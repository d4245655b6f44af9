"""The SDF instance of the query join: sorted queries x structure atoms.

PyTorch counterpart of ``zelll_tpu/ops/sdf_join.py``. The psssh workload
evaluates the smooth distance field (`models.sdf`, after the reference's
``surface-sampling/src/sdf/numdual.rs:11-61``) on large query batches.
Instead of autodiff, each query accumulates the 12 sufficient sums of the
SDF and its analytic gradient over its within-cutoff atoms:

    S1 = sum e1,  S2 = sum e3*r,  S3 = sum e3,
    A1 = sum (e1/r/d) * u,  A2 = sum (e3*r/d) * u,  A3 = sum (e3/d) * u

with e1 = exp(-d/r), e3 = exp(-d) and u = x_q - x_p. An atom at d == 0
adds (1, r, 1) to (S1, S2, S3) and nothing to the gradient sums, as in
the reference (numdual.rs:34-42). `models.sdf` closes the sums over the
value and gradient:

    sigma = S2/S3, val = -sigma*ln(S1)
    grad  = lnS1 * (A2*S3 - S2*A3)/S3^2 + sigma*A1/S1.

On CUDA tensors the sums come from kernel K12's sdf instance
(``csrc/join_reduce.cu``); on CPU tensors from its plain version.
"""

from __future__ import annotations

import torch

from .join import join_reduce

__all__ = ["sdf_join_sums", "sdf_term", "NACC"]

# accumulated quantities per query:
# 0 S1, 1 S2, 2 S3, 3-5 A1, 6-8 A2, 9-11 A3
NACC = 12


def sdf_term(dsq, d, payload, within):
    """The 12 SDF quantities of each (query, atom) pair (see the module
    docstring); the payload rows are (r, 1/r) in sorted slot order."""
    r, rinv = payload
    iszero = within & (dsq == 0)
    live = within & (dsq > 0)
    zero = torch.zeros_like(dsq)

    # one rsqrt replaces sqrt and a division; masked lanes use dsq = 1, so
    # no inf or NaN is ever formed
    rs = torch.rsqrt(torch.where(live, dsq, torch.ones_like(dsq)))
    dist = dsq * rs
    e1 = torch.where(live, torch.exp(-dist * rinv), zero)
    e3 = torch.where(live, torch.exp(-dist), zero)
    z = torch.where(iszero, torch.ones_like(dsq), zero)

    c1 = e1 * rs * rinv
    c3 = e3 * rs
    c2 = c3 * r
    out = [e1 + z, (e3 + z) * r, e3 + z]
    for c in (c1, c2, c3):
        out.extend(c * da for da in d)
    return out


def sdf_join_sums(qplanes, qkeys, pplanes, pkeys, strides, cutoff_sq, *,
                  CB: int = 8, MAXJ: int | None = None, device=None):
    """The 12 per-query SDF sums over all within-cutoff atoms.

    ``qplanes``/``qkeys``: the sorted queries; ``pplanes``: the 5 sorted
    atom planes x, y, z, r, 1/r; ``pkeys`` their keys. Returns (sums, ok):
    ``sums`` (nq, NACC) ordered [S1, S2, S3, A1xyz, A2xyz, A3xyz] per
    sorted query, ``ok`` the join's coverage flag (`ops.join.join_reduce`).
    """
    return join_reduce(qplanes, qkeys, pplanes, pkeys, strides, cutoff_sq,
                       term=sdf_term, n_out=NACC, CB=CB, MAXJ=MAXJ,
                       device=device)
