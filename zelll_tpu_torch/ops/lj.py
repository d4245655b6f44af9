"""Lennard-Jones pair interaction as functions of the squared distance.

PyTorch counterpart of ``zelll_tpu/ops/lj.py`` (dimensionless lj/cut,
epsilon = sigma = 1, as LAMMPS ``pair_style lj/cut``):

    V(r^2) = 4 ((1/r^2)^6 - (1/r^2)^3)

`lj_force_factor` is the scalar g with force on i from j equal to
``g * (p_i - p_j)``; the forces kernels (K3 in ``ops.lag_pairs``, K7 in
``ops.tile_pairs``) evaluate it per pair in the same operation order.
``lj_energy``/``lj_forces`` over a grid need the bucketed ``core.pairs``
path, which the port does not have yet.
"""

from __future__ import annotations

import torch

__all__ = ["lj", "lj_force_factor", "lj_force_factor_fast"]


def lj(dsq):
    """4((1/r)^12 - (1/r)^6) from the squared distance."""
    inv = 1.0 / dsq
    t = inv * inv * inv
    return 4.0 * t * (t - 1.0)


def lj_force_factor(dsq):
    """Scalar g such that the force on i from j is g * (p_i - p_j).

    g = -2 dV/d(dsq) = 24 t (2t - 1) / dsq with t = dsq^-3.
    """
    inv = 1.0 / dsq
    t = inv * inv * inv
    return 24.0 * t * (2.0 * t - 1.0) * inv


def lj_force_factor_fast(dsq):
    """`lj_force_factor` with the division replaced by a reciprocal square
    root (a few ulp), for the f32 headline mode only."""
    r = torch.rsqrt(dsq)
    inv = r * r
    t = inv * inv * inv
    return 24.0 * t * (2.0 * t - 1.0) * inv
