"""Lennard-Jones pair interaction as functions of the squared distance.

PyTorch counterpart of ``zelll_tpu/ops/lj.py`` (dimensionless lj/cut,
epsilon = sigma = 1, as LAMMPS ``pair_style lj/cut``):

    V(r^2) = 4 ((1/r^2)^6 - (1/r^2)^3)

`lj_force_factor` is the scalar g with force on i from j equal to
``g * (p_i - p_j)``; the forces kernels (K3 in ``ops.lag_pairs``, K7 in
``ops.tile_pairs``) evaluate it per pair in the same operation order.
`lj_energy`/`lj_forces` sum over a grid through the bucketed
``core.pairs`` path.
"""

from __future__ import annotations

import torch

from ..core.grid import CellGridData
from ..core.pairs import pair_forces, pair_sum

__all__ = ["lj", "lj_force_factor", "lj_force_factor_fast", "lj_virial_term",
           "lj_energy", "lj_forces"]


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


def lj_virial_term(dsq):
    """w(dsq) = lj_force_factor(dsq) * dsq = 24 t (2t - 1), t = dsq^-3.

    The per-pair virial f_ij . r_ij of the dimensionless LJ potential,
    simplified so that it takes one division fewer than composing
    `lj_force_factor` with a multiply. ``ops.virial`` exports it under the
    JAX package's name; it lives here so that the kernels' term tables
    (`ops.lag_pairs`, `ops.tile_pairs`) can name it.
    """
    t = (1.0 / dsq) ** 3
    return 24.0 * t * (2.0 * t - 1.0)


def lj_energy(grid: CellGridData, *, K: int, cutoff=None, chunk: int = 256,
              accum_dtype=None):
    """Total LJ potential energy over cutoff-filtered unique pairs.

    The distance filter is strict `<`, like the reference benchmark
    (benches/lj.rs:83-90).
    """
    c = grid.info.cutoff if cutoff is None else cutoff
    return pair_sum(grid, lj, K=K, chunk=chunk, cutoff_sq=c * c,
                    accum_dtype=accum_dtype)


def lj_forces(grid: CellGridData, *, K: int, cutoff=None, chunk: int = 256):
    """Per-particle LJ forces (input particle order)."""
    c = grid.info.cutoff if cutoff is None else cutoff
    return pair_forces(grid, lj_force_factor, K=K, chunk=chunk, cutoff_sq=c * c)
