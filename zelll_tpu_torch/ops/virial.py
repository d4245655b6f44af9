"""Pair virial terms.

PyTorch counterpart of the part of ``zelll_tpu/ops/virial.py`` that
`CellGrid.virial` needs: the per-pair virial term of the LJ potential.
The stress and pressure tools over kernels K4 and K8 follow with the
observables (ROADMAP queue 1, slice 6).
"""

from __future__ import annotations

__all__ = ["lj_virial_term"]


def lj_virial_term(dsq):
    """w(dsq) = lj_force_factor(dsq) * dsq = 24 t (2t - 1), t = dsq^-3.

    The per-pair virial f_ij . r_ij of the dimensionless LJ potential,
    simplified so that it takes one division fewer than composing
    `lj_force_factor` with a multiply.
    """
    t = (1.0 / dsq) ** 3
    return 24.0 * t * (2.0 * t - 1.0)
