"""Virial, stress tensor and pressure under open boundaries: the
thermodynamic observables.

PyTorch counterpart of the open-boundary part of ``zelll_tpu/ops/virial.py``.
The scalar pair virial

    W = sum_pairs f_ij . r_ij = sum_pairs gfn(dsq) * dsq

is a scalar pair term, so it rides the fused reductions unchanged: kernel
K1 on thin boxes (`fused_virial`, `virial_rebuild`) and K6 on cubic ones
(``tile_pairs.tile_lj_rebuild_energy(term=lj_virial_term)``). The full
configurational stress tensor

    sigma_ab = sum_pairs gfn(dsq) * dx_a * dx_b        (trace = W)

is one direct fused pass (`fused_stress_open`): kernel K4 on the lag path
and K8 on the tile path, each term bounded by |gfn| cutoff^2, so there is
no box-scale cancellation. Other dimensions take the bucketed
``core.pairs.pair_stress`` (`pair_stress_open`).

Pressure (instantaneous, unit mass, dimensionless units):

    P = (2 KE + W) / (dim V)

The periodic half of the JAX module (``pbc_virial``, ``pbc_stress``,
``pbc_stress_fused``) is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

from .._device import resolve_device
from ..core.binning import compute_keys, sort_by_key
from ..core.geometry import GridInfo, aabb_from_positions
from ..core.grid import CellGridData, build
from ..core.pairs import pair_stress
from .fused import fused_lj_rebuild_energy, fused_pair_sum
from .lag_pairs import lag_coverage_ok, pair_lag_stress, term_spec
from .lj import lj_force_factor, lj_virial_term
from .potentials import KIND_MIXED_LJ, MODE_GFN, MODE_VIRIAL
from .tile_pairs import tile_pair_stress

__all__ = [
    "lj_virial_term",
    "virial_term_from_gfn",
    "fused_virial",
    "virial_rebuild",
    "pair_stress_open",
    "fused_stress_open",
    "kinetic_energy",
    "kinetic_stress",
    "pressure",
    "pressure_tensor",
]

# Weak values: an entry lives as long as something holds the derived term
# (the closure keeps its gfn alive that long), as in the JAX package.
_VIRIAL_TERMS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def virial_term_from_gfn(gfn: Callable) -> Callable:
    """w(dsq) = gfn(dsq) * dsq for an arbitrary force factor, cached per
    gfn. The derived term of an `ops.potentials` factory's gfn carries the
    term table's virial mode, so K1 and K6 run it on the card; any other
    derived term runs on CPU tensors."""
    fn = _VIRIAL_TERMS.get(gfn)
    if fn is None:
        def fn(dsq):
            return gfn(dsq) * dsq

        spec = term_spec(gfn)
        if spec is not None and spec.mode == MODE_GFN and spec.kind != KIND_MIXED_LJ:
            fn.table = spec._replace(mode=MODE_VIRIAL)
        _VIRIAL_TERMS[gfn] = fn
    return fn


def _virial_term(gfn: Callable | None) -> Callable:
    return lj_virial_term if gfn is None else virial_term_from_gfn(gfn)


def fused_virial(grid: CellGridData, *, gfn: Callable | None = None, **kw):
    """Scalar virial W over unique cutoff pairs of a built grid (open
    boundaries), on the fused lag reduction (K1). Returns (W,
    coverage_ok)."""
    return fused_pair_sum(grid, _virial_term(gfn), **kw)


def virial_rebuild(positions, cutoff, positions_lo=None, **kw):
    """Full-pipeline scalar virial (keys -> sort -> fused reduction, K1),
    the rebuild-per-step form of MD observers. Returns (W, coverage_ok)."""
    term = _virial_term(kw.pop("gfn", None))
    return fused_lj_rebuild_energy(positions, cutoff, positions_lo, term=term, **kw)


def pair_stress_open(positions, cutoff, *, gfn: Callable | None = None,
                     K: int | None = None, chunk: int = 256, device=None):
    """Configurational stress tensor under open boundaries, any dimension:
    builds the grid and folds sigma_ab on the bucketed ``core.pairs`` path.
    ``K`` defaults to the data's largest cell count (one host read).
    Returns ((dim, dim), ok)."""
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    grid = build(positions, cutoff)
    if K is None:
        K = int(grid.bins.max_cell_count())
    sigma = pair_stress(grid, gfn or lj_force_factor, K=K, chunk=chunk,
                        cutoff_sq=torch.as_tensor(cutoff, dtype=positions.dtype) ** 2)
    return sigma, grid.bins.max_cell_count() <= K


def _stress_pass(positions, cutoff, *, gfn, path, M, L, MAXJ, CB,
                 positions_lo=None):
    """One direct fused stress pass over unique cutoff pairs (open
    boundaries): cell keys on an ``auto_order`` grid, one sort and gather,
    then K4 (``path="lag"``) or K8 (``"tile"``). Returns ((dim, dim), ok)."""
    if path not in ("lag", "tile"):
        raise ValueError(f"unknown path {path!r} (lag | tile)")
    info = GridInfo.create(aabb_from_positions(positions), cutoff, auto_order=True)
    keys = compute_keys(positions, info)
    if positions_lo is not None:
        skeys, _, sp, slo = sort_by_key(keys, positions, positions_lo)
    else:
        (skeys, _, sp), slo = sort_by_key(keys, positions), None
    csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
    gfn = gfn or lj_force_factor
    if path == "tile":
        return tile_pair_stress(sp, skeys, info.strides, csq, slo, CB=CB,
                                MAXJ=MAXJ, gfn=gfn)
    sigma = pair_lag_stress(sp, skeys, info.strides, csq, slo, M=M, L=L, gfn=gfn)
    return sigma, lag_coverage_ok(skeys, info.strides, L)


def fused_stress_open(positions, cutoff, *, gfn: Callable | None = None,
                      path: str = "lag", M: int = 1024, L: int = 256, MAXJ=8,
                      CB: int = 8, positions_lo=None, device=None):
    """Configurational stress tensor at fused-kernel speed, open boundaries:
    one direct pair-sum pass, the pair list never exists. ``path="lag"``
    (K4, capacity ``L``) for thin boxes, ``"tile"`` (K8, capacity
    ``MAXJ``) for cubic and wide ones. ``positions_lo`` (f32 low parts,
    `lag_pairs.split_f64`) gives f64-grade stress from f32 coordinates.
    Returns ((dim, dim) in the positions' dtype, ok); never trust a result
    with a false flag.

    Other dimensions than 3 go to `pair_stress_open` (the bucketed path);
    a split request cannot be honoured there, so it raises.
    """
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    if positions_lo is not None:
        positions_lo = torch.as_tensor(positions_lo, device=device)
    if positions.shape[1] != 3:
        if positions_lo is not None:
            raise ValueError(
                "split-precision stress is only fused for dim == 3; the "
                "bucketed fallback would silently drop positions_lo")
        return pair_stress_open(positions, cutoff, gfn=gfn)
    return _stress_pass(positions, cutoff, gfn=gfn, path=path, M=M, L=L,
                        MAXJ=MAXJ, CB=CB, positions_lo=positions_lo)


def kinetic_energy(velocities: torch.Tensor) -> torch.Tensor:
    """Total kinetic energy, unit mass: KE = 1/2 sum |v|^2 (summed axis by
    axis, as in the JAX package)."""
    v = torch.as_tensor(velocities)
    total = (v[:, 0] * v[:, 0]).sum()
    for a in range(1, v.shape[1]):
        total = total + (v[:, a] * v[:, a]).sum()
    return 0.5 * total


def kinetic_stress(velocities: torch.Tensor) -> torch.Tensor:
    """Kinetic stress tensor, unit mass: sum_i v_a v_b (trace = 2 KE), one
    sum per component as in the JAX package."""
    v = torch.as_tensor(velocities)
    dim = v.shape[1]
    sums = {(a, b): (v[:, a] * v[:, b]).sum() for a in range(dim) for b in range(a, dim)}
    return torch.stack([sums[min(a, b), max(a, b)] for a in range(dim)
                        for b in range(dim)]).reshape(dim, dim)


def pressure(virial_w, kinetic, volume, dim: int = 3):
    """Instantaneous scalar pressure P = (2 KE + W) / (dim V)."""
    return (2.0 * kinetic + virial_w) / (dim * volume)


def pressure_tensor(sigma_conf, sigma_kin, volume):
    """Instantaneous pressure tensor P_ab = (sigma_kin + sigma_conf) / V; its
    trace / dim is the scalar `pressure`."""
    return (sigma_kin + sigma_conf) / volume
