"""Virial, stress tensor and pressure: the thermodynamic observables.

PyTorch counterpart of ``zelll_tpu/ops/virial.py``.
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

Orthorhombic periodic boxes (``ops.pbc``): `pbc_virial` is `pbc_pair_sum`
with the virial term (K1 or K6 with the keep mask, K1 with the minimum
image); `pbc_stress_fused` is one pass over the ghost-extended sort, the
shift-sign plane masking each minimum-image cross pair to count once
(`lag_pairs.pbc_keep`, the JAX package's ``_pbc_keep_mask``; K4's and
K8's keep instances: d (x) d is the same for a pair and its mirror image), or over the minimum-image binning of
``pbc._minimage_bins`` (K4's minimum-image instances, the keep mask only
where ghost axes remain); `pbc_stress` is the N-dimensional fallback on
``core.pairs`` with endpoint half-weights (1 on real rows, 0 on ghosts).

Pressure (instantaneous, unit mass, dimensionless units):

    P = (2 KE + W) / (dim V)

feeding the barostat of ``models.thermostats.md_run_npt``.
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
from .lag_pairs import lag_coverage_ok, pair_lag_stress, pbc_keep, term_spec
from .lj import lj_force_factor, lj_virial_term
from .pbc import (
    _default_caps,
    _minimage_bins,
    _prepare,
    _resolve_minimage,
    pbc_extend,
    pbc_pair_sum,
    suggest_pbc_capacity,
)
from .potentials import KIND_MIXED_LJ, MODE_GFN, MODE_VIRIAL
from .tile_pairs import tile_pair_stress

__all__ = [
    "lj_virial_term",
    "virial_term_from_gfn",
    "fused_virial",
    "virial_rebuild",
    "pbc_virial",
    "pair_stress_open",
    "pbc_stress",
    "fused_stress_open",
    "pbc_stress_fused",
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


def pbc_virial(positions, origin, box, cutoff, *, gfn: Callable | None = None, **kw):
    """Scalar virial W over the unique minimum-image cutoff pairs of an
    orthorhombic periodic box, on any path of `pbc.pbc_pair_sum` (lag: K1
    with the keep mask or the minimum image; tile: K6 with the keep mask;
    xla). Returns (W, ok)."""
    return pbc_pair_sum(positions, origin, box, cutoff, term=_virial_term(gfn), **kw)


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


def pbc_stress(positions, origin, box, cutoff, *, gfn: Callable | None = None,
               B: int | None = None, G: int | None = None, K: int | None = None,
               chunk: int = 256, device=None):
    """Configurational stress tensor under orthorhombic PBC, any dimension
    (2 and 3): ghost-image extension, then the bucketed ``core.pairs`` pass
    with endpoint half-weights (real rows weigh 1, ghost rows 0), so each
    minimum-image cross pair counts exactly once and ghost-ghost pairs
    vanish. ``K`` defaults to the largest cell count (one host read).
    Returns ((dim, dim), ok)."""
    positions, _ = _prepare(positions, None, device)
    n = positions.shape[0]
    if B is None or G is None:
        Bd, Gd = suggest_pbc_capacity(n, box, cutoff)
        B = Bd if B is None else B
        G = Gd if G is None else G
    ext, _, _, valid, ok = pbc_extend(positions, origin, box, cutoff, B=B, G=G)
    grid = build(ext, cutoff, valid=valid)
    if K is None:
        K = int(grid.bins.max_cell_count())
    ok = ok & (grid.bins.max_cell_count() <= K)
    # sorted_ids < n: the slot holds a real (not ghost, not padding) row
    weights = (grid.sorted_ids < n).to(positions.dtype)
    sigma = pair_stress(grid, gfn or lj_force_factor, K=K, chunk=chunk,
                        cutoff_sq=torch.as_tensor(cutoff, dtype=positions.dtype) ** 2,
                        slot_weights=weights)
    return sigma, ok


def _stress_pass(positions, cutoff, *, gfn, path, M, L, MAXJ, CB,
                 positions_lo=None, valid=None, payload=None, pair_mask=None):
    """One direct fused stress pass over unique cutoff pairs: cell keys on
    an ``auto_order`` grid of the ``valid`` rows (the others take the
    sentinel key), one sort and gather of the coordinates, low parts and
    (n,) ``payload``, then K4 (``path="lag"``) or K8 (``"tile"``) with
    ``pair_mask`` over the sorted payload. Returns ((dim, dim), ok)."""
    if path not in ("lag", "tile"):
        raise ValueError(f"unknown path {path!r} (lag | tile)")
    info = GridInfo.create(aabb_from_positions(positions, valid), cutoff, auto_order=True)
    keys = compute_keys(positions, info, valid)
    cols = [positions] + [c for c in (positions_lo, payload) if c is not None]
    skeys, _, sp, *rest = sort_by_key(keys, *cols)
    slo = rest.pop(0) if positions_lo is not None else None
    spay = rest.pop(0) if payload is not None else None
    csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
    gfn = gfn or lj_force_factor
    if path == "tile":
        return tile_pair_stress(sp, skeys, info.strides, csq, slo, spay, CB=CB,
                                MAXJ=MAXJ, gfn=gfn, pair_mask=pair_mask)
    sigma = pair_lag_stress(sp, skeys, info.strides, csq, slo, spay, M=M, L=L, gfn=gfn,
                            pair_mask=pair_mask)
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
    with a false flag. On the card ``gfn`` (default `lj_force_factor`) is
    `lj_force_factor`, `lj_force_factor_fast` or, with f32 coordinates
    (optionally split), the gfn of any `ops.potentials` factory but
    `lennard_jones_mixed`, which K4 and K8 evaluate through the device term
    table; other callables run on CPU tensors.

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


def pbc_stress_fused(positions, origin, box, cutoff, *, gfn: Callable | None = None,
                     path: str = "lag", B: int | None = None, G: int | None = None,
                     M: int = 1024, L: int = 256, MAXJ=8, CB: int = 8,
                     positions_lo=None, minimage=False, device=None):
    """Configurational stress tensor at fused-kernel speed under orthorhombic
    PBC: one direct pair-sum pass over the ghost-image extension, the
    shift-sign payload plane masking each minimum-image cross pair to count
    exactly once (`lag_pairs.pbc_keep`, the rule of the periodic energies;
    K4 on the lag path, K8 on the tile path). ``positions_lo`` carries split
    precision through the ghosts (`pbc.pbc_extend`). B and G default to
    `pbc.suggest_pbc_capacity`'s and BE to B, as in the JAX package.

    ``minimage`` ("auto", False or a per-axis mask; lag path only) folds the
    narrow axes in K4 instead of building their ghost images
    (`pbc._minimage_bins`): d (x) d on the folded separation is the image
    pair's outer product, so only the axes that keep ghosts need the keep
    mask. Returns ((dim, dim), ok); never trust a result with a false flag.
    On the card ``gfn`` takes what `fused_stress_open`'s does: the LJ
    factors and, with f32 (or split) coordinates, the gfn of any
    `ops.potentials` factory but `lennard_jones_mixed` (K4's and K8's term
    table instances, on every layout: ghost images on either path and
    ``minimage``). Other dimensions than 3 go to `pbc_stress`, where a split
    request cannot be honoured, so it raises.
    """
    positions, positions_lo = _prepare(positions, positions_lo, device)
    n, dim = positions.shape
    if dim != 3:
        if positions_lo is not None:
            raise ValueError(
                "split-precision PBC stress is only fused for dim == 3; the "
                "bucketed fallback would silently drop positions_lo")
        return pbc_stress(positions, origin, box, cutoff, gfn=gfn, B=B, G=G)
    mimask = _resolve_minimage(box, cutoff, minimage, dim)
    if mimask.any():
        if path != "lag":
            raise ValueError(
                "minimage is a lag-path feature (narrow axes are the lag "
                f"kernel's regime); got path={path!r}")
        bins, sp, slo, payload, reach, mi_box, ok = _minimage_bins(
            positions, origin, box, cutoff, mimask, B=B, G=G,
            positions_lo=positions_lo, need_perm=False)
        csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
        sigma = pair_lag_stress(
            sp, bins.sorted_keys, bins.info.strides, csq, slo, payload,
            pair_mask=None if payload is None else pbc_keep, M=M, L=L,
            gfn=gfn or lj_force_factor, mi_box=mi_box, key_reach=reach)
        ok = ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L, reach=reach)
        return sigma, ok
    # sized as the JAX package sizes it: BE = B
    B, G, _ = _default_caps(n, box, cutoff, B, G, None, multi=False)
    ext, ext_lo, w, valid, ok = pbc_extend(
        positions, origin, box, cutoff, B=B, G=G, positions_lo=positions_lo)
    sigma, ok_k = _stress_pass(
        ext, cutoff, gfn=gfn, path=path, M=M, L=L, MAXJ=MAXJ, CB=CB,
        positions_lo=ext_lo, valid=valid, payload=w, pair_mask=pbc_keep)
    return sigma, ok & ok_k


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
