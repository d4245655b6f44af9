"""Pair-distance histograms and the radial distribution function.

PyTorch counterpart of ``zelll_tpu/ops/rdf.py``.
The histogram accumulates inside a fused pass over the sorted particles
(kernel K5 on the lag path, ``lag_pairs.pair_lag_hist``; K9 on the tile
path, ``tile_pairs.tile_pair_hist``), so the pair list never exists:
`pair_distance_histogram` returns exact integer shell counts of unique
pairs with ``edges[k] <= r < edges[k+1]``. The grid is binned at
``edges[-1]``, the effective cutoff. Partial histograms restrict to
unordered species pairs {a, b} through a payload pair mask, still one pass.

`rdf` is the periodic counterpart with the ideal-gas shell normalisation
``g(r_k) = 2 V h_k / (N (N-1) Vshell_k)``: the counts come from one fused
pass over the ghost-image extension of ``ops.pbc`` (K5 or K9 with the keep
mask over the shift-sign plane, each cross pair once), or on the lag path
over the minimum-image binning (K5 with the minimum image, and the keep
mask where ghost axes remain). Species partials compose the keep mask with
the species pair mask over two payload planes (K5).

The flag goes False when the lag bound L, the tile capacity MAXJ or the
periodic capacities are too small (grow them and run again); a result with
a false flag is never trustworthy.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core.binning import compute_keys, sort_by_key
from ..core.geometry import GridInfo, aabb_from_positions
from .lag_pairs import (
    PbcSpeciesPairMask,
    SpeciesPairMask,
    combine_count_vec,
    lag_coverage_ok,
    pair_lag_hist,
    pbc_keep,
)
from .pbc import _default_caps, _ghost_bins, _minimage_bins, _prepare, _resolve_minimage
from .tile_pairs import tile_pair_hist

__all__ = ["pair_distance_histogram", "rdf", "rdf_normalize", "rdf_normalize_partial"]


_SPECIES_MASKS: dict = {}


def _species_mask(a: int, b: int) -> SpeciesPairMask:
    """The cached mask of the unordered species pairs {a, b}: the one pair
    mask the histogram kernels take."""
    fn = _SPECIES_MASKS.get((a, b))
    if fn is None:
        fn = _SPECIES_MASKS[(a, b)] = SpeciesPairMask(a, b)
    return fn


def _cum_hist(positions, edges, *, positions_lo, M, L, path, CB, MAXJ,
              species=None, pair=None):
    """(2, K) packed cumulative pair counts (dsq < edges[k]^2) and the flag:
    keys on an ``auto_order`` grid of cell edge ``edges[-1]``, one sort and
    gather of the coordinates (and low parts and species), then K5 or K9."""
    if path not in ("lag", "tile"):
        raise ValueError(f"unknown path {path!r} (lag | tile)")
    dtype = positions.dtype
    cutoff = float(edges[-1])
    edges_sq = torch.as_tensor(np.asarray(edges, np.float64)).to(dtype) ** 2
    info = GridInfo.create(aabb_from_positions(positions), cutoff, auto_order=True)
    keys = compute_keys(positions, info)
    cols = [positions]
    if positions_lo is not None:
        cols.append(positions_lo)
    if species is not None:
        cols.append(torch.as_tensor(species, device=positions.device).to(dtype).reshape(-1))
    skeys, _, sp, *rest = sort_by_key(keys, *cols)
    slo = rest.pop(0) if positions_lo is not None else None
    spec = rest.pop(0) if species is not None else None
    mask = _species_mask(*pair) if species is not None else None
    if path == "tile":
        return tile_pair_hist(sp, skeys, info.strides, edges_sq, slo, spec, CB=CB,
                              MAXJ=MAXJ, pair_mask=mask)
    packed = pair_lag_hist(sp, skeys, info.strides, edges_sq, slo, spec, M=M, L=L,
                           pair_mask=mask)
    return packed, lag_coverage_ok(skeys, info.strides, L)


def pair_distance_histogram(positions, edges, *, positions_lo=None, M: int = 1024,
                            L: int = 256, path: str = "lag", CB: int = 8, MAXJ=8,
                            species=None, pair: tuple[int, int] | None = None,
                            device=None):
    """Histogram of unique pair distances over the (K-1) shells
    ``edges[k] <= r < edges[k+1]`` (open boundaries; edges ascending,
    ``edges[-1]`` the effective cutoff). Host-syncing; returns ((K-1,)
    int64 numpy counts, coverage_ok as a bool). Exact integer counts: ties
    at a shell boundary follow the f32 (or split, or f64) dsq of the pair.

    ``positions_lo``: f32 low parts (`lag_pairs.split_f64`) for f64-grade
    shell boundaries in large boxes. ``path="tile"`` (capacity ``MAXJ``;
    K <= 64) suits cubic and wide boxes where the lag bound L degenerates;
    ``"lag"`` (capacity ``L``) suits thin ones.

    ``species`` ((n,) small non-negative ints) with ``pair=(a, b)``
    restricts the counts to unordered species pairs {a, b}: partial
    histograms through a payload pair mask, still one fused pass.
    """
    if (species is None) != (pair is None):
        raise ValueError("species and pair go together")
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    if positions_lo is not None:
        positions_lo = torch.as_tensor(positions_lo, device=device)
    packed, ok = _cum_hist(positions, np.asarray(edges, np.float64).reshape(-1),
                           positions_lo=positions_lo, M=M, L=L, path=path, CB=CB,
                           MAXJ=MAXJ, species=species, pair=pair)
    cum = combine_count_vec(packed)
    return cum[1:] - cum[:-1], bool(ok)


_PBC_SPECIES_MASKS: dict = {}


def _pbc_species_mask(a: int, b: int) -> PbcSpeciesPairMask:
    """The cached keep mask composed with the species pairs {a, b}, over the
    payload columns (shift sign, species)."""
    fn = _PBC_SPECIES_MASKS.get((a, b))
    if fn is None:
        fn = _PBC_SPECIES_MASKS[(a, b)] = PbcSpeciesPairMask(a, b)
    return fn


def _pbc_cum_hist(positions, origin, box, edges, *, positions_lo, B, G, M, L,
                  path="lag", CB=8, MAXJ=8, species=None, pair=None, minimage=False):
    """(2, K) packed cumulative minimum-image pair counts and the flag:
    the minimum-image binning and K5 (``minimage`` on the lag path), or the
    ghost-image extension's sort with the shift-sign plane (and the species,
    ghosts taking their parent's) and K5 or K9."""
    n, dim = positions.shape
    dtype = positions.dtype
    cutoff = float(edges[-1])
    edges_sq = torch.as_tensor(np.asarray(edges, np.float64)).to(dtype) ** 2
    mimask = _resolve_minimage(box, cutoff, minimage, dim)
    if mimask.any():
        if path != "lag":
            raise ValueError(
                "minimage is a lag-path feature (narrow axes are the lag "
                f"kernel's regime); got path={path!r}")
        # species ride the binning as an extra column (ghosts on the axes
        # that keep them take their parent's); the pair mask composes with
        # the shift-sign plane only where ghost axes remain
        spec = None if species is None else \
            torch.as_tensor(species, device=positions.device).to(dtype).reshape(-1)
        out = _minimage_bins(positions, origin, box, cutoff, mimask, B=B, G=G,
                             positions_lo=positions_lo, need_perm=False, extra=spec)
        bins, sp, slo, payload, reach, mi_box, ok = out[:7]
        mask = None if payload is None else pbc_keep
        if species is not None:
            if payload is None:
                payload, mask = out[7], _species_mask(*pair)
            else:
                payload, mask = torch.cat([payload, out[7]], 1), _pbc_species_mask(*pair)
        packed = pair_lag_hist(sp, bins.sorted_keys, bins.info.strides, edges_sq, slo,
                               payload, M=M, L=L, pair_mask=mask, mi_box=mi_box,
                               key_reach=reach)
        ok = ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L, reach=reach)
        return packed, ok
    if path not in ("lag", "tile"):
        raise ValueError(f"unknown path {path!r} (lag | tile)")
    if species is not None and path == "tile":
        # the packed layout has one payload row, taken by the shift signs
        raise ValueError("species-resolved PBC histograms need path='lag' "
                         "(one payload row on tile)")
    # sized as the JAX package sizes it: BE = B
    B, G, BE = _default_caps(n, box, cutoff, B, G, None, multi=False)
    bins, sp, slo, signs, ok, *spec = _ghost_bins(
        positions, origin, box, cutoff, B=B, G=G, BE=BE, positions_lo=positions_lo,
        need_perm=False, extra=species)
    if path == "tile":
        packed, cov = tile_pair_hist(sp, bins.sorted_keys, bins.info.strides, edges_sq,
                                     slo, signs[:, 0], CB=CB, MAXJ=MAXJ, pair_mask=pbc_keep)
        return packed, ok & cov
    payload, mask = signs, pbc_keep
    if species is not None:
        payload, mask = torch.cat([signs, spec[0]], 1), _pbc_species_mask(*pair)
    packed = pair_lag_hist(sp, bins.sorted_keys, bins.info.strides, edges_sq, slo,
                           payload, M=M, L=L, pair_mask=mask)
    return packed, ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L)


def rdf(positions, origin, box, edges, *, positions_lo=None, B: int | None = None,
        G: int | None = None, M: int = 1024, L: int = 256, path: str = "lag",
        CB: int = 8, MAXJ=8, species=None, pair: tuple[int, int] | None = None,
        minimage=False, device=None):
    """Radial distribution function g(r) under orthorhombic PBC (minimum
    image; each ``box > 2 edges[-1]``, as every ``ops.pbc`` path needs).
    Host-syncing; returns (r_mid, g, coverage_ok as a bool).

    The shell counts come from one fused histogram pass over the
    ghost-extended sort (K5 on the lag path, K9 on the tile path, the
    realistic cubic geometry); the normalisation is the ideal-gas shell
    count at the box density. ``species`` ((n,) small non-negative ints)
    with ``pair=(a, b)`` gives the partial g_AB (lag path: the species plane
    rides the kernel payload beside the shift-sign plane). ``minimage``
    ("auto", False or a per-axis mask; lag path) folds the narrow axes in
    K5 instead of building their ghost images (`pbc._minimage_bins`); the
    binned distances are image distances, and species compose.
    B and G default to `pbc.suggest_pbc_capacity`'s and BE to B, as in the
    JAX package.
    """
    if (species is None) != (pair is None):
        raise ValueError("species and pair go together")
    positions, positions_lo = _prepare(positions, positions_lo, device)
    edges = np.asarray(edges, np.float64).reshape(-1)
    packed, ok = _pbc_cum_hist(positions, origin, box, edges, positions_lo=positions_lo,
                               B=B, G=G, M=M, L=L, path=path, CB=CB, MAXJ=MAXJ,
                               species=species, pair=pair, minimage=minimage)
    cum = combine_count_vec(packed)
    counts = cum[1:] - cum[:-1]
    vol = float(np.prod(np.asarray(box, np.float64)))
    if pair is None:
        r_mid, g = rdf_normalize(counts, edges, positions.shape[0], vol)
    else:
        # the species counts where the species lie (two scalar reads)
        sp = torch.as_tensor(species, device=positions.device)
        na, nb = int((sp == pair[0]).sum()), int((sp == pair[1]).sum())
        r_mid, g = rdf_normalize_partial(counts, edges, na, nb, vol,
                                         same=pair[0] == pair[1])
    return r_mid, g, bool(ok)


def _shell_volumes(edges) -> tuple[np.ndarray, np.ndarray]:
    e = np.asarray(edges, np.float64)
    return 0.5 * (e[1:] + e[:-1]), 4.0 / 3.0 * np.pi * (e[1:] ** 3 - e[:-1] ** 3)


def rdf_normalize(counts, edges, n: int, volume: float):
    """Shell counts -> g(r): ``g_k = 2 V h_k / (N (N-1) Vshell_k)`` (each
    unique pair counted once, hence the 2). Returns (r_mid, g)."""
    r_mid, vshell = _shell_volumes(edges)
    h = np.asarray(counts, np.float64)
    return r_mid, 2.0 * float(volume) * h / (max(n, 1) * max(n - 1, 1) * vshell)


def rdf_normalize_partial(counts, edges, na: int, nb: int, volume: float,
                          same: bool):
    """Partial normalisation: ``g_AB = V h / (N_A N_B Vshell)`` for A != B
    (each unordered cross pair counted once), and the `rdf_normalize`
    same-species form when ``same``."""
    if same:
        return rdf_normalize(counts, edges, na, volume)
    r_mid, vshell = _shell_volumes(edges)
    h = np.asarray(counts, np.float64)
    return r_mid, float(volume) * h / (max(na, 1) * max(nb, 1) * vshell)
