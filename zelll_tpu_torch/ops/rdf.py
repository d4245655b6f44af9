"""Pair-distance histograms and their radial-distribution normalisation,
open boundaries.

PyTorch counterpart of the open-boundary part of ``zelll_tpu/ops/rdf.py``.
The histogram accumulates inside a fused pass over the sorted particles
(kernel K5 on the lag path, ``lag_pairs.pair_lag_hist``; K9 on the tile
path, ``tile_pairs.tile_pair_hist``), so the pair list never exists:
`pair_distance_histogram` returns exact integer shell counts of unique
pairs with ``edges[k] <= r < edges[k+1]``. The grid is binned at
``edges[-1]``, the effective cutoff. Partial histograms restrict to
unordered species pairs {a, b} through a payload pair mask, still one pass.

The flag goes False when the lag bound L or the tile capacity MAXJ is too
small (grow it and run again); a result with a false flag is never
trustworthy. The periodic ``rdf`` of the JAX module is not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..core.binning import compute_keys, sort_by_key
from ..core.geometry import GridInfo, aabb_from_positions
from .lag_pairs import SpeciesPairMask, combine_count_vec, lag_coverage_ok, pair_lag_hist
from .tile_pairs import tile_pair_hist

__all__ = ["pair_distance_histogram", "rdf_normalize", "rdf_normalize_partial"]


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
