"""Fused pair reductions: grid in, scalar out, never a pair list.

PyTorch counterpart of ``zelll_tpu/ops/fused.py``. Wraps the K1 reduction
(`lag_pairs.pair_lag_reduce`) with the lag-coverage check, and provides the
full-rebuild step of the benchmark (`fused_lj_rebuild_energy`): cell keys
-> one sort -> fused reduction, with no occupied-cell table (K1 needs none).
`auto_lj_energy` probes the data and sends thin boxes to that step and
cubic or wide ones to the segment-tile step (K6,
`tile_pairs.tile_lj_rebuild_energy`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core.binning import bin_and_sort, compute_keys, sort_by_key
from ..core.geometry import GridInfo, aabb_from_positions
from ..core.grid import CellGridData, build
from ..core.pairs import pair_sum
from .lag_pairs import (
    combine_count,
    count_term,
    lag_coverage_ok,
    lj_term,
    pair_lag_reduce,
    _pad_and_desentinel,
    split_f64,
    suggest_lag,
)
from .lj import lj
from .segments import CHUNK, segment_bands, suggest_maxj
from .tile_pairs import tile_lj_rebuild_energy

__all__ = [
    "fused_pair_sum",
    "fused_lj_energy",
    "fused_count_pairs",
    "fused_lj_rebuild_energy",
    "auto_lj_energy",
]


def fused_pair_sum(grid: CellGridData, term: Callable, *, cutoff=None,
                   M: int = 4096, L: int = 256, out_dtype=None):
    """Sum term(dsq) over unique cutoff pairs. Returns (total, coverage_ok).

    coverage_ok False means the lag bound L is too small for this data's
    density: rerun with a larger L.
    """
    c = grid.info.cutoff if cutoff is None else cutoff
    total = pair_lag_reduce(grid.sorted_pos, grid.bins.sorted_keys,
                            grid.info.strides, c * c, M=M, L=L, term=term,
                            out_dtype=out_dtype)
    ok = lag_coverage_ok(grid.bins.sorted_keys, grid.info.strides, L)
    return total, ok


def fused_lj_energy(grid: CellGridData, **kw):
    return fused_pair_sum(grid, lj_term, **kw)


def fused_count_pairs(grid: CellGridData, **kw):
    """Exact pair count as a Python int, with coverage_ok. Integer
    accumulation, returned as two int32 halves so totals past 2^31 cannot
    wrap."""
    kw.setdefault("out_dtype", torch.int32)
    packed, ok = fused_pair_sum(grid, count_term, **kw)
    return combine_count(packed), ok


def fused_lj_rebuild_energy(positions, cutoff, positions_lo=None, *,
                            M: int = 4096, L: int = 256,
                            term: Callable = lj_term, out_dtype=None,
                            device=None):
    """The benchmark step: cell keys -> sort by key -> fused reduction.

    ``positions_lo`` (f32 low parts from `split_f64`) selects
    split-precision pair distances. The grid uses ``auto_order`` strides
    and the sort is not stable (intra-cell order is never observed).
    Returns (total, coverage_ok).
    """
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    info = GridInfo.create(aabb_from_positions(positions), cutoff,
                           auto_order=True)
    keys = compute_keys(positions, info)
    if positions_lo is not None:
        positions_lo = torch.as_tensor(positions_lo, device=device)
        sorted_keys, _, sorted_pos, sorted_lo = sort_by_key(
            keys, positions, positions_lo)
    else:
        sorted_keys, _, sorted_pos = sort_by_key(keys, positions)
        sorted_lo = None
    csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
    total = pair_lag_reduce(sorted_pos, sorted_keys, info.strides, csq,
                            sorted_lo, M=M, L=L, term=term, out_dtype=out_dtype)
    ok = lag_coverage_ok(sorted_keys, info.strides, L)
    return total, ok


def auto_lj_energy(positions, cutoff, *, max_thin_lag: int = 2048,
                   split: bool = False, device=None):
    """LJ energy that picks its own path: it probes the data's lag
    requirement and sends thin boxes to the fused lag step (K1) and cubic
    or wide boxes to the segment-tile step (K6).

    ``split=True`` splits the (f64) input into hi/lo f32 planes for
    f64-grade pair distances (`split_f64`). It chooses its kernel
    parameters from the data, so it reads back to the host. Returns
    (energy: float, path name).
    """
    device = resolve_device(device, positions)
    if split:
        positions, pos_lo = split_f64(
            torch.as_tensor(positions, dtype=torch.float64, device=device))
    else:
        positions = torch.as_tensor(positions, device=device)
        pos_lo = None
    bins, _ = bin_and_sort(positions, cutoff, max_cells=1, need_perm=False)
    L = suggest_lag(bins.sorted_keys, bins.info.strides)
    if L <= max_thin_lag:
        M = max(1024, min(16384, L))
        e, ok = fused_lj_rebuild_energy(positions, cutoff, pos_lo, M=M, L=L)
        if not bool(ok):
            raise RuntimeError(f"lag coverage failed at the suggested L={L}")
        return float(e), f"fused(L={L})"
    if positions.shape[1] > 3:
        # segment bands are defined for dim <= 3; higher-N wide boxes take
        # the bucketed path (the reference is generic over N, lib.rs:132)
        grid = build(positions, cutoff)
        K = int(grid.bins.max_cell_count())
        e = pair_sum(grid, lj, K=K, chunk=min(256, grid.bins.max_cells),
                     cutoff_sq=cutoff * cutoff)
        return float(e), f"xla(K={K})"
    # Wide or cubic box: the segment-tile step. Probe the window capacity
    # on the keys computed above; the flag and the growth loop still guard
    # density drift (never drop pairs silently).
    nk = bins.sorted_keys.shape[0]
    C = max(-(-nk // (CHUNK * 8)) * 8, 8) * CHUNK
    # key headroom does not depend on MAXJ: check it once, up front
    max_key = int(np.max(bins.sorted_keys.cpu().numpy()))
    if max_key >= (1 << 24):
        raise ValueError(
            f"grid has flat keys up to {max_key} >= 2^24: beyond the "
            "packed tile layout's f32-exact key range; shrink the grid or "
            "use ops.tile_pairs.tile_pair_reduce with packed=False"
        )
    maxj = suggest_maxj(_pad_and_desentinel(bins.sorted_keys, C),
                        segment_bands(bins.info.strides), per_band=True)
    while True:
        e, ok = tile_lj_rebuild_energy(positions, cutoff, pos_lo, MAXJ=maxj)
        if bool(ok):
            return float(e), f"tile(MAXJ={maxj})"
        if max(maxj) > 512:
            raise RuntimeError("tile window capacity still insufficient "
                               f"at MAXJ={maxj}")
        maxj = tuple(2 * m for m in maxj)
