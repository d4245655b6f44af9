"""Fused pair reductions: grid in, scalar out, never a pair list.

PyTorch counterpart of ``zelll_tpu/ops/fused.py``. Wraps the K1 reduction
(`lag_pairs.pair_lag_reduce`) with the lag-coverage check, and provides the
full-rebuild step of the benchmark (`fused_lj_rebuild_energy`): cell keys
-> one sort -> fused reduction, with no occupied-cell table (K1 needs none).
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..core.binning import compute_keys, sort_by_key
from ..core.geometry import GridInfo, aabb_from_positions
from ..core.grid import CellGridData
from .lag_pairs import (
    combine_count,
    count_term,
    lag_coverage_ok,
    lj_term,
    pair_lag_reduce,
)

__all__ = [
    "fused_pair_sum",
    "fused_lj_energy",
    "fused_count_pairs",
    "fused_lj_rebuild_energy",
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
