"""Carrying state across from the JAX package.

The system has no weights: its state is the sorted grid. These helpers
build the port's objects from the arrays of a ``zelll_tpu`` grid, so both
packages can be fed the identical sorted order (an unstable sort may order
particles within a cell differently in each package).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.binning import Bins
from .core.geometry import Aabb, GridInfo
from .core.grid import CellGridData

__all__ = ["grid_from_numpy", "sorted_inputs_from_numpy", "md_state_from_numpy"]


def grid_from_numpy(grid, *, device=None) -> CellGridData:
    """The port's `CellGridData` from a grid laid out like
    ``zelll_tpu.core.grid.CellGridData`` (``sorted_pos``, ``sorted_ids``
    and ``bins`` with its ``info``, ``aabb`` and cell table). Every leaf is
    copied with ``numpy.array``, so any array type that converts works."""
    device = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    b, info = grid.bins, grid.bins.info
    port_info = GridInfo(
        aabb=Aabb(inf=t(info.aabb.inf), sup=t(info.aabb.sup)),
        cutoff=t(info.cutoff),
        shape=t(info.shape, torch.int32),
        strides=t(info.strides, torch.int32),
    )
    bins = Bins(
        info=port_info,
        keys=t(b.keys, torch.int32),
        perm=t(b.perm, torch.int32),
        sorted_keys=t(b.sorted_keys, torch.int32),
        cell_keys=t(b.cell_keys, torch.int32),
        cell_starts=t(b.cell_starts, torch.int32),
        cell_counts=t(b.cell_counts, torch.int32),
        num_cells=t(b.num_cells, torch.int32),
        num_valid=t(b.num_valid, torch.int32),
        overflow=t(b.overflow, torch.bool),
    )
    return CellGridData(bins=bins, sorted_pos=t(grid.sorted_pos),
                        sorted_ids=t(grid.sorted_ids, torch.int32))


def sorted_inputs_from_numpy(sorted_pos, sorted_pos_lo, sorted_keys, strides,
                             *, device=None):
    """The raw sorted inputs of `ops.lag_pairs.pair_lag_reduce` as tensors:
    returns (sorted_pos, sorted_keys, strides, sorted_pos_lo), with
    ``sorted_pos_lo`` None when given None."""
    device = resolve_device(device)

    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return (t(sorted_pos), t(sorted_keys, torch.int32), t(strides, torch.int32),
            t(sorted_pos_lo))


def md_state_from_numpy(positions, velocities, *, split: bool = False,
                        device=None):
    """The port's MD state from the JAX package's, given as arrays.

    ``split=False``: an `MDState` of the two (n, dim) arrays, dtypes kept.
    ``split=True``: an `MDStateSplit`, from f64 positions (split with
    `split_f64`, bitwise as the JAX package splits them) or from the
    (pos_hi, pos_lo) pair of a JAX ``MDStateSplit``; velocities in f32.
    """
    from .models.lj_md import MDState, MDStateSplit

    device = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    if not split:
        return MDState(positions=t(positions), velocities=t(velocities))
    if isinstance(positions, (tuple, list)):
        hi, lo = positions
        return MDStateSplit(pos_hi=t(hi, torch.float32), pos_lo=t(lo, torch.float32),
                            velocities=t(velocities, torch.float32))
    return MDStateSplit.from_f64(t(positions, torch.float64), t(velocities),
                                 device=device)
