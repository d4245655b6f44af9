"""Dense cell-table backend: the second grid-storage axis.

PyTorch counterpart of ``zelll_tpu/core/dense.py``. The reference sketches
a sparse-vs-dense storage axis (a `GridStorage` trait and an experimental
`DenseMap` indexed by flat key, zelll `src/cellgrid/storage.rs:172-302`)
but never wires it into `CellGrid`. Here it is wired: a `DenseTable` maps
flat cell keys directly to occupied-cell-table rows, replacing the
per-stencil-offset binary search (`pairs._neighbor_rows`) with one O(1)
gather per neighbour cell.

The trade-off is the reference's: O(prod(padded_shape)) memory against
O(1) lookups, for compact boxes only. ``capacity`` is fixed by the caller
and `DenseTable.fits` is False iff some occupied cell's key falls outside
the table: results from a table that does not fit must not be trusted;
rebuild it with a larger capacity.
"""

from __future__ import annotations

import dataclasses

import torch

from .binning import Bins
from .geometry import SENTINEL_KEY

__all__ = ["DenseTable", "build_dense_table", "dense_rows_for_keys"]


@dataclasses.dataclass(frozen=True)
class DenseTable:
    """Flat-key-indexed view of the occupied-cell table.

    ``rows[k]`` is the row of cell key ``k`` in the `Bins` cell table, or
    ``max_cells`` when cell ``k`` is empty. ``fits`` is the coverage flag:
    True iff every occupied cell key landed inside ``[0, capacity)``.
    """

    rows: torch.Tensor  # (capacity,) int32
    fits: torch.Tensor  # scalar bool

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]


def build_dense_table(bins: Bins, capacity: int) -> DenseTable:
    """Invert the occupied-cell table into a dense key-indexed array.

    One scatter of ``max_cells`` values into ``capacity + 1`` rows, the
    last a dump row for keys outside the table (the JAX package drops
    those scatters), which `fits` reports.
    """
    mc = bins.max_cells
    keys = bins.cell_keys
    real = keys != SENTINEL_KEY
    kmax = torch.where(real, keys, torch.full_like(keys, -1)).max()
    tgt = torch.where(real & (keys >= 0) & (keys < capacity), keys,
                      torch.full_like(keys, capacity))
    rows = torch.full((capacity + 1,), mc, dtype=torch.int32, device=keys.device)
    rows[tgt.long()] = torch.arange(mc, dtype=torch.int32, device=keys.device)
    return DenseTable(rows=rows[:capacity], fits=kmax < capacity)


def dense_rows_for_keys(table: DenseTable, qkeys: torch.Tensor, mc) -> torch.Tensor:
    """Cell-table rows for query keys: the O(1) replacement of the
    binary-search lookup. Out-of-range keys (including the negative keys a
    boundary cell's stencil produces) resolve to ``mc`` (empty)."""
    cap = table.capacity
    in_range = (qkeys >= 0) & (qkeys < cap)
    r = table.rows[qkeys.clamp(0, cap - 1).long()]
    return torch.where(in_range, r, torch.full_like(r, mc))
