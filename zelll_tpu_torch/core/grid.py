"""Cell-grid state and its build.

PyTorch counterpart of ``zelll_tpu/core/grid.py``: an immutable
`CellGridData` made by `build` and remade by `rebuild`. Its
``sorted_pos`` is the flat particle storage grouped by cell, with
``bins.cell_starts``/``cell_counts`` as the per-cell slice table.

* `build(positions, cutoff)`       == `CellGrid::new` (cellgrid.rs:166-172)
* `rebuild(grid, positions, ...)`  == `CellGrid::rebuild_mut`
  (cellgrid.rs:264-312) with its fast path: when no particle changed
  cells and the geometry is unchanged, the occupied-cell table is kept
  and only the coordinates are regrouped.
"""

from __future__ import annotations

import dataclasses

import torch

from .binning import Bins, bin_and_sort, compute_keys
from .geometry import GridInfo, aabb_from_positions

__all__ = ["CellGridData", "build", "rebuild"]


@dataclasses.dataclass(frozen=True)
class CellGridData:
    """Immutable cell-grid state."""

    bins: Bins
    sorted_pos: torch.Tensor  # (n, N) positions grouped by cell
    sorted_ids: torch.Tensor  # (n,) input particle index per sorted slot

    @property
    def info(self) -> GridInfo:
        return self.bins.info

    @property
    def n(self) -> int:
        return self.sorted_pos.shape[0]

    @property
    def dim(self) -> int:
        return self.sorted_pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.sorted_pos.device

    @property
    def num_cells(self) -> torch.Tensor:
        return self.bins.num_cells

    def unsort(self, per_slot: torch.Tensor) -> torch.Tensor:
        """Re-order a per-sorted-slot array back to input particle order."""
        inv = torch.empty_like(self.bins.perm)
        inv[self.bins.perm.long()] = torch.arange(
            self.n, dtype=inv.dtype, device=inv.device)
        return per_slot[inv.long()]


def build(positions, cutoff, *, max_cells: int | None = None, valid=None,
          info: GridInfo | None = None, device=None) -> CellGridData:
    """Construct a cell grid from (n, N) positions."""
    bins, sorted_pos = bin_and_sort(positions, cutoff, max_cells=max_cells,
                                    valid=valid, info=info, device=device)
    return CellGridData(bins=bins, sorted_pos=sorted_pos, sorted_ids=bins.perm)


def rebuild(grid: CellGridData, positions, cutoff=None, *, valid=None
            ) -> CellGridData:
    """Rebuild from new positions, reusing the cell table when no key changed.

    Cheap pass: the bounding box, the grid geometry and every particle's
    key. If the geometry and every key are unchanged (the reference's
    ``rebuild_mut`` fast path, cellgrid.rs:264-286), the occupied-cell
    table is kept and the coordinates are regrouped by a stable sort of the
    unchanged keys, which reproduces the build's permutation. Otherwise
    the slow path bins and sorts again (`bin_and_sort`), with the grid's
    ``max_cells``.

    Where the JAX package picks the path on the device (``lax.cond``), this
    reads the one ``unchanged`` flag back to the host: its callers read the
    grid back anyway (`api.CellGrid.rebuild` reads ``max_cell_count()``).
    ``positions`` must have the grid's shape.
    """
    device = grid.device
    positions = torch.as_tensor(positions, device=device)
    if tuple(positions.shape) != tuple(grid.sorted_pos.shape):
        raise ValueError(f"rebuild takes positions of the grid's shape "
                         f"{tuple(grid.sorted_pos.shape)}, got {tuple(positions.shape)}")
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    if cutoff is None:
        cutoff = grid.info.cutoff
    sdim = grid.info.dim
    info = GridInfo.create(aabb_from_positions(positions[:, :sdim], valid), cutoff)
    new_keys = compute_keys(positions[:, :sdim], info, valid)
    old = grid.info
    unchanged = ((info.shape == old.shape).all()
                 & (info.strides == old.strides).all()
                 & (info.origin == old.origin).all()
                 & (info.cutoff == old.cutoff)
                 & (new_keys == grid.bins.keys).all())
    if not bool(unchanged):
        bins, sorted_pos = bin_and_sort(positions, cutoff,
                                        max_cells=grid.bins.max_cells,
                                        valid=valid, info=info)
        return CellGridData(bins=bins, sorted_pos=sorted_pos, sorted_ids=bins.perm)
    b = grid.bins
    _, perm = torch.sort(b.keys, stable=True)
    perm = perm.to(torch.int32)
    bins = dataclasses.replace(b, info=info, keys=new_keys, perm=perm)
    return CellGridData(bins=bins, sorted_pos=positions[perm.long()],
                        sorted_ids=perm)
