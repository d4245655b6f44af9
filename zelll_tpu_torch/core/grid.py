"""Cell-grid state and its build.

PyTorch counterpart of ``zelll_tpu/core/grid.py``: an immutable
`CellGridData` made by `build`. Its ``sorted_pos`` is the flat particle
storage grouped by cell, with ``bins.cell_starts``/``cell_counts`` as the
per-cell slice table.
"""

from __future__ import annotations

import dataclasses

import torch

from .binning import Bins, bin_and_sort
from .geometry import GridInfo

__all__ = ["CellGridData", "build"]


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
