"""Sort-based particle binning into a CSR table of occupied cells.

PyTorch counterpart of ``zelll_tpu/core/binning.py``:

1. a flat cell key per particle,
2. one sort of the keys, then one index gather of the coordinates (the
   TPU's rule against gathers is a fact about that chip; on a GPU the
   gather is a single coalesced pass),
3. segment boundaries on the sorted keys -> ``cell_keys`` (ascending),
   ``cell_starts``, ``cell_counts``.

Only occupied cells materialise (the table has ``max_cells <= n`` rows);
nothing is allocated in proportion to ``prod(shape)``.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from .geometry import SENTINEL_KEY, GridInfo, aabb_from_positions

__all__ = ["Bins", "build_bins", "bin_and_sort", "compute_keys", "sort_by_key"]


@dataclasses.dataclass(frozen=True)
class Bins:
    """CSR-like occupied-cell table over sorted particles.

    * ``info``          grid geometry
    * ``keys``          (n,) flat cell key per particle, input order
    * ``perm``          (n,) sort permutation: sorted slot -> input id
    * ``sorted_keys``   (n,) keys[perm], ascending; sentinel rows last
    * ``cell_keys``     (max_cells,) ascending occupied-cell keys, padded
                        with SENTINEL_KEY
    * ``cell_starts``   (max_cells,) first sorted slot of each cell, padded n
    * ``cell_counts``   (max_cells,) particles per cell, padded 0
    * ``num_cells``     scalar int32, number of occupied cells
    * ``num_valid``     scalar int32, number of valid particles
    * ``overflow``      scalar bool, True iff num_cells > max_cells (the
                        table is truncated; rebuild with a larger capacity)
    """

    info: GridInfo
    keys: torch.Tensor
    perm: torch.Tensor
    sorted_keys: torch.Tensor
    cell_keys: torch.Tensor
    cell_starts: torch.Tensor
    cell_counts: torch.Tensor
    num_cells: torch.Tensor
    num_valid: torch.Tensor
    overflow: torch.Tensor

    @property
    def n(self) -> int:
        return self.keys.shape[0]

    @property
    def max_cells(self) -> int:
        return self.cell_keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def max_cell_count(self) -> torch.Tensor:
        """Largest per-cell occupancy."""
        return self.cell_counts.max()


def compute_keys(positions: torch.Tensor, info: GridInfo,
                 valid: torch.Tensor | None = None) -> torch.Tensor:
    """Flat cell key per particle; padding rows get SENTINEL_KEY."""
    keys = info.flat_cell_index(positions)
    if valid is not None:
        keys = torch.where(valid, keys, SENTINEL_KEY)
    return keys


def build_bins(positions, cutoff, *, max_cells: int | None = None, valid=None,
               info: GridInfo | None = None, device=None) -> Bins:
    """Bin (n, N) positions into occupied cells. See `bin_and_sort`."""
    return bin_and_sort(positions, cutoff, max_cells=max_cells, valid=valid,
                        info=info, device=device)[0]


def sort_by_key(keys: torch.Tensor, *cols: torch.Tensor, stable: bool = False):
    """Sort ``keys`` and gather each (n, ..) array of ``cols`` into the same
    order. Returns (sorted_keys, perm (int64), sorted cols...)."""
    sorted_keys, perm = torch.sort(keys, stable=stable)
    return (sorted_keys, perm, *(c[perm] for c in cols))


def _cell_table(sorted_keys: torch.Tensor, max_cells: int):
    """The CSR table of the first ``max_cells`` occupied cells of ascending
    keys. Every row carries the index of its cell (sentinel rows a larger
    one), a non-decreasing sequence, so each cell's rows are found by two
    searches: no scatter, and no count read back from the device (boolean
    indexing would read one)."""
    n = sorted_keys.shape[0]
    device = sorted_keys.device
    valid_sorted = sorted_keys != SENTINEL_KEY
    is_start = torch.ones_like(valid_sorted)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    is_start &= valid_sorted
    num_cells = is_start.sum(dtype=torch.int32)
    num_valid = valid_sorted.sum(dtype=torch.int32)
    if n == 0:
        return (torch.full((max_cells,), SENTINEL_KEY, dtype=torch.int32, device=device),
                torch.zeros((max_cells,), dtype=torch.int32, device=device),
                torch.zeros((max_cells,), dtype=torch.int32, device=device),
                num_cells, num_valid)
    cell_of_row = torch.cumsum(is_start, 0, dtype=torch.int32) - 1
    cell_of_row = torch.where(valid_sorted, cell_of_row, torch.full_like(
        cell_of_row, torch.iinfo(torch.int32).max))
    cells = torch.arange(max_cells, dtype=torch.int32, device=device)
    first = torch.searchsorted(cell_of_row, cells).to(torch.int32)
    counts = torch.searchsorted(cell_of_row, cells, right=True).to(torch.int32) - first
    occupied = cells < num_cells
    cell_keys = torch.where(occupied, sorted_keys[first.clamp(max=n - 1).long()],
                            torch.full_like(first, SENTINEL_KEY))
    cell_starts = torch.where(occupied, first, torch.full_like(first, n))
    return cell_keys, cell_starts, counts, num_cells, num_valid


def bin_and_sort(
    positions,
    cutoff,
    *,
    max_cells: int | None = None,
    valid=None,
    info: GridInfo | None = None,
    need_perm: bool = True,
    stacked: bool = True,
    auto_order: bool = False,
    stable: bool | None = None,
    device=None,
):
    """Bin (n, N) positions into occupied cells; also return the positions
    in sorted (cell-grouped) order: one (n, N) tensor, or with
    ``stacked=False`` a tuple of N sorted (n,) planes (rows of one
    (N, n) tensor), the layout the tile kernels read.

    ``max_cells`` defaults to n (never overflows). ``info`` reuses a given
    grid geometry; otherwise it is computed from the data. Columns beyond
    the spatial dimension (``info.dim``, or min(N, 3)) ride along as
    payload (e.g. split-precision low parts).

    ``stable`` defaults to ``need_perm``: a stable sort keeps each cell's
    particles in input order. With ``need_perm=False`` the returned perm is
    the identity, as in the JAX package.
    """
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    if valid is not None:
        valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    n, dim = positions.shape
    if max_cells is None:
        max_cells = max(n, 1)
    sdim = info.dim if info is not None else min(dim, 3)
    if info is None:
        aabb = aabb_from_positions(positions[:, :sdim], valid)
        info = GridInfo.create(aabb, cutoff, auto_order=auto_order)

    keys = compute_keys(positions[:, :sdim], info, valid)
    if stable is None:
        stable = need_perm
    if stacked:
        sorted_keys, perm, sorted_pos = sort_by_key(keys, positions,
                                                    stable=stable)
    else:
        sorted_keys, perm = torch.sort(keys, stable=stable)
        sorted_pos = tuple(positions.t().index_select(1, perm))
    perm = perm.to(torch.int32) if need_perm else torch.arange(
        n, dtype=torch.int32, device=device)
    cell_keys, cell_starts, cell_counts, num_cells, num_valid = _cell_table(
        sorted_keys, max_cells)
    bins = Bins(
        info=info,
        keys=keys,
        perm=perm,
        sorted_keys=sorted_keys,
        cell_keys=cell_keys,
        cell_starts=cell_starts,
        cell_counts=cell_counts,
        num_cells=num_cells,
        num_valid=num_valid,
        overflow=num_cells > max_cells,
    )
    return bins, sorted_pos
