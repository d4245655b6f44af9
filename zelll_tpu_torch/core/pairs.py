"""Pair enumeration over the cell grid: the general bucketed path.

PyTorch counterpart of ``zelll_tpu/core/pairs.py``, plain torch (the JAX
package's version is plain XLA too). The reference enumerates candidate
pairs lazily per cell (zelll `src/cellgrid/iters.rs:218-241`): triangular
pairs within each cell plus the cartesian product with the 13-cell
*half-space* stencil, each unordered pair emitted exactly once. Here the
same candidate set is produced as masked dense blocks:

* occupied cells are processed in fixed-size chunks (a Python loop where
  the JAX package runs ``lax.scan``), so peak memory never holds the whole
  candidate set;
* each cell contributes a padded *bucket* of up to K particles. Particles
  are sorted by cell key, so a bucket is the contiguous window
  ``sorted_pos[start : start + K]``;
* neighbour cells are found by a vectorised binary search
  (`torch.searchsorted`) of ``cell_key + offset`` in the ascending
  occupied-cell table, whose tail is SENTINEL_KEY;
* uniqueness: intra-cell pairs are the k1 < k2 triangle, inter-cell pairs
  use the half stencil (iters.rs:29-37, :58-63).

Masked bucket slots point at the padding slot ``n``. The JAX package drops
scatters to it; torch's ``index_add_`` would raise (or trip a device
assert), so every scatter here writes into ``n + 1`` rows and the last one
is sliced off.

Each scan reads the number of occupied cells back once and loops over the
chunks that hold them; the chunks past it hold no cell and add nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from .dense import DenseTable, dense_rows_for_keys
from .geometry import full_stencil, half_stencil
from .grid import CellGridData

__all__ = [
    "PairBlock",
    "QueryResult",
    "scan_cell_chunks",
    "pair_sum",
    "pair_forces",
    "pair_stress",
    "pair_energy_per_particle",
    "count_pairs",
    "materialize_pairs",
    "query_neighbors",
]


def _dsq(a, b):
    """Squared distance, the spatial axis unrolled: ((d0 d0 + d1 d1) + d2 d2)
    in the JAX package's order of operations."""
    d0 = a[..., 0] - b[..., 0]
    total = d0 * d0
    for ax in range(1, a.shape[-1]):
        d = a[..., ax] - b[..., ax]
        total = total + d * d
    return total


def _gather_window(grid: CellGridData, starts, counts, K: int):
    """Padded bucket gather: the contiguous K-window of each cell.

    Returns (pos, slots, mask) of shapes (..., K, N), (..., K), (..., K).
    Masked slots point at ``n`` and their coordinates are those of slot 0:
    callers apply ``mask``.
    """
    n = grid.n
    k_iota = torch.arange(K, dtype=torch.int32, device=grid.device)
    slots = starts[..., None] + k_iota
    mask = k_iota < counts[..., None]
    gslots = torch.where(mask, slots, torch.zeros_like(slots))
    pos = grid.sorted_pos[gslots.long()]
    slots = torch.where(mask, slots, torch.full_like(slots, n))
    return pos, slots, mask


def _table_rows(grid: CellGridData, qkeys, dense: DenseTable | None):
    """Occupied-cell table rows of the cells keyed ``qkeys``, and whether
    each is occupied: the dense table's O(1) lookup, or a binary search
    over the ascending ``cell_keys`` (the reference's hashmap lookups,
    iters.rs:197-214)."""
    b = grid.bins
    mc = b.max_cells
    if dense is not None:
        rows = dense_rows_for_keys(dense, qkeys, mc)
        return rows, rows < mc
    pos = torch.searchsorted(b.cell_keys, qkeys.contiguous()).to(torch.int32)
    cpos = pos.clamp(0, mc - 1)
    return cpos, b.cell_keys[cpos.long()] == qkeys


def _neighbor_rows(grid: CellGridData, rows, stencil, dense=None):
    """Occupied-cell table rows of stencil neighbours, or max_cells where
    the neighbour cell is empty."""
    qkeys = grid.bins.cell_keys[rows.long()][..., None] + stencil
    found_rows, found = _table_rows(grid, qkeys, dense)
    return torch.where(found, found_rows,
                       torch.full_like(found_rows, grid.bins.max_cells))


def _strict_upper(K: int, device) -> torch.Tensor:
    return torch.ones((K, K), dtype=torch.bool, device=device).triu(1)


@dataclasses.dataclass
class PairBlock:
    """One chunk of candidate-pair structure handed to reduction bodies.

    Shapes: B = cells per chunk, K = bucket capacity, S = stencil size.
    ``own_*``: (B, K, ...) the chunk cells' own particles.
    ``nb_*``: (B, S*K, ...) particles of the stencil neighbour cells.
    ``row_valid``: (B,) whether the row is a real occupied cell.
    """

    own_pos: torch.Tensor
    own_slots: torch.Tensor
    own_mask: torch.Tensor
    nb_pos: torch.Tensor
    nb_slots: torch.Tensor
    nb_mask: torch.Tensor
    row_valid: torch.Tensor

    def intra_mask(self):
        """(B, K, K) unique-pair mask (k1 < k2) of own particles."""
        K = self.own_mask.shape[-1]
        return (_strict_upper(K, self.own_mask.device)
                & self.own_mask[:, :, None] & self.own_mask[:, None, :]
                & self.row_valid[:, None, None])

    def inter_mask(self):
        """(B, K, S*K) mask of own x neighbour particles."""
        return (self.own_mask[:, :, None] & self.nb_mask[:, None, :]
                & self.row_valid[:, None, None])

    def intra_dsq(self):
        """(B, K, K) squared distances + unique-pair mask (k1 < k2)."""
        dsq = _dsq(self.own_pos[:, :, None, :], self.own_pos[:, None, :, :])
        return dsq, self.intra_mask()

    def inter_dsq(self):
        """(B, K, S*K) squared distances own x neighbours + mask."""
        dsq = _dsq(self.own_pos[:, :, None, :], self.nb_pos[:, None, :, :])
        return dsq, self.inter_mask()


def scan_cell_chunks(grid: CellGridData, body: Callable, init, *, K: int,
                     chunk: int = 256, half: bool = True,
                     dense: DenseTable | None = None):
    """Fold ``body(carry, PairBlock) -> carry`` over occupied-cell chunks.

    The blockwise streaming skeleton: chunks of the pair structure are
    produced and consumed without materialising the whole candidate set.
    ``dense`` switches the neighbour-cell lookup from binary search to the
    dense key-indexed table (`core.dense.DenseTable`); check ``dense.fits``
    alongside the usual capacity flags.
    """
    b = grid.bins
    mc = b.max_cells
    device = grid.device
    stencil = half_stencil(grid.info) if half else full_stencil(grid.info)
    S = stencil.shape[0]
    num_cells = int(b.num_cells)
    carry = init
    for ci in range(math.ceil(min(num_cells, mc) / chunk)):
        rows = ci * chunk + torch.arange(chunk, dtype=torch.int32, device=device)
        row_valid = rows < num_cells
        rows = rows.clamp(max=mc - 1)
        own_starts = b.cell_starts[rows.long()]
        own_counts = torch.where(row_valid, b.cell_counts[rows.long()],
                                 torch.zeros_like(rows))
        own_pos, own_slots, own_mask = _gather_window(grid, own_starts,
                                                      own_counts, K)
        nrows = _neighbor_rows(grid, rows, stencil, dense)  # (B, S)
        nb_found = nrows < mc
        gn = torch.where(nb_found, nrows, torch.zeros_like(nrows)).long()
        nb_starts = b.cell_starts[gn]
        nb_counts = torch.where(nb_found, b.cell_counts[gn],
                                torch.zeros_like(nrows))
        nb_pos, nb_slots, nb_mask = _gather_window(grid, nb_starts, nb_counts, K)
        block = PairBlock(
            own_pos=own_pos,
            own_slots=own_slots,
            own_mask=own_mask,
            nb_pos=nb_pos.reshape(chunk, S * K, -1),
            nb_slots=nb_slots.reshape(chunk, S * K),
            nb_mask=nb_mask.reshape(chunk, S * K),
            row_valid=row_valid,
        )
        carry = body(carry, block)
    return carry


def _cut(mask, dsq, cutoff_sq):
    """``mask`` restricted to ``dsq < cutoff_sq`` (strict, as the
    reference's benchmark filters, benches/lj.rs:83-90)."""
    if cutoff_sq is None:
        return mask
    return mask & (dsq < torch.as_tensor(cutoff_sq, dtype=dsq.dtype,
                                         device=dsq.device))


def _masked(fn, dsq, mask, dtype):
    """fn(dsq) where ``mask``, 0 elsewhere; masked entries are evaluated at
    dsq = 1, so no inf or NaN reaches a sum."""
    vals = fn(torch.where(mask, dsq, torch.ones_like(dsq))).to(dtype)
    return torch.where(mask, vals, torch.zeros_like(vals))


def pair_sum(grid: CellGridData, fn: Callable, *, K: int, chunk: int = 256,
             cutoff_sq=None, accum_dtype=None, dense=None):
    """Sum ``fn(dsq)`` over all unique candidate pairs (optionally distance
    filtered) without materialising a pair list.

    The fused equivalent of ``cg.particle_pairs().filter(dist).map(fn).sum()``
    in the reference's LJ benchmark (benches/lj.rs:81-93).
    """
    dtype = accum_dtype or grid.sorted_pos.dtype

    def body(acc, blk: PairBlock):
        for dsq, m in (blk.intra_dsq(), blk.inter_dsq()):
            acc = acc + _masked(fn, dsq, _cut(m, dsq, cutoff_sq), dtype).sum()
        return acc

    return scan_cell_chunks(grid, body, torch.zeros((), dtype=dtype, device=grid.device),
                            K=K, chunk=chunk, half=True, dense=dense)


def _axis_pairs(a_pos, b_pos):
    """Per-axis separations a - b of (B, Ka) x (B, Kb) particles."""
    return [a_pos[..., ax][:, :, None] - b_pos[..., ax][:, None, :]
            for ax in range(a_pos.shape[-1])]


def _add_rows(acc, slots, values):
    """acc[slots] += values, repeated slots accumulating (slot n is the
    dump row)."""
    acc.index_add_(0, slots.reshape(-1).long(),
                   values.reshape(-1, *acc.shape[1:]))


def pair_forces(grid: CellGridData, gfn: Callable, *, K: int, chunk: int = 256,
                cutoff_sq=None, dense=None):
    """Per-particle pairwise forces, input particle order.

    For each unique pair (i, j): ``f_i += (p_i - p_j) * gfn(dsq)`` and
    ``f_j -= ...`` (Newton's third law: the half-space enumeration sees
    each pair once). ``gfn(dsq)`` is the scalar factor such that the force
    is that factor times the separation vector, e.g. ``-2 dV/d(dsq)``.
    """
    n, dim = grid.sorted_pos.shape
    dtype = grid.sorted_pos.dtype

    def body(forces, blk: PairBlock):
        # intra-cell
        ds = _axis_pairs(blk.own_pos, blk.own_pos)
        dsq = sum(d * d for d in ds)
        g = _masked(gfn, dsq, _cut(blk.intra_mask(), dsq, cutoff_sq), dtype)
        f_i = torch.stack([(d * g).sum(2) for d in ds], -1)
        f_j = torch.stack([-(d * g).sum(1) for d in ds], -1)
        _add_rows(forces, blk.own_slots, f_i + f_j)
        # inter-cell
        ds = _axis_pairs(blk.own_pos, blk.nb_pos)
        dsq = sum(d * d for d in ds)
        g = _masked(gfn, dsq, _cut(blk.inter_mask(), dsq, cutoff_sq), dtype)
        _add_rows(forces, blk.own_slots, torch.stack([(d * g).sum(2) for d in ds], -1))
        _add_rows(forces, blk.nb_slots, torch.stack([-(d * g).sum(1) for d in ds], -1))
        return forces

    forces = torch.zeros((n + 1, dim), dtype=dtype, device=grid.device)
    forces = scan_cell_chunks(grid, body, forces, K=K, chunk=chunk, half=True,
                              dense=dense)
    return grid.unsort(forces[:n])


def pair_stress(grid: CellGridData, gfn: Callable, *, K: int, chunk: int = 256,
                cutoff_sq=None, slot_weights=None, dense=None):
    """Configurational stress (pair-virial) tensor, summed over unique pairs:

        sigma_ab = sum_pairs w_pair * gfn(dsq) * dx_a * dx_b

    with ``dx = p_i - p_j`` and ``gfn`` the force factor (force on i from j
    is ``gfn(dsq) * dx``, as in `pair_forces`). The trace is the scalar
    virial ``sum f_ij . r_ij``; divide by volume (and add the kinetic
    term) for the pressure tensor.

    ``slot_weights``: optional (n,) per-SORTED-slot weights;
    ``w_pair = 0.5 * (w_i + w_j)`` (the periodic ownership rule: 1 on real
    rows, 0 on ghost images). Default weight 1.

    Returns a symmetric (dim, dim) tensor.
    """
    dim = grid.sorted_pos.shape[1]
    dtype = grid.sorted_pos.dtype
    device = grid.device
    w_ext = None
    if slot_weights is not None:
        # masked slots point at n: a zero dump row
        w = torch.as_tensor(slot_weights, device=device).to(dtype)
        w_ext = torch.cat([w, torch.zeros((1,), dtype=dtype, device=device)])

    def accumulate(acc, ds, g, slots_a, slots_b):
        if w_ext is not None:
            g = g * (0.5 * (w_ext[slots_a.long()][:, :, None]
                            + w_ext[slots_b.long()][:, None, :]))
        for a in range(dim):
            gda = g * ds[a]
            for b in range(a, dim):
                acc[a][b] = acc[a][b] + (gda * ds[b]).sum()
        return acc

    def body(acc, blk: PairBlock):
        # intra-cell (strictly upper triangle: each unordered pair once)
        ds = _axis_pairs(blk.own_pos, blk.own_pos)
        dsq, m = blk.intra_dsq()
        acc = accumulate(acc, ds, _masked(gfn, dsq, _cut(m, dsq, cutoff_sq), dtype),
                         blk.own_slots, blk.own_slots)
        # inter-cell (half stencil: each unordered pair once)
        ds = _axis_pairs(blk.own_pos, blk.nb_pos)
        dsq, m = blk.inter_dsq()
        return accumulate(acc, ds, _masked(gfn, dsq, _cut(m, dsq, cutoff_sq), dtype),
                          blk.own_slots, blk.nb_slots)

    zero = torch.zeros((), dtype=dtype, device=device)
    init = [{b: zero for b in range(a, dim)} for a in range(dim)]
    acc = scan_cell_chunks(grid, body, init, K=K, chunk=chunk, half=True, dense=dense)
    out = torch.zeros((dim, dim), dtype=dtype, device=device)
    for a in range(dim):
        for b in range(a, dim):
            out[a, b] = acc[a][b]
            out[b, a] = acc[a][b]
    return out


def pair_energy_per_particle(grid: CellGridData, fn: Callable, *, K: int,
                             chunk: int = 256, cutoff_sq=None, dense=None):
    """Per-particle half-energies e_i = 1/2 sum_j fn(dsq_ij), input order.

    Each unique pair contributes fn/2 to both ends, so summing e_i over any
    subset S counts pairs inside S once and boundary pairs half: the
    building block of halo-correct distributed energy sums.
    """
    n = grid.n
    dtype = grid.sorted_pos.dtype

    def half(dsq, mask):
        return 0.5 * _masked(fn, dsq, _cut(mask, dsq, cutoff_sq), dtype)

    def body(acc, blk: PairBlock):
        v = half(*blk.intra_dsq())
        _add_rows(acc, blk.own_slots, v.sum(2))
        _add_rows(acc, blk.own_slots, v.sum(1))
        v = half(*blk.inter_dsq())
        _add_rows(acc, blk.own_slots, v.sum(2))
        _add_rows(acc, blk.nb_slots, v.sum(1))
        return acc

    acc = torch.zeros((n + 1,), dtype=dtype, device=grid.device)
    acc = scan_cell_chunks(grid, body, acc, K=K, chunk=chunk, half=True, dense=dense)
    return grid.unsort(acc[:n])


def _ones_int64(dsq):
    return torch.ones_like(dsq, dtype=torch.int64)


def count_pairs(grid: CellGridData, *, K: int, chunk: int = 256, cutoff_sq=None,
                dense=None):
    """Number of unique candidate (or distance-filtered) pairs, int64 (as
    the JAX package counts under x64)."""
    return pair_sum(grid, _ones_int64, K=K, chunk=chunk, cutoff_sq=cutoff_sq,
                    accum_dtype=torch.int64, dense=dense)


def materialize_pairs(grid: CellGridData, *, K: int, max_pairs: int,
                      chunk: int = 256, cutoff_sq=None, dense=None):
    """Materialise unique candidate pairs as input-particle-id arrays.

    Returns ``(i, j, count, overflow)``; rows past ``count`` are n
    (padding). Pair order is deterministic (cell-table order) but
    unspecified, like the reference (iters.rs:251). The pairs are compacted
    on the device by a running cumsum, so one transfer yields the whole
    list: the path behind the iterator protocol
    (python/src/lib.rs:262-345). Pairs past ``max_pairs`` land in a dump
    row (the JAX package drops them) and ``overflow`` reports them.
    """
    n = grid.n
    device = grid.device
    ids_i = torch.full((max_pairs + 1,), n, dtype=torch.int32, device=device)
    ids_j = torch.full((max_pairs + 1,), n, dtype=torch.int32, device=device)

    def emit(state, dsq, mask, slots_a, slots_b):
        ids_i, ids_j, offset = state
        flat = _cut(mask, dsq, cutoff_sq).reshape(-1)
        a = torch.broadcast_to(slots_a, mask.shape).reshape(-1)
        b = torch.broadcast_to(slots_b, mask.shape).reshape(-1)
        pos = torch.cumsum(flat, 0, dtype=torch.int64) - 1 + offset
        tgt = torch.where(flat & (pos < max_pairs), pos,
                          torch.full_like(pos, max_pairs))
        fill = torch.full_like(a, n)
        ids_i[tgt] = torch.where(flat, a, fill)
        ids_j[tgt] = torch.where(flat, b, fill)
        return ids_i, ids_j, offset + flat.sum(dtype=torch.int64)

    def body(state, blk: PairBlock):
        dsq, m = blk.intra_dsq()
        state = emit(state, dsq, m, blk.own_slots[:, :, None],
                     blk.own_slots[:, None, :])
        dsq, m = blk.inter_dsq()
        return emit(state, dsq, m, blk.own_slots[:, :, None],
                    blk.nb_slots[:, None, :])

    ids_i, ids_j, total = scan_cell_chunks(
        grid, body, (ids_i, ids_j, torch.zeros((), dtype=torch.int64, device=device)),
        K=K, chunk=chunk, half=True, dense=dense)
    # sorted slots -> input particle ids (padding slot n -> n)
    sid = torch.cat([grid.sorted_ids.to(torch.int32),
                     torch.full((1,), n, dtype=torch.int32, device=device)]).long()
    i = sid[ids_i[:max_pairs].long()].to(torch.int32)
    j = sid[ids_j[:max_pairs].long()].to(torch.int32)
    return i, j, total, total > max_pairs


class QueryResult(NamedTuple):
    """Batched neighbourhood query result (all padded to S1K = 3^N * K).

    ids: (Q, S1K) input particle indices (padding -> n)
    slots: (Q, S1K) sorted-slot indices (padding -> n)
    pos: (Q, S1K, N) neighbour coordinates (garbage where masked)
    mask: (Q, S1K) validity
    valid: (Q,) query-location validity (the None analogue, util.rs:245-256)
    """

    ids: torch.Tensor
    slots: torch.Tensor
    pos: torch.Tensor
    mask: torch.Tensor
    valid: torch.Tensor


def query_neighbors(grid: CellGridData, points, *, K: int, dense=None) -> QueryResult:
    """Batched point queries: the full-space neighbourhood of each point.

    The batched analogue of `CellGrid::query_neighbors` (cellgrid.rs:391-401):
    the query cell's own slice followed by all 3^N - 1 full-space neighbour
    slices, padded to K per cell.
    """
    n = grid.n
    device = grid.device
    points = torch.as_tensor(points, dtype=grid.sorted_pos.dtype, device=device)
    idx, ok = grid.info.try_cell_index(points)
    keys = grid.info.flatten_index(idx)
    # own cell first, then the neighbours in stencil order
    stencil = torch.cat([torch.zeros((1,), dtype=torch.int32, device=device),
                         full_stencil(grid.info)])
    qkeys = keys[:, None] + stencil
    rows, found = _table_rows(grid, qkeys, dense)
    found = found & ok[:, None]
    rows = torch.where(found, rows, torch.zeros_like(rows)).long()
    starts = grid.bins.cell_starts[rows]
    counts = torch.where(found, grid.bins.cell_counts[rows],
                         torch.zeros_like(starts))
    ppos, slots, mask = _gather_window(grid, starts, counts, K)
    Q = points.shape[0]
    S1K = stencil.shape[0] * K
    slots = slots.reshape(Q, S1K)
    sid = torch.cat([grid.sorted_ids.to(torch.int32),
                     torch.full((1,), n, dtype=torch.int32, device=device)])
    return QueryResult(ids=sid[slots.long()], slots=slots,
                       pos=ppos.reshape(Q, S1K, -1), mask=mask.reshape(Q, S1K),
                       valid=ok)
