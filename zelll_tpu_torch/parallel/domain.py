"""Spatial domain decomposition over a mesh of shards, with halo exchange.

PyTorch counterpart of ``zelll_tpu/parallel/domain.py`` (its
``sharded_stress`` is not ported yet). The scheme is the JAX package's:

* space is cut into slabs along the sort-major axis; each shard owns one
  contiguous block of the globally key-sorted particle array, so slab
  partitioning is block partitioning of the sorted order
  (`partition_by_slab`). Keys are auto-ordered (``GridInfo.create(
  auto_order=True)``: the largest box extent gets the largest stride), so
  the slabs cut the longest box axis;
* the grid geometry is global: the bounding box is reduced with ``pmin`` /
  ``pmax`` over the mesh, so every shard bins into the same key space;
* halo exchange: each shard sends the head and tail H rows of its sorted
  block to its neighbours with ``ppermute``. Left ghosts have smaller keys
  than every owned key and right ghosts larger ones, so [left ghosts | own |
  right ghosts] stays sorted;
* forces come from [left ghosts | own | right ghosts], of which the owned
  rows are kept; energies and histograms count a pair on the shard that
  owns its larger sorted slot (``min_islot = H_eff`` over [left ghosts |
  own], the kernels' ownership rule), and ``psum`` adds the shards.

Ring-wraparound ghosts (shard 0 <-> shard D - 1) are far apart in space and
filtered by the cutoff; the tile kernels, whose window bounds need
ascending keys, get key-safe rows in their place (`_wrap_safe_ghosts`).

The mesh is `mesh.Mesh`: D shards in one process, each on a torch device
(on one card, D shards run one after another through the same kernels).
Every entry point takes the JAX package's arguments, the mesh first, and
returns a function of the positions in `partition_by_slab` order, (n, dim)
with n a multiple of D, whose outputs have the JAX function's shapes and
order; sharded outputs come back concatenated in shard order on the
mesh's first device. ``interpret`` is accepted and has no effect. On the
card the kernels take float32 coordinates; on CPU tensors (a mesh made
with ``devices="cpu"``) everything runs the plain versions, in any dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.binning import Bins, bin_and_sort, compute_keys
from ..core.geometry import Aabb, GridInfo, key_window
from ..core.grid import build
from ..core.pairs import pair_energy_per_particle, pair_forces
from ..ops.autodiff import _default_gfn
from ..ops.lag_pairs import lj_term, pair_lag_forces, pair_lag_hist, pair_lag_reduce
from ..ops.lj import lj, lj_force_factor
from ..ops.tile_pairs import tile_pair_forces, tile_pair_hist, tile_pair_reduce
from .mesh import (
    AXIS,
    Mesh,
    all_gather,
    axis_index,
    axis_size,
    make_mesh,
    pmax,
    pmin,
    ppermute,
    psum,
    shard_map,
)

__all__ = [
    "make_mesh",
    "partition_by_slab",
    "sharded_md_step",
    "sharded_lj_energy",
    "sharded_pair_hist",
    "make_sharded_potential",
    "repartition",
    "repartition_exchange",
    "halo_coverage_ok",
]

_INT32_MAX = int(np.iinfo(np.int32).max)


def partition_by_slab(positions, cutoff, n_devices: int):
    """Host-side global partition: sort particles by cell key and split the
    sorted order into equal blocks (= spatial slabs of the sort-major,
    largest-extent, axis). Returns (positions_sorted, n_local) with n
    padded to a multiple of the device count by far-away spread
    coordinates. The key order mirrors the device-side
    ``GridInfo.create(auto_order=True)`` binning (a stable argsort of the
    cell counts), so the slab invariant holds on the shards. Host numpy,
    bit for bit the JAX package's.
    """
    pts = np.asarray(positions)
    n = pts.shape[0]
    n_local = -(-n // n_devices)
    n_pad = n_local * n_devices - n

    inf = pts.min(axis=0)
    sup = pts.max(axis=0)
    # auto-ordered padded-stride keys, the math of
    # GridInfo.create(auto_order=True) on the host
    shape = np.floor((sup - inf) / cutoff).astype(np.int64) + 1
    perm = np.argsort(shape, kind="stable")
    padded = shape[perm] + 4
    s = np.concatenate([[1], np.cumprod(padded[:-1])])
    strides = np.empty_like(s)
    strides[perm] = s
    major = int(perm[-1])  # the largest extent carries the largest stride
    keys = (np.floor((pts - inf) / cutoff).astype(np.int64) * strides).sum(1)
    order = np.argsort(keys, kind="stable")
    out = pts[order]
    if n_pad:
        # key-safe padding: beyond sup along the sort-major axis, one empty
        # cell apart, so pads sort last, land in distinct cells and stay
        # more than a cutoff from everything, each other included
        # (coordinates ~1e12 would overflow the f32 flat-key conversion)
        pad = np.tile(inf, (n_pad, 1)).astype(pts.dtype)
        pad[:, major] = sup[major] + 2.0 * cutoff * np.arange(2, n_pad + 2)
        out = np.vstack([out, pad])
    return out, n_local


def _global_grid_info(local_pos, cutoff) -> GridInfo:
    """Grid geometry from the global bounding box (``pmin``/``pmax`` over
    the mesh), with the auto-ordered strides of `partition_by_slab`'s host
    keys: both must agree, or the slab invariant (ascending keys across the
    shards' blocks) breaks."""
    inf = pmin(local_pos.amin(0))
    sup = pmax(local_pos.amax(0))
    return GridInfo.create(Aabb(inf=inf, sup=sup), cutoff, auto_order=True)


def _halo_exchange(arr, H: int):
    """Send the tail H rows right and the head H rows left around the ring.
    Returns (from_left, from_right).

    A one-shard mesh needs no halo: the ghosts are empty (H is then 0,
    `_h_eff`)."""
    nd = axis_size()
    if nd == 1:
        z = arr.new_zeros((0, arr.shape[1]))
        return z, z
    n = arr.shape[0]
    fwd = [(i, (i + 1) % nd) for i in range(nd)]
    bwd = [(i, (i - 1) % nd) for i in range(nd)]
    return (ppermute(arr[n - H:].contiguous(), fwd),
            ppermute(arr[:H].contiguous(), bwd))


def _h_eff(H: int, n_loc: int) -> int:
    """Effective halo: 0 on a one-shard mesh (no exchange), otherwise
    clamped to the local block (ghosts are slices of a neighbour's block,
    so the halo cannot exceed the block)."""
    if axis_size() == 1:
        return 0
    return min(H, n_loc)


def _halo_needed(sorted_keys_loc, strides, *, both_sides=True, reach=None):
    """The rows of this shard's sorted block that its neighbours' windows
    reach: (by the right neighbour, my keys >= its smallest - W, a suffix;
    by the left one, my keys <= its largest + W, a prefix, only with
    ``both_sides``), each an int64 0 where there is no such neighbour (the
    ring's ends, which are far apart). The counts `halo_coverage_ok` holds
    against the halo."""
    nd = axis_size()
    idx = axis_index()
    device = sorted_keys_loc.device
    w = key_window(strides, reach).to(device=device, dtype=sorted_keys_loc.dtype)
    fwd = [(i, (i + 1) % nd) for i in range(nd)]
    bwd = [(i, (i - 1) % nd) for i in range(nd)]
    needed_r = needed_l = torch.zeros((), dtype=torch.int64, device=device)
    right_min = ppermute(sorted_keys_loc[0], bwd)
    if idx < nd - 1:
        needed_r = (sorted_keys_loc >= right_min - w).sum()
    if both_sides:
        left_max = ppermute(sorted_keys_loc[-1], fwd)
        if idx > 0:
            needed_l = (sorted_keys_loc <= left_max + w).sum()
    return needed_r, needed_l


def halo_coverage_ok(sorted_keys_loc, strides, H_eff, *, both_sides=True,
                     reach=None) -> torch.Tensor:
    """Per-shard halo capacity check, the slab-boundary analogue of
    `lag_coverage_ok` (one shifted key compare per direction).

    ``reach``: per-axis cell-distance multipliers of the widened
    minimum-image key window (`geometry.key_window`).

    A shard's ghosts are the tail/head H_eff rows of its neighbours' sorted
    blocks. Every particle a neighbour could pair with must lie inside
    those rows, or boundary pairs are silently dropped (`_halo_needed`
    counts them):

    * needed-by-right: my rows with key >= right_min - W (a suffix of my
      ascending keys): at most H_eff of them, and fewer than n_local unless
      I am shard 0 (a wholly needed block means the window may reach past
      me to a shard whose particles are never exchanged);
    * needed-by-left, mirrored, only with ``both_sides`` (the force paths
      need both halos; the energy and histogram kernels read left ghosts
      only, a pair being owned by its larger-slot end).

    Ring-wraparound edges (shard 0 <-> D - 1) are far apart by the slab
    invariant and excluded. Returns this shard's flag (a bool tensor);
    `_all_ok` reduces it over the mesh.
    """
    nd = axis_size()
    if nd == 1:
        return torch.ones((), dtype=torch.bool, device=sorted_keys_loc.device)
    idx = axis_index()
    n_loc = sorted_keys_loc.shape[0]
    needed_r, needed_l = _halo_needed(sorted_keys_loc, strides, both_sides=both_sides,
                                      reach=reach)
    ok = (needed_r <= H_eff) & (needed_l <= H_eff)
    if idx != 0:
        ok = ok & (needed_r < n_loc)
    if idx != nd - 1:
        ok = ok & (needed_l < n_loc)
    return ok


def _all_ok(flag) -> torch.Tensor:
    """All-reduce a per-shard bool over the mesh."""
    return pmin(flag.to(torch.int32)) > 0


def _lag_ok_ext(keys_ext, strides, L: int, H_eff: int, n_loc: int) -> torch.Tensor:
    """`lag_coverage_ok` over the halo-extended block [gl | own | gr?].

    Ring-wraparound ghosts (shard 0's left ghosts, shard D - 1's right
    ones) are far away rows whose keys break the ascending-key proxy
    without forming a pair (the cutoff filters them), so comparisons that
    touch them are left out.
    """
    nd = axis_size()
    idx = axis_index()
    ntot = keys_ext.shape[0]
    device = keys_ext.device
    if ntot <= L:
        return torch.ones((), dtype=torch.bool, device=device)
    w = key_window(strides).to(device)
    diff_ok = keys_ext[L:] - keys_ext[:-L] > w
    i = torch.arange(L, ntot, device=device)
    genuine = torch.ones_like(diff_ok)
    if idx == 0:
        genuine = genuine & (i - L >= H_eff)
    if idx == nd - 1:
        genuine = genuine & (i < H_eff + n_loc)
    return (diff_ok | ~genuine).all()


def _wrap_safe_ghosts(gl, gr, info: GridInfo):
    """Replace ring-wraparound ghosts with key-safe out-of-box rows.

    Shard 0's left ghosts come from shard D - 1 (and D - 1's right ghosts
    from shard 0): far away rows whose keys break the ascending-key
    precondition of the tile kernels' window bounds
    (`segments.chunk_bounds`). They become rows below the box along the
    sort-major axis (left) or above it (right), ascending in key with their
    slot, at least 1.5 cutoffs from the box and 2 from each other, so keys
    stay ascending and no pair within the cutoff can hold one
    (`_ghost_layers`). The ghost rows keep their payload columns.

    Deviation from the JAX package, which stacks one ghost every two
    cells along the major axis: its keys span 2 H_eff major strides, which
    passes 2^24 (where the packed tile path's f32 keys round, and its flag
    drops) at a few thousand ghosts of a cube and int32 at n = 1e7. Here
    the ghosts fill layers of the box's cross-section, so they span about
    2 H_eff / (cross-section cells / 4) major strides. No pair holds a
    ghost either way, so every result but the flag is the JAX package's.
    """
    nd = axis_size()
    idx = axis_index()
    if nd == 1 or gl.shape[0] == 0:
        return gl, gr
    if idx == 0:
        gl = _ghost_layers(gl.shape[0], info, gl.dtype, below=True)
    if idx == nd - 1:
        gr = _ghost_layers(gr.shape[0], info, gr.dtype, below=False)
    return gl, gr


def _ghost_layers(rows: int, info: GridInfo, dtype, *, below: bool) -> torch.Tensor:
    """``rows`` points at cell centres outside the box, in layers across
    the sort-major axis (every other cell of the other axes, every other
    layer: 2 cells apart on each axis), the layers below the box's first
    cell layer (``below``, the deepest first) or above its last, filled in
    the order of the keys (the smaller strides' axes fastest), so their
    keys ascend with the row: below every real key, or above."""
    device = info.strides.device
    dim = info.dim
    order = torch.argsort(info.strides)  # the major axis last
    onehot = torch.nn.functional.one_hot(order, dim)  # row k: axis order[k]
    sites = ((info.shape.long() + 1) // 2)[order]  # every other cell
    rest = torch.arange(rows, device=device)
    cells = torch.zeros((rows, dim), dtype=torch.int64, device=device)
    for k in range(dim - 1):
        cells += (2 * (rest % sites[k]))[:, None] * onehot[k]
        rest = rest // sites[k]
    if below:
        major = -2 * (rest[-1] + 1 - rest)
    else:
        major = info.shape.long()[order[-1]] + 1 + 2 * rest
    cells += major[:, None] * onehot[dim - 1]
    return info.aabb.inf.to(dtype) + info.cutoff.to(dtype) * (cells.to(dtype) + 0.5)


def _tile_energy_ext(ext, keys_ext, info, csq, H_eff, MAXJ):
    """Owned-pair energy over [left ghosts | own] (``ext``, the wraparound
    ghosts key-safe, and its keys) through the tile kernel (larger-slot
    ownership through min_islot). Returns (energy, flag)."""
    return tile_pair_reduce(ext, keys_ext, info.strides, csq, MAXJ=MAXJ, min_islot=H_eff)


class SlabBlock(NamedTuple):
    """One shard's halo-extended block (`slab_block`)."""

    ext: torch.Tensor  # [left ghosts | own (| right ghosts)], payload kept
    keys: torch.Tensor  # the keys of ext's coordinates
    bins: Bins  # the local sort of the owned block (sorted_keys, perm)
    info: GridInfo  # the global grid
    H_eff: int  # the left ghosts' rows
    n_loc: int  # the owned rows

    def left(self):
        """(ext, keys) of [left ghosts | own]: a prefix of a ``right``
        block."""
        m = self.H_eff + self.n_loc
        return self.ext[:m], self.keys[:m]


def slab_block(pos, cutoff, H: int, *, n_payload: int = 0, right: bool = False,
               wrap_safe: bool = False) -> SlabBlock:
    """The per-shard steps every slab entry point starts with (inside
    `shard_map`): the global grid (`_global_grid_info`), the local sort of
    the owned block, the halo exchange (`_halo_exchange`; the ``n_payload``
    columns after the coordinates ride along), for the tile kernels
    (``wrap_safe``) the key-safe ring-wraparound ghosts
    (`_wrap_safe_ghosts`, payload kept), and the keys of [left ghosts |
    own], with ``right`` of [left ghosts | own | right ghosts]."""
    H_eff = _h_eff(H, pos.shape[0])
    dim = pos.shape[1] - n_payload
    info = _global_grid_info(pos[:, :dim], cutoff)
    bins, cols_s = bin_and_sort(pos, cutoff, max_cells=1, info=info)
    gl, gr = _halo_exchange(cols_s, H_eff)
    if wrap_safe:
        gl_c, gr_c = _wrap_safe_ghosts(gl[:, :dim], gr[:, :dim], info)
        if n_payload:
            gl_c, gr_c = torch.cat([gl_c, gl[:, dim:]], 1), torch.cat([gr_c, gr[:, dim:]], 1)
        gl, gr = gl_c, gr_c
    ext = torch.cat([gl, cols_s, gr] if right else [gl, cols_s])
    return SlabBlock(ext, compute_keys(ext[:, :dim], info), bins, info, H_eff,
                     cols_s.shape[0])


def _cutoff_sq(cutoff, dtype) -> torch.Tensor:
    return torch.as_tensor(cutoff, dtype=dtype) ** 2


def sharded_md_step(
    mesh: Mesh,
    *,
    cutoff: float,
    H: int,
    K: int = 32,
    dt: float = 1e-4,
    chunk: int = 64,
    use_pallas: bool = False,
    use_tile: bool = False,
    MAXJ: int = 8,
    M: int = 4096,
    L: int = 256,
    interpret: bool = False,
):
    """One velocity-Verlet-style MD step over the mesh.

    ``step(positions, velocities) -> (positions, velocities, energy,
    coverage_ok)``, positions and velocities (n, dim) in slab order. H is
    the halo capacity (particles per boundary).

    ``coverage_ok`` is the global AND of every static-capacity check: the
    halo capacity H (`halo_coverage_ok`), the lag bound L (``use_pallas``),
    the tile windows MAXJ (``use_tile``) or the cell bucket capacity K (the
    default path). False means a capacity was outgrown and pairs may be
    missing: rerun one capacity class up, never trust the step's outputs.

    The default path is the bucketed `core.pairs` one (the JAX package's
    XLA path); ``use_pallas`` runs the lag kernels per shard (forces K3 over
    [gl | own | gr], energy K1 over [gl | own] with min_islot = H_eff),
    ``use_tile`` the tile kernels (K7, K6). Each shard re-sorts its block
    locally; velocities follow. The energy counts each pair once, on the
    shard owning its larger slot.
    """
    del interpret

    def local_step(pos, vel):
        # keep the owned block sorted by key (the global order across the
        # shards is kept by the slab partition)
        b = slab_block(pos, cutoff, H, right=True, wrap_safe=use_tile)
        H_eff, n_loc, info = b.H_eff, b.n_loc, b.info
        pos_s = b.ext[H_eff:H_eff + n_loc]
        vel_s = vel[b.bins.perm.long()]
        csq = _cutoff_sq(cutoff, pos.dtype)
        halo_ok = halo_coverage_ok(b.bins.sorted_keys, info.strides, H_eff, both_sides=True)

        if use_tile:
            f, cap_ok_t = tile_pair_forces(b.ext, b.keys, info.strides, csq, MAXJ=MAXJ,
                                           gfn=lj_force_factor)
            f_own = f[H_eff:H_eff + n_loc]
            e_loc, cap_ok_e = _tile_energy_ext(*b.left(), info, csq, H_eff, MAXJ)
            energy = psum(e_loc)
            coverage_ok = _all_ok(halo_ok & cap_ok_t & cap_ok_e)
        elif use_pallas:
            f = pair_lag_forces(b.ext, b.keys, info.strides, csq, M=M, L=L,
                                gfn=lj_force_factor)
            f_own = f[H_eff:H_eff + n_loc]
            e_loc = pair_lag_reduce(*b.left(), info.strides, csq, M=M, L=L, term=lj_term,
                                    min_islot=H_eff)
            energy = psum(e_loc)
            cap_ok = _lag_ok_ext(b.keys, info.strides, L, H_eff, n_loc)
            coverage_ok = _all_ok(halo_ok & cap_ok)
        else:
            grid = build(b.ext, cutoff, info=info)
            forces = pair_forces(grid, lj_force_factor, K=K, chunk=chunk, cutoff_sq=csq)
            e_pp = pair_energy_per_particle(grid, lj, K=K, chunk=chunk, cutoff_sq=csq)
            f_own = forces[H_eff:H_eff + n_loc]
            energy = psum(e_pp[H_eff:H_eff + n_loc].sum())
            cap_ok = grid.bins.max_cell_count() <= K
            coverage_ok = _all_ok(halo_ok & cap_ok)

        vel_new = vel_s + dt * f_own
        pos_new = pos_s + dt * vel_new
        return pos_new, vel_new, energy, coverage_ok

    return shard_map(local_step, mesh, in_specs=(AXIS, AXIS),
                     out_specs=(AXIS, AXIS, None, None))


def repartition(mesh: Mesh, *, cutoff: float):
    """Global repartition: restore the slab invariant (globally key-sorted
    order, equal blocks per shard) after particles drift.

    An all_gather, a stable global sort by key and a local slice: O(n)
    replicated memory (`repartition_exchange` avoids it). Returns a
    function (positions, velocities) -> (positions, velocities) in slab
    order.
    """

    def local(pos, vel):
        info = _global_grid_info(pos, cutoff)
        allp = all_gather(pos)
        allv = all_gather(vel)
        keys = compute_keys(allp, info)
        order = torch.sort(keys, stable=True)[1]
        idx = axis_index()
        n_loc = pos.shape[0]
        mine = order[idx * n_loc:(idx + 1) * n_loc]
        return allp[mine], allv[mine]

    return shard_map(local, mesh, in_specs=(AXIS, AXIS), out_specs=(AXIS, AXIS))


def repartition_exchange(mesh: Mesh, *, cutoff: float, A: int | None = None):
    """Distributed repartition: restore the slab invariant (globally
    key-sorted order, exactly n_local per shard) without replicating the
    particle array, the sample-sort replacement of `repartition`.

    1. Local sort by cell key (velocities ride as payload).
    2. Exact splitters: the global order statistic at every rank
       d * n_local is found by a 32-step distributed binary search over the
       augmented key ``k2 = key * nd + shard`` (each step one local
       searchsorted and one ``psum``). Ties of k2 are same-key same-shard,
       so the residual split is decided by local position: the global
       order is exactly `repartition`'s (key, shard, local slot) order.
    3. Each particle's destination follows from the splitters; destinations
       ascend in sorted order, so the outgoing particles form a head run
       (to the left neighbour) and a tail run (to the right one), sent as
       fixed-capacity (A, 2 dim + 2) buffers by two ``ppermute`` calls (the
       last two columns: source shard, validity).
    4. [received left | kept | received right] is sorted again by (key,
       source shard), invalid rows last; the first n_local rows are the new
       block.

    The returned ``ok`` is False iff a particle drifted past an adjacent
    slab, a run exceeded A (default n_local // 4), or keys overflow the k2
    encoding: fall back to `repartition` then, and never trust outputs
    with a False flag. Returns step(positions, velocities) -> (positions,
    velocities, ok).
    """

    def local(pos, vel):
        n_loc = pos.shape[0]
        cap = A if A is not None else max(n_loc // 4, 1)
        cap = min(cap, n_loc)
        info = _global_grid_info(pos, cutoff)
        return _repartition_exchange_local(pos, vel, info, cutoff, cap)

    return shard_map(local, mesh, in_specs=(AXIS, AXIS), out_specs=(AXIS, AXIS, None))


def _first_at(sorted_vals, value: int, right: bool) -> torch.Tensor:
    """searchsorted of one host value in a sorted int32 tensor, as a (1,)
    tensor on its device."""
    v = torch.full((1,), value, dtype=sorted_vals.dtype, device=sorted_vals.device)
    return torch.searchsorted(sorted_vals, v, right=right).to(torch.int32)


def _repartition_exchange_local(pos, vel, info, cutoff, cap: int, ring: bool = False):
    """Per-shard body of the distributed repartition (inside `shard_map`):
    splitters by distributed binary search, then a fixed-capacity
    neighbour exchange. ``info`` fixes the key grid (the data's box for
    open boundaries, the extended grid under periodic ones).

    ``ring=True`` (periodic boxes) treats the slabs as a ring: a particle
    crossing a periodic face wraps to the other end of the key range, so
    its destination is linearly far (|dest - idx| = nd - 1) but
    ring-adjacent. Destination classes are contiguous runs of the sorted
    order (dest ascends with the key), taken as fixed-capacity slices at
    searchsorted offsets, and the two ``ppermute`` calls use full ring
    permutations. With nd <= 2 the linear transport covers the ring."""
    nd = axis_size()
    idx = axis_index()
    n_loc, dim = pos.shape
    device = pos.device
    i32 = torch.int32
    stacked = torch.cat([pos, vel], dim=1)
    # stable: the contract is bit-identity with `repartition`, whose stable
    # global sort keeps equal-key rows in (shard, input slot) order
    bins, cols = bin_and_sort(stacked, cutoff, max_cells=1, info=info,
                              need_perm=False, stable=True)
    keys = bins.sorted_keys  # (n_loc,) ascending
    k2 = keys * nd + idx
    ok_enc = keys.max() <= (_INT32_MAX - nd) // nd

    # exact splitter order statistics (distributed binary search)
    r = torch.arange(1, nd, dtype=i32, device=device) * n_loc
    lo = torch.zeros((nd - 1,), dtype=i32, device=device)
    hi = torch.full((nd - 1,), _INT32_MAX, dtype=i32, device=device)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        c_le = psum(torch.searchsorted(k2, mid, right=True).to(i32))
        found = c_le >= r + 1
        lo, hi = torch.where(found, lo, mid + 1), torch.where(found, mid, hi)
    v = lo
    cnt_lt = psum(torch.searchsorted(k2, v).to(i32))
    t = r - cnt_lt  # tie-run elements going to the left side

    # destination slab per particle (ascending in sorted order)
    iota = torch.arange(n_loc, dtype=i32, device=device)
    tie_pos = iota - torch.searchsorted(k2, k2).to(i32)
    past_cut = (k2[:, None] > v[None, :]) | (
        (k2[:, None] == v[None, :]) & (tie_pos[:, None] >= t[None, :]))
    dest = past_cut.to(i32).sum(1, dtype=i32)
    # columns: the payload (positions, velocities), the source shard (the
    # tie key: ring traffic arrives out of shard order, but the global tie
    # order is (key, shard, slot), `repartition`'s gathered order) and the
    # validity
    width = cols.shape[1] + 2
    data = torch.cat([cols, torch.full((n_loc, 1), idx, dtype=cols.dtype, device=device),
                      torch.ones((n_loc, 1), dtype=cols.dtype, device=device)], dim=1)
    ia = torch.arange(cap, dtype=i32, device=device)
    zero = data.new_zeros(())
    if ring and nd > 2:
        # ring transport: the destination classes (contiguous runs of the
        # ascending dest) as fixed-capacity slices
        tl = (idx - 1) % nd
        tr = (idx + 1) % nd
        ok_jump = ((dest == idx) | (dest == tl) | (dest == tr)).all()
        sl = _first_at(dest, tl, right=False)
        cl = _first_at(dest, tl, right=True) - sl
        sr = _first_at(dest, tr, right=False)
        cr = _first_at(dest, tr, right=True) - sr
        ok_cap = ((cl <= cap) & (cr <= cap))[0]
        dpad = torch.cat([data, data.new_zeros((cap, width))])
        lbuf = torch.where((ia < cl)[:, None], dpad[(sl + ia).long()], zero)
        rbuf = torch.where((ia < cr)[:, None], dpad[(sr + ia).long()], zero)
        recv_r = ppermute(lbuf, [(d, (d - 1) % nd) for d in range(nd)])
        recv_l = ppermute(rbuf, [(d, (d + 1) % nd) for d in range(nd)])
        vkeep = dest == idx
    else:
        # fixed-capacity adjacent exchange
        jump = dest - idx
        ok_jump = ((jump >= -1) & (jump <= 1)).all()
        cl = (dest < idx).sum(dtype=i32)
        cr = (dest > idx).sum(dtype=i32)
        ok_cap = (cl <= cap) & (cr <= cap)
        lbuf = torch.where((ia < cl)[:, None], data[:cap], zero)
        rbuf = torch.where((ia >= cap - cr)[:, None], data[n_loc - cap:], zero)
        recv_r = ppermute(lbuf, [(d, d - 1) for d in range(1, nd)])
        recv_l = ppermute(rbuf, [(d, d + 1) for d in range(nd - 1)])
        vkeep = (iota >= cl) & (iota < n_loc - cr)
    kept = torch.where(vkeep[:, None], data, zero)

    ext = torch.cat([recv_l, kept, recv_r])
    valid_ext = ext[:, width - 1] > 0.5
    keys_ext = compute_keys(ext[:, :dim], info, valid_ext)
    # one stable sort by (key, source shard), invalid rows (sentinel keys) last
    order = torch.sort(keys_ext.long() * nd + ext[:, width - 2].long(), stable=True)[1]
    mine = order[:n_loc]
    new_pos = ext[mine, :dim]
    new_vel = ext[mine, dim:2 * dim]
    ok = pmin((ok_enc & ok_jump & ok_cap).to(i32))
    return new_pos, new_vel, ok > 0


def sharded_lj_energy(
    mesh: Mesh,
    *,
    cutoff: float,
    H: int,
    K: int = 32,
    chunk: int = 64,
    use_pallas: bool = False,
    use_tile: bool = False,
    MAXJ: int = 8,
    M: int = 4096,
    L: int = 256,
    term=lj_term,
    interpret: bool = False,
    n_payload: int = 0,
):
    """Global pair energy over slab-sharded positions (exact).

    Returns ``fn(positions) -> (energy, coverage_ok)``; `sharded_md_step`
    says what the flag means. The lag path (``use_pallas``, K1) and the
    tile path (``use_tile``, K6, MAXJ its window capacity) read left ghosts
    only (larger-slot ownership, min_islot = H_eff), so their halo check is
    one-sided. ``term`` is the elementwise pair term (default LJ), summed
    over unique cutoff pairs on every path.

    ``n_payload``: the positions carry that many extra per-particle
    columns after the coordinates ((n, dim + n_payload)); they ride the
    local sort and the halo exchange, and ``term`` receives ``(dsq,
    own_0.., j_0..)``, as with `ops.potentials.lennard_jones_mixed`'s
    species plane. Lag and tile paths only, one column on the tile path.
    """
    del interpret
    if n_payload and not (use_pallas or use_tile):
        raise ValueError("payload columns need use_pallas or use_tile")
    if n_payload and use_tile and n_payload > 1:
        raise ValueError("the packed tile layout carries one payload row")

    def local(pos):
        dim = pos.shape[1] - n_payload
        # the lag and tile paths read [left ghosts | own], the default one
        # [left ghosts | own | right ghosts]
        b = slab_block(pos, cutoff, H, n_payload=n_payload,
                       right=not (use_pallas or use_tile), wrap_safe=use_tile)
        H_eff, n_loc, info = b.H_eff, b.n_loc, b.info
        csq = _cutoff_sq(cutoff, pos.dtype)
        halo_ok = halo_coverage_ok(b.bins.sorted_keys, info.strides, H_eff,
                                   both_sides=not (use_pallas or use_tile))
        ext = b.ext[:, :dim].contiguous()
        if use_tile:
            # substituted ghost rows keep their payload (their far
            # coordinates exclude every pair anyway)
            pay = b.ext[:, dim].contiguous() if n_payload else None
            e_loc, cap_ok = tile_pair_reduce(ext, b.keys, info.strides, csq, None, pay,
                                             MAXJ=MAXJ, min_islot=H_eff, term=term)
            return psum(e_loc), _all_ok(halo_ok & cap_ok)
        if use_pallas:
            e_loc = pair_lag_reduce(
                ext, b.keys, info.strides, csq,
                sorted_payload=b.ext[:, dim:] if n_payload else None,
                M=M, L=L, term=term, min_islot=H_eff)
            cap_ok = _lag_ok_ext(b.keys, info.strides, L, H_eff, n_loc)
            return psum(e_loc), _all_ok(halo_ok & cap_ok)
        grid = build(ext, cutoff, info=info)
        e_pp = pair_energy_per_particle(grid, term, K=K, chunk=chunk, cutoff_sq=csq)
        cap_ok = grid.bins.max_cell_count() <= K
        return psum(e_pp[H_eff:H_eff + n_loc].sum()), _all_ok(halo_ok & cap_ok)

    return shard_map(local, mesh, in_specs=(AXIS,), out_specs=(None, None))


def sharded_pair_hist(
    mesh: Mesh,
    edges,
    *,
    H: int,
    M: int = 1024,
    L: int = 256,
    use_tile: bool = False,
    MAXJ: int = 8,
    interpret: bool = False,
):
    """Global pair-distance histogram over slab-sharded positions:
    cumulative counts of unique pairs with ``dsq < edges[k]^2``, each pair
    counted once, on the shard owning its larger slot (min_islot over the
    left-ghost halo, the rule of the sharded energies). ``edges[-1]`` is
    the effective cutoff and sets the grid; the squared edges are rounded
    to f32, as in the JAX package. ``use_tile`` runs the tile histogram
    (K9, capacity MAXJ), else the lag one (K5). Returns ``fn(positions) ->
    ((2, K) int32 hi/lo planes, coverage_ok)``; `lag_pairs.
    combine_count_vec` gives the counts, and adjacent differences the
    shells."""
    del interpret
    cutoff = float(np.asarray(edges)[-1])
    edges_sq = torch.as_tensor(np.asarray(edges, np.float64) ** 2, dtype=torch.float32)

    def local(pos):
        b = slab_block(pos, cutoff, H, wrap_safe=use_tile)
        H_eff, info = b.H_eff, b.info
        halo_ok = halo_coverage_ok(b.bins.sorted_keys, info.strides, H_eff, both_sides=False)
        esq = edges_sq.to(device=pos.device, dtype=pos.dtype)
        if use_tile:
            packed, cap_ok = tile_pair_hist(b.ext, b.keys, info.strides, esq, MAXJ=MAXJ,
                                            min_islot=H_eff)
            return psum(packed), _all_ok(halo_ok & cap_ok)
        packed = pair_lag_hist(b.ext, b.keys, info.strides, esq, M=M, L=L, min_islot=H_eff)
        cap_ok = _lag_ok_ext(b.keys, info.strides, L, H_eff, b.n_loc)
        # per-shard (hi, lo) 16-bit plane sums are < 2^27 each; their sum
        # over any realistic mesh stays far from int32 overflow
        return psum(packed), _all_ok(halo_ok & cap_ok)

    return shard_map(local, mesh, in_specs=(AXIS,), out_specs=(None, None))


def _sharded_forces(
    mesh: Mesh,
    *,
    cutoff: float,
    H: int,
    K: int = 32,
    chunk: int = 64,
    use_pallas: bool = False,
    use_tile: bool = False,
    MAXJ=8,
    M: int = 4096,
    L: int = 256,
    gfn=lj_force_factor,
):
    """Global pair forces over slab-sharded positions, in the input order
    of each shard's block (the local sort undone by the permutation).
    Returns fn(positions) -> (forces, coverage_ok)."""

    def local(pos):
        b = slab_block(pos, cutoff, H, right=True, wrap_safe=use_tile)
        H_eff, n_loc, info = b.H_eff, b.n_loc, b.info
        csq = _cutoff_sq(cutoff, pos.dtype)
        halo_ok = halo_coverage_ok(b.bins.sorted_keys, info.strides, H_eff, both_sides=True)
        if use_tile:
            f, cap_ok = tile_pair_forces(b.ext, b.keys, info.strides, csq, MAXJ=MAXJ, gfn=gfn)
        elif use_pallas:
            f = pair_lag_forces(b.ext, b.keys, info.strides, csq, M=M, L=L, gfn=gfn)
            cap_ok = _lag_ok_ext(b.keys, info.strides, L, H_eff, n_loc)
        else:
            grid = build(b.ext, cutoff, info=info)
            f = pair_forces(grid, gfn, K=K, chunk=chunk, cutoff_sq=csq)
            cap_ok = grid.bins.max_cell_count() <= K
        f_own = f[H_eff:H_eff + n_loc]
        out = torch.empty_like(f_own).index_copy_(0, b.bins.perm.long(), f_own)
        return out, _all_ok(halo_ok & cap_ok)

    return shard_map(local, mesh, in_specs=(AXIS,), out_specs=(AXIS, None))


class _ShardedPotential(torch.autograd.Function):
    """E(positions) over the mesh, with the sharded forces as its backward
    pass. ``fns`` is the pair (energy function, forces function)."""

    @staticmethod
    def forward(positions, fns):
        return fns[0](positions)

    @staticmethod
    def setup_context(ctx, inputs, output):
        positions, fns = inputs
        ctx.forces = fns[1]
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(positions)

    @staticmethod
    def backward(ctx, ct_e, _):
        (positions,) = ctx.saved_tensors
        f, ok = ctx.forces(positions.detach())
        # the backward pass has no channel for a coverage flag: an
        # under-capacity forces pass poisons the gradient with NaN
        f = torch.where(ok, f, torch.full_like(f, float("nan")))
        grad = ct_e.to(f.device) * (-f)
        return grad.to(device=positions.device, dtype=positions.dtype), None


def make_sharded_potential(
    mesh: Mesh,
    *,
    cutoff: float,
    H: int,
    K: int = 32,
    chunk: int = 64,
    use_pallas: bool = False,
    use_tile: bool = False,
    MAXJ=8,
    MAXJ_F=None,
    M: int = 4096,
    L: int = 256,
    term=None,
    gfn=None,
    interpret: bool = False,
) -> Callable:
    """Differentiable global pair potential over slab-sharded positions,
    the multi-shard sibling of `ops.autodiff.make_pair_potential`.

    ``pot(positions) -> (energy, coverage_ok)``, positions (n, dim) in slab
    order; ``torch.autograd.grad`` (or ``.backward()``) gives dE/dpositions
    in the same order, by the sharded forces pass (halo exchange, the
    forces kernel per shard, the local sort undone), one collective round.

    ``term`` is the elementwise pair term (default LJ), ``gfn`` its force
    factor (default: `lj_force_factor` for LJ, a factory's own gfn for an
    `ops.potentials` factory's term, else `ops.autodiff.gfn_from_term`).
    ``MAXJ_F`` is the forces kernel's window capacity on the tile path (9
    full bands against the energy's 5 half bands; default MAXJ's widest
    entry). An under-capacity backward pass poisons the gradient with NaN.
    """
    del interpret
    if term is None:
        term, gfn = lj_term, (gfn or lj_force_factor)
    elif gfn is None:
        gfn = _default_gfn(term)
    if MAXJ_F is None:
        MAXJ_F = MAXJ if isinstance(MAXJ, int) else max(MAXJ)

    energy_fn = sharded_lj_energy(
        mesh, cutoff=cutoff, H=H, K=K, chunk=chunk, use_pallas=use_pallas,
        use_tile=use_tile, MAXJ=MAXJ, M=M, L=L, term=term)
    forces_fn = _sharded_forces(
        mesh, cutoff=cutoff, H=H, K=K, chunk=chunk, use_pallas=use_pallas,
        use_tile=use_tile, MAXJ=MAXJ_F, M=M, L=L, gfn=gfn)

    def pot(positions):
        return _ShardedPotential.apply(torch.as_tensor(positions), (energy_fn, forces_fn))

    return pot
