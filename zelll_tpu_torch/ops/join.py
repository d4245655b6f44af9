"""Batched query-particle join reductions (kernel K12).

PyTorch counterpart of ``zelll_tpu/ops/join.py``. The reference answers
point queries one at a time (`query_neighbors`, cellgrid.rs:391-401) and
leaves every reduction to the caller's loop. Here a batch of queries is
sorted by flat cell key and each query's within-cutoff particles are
reduced in one pass:

- `join_reduce`: per SORTED query, ``n_out`` quantities of a term over all
  particles within the cutoff (``dsq <= cutoff^2``, inclusive), combined
  by sum, min or max. CUDA tensors launch the hand-written kernel
  (``csrc/join_reduce.cu``) for its three instances, `_count_term`,
  `_nearest_term` and `ops.sdf_join.sdf_term`; CPU tensors run
  `join_reduce_plain`, which takes any term. There is no fallback between
  the two: a CUDA input the kernel cannot take raises.
- `query_join_reduce` / `grid_join_reduce`: raw query points against a
  grid's particles: keys, the `try_cell_index` validity rule
  (util.rs:245-256), sorting and un-sorting.
- `count_neighbors` / `nearest_dsq`: the two stock instances.

``MAXJ`` (the TPU kernel's window capacity above `JOIN_MAX_PARTICLES`)
sets the plain version's windows and flag as in the JAX package, so
`grid_join_reduce_auto` keeps its capacity ladder there. The CUDA kernel
has no particle ceiling and no windows: it ignores ``MAXJ`` and its flag
guards the key preconditions only, which a caller that passes
``keys_sorted=True`` (a built grid's keys, `sort_queries`' keys) vouches
for instead. `maxj_ladder` is the one capacity ladder, shared by
`grid_join_reduce_auto` and `models.sdf.SmoothDistanceField`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable

import torch

from .._device import resolve_device
from ._build import kernel_loader
from .lag_pairs import _pad_and_desentinel
from .segments import CHUNK, join_bounds, segment_bands

__all__ = [
    "JOIN_MAX_PARTICLES",
    "join_reduce",
    "join_reduce_plain",
    "query_join_reduce",
    "sort_queries",
    "grid_join_reduce",
    "grid_join_reduce_auto",
    "maxj_ladder",
    "count_neighbors",
    "nearest_dsq",
    "load_kernel",
]

# The TPU kernel's particle ceiling for its VMEM-resident form; above it
# the JAX package runs windowed (MAXJ). The port keeps the number for the
# plain version's ladder and for `SmoothDistanceField.hmc_vgrad_fn`.
JOIN_MAX_PARTICLES = 131072

# payload planes the join takes (the TPU kernel's 8-row blocks: 3
# coordinates, the key and at most 4 payload rows) and outputs (2 x 8)
_MAX_PAYLOAD = 4
_MAX_OUT = 16

_IDENT = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}

# query chunks the plain version evaluates at once: bounds its (B, 128,
# 128) tiles to ~128 MB whatever the term
_PLAIN_TILE_BYTES = 1 << 27


def _combine(reducer: str, a, b):
    if reducer == "sum":
        return a + b
    if reducer == "min":
        return torch.minimum(a, b)
    return torch.maximum(a, b)


def _count_term(dsq, d, payload, within):
    return [within.to(dsq.dtype)]


def _nearest_term(dsq, d, payload, within):
    return [torch.where(within, dsq, torch.full_like(dsq, float("inf")))]


def _kernel_instance(term):
    """(instance id, reducer, n_out, payload planes) of the CUDA kernel's
    instance for ``term``, or None."""
    from .sdf_join import NACC, sdf_term

    return {
        _count_term: (0, "sum", 1, 0),
        _nearest_term: (1, "min", 1, 0),
        sdf_term: (2, "sum", NACC, 2),
    }.get(term)


def _scalar(x, dtype, device) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``dtype`` on ``device``: a tensor is cast,
    a number is filled in (a fill never waits for the device's queue, a copy
    from host memory may)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), float(x), dtype=dtype, device=device)


def _keys_ok(qkeys: torch.Tensor, pkeys: torch.Tensor) -> torch.Tensor:
    """The key preconditions `join_bounds` checks, on the device and
    without a read-back: both arrays ascending once their padding keys are
    spread. (Its third test, real keys below the padding base, holds by
    construction.) The JAX package's f32 key-exactness test does not
    apply: K12 and the plain version compare int32 keys."""
    q = _pad_and_desentinel(qkeys, qkeys.shape[0])
    p = _pad_and_desentinel(pkeys, pkeys.shape[0])
    return (q[1:] >= q[:-1]).all() & (p[1:] >= p[:-1]).all()


def _check_args(qplanes, pplanes, reducer: str, n_out: int):
    if reducer not in _IDENT:
        raise ValueError(f"reducer must be one of {sorted(_IDENT)}")
    if len(qplanes) != 3:
        raise ValueError("qplanes must be the 3 query coordinate planes")
    npl = len(pplanes) - 3
    if npl < 0 or npl > _MAX_PAYLOAD:
        raise ValueError("pplanes must be 3 coordinates + at most "
                         f"{_MAX_PAYLOAD} payload planes")
    if not 1 <= n_out <= _MAX_OUT:
        raise ValueError(f"n_out must be in 1..{_MAX_OUT}")


def _pad_plane(x: torch.Tensor, C: int, spread: bool, cutoff_sq) -> torch.Tensor:
    """A plane padded to C rows: the x plane with far, mutually spread
    coordinates (the JAX package's packed-block family), the others with
    zeros, so a padding row meets no real row within the cutoff."""
    npad = C - x.shape[0]
    if npad == 0:
        return x
    if spread:
        spacing = max(1e5, 4 * float(cutoff_sq) ** 0.5)
        tail = 1e6 + torch.arange(npad, dtype=x.dtype, device=x.device) * spacing
    else:
        tail = torch.zeros((npad,), dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def _window_tiles(start, num, ncp: int) -> torch.Tensor:
    """The distinct particle tiles of each chunk's band windows: (B, U)
    ascending tile indices, padded with ``ncp``. A tile that lies in the
    windows of several bands is evaluated once, under the union of their
    band masks."""
    width = max(int(num.max()) if num.numel() else 0, 1)
    t = torch.arange(width, device=start.device)
    cand = start[:, :, None] + t  # (B, S, W)
    cand = torch.where(t < num[:, :, None], cand, torch.full_like(cand, ncp))
    cand = torch.sort(cand.reshape(start.shape[0], -1), dim=1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand = torch.where(dup, torch.full_like(cand, ncp), cand)
    cand = torch.sort(cand, dim=1).values
    used = int((cand < ncp).sum(1).max()) if cand.numel() else 0
    return cand[:, :used]


def join_reduce_plain(qplanes, qkeys, pplanes, pkeys, strides, cutoff_sq, *,
                      term: Callable, n_out: int, reducer: str = "sum",
                      CB: int = 8, MAXJ: int | None = None):
    """Plain PyTorch version of K12, the TPU kernel's formulation: queries
    in 128-slot chunks, per-chunk band windows over 128-slot particle tiles
    (`segments.join_bounds`), each tile masked by its bands and by
    ``dsq <= cutoff_sq``, the (128, 128) term tiles combined across tiles,
    then reduced over the particle lanes. Where the TPU kernel visits a tile
    once per band whose window holds it, this evaluates it once under the
    union of those bands' masks: the same pairs, fewer passes. With
    ``MAXJ`` the windows are capped at MAXJ tiles and the flag also covers
    that capacity, as the JAX package's windowed kernel does. ``CB`` only
    sets the TPU kernel's grouping of chunks and has no effect. Returns
    (out (nq, n_out), ok) in sorted query order.
    """
    del CB
    _check_args(qplanes, pplanes, reducer, n_out)
    nq = qplanes[0].shape[0]
    npart = pplanes[0].shape[0]
    device, dtype = qplanes[0].device, qplanes[0].dtype
    ident = _IDENT[reducer]
    ncq = max(-(-nq // CHUNK), 1)
    ncp = max(-(-npart // CHUNK), 1)
    Cq, Cp = ncq * CHUNK, ncp * CHUNK
    qkeys_p = _pad_and_desentinel(torch.as_tensor(qkeys, device=device), Cq)
    pkeys_p = _pad_and_desentinel(torch.as_tensor(pkeys, device=device), Cp)
    bands = segment_bands(torch.as_tensor(strides, device=device), full=True)
    if MAXJ is None:
        start, num, ok = join_bounds(qkeys_p, pkeys_p, bands)
    else:
        jlo, toff, num, ok = join_bounds(qkeys_p, pkeys_p, bands,
                                         max_j=min(MAXJ, ncp))
        start = jlo + toff
    csq = _scalar(cutoff_sq, dtype, device)
    q = [_pad_plane(p.to(dtype), Cq, a == 0, csq).reshape(ncq, CHUNK)
         for a, p in enumerate(qplanes)]
    pl = [_pad_plane(p.to(dtype), Cp, a == 0, csq).reshape(ncp, CHUNK)
          for a, p in enumerate(pplanes)]
    qk = qkeys_p.to(torch.int64).reshape(ncq, CHUNK)
    pk = pkeys_p.to(torch.int64).reshape(ncp, CHUNK)
    b = bands.to(torch.int64)
    S = b.shape[0]
    out = torch.empty((ncq, CHUNK, n_out), dtype=dtype, device=device)
    batch = max(1, _PLAIN_TILE_BYTES // (CHUNK * CHUNK * dtype.itemsize
                                         * (n_out + 16)))
    for c0 in range(0, ncq, batch):
        cs = slice(c0, min(c0 + batch, ncq))
        qc = [x[cs][:, :, None] for x in q]
        qkc = qk[cs][:, :, None]
        st, nm = start[cs], num[cs]  # (B, S)
        tiles = _window_tiles(st, nm, ncp)
        macc = [torch.full((qkc.shape[0], CHUNK, CHUNK), ident, dtype=dtype,
                           device=device) for _ in range(n_out)]
        for k in range(tiles.shape[1]):
            tile = tiles[:, k]  # (B,), ncp where the chunk has no k-th tile
            # band s covers the pair iff the tile lies in band s's window
            # and the key difference in band s (the bands are disjoint)
            inwin = (st <= tile[:, None]) & (tile[:, None] < st + nm)  # (B, S)
            tile = torch.clamp(tile, max=ncp - 1)
            blk = [x[tile][:, None, :] for x in pl]
            diff = qkc - pk[tile][:, None, :]
            m = torch.zeros(diff.shape, dtype=torch.bool, device=device)
            for band in range(S):
                m |= (inwin[:, band, None, None] & (diff >= b[band, 0])
                      & (diff <= b[band, 1]))
            d0 = qc[0] - blk[0]
            d1 = qc[1] - blk[1]
            d2 = qc[2] - blk[2]
            dsq = d0 * d0 + d1 * d1 + d2 * d2
            within = m & (dsq <= csq)  # inclusive, cellgrid.rs:398
            vals = term(dsq, (d0, d1, d2), blk[3:], within)
            for j in range(n_out):
                macc[j] = _combine(reducer, macc[j], vals[j])
        for k in range(n_out):
            if reducer == "sum":
                out[cs, :, k] = macc[k].sum(-1)
            elif reducer == "min":
                out[cs, :, k] = macc[k].amin(-1)
            else:
                out[cs, :, k] = macc[k].amax(-1)
    return out.reshape(Cq, n_out)[:nq], ok


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zelll_join_reduce.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      vp, vp]
    lib.zelll_join_reduce.restype = ci


# Build (at first use) and load the K12 library; its build log is
# ``load_kernel.log``.
load_kernel = kernel_loader(Path(__file__).resolve().parents[1] / "csrc"
                            / "join_reduce.cu", "join_reduce", _bind)


def _join_reduce_cuda(qplanes, qkeys, pplanes, pkeys, strides, cutoff_sq, *,
                      term, n_out, reducer, keys_sorted):
    """Launch K12 on the current stream. Returns (out (nq, n_out), ok); with
    ``keys_sorted`` the key check is skipped and ``ok`` is True."""
    inst = _kernel_instance(term)
    if inst is None:
        raise ValueError(
            "the CUDA kernel implements the count, nearest and sdf terms "
            "only; run other terms through join_reduce_plain or on CPU "
            "tensors")
    inst_id, inst_reducer, inst_out, inst_npl = inst
    if (reducer, n_out, len(pplanes) - 3) != (inst_reducer, inst_out, inst_npl):
        raise ValueError(
            f"the CUDA kernel's {term.__name__} takes reducer={inst_reducer!r}, "
            f"n_out={inst_out} and {inst_npl} payload planes")
    device, dtype = qplanes[0].device, qplanes[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K12 takes float32 or float64 coordinates, not {dtype}")
    nq, npart = qplanes[0].shape[0], pplanes[0].shape[0]
    if max(nq, npart) >= 2**31:
        raise ValueError("K12 takes fewer than 2^31 queries and particles")
    q = torch.stack([torch.as_tensor(x, device=device).to(dtype) for x in qplanes])
    p = torch.stack([torch.as_tensor(x, device=device).to(dtype) for x in pplanes])
    qkeys = torch.as_tensor(qkeys, device=device).to(torch.int32).contiguous()
    pkeys = torch.as_tensor(pkeys, device=device).to(torch.int32).contiguous()
    if qkeys.shape != (nq,) or pkeys.shape != (npart,) or q.device != device \
            or p.device != device or p.shape[1:] != (npart,):
        raise ValueError("K12 takes (nq,) query planes and keys and (np,) "
                         "particle planes and keys on one device")
    bands = segment_bands(torch.as_tensor(strides, device=device),
                          full=True).contiguous()
    csq = _scalar(cutoff_sq, dtype, device).reshape(1)
    out = torch.empty((nq, n_out), dtype=dtype, device=device)
    ok = (torch.ones((), dtype=torch.bool, device=device) if keys_sorted
          else _keys_ok(qkeys, pkeys))
    if nq == 0:
        return out, ok
    lib = load_kernel()
    err = lib.zelll_join_reduce(
        q.data_ptr(), qkeys.data_ptr(), p.data_ptr(), pkeys.data_ptr(),
        bands.data_ptr(), csq.data_ptr(), nq, npart, bands.shape[0], inst_id,
        int(dtype == torch.float64), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K12 launch failed: CUDA error {err}")
    join_reduce.launches += 1
    return out, ok


def join_reduce(qplanes, qkeys, pplanes, pkeys, strides, cutoff_sq, *,
                term: Callable, n_out: int, reducer: str = "sum", CB: int = 8,
                MAXJ: int | None = None, keys_sorted: bool = False, device=None):
    """Reduce ``term`` over all within-cutoff particles per sorted query.

    ``qplanes``: the 3 (nq,) query coordinate planes and ``qkeys`` (nq,)
    their ascending int32 cell keys; ``pplanes``: 3 + npl (np,) particle
    planes (x, y, z, then at most 4 payload planes) and ``pkeys`` (np,)
    their ascending keys; ``strides`` the shared grid strides (3-D).

    ``term(dsq, (dx, dy, dz), payload_rows, within)`` returns ``n_out``
    tensors masked to the reducer's identity (0 for sum, +/-inf for
    min/max) outside ``within``. Returns (out (nq, n_out), ok) in sorted
    query order; ``ok`` is False when the key preconditions fail (keys not
    ascending) or, on the plain path with ``MAXJ``, when a window needs
    more than MAXJ particle tiles. Never trust a result with a false flag.
    ``keys_sorted=True`` says both key arrays ascend by construction (a
    built grid's sorted keys, `sort_queries`' keys): the CUDA path then
    skips its key check, and its flag is True.

    CUDA tensors run K12, which takes `_count_term` (sum, n_out 1),
    `_nearest_term` (min, n_out 1) and `ops.sdf_join.sdf_term` (sum, n_out
    12, payload (r, 1/r)) in f32 or f64, ignores ``CB`` and ``MAXJ``, and
    raises on anything else. CPU tensors run `join_reduce_plain`.
    """
    _check_args(qplanes, pplanes, reducer, n_out)
    device = resolve_device(device, qplanes[0])
    qplanes = [torch.as_tensor(x, device=device) for x in qplanes]
    pplanes = [torch.as_tensor(x, device=device) for x in pplanes]
    if device.type == "cuda":
        return _join_reduce_cuda(qplanes, qkeys, pplanes, pkeys, strides,
                                 cutoff_sq, term=term, n_out=n_out,
                                 reducer=reducer, keys_sorted=keys_sorted)
    return join_reduce_plain(qplanes, qkeys, pplanes, pkeys, strides, cutoff_sq,
                             term=term, n_out=n_out, reducer=reducer, CB=CB,
                             MAXJ=MAXJ)


# Kernel launches since the last reset; only a launch of K12 adds to it.
join_reduce.launches = 0
# Uses of the documented fallback since the last reset: a caller that
# found ``ok`` False on CPU tensors and took the gather or query path
# instead (`SmoothDistanceField.evaluate`/`hmc_gradient`, `CellGrid`'s two
# batch queries). On CUDA tensors those callers raise instead, as does a
# kernel that fails to build or launch.
join_reduce.fallbacks = 0


def sort_queries(points, origin, shape, strides, cutoff, dtype, device):
    """Raw query points -> (sorted planes (3 (Q,) tensors), sorted keys
    (Q,) int32, perm (Q,), valid (Q,)), the preamble of
    `query_join_reduce`. ``valid`` is the reference's `try_cell_index`
    rule (within one implicit padding layer, util.rs:245-256). Cell indices
    are clipped to [-1, shape] in floating point before the integer
    conversion, so a far query (say at 1e9) never overflows int32; its key
    is a corner cell's, and its coordinates fail every cutoff test."""
    points = torch.as_tensor(points, device=device).to(dtype)
    if points.ndim == 1:
        points = points[None, :]
    shape = torch.as_tensor(shape, device=device)
    strides = torch.as_tensor(strides, device=device)
    origin = torch.as_tensor(origin, device=device).to(dtype)
    f = torch.floor((points - origin) / _scalar(cutoff, dtype, device))
    shape_f = shape.to(dtype)
    valid = ((f >= -1) & (f <= shape_f)).all(-1)
    idx = torch.minimum(torch.clamp(f, min=-1), shape_f).to(torch.int32)
    qkey = idx[:, 0] * strides[0]
    for a in range(1, 3):
        qkey = qkey + idx[:, a] * strides[a]
    sk, perm = torch.sort(qkey.to(torch.int32), stable=True)
    sp = points[perm]
    return (sp[:, 0], sp[:, 1], sp[:, 2]), sk, perm, valid


def query_join_reduce(points, origin, shape, strides, cutoff, pplanes, pkeys,
                      *, term: Callable, n_out: int, reducer: str = "sum",
                      CB: int = 8, MAXJ: int | None = None,
                      keys_sorted: bool = False):
    """`join_reduce` for raw query points: key assignment, sorting and
    un-sorting around the kernel (`sort_queries`).

    ``origin``/``shape``/``strides``/``cutoff`` are the particle grid's
    geometry (`GridInfo`). Returns (out (Q, n_out), valid (Q,), ok) in
    input query order; out-of-range queries (``valid`` False) get the
    reducer's identity. ``keys_sorted=True``: ``pkeys`` are a built grid's
    sorted keys (the query keys are sorted here), see `join_reduce`.
    """
    dtype, device = pplanes[0].dtype, pplanes[0].device
    qplanes, sk, perm, valid = sort_queries(points, origin, shape, strides,
                                            cutoff, dtype, device)
    cut = _scalar(cutoff, dtype, device)
    sums, ok = join_reduce(qplanes, sk, pplanes, pkeys, strides, cut * cut,
                           term=term, n_out=n_out, reducer=reducer, CB=CB,
                           MAXJ=MAXJ, keys_sorted=keys_sorted, device=device)
    out = torch.empty_like(sums)
    out[perm] = sums
    return out, valid, ok


def grid_join_reduce(grid, points, *, term: Callable, n_out: int, payload=(),
                     reducer: str = "sum", CB: int = 8, MAXJ: int | None = None):
    """`query_join_reduce` against a built `core.grid.CellGridData`.

    ``payload`` are extra per-particle planes in sorted slot order (for
    example ``radii[grid.bins.perm]``). The join is 3-D only."""
    if grid.dim != 3:
        raise ValueError(
            f"the join kernel is 3D-only (grid dim {grid.dim}); use "
            "core.pairs.query_neighbors for other dimensions")
    info = grid.info
    sp = grid.sorted_pos
    pplanes = [sp[:, 0], sp[:, 1], sp[:, 2]] + [
        torch.as_tensor(p, device=sp.device).to(sp.dtype) for p in payload]
    return query_join_reduce(
        points, info.origin, info.shape, info.strides, info.cutoff, pplanes,
        grid.bins.sorted_keys, term=term, n_out=n_out, reducer=reducer, CB=CB,
        MAXJ=MAXJ, keys_sorted=True)


def maxj_ladder(run: Callable, n: int, maxj0: int = 8, maxj_cap: int = 16):
    """The window capacity picked by flag retry: ``run(MAXJ)`` returns a
    tuple whose last item is the join's flag.

    Up to `JOIN_MAX_PARTICLES` particles there are no windows: one
    ``run(None)``. Above, it starts at ``maxj0`` tiles and doubles while the
    flag fails, up to ``maxj_cap``; a flag still False there is returned as
    it is (never trust it). Returns (the last run's result, its MAXJ). The
    plain version follows the JAX package's windows, so the ladder climbs on
    CPU tensors only; the CUDA kernel has no windows, and its first answer
    stands. Reads the flag back to the host."""
    if n <= JOIN_MAX_PARTICLES:
        return run(None), None
    cap = min(-(-n // CHUNK), maxj_cap)
    MAXJ = min(maxj0, cap)
    while True:
        res = run(MAXJ)
        if bool(res[-1]) or MAXJ >= cap:
            return res, MAXJ
        MAXJ = min(2 * MAXJ, cap)


def grid_join_reduce_auto(grid, points, *, maxj0: int = 8, maxj_cap: int = 16,
                          **kw):
    """`grid_join_reduce` with the window capacity picked by `maxj_ladder`."""
    return maxj_ladder(lambda M: grid_join_reduce(grid, points, MAXJ=M, **kw),
                       int(grid.n), maxj0, maxj_cap)[0]


def count_neighbors(grid, points, *, CB: int = 8):
    """Within-cutoff (<=) particle count per query point in one pass.

    Returns (counts (Q,) int32, valid (Q,), ok): the batched form of
    looping `query_neighbors` and counting (cellgrid.rs:391-401)."""
    out, valid, ok = grid_join_reduce_auto(grid, points, term=_count_term,
                                           n_out=1, CB=CB)
    return out[:, 0].to(torch.int32), valid, ok


def nearest_dsq(grid, points, *, CB: int = 8):
    """Squared distance to the nearest particle within the cutoff per
    query point, +inf where none is. Returns (dsq (Q,), valid (Q,), ok)."""
    out, valid, ok = grid_join_reduce_auto(grid, points, term=_nearest_term,
                                           n_out=1, reducer="min", CB=CB)
    return out[:, 0], valid, ok

