"""The segment-tile pair reduction (kernel K6, which also covers K10), pair
forces (kernel K7, which also covers K11), the stress tensor (kernel K8)
and the pair-distance histogram (kernel K9) over key-sorted particles.

PyTorch counterpart of ``zelll_tpu/ops/tile_pairs.py`` for the reduction
the cubic main path runs (`tile_pair_reduce`, `tile_lj_rebuild_energy`),
the forces of the cubic MD loops (`tile_pair_forces`, `tile_forces_core`)
and the observables of `ops.virial` and `ops.rdf` (`tile_pair_stress`,
`tile_pair_hist`).

The lag kernel (`ops.lag_pairs`) is tight for thin boxes, but its
contiguous lag window degenerates on cubic and wide boxes. The tile
reduction visits, for every 128-slot chunk of the key-sorted order, only
the slot ranges that can hold cutoff partners: `ops.segments` splits the
half stencil into <= 5 disjoint key-difference bands and locates, per chunk
and band, the one contiguous window of j-chunks that holds every partner.
Each (own chunk, j-chunk) pair is one 128 x 128 tile of separations, masked
by the slot bound, the key band (with ``bandmask``), the slot triangle in
band 0 and the cutoff. Every pair is counted once, by its larger slot. The
forces use the full stencil instead (``full=True``: 9 mirrored bands in
3-D, no triangle), so each particle meets every partner and only its own
side is written.

`tile_pair_reduce` launches the hand-written CUDA kernel
(``csrc/tile_reduce.cu``) for CUDA tensors and the plain PyTorch version
for CPU tensors; `tile_pair_forces` does the same with
``csrc/tile_forces.cu``, `tile_pair_stress` with ``csrc/tile_stress.cu`` and
`tile_pair_hist` with ``csrc/tile_hist.cu``. There is no fallback between
the two. The TPU
package has two kernels for each: a packed one whose keys ride as f32
(exact below 2^24) and an int32-key one for larger grids
(``packed=False``). The CUDA kernels read int32 keys in both cases, so
``packed`` decides only whether the coverage flag carries the 2^24
key-exactness term, as it does in JAX.

Split precision: ``sorted_pos_lo`` carries the f32 low parts of f64
coordinates, and ``d = (hi_i - hi_j) + (lo_i - lo_j)`` recovers f64-grade
separations.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable

import torch

from .._device import resolve_device
from ..core.binning import compute_keys
from ..core.geometry import GridInfo, aabb_from_positions
from ._build import kernel_loader
from .lag_pairs import (
    _PAD_KEY_BASE,
    _cumulative_counts,
    _is_default_islot,
    _keep_plane,
    _pack_count,
    _pad_and_desentinel,
    count_term,
    hist_edges,
    lj_term,
    lj_term_fast,
    mask_plane,
    split_cutoff_test,
    symmetric_stress,
)
from .lj import lj_force_factor, lj_force_factor_fast, lj_virial_term
from .segments import (
    CHUNK,
    band_order,
    chunk_bounds,
    num_segments,
    segment_bands,
    trim_windows_disjoint,
    windows_disjoint,
)

__all__ = [
    "TileInputs",
    "tile_inputs",
    "reduce_tiles",
    "reduce_tiles_plain",
    "tile_pair_reduce",
    "tile_pair_reduce_plain",
    "tile_lj_rebuild_energy",
    "tile_lj_energy",
    "tile_count_pairs",
    "forces_tiles",
    "forces_tiles_plain",
    "tile_forces_core",
    "tile_pair_forces",
    "tile_pair_forces_plain",
    "stress_tiles",
    "stress_tiles_plain",
    "tile_pair_stress",
    "tile_pair_stress_plain",
    "hist_tiles",
    "hist_tiles_plain",
    "tile_pair_hist",
    "tile_pair_hist_plain",
    "load_kernel",
    "load_forces_kernel",
    "load_stress_kernel",
    "load_hist_kernel",
]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"

# The terms and force factors the CUDA kernels implement, by the enum
# value each takes.
_KERNEL_TERMS = {lj_term: 0, lj_term_fast: 1, count_term: 2, lj_virial_term: 3}
_KERNEL_GFNS = {lj_force_factor: 0, lj_force_factor_fast: 1}

# Own chunks per step of the plain version: a (1024, 128, 128) f32 tile is
# 64 MiB, so memory stays bounded at any n.
_PLAIN_BATCH = 1024


def _norm_maxj(MAXJ, S: int, nc_pad: int) -> tuple:
    """A MAXJ capacity spec as a length-S tuple of per-band window sizes,
    each clamped to the array's chunk count."""
    if isinstance(MAXJ, int):
        MAXJ = (MAXJ,) * S
    MAXJ = tuple(int(m) for m in MAXJ)
    if len(MAXJ) != S:
        raise ValueError(
            f"per-band MAXJ needs {S} entries (one per stencil band), "
            f"got {len(MAXJ)}"
        )
    if any(m < 1 for m in MAXJ):
        raise ValueError(f"MAXJ entries must be >= 1, got {MAXJ}")
    return tuple(min(m, nc_pad) for m in MAXJ)


def _key_exact_f32(keys_p: torch.Tensor, cov_ok: torch.Tensor) -> torch.Tensor:
    """The packed layout's flag term: f32 keys are exact only below 2^24,
    and negative keys (out-of-box rows) must stay exact too."""
    kreal_max = torch.where(keys_p < _PAD_KEY_BASE, keys_p,
                            torch.full_like(keys_p, -1)).max()
    return cov_ok & (kreal_max < (1 << 24)) & (keys_p.min() > -(1 << 24))


@dataclasses.dataclass(frozen=True)
class TileInputs:
    """What the tile reduction reads, built by `tile_inputs`.

    * ``pos``          (dim, n) sorted coordinate planes
    * ``lo``           (dim, n) low parts (split mode) or None
    * ``keys``         (C,) int32 keys padded by `_pad_and_desentinel`,
                       C = nc_pad * CHUNK
    * ``bounds``       (nc_pad, 3 S) int32: (jlo, toff, jnum) per band
    * ``bands``        (S, 2) int32 key-difference bands
    * ``bandmask``     whether the tiles test the key band
    * ``coverage_ok``  False iff a result would drop pairs
    """

    pos: torch.Tensor
    lo: torch.Tensor | None
    keys: torch.Tensor
    bounds: torch.Tensor
    bands: torch.Tensor
    bandmask: bool
    coverage_ok: torch.Tensor


def tile_inputs(pos_planes: torch.Tensor, sorted_keys: torch.Tensor, strides,
                lo_planes: torch.Tensor | None = None, *, CB: int = 8,
                MAXJ=4, packed: bool = True, bandmask: bool = True,
                full: bool = False) -> TileInputs:
    """Pad the keys, locate every chunk's band windows and fold the
    coverage flag, as the JAX package's ``_packed_core`` and
    ``_tile_pair_reduce_impl`` do before their kernels (``full=True``: as
    ``_packed_forces_core`` and ``tile_pair_forces`` do, over the full
    stencil's mirrored bands).

    ``CB`` (the TPU kernel's chunks per program) fixes the padding:
    ``nc_pad = ceil(n / (128 CB)) CB`` chunks. That sets the MAXJ clamp and
    the padding-key spacing, hence the flag, exactly as in JAX; it has no
    effect on the CUDA grid. Without ``bandmask`` the windows are trimmed
    pairwise disjoint (in `band_order`) and the flag also requires that
    they are.
    """
    dim, n = pos_planes.shape
    S = num_segments(dim, full=full)
    nc_pad = max(-(-n // (CHUNK * CB)) * CB, CB)
    MAXJ = _norm_maxj(MAXJ, S, nc_pad)
    keys_p = _pad_and_desentinel(sorted_keys, nc_pad * CHUNK)
    bands = segment_bands(torch.as_tensor(strides, device=keys_p.device),
                          full=full)
    jlo, toff, jnum, cov_ok = chunk_bounds(keys_p, bands, MAXJ, half=not full)
    if not bandmask:
        # a j-chunk shared by two bands' windows would be counted twice by
        # a maskless tile: trim the windows disjoint (coverage-preserving)
        # and keep the invariant in the flag
        toff, jnum = trim_windows_disjoint(jlo, toff, jnum,
                                           band_order(dim, full=full))
        cov_ok = cov_ok & windows_disjoint(jlo, toff, jnum)
    if packed and pos_planes.dtype == torch.float32:
        cov_ok = _key_exact_f32(keys_p, cov_ok)
    bounds = torch.stack([jlo, toff, jnum], dim=-1).reshape(nc_pad, 3 * S)
    return TileInputs(pos=pos_planes, lo=lo_planes, keys=keys_p,
                      bounds=bounds.contiguous(), bands=bands,
                      bandmask=bandmask, coverage_ok=cov_ok)


def _out_types(dtype, out_dtype):
    out_dtype = out_dtype or dtype
    integer = not out_dtype.is_floating_point
    return out_dtype, integer, torch.int64 if integer else torch.float64


def _finish(total: torch.Tensor, out_dtype, integer: bool) -> torch.Tensor:
    return _pack_count(total) if integer else total.to(out_dtype)


def _half_tiles(inp: TileInputs, payload=None, min_islot=0):
    """The plain versions' walk over the half-stencil windows (K6, K8, K9).

    Own chunks go in batches; for each (band, window step) the batch's
    j-chunks are gathered and one (batch, 128, 128) tile of separations is
    built. Yields (d, dsq, m, own payload, j payload) per tile: the per-axis
    separations (split: (hi_i - hi_j) + (lo_i - lo_j)), dsq summed axis by
    axis, and the mask of the slot bounds, ``min_islot`` (the larger slot
    at or above it), the key band (with ``bandmask``) and the slot triangle
    in band 0, without the cutoff. The payload tiles are (b, 128, 1) and
    (b, 1, 128) views of the one sorted (n,) plane, or None.
    """
    pos, lo = inp.pos, inp.lo
    dim, n = pos.shape
    device, dtype = pos.device, pos.dtype
    nc_pad = inp.bounds.shape[0]
    S = inp.bands.shape[0]
    C = nc_pad * CHUNK
    planes = pos if lo is None else torch.cat([pos, lo])
    padded = torch.zeros((planes.shape[0], C), dtype=planes.dtype, device=device)
    padded[:, :n] = planes
    pay = None
    if payload is not None:
        pay = torch.zeros((C,), dtype=dtype, device=device)
        pay[:n] = torch.as_tensor(payload, device=device).reshape(-1)
    keys = inp.keys.to(torch.int64)
    lane = torch.arange(CHUNK, device=device)
    tri = lane[None, :] < lane[:, None]  # (row i, column j): j's lane < i's
    nc_real = -(-n // CHUNK)  # chunks past it hold no own slot
    for c0 in range(0, nc_real, _PLAIN_BATCH):
        c1 = min(c0 + _PLAIN_BATCH, nc_real)
        own_c = torch.arange(c0, c1, device=device)
        own_s = own_c[:, None] * CHUNK + lane  # (b, 128) slots
        own_ok = own_s < n
        if not _is_default_islot(min_islot):
            own_ok = own_ok & (own_s >= torch.as_tensor(min_islot, device=device))
        own = padded[:, own_s][:, :, :, None]  # (D, b, 128, 1)
        own_k = keys[own_s][:, :, None]
        own_w = None if pay is None else pay[own_s][:, :, None]
        for s in range(S):
            jlo, toff, jnum = inp.bounds[c0:c1, 3 * s:3 * s + 3].long().unbind(1)
            lo_s, hi_s = inp.bands[s].long().unbind(0)
            for t in range(int(jnum.max()) if jnum.numel() else 0):
                jc = torch.clamp(jlo + toff + t, max=nc_pad - 1)
                j_s = jc[:, None] * CHUNK + lane  # (b, 128)
                j_ok = (j_s < n) & (t < jnum)[:, None]
                jp = padded[:, j_s][:, :, None, :]  # (D, b, 1, 128)
                d = []
                dsq = None
                for a in range(dim):
                    da = own[a] - jp[a]
                    if lo is not None:
                        da = da + (own[a + dim] - jp[a + dim])
                    d.append(da)
                    dsq = da * da if dsq is None else dsq + da * da
                m = own_ok[:, :, None] & j_ok[:, None, :]
                if inp.bandmask:
                    diff = own_k - keys[j_s][:, None, :]
                    m = m & (diff >= lo_s) & (diff <= hi_s)
                if s == 0:
                    before = (jc < own_c)[:, None, None]
                    same = (jc == own_c)[:, None, None]
                    m = m & (before | (same & tri))
                j_w = None if pay is None else pay[j_s][:, None, :]
                yield d, dsq, m, own_w, j_w


def reduce_tiles_plain(inp: TileInputs, cutoff_sq, *, term: Callable = lj_term,
                       out_dtype=None, safe_term: bool = True, payload=None,
                       min_islot=0) -> torch.Tensor:
    """Plain PyTorch version of K6 over the same windows, masks and terms
    (`_half_tiles`), each tile masked by the cutoff.

    Any ``term`` works. With ``payload`` (one sorted (n,) plane), ``term``
    receives (dsq, own payload, j payload); ``min_islot`` keeps only pairs
    whose larger slot is at or above it. Float terms are summed in f64 and
    integer ones in int64, as in the kernel.
    """
    pos = inp.pos
    device, dtype = pos.device, pos.dtype
    out_dtype, integer, acc = _out_types(dtype, out_dtype)
    csq = float(torch.as_tensor(cutoff_sq, dtype=dtype))
    total = torch.zeros((), dtype=acc, device=device)
    for _, dsq, m, own_w, j_w in _half_tiles(inp, payload, min_islot):
        m = m & (dsq < csq)
        safe = torch.where(m, dsq, torch.ones_like(dsq)) if safe_term else dsq
        tv = term(safe) if payload is None else term(safe, own_w, j_w)
        v = torch.where(m, tv, torch.zeros_like(tv)).to(out_dtype)
        total += v.sum(dtype=acc)
    return _finish(total, out_dtype, integer)


def _bind_reduce(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zelll_tile_reduce.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ci, ci, ci, ci, vp, vp,
    ]
    lib.zelll_tile_reduce.restype = ci
    lib.zelll_tile_reduce_chunk.argtypes = []
    lib.zelll_tile_reduce_chunk.restype = ci
    if lib.zelll_tile_reduce_chunk() != CHUNK:
        raise RuntimeError("tile_reduce.cu was built for another chunk size")


# Build (at first use) and load the K6 library; its build log is
# ``load_kernel.log``.
load_kernel = kernel_loader(_CSRC / "tile_reduce.cu", "tile_reduce", _bind_reduce)


def _check_cuda(name: str, t: torch.Tensor, dtype, shape, device,
                kernel: str = "K6"):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{kernel} takes {name} as a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})"
        )


def reduce_tiles(inp: TileInputs, cutoff_sq, *, term: Callable = lj_term,
                 out_dtype=None, payload=None) -> torch.Tensor:
    """Launch K6 on the current stream and sum its per-chunk partials.

    Takes f32 planes on a CUDA device, the terms `lj_term`,
    `lj_term_fast`, `count_term` and `ops.virial.lj_virial_term`, and one
    payload rule: the periodic keep mask (``term`` a `PbcKeepTerm` of one
    of those terms, ``payload`` the sorted (n,) shift-sign plane, whose
    value for each own and j slot the kernel reads); raises on anything
    else. Every kahan mode of the JAX package sums the same way here: f64
    per thread, a fixed fold per block, one partial per own chunk.
    """
    pos = inp.pos
    mask, term, plane = _keep_plane("K6", term, payload, pos.shape[1], pos.device)
    if term not in _KERNEL_TERMS:
        raise ValueError(
            "the CUDA kernel implements lj_term, lj_term_fast, count_term and "
            "lj_virial_term only; run other terms through "
            "tile_pair_reduce_plain or on CPU tensors"
        )
    if out_dtype not in (None, torch.float32, torch.float64, torch.int32):
        raise ValueError(f"K6 writes float32, float64 or int32 sums, not {out_dtype}")
    pos = inp.pos
    device = pos.device
    dim, n = pos.shape
    out_dtype, integer, acc = _out_types(pos.dtype, out_dtype)
    S = inp.bands.shape[0]
    nc_pad = inp.bounds.shape[0]
    if device.type != "cuda":
        raise ValueError(f"K6 runs on a CUDA device, not {device}")
    if not 1 <= dim <= 3 or nc_pad * CHUNK >= 2**31:
        raise ValueError(f"K6 takes 1 <= dim <= 3 and fewer than 2^31 slots; got {(dim, n)}")
    _check_cuda("pos", pos, torch.float32, (dim, n), device)
    if inp.lo is not None:
        _check_cuda("lo", inp.lo, torch.float32, (dim, n), device)
    _check_cuda("keys", inp.keys, torch.int32, (nc_pad * CHUNK,), device)
    _check_cuda("bounds", inp.bounds, torch.int32, (nc_pad, 3 * S), device)
    _check_cuda("bands", inp.bands, torch.int32, (S, 2), device)
    if n == 0:
        return _finish(torch.zeros((), dtype=acc, device=device), out_dtype, integer)
    lib = load_kernel()
    partial = torch.empty((-(-n // CHUNK),), dtype=acc, device=device)
    csq = float(torch.as_tensor(cutoff_sq, dtype=torch.float32))
    err = lib.zelll_tile_reduce(
        pos.data_ptr(), None if inp.lo is None else inp.lo.data_ptr(),
        None if plane is None else plane.data_ptr(),
        inp.keys.data_ptr(), inp.bounds.data_ptr(), inp.bands.data_ptr(),
        n, dim, S, csq, _KERNEL_TERMS[term], int(integer), int(inp.bandmask), mask,
        partial.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {err}")
    tile_pair_reduce.launches += 1
    return _finish(partial.sum(), out_dtype, integer)


def _planes(x: torch.Tensor | None) -> torch.Tensor | None:
    """(n, dim) rows -> (dim, n) contiguous planes, the layout K6 reads."""
    return None if x is None else x.t().contiguous()


def _tile_pair_reduce(sorted_pos, sorted_keys, strides, cutoff_sq,
                      sorted_pos_lo, sorted_payload, *, CB, MAXJ, term,
                      out_dtype, min_islot, kahan, OH, packed, bandmask,
                      safe_term, device, plain: bool):
    if bandmask is None:
        bandmask = not packed  # the packed path defaults to the maskless body
    if sorted_payload is not None and not packed:
        raise ValueError("sorted_payload needs the packed layout")
    if not packed and (not bandmask or not safe_term or kahan == "program"):
        raise ValueError("bandmask=False / safe_term=False / "
                         'kahan="program" need the packed layout')
    if CB < 1:
        raise ValueError(f"CB must be >= 1, got {CB}")
    if not packed and not isinstance(MAXJ, int):
        raise ValueError("per-band MAXJ tuples need the packed layout; "
                         "pass packed=True")
    if CHUNK % OH or OH % 8:
        raise ValueError("OH must divide 128 and be a multiple of 8")
    if packed and OH != CHUNK:
        raise ValueError("OH row groups apply to the non-packed layout "
                         "only; pass packed=False with OH != 128")
    device = resolve_device(device, sorted_pos)
    sorted_pos = torch.as_tensor(sorted_pos, device=device)
    sorted_keys = torch.as_tensor(sorted_keys, device=device)
    if sorted_pos_lo is not None:
        sorted_pos_lo = torch.as_tensor(sorted_pos_lo, device=device)
    distributed = not (isinstance(min_islot, int) and min_islot == 0)
    kernel = device.type == "cuda" and not plain
    if kernel and distributed:
        raise ValueError(
            "the CUDA kernel K6 takes only min_islot=0 (multi-device, slice "
            "9); run others through tile_pair_reduce_plain"
        )
    inp = tile_inputs(_planes(sorted_pos), sorted_keys, strides,
                      _planes(sorted_pos_lo), CB=CB, MAXJ=MAXJ, packed=packed,
                      bandmask=bandmask)
    total = _reduce(inp, cutoff_sq, kernel, term=term, out_dtype=out_dtype,
                    safe_term=safe_term, payload=sorted_payload,
                    min_islot=min_islot)
    return total, inp.coverage_ok


def _reduce(inp: TileInputs, cutoff_sq, kernel: bool, **kw) -> torch.Tensor:
    """K6 for ``kernel``, else its plain version (which alone reads
    ``safe_term`` and ``min_islot``)."""
    if kernel:
        return reduce_tiles(inp, cutoff_sq, term=kw["term"], out_dtype=kw["out_dtype"],
                            payload=kw.get("payload"))
    return reduce_tiles_plain(inp, cutoff_sq, **kw)


def tile_pair_reduce(sorted_pos, sorted_keys, strides, cutoff_sq,
                     sorted_pos_lo=None, sorted_payload=None, *, CB: int = 8,
                     MAXJ=4, term: Callable = lj_term, out_dtype=None,
                     min_islot=0, kahan=True, OH: int = 128, packed: bool = True,
                     bandmask: bool | None = None, safe_term: bool = True,
                     device=None):
    """Sum ``term(dsq)`` over all unique cutoff pairs of key-sorted
    particles, any box shape (the sibling of `pair_lag_reduce`).

    Returns (total, coverage_ok). coverage_ok is False iff some chunk's
    partner window needs more than MAXJ j-chunks (or, packed and f32, a key
    reaches 2^24; or, maskless, two bands' windows overlap): rerun with a
    larger MAXJ, ``packed=False`` or ``bandmask=True``, and never trust a
    result with a false flag. ``MAXJ`` may be a per-band tuple
    (`segments.suggest_maxj(per_band=True)`) on the packed path. Integer
    ``out_dtype`` returns the (hi, lo) int32 pair of `combine_count`.

    The JAX package's arguments keep their meaning for the result:
    ``bandmask=None`` is False on the packed path and True otherwise;
    ``packed`` decides the 2^24 key term of the flag; ``CB`` fixes the
    padding (`tile_inputs`) and need not be a multiple of 8 (a TPU
    scalar-memory rule); ``OH`` is validated and has no other effect;
    every ``kahan`` mode sums in f64 (tighter than the TPU's f32 Kahan);
    ``safe_term=False`` changes nothing, since masked lanes are selected
    out, never multiplied.

    CUDA tensors run kernel K6, which takes f32 coordinates, the terms
    `lj_term`, `lj_term_fast`, `count_term` and `lj_virial_term`, one
    payload rule (the periodic keep mask: a `lag_pairs.PbcKeepTerm` of one
    of those terms over the (n,) ``sorted_payload`` plane) and
    ``min_islot=0``, and raises on anything else (other payload terms
    come with slice 5b, ``min_islot`` with slice 9). CPU tensors run
    `reduce_tiles_plain`, which takes them all.
    """
    return _tile_pair_reduce(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
        sorted_payload, CB=CB, MAXJ=MAXJ, term=term, out_dtype=out_dtype,
        min_islot=min_islot, kahan=kahan, OH=OH, packed=packed,
        bandmask=bandmask, safe_term=safe_term, device=device, plain=False)


def tile_pair_reduce_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                           sorted_pos_lo=None, sorted_payload=None, *,
                           CB: int = 8, MAXJ=4, term: Callable = lj_term,
                           out_dtype=None, min_islot=0, kahan=True,
                           OH: int = 128, packed: bool = True,
                           bandmask: bool | None = None,
                           safe_term: bool = True, device=None):
    """`tile_pair_reduce` through its plain PyTorch version on any device
    (the yardstick K6 is held to on the card)."""
    return _tile_pair_reduce(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
        sorted_payload, CB=CB, MAXJ=MAXJ, term=term, out_dtype=out_dtype,
        min_islot=min_islot, kahan=kahan, OH=OH, packed=packed,
        bandmask=bandmask, safe_term=safe_term, device=device, plain=True)


# Kernel launches since the last reset; only a launch of K6 adds to it.
tile_pair_reduce.launches = 0


def tile_lj_rebuild_energy(positions, cutoff, positions_lo=None, *, CB: int = 8,
                           MAXJ=8, term: Callable = lj_term, kahan=True,
                           out_dtype=None, bandmask: bool = False,
                           safe_term: bool = True, device=None):
    """The cubic-box step (the tile sibling of `fused_lj_rebuild_energy`):
    cell keys -> one sort -> one gather into coordinate planes -> the tile
    reduction, packed semantics. ``positions_lo`` (f32 low parts from
    `split_f64`) selects split-precision separations. ``MAXJ`` may be a
    per-band tuple. Returns (total, coverage_ok).
    """
    del kahan
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    info = GridInfo.create(aabb_from_positions(positions), cutoff,
                           auto_order=True)
    sorted_keys, perm = torch.sort(compute_keys(positions, info))
    planes = positions.t().index_select(1, perm).contiguous()
    lo_planes = None
    if positions_lo is not None:
        lo = torch.as_tensor(positions_lo, device=device)
        lo_planes = lo.t().index_select(1, perm).contiguous()
    inp = tile_inputs(planes, sorted_keys, info.strides, lo_planes, CB=CB,
                      MAXJ=MAXJ, packed=True, bandmask=bandmask)
    csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
    total = _reduce(inp, csq, device.type == "cuda", term=term,
                    out_dtype=out_dtype, safe_term=safe_term)
    return total, inp.coverage_ok


def tile_lj_energy(sorted_pos, sorted_keys, strides, cutoff_sq,
                   sorted_pos_lo=None, **kw):
    return tile_pair_reduce(sorted_pos, sorted_keys, strides, cutoff_sq,
                            sorted_pos_lo, term=lj_term, **kw)


def tile_count_pairs(sorted_pos, sorted_keys, strides, cutoff_sq, **kw):
    """Returns ((hi, lo) int32 pair, coverage_ok); `combine_count` gives
    the exact count."""
    return tile_pair_reduce(sorted_pos, sorted_keys, strides, cutoff_sq,
                            term=count_term, out_dtype=torch.int32, **kw)


def forces_tiles_plain(inp: TileInputs, cutoff_sq, *,
                       gfn: Callable = lj_force_factor, out_dtype=None,
                       safe_term: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K7 over the same full-stencil windows,
    masks and force factor (``inp`` from ``tile_inputs(full=True)``).

    Own chunks go in batches; for each (band, window step) the batch's
    j-chunks are gathered and one (batch, 128, 128) tile of separations is
    built, masked by the slot bound, the key band (with ``bandmask``) and
    ``0 < dsq < cutoff^2`` (f64-grade near the cutoff in split mode, see
    `lag_pairs.split_cutoff_test`). Each own slot sums ``g d`` over its row in
    f64. Any ``gfn`` works. Returns (dim, n) force planes in
    ``out_dtype`` (default: the coordinates' dtype).
    """
    pos, lo = inp.pos, inp.lo
    dim, n = pos.shape
    device, dtype = pos.device, pos.dtype
    nc_pad = inp.bounds.shape[0]
    S = inp.bands.shape[0]
    C = nc_pad * CHUNK
    csq = float(torch.as_tensor(cutoff_sq, dtype=dtype))
    planes = pos if lo is None else torch.cat([pos, lo])
    padded = torch.zeros((planes.shape[0], C), dtype=dtype, device=device)
    padded[:, :n] = planes
    keys = inp.keys.to(torch.int64)
    lane = torch.arange(CHUNK, device=device)
    forces = torch.zeros((dim, n), dtype=torch.float64, device=device)
    nc_real = -(-n // CHUNK)  # chunks past it hold no own slot
    for c0 in range(0, nc_real, _PLAIN_BATCH):
        c1 = min(c0 + _PLAIN_BATCH, nc_real)
        own_s = torch.arange(c0, c1, device=device)[:, None] * CHUNK + lane
        own_ok = own_s < n
        own = padded[:, own_s][:, :, :, None]  # (D, b, 128, 1)
        own_k = keys[own_s][:, :, None]
        acc = torch.zeros((dim, c1 - c0, CHUNK), dtype=torch.float64, device=device)
        for s in range(S):
            jlo, toff, jnum = inp.bounds[c0:c1, 3 * s:3 * s + 3].long().unbind(1)
            lo_s, hi_s = inp.bands[s].long().unbind(0)
            for t in range(int(jnum.max()) if jnum.numel() else 0):
                jc = torch.clamp(jlo + toff + t, max=nc_pad - 1)
                j_s = jc[:, None] * CHUNK + lane  # (b, 128)
                j_ok = (j_s < n) & (t < jnum)[:, None]
                jp = padded[:, j_s][:, :, None, :]  # (D, b, 1, 128)
                d = []
                dsq = None
                for a in range(dim):
                    da = own[a] - jp[a]
                    if lo is not None:
                        da = da + (own[a + dim] - jp[a + dim])
                    d.append(da)
                    dsq = da * da if dsq is None else dsq + da * da
                inside = dsq < csq
                if lo is not None:
                    inside = split_cutoff_test(
                        inside, dsq, csq, own[:dim], jp[:dim], own[dim:], jp[dim:])
                m = own_ok[:, :, None] & j_ok[:, None, :] & inside & (dsq > 0)
                if inp.bandmask:
                    diff = own_k - keys[j_s][:, None, :]
                    m = m & (diff >= lo_s) & (diff <= hi_s)
                gv = gfn(torch.where(m, dsq, torch.ones_like(dsq)) if safe_term else dsq)
                g = torch.where(m, gv, torch.zeros_like(gv))
                for a in range(dim):
                    acc[a] += (g * d[a]).to(torch.float64).sum(-1)
        s0, s1 = c0 * CHUNK, min(c1 * CHUNK, n)
        forces[:, s0:s1] = acc.reshape(dim, -1)[:, :s1 - s0]
    return forces.to(out_dtype or dtype)


def _bind_forces(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zelll_tile_forces.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ci, ci, ci, vp, vp,
    ]
    lib.zelll_tile_forces.restype = ci
    lib.zelll_tile_forces_chunk.argtypes = []
    lib.zelll_tile_forces_chunk.restype = ci
    if lib.zelll_tile_forces_chunk() != CHUNK:
        raise RuntimeError("tile_forces.cu was built for another chunk size")


# Build (at first use) and load the K7 library; its build log is
# ``load_forces_kernel.log``.
load_forces_kernel = kernel_loader(_CSRC / "tile_forces.cu", "tile_forces",
                                   _bind_forces)


def forces_tiles(inp: TileInputs, cutoff_sq, *, gfn: Callable = lj_force_factor,
                 out_dtype=None) -> torch.Tensor:
    """Launch K7 on the current stream. Returns (dim, n) force planes.

    Takes ``inp`` from ``tile_inputs(full=True)`` with f32 planes on a
    CUDA device, and the force factors `lj_force_factor` and
    `lj_force_factor_fast`; raises on anything else. ``out_dtype``
    float32 (the default) or float64 (the f64 sums of the f32 terms).
    """
    if gfn not in _KERNEL_GFNS:
        raise ValueError(
            "the CUDA kernel implements lj_force_factor and "
            "lj_force_factor_fast only; run other force factors through "
            "tile_pair_forces_plain or on CPU tensors"
        )
    pos = inp.pos
    device = pos.device
    dim, n = pos.shape
    out_dtype = out_dtype or pos.dtype
    if out_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K7 writes float32 or float64 forces, not {out_dtype}")
    S = inp.bands.shape[0]
    nc_pad = inp.bounds.shape[0]
    if device.type != "cuda":
        raise ValueError(f"K7 runs on a CUDA device, not {device}")
    if not 1 <= dim <= 3 or S != num_segments(dim, full=True) \
            or nc_pad * CHUNK >= 2**31:
        raise ValueError("K7 takes 1 <= dim <= 3, the full stencil's bands "
                         f"and fewer than 2^31 slots; got {(dim, n)}, S = {S}")
    _check_cuda("pos", pos, torch.float32, (dim, n), device, "K7")
    if inp.lo is not None:
        _check_cuda("lo", inp.lo, torch.float32, (dim, n), device, "K7")
    _check_cuda("keys", inp.keys, torch.int32, (nc_pad * CHUNK,), device, "K7")
    _check_cuda("bounds", inp.bounds, torch.int32, (nc_pad, 3 * S), device, "K7")
    _check_cuda("bands", inp.bands, torch.int32, (S, 2), device, "K7")
    out = torch.empty((dim, n), dtype=out_dtype, device=device)
    if n == 0:
        return out
    lib = load_forces_kernel()
    csq = float(torch.as_tensor(cutoff_sq, dtype=torch.float32))
    err = lib.zelll_tile_forces(
        pos.data_ptr(), None if inp.lo is None else inp.lo.data_ptr(),
        inp.keys.data_ptr(), inp.bounds.data_ptr(), inp.bands.data_ptr(),
        n, dim, S, csq, _KERNEL_GFNS[gfn], int(out_dtype == torch.float64),
        int(inp.bandmask), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {err}")
    tile_pair_forces.launches += 1
    return out


def _forces(inp: TileInputs, cutoff_sq, kernel: bool, *, gfn, out_dtype,
            safe_term) -> torch.Tensor:
    """K7 for ``kernel``, else its plain version (which alone reads
    ``safe_term``)."""
    if kernel:
        return forces_tiles(inp, cutoff_sq, gfn=gfn, out_dtype=out_dtype)
    return forces_tiles_plain(inp, cutoff_sq, gfn=gfn, out_dtype=out_dtype,
                              safe_term=safe_term)


def tile_forces_core(planes: torch.Tensor, sorted_keys: torch.Tensor, strides,
                     cutoff_sq, lo_planes: torch.Tensor | None = None, *,
                     CB: int = 8, MAXJ=6, gfn: Callable = lj_force_factor,
                     packed: bool = True, bandmask: bool = True,
                     safe_term: bool = True, out_dtype=None,
                     plain: bool = False):
    """The forces pipeline over coordinate planes, the counterpart of the
    JAX package's ``_packed_forces_core``: (dim, n) sorted planes (and
    their low parts) in, ((dim, n) force planes, coverage_ok) out, so the
    MD loops never stack or transpose their state.

    Pads the keys, locates the full-stencil windows (trimmed disjoint in
    ``band_order(dim, full=True)`` without ``bandmask``), folds the flag
    and runs K7 on CUDA tensors, or the plain version on CPU tensors or
    with ``plain=True``.
    """
    inp = tile_inputs(planes, sorted_keys, strides, lo_planes, CB=CB, MAXJ=MAXJ,
                      packed=packed, bandmask=bandmask, full=True)
    kernel = planes.device.type == "cuda" and not plain
    forces = _forces(inp, cutoff_sq, kernel, gfn=gfn, out_dtype=out_dtype,
                     safe_term=safe_term)
    return forces, inp.coverage_ok


def _tile_pair_forces(sorted_pos, sorted_keys, strides, cutoff_sq,
                      sorted_pos_lo, *, CB, MAXJ, gfn, packed, bandmask,
                      safe_term, out_dtype, device, plain: bool):
    if gfn is None:
        gfn = lj_force_factor
    if bandmask is None:
        bandmask = not packed  # the packed path defaults to the maskless body
    if not packed and (not bandmask or not safe_term):
        raise ValueError("bandmask=False / safe_term=False need the packed "
                         "layout; pass packed=True")
    if not packed and not isinstance(MAXJ, int):
        raise ValueError("per-band MAXJ tuples need the packed layout; "
                         "pass packed=True")
    if CB < 1:
        raise ValueError(f"CB must be >= 1, got {CB}")
    device = resolve_device(device, sorted_pos)
    sorted_pos = torch.as_tensor(sorted_pos, device=device)
    sorted_keys = torch.as_tensor(sorted_keys, device=device)
    if sorted_pos_lo is not None:
        sorted_pos_lo = torch.as_tensor(sorted_pos_lo, device=device)
    forces, ok = tile_forces_core(
        _planes(sorted_pos), sorted_keys, strides, cutoff_sq,
        _planes(sorted_pos_lo), CB=CB, MAXJ=MAXJ, gfn=gfn, packed=packed,
        bandmask=bandmask, safe_term=safe_term, out_dtype=out_dtype,
        plain=plain)
    return forces.t(), ok


def tile_pair_forces(sorted_pos, sorted_keys, strides, cutoff_sq,
                     sorted_pos_lo=None, *, CB: int = 8, MAXJ=6,
                     gfn: Callable | None = None, packed: bool = True,
                     bandmask: bool | None = None, safe_term: bool = True,
                     out_dtype=None, device=None):
    """Per-particle pair forces in sorted-slot order, any box shape (the
    sibling of `lag_pairs.pair_lag_forces`).

    f_i is the sum over cutoff partners j of ``gfn(dsq) * (p_i - p_j)``
    (``0 < dsq < cutoff_sq``): the full stencil's mirrored bands give each
    particle both sides of its pairs directly. ``gfn`` defaults to
    `ops.lj.lj_force_factor`. Returns ((n, dim) forces, a view of (dim, n)
    planes, and coverage_ok); never trust forces with a False flag.

    The JAX package's arguments keep their meaning: ``bandmask=None`` is
    False on the packed path and True otherwise; ``packed`` decides the
    2^24 key term of the flag, and ``packed=False`` refuses
    ``bandmask=False``, ``safe_term=False`` and per-band MAXJ tuples;
    ``MAXJ`` may be a per-band tuple (9 entries in 3-D, see
    ``segments.suggest_maxj(half=False, per_band=True)``); ``CB`` fixes
    the padding (`tile_inputs`); ``safe_term=False`` changes nothing,
    since masked lanes are selected out. ``out_dtype`` defaults to the
    coordinates' dtype.

    CUDA tensors run kernel K7, which takes f32 coordinates and the force
    factors `lj_force_factor` and `lj_force_factor_fast`, and raises on
    anything else. CPU tensors run `forces_tiles_plain`.
    """
    return _tile_pair_forces(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, CB=CB,
        MAXJ=MAXJ, gfn=gfn, packed=packed, bandmask=bandmask,
        safe_term=safe_term, out_dtype=out_dtype, device=device, plain=False)


def tile_pair_forces_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                           sorted_pos_lo=None, *, CB: int = 8, MAXJ=6,
                           gfn: Callable | None = None, packed: bool = True,
                           bandmask: bool | None = None,
                           safe_term: bool = True, out_dtype=None,
                           device=None):
    """`tile_pair_forces` through its plain PyTorch version on any device
    (the yardstick K7 is held to on the card)."""
    return _tile_pair_forces(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, CB=CB,
        MAXJ=MAXJ, gfn=gfn, packed=packed, bandmask=bandmask,
        safe_term=safe_term, out_dtype=out_dtype, device=device, plain=True)


# Kernel launches since the last reset; only a launch of K7 adds to it.
tile_pair_forces.launches = 0


# -- observables: the stress tensor (K8) and the histogram (K9) --------------

# The histogram kernels' limits, kept on both devices as the JAX package
# keeps them: K <= 64 edges, and sum(MAXJ) <= 255 (its 8-bit packed
# accumulator).
TILE_HIST_MAX_BINS = 64
TILE_HIST_MAX_TILES = 255


def stress_tiles_plain(inp: TileInputs, cutoff_sq, *,
                       gfn: Callable = lj_force_factor, out_dtype=None,
                       safe_term: bool = True, payload=None, pair_mask=None,
                       pair_weight=None, min_islot=0) -> torch.Tensor:
    """Plain PyTorch version of K8 over the same windows and masks as K6's
    (`_half_tiles`): the pairs with ``0 < dsq < cutoff^2`` add
    ``(g d_a) d_b`` to sigma_ab, g = gfn(dsq) in the coordinates' dtype.
    Any ``gfn`` works, and so do the JAX kernel's payload rules over one
    sorted (n,) plane: ``pair_mask(own, j)``, the multiplicative
    ``pair_weight(own, j)`` and ``min_islot``. Sums in f64; returns the
    symmetric (dim, dim) tensor in ``out_dtype`` (default: the
    coordinates' dtype).
    """
    dim = inp.pos.shape[0]
    device, dtype = inp.pos.device, inp.pos.dtype
    csq = float(torch.as_tensor(cutoff_sq, dtype=dtype))
    sig = torch.zeros((dim, dim), dtype=torch.float64, device=device)
    for d, dsq, m, own_w, j_w in _half_tiles(inp, payload, min_islot):
        m = m & (dsq < csq) & (dsq > 0)
        if pair_mask is not None:
            m = m & pair_mask(own_w, j_w)
        gv = gfn(torch.where(m, dsq, torch.ones_like(dsq)) if safe_term else dsq)
        g = torch.where(m, gv, torch.zeros_like(gv)).to(dtype)
        if pair_weight is not None:
            g = g * pair_weight(own_w, j_w).to(dtype)
        for a in range(dim):
            gd = g * d[a]
            for b in range(a, dim):
                sig[a, b] += (gd * d[b]).sum(dtype=torch.float64)
    sig = torch.triu(sig) + torch.triu(sig, 1).t()
    return sig.to(out_dtype or dtype)


def _check_tile_observable(kernel: str, inp: TileInputs):
    """The inputs the observables kernels K8 and K9 take: f32 (optionally
    split) or f64 planes on a CUDA device, 1 <= dim <= 3, the half
    stencil's bands, fewer than 2^31 slots."""
    pos = inp.pos
    device = pos.device
    dim, n = pos.shape
    S = inp.bands.shape[0]
    nc_pad = inp.bounds.shape[0]
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on a CUDA device, not {device}")
    if pos.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{kernel} takes float32 or float64 planes, not {pos.dtype}")
    if inp.lo is not None and pos.dtype != torch.float32:
        raise ValueError(f"{kernel} takes low parts with float32 planes only")
    if not 1 <= dim <= 3 or S != num_segments(dim) or nc_pad * CHUNK >= 2**31:
        raise ValueError(f"{kernel} takes 1 <= dim <= 3, the half stencil's bands "
                         f"and fewer than 2^31 slots; got {(dim, n)}, S = {S}")
    _check_cuda("pos", pos, pos.dtype, (dim, n), device, kernel)
    if inp.lo is not None:
        _check_cuda("lo", inp.lo, torch.float32, (dim, n), device, kernel)
    _check_cuda("keys", inp.keys, torch.int32, (nc_pad * CHUNK,), device, kernel)
    _check_cuda("bounds", inp.bounds, torch.int32, (nc_pad, 3 * S), device, kernel)
    _check_cuda("bands", inp.bands, torch.int32, (S, 2), device, kernel)


def _bind_stress(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zelll_tile_stress.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_double, ci, ci, ci, vp, vp,
    ]
    lib.zelll_tile_stress.restype = ci
    lib.zelll_tile_stress_chunk.argtypes = []
    lib.zelll_tile_stress_chunk.restype = ci
    if lib.zelll_tile_stress_chunk() != CHUNK:
        raise RuntimeError("tile_stress.cu was built for another chunk size")


# Build (at first use) and load the K8 library; its build log is
# ``load_stress_kernel.log``.
load_stress_kernel = kernel_loader(_CSRC / "tile_stress.cu", "tile_stress",
                                   _bind_stress)


def stress_tiles(inp: TileInputs, cutoff_sq, *, gfn: Callable = lj_force_factor,
                 out_dtype=None) -> torch.Tensor:
    """Launch K8 on the current stream and sum its per-chunk partials.

    Takes ``inp`` from `tile_inputs` (the half stencil) with f32 (optionally
    split) or f64 planes on a CUDA device, and the force factors
    `lj_force_factor` and `lj_force_factor_fast`; raises on anything else.
    Returns the symmetric (dim, dim) stress in ``out_dtype`` (default: the
    planes' dtype; float64 gives the f64 sums of f32 products).
    """
    if gfn not in _KERNEL_GFNS:
        raise ValueError(
            "the CUDA kernel implements lj_force_factor and "
            "lj_force_factor_fast only; run other force factors through "
            "tile_pair_stress_plain or on CPU tensors"
        )
    pos = inp.pos
    dim, n = pos.shape
    out_dtype = out_dtype or pos.dtype
    if out_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K8 writes float32 or float64 stress, not {out_dtype}")
    _check_tile_observable("K8", inp)
    if n == 0:
        return torch.zeros((dim, dim), dtype=out_dtype, device=pos.device)
    lib = load_stress_kernel()
    partial = torch.empty((-(-n // CHUNK), 6), dtype=torch.float64, device=pos.device)
    csq = float(torch.as_tensor(cutoff_sq, dtype=pos.dtype))
    err = lib.zelll_tile_stress(
        pos.data_ptr(), None if inp.lo is None else inp.lo.data_ptr(),
        inp.keys.data_ptr(), inp.bounds.data_ptr(), inp.bands.data_ptr(),
        n, dim, inp.bands.shape[0], csq, _KERNEL_GFNS[gfn], int(inp.bandmask),
        int(pos.dtype == torch.float64), partial.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K8 launch failed: CUDA error {err}")
    tile_pair_stress.launches += 1
    return symmetric_stress(partial.sum(0), dim).to(out_dtype)


def _observable_inputs(sorted_pos, sorted_keys, strides, sorted_pos_lo, *, CB,
                       MAXJ, bandmask, device):
    """Device, (n, dim) positions and the half-stencil `TileInputs` of the
    observables' tile entry points (the packed layout's flag)."""
    if CB < 1:
        raise ValueError(f"CB must be >= 1, got {CB}")
    device = resolve_device(device, sorted_pos)
    sorted_pos = torch.as_tensor(sorted_pos, device=device)
    sorted_keys = torch.as_tensor(sorted_keys, device=device)
    if sorted_pos_lo is not None:
        sorted_pos_lo = torch.as_tensor(sorted_pos_lo, device=device)
    inp = tile_inputs(_planes(sorted_pos), sorted_keys, strides,
                      _planes(sorted_pos_lo), CB=CB, MAXJ=MAXJ, packed=True,
                      bandmask=bandmask)
    return device, sorted_pos, inp


def _tile_pair_stress(sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
                      sorted_payload, *, gfn, CB, MAXJ, min_islot, pair_mask,
                      bandmask, safe_term, pair_weight, out_dtype, device,
                      plain: bool):
    gfn = gfn or lj_force_factor
    if (sorted_payload is None) != (pair_mask is None and pair_weight is None):
        raise ValueError("pair_mask/pair_weight and sorted_payload go together")
    device, sorted_pos, inp = _observable_inputs(
        sorted_pos, sorted_keys, strides, sorted_pos_lo, CB=CB, MAXJ=MAXJ,
        bandmask=bandmask, device=device)
    if device.type == "cuda" and not plain:
        if sorted_payload is not None or not _is_default_islot(min_islot):
            raise ValueError("the CUDA kernel takes no payload rule "
                             "(sorted_payload, pair_mask, pair_weight) and only "
                             "min_islot=0; run these through tile_pair_stress_plain")
        sig = stress_tiles(inp, cutoff_sq, gfn=gfn, out_dtype=out_dtype)
    else:
        sig = stress_tiles_plain(inp, cutoff_sq, gfn=gfn, out_dtype=out_dtype,
                                 safe_term=safe_term, payload=sorted_payload,
                                 pair_mask=pair_mask, pair_weight=pair_weight,
                                 min_islot=min_islot)
    return sig, inp.coverage_ok


def tile_pair_stress(sorted_pos, sorted_keys, strides, cutoff_sq,
                     sorted_pos_lo=None, sorted_payload=None, *,
                     gfn: Callable | None = None, CB: int = 8, MAXJ=8,
                     min_islot=0, pair_mask=None, bandmask: bool = False,
                     safe_term: bool = True, pair_weight=None, out_dtype=None,
                     device=None):
    """Configurational stress tensor sigma_ab = sum_pairs gfn(dsq) d_a d_b
    over the unique pairs of the half-stencil windows with
    ``0 < dsq < cutoff_sq``, any box shape (the sibling of
    `lag_pairs.pair_lag_stress`): a direct fused pair sum. Returns
    ((dim, dim), coverage_ok); never trust a result with a false flag.

    The JAX package's arguments keep their meaning: ``bandmask=False``
    (the default) runs the maskless body over windows trimmed disjoint,
    and its flag also requires that they are; ``MAXJ`` may be a per-band
    tuple; ``CB`` fixes the padding (`tile_inputs`); ``safe_term=False``
    changes nothing on the card, where masked lanes are selected out.
    ``sorted_payload`` (one sorted (n,) plane) feeds ``pair_mask(own, j)``
    and the multiplicative ``pair_weight(own, j)``; ``min_islot`` is the
    ownership rule. ``out_dtype`` defaults to the coordinates' dtype.

    CUDA tensors run kernel K8, which takes f32 (optionally split) or f64
    coordinates, the force factors `lj_force_factor` and
    `lj_force_factor_fast`, no payload rule and ``min_islot=0``, and raises
    on anything else. CPU tensors run `stress_tiles_plain`.
    """
    return _tile_pair_stress(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, sorted_payload,
        gfn=gfn, CB=CB, MAXJ=MAXJ, min_islot=min_islot, pair_mask=pair_mask,
        bandmask=bandmask, safe_term=safe_term, pair_weight=pair_weight,
        out_dtype=out_dtype, device=device, plain=False)


def tile_pair_stress_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                           sorted_pos_lo=None, sorted_payload=None, *,
                           gfn: Callable | None = None, CB: int = 8, MAXJ=8,
                           min_islot=0, pair_mask=None, bandmask: bool = False,
                           safe_term: bool = True, pair_weight=None,
                           out_dtype=None, device=None):
    """`tile_pair_stress` through its plain PyTorch version on any device
    (the yardstick K8 is held to on the card)."""
    return _tile_pair_stress(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, sorted_payload,
        gfn=gfn, CB=CB, MAXJ=MAXJ, min_islot=min_islot, pair_mask=pair_mask,
        bandmask=bandmask, safe_term=safe_term, pair_weight=pair_weight,
        out_dtype=out_dtype, device=device, plain=True)


# Kernel launches since the last reset; only a launch of K8 adds to it.
tile_pair_stress.launches = 0


def hist_tiles_plain(inp: TileInputs, edges_sq, *, payload=None, pair_mask=None,
                     min_islot=0) -> torch.Tensor:
    """Plain PyTorch version of K9 over the same windows and masks as K6's
    (`_half_tiles`): each pair with ``dsq < edges_sq[-1]`` (no dsq > 0
    test) goes to the first bin whose edge is above its dsq, and the prefix
    sum gives ``count_k = #pairs with dsq < edges_sq[k]``. ``pair_mask(own,
    j)`` reads one sorted (n,) payload plane; ``min_islot`` keeps pairs
    whose larger slot is at or above it. Returns (2, K) int32 hi/lo planes.
    """
    edges = hist_edges(edges_sq, inp.pos.dtype, inp.pos.device)
    K = edges.shape[0]
    first = torch.zeros((K + 1,), dtype=torch.int64, device=inp.pos.device)
    for _, dsq, m, own_w, j_w in _half_tiles(inp, payload, min_islot):
        m = m & (dsq < edges[-1])
        if pair_mask is not None:
            m = m & pair_mask(own_w, j_w)
        b = torch.where(m, torch.searchsorted(edges, dsq, right=True), K)
        first.index_add_(0, b.reshape(-1), torch.ones_like(b).reshape(-1))
    return _cumulative_counts(first[:K])


def _bind_hist(lib) -> None:
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.zelll_tile_hist.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, cd, cd, ci, ci, vp, vp,
    ]
    lib.zelll_tile_hist.restype = ci
    lib.zelll_tile_hist_chunk.argtypes = []
    lib.zelll_tile_hist_chunk.restype = ci
    if lib.zelll_tile_hist_chunk() != CHUNK:
        raise RuntimeError("tile_hist.cu was built for another chunk size")


# Build (at first use) and load the K9 library; its build log is
# ``load_hist_kernel.log``.
load_hist_kernel = kernel_loader(_CSRC / "tile_hist.cu", "tile_hist", _bind_hist)


def hist_tiles(inp: TileInputs, edges_sq, *, payload=None,
               pair_mask=None) -> torch.Tensor:
    """Launch K9 on the current stream: (2, K) int32 hi/lo planes.

    Takes ``inp`` from `tile_inputs` (the half stencil) with f32 (optionally
    split) or f64 planes on a CUDA device, K <= 64 ascending edges, and no
    mask or a `lag_pairs.SpeciesPairMask` over one payload plane; raises on
    anything else.
    """
    pos = inp.pos
    dim, n = pos.shape
    _check_tile_observable("K9", inp)
    edges = hist_edges(edges_sq, pos.dtype, pos.device)
    K = edges.shape[0]
    if K > TILE_HIST_MAX_BINS:
        raise ValueError(f"tile histogram: K = {K} > {TILE_HIST_MAX_BINS} edges")
    mask, ma, mb, plane = mask_plane("K9", pair_mask, payload, n, pos.dtype,
                                     pos.device)
    first = torch.zeros((K,), dtype=torch.int64, device=pos.device)
    if n == 0:
        return _cumulative_counts(first)
    lib = load_hist_kernel()
    err = lib.zelll_tile_hist(
        pos.data_ptr(), None if inp.lo is None else inp.lo.data_ptr(),
        None if plane is None else plane.data_ptr(), inp.keys.data_ptr(),
        inp.bounds.data_ptr(), inp.bands.data_ptr(), edges.data_ptr(), n, dim,
        inp.bands.shape[0], K, mask, ma, mb, int(inp.bandmask),
        int(pos.dtype == torch.float64), first.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K9 launch failed: CUDA error {err}")
    tile_pair_hist.launches += 1
    return _cumulative_counts(first)


def _tile_pair_hist(sorted_pos, sorted_keys, strides, edges_sq, sorted_pos_lo,
                    sorted_payload, *, CB, MAXJ, min_islot, pair_mask, bandmask,
                    device, plain: bool):
    if (sorted_payload is None) != (pair_mask is None):
        raise ValueError("pair_mask and sorted_payload go together")
    K = torch.as_tensor(edges_sq).numel()
    if K > TILE_HIST_MAX_BINS:
        raise ValueError(f"tile histogram: K = {K} > {TILE_HIST_MAX_BINS} edges")
    if CB < 1:
        raise ValueError(f"CB must be >= 1, got {CB}")
    n, dim = torch.as_tensor(sorted_pos).shape
    nc_pad = max(-(-n // (CHUNK * CB)) * CB, CB)
    if sum(_norm_maxj(MAXJ, num_segments(dim), nc_pad)) > TILE_HIST_MAX_TILES:
        raise ValueError(
            f"tile histogram: sum(MAXJ) > {TILE_HIST_MAX_TILES}, the JAX "
            "kernel's 8-bit packed accumulator field capacity; use smaller "
            "per-band capacities")
    device, sorted_pos, inp = _observable_inputs(
        sorted_pos, sorted_keys, strides, sorted_pos_lo, CB=CB, MAXJ=MAXJ,
        bandmask=bandmask, device=device)
    if device.type == "cuda" and not plain:
        if not _is_default_islot(min_islot):
            raise ValueError("the CUDA kernel takes only min_islot=0; run "
                             "others through tile_pair_hist_plain")
        packed = hist_tiles(inp, edges_sq, payload=sorted_payload, pair_mask=pair_mask)
    else:
        packed = hist_tiles_plain(inp, edges_sq, payload=sorted_payload,
                                  pair_mask=pair_mask, min_islot=min_islot)
    return packed, inp.coverage_ok


def tile_pair_hist(sorted_pos, sorted_keys, strides, edges_sq, sorted_pos_lo=None,
                   sorted_payload=None, *, CB: int = 8, MAXJ=8, min_islot=0,
                   pair_mask=None, bandmask: bool = False, device=None):
    """Cumulative pair-distance histogram over the unique pairs of the
    half-stencil windows, any box shape (the sibling of
    `lag_pairs.pair_lag_hist`): ``out[k] = #pairs with dsq <
    edges_sq[k]``, the effective cutoff being ``edges_sq[-1]``, which the
    binning grid must have used. Returns ((2, K) int32 hi/lo planes, see
    `lag_pairs.combine_count_vec`, coverage_ok).

    As in the JAX package, K <= 64 and sum(MAXJ) <= 255 (after clamping to
    the chunk count) on both devices. ``bandmask=False`` (the default) runs
    the maskless body over disjoint-trimmed windows; small or dense grids
    can trip that flag and must rerun with ``bandmask=True``.
    ``sorted_payload`` (one sorted (n,) plane) feeds ``pair_mask(own, j)``;
    ``min_islot`` is the ownership rule.

    CUDA tensors run kernel K9, which takes f32 (optionally split) or f64
    coordinates, no mask or a `lag_pairs.SpeciesPairMask`, and
    ``min_islot=0``, and raises on anything else. CPU tensors run
    `hist_tiles_plain`.
    """
    return _tile_pair_hist(
        sorted_pos, sorted_keys, strides, edges_sq, sorted_pos_lo, sorted_payload,
        CB=CB, MAXJ=MAXJ, min_islot=min_islot, pair_mask=pair_mask,
        bandmask=bandmask, device=device, plain=False)


def tile_pair_hist_plain(sorted_pos, sorted_keys, strides, edges_sq,
                         sorted_pos_lo=None, sorted_payload=None, *, CB: int = 8,
                         MAXJ=8, min_islot=0, pair_mask=None,
                         bandmask: bool = False, device=None):
    """`tile_pair_hist` through its plain PyTorch version on any device (the
    yardstick K9 is held to on the card)."""
    return _tile_pair_hist(
        sorted_pos, sorted_keys, strides, edges_sq, sorted_pos_lo, sorted_payload,
        CB=CB, MAXJ=MAXJ, min_islot=min_islot, pair_mask=pair_mask,
        bandmask=bandmask, device=device, plain=True)


# Kernel launches since the last reset; only a launch of K9 adds to it.
tile_pair_hist.launches = 0
