"""The lag-window pair reduction (kernel K1) and pair forces (kernel K3)
over key-sorted particles.

PyTorch counterpart of ``zelll_tpu/ops/pallas_pairs.py`` for the reduction
the main path runs (`pair_lag_reduce`), the forces of the thin-box MD loops
(`pair_lag_forces`) and their host helpers.

After sorting by flat cell key, every cutoff partner j < i of particle i
satisfies ``key_j >= key_i - W`` with ``W = sum(strides)``, so all of them
lie within a bounded lag behind i in slot order. A pair is counted once, by
its larger slot: for lag in 1..L, pairs (i, i - lag) masked by the key
window and by ``dsq < cutoff^2``. The pair list never exists.

`pair_lag_reduce` launches the hand-written CUDA kernel
(``csrc/lag_reduce.cu``) for CUDA tensors and runs
`pair_lag_reduce_plain` for CPU tensors; `pair_lag_forces` does the same
with ``csrc/lag_forces.cu`` and `pair_lag_forces_plain`. There is no
fallback between the two: a CUDA input a kernel cannot take raises.

Split precision: with f32 coordinates in a large box ``x_i - x_j`` loses
small separations to cancellation. ``sorted_pos_lo`` carries the f32 low
parts of the f64 coordinates (`split_f64`), and
``d = (hi_i - hi_j) + (lo_i - lo_j)`` recovers f64-grade distances.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core.geometry import SENTINEL_KEY, key_window
from ._build import kernel_loader
from .lj import lj_force_factor, lj_force_factor_fast

__all__ = [
    "pair_lag_reduce",
    "pair_lag_reduce_plain",
    "pair_lag_forces",
    "pair_lag_forces_plain",
    "lag_coverage_ok",
    "suggest_lag",
    "split_f64",
    "split_cutoff_test",
    "lj_term",
    "lj_term_fast",
    "count_term",
    "combine_count",
    "load_kernel",
    "load_forces_kernel",
]

# Padding-row keys start here: above every real key, below int32 overflow
# even after per-slot spacing.
_PAD_KEY_BASE = int(np.iinfo(np.int32).max) // 2
_INT32_MAX = int(np.iinfo(np.int32).max)

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SRC = _CSRC / "lag_reduce.cu"
_FORCES_SRC = _CSRC / "lag_forces.cu"


def lj_term(dsq):
    t = 1.0 / dsq
    t3 = t * t * t
    return 4.0 * t3 * (t3 - 1.0)


def lj_term_fast(dsq):
    """LJ through the reciprocal square root instead of a true division:
    a few ulp on the reciprocal, for the f32 headline mode. Parity modes
    keep `lj_term`."""
    r = torch.rsqrt(dsq)
    t = r * r
    t3 = t * t * t
    return 4.0 * t3 * (t3 - 1.0)


def count_term(dsq):
    return torch.ones_like(dsq)


# The terms the CUDA kernel implements, by the enum value it takes.
_KERNEL_TERMS = {lj_term: 0, count_term: 1}


# Split mode's tie band: |dsq - csq| <= _TIE_BAND * csq holds every pair
# whose f32 dsq can fall on the other side of the cutoff from its f64 dsq
# (the f32 dsq of split separations is within 6 x 2^-24 of it).
_TIE_BAND = 1e-6


def split_cutoff_test(inside, dsq, csq, hi_i, hi_j, lo_i, lo_j):
    """The cutoff test of split coordinates, f64-grade: pairs whose f32
    ``dsq`` lies within the tie band of ``csq`` are decided on the f64
    dsq of their split separations, ((hi_i - hi_j) + (lo_i - lo_j)) per
    axis in f64; the rest keep ``inside`` (``dsq < csq``). ``hi_i`` ..
    ``lo_j`` are per-axis sequences of broadcastable tensors. The forces
    kernels (K3, K7) apply the same rule in the same order of operations.
    The JAX package decides every pair on the f32 dsq, which flips pairs
    within about 4e-7 of the cutoff (ROADMAP queue 3)."""
    csq32 = torch.as_tensor(csq, dtype=dsq.dtype)
    band = torch.as_tensor(_TIE_BAND, dtype=dsq.dtype) * csq32
    near = (dsq - csq32).abs() <= band
    dsq64 = None
    for hi, hj, li, lj in zip(hi_i, hi_j, lo_i, lo_j):
        d = (hi.double() - hj.double()) + (li.double() - lj.double())
        dsq64 = d * d if dsq64 is None else dsq64 + d * d
    return torch.where(near, dsq64 < float(csq), inside)


def split_f64(x64: torch.Tensor):
    """Split f64 values into (hi, lo) f32 tensors with hi + lo == x64 to
    f32x2 precision."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def lag_coverage_ok(sorted_keys: torch.Tensor, strides, L: int) -> torch.Tensor:
    """True iff lag bound L covers every in-window pair:
    ``key[i] - key[i-L] > W`` for every real row i (SENTINEL_KEY rows, which
    sort last and hold no real pairs, are excluded)."""
    w = key_window(strides).to(sorted_keys.device)
    if sorted_keys.shape[0] <= L:
        return torch.ones((), dtype=torch.bool, device=sorted_keys.device)
    later = sorted_keys[L:]
    return ((later - sorted_keys[:-L] > w) | (later == SENTINEL_KEY)).all()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def suggest_lag(sorted_keys_host, strides_host, granule: int = 128) -> int:
    """Smallest granule multiple L with full coverage (host-side helper).
    SENTINEL_KEY rows are excluded as in `lag_coverage_ok`."""
    w = int(np.sum(_host(strides_host)))
    keys = _host(sorted_keys_host)
    n = len(keys)
    L = granule
    while L < n and not np.all(
        (keys[L:] - keys[:-L] > w) | (keys[L:] == SENTINEL_KEY)
    ):
        L *= 2
    return min(L, ((n + granule - 1) // granule) * granule)


def _pad_spacing(n: int) -> int:
    """The largest padding-key spacing that cannot overflow int32."""
    return max(1, (_INT32_MAX - _PAD_KEY_BASE - 1) // max(n, 1))


def _pad_and_desentinel(sorted_keys: torch.Tensor, ntot: int) -> torch.Tensor:
    """Extend (n,) keys to ``ntot`` slots and replace every padding key
    (SENTINEL_KEY rows and the appended tail) with strictly ascending keys
    spaced by ``_pad_spacing(ntot)`` from _PAD_KEY_BASE.

    Ascending padding keys end a key window after ceil(W / spacing) slots
    instead of holding it open over a whole padding run. They stay above
    every real key, so no real-vs-padding pair enters a window. K1 applies
    the same rule with ``ntot = n`` as it loads each key."""
    n = sorted_keys.shape[0]
    tail = torch.full((ntot - n,), SENTINEL_KEY, dtype=torch.int32,
                      device=sorted_keys.device)
    keys = torch.cat([sorted_keys.to(torch.int32), tail])
    iota = torch.arange(ntot, dtype=torch.int64, device=sorted_keys.device)
    pad = (_PAD_KEY_BASE + iota * _pad_spacing(ntot)).to(torch.int32)
    return torch.where(keys == SENTINEL_KEY, pad, keys)


def combine_count(packed) -> int:
    """The exact pair count from the (hi, lo) int32 pair returned by an
    integer `pair_lag_reduce`; a scalar (float) count is rounded."""
    v = np.asarray(_host(packed))
    if v.ndim == 0:
        return int(round(float(v)))
    return (int(v[0]) << 16) + int(v[1])


def _pack_count(total: torch.Tensor) -> torch.Tensor:
    """int64 total -> (hi, lo) int32 with total == (hi << 16) + lo."""
    return torch.stack([total >> 16, total & 0xFFFF]).to(torch.int32)


def pair_lag_reduce_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                          sorted_pos_lo=None, *, L: int = 256,
                          term: Callable = lj_term, out_dtype=None):
    """Plain PyTorch version of K1, vectorised over slots, one lag at a time.

    Same masks, separations and terms as the kernel; any ``term`` callable
    works here. Float sums are taken in f64 per lag; integer ones in int64.
    """
    n = sorted_pos.shape[0]
    dtype = sorted_pos.dtype
    out_dtype = out_dtype or dtype
    integer = not out_dtype.is_floating_point
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides).to(keys.device)
    csq = torch.as_tensor(cutoff_sq, dtype=dtype, device=sorted_pos.device)
    total = torch.zeros((), dtype=torch.int64 if integer else torch.float64,
                        device=sorted_pos.device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break  # keys ascend: no later lag can be in window
        dsq = torch.zeros((n - lag,), dtype=dtype, device=sorted_pos.device)
        for a in range(sorted_pos.shape[1]):
            d = sorted_pos[lag:, a] - sorted_pos[:-lag, a]
            if sorted_pos_lo is not None:
                d = d + (sorted_pos_lo[lag:, a] - sorted_pos_lo[:-lag, a])
            dsq = dsq + d * d
        mask = keymask & (dsq < csq)
        vals = term(torch.where(mask, dsq, torch.ones_like(dsq)))
        v = torch.where(mask, vals, torch.zeros_like(vals)).to(out_dtype)
        total += v.sum(dtype=total.dtype)
    if integer:
        return _pack_count(total)
    return total.to(out_dtype)


def _bind_reduce(lib) -> None:
    vp = ctypes.c_void_p
    lib.zelll_lag_reduce.argtypes = [
        vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, vp, vp,
    ]
    lib.zelll_lag_reduce.restype = ctypes.c_int
    lib.zelll_lag_reduce_block.argtypes = []
    lib.zelll_lag_reduce_block.restype = ctypes.c_int


# Build (at first use) and load the K1 library; its build log is
# ``load_kernel.log``.
load_kernel = kernel_loader(_SRC, "lag_reduce", _bind_reduce)


def _check_cuda(name: str, t: torch.Tensor, dtype, shape, device,
                kernel: str = "K1"):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{kernel} takes {name} as a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})"
        )


def _lag_reduce_cuda(sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
                     *, L, term, out_dtype):
    """Launch K1 on the current stream and sum its per-block partials."""
    device = sorted_pos.device
    n, dim = sorted_pos.shape
    if term not in _KERNEL_TERMS:
        raise ValueError(
            "the CUDA kernel implements lj_term and count_term only; run "
            "other terms through pair_lag_reduce_plain or on CPU tensors"
        )
    if out_dtype not in (torch.float32, torch.float64, torch.int32):
        raise ValueError(f"K1 writes float32, float64 or int32 sums, not {out_dtype}")
    if not 1 <= dim <= 3 or n >= 2**31:
        raise ValueError(f"K1 takes 1 <= dim <= 3 and n < 2^31; got {(n, dim)}")
    _check_cuda("sorted_pos", sorted_pos, torch.float32, (n, dim), device)
    if sorted_pos_lo is not None:
        _check_cuda("sorted_pos_lo", sorted_pos_lo, torch.float32, (n, dim), device)
    _check_cuda("sorted_keys", sorted_keys, torch.int32, (n,), device)
    integer = out_dtype == torch.int32
    acc = torch.int64 if integer else torch.float64
    if n == 0:
        total = torch.zeros((), dtype=acc, device=device)
        return _pack_count(total) if integer else total.to(out_dtype)
    lib = load_kernel()
    w_key = key_window(strides).reshape(1)
    block = lib.zelll_lag_reduce_block()
    partial = torch.empty((-(-n // block),), dtype=acc, device=device)
    csq = float(torch.as_tensor(cutoff_sq, dtype=torch.float32))
    err = lib.zelll_lag_reduce(
        sorted_pos.data_ptr(),
        None if sorted_pos_lo is None else sorted_pos_lo.data_ptr(),
        sorted_keys.data_ptr(), w_key.data_ptr(), n, dim, L, _pad_spacing(n), csq,
        _KERNEL_TERMS[term], int(integer), partial.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    pair_lag_reduce.launches += 1
    total = partial.sum()
    return _pack_count(total) if integer else total.to(out_dtype)


def pair_lag_reduce(sorted_pos, sorted_keys, strides, cutoff_sq,
                    sorted_pos_lo=None, *, M: int = 1024, L: int = 256,
                    term: Callable = lj_term, out_dtype=None, device=None):
    """Sum ``term(dsq)`` over all unique cutoff pairs of key-sorted particles.

    ``sorted_keys`` (int32) must ascend, SENTINEL_KEY rows last. L is the lag
    bound: the reduction considers lags 1..L exactly, as the TPU kernel
    does, so its output is defined even where `lag_coverage_ok` is False.
    ``M`` (the TPU kernel's block rows) is accepted for the JAX package's
    signature and has no effect here.

    ``sorted_pos_lo`` (f32 low parts, see `split_f64`) selects
    split-precision separations. ``out_dtype`` defaults to the positions'
    dtype; an integer ``out_dtype`` returns the (hi, lo) int32 pair that
    `combine_count` turns into the exact total. Float terms are summed in
    f64 and the total is then cast, so with f32 positions
    ``out_dtype=torch.float64`` returns the f64 sum of the f32 terms.

    CUDA tensors run kernel K1, which takes f32 coordinates and the terms
    `lj_term` and `count_term`, and raises on anything else. CPU tensors
    run `pair_lag_reduce_plain`.
    """
    del M
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    device = resolve_device(device, sorted_pos)
    sorted_pos = torch.as_tensor(sorted_pos, device=device)
    sorted_keys = torch.as_tensor(sorted_keys, device=device)
    strides = torch.as_tensor(strides, dtype=torch.int32, device=device)
    if sorted_pos_lo is not None:
        sorted_pos_lo = torch.as_tensor(sorted_pos_lo, device=device)
    if device.type == "cuda":
        return _lag_reduce_cuda(
            sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
            L=L, term=term, out_dtype=out_dtype or sorted_pos.dtype)
    return pair_lag_reduce_plain(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, L=L,
        term=term, out_dtype=out_dtype)


# Kernel launches since the last reset; only a launch of K1 adds to it.
pair_lag_reduce.launches = 0


# The force factors the K3 kernel implements, by the enum value it takes.
_KERNEL_GFNS = {lj_force_factor: 0, lj_force_factor_fast: 1}


def pair_lag_forces_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                          sorted_pos_lo=None, sorted_payload=None, *,
                          L: int = 256, gfn: Callable = lj_force_factor,
                          out_dtype=None):
    """Plain PyTorch version of K3, vectorised over slots, one lag at a time.

    Same masks, separations and force factor as the kernel: for each lag,
    the pairs (i, i - lag) in the key window with ``0 < dsq < cutoff^2``
    add ``g d`` to i and ``-g d`` to i - lag. Any ``gfn`` works here; with
    ``sorted_payload`` ((n, P), sorted order) it receives
    ``(dsq, own_0.., j_0..)``, own being the larger slot. The f32 (or
    f64) products are summed in f64 and the result is cast to
    ``out_dtype`` (default: the positions' dtype).
    """
    n, dim = sorted_pos.shape
    device, dtype = sorted_pos.device, sorted_pos.dtype
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides).to(device)
    csq = torch.as_tensor(cutoff_sq, dtype=dtype, device=device)
    pay = None if sorted_payload is None else \
        torch.as_tensor(sorted_payload, device=device).to(dtype)
    forces = torch.zeros((n, dim), dtype=torch.float64, device=device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break  # keys ascend: no later lag can be in window
        d = sorted_pos[lag:] - sorted_pos[:-lag]
        if sorted_pos_lo is not None:
            d = d + (sorted_pos_lo[lag:] - sorted_pos_lo[:-lag])
        dsq = d[:, 0] * d[:, 0]
        for a in range(1, dim):
            dsq = dsq + d[:, a] * d[:, a]
        inside = dsq < csq
        if sorted_pos_lo is not None:
            inside = split_cutoff_test(
                inside, dsq, csq, sorted_pos[lag:].unbind(1),
                sorted_pos[:-lag].unbind(1), sorted_pos_lo[lag:].unbind(1),
                sorted_pos_lo[:-lag].unbind(1))
        mask = keymask & inside & (dsq > 0)
        safe = torch.where(mask, dsq, torch.ones_like(dsq))
        if pay is None:
            gv = gfn(safe)
        else:
            gv = gfn(safe, *pay[lag:].unbind(1), *pay[:-lag].unbind(1))
        g = torch.where(mask, gv, torch.zeros_like(gv)).to(dtype)
        c = (g[:, None] * d).to(torch.float64)
        forces[lag:] += c
        forces[:-lag] -= c
    return forces.to(out_dtype or dtype)


def _bind_forces(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zelll_lag_forces.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ci, ci, vp, vp,
    ]
    lib.zelll_lag_forces.restype = ci


# Build (at first use) and load the K3 library; its build log is
# ``load_forces_kernel.log``.
load_forces_kernel = kernel_loader(_FORCES_SRC, "lag_forces", _bind_forces)


def _lag_forces_cuda(sorted_pos, sorted_keys, strides, cutoff_sq,
                     sorted_pos_lo, *, L, gfn, out_dtype):
    """Launch K3 on the current stream. Returns (n, 3) forces, a view of
    the (3, n) planes the kernel writes."""
    device = sorted_pos.device
    n, dim = sorted_pos.shape
    if gfn not in _KERNEL_GFNS:
        raise ValueError(
            "the CUDA kernel implements lj_force_factor and "
            "lj_force_factor_fast only; run other force factors through "
            "pair_lag_forces_plain or on CPU tensors"
        )
    if out_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K3 writes float32 or float64 forces, not {out_dtype}")
    if n >= 2**31:
        raise ValueError(f"K3 takes n < 2^31; got {n}")
    # the kernel reads (3, n) planes: rows of any layout are copied once
    planes = sorted_pos.t().contiguous()
    _check_cuda("sorted_pos.t()", planes, torch.float32, (dim, n), device, "K3")
    lo_planes = None
    if sorted_pos_lo is not None:
        lo_planes = sorted_pos_lo.t().contiguous()
        _check_cuda("sorted_pos_lo.t()", lo_planes, torch.float32, (dim, n),
                    device, "K3")
    _check_cuda("sorted_keys", sorted_keys, torch.int32, (n,), device, "K3")
    out = torch.empty((dim, n), dtype=out_dtype, device=device)
    if n == 0:
        return out.t()
    lib = load_forces_kernel()
    w_key = key_window(strides).reshape(1)
    csq = float(torch.as_tensor(cutoff_sq, dtype=torch.float32))
    err = lib.zelll_lag_forces(
        planes.data_ptr(), None if lo_planes is None else lo_planes.data_ptr(),
        sorted_keys.data_ptr(), w_key.data_ptr(), n, L, _pad_spacing(n), csq,
        _KERNEL_GFNS[gfn], int(out_dtype == torch.float64), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    pair_lag_forces.launches += 1
    return out.t()


def pair_lag_forces(sorted_pos, sorted_keys, strides, cutoff_sq,
                    sorted_pos_lo=None, sorted_payload=None, *, M: int = 1024,
                    L: int = 256, gfn: Callable | None = None, mi_box=None,
                    key_reach=None, out_dtype=None, device=None):
    """Per-particle pair forces in sorted-slot order (3-D).

    f_i is the sum over unique cutoff pairs (p, p - lag), lag = 1..L, that
    hold i, of ``gfn(dsq) * (p_p - p_(p-lag))`` with the opposite
    contribution on the smaller slot, over pairs in the key window
    ``key_j >= key_i - W`` with ``0 < dsq < cutoff_sq`` (coincident
    particles are excluded). The lag set is exactly 1..L, so the output is
    defined where `lag_coverage_ok` is False. ``M`` (the TPU kernel's
    block rows) is accepted and has no effect. ``gfn`` defaults to
    `ops.lj.lj_force_factor`.

    ``sorted_pos_lo`` (f32 low parts, see `split_f64`) selects
    split-precision separations. ``out_dtype`` defaults to the positions'
    dtype; with f32 positions ``out_dtype=torch.float64`` returns the f64
    sums of the f32 terms. Returns (n, 3) forces aligned with
    ``sorted_pos``.

    CUDA tensors run kernel K3, which takes f32 coordinates and the force
    factors `lj_force_factor` and `lj_force_factor_fast`, and raises on
    anything else (``sorted_payload`` included). CPU tensors run
    `pair_lag_forces_plain`, which also takes ``sorted_payload`` and any
    ``gfn``. ``mi_box``/``key_reach`` (minimum image) are not ported yet
    and raise on either device.
    """
    del M
    if gfn is None:
        gfn = lj_force_factor
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    if mi_box is not None or key_reach is not None:
        raise ValueError("mi_box / key_reach (minimum-image forces) are not "
                         "ported yet (periodic boxes, ROADMAP queue 1)")
    device = resolve_device(device, sorted_pos)
    sorted_pos = torch.as_tensor(sorted_pos, device=device)
    if sorted_pos.ndim != 2 or sorted_pos.shape[1] != 3:
        raise ValueError("pair_lag_forces is 3-D only; got positions of "
                         f"shape {tuple(sorted_pos.shape)}")
    sorted_keys = torch.as_tensor(sorted_keys, device=device)
    strides = torch.as_tensor(strides, dtype=torch.int32, device=device)
    if sorted_pos_lo is not None:
        sorted_pos_lo = torch.as_tensor(sorted_pos_lo, device=device)
    if device.type == "cuda":
        if sorted_payload is not None:
            raise ValueError("the CUDA kernel takes no sorted_payload; run "
                             "it through pair_lag_forces_plain")
        return _lag_forces_cuda(
            sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, L=L,
            gfn=gfn, out_dtype=out_dtype or sorted_pos.dtype)
    return pair_lag_forces_plain(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
        sorted_payload, L=L, gfn=gfn, out_dtype=out_dtype)


# Kernel launches since the last reset; only a launch of K3 adds to it.
pair_lag_forces.launches = 0
