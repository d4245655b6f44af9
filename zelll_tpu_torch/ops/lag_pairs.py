"""The lag-window pair reduction (kernel K1), pair forces (kernel K3),
per-particle sums (kernel K2), the stress tensor (kernel K4) and the
pair-distance histogram (kernel K5) over key-sorted particles.

PyTorch counterpart of ``zelll_tpu/ops/pallas_pairs.py`` for the reduction
the main path runs (`pair_lag_reduce`), the forces of the thin-box MD loops
(`pair_lag_forces`), the per-particle sums behind
`CellGrid.coordination_numbers` (`pair_lag_per_particle`), the observables
of `ops.virial` and `ops.rdf` (`pair_lag_stress`, `pair_lag_hist`) and their
host helpers.

After sorting by flat cell key, every cutoff partner j < i of particle i
satisfies ``key_j >= key_i - W`` with ``W = sum(strides)``, so all of them
lie within a bounded lag behind i in slot order. A pair is counted once, by
its larger slot: for lag in 1..L, pairs (i, i - lag) masked by the key
window and by ``dsq < cutoff^2``. The pair list never exists.

`pair_lag_reduce` launches the hand-written CUDA kernel
(``csrc/lag_reduce.cu``) for CUDA tensors and runs
`pair_lag_reduce_plain` for CPU tensors; `pair_lag_forces` does the same
with ``csrc/lag_forces.cu`` and `pair_lag_forces_plain`, and
`pair_lag_per_particle` with ``csrc/lag_per_particle.cu`` and
`pair_lag_per_particle_plain`, `pair_lag_stress` with ``csrc/lag_stress.cu``
and `pair_lag_stress_plain`, and `pair_lag_hist` with ``csrc/lag_hist.cu``
and `pair_lag_hist_plain`. There is no fallback between the two: a CUDA
input a kernel cannot take raises.

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
from .lj import lj_force_factor, lj_force_factor_fast, lj_virial_term
from .potentials import KIND_MIXED_LJ, MODE_GFN, TermSpec, species_table

__all__ = [
    "pair_lag_reduce",
    "pair_lag_reduce_plain",
    "pair_lag_forces",
    "pair_lag_forces_plain",
    "pair_lag_per_particle",
    "pair_lag_per_particle_plain",
    "pair_lag_stress",
    "pair_lag_stress_plain",
    "pair_lag_hist",
    "pair_lag_hist_plain",
    "SpeciesPairMask",
    "PbcKeepTerm",
    "PbcSpeciesPairMask",
    "pbc_keep",
    "mi_fold",
    "lag_coverage_ok",
    "suggest_lag",
    "split_f64",
    "split_cutoff_test",
    "lj_term",
    "lj_term_fast",
    "count_term",
    "combine_count",
    "combine_count_vec",
    "load_kernel",
    "load_forces_kernel",
    "load_per_particle_kernel",
    "load_stress_kernel",
    "load_hist_kernel",
]

# Padding-row keys start here: above every real key, below int32 overflow
# even after per-slot spacing.
_PAD_KEY_BASE = int(np.iinfo(np.int32).max) // 2
_INT32_MAX = int(np.iinfo(np.int32).max)

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SRC = _CSRC / "lag_reduce.cu"
_FORCES_SRC = _CSRC / "lag_forces.cu"
_PER_PARTICLE_SRC = _CSRC / "lag_per_particle.cu"
_STRESS_SRC = _CSRC / "lag_stress.cu"
_HIST_SRC = _CSRC / "lag_hist.cu"


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


# The terms the CUDA kernel implements, by the enum value it takes; a
# factory's function of ops.potentials runs as the term table (3) or the
# species term (4).
_KERNEL_TERMS = {lj_term: 0, count_term: 1, lj_virial_term: 2}
_TERM_TABLE = 3
_TERM_SPECIES = 4

# What the card takes besides its own terms, for the kernels' messages.
CARD_TERMS = ("the functions of ops.potentials' factories (the device term "
              "table; lennard_jones_mixed over a species plane)")

# The table arguments of a launch without the table: kind, mode, values,
# species table, species count.
_NO_TABLE = (0, 0, None, None, 0)
_MIX_TABLES: dict = {}


def term_spec(fn) -> TermSpec | None:
    """The device spec an ops.potentials function carries, or None."""
    spec = getattr(fn, "table", None)
    return spec if isinstance(spec, TermSpec) else None


def is_species_term(fn) -> bool:
    spec = term_spec(fn)
    return spec is not None and spec.kind == KIND_MIXED_LJ


def table_args(spec: TermSpec, device) -> tuple:
    """The C interfaces' table arguments for ``spec``: (kind, mode, the
    constants and the shift as 6 f32 in host memory, the device species
    table's address or None, the species count). The f64 constants round to
    f32 as torch rounds a Python scalar for an f32 tensor. A species table
    is copied to ``device`` once per potential and kept."""
    vals = list(spec.params) + [0.0] * (5 - len(spec.params)) + [spec.shift]
    arr = (ctypes.c_float * 6)(*vals)
    if spec.kind != KIND_MIXED_LJ:
        return spec.kind, spec.mode, arr, None, 0
    key = (spec.species, str(device))
    mix = _MIX_TABLES.get(key)
    if mix is None:
        mix = _MIX_TABLES[key] = torch.tensor(species_table(spec), dtype=torch.float32,
                                              device=device)
    return spec.kind, spec.mode, arr, mix.data_ptr(), len(spec.species[0])


def energy_term_arg(kernel: str, term, kernel_terms: dict, table_id: int):
    """An energy kernel's term enum (``table_id`` for the table, + 1 for
    the species term) and its table arguments; raises on a term the card
    does not take."""
    if term in kernel_terms:
        return kernel_terms[term], None
    spec = term_spec(term)
    if spec is None or spec.mode == MODE_GFN:
        names = ", ".join(getattr(t, "__name__", str(t)) for t in kernel_terms)
        raise ValueError(
            f"the CUDA kernel {kernel} takes the terms {names} and {CARD_TERMS}; "
            "run other terms through the plain version or on CPU tensors")
    return table_id + int(spec.kind == KIND_MIXED_LJ), spec


def forces_gfn_arg(kernel: str, gfn, kernel_gfns: dict, table_id: int, species: bool):
    """A forces kernel's force-factor enum (``table_id`` for the table,
    + 1 for the species factor over a payload plane) and its spec; raises on
    a factor the card does not take."""
    spec = term_spec(gfn)
    if species:
        if spec is None or spec.kind != KIND_MIXED_LJ or spec.mode != MODE_GFN:
            raise ValueError(
                f"the CUDA kernel {kernel} takes one payload force factor, "
                "ops.potentials.lennard_jones_mixed's gfn over a species plane; "
                "run other payload force factors through the plain version or "
                "on CPU tensors")
        return table_id + 1, spec
    if gfn in kernel_gfns:
        return kernel_gfns[gfn], None
    if spec is None or spec.mode != MODE_GFN or spec.kind == KIND_MIXED_LJ:
        names = ", ".join(getattr(g, "__name__", str(g)) for g in kernel_gfns)
        raise ValueError(
            f"the CUDA kernel {kernel} takes the force factors {names} and "
            f"{CARD_TERMS}; a species gfn needs its sorted_payload; run other "
            "force factors through the plain version or on CPU tensors")
    return table_id, spec


def observable_table_arg(kernel: str, fn, kernel_fns: dict, table_id: int, *,
                         gfn: bool, dtype):
    """The enum of an observables kernel (K2's term; K4's and K8's force
    factor) and its spec: one of the kernel's own functions, or, with f32
    coordinates, the function of an ops.potentials factory through the
    device term table (``gfn``: a force factor; else an energy or virial
    term). These kernels read no payload, so the species functions of
    lennard_jones_mixed are refused, as is any other callable."""
    if fn in kernel_fns:
        return kernel_fns[fn], None
    spec = term_spec(fn)
    what = "force factors" if gfn else "terms"
    if spec is None or spec.kind == KIND_MIXED_LJ or (spec.mode == MODE_GFN) != gfn:
        names = " and ".join(getattr(f, "__name__", str(f)) for f in kernel_fns)
        table = "gfn" if gfn else "energy and virial terms"
        raise ValueError(
            f"the CUDA kernel {kernel} takes the {what} {names}, and the {table} of every "
            "ops.potentials factory but lennard_jones_mixed (the device term table); "
            f"run other {what} through the plain version or on CPU tensors")
    if dtype != torch.float32:
        raise ValueError(
            f"{kernel} evaluates the term table with float32 coordinates only (split "
            f"ones are float32 planes), not {dtype}; run float64 coordinates with a "
            "table function on CPU tensors")
    return table_id, spec


# Split mode's tie band: |dsq - csq| <= _TIE_BAND * csq holds every pair
# whose f32 dsq can fall on the other side of the cutoff from its f64 dsq
# (the f32 dsq of split separations is within 6 x 2^-24 of it).
_TIE_BAND = 1e-6


def split_cutoff_test(inside, dsq, csq, hi_i, hi_j, lo_i, lo_j, shifts=None):
    """The cutoff test of split coordinates, f64-grade: pairs whose f32
    ``dsq`` lies within the tie band of ``csq`` are decided on the f64
    dsq of their split separations, ((hi_i - hi_j) + (lo_i - lo_j)) per
    axis in f64; the rest keep ``inside`` (``dsq < csq``). ``hi_i`` ..
    ``lo_j`` are per-axis sequences of broadcastable tensors. With
    ``shifts`` (per axis, the minimum image's box shift of `mi_fold`, in
    split mode the f64 sum of its f32 box and the box's low part) the f64
    separation is ((hi_i - hi_j) - shift) + (lo_i - lo_j). The forces
    kernels (K3, K7) apply the same rule in the same order of operations.
    The JAX package decides every pair on the f32 dsq, which flips pairs
    within about 4e-7 of the cutoff (ROADMAP queue 3)."""
    csq32 = torch.as_tensor(csq, dtype=dsq.dtype)
    band = torch.as_tensor(_TIE_BAND, dtype=dsq.dtype) * csq32
    near = (dsq - csq32).abs() <= band
    dsq64 = None
    for a, (hi, hj, li, lj) in enumerate(zip(hi_i, hi_j, lo_i, lo_j)):
        h = hi.double() - hj.double()
        if shifts is not None:
            h = h - shifts[a].double()
        d = h + (li.double() - lj.double())
        dsq64 = d * d if dsq64 is None else dsq64 + d * d
    return torch.where(near, dsq64 < float(csq), inside)


def mi_fold(hi_i, hi_j, lo_i, lo_j, box):
    """One axis' separation folded to the minimum image: s = hi_i - hi_j,
    one box length bx (``box`` in the coordinates' dtype; 0 leaves the
    axis open) subtracted where |s| > bx / 2, as the JAX package's
    ``pallas_pairs._mi_pair_d`` folds it. In split mode (``lo_i``/``lo_j``
    not None) the exact two-diff error e of s is carried into the low term,
    less the box's own low part bxl = ``box`` - bx (nonzero where an f64
    ``box`` rounds in f32) with the shift's sign: d = (s - shift) + ((e +
    (lo_i - lo_j)) - shift_lo), so split separations stay f64-grade across
    the seam; the JAX package drops bxl (ROADMAP queue 3). Returns (d,
    shift), shift in split mode the f64 sum shift + shift_lo (exact), for
    `split_cutoff_test`. K1 and K3 fold in the same order of operations."""
    box64 = torch.as_tensor(box, dtype=torch.float64, device=hi_i.device)
    bx = box64.to(hi_i.dtype)
    s = hi_i - hi_j
    half = 0.5 * bx
    zero = torch.zeros_like(s)
    shift = torch.where(s > half, bx, torch.where(s < -half, -bx, zero))
    d = s - shift
    if lo_i is None:
        return d, shift
    bxl = (box64 - bx.double()).to(hi_i.dtype)
    z = s - hi_i
    e = (hi_i - (s - z)) - (hi_j + z)
    shift_lo = torch.where(s > half, bxl, torch.where(s < -half, -bxl, zero))
    d = d + ((e + (lo_i - lo_j)) - shift_lo)
    return d, shift.double() + shift_lo.double()


def split_f64(x64: torch.Tensor):
    """Split f64 values into (hi, lo) f32 tensors with hi + lo == x64 to
    f32x2 precision."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def lag_coverage_ok(sorted_keys: torch.Tensor, strides, L: int,
                    reach=None) -> torch.Tensor:
    """True iff lag bound L covers every in-window pair:
    ``key[i] - key[i-L] > W`` for every real row i (SENTINEL_KEY rows, which
    sort last and hold no real pairs, are excluded). ``reach``: per-axis
    cell spans of the widened minimum-image window (`key_window`)."""
    w = key_window(strides, reach).to(sorted_keys.device)
    if sorted_keys.shape[0] <= L:
        return torch.ones((), dtype=torch.bool, device=sorted_keys.device)
    later = sorted_keys[L:]
    return ((later - sorted_keys[:-L] > w) | (later == SENTINEL_KEY)).all()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def suggest_lag(sorted_keys_host, strides_host, granule: int = 128,
                reach=None) -> int:
    """Smallest granule multiple L with full coverage (host-side helper).
    SENTINEL_KEY rows are excluded as in `lag_coverage_ok`; ``reach``
    widens the window as there."""
    strides = _host(strides_host)
    w = int(np.sum(strides) if reach is None else np.sum(strides * np.asarray(reach)))
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


def combine_count_vec(packed) -> np.ndarray:
    """Vector sibling of `combine_count`: (2, K) int32 (hi, lo) planes ->
    (K,) int64 counts, exact past 2^31 per bin."""
    v = np.asarray(_host(packed), np.int64)
    return (v[0] << 16) + v[1]


def _pack_count(total: torch.Tensor) -> torch.Tensor:
    """int64 total(s) -> (hi, lo) int32 with total == (hi << 16) + lo: a
    (2,) pair for a scalar, (2, K) planes for (K,) totals."""
    return torch.stack([total >> 16, total & 0xFFFF]).to(torch.int32)


def pair_lag_reduce_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                          sorted_pos_lo=None, sorted_payload=None, *, L: int = 256,
                          term: Callable = lj_term, out_dtype=None, min_islot=0,
                          mi_box=None, key_reach=None):
    """Plain PyTorch version of K1, vectorised over slots, one lag at a time.

    Same masks, separations and terms as the kernel; any ``term`` callable
    works here. With ``sorted_payload`` ((n, P), sorted order) the term
    receives ``(dsq, own_0.., j_0..)``, own being the larger slot; ``min_islot`` keeps the
    pairs whose larger slot is at or above it; ``mi_box``/``key_reach``
    fold the separations to the minimum image (`mi_fold`) in the widened
    key window. Float sums are taken in f64 per lag; integer ones in int64.
    """
    n = sorted_pos.shape[0]
    device, dtype = sorted_pos.device, sorted_pos.dtype
    out_dtype = out_dtype or dtype
    integer = not out_dtype.is_floating_point
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides, key_reach).to(keys.device)
    csq = torch.as_tensor(cutoff_sq, dtype=dtype, device=device)
    pay = _payload_rows(sorted_payload, n, dtype, device)
    mib = _mi_box(mi_box, device)
    total = torch.zeros((), dtype=torch.int64 if integer else torch.float64,
                        device=device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break  # keys ascend: no later lag can be in window
        _, dsq, _ = _lag_separations(sorted_pos, sorted_pos_lo, lag, mib)
        mask = _lag_pair_mask(keymask & (dsq < csq), lag, None, min_islot, None)
        safe = torch.where(mask, dsq, torch.ones_like(dsq))
        if pay is None:
            vals = term(safe)
        else:
            vals = term(safe, *pay[lag:].unbind(1), *pay[:-lag].unbind(1))
        v = torch.where(mask, vals, torch.zeros_like(vals)).to(out_dtype)
        total += v.sum(dtype=total.dtype)
    if integer:
        return _pack_count(total)
    return total.to(out_dtype)


def _bind_reduce(lib) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zelll_lag_reduce.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, cf, ci, ci, ci, ci, cf, cf, cf, cf, cf, cf,
        vp, vp, ci, ci, vp, vp, ci, ci,
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


def _kernel_mi_box(mi_box, dim: int):
    """(flag, three f32 box lengths, their three f32 low parts) of the
    kernels' minimum image: the host values of ``mi_box`` (one read from
    the device if it lives there) rounded to f32, and what that rounding
    drops (split mode's fold takes it off, `mi_fold`); absent axes 0."""
    if mi_box is None:
        return 0, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0)
    box64 = torch.as_tensor(mi_box, dtype=torch.float64).reshape(-1).cpu()
    if box64.shape[0] != dim:
        raise ValueError(f"mi_box takes one length per axis ({dim}); got {box64.shape[0]}")
    hi = box64.to(torch.float32)
    lo = (box64 - hi.double()).to(torch.float32)
    pad = [0.0] * (3 - dim)
    return 1, tuple(hi.tolist() + pad), tuple(lo.tolist() + pad)


def _one_plane(kernel: str, what: str, sorted_payload, n: int, dtype, device):
    """A kernel's (n,) payload plane, from one payload column, in ``dtype``."""
    plane = torch.as_tensor(sorted_payload, device=device)
    if plane.ndim == 2 and plane.shape[1] == 1:
        plane = plane[:, 0]
    if tuple(plane.shape) != (n,):
        raise ValueError(f"{kernel}'s {what} reads one payload plane of {n} "
                         f"values; got shape {tuple(plane.shape)}")
    return plane.to(dtype).contiguous()


def _keep_plane(kernel: str, term, sorted_payload, n: int, device):
    """What an energy kernel takes for a payload rule: (mask id, the term
    it evaluates, the (n,) f32 plane or None). The payload rules on the
    card are the periodic keep mask (`PbcKeepTerm` over the shift-sign
    plane) and the species term of `ops.potentials.lennard_jones_mixed`
    over a species plane; any other payload term raises."""
    keep, species = isinstance(term, PbcKeepTerm), is_species_term(term)
    if sorted_payload is None and not keep and not species:
        return _MASK_NONE, term, None
    if sorted_payload is None or not (keep or species) or \
            (keep and is_species_term(term.term)):
        raise ValueError(
            f"the CUDA kernel {kernel} takes two payload rules, the periodic "
            "keep mask (PbcKeepTerm over ops.pbc's shift-sign plane) and the "
            "species plane of ops.potentials.lennard_jones_mixed's term, one at "
            "a time; run other payload terms through the plain version or on "
            "CPU tensors")
    plane = _one_plane(kernel, "payload rule", sorted_payload, n, torch.float32, device)
    return (_MASK_NONE, term, plane) if species else (_MASK_PBC_KEEP, term.term, plane)


def _lag_reduce_cuda(sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
                     sorted_payload, *, L, term, out_dtype, mi_box, key_reach,
                     min_islot=0):
    """Launch K1 on the current stream and sum its per-block partials."""
    device = sorted_pos.device
    n, dim = sorted_pos.shape
    mask, term, plane = _keep_plane("K1", term, sorted_payload, n, device)
    targ, spec = energy_term_arg("K1", term, _KERNEL_TERMS, _TERM_TABLE)
    islot = islot_arg(
        "K1", min_islot, why="on open f32 coordinates (no sorted_pos_lo, mi_box or keep "
        "mask) with lj_term, a factory's term or the species term, into float sums",
        supported=(sorted_pos_lo is None and mi_box is None and mask == _MASK_NONE
                  and targ in (_KERNEL_TERMS[lj_term], _TERM_TABLE, _TERM_SPECIES)
                  and out_dtype != torch.int32))
    if out_dtype not in (torch.float32, torch.float64, torch.int32):
        raise ValueError(f"K1 writes float32, float64 or int32 sums, not {out_dtype}")
    if spec is not None and out_dtype == torch.int32:
        raise ValueError("K1 sums a table term in float32 or float64, not int32")
    if targ == _TERM_SPECIES and (sorted_pos_lo is not None or mi_box is not None):
        raise ValueError("K1's species term runs on open f32 coordinates (no "
                         "sorted_pos_lo, no mi_box); run it through "
                         "pair_lag_reduce_plain")
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
    mi, box, box_lo = _kernel_mi_box(mi_box, dim)
    lib = load_kernel()
    w_key = key_window(strides, key_reach).reshape(1)
    block = lib.zelll_lag_reduce_block()
    partial = torch.empty((-(-n // block),), dtype=acc, device=device)
    csq = float(torch.as_tensor(cutoff_sq, dtype=torch.float32))
    err = lib.zelll_lag_reduce(
        sorted_pos.data_ptr(),
        None if sorted_pos_lo is None else sorted_pos_lo.data_ptr(),
        None if plane is None else plane.data_ptr(),
        sorted_keys.data_ptr(), w_key.data_ptr(), n, dim, L, _pad_spacing(n), csq,
        targ, int(integer), mask, mi, *box, *box_lo, partial.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
        *(_NO_TABLE if spec is None else table_args(spec, device)), islot,
    )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    pair_lag_reduce.launches += 1
    if islot:
        pair_lag_reduce.islot_launches += 1
    total = partial.sum()
    return _pack_count(total) if integer else total.to(out_dtype)


def pair_lag_reduce(sorted_pos, sorted_keys, strides, cutoff_sq,
                    sorted_pos_lo=None, sorted_payload=None, *, M: int = 1024,
                    L: int = 256, term: Callable = lj_term, out_dtype=None,
                    min_islot=0, mi_box=None, key_reach=None, device=None):
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

    ``sorted_payload`` ((n, P), sorted order) parameterises the term,
    which then receives ``(dsq, own_0.., j_0..)``, own being the larger
    slot. ``min_islot``
    keeps only the pairs whose larger slot is at or above it (the
    distributed ownership rule). ``mi_box`` ((dim,) box lengths, 0 for an
    open axis) folds each separation to its minimum image in-kernel
    (`mi_fold`); pass ``key_reach`` (per-axis cell spans, `key_window`) so
    the key window admits wrap-adjacent cells.

    CUDA tensors run kernel K1, which takes f32 coordinates, the terms
    `lj_term`, `count_term` and `ops.virial.lj_virial_term`, the energy
    and virial of every `ops.potentials` factory (the device term table,
    float sums), the minimum image, and two payload rules: the periodic
    keep mask (a `PbcKeepTerm` of one of those terms over one payload
    plane) and the species plane of `ops.potentials.lennard_jones_mixed`'s
    term (open, f32). It raises on anything else: other callables and
    payload terms. ``min_islot != 0`` runs K1's ownership instances, on
    open f32 coordinates with `lj_term`, a factory's term or the species
    term, into float sums; with anything else it raises. CPU tensors run
    `pair_lag_reduce_plain`, which takes them all.
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
            sorted_payload, L=L, term=term, out_dtype=out_dtype or sorted_pos.dtype,
            mi_box=mi_box, key_reach=key_reach, min_islot=min_islot)
    return pair_lag_reduce_plain(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, sorted_payload,
        L=L, term=term, out_dtype=out_dtype, min_islot=min_islot, mi_box=mi_box,
        key_reach=key_reach)


# Kernel launches since the last reset; only a launch of K1 adds to it, and
# to islot_launches only a launch of its min_islot instances.
pair_lag_reduce.launches = 0
pair_lag_reduce.islot_launches = 0


# The force factors the K3 kernel implements, by the enum value it takes;
# a factory's gfn of ops.potentials runs as the table (2) or, over a species
# plane, the species factor (3).
_KERNEL_GFNS = {lj_force_factor: 0, lj_force_factor_fast: 1}
_GFN_TABLE = 2


def _forces_table_args(spec, plane, device) -> tuple:
    """K3's trailing arguments: the table's kind, mode and values, the
    species plane, the species table and the species count."""
    kind, mode, vals, mix, ns = _NO_TABLE if spec is None else table_args(spec, device)
    return kind, mode, vals, None if plane is None else plane.data_ptr(), mix, ns


def pair_lag_forces_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                          sorted_pos_lo=None, sorted_payload=None, *,
                          L: int = 256, gfn: Callable = lj_force_factor,
                          mi_box=None, key_reach=None, out_dtype=None):
    """Plain PyTorch version of K3, vectorised over slots, one lag at a time.

    Same masks, separations and force factor as the kernel: for each lag,
    the pairs (i, i - lag) in the key window with ``0 < dsq < cutoff^2``
    add ``g d`` to i and ``-g d`` to i - lag. Any ``gfn`` works here; with
    ``sorted_payload`` ((n, P), sorted order) it receives
    ``(dsq, own_0.., j_0..)``, own being the larger slot. ``mi_box`` and
    ``key_reach`` fold d to the minimum image (`mi_fold`) in the widened
    key window; split mode's tie decision then takes the f64 separation
    less the same shift. The f32 (or f64) products are summed in f64 and
    the result is cast to ``out_dtype`` (default: the positions' dtype).
    """
    n, dim = sorted_pos.shape
    device, dtype = sorted_pos.device, sorted_pos.dtype
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides, key_reach).to(device)
    csq = torch.as_tensor(cutoff_sq, dtype=dtype, device=device)
    pay = None if sorted_payload is None else \
        torch.as_tensor(sorted_payload, device=device).to(dtype)
    mib = _mi_box(mi_box, device)
    forces = torch.zeros((n, dim), dtype=torch.float64, device=device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break  # keys ascend: no later lag can be in window
        d, dsq, shifts = _lag_separations(sorted_pos, sorted_pos_lo, lag, mib)
        inside = dsq < csq
        if sorted_pos_lo is not None:
            inside = split_cutoff_test(
                inside, dsq, csq, sorted_pos[lag:].unbind(1),
                sorted_pos[:-lag].unbind(1), sorted_pos_lo[lag:].unbind(1),
                sorted_pos_lo[:-lag].unbind(1),
                None if shifts is None else shifts.unbind(1))
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
    cf = ctypes.c_float
    lib.zelll_lag_forces.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, cf, ci, ci, ci, cf, cf, cf, cf, cf, cf, vp, vp,
        ci, ci, vp, vp, vp, ci,
    ]
    lib.zelll_lag_forces.restype = ci


# Build (at first use) and load the K3 library; its build log is
# ``load_forces_kernel.log``.
load_forces_kernel = kernel_loader(_FORCES_SRC, "lag_forces", _bind_forces)


def _lag_forces_cuda(sorted_pos, sorted_keys, strides, cutoff_sq,
                     sorted_pos_lo, sorted_payload, *, L, gfn, out_dtype, mi_box,
                     key_reach):
    """Launch K3 on the current stream. Returns (n, 3) forces, a view of
    the (3, n) planes the kernel writes."""
    device = sorted_pos.device
    n, dim = sorted_pos.shape
    species = sorted_payload is not None
    garg, spec = forces_gfn_arg("K3", gfn, _KERNEL_GFNS, _GFN_TABLE, species)
    plane = None
    if species:
        plane = torch.as_tensor(sorted_payload, device=device)
        if plane.ndim == 2 and plane.shape[1] == 1:
            plane = plane[:, 0]
        if tuple(plane.shape) != (n,):
            raise ValueError(f"K3's species factor reads one payload plane of {n} "
                             f"values; got shape {tuple(plane.shape)}")
        plane = plane.to(torch.float32).contiguous()
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
    mi, box, box_lo = _kernel_mi_box(mi_box, dim)
    lib = load_forces_kernel()
    w_key = key_window(strides, key_reach).reshape(1)
    csq = float(torch.as_tensor(cutoff_sq, dtype=torch.float32))
    err = lib.zelll_lag_forces(
        planes.data_ptr(), None if lo_planes is None else lo_planes.data_ptr(),
        sorted_keys.data_ptr(), w_key.data_ptr(), n, L, _pad_spacing(n), csq,
        garg, int(out_dtype == torch.float64), mi, *box, *box_lo,
        out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
        *_forces_table_args(spec, plane, device),
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
    sums of the f32 terms. ``mi_box`` ((3,) box lengths, 0 for an open
    axis) and ``key_reach`` fold each separation to its minimum image in
    the widened key window (`mi_fold`): Newton's +/- g d on the folded
    separation is the minimum-image force. Returns (n, 3) forces aligned
    with ``sorted_pos``.

    CUDA tensors run kernel K3, which takes f32 coordinates, the force
    factors `lj_force_factor` and `lj_force_factor_fast`, the force factor
    of every `ops.potentials` factory (the device term table), the species
    factor of `ops.potentials.lennard_jones_mixed` over a one-plane
    ``sorted_payload``, and the minimum image, and raises on anything else
    (other callables and payload factors). CPU tensors run
    `pair_lag_forces_plain`, which takes any ``gfn`` and payload.
    """
    del M
    if gfn is None:
        gfn = lj_force_factor
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
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
        return _lag_forces_cuda(
            sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, sorted_payload,
            L=L, gfn=gfn, out_dtype=out_dtype or sorted_pos.dtype, mi_box=mi_box,
            key_reach=key_reach)
    return pair_lag_forces_plain(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
        sorted_payload, L=L, gfn=gfn, mi_box=mi_box, key_reach=key_reach,
        out_dtype=out_dtype)


# Kernel launches since the last reset; only a launch of K3 adds to it.
pair_lag_forces.launches = 0


def pair_lag_per_particle_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                                *, L: int = 256, term: Callable = count_term):
    """Plain PyTorch version of K2, vectorised over slots, one lag at a time.

    Same pair set and terms as the kernel: for each lag, the pairs
    (i, i - lag) in the key window with ``0 < dsq < cutoff^2`` add
    ``term(dsq)`` to both ends. Any ``term`` works here. The terms are
    summed in f64 and the result is cast to the positions' dtype.
    """
    n, dim = sorted_pos.shape
    device, dtype = sorted_pos.device, sorted_pos.dtype
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides).to(device)
    csq = torch.as_tensor(cutoff_sq, dtype=dtype, device=device)
    out = torch.zeros((n,), dtype=torch.float64, device=device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break  # keys ascend: no later lag can be in window
        d = sorted_pos[lag:, 0] - sorted_pos[:-lag, 0]
        dsq = d * d
        for a in range(1, dim):
            d = sorted_pos[lag:, a] - sorted_pos[:-lag, a]
            dsq = dsq + d * d
        mask = keymask & (dsq < csq) & (dsq > 0)
        vals = term(torch.where(mask, dsq, torch.ones_like(dsq)))
        c = torch.where(mask, vals, torch.zeros_like(vals)).to(torch.float64)
        out[lag:] += c
        out[:-lag] += c
    return out.to(dtype)


def _bind_per_particle(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zelll_lag_per_particle.argtypes = [
        vp, vp, vp, ci, ci, ci, ctypes.c_double, ci, ci, vp, vp, ci, ci, vp,
    ]
    lib.zelll_lag_per_particle.restype = ci


# Build (at first use) and load the K2 library; its build log is
# ``load_per_particle_kernel.log``.
load_per_particle_kernel = kernel_loader(_PER_PARTICLE_SRC, "lag_per_particle",
                                         _bind_per_particle)


# The terms K2 implements, by the enum value it takes; a factory's energy or
# virial runs as the term table (_TERM_TABLE).
_PER_PARTICLE_TERMS = {lj_term: 0, count_term: 1}


def _lag_per_particle_cuda(sorted_pos, sorted_keys, strides, cutoff_sq, *, L,
                           term):
    """Launch K2 on the current stream. Returns (n,) sums in the positions'
    dtype."""
    device = sorted_pos.device
    n, dim = sorted_pos.shape
    dtype = sorted_pos.dtype
    targ, spec = observable_table_arg("K2", term, _PER_PARTICLE_TERMS, _TERM_TABLE,
                                      gfn=False, dtype=dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K2 takes float32 or float64 coordinates, not {dtype}")
    if n >= 2**31:
        raise ValueError(f"K2 takes n < 2^31; got {n}")
    # the kernel reads (3, n) planes: rows of any layout are copied once
    planes = sorted_pos.t().contiguous()
    _check_cuda("sorted_pos.t()", planes, dtype, (dim, n), device, "K2")
    _check_cuda("sorted_keys", sorted_keys, torch.int32, (n,), device, "K2")
    out = torch.empty((n,), dtype=dtype, device=device)
    if n == 0:
        return out
    lib = load_per_particle_kernel()
    w_key = key_window(strides).reshape(1)
    # cutoff^2 rounded to the coordinates' dtype, as the plain version does
    csq = float(torch.as_tensor(cutoff_sq, dtype=dtype))
    err = lib.zelll_lag_per_particle(
        planes.data_ptr(), sorted_keys.data_ptr(), w_key.data_ptr(), n, L,
        _pad_spacing(n), csq, targ, int(dtype == torch.float64),
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        *(_NO_TABLE if spec is None else table_args(spec, device))[:3],
    )
    if err != 0:
        raise RuntimeError(f"K2 launch failed: CUDA error {err}")
    pair_lag_per_particle.launches += 1
    return out


def pair_lag_per_particle(sorted_pos, sorted_keys, strides, cutoff_sq, *,
                          M: int = 1024, L: int = 256,
                          term: Callable = count_term, device=None):
    """Per-particle sums over cutoff partners, in sorted-slot order (3-D):
    ``out_i = sum term(dsq)`` over the partners j = i -/+ lag, lag = 1..L,
    of the unique pairs in the key window ``key_j >= key_i - W`` (j the
    smaller slot) with ``0 < dsq < cutoff_sq``. Both ends of a pair
    receive its term; coincident particles are excluded. The default term
    gives coordination numbers; `lj_term` halved gives per-particle
    energies. The lag set is exactly 1..L, so the output is defined where
    `lag_coverage_ok` is False. ``M`` (the TPU kernel's block rows) is
    accepted and has no effect. Returns (n,) in the positions' dtype.

    CUDA tensors run kernel K2, which takes f32 or f64 coordinates with the
    terms `lj_term` and `count_term`, and f32 coordinates with the energy or
    virial term of every `ops.potentials` factory but
    `lennard_jones_mixed` (the device term table: `shifted` terms and
    `ops.virial.virial_term_from_gfn` of a factory's gfn among them); it
    raises on anything else (other callables, the species term, a table
    term with f64 coordinates). CPU tensors run
    `pair_lag_per_particle_plain`, which takes any term.
    """
    del M
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    device = resolve_device(device, sorted_pos)
    sorted_pos = torch.as_tensor(sorted_pos, device=device)
    if sorted_pos.ndim != 2 or sorted_pos.shape[1] != 3:
        raise ValueError("pair_lag_per_particle is 3-D only; got positions of "
                         f"shape {tuple(sorted_pos.shape)}")
    sorted_keys = torch.as_tensor(sorted_keys, device=device)
    strides = torch.as_tensor(strides, dtype=torch.int32, device=device)
    if device.type == "cuda":
        return _lag_per_particle_cuda(sorted_pos, sorted_keys, strides,
                                      cutoff_sq, L=L, term=term)
    return pair_lag_per_particle_plain(sorted_pos, sorted_keys, strides,
                                       cutoff_sq, L=L, term=term)


# Kernel launches since the last reset; only a launch of K2 adds to it.
pair_lag_per_particle.launches = 0


# -- observables: the stress tensor (K4) and the histogram (K5) --------------

# The six components the stress kernels write, (a, b) with a <= b over three
# axes, and their positions in a symmetric 3 x 3 tensor.
_COMP_INDEX = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


def symmetric_stress(comps: torch.Tensor, dim: int) -> torch.Tensor:
    """(6,) kernel components (xx, xy, xz, yy, yz, zz) -> the symmetric
    (dim, dim) tensor of the first ``dim`` axes (no host sync)."""
    rows = [comps[_COMP_INDEX[a][b]] for a in range(dim) for b in range(dim)]
    return torch.stack(rows).reshape(dim, dim)


class SpeciesPairMask:
    """Pair mask over one payload plane of species values: keeps exactly the
    unordered species pairs {a, b} (the JAX package's
    ``rdf._species_mask``). The histogram kernels K5 and K9 take it as a
    mask id and (a, b); any other mask callable runs on CPU tensors only."""

    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, wi, wj):
        return ((wi == self.a) & (wj == self.b)) | ((wi == self.b) & (wj == self.a))

    def __repr__(self):
        return f"SpeciesPairMask({self.a!r}, {self.b!r})"


# Pair-mask ids the kernels share: none, the species pair mask (the
# histograms K5 and K9), the periodic keep mask (K1, K4, K5, K6, K8, K9) and
# both over two planes (K5).
_MASK_NONE = 0
_MASK_SPECIES = 1
_MASK_PBC_KEEP = 2
_MASK_PBC_KEEP_SPECIES = 3


def pbc_keep(wi, wj):
    """The periodic keep mask over the shift-sign plane of `ops.pbc`'s
    ghost images (0 for real rows, the lexicographic shift sign +/-1 for
    ghosts): ``(w_i w_j == 0) & (w_i + w_j >= 0)`` keeps real-real pairs,
    each cross-boundary pair once (with its positive-shift ghost) and no
    ghost-ghost pair."""
    return (wi * wj == 0) & (wi + wj >= 0)


class PbcSpeciesPairMask:
    """`pbc_keep` over a shift-sign plane composed with the species pair
    mask {a, b} over a species plane: the pair mask ``(w_i, s_i, w_j,
    s_j)`` of a two-column payload (the JAX package's
    ``rdf._pbc_species_mask``). K5 takes it as mask id 3 over both
    planes; any other two-plane mask runs on CPU tensors only."""

    __slots__ = ("species",)

    def __init__(self, a, b):
        self.species = SpeciesPairMask(a, b)

    def __call__(self, wi, si, wj, sj):
        return pbc_keep(wi, wj) & self.species(si, sj)

    def __repr__(self):
        return f"PbcSpeciesPairMask({self.species.a!r}, {self.species.b!r})"


class PbcKeepTerm:
    """``term`` masked by `pbc_keep`: a payload term ``(dsq, w_i, w_j)``
    (the JAX package's ``pbc._pbc_term``). The energy kernels K1 and K6
    take it as mask id 2 over one payload plane when ``term`` is one of
    their own terms; any other payload term runs on CPU tensors only."""

    __slots__ = ("term",)

    def __init__(self, term: Callable):
        self.term = term

    def __call__(self, dsq, wi, wj):
        v = self.term(dsq)
        return torch.where(pbc_keep(wi, wj), v, torch.zeros_like(v))

    def __repr__(self):
        return f"PbcKeepTerm({getattr(self.term, '__name__', self.term)!r})"


def _is_default_islot(min_islot) -> bool:
    return isinstance(min_islot, int) and min_islot == 0


def islot_arg(kernel: str, min_islot, *, supported: bool, why: str = "") -> int:
    """The ownership rule's first owned slot as the kernels take it: a host
    int (one read from the device for a tensor). A kernel runs its
    ``min_islot`` instances (the distributed ownership rule of
    ``parallel``) where ``supported``, the inputs ``why`` names, and
    raises on anything else."""
    value = int(min_islot)
    if not -2**31 <= value < 2**31:
        raise ValueError(f"{kernel} takes min_islot as an int32; got {value}")
    if value != 0 and not supported:
        raise ValueError(
            f"the CUDA kernel {kernel} runs min_islot != 0 (the distributed "
            f"ownership rule) {why}; run other inputs through its plain "
            "version or on CPU tensors")
    return value


def _payload_rows(sorted_payload, n: int, dtype, device):
    """The payload as (n, P) rows in the coordinates' dtype, or None."""
    if sorted_payload is None:
        return None
    return torch.as_tensor(sorted_payload, device=device).to(dtype).reshape(n, -1)


def _lag_pair_mask(mask, lag: int, pay, min_islot, pair_mask):
    """``mask`` of the lag's pairs (i, i - lag), i >= lag, narrowed by the
    ownership rule (slot i >= min_islot) and the payload pair mask."""
    if not _is_default_islot(min_islot):
        own = torch.arange(lag, lag + mask.shape[0], device=mask.device)
        mask = mask & (own >= torch.as_tensor(min_islot, device=mask.device))
    if pair_mask is not None:
        mask = mask & pair_mask(*pay[lag:].unbind(1), *pay[:-lag].unbind(1))
    return mask


def _mi_box(mi_box, device):
    """``mi_box`` as a (dim,) f64 tensor, or None: `mi_fold` rounds it to
    the coordinates' dtype and, in split mode, keeps what that drops."""
    if mi_box is None:
        return None
    return torch.as_tensor(mi_box, device=device).to(torch.float64).reshape(-1)


def _lag_separations(sorted_pos, sorted_pos_lo, lag: int, mi_box=None):
    """(d, dsq, shifts) of the lag's pairs: d = p_i - p_(i-lag) per axis
    (split: (hi_i - hi_j) + (lo_i - lo_j)), dsq summed axis by axis. With
    ``mi_box`` ((dim,) f64 tensor) each axis is folded by `mi_fold` and
    ``shifts`` holds its box shifts; otherwise ``shifts`` is None."""
    shifts = None
    if mi_box is None:
        d = sorted_pos[lag:] - sorted_pos[:-lag]
        if sorted_pos_lo is not None:
            d = d + (sorted_pos_lo[lag:] - sorted_pos_lo[:-lag])
    else:
        split = sorted_pos_lo is not None
        cols = [mi_fold(sorted_pos[lag:, a], sorted_pos[:-lag, a],
                        sorted_pos_lo[lag:, a] if split else None,
                        sorted_pos_lo[:-lag, a] if split else None, mi_box[a])
                for a in range(sorted_pos.shape[1])]
        d = torch.stack([c[0] for c in cols], 1)
        shifts = torch.stack([c[1] for c in cols], 1)
    dsq = d[:, 0] * d[:, 0]
    for a in range(1, d.shape[1]):
        dsq = dsq + d[:, a] * d[:, a]
    return d, dsq, shifts


def pair_lag_stress_plain(sorted_pos, sorted_keys, strides, cutoff_sq,
                          sorted_pos_lo=None, sorted_payload=None, *,
                          L: int = 256, gfn: Callable = lj_force_factor,
                          min_islot=0, pair_mask=None, pair_weight=None,
                          mi_box=None, key_reach=None, out_dtype=None):
    """Plain PyTorch version of K4, vectorised over slots, one lag at a time.

    Same pairs, separations and products as the kernel: for each lag, the
    pairs (i, i - lag) in the key window with ``0 < dsq < cutoff^2`` add
    ``(g d_a) d_b`` to sigma_ab, g = gfn(dsq) in the coordinates' dtype.
    Any ``gfn`` works here, and so do the payload rules of the JAX kernel:
    ``pair_mask`` and the multiplicative ``pair_weight`` receive
    ``(own_0.., j_0..)`` of ``sorted_payload`` ((n, P), own being the larger
    slot), and ``min_islot`` keeps pairs whose larger slot is at or above
    it. ``mi_box``/``key_reach`` fold the separations to the minimum image
    (`mi_fold`) in the widened key window, as `pair_lag_reduce_plain` does.
    The products are summed in f64 and the (dim, dim) result is cast to
    ``out_dtype`` (default: the positions' dtype).
    """
    n, dim = sorted_pos.shape
    device, dtype = sorted_pos.device, sorted_pos.dtype
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides, key_reach).to(device)
    csq = torch.as_tensor(cutoff_sq, dtype=dtype, device=device)
    pay = _payload_rows(sorted_payload, n, dtype, device)
    mib = _mi_box(mi_box, device)
    sig = torch.zeros((dim, dim), dtype=torch.float64, device=device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break  # keys ascend: no later lag can be in window
        d, dsq, _ = _lag_separations(sorted_pos, sorted_pos_lo, lag, mib)
        mask = _lag_pair_mask(keymask & (dsq < csq) & (dsq > 0), lag, pay,
                              min_islot, pair_mask)
        gv = gfn(torch.where(mask, dsq, torch.ones_like(dsq)))
        g = torch.where(mask, gv, torch.zeros_like(gv)).to(dtype)
        if pair_weight is not None:
            g = g * pair_weight(*pay[lag:].unbind(1), *pay[:-lag].unbind(1)).to(dtype)
        for a in range(dim):
            gd = g * d[:, a]
            for b in range(a, dim):
                sig[a, b] += (gd * d[:, b]).sum(dtype=torch.float64)
    sig = torch.triu(sig) + torch.triu(sig, 1).t()
    return sig.to(out_dtype or dtype)


def _bind_stress(lib) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zelll_lag_stress.argtypes = [
        vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_double, ci, ci, vp, vp,
        vp, ci, cf, cf, cf, cf, cf, cf, ci, ci, vp,
    ]
    lib.zelll_lag_stress.restype = ci
    lib.zelll_lag_stress_block.argtypes = []
    lib.zelll_lag_stress_block.restype = ci


# Build (at first use) and load the K4 library; its build log is
# ``load_stress_kernel.log``.
load_stress_kernel = kernel_loader(_STRESS_SRC, "lag_stress", _bind_stress)


def _check_coords(kernel: str, sorted_pos, sorted_pos_lo):
    """The coordinate types the observables kernels take: f32 (optionally
    with f32 low parts) or f64, 1 <= dim <= 3, n < 2^31."""
    n, dim = sorted_pos.shape
    dtype = sorted_pos.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{kernel} takes float32 or float64 coordinates, not {dtype}")
    if sorted_pos_lo is not None and dtype != torch.float32:
        raise ValueError(f"{kernel} takes low parts with float32 coordinates only")
    if not 1 <= dim <= 3 or n >= 2**31:
        raise ValueError(f"{kernel} takes 1 <= dim <= 3 and n < 2^31; got {(n, dim)}")


def stress_mask_plane(kernel: str, pair_mask, sorted_payload, n: int, dtype, device):
    """What a stress kernel (K4, K8) takes for ``pair_mask``: the (n,)
    shift-sign plane of the periodic keep mask in the coordinates' dtype,
    or None without a mask. Raises on any mask but `pbc_keep` over one
    payload column."""
    if pair_mask is None:
        return None
    if pair_mask is not pbc_keep:
        raise ValueError(
            f"the CUDA kernel {kernel} takes no pair mask but pbc_keep (the "
            "periodic keep mask over ops.pbc's shift-sign plane); run other "
            "masks on CPU tensors")
    return _one_plane(kernel, "keep mask", sorted_payload, n, dtype, device)


def _mi_args(kernel: str, mi_box, dim: int, dtype) -> tuple:
    """(flag, box, box low parts) of a stress or histogram kernel's minimum
    image (`_kernel_mi_box`), which it takes with f32 coordinates only."""
    if mi_box is not None and dtype != torch.float32:
        raise ValueError(f"{kernel} folds the minimum image of float32 (or split) "
                         f"coordinates only, not {dtype}")
    mi, box, box_lo = _kernel_mi_box(mi_box, dim)
    return (mi, *box, *box_lo)


def _lag_stress_cuda(sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo,
                     sorted_payload, *, L, gfn, pair_mask, mi_box, key_reach, out_dtype):
    """Launch K4 on the current stream and sum its per-block partials."""
    device = sorted_pos.device
    n, dim = sorted_pos.shape
    dtype = sorted_pos.dtype
    garg, spec = observable_table_arg("K4", gfn, _KERNEL_GFNS, _GFN_TABLE, gfn=True,
                                      dtype=dtype)
    if out_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K4 writes float32 or float64 stress, not {out_dtype}")
    _check_coords("K4", sorted_pos, sorted_pos_lo)
    keep = stress_mask_plane("K4", pair_mask, sorted_payload, n, dtype, device)
    mi = _mi_args("K4", mi_box, dim, dtype)
    _check_cuda("sorted_pos", sorted_pos, dtype, (n, dim), device, "K4")
    if sorted_pos_lo is not None:
        _check_cuda("sorted_pos_lo", sorted_pos_lo, torch.float32, (n, dim), device, "K4")
    _check_cuda("sorted_keys", sorted_keys, torch.int32, (n,), device, "K4")
    if n == 0:
        return torch.zeros((dim, dim), dtype=out_dtype, device=device)
    lib = load_stress_kernel()
    w_key = key_window(strides, key_reach).reshape(1)
    block = lib.zelll_lag_stress_block()
    partial = torch.empty((-(-n // block), 6), dtype=torch.float64, device=device)
    # cutoff^2 rounded to the coordinates' dtype, as the plain version does
    csq = float(torch.as_tensor(cutoff_sq, dtype=dtype))
    err = lib.zelll_lag_stress(
        sorted_pos.data_ptr(),
        None if sorted_pos_lo is None else sorted_pos_lo.data_ptr(),
        sorted_keys.data_ptr(), w_key.data_ptr(), n, dim, L, _pad_spacing(n), csq,
        garg, int(dtype == torch.float64), partial.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
        None if keep is None else keep.data_ptr(), *mi,
        *(_NO_TABLE if spec is None else table_args(spec, device))[:3],
    )
    if err != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    pair_lag_stress.launches += 1
    return symmetric_stress(partial.sum(0), dim).to(out_dtype)


def _observable_args(sorted_pos, sorted_keys, strides, sorted_pos_lo, device):
    device = resolve_device(device, sorted_pos)
    sorted_pos = torch.as_tensor(sorted_pos, device=device)
    sorted_keys = torch.as_tensor(sorted_keys, device=device)
    strides = torch.as_tensor(strides, dtype=torch.int32, device=device)
    if sorted_pos_lo is not None:
        sorted_pos_lo = torch.as_tensor(sorted_pos_lo, device=device)
    return device, sorted_pos, sorted_keys, strides, sorted_pos_lo


def pair_lag_stress(sorted_pos, sorted_keys, strides, cutoff_sq,
                    sorted_pos_lo=None, sorted_payload=None, *,
                    gfn: Callable | None = None, M: int = 1024, L: int = 256,
                    min_islot=0, pair_mask=None, pair_weight=None, mi_box=None,
                    key_reach=None, out_dtype=None, device=None):
    """Configurational stress tensor sigma_ab = sum_pairs gfn(dsq) d_a d_b
    over the unique pairs (i, i - lag), lag = 1..L, in the key window with
    ``0 < dsq < cutoff_sq`` (d = p_i - p_(i-lag); coincident pairs are
    excluded, since gfn(0) = inf). A direct fused pair sum: the pair list
    never exists. Returns a symmetric (dim, dim) tensor whose trace is the
    scalar virial. The lag set is exactly 1..L, so the result is defined
    where `lag_coverage_ok` is False. ``gfn`` defaults to
    `ops.lj.lj_force_factor`; ``M`` is accepted and has no effect.

    ``sorted_pos_lo`` (f32 low parts, see `split_f64`) selects
    split-precision separations; the cutoff is decided on their f32 dsq,
    as in the JAX kernel. ``out_dtype`` defaults to the positions' dtype;
    with f32 positions ``out_dtype=torch.float64`` returns the f64 sums of
    the f32 products. ``mi_box`` ((dim,) box lengths, 0 for an open axis)
    folds each separation to its minimum image (`mi_fold`); pass
    ``key_reach`` (per-axis cell spans, `key_window`) so the key window
    admits wrap-adjacent cells.

    CUDA tensors run kernel K4, which takes f32 (optionally split) or f64
    coordinates, 1 <= dim <= 3, the force factors `lj_force_factor` and
    `lj_force_factor_fast`, with f32 (or split) coordinates the gfn of
    every `ops.potentials` factory but `lennard_jones_mixed` (the device
    term table), the periodic keep mask (``pair_mask`` = `pbc_keep` over
    one payload plane of shift signs) and, with f32 coordinates, the
    minimum image; it raises on anything else (other force factors and
    masks, a table gfn with f64 coordinates, ``pair_weight``,
    ``min_islot != 0``). CPU tensors run `pair_lag_stress_plain`, which
    takes them all.
    """
    del M
    gfn = gfn or lj_force_factor
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    if (sorted_payload is None) != (pair_mask is None and pair_weight is None):
        raise ValueError("pair_mask/pair_weight and sorted_payload go together")
    device, sorted_pos, sorted_keys, strides, sorted_pos_lo = _observable_args(
        sorted_pos, sorted_keys, strides, sorted_pos_lo, device)
    if device.type == "cuda":
        if pair_weight is not None or not _is_default_islot(min_islot):
            raise ValueError("the CUDA kernel takes no pair_weight and only "
                             "min_islot=0 (multi-device, slice 9); run these "
                             "through pair_lag_stress_plain")
        return _lag_stress_cuda(sorted_pos, sorted_keys, strides, cutoff_sq,
                                sorted_pos_lo, sorted_payload, L=L, gfn=gfn,
                                pair_mask=pair_mask, mi_box=mi_box,
                                key_reach=key_reach,
                                out_dtype=out_dtype or sorted_pos.dtype)
    return pair_lag_stress_plain(
        sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo, sorted_payload,
        L=L, gfn=gfn, min_islot=min_islot, pair_mask=pair_mask,
        pair_weight=pair_weight, mi_box=mi_box, key_reach=key_reach,
        out_dtype=out_dtype)


# Kernel launches since the last reset; only a launch of K4 adds to it.
pair_lag_stress.launches = 0


def hist_edges(edges_sq, dtype, device) -> torch.Tensor:
    """(K,) squared edges in the coordinates' dtype on ``device``; raises
    unless K >= 1 and the edges ascend (ties allowed), which the kernels'
    binary search needs (one host read of the edges)."""
    edges = torch.as_tensor(edges_sq).reshape(-1).to(dtype)
    if edges.numel() == 0:
        raise ValueError("a histogram needs at least one edge")
    host = edges.cpu()
    if bool((host[1:] < host[:-1]).any()):
        raise ValueError("histogram edges must ascend")
    return edges.to(device)


def _cumulative_counts(first: torch.Tensor) -> torch.Tensor:
    """Per-pair first-bin counts (K,) int64 -> the (2, K) int32 hi/lo planes
    of the cumulative counts (`combine_count_vec`)."""
    return _pack_count(first.cumsum(0))


def pair_lag_hist_plain(sorted_pos, sorted_keys, strides, edges_sq,
                        sorted_pos_lo=None, sorted_payload=None, *,
                        L: int = 256, min_islot=0, pair_mask=None, mi_box=None,
                        key_reach=None):
    """Plain PyTorch version of K5, vectorised over slots, one lag at a time.

    Same pairs, separations and bins as the kernel: each pair (i, i - lag)
    in the key window with ``dsq < edges_sq[-1]`` (no dsq > 0 test) goes to
    the first bin whose edge is above its dsq, and the prefix sum over the
    bins gives ``count_k = #pairs with dsq < edges_sq[k]``. ``pair_mask``
    receives ``(own_0.., j_0..)`` of ``sorted_payload``; ``min_islot`` keeps
    pairs whose larger slot is at or above it; ``mi_box``/``key_reach`` fold
    the separations to the minimum image (`mi_fold`) in the widened key
    window. Returns (2, K) int32 hi/lo planes (`combine_count_vec`).
    """
    n, dim = sorted_pos.shape
    device, dtype = sorted_pos.device, sorted_pos.dtype
    edges = hist_edges(edges_sq, dtype, device)
    K = edges.shape[0]
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides, key_reach).to(device)
    pay = _payload_rows(sorted_payload, n, dtype, device)
    mib = _mi_box(mi_box, device)
    first = torch.zeros((K + 1,), dtype=torch.int64, device=device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break  # keys ascend: no later lag can be in window
        _, dsq, _ = _lag_separations(sorted_pos, sorted_pos_lo, lag, mib)
        mask = _lag_pair_mask(keymask & (dsq < edges[-1]), lag, pay, min_islot,
                              pair_mask)
        b = torch.where(mask, torch.searchsorted(edges, dsq, right=True), K)
        first.index_add_(0, b, torch.ones_like(b))
    return _cumulative_counts(first[:K])


def _bind_hist(lib) -> None:
    vp, ci, cd, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_float
    lib.zelll_lag_hist.argtypes = [
        vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cd, cd, ci, vp, vp,
        vp, ci, cf, cf, cf, cf, cf, cf, ci,
    ]
    lib.zelll_lag_hist.restype = ci
    lib.zelll_lag_hist_max_bins.argtypes = []
    lib.zelll_lag_hist_max_bins.restype = ci


# Build (at first use) and load the K5 library; its build log is
# ``load_hist_kernel.log``.
load_hist_kernel = kernel_loader(_HIST_SRC, "lag_hist", _bind_hist)


def mask_plane(kernel: str, pair_mask, sorted_payload, n: int, dtype, device,
               two_planes: bool = False):
    """What a histogram kernel takes for ``pair_mask``: (mask id, a, b, the
    (n,) species plane or None, the (n,) keep plane or None), planes in the
    coordinates' dtype. The masks: `SpeciesPairMask` and `pbc_keep` over one
    payload column, and with ``two_planes`` (K5) `PbcSpeciesPairMask` over
    two (the shift signs, then the species). Raises on any other."""
    if pair_mask is None:
        return _MASK_NONE, 0.0, 0.0, None, None
    if isinstance(pair_mask, SpeciesPairMask):
        return (_MASK_SPECIES, float(pair_mask.a), float(pair_mask.b),
                _one_plane(kernel, "species mask", sorted_payload, n, dtype, device), None)
    if pair_mask is pbc_keep:
        return (_MASK_PBC_KEEP, 0.0, 0.0, None,
                _one_plane(kernel, "keep mask", sorted_payload, n, dtype, device))
    if two_planes and isinstance(pair_mask, PbcSpeciesPairMask):
        cols = torch.as_tensor(sorted_payload, device=device)
        if tuple(cols.shape) != (n, 2):
            raise ValueError(f"{kernel}'s species keep mask reads two payload planes "
                             f"of {n} values; got shape {tuple(cols.shape)}")
        cols = cols.to(dtype)
        sp = pair_mask.species
        return (_MASK_PBC_KEEP_SPECIES, float(sp.a), float(sp.b),
                cols[:, 1].contiguous(), cols[:, 0].contiguous())
    raise ValueError(
        f"the CUDA kernel {kernel} takes no pair mask but SpeciesPairMask (ops.rdf's "
        "species pairs), pbc_keep (the periodic keep mask)"
        + (" and PbcSpeciesPairMask (both)" if two_planes else "")
        + "; run other masks on CPU tensors")


def _lag_hist_cuda(sorted_pos, sorted_keys, strides, edges, sorted_pos_lo,
                   sorted_payload, *, L, pair_mask, mi_box=None, key_reach=None,
                   min_islot=0):
    """Launch K5 on the current stream: (2, K) int32 hi/lo planes."""
    device = sorted_pos.device
    n, dim = sorted_pos.shape
    dtype = sorted_pos.dtype
    K = edges.shape[0]
    _check_coords("K5", sorted_pos, sorted_pos_lo)
    islot = islot_arg(
        "K5", min_islot, why="on open coordinates (no sorted_pos_lo, mi_box or pair mask)",
        supported=sorted_pos_lo is None and mi_box is None and pair_mask is None)
    mask, ma, mb, plane, keep = mask_plane("K5", pair_mask, sorted_payload, n, dtype,
                                           device, two_planes=True)
    mi = _mi_args("K5", mi_box, dim, dtype)
    _check_cuda("sorted_pos", sorted_pos, dtype, (n, dim), device, "K5")
    if sorted_pos_lo is not None:
        _check_cuda("sorted_pos_lo", sorted_pos_lo, torch.float32, (n, dim), device, "K5")
    _check_cuda("sorted_keys", sorted_keys, torch.int32, (n,), device, "K5")
    first = torch.zeros((K,), dtype=torch.int64, device=device)
    if n == 0:
        return _cumulative_counts(first)
    lib = load_hist_kernel()
    if K > lib.zelll_lag_hist_max_bins():
        raise ValueError(f"K5 takes at most {lib.zelll_lag_hist_max_bins()} "
                         f"edges; got {K}")
    w_key = key_window(strides, key_reach).reshape(1)
    err = lib.zelll_lag_hist(
        sorted_pos.data_ptr(),
        None if sorted_pos_lo is None else sorted_pos_lo.data_ptr(),
        None if plane is None else plane.data_ptr(), sorted_keys.data_ptr(),
        w_key.data_ptr(), edges.data_ptr(), n, dim, L, _pad_spacing(n), K, mask,
        ma, mb, int(dtype == torch.float64), first.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
        None if keep is None else keep.data_ptr(), *mi, islot,
    )
    if err != 0:
        raise RuntimeError(f"K5 launch failed: CUDA error {err}")
    pair_lag_hist.launches += 1
    if islot:
        pair_lag_hist.islot_launches += 1
    return _cumulative_counts(first)


def pair_lag_hist(sorted_pos, sorted_keys, strides, edges_sq, sorted_pos_lo=None,
                  sorted_payload=None, *, M: int = 1024, L: int = 256,
                  min_islot=0, pair_mask=None, mi_box=None, key_reach=None,
                  device=None):
    """Cumulative pair-distance histogram over the unique pairs (i, i - lag),
    lag = 1..L, in the key window: ``out[k] = #pairs with dsq <
    edges_sq[k]``, the effective cutoff being ``edges_sq[-1]`` (the grid the
    keys were built with must use a cutoff >= its root). There is no
    dsq > 0 test: coincident pairs count in every bin above 0. Edges must
    ascend. Returns (2, K) int32 (hi, lo) planes; `combine_count_vec` gives
    the exact counts, and adjacent differences the shell counts. ``M`` is
    accepted and has no effect.

    ``sorted_pos_lo`` selects split-precision separations (the bins see
    their f32 dsq, as in the JAX kernel). ``pair_mask`` + ``sorted_payload``
    mask candidate pairs (receiving ``(own_0.., j_0..)``); ``min_islot`` is
    the distributed ownership rule. ``mi_box``/``key_reach`` fold the
    separations to the minimum image, as in `pair_lag_stress`.

    CUDA tensors run kernel K5, which takes f32 (optionally split) or f64
    coordinates, 1 <= dim <= 3, at most 2048 edges, no mask, a
    `SpeciesPairMask` or `pbc_keep` over one payload plane or a
    `PbcSpeciesPairMask` over two (shift signs, species) and, with f32
    coordinates, the minimum image; ``min_islot != 0`` runs its ownership
    instances, on open coordinates (f32 or f64) without a mask. It raises
    on anything else. CPU tensors run `pair_lag_hist_plain`.
    """
    del M
    if L < 1:
        raise ValueError(f"L must be >= 1, got {L}")
    if (sorted_payload is None) != (pair_mask is None):
        raise ValueError("pair_mask and sorted_payload go together")
    device, sorted_pos, sorted_keys, strides, sorted_pos_lo = _observable_args(
        sorted_pos, sorted_keys, strides, sorted_pos_lo, device)
    if device.type == "cuda":
        edges = hist_edges(edges_sq, sorted_pos.dtype, device)
        return _lag_hist_cuda(sorted_pos, sorted_keys, strides, edges,
                              sorted_pos_lo, sorted_payload, L=L,
                              pair_mask=pair_mask, mi_box=mi_box, key_reach=key_reach,
                              min_islot=min_islot)
    return pair_lag_hist_plain(sorted_pos, sorted_keys, strides, edges_sq,
                               sorted_pos_lo, sorted_payload, L=L,
                               min_islot=min_islot, pair_mask=pair_mask,
                               mi_box=mi_box, key_reach=key_reach)


# Kernel launches since the last reset; only a launch of K5 adds to it, and
# to islot_launches only a launch of its min_islot instances.
pair_lag_hist.launches = 0
pair_lag_hist.islot_launches = 0
