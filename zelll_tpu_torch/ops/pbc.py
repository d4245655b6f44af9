"""Periodic boundary conditions: ghost images and in-kernel minimum image.

PyTorch counterpart of ``zelll_tpu/ops/pbc.py``. MD production runs need
orthorhombic periodic boxes, and the sorted-order design admits them with
the kernels' payload and minimum-image instances:

* **Ghost images.** Every particle within ``cutoff`` of a box face gets
  image copies shifted by the box vector across that face (up to 7 for a
  corner particle, one per non-empty subset of its adjacent faces). The
  images land within ``cutoff`` outside the box, so the grid grows by one
  cell layer and binning, sorting and the pair kernels run unchanged.
* **Forces need no mask.** The forces kernels write each real row's full
  force from its own copy of every cross-boundary pair; the reactions land
  on ghost rows, which the un-sort drops.
* **Energies and counts are masked to count each pair once.** A payload
  plane ``w`` holds 0 for real rows and the lexicographic sign (+/-1) of
  the image shift for ghosts, and `lag_pairs.pbc_keep` keeps real-real
  pairs, each cross pair once and no ghost-ghost pair. K1 and K6 take it
  as their payload rule (mask id 2).
* **Minimum image.** A narrow periodic axis (a few cells) is folded in the
  kernel instead (`minimage_axes`): K1 and K3 take ``mi_box`` and a key
  window widened by ``key_reach``, and only the other axes get ghosts.

Correctness bound: each axis must satisfy ``box > 2 * cutoff``. The
returned flag goes False otherwise, and when the capacities ``B``, ``G``
or ``BE`` are exceeded; pairs are never dropped silently.

Where the JAX package compacts with multi-operand sorts (a TPU rule), this
compacts with a prefix sum and one scatter per static capacity; ghost
order may therefore differ, the ghost multiset does not. 2-D boxes route
to the per-particle ``xla`` path (`core.pairs`), as in the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..core.binning import bin_and_sort
from ..core.geometry import Aabb, GridInfo
from .lag_pairs import (
    PbcKeepTerm,
    combine_count,
    count_term,
    lag_coverage_ok,
    lj_term,
    pair_lag_forces,
    pair_lag_reduce,
)

__all__ = [
    "wrap_positions",
    "suggest_pbc_capacity",
    "pbc_extend",
    "pbc_pair_sum",
    "pbc_lj_energy",
    "pbc_count_pairs",
    "pbc_lj_forces",
    "md_step_pbc",
    "minimage_axes",
]


def minimage_axes(box, cutoff, max_cells: int = 4) -> np.ndarray:
    """Host-side per-axis choice: in-kernel minimum image or ghost images.

    An axis of at most ``max_cells`` cells (``ceil(box / cutoff)``) is
    folded in the kernel: every cell along it is wrap-adjacent to every
    other, so the key window widens by ``(ncells - 1) * stride`` and no
    ghost row is made. The benchmark's 30 x 30 x long box at cutoff 10
    would be almost all boundary under ghost extension. The largest axis
    is never folded: under auto-ordered strides it carries the major
    stride, whose widened window would approach all pairs. Returns a
    (dim,) bool array (True: fold in the kernel).
    """
    b = np.asarray(box, np.float64).reshape(-1)
    mask = np.ceil(b / float(cutoff)).astype(int) <= max_cells
    mask[int(np.argmax(b))] = False
    return mask


def _resolve_minimage(box, cutoff, minimage, dim: int) -> np.ndarray:
    """(dim,) bool array from a ``minimage`` spec: False, "auto" (3-D only;
    elsewhere no axis) or an explicit per-axis mask."""
    if minimage is False or minimage is None:
        return np.zeros(dim, bool)
    if isinstance(minimage, str) and minimage == "auto":
        if dim != 3:
            return np.zeros(dim, bool)
        return minimage_axes(box, cutoff)
    return np.asarray(minimage, bool).reshape(dim)


def _subsets(dim: int):
    """Non-empty subsets of the axes (2^dim - 1): the faces whose shifts
    make up one image."""
    return tuple(m for m in itertools.product((0, 1), repeat=dim) if any(m))


def wrap_positions(positions, origin, box, *, device=None) -> torch.Tensor:
    """Positions wrapped into [origin, origin + box) per axis. In-box
    coordinates come back bit for bit, so split (hi, lo) parts of wrapped
    data stay exact."""
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    dtype = positions.dtype
    origin = torch.as_tensor(origin, dtype=dtype, device=device)
    box = torch.as_tensor(box, dtype=dtype, device=device)
    inside = (positions >= origin) & (positions < origin + box)
    wrapped = origin + torch.remainder(positions - origin, box)
    # the remainder can be exactly box for tiny negative offsets
    wrapped = torch.where(wrapped >= origin + box, origin, wrapped)
    return torch.where(inside, positions, wrapped)


def suggest_pbc_capacity(n: int, box, cutoff, safety: float = 1.6, axes=None,
                         with_multi: bool = False):
    """Host-side (B, G[, BE]) capacities for `pbc_extend`: B bounds the
    particles within cutoff of a face (uniform density assumed), G the
    ghost images, BE (``with_multi``) the rows near two or more faces,
    whose edge and corner images are made. ``axes`` restricts the
    estimate to the axes that get images."""
    box = np.asarray(box, np.float64)
    c = float(cutoff)
    frac_face = np.minimum(2.0 * c / box, 1.0)
    if axes is not None:
        frac_face = np.where(np.asarray(axes, bool), frac_face, 0.0)
    frac_any = 1.0 - np.prod(1.0 - frac_face)
    exp_images = np.prod(1.0 + frac_face) - 1.0
    n_img = 2 ** len(box) - 1
    B = int(np.ceil(n * min(1.0, frac_any * safety))) + 8
    G = int(np.ceil(n * min(float(n_img), exp_images * safety))) + 8

    def round_up(v):
        return max(128, -(-v // 128) * 128)

    Bc, Gc = min(round_up(B), n), min(round_up(G), n_img * n)
    if not with_multi:
        return Bc, Gc
    # P(near >= 2 faces) = P(>= 1) - P(exactly 1)
    p_eq1 = sum(
        f * np.prod([1.0 - g for j, g in enumerate(frac_face) if j != a])
        for a, f in enumerate(frac_face)
    )
    p_multi = max(float(frac_any - p_eq1), 0.0)
    BE = int(np.ceil(n * min(1.0, p_multi * safety * 1.5))) + 8
    return Bc, Gc, min(round_up(BE), Bc)


def _twosum(a, b):
    """Error-free transform: a + b == s + err exactly (Knuth's two-sum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _compact(mask: torch.Tensor, cap: int, *cols: torch.Tensor):
    """The rows where ``mask`` holds, in order, into ``cap`` static rows,
    with no read back to the host: (valid (cap,), each col (cap, ...)).
    Rows past the capacity are dropped (the caller's flag counts them);
    unfilled rows are zero."""
    pos = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    valid = torch.zeros((cap + 1,), dtype=torch.bool, device=mask.device)
    valid.index_fill_(0, dest, True)
    out = []
    for c in cols:
        buf = torch.zeros((cap + 1, *c.shape[1:]), dtype=c.dtype, device=c.device)
        buf.index_copy_(0, dest, c)
        out.append(buf[:cap])
    return (valid[:cap], *out)


def _spread(k: torch.Tensor, side: int, dim: int, dtype) -> torch.Tensor:
    """Far-apart coordinates for invalid ghost rows number ``k`` (int64) on
    a grid ``side`` rows wide, in this module's own family (base 4e12,
    spacing 2^20, an exact multiple of the f32 ulp there), so no padding
    row can pair with anything. The grid steps are integers until the
    final cast: an f32 row number would round past 2^24 and put two rows
    on one point (the JAX package counts rows in the coordinates' dtype)."""
    gx = 4e12 + (k % side).double() * 2.0**20
    gy = 4e12 + (k // side + 1).double() * 2.0**20
    rest = [torch.full_like(gx, 4e12)] * (dim - 2)
    return torch.stack([gx, gy, *rest], -1).to(dtype)


def pbc_extend(positions, origin, box, cutoff, *, B: int, G: int,
               positions_lo=None, wrap: bool = True, return_parents: bool = False,
               axes=None, BE: int | None = None, device=None):
    """Append ghost images of boundary particles for orthorhombic PBC.

    Returns ``(ext_pos (n+G, dim), ext_lo (n+G, dim) | None, w (n+G,),
    valid (n+G,), ok)``: ``w`` is 0 for real rows and the lexicographic
    shift sign (+/-1, in the positions' dtype) for ghosts, ``valid`` marks
    the real rows and the live ghosts (pass it to `bin_and_sort`), and
    ``ok`` is False when some ``box <= 2 * cutoff``, or more than ``B``
    particles lie within cutoff of a face, more than ``BE`` of them near
    two or more faces, or more than ``G`` images are needed.

    ``positions_lo`` (f32 low parts, `lag_pairs.split_f64`) carries split
    precision: a ghost's low parts take the exact two-sum residual of
    ``hi + shift * box`` and the shift of the box's own low part (the host
    box less its rounding to the positions' dtype), so a ghost's hi + lo
    is its parent's shifted by the host box, not by the rounded one (the
    JAX package shifts by the rounded box only). ``return_parents``
    appends a (G,) int64 tensor of each ghost's parent row (0 for invalid
    rows). ``axes`` restricts the images to the selected axes (the others
    fold in the kernel).
    """
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    n, dim = positions.shape
    if dim not in (2, 3):
        raise ValueError(f"pbc_extend supports dim 2 and 3; got {dim}")
    if B < 1 or G < 1:
        raise ValueError(f"B and G must be >= 1; got {B}, {G}")
    subsets = _subsets(dim)
    n_img = len(subsets)
    B = min(B, n)
    BE = B if BE is None else min(max(BE, 128), B)
    G = min(G, dim * B + (n_img - dim) * BE)
    dtype = positions.dtype
    split = positions_lo is not None
    origin = torch.as_tensor(origin, dtype=dtype, device=device).reshape(dim)
    box64 = torch.as_tensor(box, dtype=torch.float64, device=device).reshape(dim)
    box = box64.to(dtype)
    cutoff = torch.as_tensor(cutoff, dtype=dtype, device=device)

    pos = wrap_positions(positions, origin, box) if wrap else positions
    pos_lo = torch.as_tensor(positions_lo, device=device).to(dtype) if split else None
    box_lo = (box64 - box.to(torch.float64)).to(dtype) if split else None

    # per-axis shift: +1 near the low face (image beyond the high face), -1
    # near the high face; only for in-box coordinates, so a row outside the
    # box is never imaged back into it
    s = ((pos >= origin) & (pos < origin + cutoff)).to(torch.int32) - (
        (pos >= origin + box - cutoff) & (pos < origin + box)).to(torch.int32)
    if axes is not None:
        s = s * torch.tensor([int(bool(a)) for a in axes], dtype=torch.int32,
                             device=device)
    ok = (box > 2 * cutoff).all()
    near = (s != 0).any(1)
    ok = ok & (near.sum() <= B)

    # stage 1: the B boundary rows
    rows = torch.arange(n, device=device)
    bvalid, bpar = _compact(near, B, rows)
    bpos, bs = pos[bpar], s[bpar]
    blo = pos_lo[bpar] if split else None

    # stage 2: images, edge and corner ones only from the BE rows near two
    # or more faces
    lex = torch.tensor([3 ** (dim - 1 - a) for a in range(dim)], dtype=torch.int32,
                       device=device)
    is_multi = bvalid & ((bs != 0).sum(1) >= 2)
    ok = ok & (is_multi.sum() <= BE)
    evalid, eidx = _compact(is_multi, BE, torch.arange(B, device=device))
    epos, es, epar = bpos[eidx], bs[eidx], bpar[eidx]
    elo = blo[eidx] if split else None

    cand = []
    for m in subsets:
        one = sum(m) == 1
        mpos, mlo, ms, mvalid, mpar = ((bpos, blo, bs, bvalid, bpar) if one
                                       else (epos, elo, es, evalid, epar))
        mv = torch.tensor(m, dtype=torch.int32, device=device)
        sv = ms * mv
        v = mvalid & ((ms != 0) | (mv == 0)).all(1)
        img, err = _twosum(mpos, sv.to(dtype) * box)
        t = (sv * lex).sum(1)
        sign = torch.where(t > 0, 1, -1).to(dtype)
        cand.append((img, mlo + (err + sv.to(dtype) * box_lo) if split else None, sign, v,
                     mpar))
    order = [k for k, m in enumerate(subsets) if sum(m) == 1] + \
        [k for k, m in enumerate(subsets) if sum(m) > 1]
    cpos = torch.cat([cand[k][0] for k in order])
    csign = torch.cat([cand[k][2] for k in order])
    cvalid = torch.cat([cand[k][3] for k in order])
    cpar = torch.cat([cand[k][4] for k in order])
    ok = ok & (cvalid.sum() <= G)
    cols = [cpos, csign, cpar]
    if split:
        cols.append(torch.cat([cand[k][1] for k in order]))
    gvalid, gpos, gsign, gparent, *glo = _compact(cvalid, G, *cols)

    spread = _spread(torch.arange(1, G + 1, device=device), int(G**0.5) + 2, dim, dtype)
    gpos = torch.where(gvalid[:, None], gpos, spread)
    ok = ok & (4 * cutoff <= 2.0**20)
    ext_pos = torch.cat([pos, gpos])
    w = torch.cat([torch.zeros((n,), dtype=dtype, device=device), gsign])
    valid = torch.cat([torch.ones((n,), dtype=torch.bool, device=device), gvalid])
    ext_lo = torch.cat([pos_lo, glo[0]]) if split else None
    if return_parents:
        return ext_pos, ext_lo, w, valid, ok, gparent
    return ext_pos, ext_lo, w, valid, ok


def _default_caps(n: int, box, cutoff, B, G, BE):
    """(B, G, BE) as given, `suggest_pbc_capacity`'s where B or G is None
    (BE too, if None then; with B and G given, `pbc_extend` takes BE = B)."""
    if B is None or G is None:
        Bd, Gd, BEd = suggest_pbc_capacity(n, box, cutoff, with_multi=True)
        B = Bd if B is None else B
        G = Gd if G is None else G
        if BE is None:
            BE = BEd
    return B, G, BE


def _ghost_bins(positions, origin, box, cutoff, *, B, G, BE, positions_lo,
                need_perm: bool, signs: bool = True, stable: bool | None = None):
    """Binning for the ghost-image lag and tile paths: ghost-extend every
    axis (`pbc_extend`) and sort by cell key on the auto-ordered grid of
    the live rows. The low parts and, with ``signs``, the shift-sign plane
    ride the sort. Returns (bins, sorted positions, sorted low parts or
    None, sorted signs (n_ext, 1) or None, ok)."""
    ext, ext_lo, w, valid, ok = pbc_extend(
        positions, origin, box, cutoff, B=B, G=G, positions_lo=positions_lo, BE=BE)
    cols = [ext] + ([ext_lo] if ext_lo is not None else []) + ([w[:, None]] if signs else [])
    bins, sorted_cols = bin_and_sort(torch.cat(cols, 1) if len(cols) > 1 else ext, cutoff,
                                     max_cells=1, need_perm=need_perm, valid=valid,
                                     stable=stable, auto_order=True)
    # the lag kernels read contiguous rows
    sp = sorted_cols[:, :3].contiguous()
    slo = sorted_cols[:, 3:6].contiguous() if ext_lo is not None else None
    return bins, sp, slo, sorted_cols[:, -1:] if signs else None, ok


def _minimage_bins(positions, origin, box, cutoff, mimask, *, B, G, positions_lo,
                   need_perm: bool, extra=None, stable: bool | None = None):
    """Binning for the minimum-image lag paths: wrap, ghost-extend only the
    axes that are not folded (nothing when all fold), and bin on the box's
    own aabb (``[origin, origin + box]``, auto-ordered strides), so the
    periodic reach is exact wherever particles sit.

    ``extra`` ((n, k) columns) rides the sort, ghosts taking their
    parent's values. Returns (bins, sorted positions, sorted low parts,
    sorted payload (n_ext, 1) or None, reach, mi_box, ok[, sorted extra]).
    This is the JAX package's general path; its sorted-extremes fast path
    (`_minimage_bins_sorted_extremes`, one ghost axis, the major one) is
    not ported and gives the same pairs.
    """
    n, dim = positions.shape
    dtype, device = positions.dtype, positions.device
    originj = torch.as_tensor(origin, dtype=dtype, device=device).reshape(dim)
    boxj = torch.as_tensor(box, dtype=dtype, device=device).reshape(dim)
    cutj = torch.as_tensor(cutoff, dtype=dtype, device=device)
    pos = wrap_positions(positions, originj, boxj)
    ok = (boxj > 2 * cutj).all()
    ext_extra = None if extra is None else \
        torch.as_tensor(extra, device=device).to(dtype).reshape(n, -1)
    if bool(mimask.all()):
        ext, ext_lo, w, valid = pos, positions_lo, None, None
    else:
        ghost_axes = tuple(bool(x) for x in ~mimask)
        if B is None or G is None:
            Bd, Gd = suggest_pbc_capacity(n, box, cutoff, axes=~mimask)
            B = Bd if B is None else B
            G = Gd if G is None else G
        ext, ext_lo, w, valid, okx, gparent = pbc_extend(
            pos, originj, box, cutoff, B=B, G=G, positions_lo=positions_lo,
            wrap=False, axes=ghost_axes, return_parents=True)
        if ext_extra is not None:
            ext_extra = torch.cat([ext_extra, ext_extra[gparent]])
        ok = ok & okx
    info = GridInfo.create(Aabb(originj, originj + boxj), cutoff, auto_order=True)
    cols = [ext]
    if ext_lo is not None:
        cols.append(torch.as_tensor(ext_lo, device=device).to(dtype))
    if w is not None:
        cols.append(w[:, None])
    n_extra = 0 if ext_extra is None else ext_extra.shape[1]
    if n_extra:
        cols.append(ext_extra)
    stacked = torch.cat(cols, 1) if len(cols) > 1 else ext
    bins, sorted_cols = bin_and_sort(stacked, cutoff, max_cells=1, need_perm=need_perm,
                                     valid=valid, stable=stable, info=info)
    # the lag kernels read contiguous rows
    sp = sorted_cols[:, :dim].contiguous()
    slo = sorted_cols[:, dim:2 * dim].contiguous() if ext_lo is not None else None
    pay_end = sorted_cols.shape[1] - n_extra
    payload = sorted_cols[:, pay_end - 1:pay_end] if w is not None else None
    b64 = np.asarray(box, np.float64).reshape(dim)
    reach = tuple(max(int(np.ceil(b64[a] / float(cutoff))) - 1, 1) if mimask[a] else 1
                  for a in range(dim))
    mi_box = torch.where(torch.as_tensor(mimask), torch.as_tensor(b64, dtype=dtype),
                         torch.zeros((), dtype=dtype))
    out = (bins, sp, slo, payload, reach, mi_box, ok)
    if extra is not None:
        out = out + (sorted_cols[:, pay_end:],)
    return out


def _minimage_pair_sum(positions, origin, box, cutoff, mimask, *, term, B, G, M, L,
                       out_dtype, positions_lo):
    """Lag-path pair sum with the minimum image on the ``mimask`` axes and
    ghost images along the rest. Returns (total, ok)."""
    bins, sp, slo, payload, reach, mi_box, ok = _minimage_bins(
        positions, origin, box, cutoff, mimask, B=B, G=G,
        positions_lo=positions_lo, need_perm=False)
    csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
    eff_term = term if payload is None else _pbc_term(term)
    total = pair_lag_reduce(
        sp, bins.sorted_keys, bins.info.strides, csq, slo, payload, M=M, L=L,
        term=eff_term, out_dtype=out_dtype, mi_box=mi_box, key_reach=reach)
    ok = ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L, reach=reach)
    return total, ok


_MASKED_TERMS: dict = {}


def _pbc_term(term: Callable) -> PbcKeepTerm:
    """``term`` masked by the periodic keep mask (`lag_pairs.PbcKeepTerm`),
    one object per term, so repeated calls hand the kernels the same
    term."""
    fn = _MASKED_TERMS.get(term)
    if fn is None:
        fn = _MASKED_TERMS[term] = PbcKeepTerm(term)
    return fn


def _prepare(positions, positions_lo, device):
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    if positions_lo is not None:
        positions_lo = torch.as_tensor(positions_lo, device=device)
    return positions, positions_lo


def _check_minimage_options(path, bandmask, BE, kahan=True):
    if path != "lag":
        raise ValueError(
            "minimage is a lag-path feature (narrow axes are the lag "
            f"kernel's regime); got path={path!r}")
    if bandmask is not None or BE is not None or kahan is not True:
        raise ValueError(
            "bandmask/kahan/BE are tile/extend-path options with no effect "
            "under minimage; leave them at their defaults")


def pbc_pair_sum(positions, origin, box, cutoff, *, term: Callable = lj_term,
                 B: int | None = None, G: int | None = None, M: int = 4096,
                 L: int = 256, path: str = "lag", CB: int = 8, MAXJ=8, K: int = 32,
                 chunk: int = 64, out_dtype=None, positions_lo=None, minimage=False,
                 bandmask: bool | None = None, kahan=True, BE: int | None = None,
                 device=None):
    """Sum ``term(dsq)`` over the unique minimum-image cutoff pairs of an
    orthorhombic periodic box. Returns (total, ok).

    ``ok`` folds the ghost capacity and regime flags with the kernels'
    coverage flag; False means grow B, G, BE or L (or MAXJ, K) and run
    again. B, G and BE default to `suggest_pbc_capacity`. ``path="lag"``
    (K1) suits thin boxes, ``"tile"`` (K6, the shift-sign plane as its
    payload row) cubic and wide ones, ``"xla"`` any box and dim 2
    (per-particle half-energies summed over the real rows, through
    `core.pairs`); 2-D inputs route to "xla". An integer ``out_dtype``
    returns the (hi, lo) int32 pair of `lag_pairs.combine_count`.

    ``minimage`` ("auto", False or a per-axis mask; lag path only) folds
    the narrow axes in K1 instead of making ghost images
    (`minimage_axes`); it needs host ``box`` and ``cutoff``.
    """
    positions, positions_lo = _prepare(positions, positions_lo, device)
    n, dim = positions.shape
    if dim != 3:
        path = "xla"
    mimask = _resolve_minimage(box, cutoff, minimage, dim)
    if mimask.any():
        _check_minimage_options(path, bandmask, BE, kahan)
        return _minimage_pair_sum(
            positions, origin, box, cutoff, mimask, term=term, B=B, G=G, M=M, L=L,
            out_dtype=out_dtype, positions_lo=positions_lo)
    if path not in ("lag", "tile", "xla"):
        raise ValueError(f"unknown path {path!r} (lag | tile | xla)")
    B, G, BE = _default_caps(n, box, cutoff, B, G, BE)
    csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
    if path == "xla":
        from ..core.grid import build
        from ..core.pairs import pair_energy_per_particle

        ext, _, _, valid, ok = pbc_extend(
            positions, origin, box, cutoff, B=B, G=G, positions_lo=positions_lo, BE=BE)
        grid = build(ext, cutoff, valid=valid)
        e_pp = pair_energy_per_particle(grid, term, K=K, chunk=chunk, cutoff_sq=csq)
        ok = ok & (grid.bins.max_cell_count() <= K)
        if out_dtype is not None and not out_dtype.is_floating_point:
            # the per-row halves are half-integral: sum the doubled per-row
            # counts as (hi, lo) planes and halve the total, as the JAX
            # package does, so odd rows do not truncate
            cnt = torch.round(2.0 * e_pp[:n]).to(torch.int64)
            lo = (cnt & 0xFFFF).sum()
            hi = (cnt >> 16).sum()
            half_lo = (lo + ((hi & 1) << 16)) >> 1
            return torch.stack([hi >> 1, half_lo]).to(torch.int32), ok
        return e_pp[:n].sum(dtype=out_dtype), ok
    bins, sp, slo, signs, ok = _ghost_bins(
        positions, origin, box, cutoff, B=B, G=G, BE=BE, positions_lo=positions_lo,
        need_perm=False)
    if path == "tile":
        from .tile_pairs import tile_pair_reduce

        total, cov = tile_pair_reduce(
            sp, bins.sorted_keys, bins.info.strides, csq, slo, signs[:, 0],
            CB=CB, MAXJ=MAXJ, term=_pbc_term(term), out_dtype=out_dtype,
            bandmask=False if bandmask is None else bandmask, kahan=kahan)
        return total, ok & cov
    total = pair_lag_reduce(
        sp, bins.sorted_keys, bins.info.strides, csq, slo, signs,
        M=M, L=L, term=_pbc_term(term), out_dtype=out_dtype)
    return total, ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L)


def pbc_lj_energy(positions, origin, box, cutoff, **kw):
    """Total LJ energy under orthorhombic PBC. Returns (energy, ok)."""
    return pbc_pair_sum(positions, origin, box, cutoff, term=lj_term, **kw)


def pbc_count_pairs(positions, origin, box, cutoff, **kw):
    """The exact minimum-image cutoff pair count. Returns (count, ok);
    reads the (hi, lo) pair back to the host."""
    kw.setdefault("out_dtype", torch.int32)
    packed, ok = pbc_pair_sum(positions, origin, box, cutoff, term=count_term, **kw)
    return combine_count(packed), ok


def _unsort_rows(f: torch.Tensor, perm: torch.Tensor, n: int) -> torch.Tensor:
    """Rows in sorted order -> the first ``n`` input rows (ghosts, whose
    input index is n or more, are dropped)."""
    out = torch.empty_like(f)
    out[perm.long()] = f
    return out[:n]


def pbc_lj_forces(positions, origin, box, cutoff, *, gfn: Callable | None = None,
                  B: int | None = None, G: int | None = None, M: int = 1024,
                  L: int = 256, path: str = "lag", CB: int = 8, MAXJ=8, K: int = 32,
                  chunk: int = 64, positions_lo=None, minimage=False, species=None,
                  bandmask: bool | None = None, BE: int | None = None, device=None):
    """Per-particle forces under orthorhombic PBC, in input order. Returns
    ((n, dim) forces, ok).

    No pair mask is needed: each real row gets its whole force from its
    own copy of every pair, and the ghost rows' reactions are dropped by
    the un-sort. ``path="lag"`` runs K3 (thin boxes; ``minimage`` folds
    narrow axes there, and Newton's +/- g d on the folded separation is
    the minimum-image force), ``"tile"`` K7 on the ghost-extended array
    (cubic and wide boxes), ``"xla"`` `core.pairs` (any box, and dim 2).
    ``species`` (multi-component forces) comes with slice 5b and raises.
    """
    if species is not None:
        raise NotImplementedError(
            "pbc_lj_forces(species=) is not ported yet: species payloads come "
            "with slice 5b (species and pair potentials)")
    positions, positions_lo = _prepare(positions, positions_lo, device)
    n, dim = positions.shape
    if dim != 3:
        path = "xla"
    csq = torch.as_tensor(cutoff, dtype=positions.dtype) ** 2
    mimask = _resolve_minimage(box, cutoff, minimage, dim)
    if mimask.any():
        _check_minimage_options(path, bandmask, BE)
        bins, sp, slo, _, reach, mi_box, ok = _minimage_bins(
            positions, origin, box, cutoff, mimask, B=B, G=G,
            positions_lo=positions_lo, need_perm=True, stable=False)
        f = pair_lag_forces(sp, bins.sorted_keys, bins.info.strides, csq, slo, M=M,
                            L=L, gfn=gfn, mi_box=mi_box, key_reach=reach)
        ok = ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L, reach=reach)
        return _unsort_rows(f, bins.perm, n), ok
    if path not in ("lag", "tile", "xla"):
        raise ValueError(f"unknown path {path!r} (lag | tile | xla)")
    B, G, BE = _default_caps(n, box, cutoff, B, G, BE)
    if path == "xla":
        from ..core.grid import build
        from ..core.pairs import pair_forces
        from .lj import lj_force_factor

        ext, _, _, valid, ok = pbc_extend(
            positions, origin, box, cutoff, B=B, G=G, positions_lo=positions_lo, BE=BE)
        grid = build(ext, cutoff, valid=valid)
        f = pair_forces(grid, gfn or lj_force_factor, K=K, chunk=chunk, cutoff_sq=csq)
        return f[:n], ok & (grid.bins.max_cell_count() <= K)
    bins, sp, slo, _, ok = _ghost_bins(
        positions, origin, box, cutoff, B=B, G=G, BE=BE, positions_lo=positions_lo,
        need_perm=True, signs=False, stable=False)
    if path == "tile":
        from .tile_pairs import tile_pair_forces

        f, cov = tile_pair_forces(
            sp, bins.sorted_keys, bins.info.strides, csq, slo, CB=CB, MAXJ=MAXJ,
            gfn=gfn, bandmask=False if bandmask is None else bandmask)
        ok = ok & cov
    else:
        f = pair_lag_forces(sp, bins.sorted_keys, bins.info.strides, csq, slo, M=M,
                            L=L, gfn=gfn)
        ok = ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L)
    return _unsort_rows(f, bins.perm, n), ok


def md_step_pbc(positions, velocities, origin, box, cutoff, dt, *, B: int | None = None,
                G: int | None = None, path: str = "lag", **kw):
    """One LJ MD step (semi-implicit Euler: v += dt f; x += dt v) under
    orthorhombic PBC, positions wrapped back into the box; the state stays
    in input order. Returns (positions, velocities, ok). Keyword
    arguments go to `pbc_lj_forces`."""
    f, ok = pbc_lj_forces(positions, origin, box, cutoff, B=B, G=G, path=path, **kw)
    velocities = torch.as_tensor(velocities, device=f.device)
    positions = torch.as_tensor(positions, device=f.device)
    vel_new = velocities + dt * f
    pos_new = wrap_positions(positions + dt * vel_new, origin, box)
    return pos_new, vel_new, ok
