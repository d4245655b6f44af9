"""Per-chunk lag-segment bounds for the segment-tile kernel (K6), and the
per-query-chunk windows of the query join's plain version (`join_bounds`).

PyTorch counterpart of ``zelll_tpu/ops/segments.py``, in plain torch.

The lag kernel (`ops.lag_pairs`) scans one contiguous window of lags,
which is tight for thin boxes but degenerates for cubic or wide boxes,
where the key window spans a whole z-layer of slots that hold no partner.
The tile kernel (`ops.tile_pairs`) instead visits, for every 128-slot chunk
of the sorted order, only the few slot ranges that can hold cutoff
partners.

With ascending strides (x fastest), the key difference ``key_i - key_j``
of every half-stencil partner j falls in a small set of disjoint bands:

    3D:  [0, 1]                        own row      (dz=0, dy=0, dx in {0,-1})
         [s_y-1, s_y+1]                y-1 row      (dz=0, dy=-1)
         [s_z-s_y-1, s_z-s_y+1]        z-1, y+1 row
         [s_z-1, s_z+1]                z-1, y   row
         [s_z+s_y-1, s_z+s_y+1]        z-1, y-1 row
    2D:  [0, 1], [s_y-1, s_y+1]
    1D:  [0, 1]

The +4 stride padding (`GridInfo`) makes the bands disjoint for every grid
shape, and their union is exactly the half stencil: every cutoff pair lands
in exactly one band. For each chunk c and band s the partner slots form
one contiguous range, located with two ``searchsorted`` calls on the
128-downsampled sorted keys.

All key arithmetic stays in int32, as in the JAX package, so that window
bounds agree bitwise with it.
"""

from __future__ import annotations

import numpy as np
import torch

from .lag_pairs import _PAD_KEY_BASE

__all__ = [
    "CHUNK",
    "segment_bands",
    "num_segments",
    "suggest_maxj",
    "band_order",
    "trim_windows_disjoint",
    "windows_disjoint",
    "chunk_bounds",
    "join_bounds",
]

CHUNK = 128

_I32 = torch.int32


def segment_bands(strides, full: bool = False) -> torch.Tensor:
    """(S, 2) int32 [lo, hi] key-difference bands of the stencil for
    ``strides`` (length = dim), on the strides' device.

    Half space (default): each unordered pair appears once (j behind i);
    S = 1, 2, 5 for dim = 1, 2, 3. ``full=True`` adds the mirrored bands
    (partners ahead of i too, [0, 1] widening to [-1, 1]) for
    per-particle full-stencil reductions; S = 1, 3, 9.

    Strides are sorted on entry: the band set depends only on the stride
    values, so per-axis vectors from ``GridInfo.create(auto_order=True)``
    work unchanged.
    """
    strides = torch.sort(torch.as_tensor(strides, dtype=_I32)).values
    dim = strides.shape[0]
    device = strides.device
    lo0 = -1 if full else 0
    if dim == 1:
        rows = [(lo0, 1)]
    elif dim == 2:
        sy = strides[1]
        rows = [(lo0, 1), (sy - 1, sy + 1)]
        if full:
            rows.append((-sy - 1, -sy + 1))
    elif dim == 3:
        sy, sz = strides[1], strides[2]
        rows = [
            (lo0, 1),
            (sy - 1, sy + 1),
            (sz - sy - 1, sz - sy + 1),
            (sz - 1, sz + 1),
            (sz + sy - 1, sz + sy + 1),
        ]
        if full:
            rows += [
                (-sy - 1, -sy + 1),
                (-sz + sy - 1, -sz + sy + 1),
                (-sz - 1, -sz + 1),
                (-sz - sy - 1, -sz - sy + 1),
            ]
    else:
        raise NotImplementedError("segment bands support dim <= 3")

    # built on the device: no read-back of the strides, no blocking copy
    def entry(v):
        if isinstance(v, torch.Tensor):
            return v
        return torch.full((), v, dtype=_I32, device=device)

    return torch.stack([torch.stack([entry(lo), entry(hi)]) for lo, hi in rows])


def num_segments(dim: int, full: bool = False) -> int:
    if full:
        return {1: 1, 2: 3, 3: 9}[dim]
    return {1: 1, 2: 2, 3: 5}[dim]


def suggest_maxj(sorted_keys_padded: torch.Tensor, bands: torch.Tensor,
                 half: bool = True, per_band: bool = False):
    """Smallest MAXJ capacity that covers every chunk's partner window for
    this data (reads the result back to the host).

    ``per_band=True`` returns a tuple of per-band capacities instead of
    one shared scalar: the own-row band spans about 2 chunks, each z-layer
    band the chunk-quantised row population.
    """
    nc = sorted_keys_padded.shape[0] // CHUNK
    _, _, jnum, _ = chunk_bounds(sorted_keys_padded, bands, max_j=nc,
                                 half=half)
    if per_band:
        return tuple(max(int(v), 1) for v in jnum.amax(0).cpu())
    return max(int(jnum.max()), 1)


def band_order(dim: int, full: bool = False) -> tuple:
    """Band indices sorted by descending window position in key space
    (ascending band hi). Both window starts (kmin - hi_s) and ends
    (kmax - lo_s) are monotone along this order, the property
    `trim_windows_disjoint` relies on."""
    if not full:
        return tuple(range(num_segments(dim)))
    return {1: (0,), 2: (2, 0, 1), 3: (8, 7, 6, 5, 0, 1, 2, 3, 4)}[dim]


def trim_windows_disjoint(jlo, toff, jnum, order):
    """Make the executed windows pairwise disjoint by construction.

    Chunks that straddle a y-row or z-layer key jump have genuinely
    overlapping band windows, and a maskless tile would evaluate a shared
    j-chunk once per band. Taking bands in descending window position
    (`band_order`), each band's executed end is clamped to the start of the
    nearest non-empty higher window. The trimmed-off regions are covered by
    the higher band, so the union of executed chunks is unchanged.

    Returns (toff', jnum') with toff' >= toff and jnum' <= jnum.
    """
    start = (jlo + toff).to(_I32)
    end = start + jnum
    nc, S = start.shape
    run = torch.full((nc,), 2**30, dtype=_I32, device=start.device)
    s2 = [None] * S
    n2 = [None] * S
    for s in order:
        e = torch.minimum(end[:, s], run)
        st = torch.minimum(start[:, s], e)
        num = torch.clamp(e - st, min=0)
        run = torch.where(num > 0, st, run)
        s2[s] = st
        n2[s] = num
    start2 = torch.stack(s2, dim=-1)
    num2 = torch.stack(n2, dim=-1)
    toff2 = torch.clamp(start2 - jlo, min=0)
    return toff2, num2


def windows_disjoint(jlo, toff, jnum) -> torch.Tensor:
    """True iff every chunk's executed windows [jlo+toff, jlo+toff+jnum)
    are pairwise disjoint across bands: the precondition of the maskless
    tile body (``bandmask=False``). Empty windows never overlap."""
    start = (jlo + toff).to(_I32)
    end = start + jnum
    S = start.shape[1]
    empty = jnum == 0
    ok = torch.ones((), dtype=torch.bool, device=start.device)
    for a in range(S):
        for b in range(a + 1, S):
            sep = (end[:, a] <= start[:, b]) | (end[:, b] <= start[:, a])
            ok = ok & (sep | empty[:, a] | empty[:, b]).all()
    return ok


def _to_device(values: np.ndarray, device) -> torch.Tensor:
    """A small host int32 vector on ``device``, written element by element
    with fills: a copy from pageable host memory may wait for the device's
    queue, a fill never does."""
    values = np.asarray(values, np.int32)
    out = torch.empty(values.shape, dtype=_I32, device=device)
    for k, v in enumerate(values.tolist()):
        out[k].fill_(v)
    return out


def _searchsorted(seq: torch.Tensor, values: torch.Tensor, right: bool):
    return torch.searchsorted(seq.contiguous(), values.contiguous(),
                              right=right).to(_I32)


def chunk_bounds(sorted_keys: torch.Tensor, bands: torch.Tensor, max_j,
                 half: bool = True, groups: int = 1):
    """Per-chunk, per-band j-chunk windows.

    ``sorted_keys``: (C,) int32 ascending, C a multiple of CHUNK; padding
    rows (keys at or above the padding base, see
    `lag_pairs._pad_and_desentinel`) sort last and resolve to empty
    windows.

    ``max_j`` is the window capacity in chunks: one shared scalar, or a
    length-S tuple of per-band capacities (`suggest_maxj(per_band=True)`).

    Returns (jlo, toff, jnum, coverage_ok):
      jlo  (NC, S) int32: window base chunk, clamped so that the window
           [jlo, jlo + max_j) is always in array range,
      toff (NC, S) int32: offset of the first partner chunk in the window,
      jnum (NC, S) int32: number of j-chunks holding partners,
      coverage_ok: False iff some window needs more than max_j chunks, a
           real key reaches the padding base, or the keys do not ascend
           (the result would drop pairs: never proceed on False).

    A pair (i, j < i) whose key difference lies in band s falls in exactly
    one (band, j-chunk) with jlo+toff <= c_j < jlo+toff+jnum.

    ``groups > 1`` also returns sub-chunk windows: each chunk is split
    into ``groups`` row groups of CHUNK/groups slots, and each (chunk,
    group, band) gets the tighter window of that group's keys. Returns
    (jlo, toff, jnum, gtoff (NC, G, S), gjnum (NC, G, S), coverage_ok);
    group windows are clamped inside [jlo, jlo + max_j).
    """
    C = sorted_keys.shape[0]
    assert C % CHUNK == 0
    nc = C // CHUNK
    device = sorted_keys.device
    k = sorted_keys.to(_I32).reshape(nc, CHUNK)
    kmin, kmax = k[:, 0], k[:, -1]
    b = bands.to(device=device, dtype=_I32)  # (S, 2)
    S = b.shape[0]
    pad_base = torch.full((), _PAD_KEY_BASE, dtype=_I32, device=device)
    minus_one = torch.full((), -1, dtype=_I32, device=device)

    # Window bounds come from the real keys of each chunk: the chunk that
    # straddles the real->padding boundary would otherwise inherit a
    # padding kmax and claim a window over the whole real tail.
    real = k < pad_base
    has_real = real[:, 0]  # keys ascend within a chunk
    kmax_real_chunk = torch.where(real, k, minus_one).amax(1)
    kreal_max = kmax_real_chunk.max()
    # padding-only chunks keep their padding kmax, so the searched array
    # stays ascending
    kmax_eff = torch.where(has_real, kmax_real_chunk, kmax)
    # clamp the query operands into the real-key range: band offsets then
    # cannot overflow int32, and padding chunks resolve to empty windows
    kmin_q = torch.minimum(kmin, kreal_max + 1)
    kmax_q = torch.minimum(kmax_eff, kreal_max)

    # queries, shaped (S, NC): window key range per chunk and band
    qlo = kmin_q[None, :] - b[:, 1][:, None]  # smallest partner key
    qhi = kmax_q[None, :] - b[:, 0][:, None]  # largest partner key

    # first chunk whose real kmax >= qlo / last chunk whose kmin <= qhi
    lo = _searchsorted(kmax_eff, qlo.reshape(-1), right=False)
    hi = _searchsorted(kmin, qhi.reshape(-1), right=True)
    lo = lo.reshape(S, nc).T  # (NC, S)
    hi = hi.reshape(S, nc).T - 1  # inclusive
    hi = torch.where(has_real[:, None], hi, lo - 1)  # padding chunks: empty

    if half:
        # partners sit at j <= i: never look past the own chunk
        own = torch.arange(nc, dtype=_I32, device=device)[:, None]
        hi = torch.minimum(hi, own)

    jnum = torch.clamp(hi - lo + 1, min=0)
    mj = np.broadcast_to(np.asarray(max_j, np.int32), (S,))
    mj_t = _to_device(mj, device)
    coverage_ok = (
        (jnum.amax(0) <= mj_t).all()
        & (kreal_max < pad_base)
        & (sorted_keys[1:] >= sorted_keys[:-1]).all()
    )
    jnum = torch.minimum(jnum, mj_t[None, :])
    # clamp the window base into range: when lo reaches past nc - max_j
    # the base backs up so [jlo, jlo + max_j) still covers [lo, hi]
    base_max = _to_device(np.maximum(nc - mj, 0), device)
    jlo = torch.minimum(lo, base_max[None, :])
    toff = lo - jlo
    if groups == 1:
        return jlo, toff, jnum, coverage_ok

    assert CHUNK % groups == 0
    OH = CHUNK // groups
    kg = k.reshape(nc * groups, OH)
    gmin, gmax_raw = kg[:, 0], kg[:, -1]
    greal = kg < pad_base
    ghas = greal[:, 0]
    gmax_real = torch.where(greal, kg, minus_one).amax(1)
    gmin_q = torch.minimum(gmin, kreal_max + 1)
    gmax_q = torch.minimum(torch.where(ghas, gmax_real, gmax_raw), kreal_max)

    qlo_g = gmin_q[None, :] - b[:, 1][:, None]  # (S, NC*G)
    qhi_g = gmax_q[None, :] - b[:, 0][:, None]
    glo = _searchsorted(kmax_eff, qlo_g.reshape(-1), right=False)
    ghi = _searchsorted(kmin, qhi_g.reshape(-1), right=True)
    glo = glo.reshape(S, nc, groups).permute(1, 2, 0)
    ghi = ghi.reshape(S, nc, groups).permute(1, 2, 0) - 1

    if half:
        own = torch.arange(nc, dtype=_I32, device=device)[:, None, None]
        ghi = torch.minimum(ghi, own)
    ghi = torch.where(ghas.reshape(nc, groups, 1), ghi, glo - 1)

    parent = jlo[:, None, :]  # (NC, 1, S)
    mj_g = mj_t[None, None, :]
    glo_c = torch.minimum(torch.maximum(glo, parent), parent + mj_g)
    ghi_c = torch.minimum(ghi, parent + mj_g - 1)
    gtoff = glo_c - parent
    gjnum = torch.clamp(ghi_c - glo_c + 1, min=0)
    return jlo, toff, jnum, gtoff, gjnum, coverage_ok


def join_bounds(q_keys: torch.Tensor, p_keys: torch.Tensor, bands: torch.Tensor,
                max_j: int | None = None):
    """Per-query-chunk, per-band windows over a second sorted array: the
    join sibling of `chunk_bounds`, for the plain version of the join
    kernel (`ops.join`). Query chunks come from ``q_keys`` (sorted query
    keys) and partner windows are located in ``p_keys`` (sorted particle
    keys). Both are (C,) int32 ascending with C a multiple of CHUNK;
    padding rows carry `lag_pairs._pad_and_desentinel` keys.

    With ``max_j=None`` returns (lo, num, coverage_ok):
      lo  (NCq, S) int32: first partner particle chunk (absolute index),
      num (NCq, S) int32: number of partner chunks,
      coverage_ok: the key preconditions (both arrays ascending, real keys
          below the padding base).

    With ``max_j`` set returns (jlo, toff, jnum, coverage_ok) as
    `chunk_bounds` does: jlo the clamped window base (the window
    [jlo, jlo + max_j) lies in range; pass max_j <= NCp), toff the first
    partner chunk inside it, and coverage_ok also False when some window
    needs more than max_j chunks.

    A (query, particle) pair whose key difference q - p lies in band s
    satisfies lo[cq, s] <= c_p < lo[cq, s] + num[cq, s].
    """
    Cq, Cp = q_keys.shape[0], p_keys.shape[0]
    assert Cq % CHUNK == 0 and Cp % CHUNK == 0
    ncq, ncp = Cq // CHUNK, Cp // CHUNK
    device = q_keys.device
    b = bands.to(device=device, dtype=_I32)  # (S, 2)
    S = b.shape[0]
    pad_base = torch.full((), _PAD_KEY_BASE, dtype=_I32, device=device)
    int_min = torch.full((), -(2**31), dtype=_I32, device=device)

    kq = q_keys.to(_I32).reshape(ncq, CHUNK)
    realq = kq < pad_base
    q_has = realq[:, 0]
    q_kmax = torch.where(realq, kq, int_min).amax(1)
    q_kmin = kq[:, 0]

    kp = p_keys.to(_I32).reshape(ncp, CHUNK)
    realp = kp < pad_base
    p_has = realp[:, 0]
    p_kmax_real = torch.where(realp, kp, int_min).amax(1)
    p_real_max = p_kmax_real.max()
    # padding-only particle chunks keep their padding kmax, so the searched
    # array stays ascending
    p_kmax_eff = torch.where(p_has, p_kmax_real, kp[:, -1])
    p_kmin = kp[:, 0]

    # Real query keys stay unclamped: out-of-box queries carry keys outside
    # the particle key range, and clamping would shift their windows. Only
    # padding query chunks (keys ~2^30, whose band offsets could overflow)
    # take a safe in-range constant; their windows are emptied below.
    safe = p_real_max + 1
    kmin_q = torch.where(q_has, q_kmin, safe)
    kmax_q = torch.where(q_has, q_kmax, safe)

    qlo = kmin_q[None, :] - b[:, 1][:, None]  # smallest partner key (S, NCq)
    qhi = kmax_q[None, :] - b[:, 0][:, None]  # largest partner key

    lo = _searchsorted(p_kmax_eff, qlo.reshape(-1), right=False)
    hi = _searchsorted(p_kmin, qhi.reshape(-1), right=True)
    lo = lo.reshape(S, ncq).T  # (NCq, S)
    hi = hi.reshape(S, ncq).T - 1  # inclusive
    hi = torch.where(q_has[:, None], hi, lo - 1)  # padding query chunks: empty

    num = torch.clamp(hi - lo + 1, min=0)
    coverage_ok = (
        (p_real_max < pad_base)
        & (q_keys[1:] >= q_keys[:-1]).all()
        & (p_keys[1:] >= p_keys[:-1]).all()
    )
    if max_j is None:
        return lo, num, coverage_ok

    assert max_j <= ncp, "clamp max_j to the particle chunk count first"
    coverage_ok = coverage_ok & (num.max() <= max_j)
    jnum = torch.clamp(num, max=max_j)
    # clamp the window base so [jlo, jlo + max_j) stays in range: whenever
    # jnum > 0 the clamped window still covers [lo, lo + jnum)
    jlo = torch.clamp(lo, 0, max(ncp - max_j, 0))
    toff = lo - jlo
    return jlo, toff, jnum, coverage_ok
