"""The geometric prune of the pair kernels K1, K3, K6, K7 and K9
(``csrc/lag_reduce.cu``, ``csrc/lag_forces.cu``, ``csrc/tile_reduce.cu``,
``csrc/tile_forces.cu``, ``csrc/tile_hist.cu``) and of the query join K12
(``csrc/join_reduce.cu``), all on ``csrc/cluster_sweep.cuh``, in plain
PyTorch.

The kernels give each warp a cluster of ``CLUSTER`` consecutive sorted
slots, reduce the cluster's axis-aligned box over its real slots (< n), and
keep a partner slot j for the cluster's sweep only if the f32 gap between j
and the box, squared and summed in the kernels' order, is below the
threshold: ``cutoff^2`` with f32 coordinates, ``cutoff^2 (1 + 2^-19)`` in
split mode, where each axis' gap is first reduced by the largest low part
of the cluster plus j's own (``cluster_sweep.cuh`` says why no pair that
counts is dropped). The forces kernels sweep both sides of each slot (K3's
lag ranges, K7's full stencil), the energy kernels one side (K1's lags
behind each slot, K6's half stencil with band 0's triangle; the tile
histogram K9 sweeps K6's entries). K12's clusters are 32 consecutive sorted
queries against the particles of each band's union range, kept where the
gap to the query box, in the coordinates' type, is at most the cutoff (the
join's cutoff is inclusive): `join_cluster_entries`. Under the minimum
image (K1 and K3 with ``mi_box``) a folded axis' gap is taken to the
nearest of a j point's periodic images and lowered by the header's
rounding slack (``MI_SLACK``, ``MI_SCALE``). This module
repeats those operations, so that the card's measurements can count the
lane evaluations the prune leaves (``chip_smoke.py``) and the CPU tests can
hold the rule to brute force. The kernels compute their boxes themselves,
from the coordinates of each launch; nothing here is on their path.
"""

from __future__ import annotations

import torch

from ..core.geometry import SENTINEL_KEY, key_window
from .lag_pairs import _pad_and_desentinel
from .segments import CHUNK, segment_bands

CLUSTER = 32  # slots per cluster: one warp's own slots
# Split mode's prune threshold is cutoff^2 times this (above the 1e-6 tie
# band of `lag_pairs.split_cutoff_test`)
SPLIT_MARGIN = 1.0 + 2.0**-19
# The minimum image's gap slack on a folded axis, a multiple of
# (|b| + box + max(|mn|, |mx|)), and the scale of every axis' gap
# (cluster_sweep.cuh's kMiSlack, kMiScale)
MI_SLACK = 2.0**-20
MI_SCALE = 1.0 - 2.0**-21
_BATCH = 16384  # own clusters per step of the counts
_JOIN_BATCH = 1 << 22  # (cluster, particle) tests per step of K12's counts


def prune_threshold(cutoff_sq, split: bool, device=None) -> torch.Tensor:
    """The f32 threshold the kernels compare a squared gap with."""
    csq = torch.as_tensor(cutoff_sq, dtype=torch.float32, device=device)
    if not split:
        return csq
    return csq * torch.tensor(SPLIT_MARGIN, dtype=torch.float32, device=device)


def cluster_boxes(planes: torch.Tensor, lo: torch.Tensor | None = None):
    """Per-cluster boxes of (dim, n) f32 planes: (mn, mx, lomax), each
    (dim, ceil(n / CLUSTER)); ``lomax`` is the largest |lo| per axis (zeros
    without ``lo``). Slots past n take no part."""
    dim, n = planes.shape
    ncl = -(-n // CLUSTER)
    pad = ncl * CLUSTER - n

    def fold(x, fill, op):
        x = torch.cat([x, x.new_full((dim, pad), fill)], 1)
        return op(x.reshape(dim, ncl, CLUSTER), -1).values

    inf = float("inf")
    mn = fold(planes, inf, torch.min)
    mx = fold(planes, -inf, torch.max)
    lomax = torch.zeros_like(mn) if lo is None else fold(lo.abs(), 0.0, torch.max)
    return mn, mx, lomax


def near_cluster(mn, mx, lomax, pts, pts_lo, thr, *, inclusive: bool = False,
                 mi_box=None) -> torch.Tensor:
    """True where a point may hold a pair with the cluster: the kernels'
    gap test, ``gsq < thr`` (``gsq <= thr`` with ``inclusive``, K12's).
    ``mn``, ``mx``, ``lomax`` broadcast against the (dim, ...) points
    ``pts`` (and their low parts ``pts_lo``, or None in f32 mode).
    ``mi_box`` (per-axis box lengths, 0 for an open axis): the minimum
    image's test (``near_box_mi``)."""
    gsq = None
    for a in range(pts.shape[0]):
        b = pts[a]
        g = torch.clamp(torch.maximum(mn[a] - b, b - mx[a]), min=0.0)
        if mi_box is not None:
            bx = float(torch.as_tensor(mi_box[a], dtype=pts.dtype))
            if bx > 0.0:
                up, dn = b + bx, b - bx
                g = torch.minimum(g, torch.clamp(torch.maximum(mn[a] - up, up - mx[a]), min=0.0))
                g = torch.minimum(g, torch.clamp(torch.maximum(mn[a] - dn, dn - mx[a]), min=0.0))
                g = g - MI_SLACK * ((b.abs() + bx) + torch.maximum(mn[a].abs(), mx[a].abs()))
            g = torch.clamp(g * MI_SCALE, min=0.0)
        if pts_lo is not None:
            g = torch.clamp(g - (lomax[a] + pts_lo[a].abs()), min=0.0)
        gsq = g * g if gsq is None else gsq + g * g
    return gsq <= thr if inclusive else gsq < thr


def tile_cluster_entries(inp, cutoff_sq, *, half: bool = False) -> torch.Tensor:
    """The j slots each own cluster of K7 sweeps: those of its chunk's band
    windows (``inp`` from `tile_pairs.tile_inputs(full=True)`) that are
    below n and pass the gap test. With ``half``, those of K6 (``inp`` from
    ``tile_inputs(full=False)``): band 0 loads no j-cluster that starts
    after the own cluster, since its triangle (j < i) masks every lane
    there. Returns (ceil(n / CLUSTER),) int64; each entry is one evaluation
    for each of the cluster's 32 lanes."""
    pos, lo = inp.pos, inp.lo
    dim, n = pos.shape
    device = pos.device
    thr = prune_threshold(cutoff_sq, lo is not None, device)
    mn, mx, lomax = cluster_boxes(pos, lo)
    ncl = mn.shape[1]
    S = inp.bands.shape[0]
    bounds = inp.bounds.long()
    lane = torch.arange(CHUNK, device=device)
    counts = torch.zeros(ncl, dtype=torch.int64, device=device)
    for c0 in range(0, ncl, _BATCH):
        cl = torch.arange(c0, min(c0 + _BATCH, ncl), device=device)
        rows = bounds[cl // (CHUNK // CLUSTER)]
        box = [x[:, cl, None] for x in (mn, mx, lomax)]
        for s in range(S):
            first = rows[:, 3 * s] + rows[:, 3 * s + 1]
            num = rows[:, 3 * s + 2]
            for t in range(int(num.max()) if num.numel() else 0):
                j = (first + t)[:, None] * CHUNK + lane
                ok = (t < num)[:, None] & (j < n)
                if half and s == 0:
                    ok = ok & (j // CLUSTER <= cl[:, None])
                j = j.clamp(0, n - 1)
                near = near_cluster(*box, pos[:, j],
                                    None if lo is None else lo[:, j], thr)
                counts[cl] += (near & ok).sum(-1)
    return counts


def lag_ranges(sorted_keys: torch.Tensor, strides, L: int, reach=None):
    """Each slot's partner range [jlo, jhi] for K3 (int64, (n,) each; K1's
    is [jlo, i - 1]): the slots within L lags in the key window (``key_j >=
    key_i - W`` behind i, ``key_i >= key_k - W`` ahead; ``reach`` widens W
    for the minimum image), padding rows read as `_pad_and_desentinel`
    spaces them. Keys ascend, so each side is one contiguous run."""
    n = sorted_keys.shape[0]
    keys = _pad_and_desentinel(sorted_keys, n).long()
    w = int(key_window(strides, reach))
    i = torch.arange(n, device=keys.device)
    jlo = torch.maximum(i - L, torch.searchsorted(keys, keys - w))
    jhi = torch.minimum(i + L, torch.searchsorted(keys, keys + w, right=True) - 1)
    return jlo, jhi


def lag_cluster_entries(planes: torch.Tensor, lo: torch.Tensor | None,
                        sorted_keys: torch.Tensor, strides, cutoff_sq,
                        L: int, *, half: bool = False, mi_box=None,
                        reach=None) -> torch.Tensor:
    """The j slots each own cluster of K3 sweeps: the union of its slots'
    partner ranges that passes the gap test ((dim, n) ``planes`` and low
    parts ``lo`` or None). With ``half``, those of K1: the union of the
    ranges behind its slots, [jlo of its first slot, its last real slot -
    1]. ``mi_box`` and ``reach``: the minimum image's gap test and widened
    window. Returns (ceil(n / CLUSTER),) int64."""
    dim, n = planes.shape
    device = planes.device
    thr = prune_threshold(cutoff_sq, lo is not None, device)
    mn, mx, lomax = cluster_boxes(planes, lo)
    ncl = mn.shape[1]
    jlo, jhi = lag_ranges(sorted_keys, strides, L, reach)
    starts = torch.arange(ncl, device=device) * CLUSTER
    ends = torch.clamp(starts + CLUSTER - 1, max=n - 1)  # the last real slots
    first = jlo[starts]
    last = ends - 1 if half else jhi[ends]
    counts = torch.zeros(ncl, dtype=torch.int64, device=device)
    for c0 in range(0, ncl, _BATCH):
        cl = torch.arange(c0, min(c0 + _BATCH, ncl), device=device)
        width = max(int((last[cl] - first[cl]).max()) + 1, 0)
        j = first[cl, None] + torch.arange(width, device=device)
        ok = j <= last[cl, None]
        j = j.clamp(max=n - 1)
        near = near_cluster(*[x[:, cl, None] for x in (mn, mx, lomax)], planes[:, j],
                            None if lo is None else lo[:, j], thr, mi_box=mi_box)
        counts[cl] = (near & ok).sum(-1)
    return counts


def join_ranges(qkeys: torch.Tensor, pkeys: torch.Tensor, bands: torch.Tensor):
    """K12's union range of each query cluster and band: (first, end), each
    (ceil(nq / CLUSTER), S) int64, the particles whose key lies in [kf -
    hi_s, kl - lo_s] for the cluster's smallest and largest real key kf, kl
    (``pkeys`` ascending). A cluster without a real query (every key
    SENTINEL_KEY) gets empty ranges."""
    nq = qkeys.shape[0]
    ncl = -(-nq // CLUSTER)
    pad = ncl * CLUSTER - nq
    k = torch.cat([qkeys.long(), qkeys.new_full((pad,), SENTINEL_KEY).long()])
    k = k.reshape(ncl, CLUSTER)
    real = k != SENTINEL_KEY
    kf = torch.where(real, k, torch.full_like(k, 2**62)).amin(1)
    kl = torch.where(real, k, torch.full_like(k, -(2**62))).amax(1)
    b = bands.long()
    pk = pkeys.long()
    first = torch.searchsorted(pk, kf[:, None] - b[None, :, 1])
    end = torch.searchsorted(pk, kl[:, None] - b[None, :, 0], right=True)
    end = torch.where(real.any(1)[:, None], end, first)
    return first, end


def join_boxes(qplanes: torch.Tensor, qkeys: torch.Tensor):
    """Per-cluster boxes (mn, mx), each (3, ceil(nq / CLUSTER)), of the
    (3, nq) query planes in their own type; queries with SENTINEL_KEY take
    no part."""
    real = qkeys != SENTINEL_KEY
    inf = float("inf")
    mn, _, _ = cluster_boxes(torch.where(real, qplanes, torch.full_like(qplanes, inf)))
    _, mx, _ = cluster_boxes(torch.where(real, qplanes, torch.full_like(qplanes, -inf)))
    return mn, mx


def join_cluster_entries(qplanes: torch.Tensor, qkeys: torch.Tensor,
                         pplanes: torch.Tensor, pkeys: torch.Tensor, strides,
                         cutoff_sq) -> torch.Tensor:
    """The buffer entries each query cluster of K12 sweeps: over the 9
    bands, the particles of the band's union range (`join_ranges`) whose
    gap to the cluster's query box, in the coordinates' type, is at most
    ``cutoff_sq`` ((3, nq) query and (3, np) particle planes of one dtype,
    keys ascending). Returns (ceil(nq / CLUSTER),) int64; each entry is one
    evaluation for each of the cluster's queries."""
    device = qplanes.device
    csq = torch.as_tensor(cutoff_sq, dtype=qplanes.dtype, device=device)
    bands = segment_bands(torch.as_tensor(strides, device=device), full=True)
    first, end = join_ranges(qkeys, pkeys, bands)
    mn, mx = join_boxes(qplanes, qkeys)
    zero = torch.zeros((), dtype=qplanes.dtype, device=device)
    ncl = first.shape[0]
    counts = torch.zeros(ncl, dtype=torch.int64, device=device)
    npart = pplanes.shape[1]
    for s in range(bands.shape[0]):
        width = end[:, s] - first[:, s]
        step = max(1, _JOIN_BATCH // max(int(width.max()) if ncl else 1, 1))
        for c0 in range(0, ncl, step):
            cl = slice(c0, min(c0 + step, ncl))
            w = int(width[cl].max())
            j = first[cl, s, None] + torch.arange(w, device=device)
            ok = j < end[cl, s, None]
            j = j.clamp(0, max(npart - 1, 0))
            near = near_cluster(mn[:, cl, None], mx[:, cl, None], zero, pplanes[:, j],
                                None, csq, inclusive=True)
            counts[cl] += (near & ok).sum(-1)
    return counts
