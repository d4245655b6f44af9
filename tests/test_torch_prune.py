"""The geometric prune of the pair kernels K1, K3, K6 and K7, in its
plain PyTorch mirror (`ops.cluster_prune`), held to brute force.

Every pair that the cutoff keeps (f32 coordinates, and split ones with the
f64 tie rule of `lag_pairs.split_cutoff_test` for the forces kernels K3 and
K7, or the f32 rule of the energy kernels K1 and K6) must lie near its own
cluster's box, on the facing clusters of `utils.datagen.cluster_gap` (boxes
exactly one cutoff apart, pairs a few ulp either side of it), on a state
moved by up to a skin since its keys were built, and on the uniform cloud.
The mirror's partner ranges (K3, and K1's one-sided ones) and sweep entries
(K3 and K7 over both sides, K1 and K6, the ``_half`` kernels, over one) are
checked against brute-force windows. The lag kernels' minimum image (K1
and K3 with ``mi_box``) is held the same way on a periodic seam cloud,
whose clusters face each other only through the seam of the folded axes
(and the ghost faces of the other), where a prune without periodic images
drops counted pairs. Everything runs on CPU tensors and calls no JAX.
"""

import numpy as np
import pytest
import torch
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu_torch.core import GridInfo, aabb_from_positions, compute_keys, key_window
from zelll_tpu_torch.ops.cluster_prune import (
    CLUSTER,
    cluster_boxes,
    lag_cluster_entries,
    lag_ranges,
    near_cluster,
    prune_threshold,
    tile_cluster_entries,
)
from zelll_tpu_torch.ops.lag_pairs import (
    _pad_and_desentinel,
    mi_fold,
    split_cutoff_test,
    split_f64,
    suggest_lag,
)
from zelll_tpu_torch.ops.pbc import _minimage_bins
from zelll_tpu_torch.ops.segments import CHUNK, segment_bands, suggest_maxj
from zelll_tpu_torch.ops.tile_pairs import tile_inputs
from zelll_tpu_torch.utils.datagen import (
    cluster_gap,
    generate_points_lattice,
    generate_points_random,
    lj_box,
    seam_cloud,
)

CUTOFF = 10.0
CSQ = torch.tensor(CUTOFF**2, dtype=torch.float32)
N = 1500
L_SHORT = 64  # below the thin box's key window: the lag bound binds
GAP_SITES = (128, 512)  # the first slots of cluster_gap's facing clusters


def _sorted(pts):
    """f64 points sorted by cell key: (f64 points, keys, strides)."""
    hi, _ = split_f64(torch.as_tensor(pts))
    info = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
    keys, perm = torch.sort(compute_keys(hi, info), stable=True)
    return np.asarray(pts)[perm.numpy()], keys, info.strides


def _case(data: str, kernel: str):
    box = lj_box(N, CUTOFF) if kernel.startswith("lag") else ((N / 0.01) ** (1 / 3),) * 3
    pts = generate_points_random(N, box) if data == "uniform" else \
        generate_points_lattice(N, box)
    pts, keys, strides = _sorted(pts)
    if data == "cluster_gap":
        pts = cluster_gap(pts, CUTOFF, GAP_SITES)
    elif data == "drifted":  # moved by up to a skin of 0.5 after the sort
        pts = pts + np.random.default_rng(3).uniform(-0.25, 0.25, pts.shape)
    hi, lo = split_f64(torch.as_tensor(pts))
    return hi, lo, keys, strides


def _counted(hi, lo, tie: bool = True):
    """(n, n) pairs that the cutoff keeps, as the plain versions decide:
    with the f64 tie rule in split mode (``tie``, the forces) or on the f32
    dsq alone (the energy kernels, which count coincident particles)."""
    d = [hi[:, None, a] - hi[None, :, a] for a in range(3)]
    if lo is not None:
        d = [d[a] + (lo[:, None, a] - lo[None, :, a]) for a in range(3)]
    dsq = d[0] * d[0]
    dsq = dsq + d[1] * d[1]
    dsq = dsq + d[2] * d[2]
    inside = dsq < CSQ
    if not tie:
        return inside & ~torch.eye(hi.shape[0], dtype=torch.bool)
    if lo is not None:
        inside = split_cutoff_test(inside, dsq, CSQ, hi[:, None].unbind(-1),
                                   hi[None].unbind(-1), lo[:, None].unbind(-1),
                                   lo[None].unbind(-1))
    return inside & (dsq > 0)


def _near(hi, lo, thr):
    """(n, n): slot j passes the gap test of slot i's cluster."""
    mn, mx, lomax = cluster_boxes(hi.t(), None if lo is None else lo.t())
    own = torch.arange(hi.shape[0]) // CLUSTER
    box = [x[:, own, None] for x in (mn, mx, lomax)]
    return near_cluster(*box, hi.t()[:, None, :],
                        None if lo is None else lo.t()[:, None, :], thr)


def _seam_check(half: bool):
    """The minimum-image prune of K1 (``half``) or K3 on a seam lattice in a
    30 x 30 x 60 box (two layers of spacing 1.5 at each x and y face, z
    filled: 640 points), with x, y folded and z ghost-extended, and with
    all three folded: every pair
    the folded cutoff counts passes the periodic gap test, some of them
    fail the open one, and `lag_cluster_entries` equals the entries counted
    by brute force over the widened window."""
    box = np.array([30.0, 30.0, 60.0])
    pts = seam_cloud(box, 1.5, 2, (0, 1), np.random.default_rng(7))
    n_seam = len(pts)
    hi64, lo64 = split_f64(torch.as_tensor(pts))
    for mimask in ((True, True, False), (True, True, True)):
        bins, shi, slo, _, reach, mib, ok = _minimage_bins(
            hi64, [0.0] * 3, box, CUTOFF, np.array(mimask), B=n_seam, G=n_seam,
            positions_lo=lo64, need_perm=False)
        assert bool(ok)
        keys, strides = bins.sorted_keys, bins.info.strides
        n = shi.shape[0]
        own = torch.arange(n)
        for split in (False, True):
            plo = slo if split else None
            folded = [mi_fold(shi[:, None, a], shi[None, :, a],
                              None if plo is None else plo[:, None, a],
                              None if plo is None else plo[None, :, a], mib[a])
                      for a in range(3)]
            d = [f[0] for f in folded]
            dsq = d[0] * d[0]
            dsq = dsq + d[1] * d[1]
            dsq = dsq + d[2] * d[2]
            counted = (dsq < CSQ) & (own[:, None] != own[None, :])
            if not half and plo is not None:
                counted = split_cutoff_test(
                    dsq < CSQ, dsq, CSQ, shi[:, None].unbind(-1), shi[None].unbind(-1),
                    plo[:, None].unbind(-1), plo[None].unbind(-1),
                    [f[1] for f in folded]) & (dsq > 0)
            mn, mx, lomax = cluster_boxes(shi.t(), None if plo is None else plo.t())
            box_of = [x[:, own // CLUSTER, None] for x in (mn, mx, lomax)]
            thr = prune_threshold(CSQ, split)
            args = (shi.t()[:, None, :], None if plo is None else plo.t()[:, None, :], thr)
            near = near_cluster(*box_of, *args, mi_box=mib)
            assert not bool((counted & ~near).any()), (mimask, split)
            assert bool((counted & ~near_cluster(*box_of, *args)).any()), (mimask, split)
            L = suggest_lag(keys, strides, reach=reach)
            jlo, jhi = lag_ranges(keys, strides, L, reach)
            first = jlo[::CLUSTER]
            ends = torch.clamp(torch.arange(0, n, CLUSTER) + CLUSTER - 1, max=n - 1)
            last = ends - 1 if half else jhi[ends]
            union = (own[None, :] >= first[:, None]) & (own[None, :] <= last[:, None])
            got = lag_cluster_entries(shi.t(), None if plo is None else plo.t(), keys,
                                      strides, CSQ, L, half=half, mi_box=mib, reach=reach)
            assert torch.equal(got, (union & near[::CLUSTER]).sum(1)), (mimask, split)


@pytest.mark.parametrize("kernel", ["lag", "tile", "lag_half", "tile_half"])
@pytest.mark.parametrize("data", ["cluster_gap", "drifted", "uniform"])
def test_prune_keeps_every_counted_pair(data, kernel):
    hi, lo, keys, strides = _case(data, kernel)
    n = hi.shape[0]
    own = torch.arange(n)
    half = kernel.endswith("_half")
    if data == "drifted" and kernel.startswith("lag"):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _seam_check(half)
        finally:
            torch.set_num_threads(threads)
    for split in (False, True):
        plo = lo if split else None
        counted = _counted(hi, plo, tie=not half)
        near = _near(hi, plo, prune_threshold(CSQ, split))
        assert not bool((counted & ~near).any()), (data, kernel, split)
        if data == "cluster_gap":
            # sharp: the facing pair at cutoff (1 - 2^-23) counts at the
            # first site, and at the second in split mode, where a prune
            # without the margin (the f32 test on the high parts) drops it
            assert bool(counted[GAP_SITES[0] + 31, GAP_SITES[0] + 32])
            assert bool(counted[GAP_SITES[1] + 31, GAP_SITES[1] + 32]) == split
            if split:
                bare = _near(hi, None, prune_threshold(CSQ, False))
                assert bool((counted & ~bare).any())
        else:
            assert float(near.float().mean()) < 0.9  # the prune bites

        if kernel.startswith("lag"):
            # the partner ranges against the window, pair by pair
            k = _pad_and_desentinel(keys, n).long()
            w = int(key_window(strides))
            lag = own[:, None] - own[None, :]  # i - j
            behind = (lag >= 1) & (lag <= L_SHORT) & (k[None, :] >= k[:, None] - w)
            ahead = (lag <= -1) & (lag >= -L_SHORT) & (k[:, None] >= k[None, :] - w)
            jlo, jhi = lag_ranges(keys, strides, L_SHORT)
            if half:  # K1: the lags behind each slot, [jlo, i - 1]
                ranged = (own[None, :] >= jlo[:, None]) & (lag >= 1)
                assert torch.equal(ranged, behind)
            else:
                ranged = (own[None, :] >= jlo[:, None]) & (own[None, :] <= jhi[:, None])
                assert torch.equal(ranged & (lag != 0), behind | ahead)
            first = jlo[::CLUSTER]
            ends = torch.clamp(torch.arange(0, n, CLUSTER) + CLUSTER - 1, max=n - 1)
            last = ends - 1 if half else jhi[ends]
            union = (own[None, :] >= first[:, None]) & (own[None, :] <= last[:, None])
            entries = union & near[::CLUSTER]
            want = entries.sum(1)
            got = lag_cluster_entries(hi.t(), None if plo is None else plo.t(), keys,
                                      strides, CSQ, L_SHORT, half=half)
        else:
            full = segment_bands(strides, full=not half)
            C = -(-n // (CHUNK * 8)) * 8 * CHUNK
            maxj = suggest_maxj(_pad_and_desentinel(keys, C), full, half=half,
                                per_band=True)
            inp = tile_inputs(hi.t().contiguous(), keys, strides,
                              None if plo is None else plo.t().contiguous(),
                              MAXJ=maxj, bandmask=False, full=not half)
            assert bool(inp.coverage_ok)
            b = inp.bounds.long()
            jc = own // CHUNK
            cl = torch.arange(0, n, CLUSTER)
            window = torch.zeros((cl.shape[0], n), dtype=torch.bool)
            for s in range(full.shape[0]):
                first = (b[:, 3 * s] + b[:, 3 * s + 1])[cl // CHUNK, None]
                band = (jc[None, :] >= first) & (jc[None, :] < first + b[cl // CHUNK, 3 * s + 2, None])
                if half and s == 0:
                    # K6's band 0 loads no j-cluster after the own cluster
                    band &= own[None, :] // CLUSTER <= (cl // CLUSTER)[:, None]
                window |= band
            entries = window & near[::CLUSTER]
            want = entries.sum(1)
            got = tile_cluster_entries(inp, CSQ, half=half)
        assert torch.equal(got, want), (data, kernel, split)
        if data == "cluster_gap":
            # the later cluster's sweep holds the facing pair at each site
            # where it counts (at the second only in split mode)
            for s in GAP_SITES:
                if bool(counted[s + 32, s + 31]):
                    assert bool(entries[(s + 32) // CLUSTER, s + 31]), (kernel, split, s)


def test_join_prune_keeps_every_counted_pair():
    """K12's query-cluster mirror (`join_ranges`, `join_boxes`,
    `join_cluster_entries`) against brute force, on the three data sets as
    join particles (rounded to a 2^-10 grid, keyed by a fresh build at the
    cutoff), in f64 and f32: every (query, particle) pair that the join
    counts (a full-stencil key band and dsq <= cutoff^2, inclusive) lies in
    its query cluster's union range of that band and passes the inclusive
    gap test, and `join_cluster_entries` equals the entries counted by
    brute force from the queries' keys and coordinates. The queries:
    uniform over the box and a cutoff around it, at atoms (d == 0), at
    +-1e9, and apart a plane of 64 queries at an atom + (cutoff, dy, dz),
    whose clusters' boxes start exactly one cutoff from the atom, so that
    a strict gap test drops the pair at exactly the cutoff."""
    from zelll_tpu_torch.core import build
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY
    from zelll_tpu_torch.ops.cluster_prune import join_boxes, join_cluster_entries, join_ranges
    from zelll_tpu_torch.ops.join import sort_queries

    rng = np.random.default_rng(17)
    offsets = np.stack(np.meshgrid(np.arange(8), np.arange(8), indexing="ij"), -1)
    offsets = (offsets.reshape(-1, 2) - 4) / 8  # dy, dz on a 2^-3 grid, 0 among them
    for data in ("cluster_gap", "drifted", "uniform"):
        hi, lo, _, _ = _case(data, "tile")
        pts = np.round((hi.double() + lo.double()).numpy() * 1024) / 1024
        g = build(torch.as_tensor(pts), CUTOFF)
        info = g.info
        a = g.sorted_pos[N // 2].numpy()
        lo_b, hi_b = pts.min(0), pts.max(0)
        mixed = np.concatenate([rng.uniform(lo_b - CUTOFF, hi_b + CUTOFF, (400, 3)),
                                pts[rng.choice(N, 60, replace=False)],
                                [[1e9, -1e9, 1e9], [-1e9, 1e9, -1e9]] * 10])
        plane = a + np.concatenate([np.full((64, 1), CUTOFF), offsets], 1)
        assert np.any(np.all(plane - a == [CUTOFF, 0.0, 0.0], 1))
        for dtype in (torch.float64, torch.float32):
            csq = torch.tensor(CUTOFF**2, dtype=dtype)
            pp = g.sorted_pos.to(dtype).t().contiguous()
            pk = g.bins.sorted_keys.long()
            bands = segment_bands(info.strides, full=True).long()
            for tag, queries in (("mixed", mixed), ("plane", plane)):
                qp, qk, _, _ = sort_queries(torch.as_tensor(queries), info.origin, info.shape,
                                            info.strides, CUTOFF, dtype, "cpu")
                qp = torch.stack(list(qp))
                nq = qp.shape[1]
                d = [qp[ax][:, None] - pp[ax][None, :] for ax in range(3)]
                dsq = d[0] * d[0]
                dsq = dsq + d[1] * d[1]
                dsq = dsq + d[2] * d[2]
                diff = qk.long()[:, None] - pk[None, :]
                band = torch.full(diff.shape, -1)
                for s, (b_lo, b_hi) in enumerate(bands.tolist()):
                    band = torch.where((diff >= b_lo) & (diff <= b_hi), s, band)
                counted = (band >= 0) & (dsq <= csq)
                first, end = join_ranges(qk, pk, bands)
                mn, mx = join_boxes(qp, qk)
                cl = torch.arange(nq) // CLUSTER
                box = [x[:, cl, None] for x in (mn, mx)]
                near = near_cluster(*box, torch.zeros(()), pp[:, None, :], None, csq,
                                    inclusive=True)
                j = torch.arange(pp.shape[1])[None, :]
                s_of = band.clamp(min=0)
                in_range = (j >= first[cl][torch.arange(nq)[:, None], s_of]) & \
                    (j < end[cl][torch.arange(nq)[:, None], s_of])
                assert bool(counted.any()), (data, dtype, tag)
                assert not bool((counted & ~(in_range & near)).any()), (data, dtype, tag)
                # the entries by brute force: per cluster of 32 sorted
                # queries and band, the particles whose key lies in
                # [smallest key - hi_s, largest key - lo_s] and whose gap to
                # the real queries' box is at most the cutoff
                want = torch.zeros(first.shape[0], dtype=torch.int64)
                for c in range(first.shape[0]):
                    sl = slice(c * CLUSTER, min((c + 1) * CLUSTER, nq))
                    real = qk[sl] != SENTINEL_KEY
                    if not bool(real.any()):
                        continue
                    keys, pts_c = qk[sl][real].long(), qp[:, sl][:, real]
                    gap = torch.maximum(pts_c.min(1).values[:, None] - pp,
                                        pp - pts_c.max(1).values[:, None]).clamp(min=0)
                    gsq = gap[0] * gap[0]
                    gsq = gsq + gap[1] * gap[1]
                    gsq = gsq + gap[2] * gap[2]
                    for b_lo, b_hi in bands.tolist():
                        union = (pk >= keys.min() - b_hi) & (pk <= keys.max() - b_lo)
                        want[c] += int((union & (gsq <= csq)).sum())
                got = join_cluster_entries(qp, qk, pp, g.bins.sorted_keys, info.strides,
                                           CUTOFF**2)
                assert torch.equal(got, want), (data, dtype, tag)
                if tag == "plane":
                    # sharp: the pair at exactly the cutoff counts, and a
                    # strict gap test would drop it
                    exact = counted & (dsq == csq)
                    strict = near_cluster(*box, torch.zeros(()), pp[:, None, :], None, csq)
                    assert bool(exact.any()) and bool((exact & ~strict).any()), (data, dtype)
                else:
                    assert float(near.float().mean()) < 0.9  # the prune bites
