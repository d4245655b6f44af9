"""Seeded random configurations through the port's observables kernels,
held to numpy brute force. Each seed draws a dimension (1 to 3), a box
shape (cubic, thin or slab), a density, a cutoff (points closer than 0.02
cutoff are dropped, since their f32 LJ terms overflow), the coordinate
mode (f32, split f32 hi/lo far from the origin, or f64), the tile
options, a tail of padding rows (SENTINEL_KEY, far from every particle)
on odd seeds, and for the histograms 1 to 64 ascending edges and, on half
the seeds, a species pair mask. It checks:

* the plain K4 (`pair_lag_stress` at `suggest_lag`'s L) and K8
  (`tile_pair_stress`, masked or maskless, at `suggest_maxj`'s capacity):
  flag up, every component within 1e-9 of the sum of its |terms| of a
  brute force that repeats the port's per-pair rounding (so only the order
  of the f64 sums differs);
* the plain K5 (`pair_lag_hist`) and K9 (`tile_pair_hist`): flag up and
  cumulative counts exactly the brute force's.

Every sixth seed also draws a periodic box (cubic, thin or slab, each axis
over 2 cutoffs, 3-D, f64) and one of its paths in turn: ghost images on
the lag path or on the tile path (the keep mask), or ``minimage="auto"``
(the minimum image, and the keep mask where ghost axes remain). It holds
`pbc_stress_fused` to a numpy minimum-image brute force (1e-9 of each
component's sum of |terms|) and `rdf`'s counts (`rdf._pbc_cum_hist`, with
a species partial on half of them) to the brute force's exactly, on edges
no pair's f64 dsq lies within 1e-12 of.

Everything runs the plain versions on CPU tensors and calls no JAX."""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu_torch.core import SENTINEL_KEY, build
from zelll_tpu_torch.ops import segments as seg
from zelll_tpu_torch.ops.lag_pairs import (
    SpeciesPairMask,
    _pad_and_desentinel,
    combine_count_vec,
    lag_coverage_ok,
    pair_lag_hist,
    pair_lag_stress,
    split_f64,
    suggest_lag,
)
from zelll_tpu_torch.ops.rdf import _pbc_cum_hist
from zelll_tpu_torch.ops.tile_pairs import tile_pair_hist, tile_pair_stress
from zelll_tpu_torch.ops.virial import pbc_stress_fused

SEEDS = range(222)
SHAPES = {"cubic": (1.0, 1.0, 1.0), "thin": (0.25, 0.25, 4.0),
          "slab": (2.0, 2.0, 0.2)}
MODES = ("f32", "split", "f64")


def _case(seed):
    """The sorted inputs of one seed: a dict of tensors and options."""
    rng = np.random.default_rng(11000 + seed)
    dim = int(rng.integers(1, 4))
    cutoff = float(rng.uniform(0.7, 1.6))
    aspect = np.asarray(SHAPES[list(SHAPES)[seed % len(SHAPES)]][-dim:])
    mode = MODES[(seed // 2) % len(MODES)]
    n = int(rng.integers(30, 300))
    density = float(rng.uniform(0.5, 4.0))  # particles per cutoff^dim
    side = (n / density / np.prod(aspect)) ** (1.0 / dim) * cutoff
    extent = np.maximum(side * aspect, 0.5 * cutoff)
    offset = 3000.0 if mode == "split" else rng.uniform(-5, 5)
    pts = rng.uniform(0, 1, (n, dim)) * extent
    # drop the later point of each pair closer than 0.02 cutoff: LJ terms of
    # nearer pairs overflow f32 (the stress tests hold coincident pairs)
    dist = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    pts = pts[~np.triu(dist < 0.02 * cutoff, 1).any(0)] + offset
    n = len(pts)
    n_pad = int(rng.integers(1, 40)) if seed % 2 else 0
    allp = np.concatenate([pts, 1.0e6 + 100.0 * np.arange(n_pad)[:, None] * np.ones(dim)])
    if mode == "f32":
        allp = allp.astype(np.float32)
    g = build(allp, cutoff, valid=np.arange(len(allp)) < n, device="cpu")
    hi, lo = g.sorted_pos, None
    if mode == "split":
        hi, lo = split_f64(g.sorted_pos)
    species = rng.integers(0, 3, len(allp))[g.bins.perm.numpy()]
    K = int(rng.integers(1, 65))
    edges = np.sort(rng.uniform(0, cutoff, K))
    edges[-1] = cutoff
    if rng.integers(0, 2):
        edges[0] = 0.0
    return dict(
        dim=dim, cutoff=cutoff, pos=hi, lo=lo, keys=g.bins.sorted_keys,
        strides=g.info.strides, real=(g.bins.sorted_keys != SENTINEL_KEY).numpy(),
        species=species, pair=tuple(sorted(rng.integers(0, 3, 2))) if seed % 4 < 2 else None,
        edges_sq=edges.astype(np.float32 if mode != "f64" else np.float64) ** 2,
        CB=int(rng.choice([1, 2, 4])), bandmask=bool(rng.integers(0, 2)))


PBC_PATHS = (dict(path="lag", L=4096), dict(path="tile", MAXJ=64), dict(L=4096, minimage="auto"))


def _pbc_case(seed):
    """A periodic seed's inputs: (f64 points in [0, box), box, cutoff, path
    options, species, pair or None, edges), and its minimum-image pairs'
    separations (d, dsq) and species."""
    rng = np.random.default_rng(22000 + seed)
    cutoff = float(rng.uniform(0.7, 1.6))
    aspect = np.asarray(SHAPES[list(SHAPES)[seed % len(SHAPES)]])
    box = np.maximum(rng.uniform(2.5, 4.0) * aspect / aspect.min(), 2.2) * cutoff
    n = int(rng.integers(30, 300))
    pts = rng.uniform(0, 1, (n, 3)) * box
    d = pts[:, None] - pts[None]
    d -= box * np.round(d / box)
    dsq = (d * d).sum(-1)
    pts = pts[~np.triu(dsq < (0.02 * cutoff) ** 2, 1).any(0)]
    i, j = np.triu_indices(len(pts), 1)
    d = pts[j] - pts[i]
    d -= box * np.round(d / box)
    species = rng.integers(0, 3, len(pts))
    edges = np.sort(rng.uniform(0, cutoff, int(rng.integers(1, 33))))
    edges[-1] = cutoff
    pair = tuple(sorted(rng.integers(0, 3, 2))) if seed % 4 < 2 else None
    return dict(pts=pts, box=box, cutoff=cutoff, kw=PBC_PATHS[(seed // 6) % 3], d=d,
                dsq=(d * d).sum(1), si=species[i], sj=species[j], species=species,
                pair=pair, edges=edges)


def _pairs(c, mask=None):
    """(d, dsq) of every unique pair of real sorted slots in the port's
    rounding: d = p_j - p_i per axis (split: (hi_j - hi_i) + (lo_j -
    lo_i)), dsq summed axis by axis in the coordinates' dtype."""
    p = c["pos"].numpy()
    i, j = np.triu_indices(len(p), 1)
    keep = c["real"][i] & c["real"][j]
    if mask is not None:
        keep &= mask(c["species"][i], c["species"][j])
    i, j = i[keep], j[keep]
    d = p[j] - p[i]
    if c["lo"] is not None:
        lo = c["lo"].numpy()
        d = d + (lo[j] - lo[i])
    dsq = d[:, 0] * d[:, 0]
    for a in range(1, p.shape[1]):
        dsq = dsq + d[:, a] * d[:, a]
    return d, dsq


def _maxj(c):
    n = c["pos"].shape[0]
    C = max(-(-n // (seg.CHUNK * c["CB"])) * c["CB"], c["CB"]) * seg.CHUNK
    keys = _pad_and_desentinel(c["keys"], C)
    return seg.suggest_maxj(keys, seg.segment_bands(c["strides"]), per_band=True)


def _tile(fn, c, *args, **kw):
    """A tile entry point at the suggested capacity: maskless when the
    seed asks and the windows allow it (the flag), else masked."""
    kw.update(CB=c["CB"], MAXJ=_maxj(c))
    out, ok = fn(*args, bandmask=c["bandmask"], **kw)
    if c["bandmask"] or bool(ok):
        return out, ok
    # maskless tiles also need pairwise disjoint windows, which a chunk
    # straddling a key jump may lack even after the trim
    return fn(*args, bandmask=True, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_stress_vs_bruteforce(seed):
    c = _case(seed)
    t = np.float64 if c["pos"].dtype == torch.float64 else np.float32
    d, dsq = _pairs(c)
    m = (dsq < t(c["cutoff"] ** 2)) & (dsq > 0)
    d, dsq = d[m], dsq[m]
    inv = t(1) / dsq
    tt = inv * inv * inv
    g = t(24) * tt * (t(2) * tt - t(1)) * inv
    dim = c["dim"]
    ref, mag = np.zeros((dim, dim)), np.zeros((dim, dim))
    for a in range(dim):
        for b in range(a, dim):
            v = ((g * d[:, a]) * d[:, b]).astype(np.float64)
            ref[a, b] = ref[b, a] = v.sum()
            mag[a, b] = mag[b, a] = np.abs(v).sum()
    args = (c["pos"], c["keys"], c["strides"], c["cutoff"] ** 2, c["lo"])
    L = suggest_lag(c["keys"], c["strides"])
    assert bool(lag_coverage_ok(c["keys"], c["strides"], L))
    lag = pair_lag_stress(*args, L=L, out_dtype=torch.float64).numpy()
    tile, ok = _tile(tile_pair_stress, c, *args, out_dtype=torch.float64)
    assert bool(ok)
    assert np.isfinite(mag).all()
    for got in (lag, tile.numpy()):
        assert got.shape == (dim, dim)
        assert np.all(np.abs(got - ref) <= 1e-9 * mag)
    if seed % 6:
        return
    p = _pbc_case(seed)
    m = (p["dsq"] < p["cutoff"] ** 2) & (p["dsq"] > 0)
    d, dsq = p["d"][m], p["dsq"][m]
    tt = (1.0 / dsq) ** 3
    terms = (24 * tt * (2 * tt - 1) / dsq)[:, None, None] * d[:, :, None] * d[:, None, :]
    sig, ok = pbc_stress_fused(torch.as_tensor(p["pts"]), np.zeros(3), p["box"], p["cutoff"],
                               B=len(p["pts"]), G=7 * len(p["pts"]), **p["kw"])
    assert bool(ok) and sig.dtype == torch.float64
    assert np.all(np.abs(sig.numpy() - terms.sum(0)) <= 1e-9 * np.abs(terms).sum(0))


@pytest.mark.parametrize("seed", SEEDS)
def test_hist_vs_bruteforce(seed):
    c = _case(seed)
    pair, mask, payload = c["pair"], None, None
    if pair is not None:
        a, b = pair
        payload = torch.as_tensor(c["species"], dtype=c["pos"].dtype)

        def mask(wi, wj):
            return ((wi == a) & (wj == b)) | ((wi == b) & (wj == a))

    _, dsq = _pairs(c, mask)
    esq = c["edges_sq"]
    want = np.array([(dsq < e).sum() for e in esq], np.int64)
    args = (c["pos"], c["keys"], c["strides"], esq, c["lo"], payload)
    kw = dict(pair_mask=None if pair is None else SpeciesPairMask(*pair))
    L = suggest_lag(c["keys"], c["strides"])
    lag = pair_lag_hist(*args, L=L, **kw)
    tile, ok = _tile(tile_pair_hist, c, *args, **kw)
    assert bool(ok)
    np.testing.assert_array_equal(combine_count_vec(lag), want)
    np.testing.assert_array_equal(combine_count_vec(tile), want)
    if seed % 6:
        return
    p = _pbc_case(seed)
    esq, dsq = p["edges"] ** 2, p["dsq"]
    kw = dict(p["kw"])
    kw.setdefault("L", 256)
    spec = {}
    if p["pair"] is not None:
        a, b = p["pair"]
        keep = ((p["si"] == a) & (p["sj"] == b)) | ((p["si"] == b) & (p["sj"] == a))
        dsq = dsq[keep]
        if kw.get("path") == "tile":  # one payload row on tile: the lag path
            kw = dict(L=4096)
        spec = dict(species=p["species"], pair=p["pair"])
    assert np.abs(dsq[:, None] - esq[None, :]).min() > 1e-12
    packed, ok = _pbc_cum_hist(torch.as_tensor(p["pts"]), np.zeros(3), p["box"], p["edges"],
                               positions_lo=None, B=len(p["pts"]), G=7 * len(p["pts"]),
                               M=1024, **spec, **kw)
    assert bool(ok)
    np.testing.assert_array_equal(combine_count_vec(packed),
                                  np.array([(dsq < e).sum() for e in esq], np.int64))
