"""Seeded random configurations through the port's pair paths, held to
numpy brute force (the port's side of tests/test_fuzz.py). Each seed draws
a dimension (1 to 3), a box shape (cubic, thin or slab), a density, a
cutoff and the tile options, and checks:

* the band windows of `ops.segments.chunk_bounds`: every cutoff pair
  (j < i by slot) lies in exactly one (band, j-chunk) window of i's chunk,
  with its key difference in that band;
* the tile reduction (`tile_pair_reduce`) at the capacity `suggest_maxj`
  gives: flag up, exact count, LJ energy to 1e-9 (f64 sums in another
  order);
* the lag step (`fused_lj_rebuild_energy`) at `suggest_lag`'s L: flag up,
  exact count, LJ energy to 1e-9.

Everything runs the plain versions on CPU tensors and calls no JAX."""

import numpy as np
import pytest
import torch

from zelll_tpu_torch.core import build
from zelll_tpu_torch.ops import segments as seg
from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
from zelll_tpu_torch.ops.lag_pairs import (
    _pad_and_desentinel,
    combine_count,
    count_term,
    suggest_lag,
)
from zelll_tpu_torch.ops.tile_pairs import tile_count_pairs, tile_lj_energy

SEEDS = range(35)
SHAPES = {"cubic": (1.0, 1.0, 1.0), "thin": (0.25, 0.25, 4.0),
          "slab": (2.0, 2.0, 0.2)}


def _config(seed):
    """(points, cutoff, CB, bandmask) of one seeded configuration."""
    rng = np.random.default_rng(7000 + seed)
    dim = int(rng.integers(1, 4))
    cutoff = float(rng.uniform(0.7, 1.6))
    shape = list(SHAPES)[seed % len(SHAPES)]
    aspect = np.asarray(SHAPES[shape][-dim:])
    n = int(rng.integers(40, 800))
    density = float(rng.uniform(0.5, 4.0))  # particles per cutoff^dim
    side = (n / density / np.prod(aspect)) ** (1.0 / dim) * cutoff
    extent = np.maximum(side * aspect, 0.5 * cutoff)
    pts = rng.uniform(0, 1, (n, dim)) * extent - rng.uniform(-5, 5, dim)
    CB = int(rng.choice([1, 2, 4]))
    bandmask = bool(rng.integers(0, 2))
    return pts, cutoff, CB, bandmask


def _brute(pts, cutoff):
    """(pair count, LJ energy) over unique pairs, f64."""
    d = pts[:, None] - pts[None, :]
    dsq = (d * d).sum(-1)
    m = (dsq < cutoff**2) & np.tri(len(pts), k=-1, dtype=bool)
    t = np.where(m, 1.0 / np.where(m, dsq, 1.0), 0.0) ** 3
    return int(m.sum()), float((4 * t * (t - 1)).sum())


def _padded(g, CB):
    n = g.sorted_pos.shape[0]
    return _pad_and_desentinel(g.bins.sorted_keys,
                               max(-(-n // (seg.CHUNK * CB)) * CB, CB) * seg.CHUNK)


@pytest.mark.parametrize("seed", SEEDS)
def test_band_windows_hold_every_pair_once(seed):
    pts, cutoff, CB, _ = _config(seed)
    g = build(pts, cutoff, device="cpu")
    keys = _padded(g, CB)
    bands = seg.segment_bands(g.info.strides)
    nc = keys.shape[0] // seg.CHUNK
    jlo, toff, jnum, ok = seg.chunk_bounds(keys, bands, max_j=nc)
    assert bool(ok)
    sp = g.sorted_pos.numpy()
    d = sp[:, None] - sp[None, :]
    i, j = np.nonzero(((d * d).sum(-1) < cutoff**2) & np.tri(len(sp), k=-1, dtype=bool))
    k = keys.numpy().astype(np.int64)
    diff = k[i] - k[j]
    lo, hi = bands.numpy().astype(np.int64).T
    start = (jlo + toff).numpy()[i // seg.CHUNK]  # (pairs, S)
    end = start + jnum.numpy()[i // seg.CHUNK]
    cj = (j // seg.CHUNK)[:, None]
    hits = (diff[:, None] >= lo) & (diff[:, None] <= hi) & (cj >= start) & (cj < end)
    assert (hits.sum(1) == 1).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_tile_reduce_vs_bruteforce(seed):
    pts, cutoff, CB, bandmask = _config(seed)
    g = build(pts, cutoff, device="cpu")
    bands = seg.segment_bands(g.info.strides)
    maxj = seg.suggest_maxj(_padded(g, CB), bands, per_band=True)
    args = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, cutoff**2)
    kw = dict(CB=CB, MAXJ=maxj, bandmask=bandmask)
    e, ok = tile_lj_energy(*args, **kw)
    if not bandmask and not bool(ok):
        # maskless tiles also need pairwise disjoint windows, which a chunk
        # straddling a key jump may lack even after the trim: the flag drops
        # there, and the masked tiles must hold every pair
        kw["bandmask"] = True
        e, ok = tile_lj_energy(*args, **kw)
    c, okc = tile_count_pairs(*args, **kw)
    n_ref, e_ref = _brute(g.sorted_pos.numpy(), cutoff)
    assert bool(ok) and bool(okc)
    assert combine_count(c) == n_ref
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_lag_step_vs_bruteforce(seed):
    pts, cutoff, _, _ = _config(seed)
    g = build(pts, cutoff, device="cpu")
    L = suggest_lag(g.bins.sorted_keys, g.info.strides)
    e, ok = fused_lj_rebuild_energy(pts, cutoff, L=L, device="cpu")
    c, okc = fused_lj_rebuild_energy(pts, cutoff, L=L, term=count_term,
                                     out_dtype=torch.int32, device="cpu")
    n_ref, e_ref = _brute(pts, cutoff)
    assert bool(ok) and bool(okc)
    assert combine_count(c) == n_ref
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-9, atol=1e-12)
