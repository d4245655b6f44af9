"""Seeded random configurations through the port's forces, held to numpy
brute force. Each seed draws a dimension (1 to 3), a box shape (cubic,
thin or slab), a density, a cutoff, the tile options, and on odd seeds a
tail of padding rows (SENTINEL_KEY, far from every particle, as a caller
pads to a capacity), and checks:

* the full-stencil windows of `ops.segments.chunk_bounds` (half=False):
  every ordered cutoff pair (i, j != i) lies in exactly one (band,
  j-chunk) window of i's chunk, with its key difference in that band;
* K3's plain version (`pair_lag_forces_plain`, any dimension) at
  `suggest_lag`'s L: flag up, forces to 1e-9 of the largest, padding rows
  untouched, and Newton's third law (the forces sum to zero);
* K7's plain version (`tile_pair_forces`, masked or maskless) at the
  capacity `suggest_maxj(half=False)` gives: the same three.

Everything runs on CPU tensors and calls no JAX."""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu_torch.core import build
from zelll_tpu_torch.ops import segments as seg
from zelll_tpu_torch.ops.lag_pairs import (
    _pad_and_desentinel,
    lag_coverage_ok,
    pair_lag_forces_plain,
    suggest_lag,
)
from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces

SEEDS = range(40)
SHAPES = {"cubic": (1.0, 1.0, 1.0), "thin": (0.25, 0.25, 4.0),
          "slab": (2.0, 2.0, 0.2)}


def _config(seed):
    """(points, padding rows, cutoff, CB, bandmask) of one seed."""
    rng = np.random.default_rng(9000 + seed)
    dim = int(rng.integers(1, 4))
    cutoff = float(rng.uniform(0.7, 1.6))
    aspect = np.asarray(SHAPES[list(SHAPES)[seed % len(SHAPES)]][-dim:])
    n = int(rng.integers(40, 600))
    density = float(rng.uniform(0.5, 3.0))  # particles per cutoff^dim
    side = (n / density / np.prod(aspect)) ** (1.0 / dim) * cutoff
    extent = np.maximum(side * aspect, 0.5 * cutoff)
    pts = rng.uniform(0, 1, (n, dim)) * extent - rng.uniform(-5, 5, dim)
    n_pad = int(rng.integers(1, 60)) if seed % 2 else 0
    pad = 1.0e6 + 100.0 * np.arange(n_pad)[:, None] * np.ones(dim)
    return pts, pad, cutoff, int(rng.choice([1, 2, 4])), bool(rng.integers(0, 2))


def _brute(pts, cutoff):
    """(n, dim) f64 LJ forces over all cutoff partners."""
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    m = (dsq < cutoff**2) & ~np.eye(len(pts), dtype=bool)
    inv = np.where(m, 1.0 / np.where(m, dsq, 1.0), 0.0)
    t = inv**3
    return (d * np.where(m, 24 * t * (2 * t - 1) * inv, 0.0)[..., None]).sum(1)


def _grid(seed):
    """The sorted grid of one seed (padding rows sort last) and the brute
    forces in its sorted order, zero on padding rows."""
    pts, pad, cutoff, CB, bandmask = _config(seed)
    allp = np.concatenate([pts, pad])
    g = build(allp, cutoff, valid=np.arange(len(allp)) < len(pts), device="cpu")
    perm = g.bins.perm.numpy()
    ref = np.concatenate([_brute(pts, cutoff), np.zeros_like(pad)])[perm]
    return g, ref, cutoff, CB, bandmask


def _check(f, ref):
    f = f.numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(f, ref, rtol=0, atol=1e-9 * scale)
    # Newton's third law: every pair adds equal and opposite terms
    np.testing.assert_allclose(f.sum(0), 0.0, atol=1e-9 * np.abs(f).sum())


def _maxj(g, CB):
    n = g.sorted_pos.shape[0]
    C = max(-(-n // (seg.CHUNK * CB)) * CB, CB) * seg.CHUNK
    keys = _pad_and_desentinel(g.bins.sorted_keys, C)
    return keys, seg.segment_bands(g.info.strides, full=True)


@pytest.mark.parametrize("seed", SEEDS)
def test_full_windows_hold_every_ordered_pair_once(seed):
    g, ref, cutoff, CB, _ = _grid(seed)
    keys, bands = _maxj(g, CB)
    nc = keys.shape[0] // seg.CHUNK
    jlo, toff, jnum, ok = seg.chunk_bounds(keys, bands, max_j=nc, half=False)
    assert bool(ok)
    sp = g.sorted_pos.numpy()
    d = sp[:, None] - sp[None, :]
    i, j = np.nonzero(((d * d).sum(-1) < cutoff**2) & ~np.eye(len(sp), dtype=bool))
    assert len(i) > 0
    k = keys.numpy().astype(np.int64)
    diff = k[i] - k[j]
    lo, hi = bands.numpy().astype(np.int64).T
    start = (jlo + toff).numpy()[i // seg.CHUNK]  # (pairs, S)
    end = start + jnum.numpy()[i // seg.CHUNK]
    cj = (j // seg.CHUNK)[:, None]
    hits = (diff[:, None] >= lo) & (diff[:, None] <= hi) & (cj >= start) & (cj < end)
    assert (hits.sum(1) == 1).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_lag_forces_vs_bruteforce(seed):
    g, ref, cutoff, _, _ = _grid(seed)
    keys, strides = g.bins.sorted_keys, g.info.strides
    L = suggest_lag(keys, strides)
    assert bool(lag_coverage_ok(keys, strides, L))
    _check(pair_lag_forces_plain(g.sorted_pos, keys, strides, cutoff**2, L=L), ref)


@pytest.mark.parametrize("seed", SEEDS)
def test_tile_forces_vs_bruteforce(seed):
    g, ref, cutoff, CB, bandmask = _grid(seed)
    keys, bands = _maxj(g, CB)
    maxj = seg.suggest_maxj(keys, bands, half=False, per_band=True)
    args = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, cutoff**2)
    f, ok = tile_pair_forces(*args, CB=CB, MAXJ=maxj, bandmask=bandmask)
    if not bandmask and not bool(ok):
        # maskless tiles also need pairwise disjoint windows, which a chunk
        # straddling a key jump may lack even after the trim: the flag drops
        # there, and the masked tiles must hold every pair
        f, ok = tile_pair_forces(*args, CB=CB, MAXJ=maxj, bandmask=True)
    assert bool(ok)
    assert f.dtype == torch.float64
    _check(f, ref)
