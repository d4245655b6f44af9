"""The port's window bounds (zelll_tpu_torch.ops.segments) against the JAX
package's on identical sorted keys: stencil bands, per-chunk windows,
capacity probes, the disjoint trim and its flag. Everything here is
integer, so everything must agree exactly.

The JAX functions are jitted once per static configuration, to keep the
number of XLA:CPU executables in a test worker small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.ops import segments as jseg
from zelll_tpu.ops.pallas_pairs import _pad_and_desentinel as jax_pad
from zelll_tpu_torch.core import SENTINEL_KEY, bin_and_sort
from zelll_tpu_torch.ops import segments as seg
from zelll_tpu_torch.ops.lag_pairs import _pad_and_desentinel

_jax_bands = jax.jit(jseg.segment_bands, static_argnames="full")
_jax_bounds = jax.jit(jseg.chunk_bounds, static_argnames=("max_j", "half", "groups"))
_jax_trim = jax.jit(jseg.trim_windows_disjoint, static_argnames="order")
_jax_disjoint = jax.jit(jseg.windows_disjoint)
CB = 2  # the padding granule of the tile entry points in these tests


def _padded(n: int) -> int:
    return max(-(-n // (seg.CHUNK * CB)) * CB, CB) * seg.CHUNK


def _sorted_keys(pts, auto_order=True):
    bins, _ = bin_and_sort(torch.as_tensor(pts), 1.0, need_perm=False,
                           auto_order=auto_order)
    return bins.sorted_keys.numpy(), bins.info.strides.numpy()


@pytest.fixture(scope="module")
def cubic():
    """A cubic cloud at ~3 per cell whose n is not a multiple of 128, so
    one chunk straddles the real->padding boundary."""
    pts = np.random.default_rng(5).uniform(0, 10.0, (3000, 3))
    keys, strides = _sorted_keys(pts)
    return _padded_keys(keys), strides


def _padded_keys(keys):
    return _pad_and_desentinel(torch.as_tensor(keys), _padded(len(keys))).numpy()


@pytest.fixture(scope="module")
def straddle():
    """12 x 12 x 3 cells at exactly 40 per cell (tests/test_tile_maskless.py):
    every ~8th chunk straddles a y-row or z-layer key jump, so band
    windows overlap before the trim."""
    rng = np.random.default_rng(0)
    base = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(3),
                                indexing="ij"), -1).reshape(-1, 3)
    pts = np.repeat(base, 40, axis=0) + rng.uniform(0.02, 0.98, (len(base) * 40, 3))
    keys, strides = _sorted_keys(pts, auto_order=False)
    return _padded_keys(keys), strides


@pytest.mark.parametrize("full", [False, True], ids=["half", "full"])
@pytest.mark.parametrize("strides", [[1], [1, 9], [1, 9, 117], [143, 1, 11]],
                         ids=["1d", "2d", "3d", "3d_auto_order"])
def test_segment_bands_match_jax(strides, full):
    want = np.asarray(_jax_bands(jnp.asarray(strides, jnp.int32), full=full))
    got = seg.segment_bands(torch.tensor(strides, dtype=torch.int32), full=full)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dim = len(strides)
    assert got.shape[0] == seg.num_segments(dim, full) == jseg.num_segments(dim, full)
    assert seg.band_order(dim, full) == jseg.band_order(dim, full)


def test_pad_and_desentinel_matches_jax():
    keys = np.sort(np.random.default_rng(1).integers(0, 5000, 1000)).astype(np.int32)
    keys[-100:] = SENTINEL_KEY
    ntot = _padded(len(keys))
    want = np.asarray(jax_pad(jnp.asarray(keys), ntot))
    got = _pad_and_desentinel(torch.as_tensor(keys), ntot)
    np.testing.assert_array_equal(got.numpy(), want)


def _both_bounds(keys, bands_full, **kw):
    strides_bands = seg.segment_bands(torch.as_tensor(bands_full[0]), full=bands_full[1])
    got = seg.chunk_bounds(torch.as_tensor(keys), strides_bands, **kw)
    want = _jax_bounds(jnp.asarray(keys), jnp.asarray(strides_bands.numpy()), **kw)
    return got, want


@pytest.mark.parametrize("kw", [
    dict(max_j=6),
    dict(max_j=(2, 5, 4, 5, 4)),
    dict(max_j=1),  # undersized: the flag drops, the windows clamp
    dict(max_j=7, half=False, full=True),
    dict(max_j=6, groups=4),
], ids=["scalar", "per_band", "undersized", "full_stencil", "groups4"])
def test_chunk_bounds_match_jax(cubic, kw):
    keys, strides = cubic
    kw = dict(kw)
    full = kw.pop("full", False)
    got, want = _both_bounds(keys, (strides, full), **kw)
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[-1]) == bool(want[-1]) == (kw["max_j"] != 1)


def test_padding_tail_chunk_windows(cubic):
    """The chunk holding the last real slots takes its window from its real
    keys only; padding-only chunks get empty windows."""
    keys, strides = cubic
    n_real = 3000
    bands = seg.segment_bands(torch.as_tensor(strides))
    nc = len(keys) // seg.CHUNK
    jlo, toff, jnum, ok = seg.chunk_bounds(torch.as_tensor(keys), bands, max_j=nc)
    straddle_chunk = n_real // seg.CHUNK
    assert bool(ok) and 0 < n_real % seg.CHUNK
    assert (jnum[straddle_chunk + 1:] == 0).all()
    # no wider than the windows of the real chunks before it
    assert int(jnum[straddle_chunk].max()) <= int(jnum[:straddle_chunk].max())


@pytest.mark.parametrize("per_band", [False, True])
def test_suggest_maxj_matches_jax_windows(cubic, per_band):
    """suggest_maxj is the widest window at full capacity: computed here
    from the JAX package's windows."""
    keys, strides = cubic
    bands = seg.segment_bands(torch.as_tensor(strides))
    nc = len(keys) // seg.CHUNK
    jnum = np.asarray(_jax_bounds(jnp.asarray(keys), jnp.asarray(bands.numpy()),
                                  max_j=nc)[2])
    want = tuple(max(int(v), 1) for v in jnum.max(0)) if per_band \
        else max(int(jnum.max()), 1)
    assert seg.suggest_maxj(torch.as_tensor(keys), bands, per_band=per_band) == want


@pytest.mark.parametrize("full", [False, True], ids=["half", "full"])
def test_trim_and_disjoint_match_jax(straddle, full):
    keys, strides = straddle
    got, want = _both_bounds(keys, (strides, full), max_j=24, half=not full)
    jlo, toff, jnum, ok = got
    wjlo, wtoff, wjnum, _ = want
    assert bool(ok)
    order = seg.band_order(3, full)
    before = seg.windows_disjoint(jlo, toff, jnum)
    assert bool(before) == bool(_jax_disjoint(wjlo, wtoff, wjnum))
    assert not bool(before)  # straddling chunks overlap until trimmed
    t2, n2 = seg.trim_windows_disjoint(jlo, toff, jnum, order)
    wt2, wn2 = _jax_trim(wjlo, wtoff, wjnum, order=order)
    np.testing.assert_array_equal(t2.numpy(), np.asarray(wt2))
    np.testing.assert_array_equal(n2.numpy(), np.asarray(wn2))
    assert bool(seg.windows_disjoint(jlo, t2, n2)) == bool(_jax_disjoint(wjlo, wt2, wn2))
    assert bool(seg.windows_disjoint(jlo, t2, n2))
    # coverage-preserving: the trimmed windows cover the same chunks
    for c in range(0, len(keys) // seg.CHUNK, 7):
        cover = lambda t, n: {int(jlo[c, s] + t[c, s] + k)  # noqa: E731
                              for s in range(jlo.shape[1]) for k in range(int(n[c, s]))}
        assert cover(t2, n2) == cover(toff, jnum)
