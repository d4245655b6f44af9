"""K1's plain version (zelll_tpu_torch.ops.lag_pairs) against the JAX
package's `pair_lag_reduce` (Pallas, interpret mode) on identical sorted
inputs, carried across with `zelll_tpu_torch.convert`, and against brute
force. The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_kernels.py and by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelll_tpu.core import build as jax_build
from zelll_tpu.ops.pallas_pairs import count_term as jax_count_term
from zelll_tpu.ops.pallas_pairs import lag_coverage_ok as jax_coverage_ok
from zelll_tpu.ops.pallas_pairs import pair_lag_reduce as jax_pair_lag_reduce
from zelll_tpu.ops.pallas_pairs import suggest_lag as jax_suggest_lag
from zelll_tpu_torch.convert import grid_from_numpy, sorted_inputs_from_numpy
from zelll_tpu_torch.core import build
from zelll_tpu_torch.ops.fused import fused_count_pairs, fused_lj_energy
from zelll_tpu_torch.ops.lag_pairs import (
    combine_count,
    count_term,
    lag_coverage_ok,
    pair_lag_reduce,
    split_f64,
    suggest_lag,
)

M = 512  # the JAX kernel's block rows (no effect on the port)


@functools.partial(jax.jit, static_argnames=("cutoff",))
def _jax_grid(pts, valid, cutoff):
    return jax_build(pts, cutoff, valid=valid)


def brute(pts, cutoff):
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    v = dsq[np.triu_indices(len(pts), 1)]
    return v[v < cutoff**2]


def lj_sum(v):
    t3 = (1.0 / v) ** 3
    return (4.0 * t3 * (t3 - 1.0)).sum()


def _inputs(g):
    """(sorted_pos, sorted_keys, strides) of a JAX grid as numpy arrays."""
    return (np.array(g.sorted_pos), np.array(g.bins.sorted_keys),
            np.array(g.info.strides))


@pytest.fixture(scope="module")
def thin():
    """Thin box, f64, sorted by the JAX package (stable sort)."""
    rng = np.random.default_rng(17)
    pts = rng.uniform(0, 1, (2000, 3)) * np.asarray([4.0, 4.0, 40.0])
    g = _jax_grid(jnp.asarray(pts), None, 1.0)
    pos, keys, strides = _inputs(g)
    L = suggest_lag(keys, strides)
    return dict(pts=pts, g=g, pos=pos, keys=keys, strides=strides, L=L,
                perm=np.asarray(g.bins.perm))


def test_lj_f64_matches_jax(thin):
    pos, keys, strides, L = thin["pos"], thin["keys"], thin["strides"], thin["L"]
    want = float(jax_pair_lag_reduce(jnp.asarray(pos), jnp.asarray(keys),
                                     jnp.asarray(strides), 1.0, M=M, L=L,
                                     interpret=True))
    p, k, s, _ = sorted_inputs_from_numpy(pos, None, keys, strides, device="cpu")
    got = pair_lag_reduce(p, k, s, 1.0, M=M, L=L)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-11)
    np.testing.assert_allclose(float(got), lj_sum(brute(thin["pts"], 1.0)), rtol=1e-11)


def test_count_matches_jax(thin):
    pos, keys, strides, L = thin["pos"], thin["keys"], thin["strides"], thin["L"]
    want = jax_pair_lag_reduce(jnp.asarray(pos), jnp.asarray(keys),
                               jnp.asarray(strides), 1.0, M=M, L=L,
                               term=jax_count_term,
                               out_dtype=jnp.int32, interpret=True)
    p, k, s, _ = sorted_inputs_from_numpy(pos, None, keys, strides, device="cpu")
    got = pair_lag_reduce(p, k, s, 1.0, M=M, L=L, term=count_term,
                          out_dtype=torch.int32)
    assert got.dtype == torch.int32 and got.shape == (2,)
    assert combine_count(got) == combine_count(np.asarray(want))
    assert combine_count(got) == len(brute(thin["pts"], 1.0))


def test_split_f32_matches_jax(thin):
    hi, lo = split_f64(torch.as_tensor(thin["pts"][thin["perm"]]))
    keys, strides, L = thin["keys"], thin["strides"], thin["L"]
    want = float(jax_pair_lag_reduce(jnp.asarray(hi.numpy()), jnp.asarray(keys),
                                     jnp.asarray(strides), 1.0, jnp.asarray(lo.numpy()),
                                     M=M, L=L, interpret=True))
    got = pair_lag_reduce(hi, torch.as_tensor(keys), torch.as_tensor(strides), 1.0, lo,
                          M=M, L=L)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(got), lj_sum(brute(thin["pts"], 1.0)), rtol=1e-6)


def test_block_rows_have_no_effect(thin):
    p, k, s, _ = sorted_inputs_from_numpy(thin["pos"], None, thin["keys"],
                                          thin["strides"], device="cpu")
    a = pair_lag_reduce(p, k, s, 1.0, M=512, L=thin["L"])
    b = pair_lag_reduce(p, k, s, 1.0, M=16384, L=thin["L"])
    assert float(a) == float(b)


def test_undersized_lag_matches_jax():
    # one cell holds every particle: each pair is in the key window at any lag
    pts = np.random.default_rng(3).uniform(0, 0.9, (400, 3))
    g = _jax_grid(jnp.asarray(pts), None, 1.0)
    pos, keys, strides = _inputs(g)
    L = 128
    jargs = (jnp.asarray(pos), jnp.asarray(keys), jnp.asarray(strides), 1.0)
    want_e = float(jax_pair_lag_reduce(*jargs, M=M, L=L, interpret=True))
    want_c = jax_pair_lag_reduce(*jargs, M=M, L=L, term=jax_count_term,
                                 out_dtype=jnp.int32, interpret=True)
    want_ok = bool(jax_coverage_ok(jnp.asarray(keys), jnp.asarray(strides), L))

    p, k, s, _ = sorted_inputs_from_numpy(pos, None, keys, strides, device="cpu")
    got_e = pair_lag_reduce(p, k, s, 1.0, M=M, L=L)
    got_c = pair_lag_reduce(p, k, s, 1.0, M=M, L=L, term=count_term,
                            out_dtype=torch.int32)
    assert not want_ok and not bool(lag_coverage_ok(k, s, L))
    assert combine_count(got_c) == combine_count(np.asarray(want_c))
    # lags stop at L: pairs with a lag above L are left out on both sides
    assert combine_count(got_c) < len(brute(pts, 1.0))
    np.testing.assert_allclose(float(got_e), want_e, rtol=1e-11)


def test_sentinel_padded_grid():
    """valid=False rows carry SENTINEL_KEY: they neither inflate the lag
    bound, nor flag coverage, nor add pairs."""
    rng = np.random.default_rng(7)
    n, n_pad, cutoff = 1500, 2048, 1.0
    pts = rng.uniform(0, 1, (n, 3)) * np.asarray([3.0, 3.0, 50.0])
    padded = np.empty((n_pad, 3))
    padded[:n] = pts
    padded[n:] = (1e12 + 1e5 * np.arange(1, n_pad - n + 1))[:, None]
    valid = np.arange(n_pad) < n

    jg = _jax_grid(jnp.asarray(padded), jnp.asarray(valid), cutoff)
    L = suggest_lag(np.asarray(jg.bins.sorted_keys), np.asarray(jg.info.strides))
    grid_pad = grid_from_numpy(jg, device="cpu")
    grid = build(pts, cutoff, device="cpu")
    assert L == suggest_lag(grid.bins.sorted_keys, grid.info.strides)

    want = float(jax_pair_lag_reduce(jg.sorted_pos, jg.bins.sorted_keys,
                                     jg.info.strides, cutoff**2, M=M, L=L,
                                     interpret=True))
    e_pad, ok_pad = fused_lj_energy(grid_pad, M=M, L=L)
    e, ok = fused_lj_energy(grid, M=M, L=L)
    assert bool(ok_pad) and bool(ok) and np.isfinite(float(e_pad))
    np.testing.assert_allclose(float(e_pad), want, rtol=1e-11)
    np.testing.assert_allclose(float(e_pad), float(e), rtol=1e-12)
    c_pad, _ = fused_count_pairs(grid_pad, M=M, L=L)
    c, _ = fused_count_pairs(grid, M=M, L=L)
    assert c_pad == c == len(brute(pts, cutoff))


@pytest.mark.parametrize("n,box,cutoff,L_max", [
    (700, (6.0, 6.0, 6.0), 1.0, 512),
    (400, (2.0, 2.0, 80.0), 2.0, 256),     # thin (bench-like) box
    (300, (10.0, 10.0, 10.0), 3.0, 512),   # big cutoff, heavy window
    (64, (1.0, 1.0, 1.0), 0.4, 256),       # dense clump
])
def test_fused_count_and_energy_vs_bruteforce(n, box, cutoff, L_max):
    pts = np.random.default_rng(n).uniform(0, 1, (n, 3)) * np.asarray(box)
    grid = build(pts, cutoff, device="cpu")
    L = min(suggest_lag(grid.bins.sorted_keys, grid.info.strides), L_max)
    v = brute(pts, cutoff)
    cnt, ok = fused_count_pairs(grid, L=L)
    assert bool(ok) and cnt == len(v)
    e, ok = fused_lj_energy(grid, L=L)
    np.testing.assert_allclose(float(e), lj_sum(v), rtol=1e-11)


def test_two_dimensional_points_vs_bruteforce():
    pts = np.random.default_rng(2).uniform(0, 1, (600, 2)) * [4.0, 60.0]
    grid = build(pts, 1.0, device="cpu")
    L = suggest_lag(grid.bins.sorted_keys, grid.info.strides)
    v = brute(pts, 1.0)
    cnt, ok = fused_count_pairs(grid, L=L)
    assert bool(ok) and cnt == len(v)
    np.testing.assert_allclose(float(fused_lj_energy(grid, L=L)[0]), lj_sum(v), rtol=1e-11)


def test_coverage_and_suggest_lag_match_jax():
    pts = np.random.default_rng(9).uniform(0, 1, (1000, 3)) * [2.0, 2.0, 6.0]
    g = _jax_grid(jnp.asarray(pts), None, 1.0)
    _, keys, strides = _inputs(g)
    cov = jax.jit(jax_coverage_ok, static_argnames="L")
    for granule in (64, 128):
        assert suggest_lag(keys, strides, granule) == jax_suggest_lag(keys, strides, granule)
    for L in (64, 128, 256, 512):
        want = bool(cov(jnp.asarray(keys), jnp.asarray(strides), L=L))
        assert bool(lag_coverage_ok(torch.as_tensor(keys), torch.as_tensor(strides), L)) == want


def test_plain_takes_any_term(thin):
    p, k, s, _ = sorted_inputs_from_numpy(thin["pos"], None, thin["keys"],
                                          thin["strides"], device="cpu")
    got = pair_lag_reduce(p, k, s, 1.0, L=thin["L"], term=lambda d: d)
    np.testing.assert_allclose(float(got), brute(thin["pts"], 1.0).sum(), rtol=1e-12)
