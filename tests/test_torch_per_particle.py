"""K2's plain version (`zelll_tpu_torch.ops.lag_pairs.
pair_lag_per_particle` on CPU tensors) against the JAX package's K2
(Pallas, interpret mode) on identical sorted inputs, and against brute
force. The CUDA kernel itself is held to the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py.

Two JAX configurations (interpret mode is costly), one with an undersized
lag bound; elsewhere brute force, as tests/test_per_particle.py holds the
JAX kernel to it. Tolerances: counts exact; f64 LJ sums to 1e-12 of the
largest (the same terms summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.core import build as jax_build
from zelll_tpu.ops.pallas_pairs import count_term as jax_count
from zelll_tpu.ops.pallas_pairs import lj_term as jax_lj
from zelll_tpu.ops.pallas_pairs import pair_lag_per_particle as jax_k2
from zelll_tpu_torch.core import SENTINEL_KEY, build
from zelll_tpu_torch.ops.lag_pairs import (
    _lag_per_particle_cuda,
    count_term,
    lag_coverage_ok,
    lj_term,
    pair_lag_per_particle,
    suggest_lag,
)


def _brute(pts, cutoff, valid=None):
    """Coordination numbers and per-particle LJ sums (both ends of every
    pair with 0 < dsq < cutoff^2), input order, f64."""
    d = pts[:, None] - pts[None, :]
    dsq = (d * d).sum(-1)
    mask = (dsq < cutoff**2) & (dsq > 0)
    if valid is not None:
        mask &= valid[:, None] & valid[None, :]
    t3 = np.where(mask, 1.0 / np.where(mask, dsq, 1.0), 0.0) ** 3
    return mask.sum(1), np.where(mask, 4 * t3 * (t3 - 1), 0.0).sum(1)


@pytest.mark.parametrize("L", [256, 128], ids=["covered", "undersized"])
def test_plain_matches_jax(L):
    """The JAX kernel and the plain version on the same sorted grid: at a
    covering L both equal brute force; at an undersized L both drop the
    same pairs (the lag set is exactly 1..L in both)."""
    rng = np.random.default_rng(L)
    n, cutoff = 1500, 1.0
    pts = rng.uniform(0, 1, (n, 3)) * np.array([8.0, 8.0, 10.0])
    g = jax.jit(lambda p: jax_build(p, cutoff))(jnp.asarray(pts))
    args = [np.array(a) for a in (g.sorted_pos, g.bins.sorted_keys, g.info.strides)]
    covered = bool(lag_coverage_ok(torch.as_tensor(args[1]), args[2], L))
    assert covered == (L == 256)
    perm = np.asarray(g.bins.perm)
    coord, energy = _brute(pts, cutoff)
    for jt, pt in ((jax_count, count_term), (jax_lj, lj_term)):
        want = np.asarray(jax_k2(g.sorted_pos, g.bins.sorted_keys, g.info.strides,
                                 cutoff**2, M=1024, L=L, term=jt, interpret=True))
        got = pair_lag_per_particle(*(torch.as_tensor(a) for a in args), cutoff**2,
                                    L=L, term=pt)
        assert got.dtype == torch.float64
        if pt is count_term:
            np.testing.assert_array_equal(got.numpy(), want)
            if covered:
                np.testing.assert_array_equal(got.numpy(), coord[perm])
            else:
                assert got.sum() < coord.sum()
        else:
            scale = np.abs(want).max()
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * scale)
            if covered:
                np.testing.assert_allclose(got.numpy(), energy[perm], rtol=0,
                                           atol=1e-12 * scale)


@pytest.mark.parametrize("case", ["f32", "sentinel_tail", "coincident", "tiny"])
def test_plain_matches_bruteforce(case):
    """f32 coordinates (counts exact), padding rows with SENTINEL_KEY keys
    and far coordinates (inert), coincident particles (excluded, as in
    the kernel), and 0, 1 and 2 particles."""
    rng = np.random.default_rng(7)
    cutoff = 1.0
    if case == "tiny":
        for n in (0, 1, 2):
            pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]])[:n]
            g = build(pts, cutoff, device="cpu")
            out = pair_lag_per_particle(g.sorted_pos, g.bins.sorted_keys,
                                        g.info.strides, 1.0)
            assert out.tolist() == [float(n == 2)] * n
        return
    n = 1200
    pts = rng.uniform(0, 1, (n, 3)) * np.array([5.0, 5.0, 30.0])
    valid = None
    if case == "coincident":
        pts[1::7] = pts[::7][: len(pts[1::7])]
    if case == "sentinel_tail":
        valid = np.arange(n) < n - 100
        k = np.arange(100, dtype=np.float64)
        pts[~valid] = 1e12 + np.stack([k * 2.0**17, k * 0, k * 0], 1)
    dtype = torch.float32 if case == "f32" else torch.float64
    g = build(torch.as_tensor(pts, dtype=dtype), cutoff, device="cpu",
              valid=None if valid is None else torch.as_tensor(valid))
    if valid is not None:
        assert (g.bins.sorted_keys[-100:] == SENTINEL_KEY).all()
    L = suggest_lag(g.bins.sorted_keys, g.info.strides)
    sp = g.sorted_pos.to(torch.float64).numpy()
    coord, energy = _brute(sp, cutoff)
    if valid is not None:
        coord, energy = _brute(sp, cutoff, g.bins.sorted_keys.numpy() != SENTINEL_KEY)
    got = pair_lag_per_particle(g.sorted_pos, g.bins.sorted_keys, g.info.strides,
                                cutoff**2, L=L)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), coord)
    if case != "f32":
        e = pair_lag_per_particle(g.sorted_pos, g.bins.sorted_keys, g.info.strides,
                                  cutoff**2, L=L, term=lj_term)
        np.testing.assert_allclose(e.numpy(), energy, rtol=0,
                                   atol=1e-12 * np.abs(energy).max())


def test_refusals():
    """3-D only on either device, L >= 1, and the CUDA path takes only the
    kernel's two terms and dtypes (checked before anything launches)."""
    pts = torch.as_tensor(np.random.default_rng(1).uniform(0, 3, (50, 3)))
    keys = torch.zeros(50, dtype=torch.int32)
    strides = torch.tensor([1, 7, 49], dtype=torch.int32)
    with pytest.raises(ValueError, match="3-D"):
        pair_lag_per_particle(pts[:, :2], keys, strides[:2], 1.0)
    with pytest.raises(ValueError, match="L must be"):
        pair_lag_per_particle(pts, keys, strides, 1.0, L=0)
    with pytest.raises(ValueError, match="lj_term and count_term"):
        _lag_per_particle_cuda(pts, keys, strides, 1.0, L=8, term=lambda d: d)
    with pytest.raises(ValueError, match="float32 or float64"):
        _lag_per_particle_cuda(pts.half(), keys, strides, 1.0, L=8, term=count_term)
    # the term table: a factory's term with f64 coordinates, and the species
    # term (K2 reads no payload plane)
    from zelll_tpu_torch.ops import potentials as P

    with pytest.raises(ValueError, match="float32 coordinates only"):
        _lag_per_particle_cuda(pts, keys, strides, 1.0, L=8, term=P.morse().term)
    with pytest.raises(ValueError, match="but lennard_jones_mixed"):
        _lag_per_particle_cuda(pts.float(), keys, strides, 1.0, L=8,
                               term=P.lennard_jones_mixed((1.0,), (1.0,)).term)
    with pytest.raises(ValueError, match="but lennard_jones_mixed"):
        _lag_per_particle_cuda(pts.float(), keys, strides, 1.0, L=8, term=P.morse().gfn)
    # any term runs on the plain path
    out = pair_lag_per_particle(pts, keys, strides, 4.0, L=64, term=lambda d: d)
    assert out.shape == (50,) and bool((out >= 0).all())
