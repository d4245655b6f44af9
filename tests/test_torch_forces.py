"""The forces of the port (zelll_tpu_torch.ops.lj, the plain versions of K3
in ops.lag_pairs and K7 in ops.tile_pairs) against the JAX package's
`pair_lag_forces` and `tile_pair_forces` (Pallas, interpret mode) on
identical sorted inputs, carried across with `zelll_tpu_torch.convert`,
and against brute force. The CUDA kernels themselves are held to the plain
versions on the card by tests/test_torch_kernels.py and chip_smoke.py.

Each JAX forces call loads a large interpret-mode executable into the test
worker, so JAX is called for seven configurations here (pyproject.toml,
ROADMAP Tier-1 budget); elsewhere the port is held to brute force, as
tests/test_forces_md.py holds JAX. Tolerances: flags exact; f64 forces to
1e-9 of the largest force (the sums differ only in order, as in
tests/test_forces_md.py); split-f32 forces to 1e-5 of the largest force
(f32 products g d summed in another order and precision)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.core import build as jax_build
from zelll_tpu.ops.lj import lj as jax_lj
from zelll_tpu.ops.lj import lj_force_factor as jax_lj_force_factor
from zelll_tpu.ops.lj import lj_force_factor_fast as jax_lj_force_factor_fast
from zelll_tpu.ops.pallas_pairs import pair_lag_forces as jax_lag_forces
from zelll_tpu.ops.pallas_pairs import suggest_lag as jax_suggest_lag
from zelll_tpu.ops.tile_pairs import tile_pair_forces as jax_tile_forces
from zelll_tpu_torch.convert import sorted_inputs_from_numpy
from zelll_tpu_torch.core import build
from zelll_tpu_torch.ops.lj import lj, lj_force_factor, lj_force_factor_fast
from zelll_tpu_torch.ops.lag_pairs import (
    _pad_and_desentinel,
    lag_coverage_ok,
    pair_lag_forces,
    split_f64,
)
from zelll_tpu_torch.ops.pbc import _minimage_bins
from zelll_tpu_torch.ops.segments import CHUNK, segment_bands, suggest_maxj
from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces, tile_pair_forces_plain


def brute_forces(pts, cutoff):
    """(n, dim) f64 LJ forces over all cutoff partners, input order."""
    n = len(pts)
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    mask = (dsq < cutoff**2) & ~np.eye(n, dtype=bool)
    inv = np.where(mask, 1.0 / np.where(mask, dsq, 1.0), 0.0)
    t = inv**3
    g = np.where(mask, 24 * t * (2 * t - 1) * inv, 0.0)
    return (d * g[..., None]).sum(axis=1)


def assert_forces(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _jax_sorted(pts, cutoff):
    """JAX's sorted (pos, keys, strides, perm) as numpy arrays."""
    g = jax_build(jnp.asarray(pts), cutoff)
    return (np.array(g.sorted_pos), np.array(g.bins.sorted_keys),
            np.array(g.info.strides), np.array(g.bins.perm))


PAIR_FUNCTIONS = {
    "lj": (lj, jax_lj),
    "lj_force_factor": (lj_force_factor, jax_lj_force_factor),
    "lj_force_factor_fast": (lj_force_factor_fast, jax_lj_force_factor_fast),
}


@pytest.mark.parametrize("name", list(PAIR_FUNCTIONS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pair_functions_match_jax(name, dtype):
    port, ref = PAIR_FUNCTIONS[name]
    dsq = np.random.default_rng(0).uniform(0.64, 9.0, 1000).astype(dtype)
    want = np.asarray(ref(jnp.asarray(dsq)))
    got = port(torch.as_tensor(dsq)).numpy()
    assert got.dtype == want.dtype
    # The same operations in the same order, so equal but for rsqrt, which
    # may differ by up to 2 ulp between the libraries: t^3 inv multiplies
    # that by 8, and the remaining roundings add a few ulp. The bound is
    # relative to the two terms that cancel in 2t - 1 (t - 1 for lj), not
    # to the result, which vanishes at that zero.
    inv = 1.0 / dsq.astype(np.float64)
    t = inv**3
    terms = 4 * t * (t + 1) if name == "lj" else 24 * t * (2 * t + 1) * inv
    ulps = (8 * 2 + 4) if name.endswith("fast") else 0
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= ulps * np.finfo(dtype).eps * terms)


LAG_CASES = [  # tests/test_forces_md.py
    (900, (4.0, 4.0, 30.0), 1.0),
    (500, (8.0, 8.0, 8.0), 2.0),
    (257, (2.0, 2.0, 40.0), 1.5),  # odd n: the JAX kernel's tail padding
]


@pytest.mark.parametrize("n,box,cutoff", LAG_CASES, ids=["thin", "cubic", "odd_n"])
def test_pair_lag_forces_matches_jax(n, box, cutoff):
    pts = np.random.default_rng(n).uniform(0, 1, size=(n, 3)) * np.asarray(box)
    sp, keys, strides, perm = _jax_sorted(pts, cutoff)
    L = jax_suggest_lag(keys, strides)
    want = np.asarray(jax_lag_forces(jnp.asarray(sp), jnp.asarray(keys),
                                     jnp.asarray(strides), cutoff**2,
                                     M=max(256, L), L=L, interpret=True))
    p_sp, p_keys, p_strides, _ = sorted_inputs_from_numpy(sp, None, keys, strides,
                                                          device="cpu")
    got = pair_lag_forces(p_sp, p_keys, p_strides, cutoff**2, L=L)
    assert got.shape == (n, 3) and got.dtype == torch.float64
    assert_forces(got, want, 1e-9)
    assert_forces(got, brute_forces(pts, cutoff)[perm], 1e-9)


def test_pair_lag_forces_split_matches_jax():
    """Split f32 planes far from the origin, where plain f32 loses the
    separations: JAX's kernel and the port agree, and both are f64-grade
    against brute force."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 1, (600, 3)) * [3.0, 3.0, 60.0] + [0.0, 0.0, 1.0e4]
    sp, keys, strides, perm = _jax_sorted(pts, 1.0)
    hi, lo = (np.asarray(x) for x in split_f64(torch.as_tensor(sp)))
    L = jax_suggest_lag(keys, strides)
    want = np.asarray(jax_lag_forces(jnp.asarray(hi), jnp.asarray(keys),
                                     jnp.asarray(strides), 1.0, jnp.asarray(lo),
                                     M=512, L=L, interpret=True))
    p_hi, p_keys, p_strides, p_lo = sorted_inputs_from_numpy(hi, lo, keys, strides,
                                                             device="cpu")
    got = pair_lag_forces(p_hi, p_keys, p_strides, 1.0, p_lo, L=L)
    assert got.dtype == torch.float32
    assert_forces(got, want, 1e-5)
    assert_forces(got, brute_forces(pts, 1.0)[perm], 1e-5)
    f64 = pair_lag_forces(p_hi, p_keys, p_strides, 1.0, p_lo, L=L,
                          out_dtype=torch.float64)
    assert f64.dtype == torch.float64
    assert_forces(f64, got.double(), 1e-6)


@pytest.fixture(scope="module")
def cube():
    """A jittered cubic lattice of 1.1 spacing at cutoff 1.6 (face
    diagonals inside the cutoff), sorted by the JAX package, and its
    per-band window capacities for the full stencil."""
    rng = np.random.default_rng(5)
    g = np.stack(np.meshgrid(*[np.arange(9.0)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pts = g * 1.1 + rng.uniform(-0.08, 0.08, g.shape)
    sp, keys, strides, perm = _jax_sorted(pts, 1.6)
    n = len(pts)
    C = max(-(-n // (CHUNK * 2)) * 2, 2) * CHUNK
    maxj = suggest_maxj(_pad_and_desentinel(torch.as_tensor(keys), C),
                        segment_bands(torch.as_tensor(strides), full=True),
                        half=False, per_band=True)
    return pts, sp, keys, strides, perm, maxj


def _both_tile(sp, keys, strides, csq, lo=None, **kw):
    """JAX's tile_pair_forces and the port's on the same sorted arrays:
    ((forces, flag) JAX, (forces, flag) port)."""
    j = jax_tile_forces(jnp.asarray(sp), jnp.asarray(keys), jnp.asarray(strides),
                        csq, None if lo is None else jnp.asarray(lo),
                        interpret=True, **kw)
    p = tile_pair_forces(torch.as_tensor(sp), torch.as_tensor(keys),
                         torch.as_tensor(strides), csq,
                         None if lo is None else torch.as_tensor(lo), **kw)
    return (np.asarray(j[0]), bool(j[1])), (p[0].numpy(), bool(p[1]))


def test_tile_forces_maskless_per_band_matches_jax(cube):
    pts, sp, keys, strides, perm, maxj = cube
    assert len(maxj) == 9
    (want, ok_j), (got, ok) = _both_tile(sp, keys, strides, 1.6**2, CB=2, MAXJ=maxj)
    assert ok_j and ok
    assert_forces(got, want, 1e-9)
    assert_forces(got, brute_forces(pts, 1.6)[perm], 1e-9)


def test_tile_forces_masked_split_matches_jax(cube):
    pts, sp, keys, strides, perm, maxj = cube
    hi, lo = (np.asarray(x) for x in split_f64(torch.as_tensor(sp + 500.0)))
    (want, ok_j), (got, ok) = _both_tile(hi, keys, strides, np.float32(1.6**2), lo,
                                         CB=2, MAXJ=max(maxj), bandmask=True)
    assert ok_j and ok
    assert got.dtype == np.float32
    assert_forces(got, want, 1e-5)
    assert_forces(got, brute_forces(pts, 1.6)[perm], 1e-5)


def test_tile_forces_undersized_maxj_matches_jax(cube):
    """MAXJ = 1 cannot hold the windows: both flags drop, and the clamped
    windows give the same partial forces on both sides."""
    pts, sp, keys, strides, perm, _ = cube
    (want, ok_j), (got, ok) = _both_tile(sp, keys, strides, 1.6**2, CB=2, MAXJ=1)
    assert not ok_j and not ok
    assert_forces(got, want, 1e-9)
    assert np.abs(got - brute_forces(pts, 1.6)[perm]).max() > 1e-3


def test_tile_forces_layouts_agree(cube):
    """packed=False (K11's int32 keys) and the masked and maskless packed
    bodies give the same forces; packed=False drops the 2^24 key term."""
    pts, sp, keys, strides, perm, maxj = cube
    args = (torch.as_tensor(sp), torch.as_tensor(keys), torch.as_tensor(strides), 1.6**2)
    want = brute_forces(pts, 1.6)[perm]
    for kw in (dict(packed=False, MAXJ=max(maxj)), dict(bandmask=True, MAXJ=maxj),
               dict(bandmask=False, MAXJ=maxj, safe_term=False)):
        f, ok = tile_pair_forces(*args, CB=2, **kw)
        f2, ok2 = tile_pair_forces_plain(*args, CB=2, **kw)
        assert bool(ok) and bool(ok2), kw
        assert torch.equal(f, f2)
        assert_forces(f, want, 1e-9)


def test_forces_refusals_and_minimum_image():
    """The argument checks of both forces entry points, and K3's minimum
    image (``mi_box``/``key_reach``, ported with periodic boxes): on a
    periodic cube binned on its own box, folded forces equal a
    minimum-image brute force."""
    pts = np.random.default_rng(0).uniform(0, 4, (200, 3))
    g = build(pts, 1.0, device="cpu")
    args = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, 1.0)
    with pytest.raises(ValueError, match="3-D only"):
        pair_lag_forces(g.sorted_pos[:, :2], *args[1:])
    box = np.full(3, 4.0)
    bins, sp, _, _, reach, mib, ok = _minimage_bins(
        torch.as_tensor(pts), [0.0] * 3, box, 1.0, np.ones(3, bool), B=None, G=None,
        positions_lo=None, need_perm=True)
    f = pair_lag_forces(sp, bins.sorted_keys, bins.info.strides, 1.0, mi_box=mib,
                        key_reach=reach, L=256)
    d = pts[:, None, :] - pts[None, :, :]
    d -= box * np.round(d / box)
    dsq = (d * d).sum(-1)
    mask = (dsq < 1.0) & ~np.eye(len(pts), dtype=bool)
    inv = np.where(mask, 1.0 / np.where(mask, dsq, 1.0), 0.0)
    want = (d * np.where(mask, 24 * inv**3 * (2 * inv**3 - 1) * inv, 0.0)[..., None]).sum(1)
    assert bool(ok) and reach == (3, 3, 3)
    assert bool(lag_coverage_ok(bins.sorted_keys, bins.info.strides, 256, reach=reach))
    assert_forces(f, want[bins.perm.long()], 1e-10)
    with pytest.raises(ValueError, match="L must be"):
        pair_lag_forces(*args, L=0)
    for kw in (dict(bandmask=False), dict(safe_term=False), dict(MAXJ=(4,) * 9)):
        with pytest.raises(ValueError, match="packed"):
            tile_pair_forces(*args, packed=False, **kw)
    with pytest.raises(ValueError, match="9 entries"):
        tile_pair_forces(*args, MAXJ=(4,) * 5)
    # a payload parameterises the force factor in the plain version
    pay = torch.ones((200, 1), dtype=torch.float64)
    f = pair_lag_forces(*args, sorted_payload=pay, gfn=lambda d, a, b: lj_force_factor(d) * a * b)
    assert torch.equal(f, pair_lag_forces(*args))



def _tie_pairs(cutoff, count, seed):
    """``count`` pairs of f64 points far from the origin whose split-f32
    dsq falls on the other side of the cutoff from their exact dsq (the
    split separation as K3/K7 round it, the f64 one from the f64 points)."""
    rng = np.random.default_rng(seed)
    m = 200_000
    a = rng.uniform(0, 1, (m, 3)) + [0.0, 0.0, 2.0e4]
    u = rng.normal(size=(m, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    b = a + u * cutoff * (1 + rng.uniform(-4e-7, 4e-7, (m, 1)))
    hi_a, lo_a = (x.numpy() for x in split_f64(torch.as_tensor(a)))
    hi_b, lo_b = (x.numpy() for x in split_f64(torch.as_tensor(b)))
    d = (hi_a - hi_b) + (lo_a - lo_b)  # f32, as the kernels round it
    dsq32 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    dsq64 = ((a - b) ** 2).sum(1)
    flips = np.nonzero((dsq32 < np.float32(cutoff**2)) != (dsq64 < cutoff**2))[0]
    assert len(flips) >= count
    return a[flips[:count]], b[flips[:count]]


def test_split_cutoff_ties_follow_f64():
    """Split mode decides pairs within the tie band of the cutoff on the f64
    sum of the split separations (ROADMAP queue 3: the JAX kernels decide
    on the f32 dsq, which flips such pairs). Pairs built to flip in f32
    get exactly the f64 brute-force forces from K3's and K7's plain
    versions."""
    a, b = _tie_pairs(1.0, 6, seed=21)
    # the pairs sit 5 apart along x, so no two of them interact
    shift = np.arange(len(a))[:, None] * [5.0, 0.0, 0.0]
    pts = np.concatenate([a + shift, b + shift])
    g = build(pts, 1.0, device="cpu")
    hi, lo = split_f64(g.sorted_pos)
    args = (hi, g.bins.sorted_keys, g.info.strides, 1.0)
    want = brute_forces(pts, 1.0)[g.bins.perm.numpy()]
    inside = (np.abs(want).max(1) > 0).sum()
    assert 0 < inside < len(pts)  # some ties inside the cutoff, some out
    f3 = pair_lag_forces(*args, lo, L=64, out_dtype=torch.float64)
    f7, ok = tile_pair_forces(*args, lo, CB=1, MAXJ=8, bandmask=True,
                              out_dtype=torch.float64)
    assert bool(ok)
    for f in (f3, f7):
        np.testing.assert_array_equal(np.abs(f.numpy()).max(1) > 0,
                                      np.abs(want).max(1) > 0)
        assert_forces(f, want, 1e-6)
