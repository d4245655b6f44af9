"""K6's plain version (zelll_tpu_torch.ops.tile_pairs) against the JAX
package's tile kernels (Pallas, interpret mode, f64) on identical sorted
inputs, and against brute force; then the cubic-box step and
`auto_lj_energy`. The CUDA kernel itself is held to the plain version on
the card by tests/test_torch_kernels.py and chip_smoke.py.

Each JAX tile call loads a large interpret-mode executable into the test
worker, and a worker that holds too many crashes (pyproject.toml), so JAX
is called only where no JAX test pins the behaviour (four
configurations). Where tests/test_tile_pairs.py and tests/test_2d.py hold
the JAX kernel to brute force, the port is held to the same brute force.
Tolerances: counts, flags and path names exact; f64 energies to 1e-9 (the
sums differ only in order); split-f32 energies to 1e-6 (f32 terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelll_tpu.core import build as jax_build
from zelll_tpu.ops.fused import auto_lj_energy as jax_auto
from zelll_tpu.ops.pallas_pairs import combine_count as jax_combine_count
from zelll_tpu.ops.tile_pairs import tile_count_pairs as jax_tile_count
from zelll_tpu.ops.tile_pairs import tile_pair_reduce as jax_tile_reduce
from zelll_tpu_torch.core import bin_and_sort, build
from zelll_tpu_torch.ops.fused import auto_lj_energy
from zelll_tpu_torch.ops.lag_pairs import combine_count, count_term, lj_term, split_f64
from zelll_tpu_torch.ops.tile_pairs import (
    tile_count_pairs,
    tile_lj_energy,
    tile_lj_rebuild_energy,
    tile_pair_reduce,
    tile_pair_reduce_plain,
)


def _brute(pts, cutoff):
    """(pair count, LJ energy) over unique pairs, f64."""
    d = pts[:, None] - pts[None, :]
    dsq = (d * d).sum(-1)
    m = (dsq < cutoff**2) & np.tri(len(pts), k=-1, dtype=bool)
    inv = np.where(m, 1.0 / np.where(m, dsq, 1.0), 0.0)
    t = inv**3
    return int(m.sum()), float((4 * t * (t - 1)).sum())


def _jax_sorted(pts, cutoff):
    g = jax_build(jnp.asarray(pts), cutoff)
    return g, (np.asarray(g.sorted_pos), np.asarray(g.bins.sorted_keys),
               np.asarray(g.info.strides))


def _port(args):
    return tuple(torch.as_tensor(np.array(a)) for a in args)


CASES = [  # tests/test_tile_pairs.py
    (2000, (12.0, 12.0, 12.0), 1.0),   # cubic
    (1200, (3.0, 3.0, 45.0), 1.0),     # thin
    (800, (40.0, 40.0, 1.5), 1.2),     # flat slab
    (777, (9.0, 9.0, 9.0), 1.5),       # odd n (padding path)
]


@pytest.mark.parametrize("n,box,cutoff", CASES, ids=["cubic", "thin", "slab", "odd_n"])
def test_energy_and_count_match_bruteforce(n, box, cutoff):
    """The inputs and limits of test_tile_pairs.py's JAX kernel test."""
    pts = np.random.default_rng(n).uniform(0, 1, (n, 3)) * np.asarray(box)
    g = build(pts, cutoff, device="cpu")
    args = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, cutoff**2)
    e, ok = tile_lj_energy(*args, CB=2, MAXJ=6)
    e2, _ = tile_pair_reduce(*args, CB=2, MAXJ=6)
    c, okc = tile_count_pairs(*args, CB=2, MAXJ=6)
    n_ref, e_ref = _brute(g.sorted_pos.numpy(), cutoff)
    assert bool(ok) and bool(okc)
    assert e.dtype == torch.float64 and float(e) == float(e2)
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-9)
    assert c.dtype == torch.int32 and combine_count(c) == n_ref


def test_split_precision_large_box_vs_bruteforce():
    rng = np.random.default_rng(5)
    n, cutoff = 1500, 10.0
    pts = rng.uniform(0, 1, (n, 3)) * np.array([30.0, 30.0, 1.6e4])
    pts[:, 2] += 1.0e4  # f32 ulp ~1e-3 out here
    g = build(pts, cutoff, device="cpu")
    hi, lo = split_f64(g.sorted_pos)
    e, ok = tile_lj_energy(hi, g.bins.sorted_keys, g.info.strides, cutoff**2, lo,
                           CB=2, MAXJ=6)
    assert bool(ok) and e.dtype == torch.float32
    np.testing.assert_allclose(float(e), _brute(g.sorted_pos.numpy(), cutoff)[1],
                               rtol=1e-6)


def test_two_dimensional_count_vs_bruteforce():
    pts = np.random.default_rng(9).uniform(0, 1, (900, 2)) * 15.0
    g = build(pts, 1.0, device="cpu")
    c, ok = tile_count_pairs(g.sorted_pos, g.bins.sorted_keys, g.info.strides,
                             1.0, CB=2, MAXJ=6)
    assert bool(ok) and combine_count(c) == _brute(g.sorted_pos.numpy(), 1.0)[0]


def test_undersized_maxj_matches_jax():
    """MAXJ = 1 cannot cover this density: both flags drop, and the clamped
    windows give the same (partial) count on both sides."""
    pts = np.random.default_rng(3).uniform(0, 1, (3000, 3)) * 10.0
    g, args = _jax_sorted(pts, 1.0)
    want, want_ok = jax_tile_count(g.sorted_pos, g.bins.sorted_keys, g.info.strides,
                                   1.0, CB=2, MAXJ=1, interpret=True)
    c, ok = tile_count_pairs(*_port(args), 1.0, CB=2, MAXJ=1)
    assert not bool(want_ok) and not bool(ok)
    assert combine_count(c) == jax_combine_count(np.asarray(want))
    assert combine_count(c) < _brute(args[0], 1.0)[0]


@pytest.fixture(scope="module")
def straddle():
    """12 x 12 x 3 cells at 40 per cell (tests/test_tile_maskless.py):
    band windows overlap at the y-row and z-layer key jumps."""
    rng = np.random.default_rng(0)
    base = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(3),
                                indexing="ij"), -1).reshape(-1, 3)
    pts = np.repeat(base, 40, axis=0) + rng.uniform(0.02, 0.98, (len(base) * 40, 3))
    bins, sp = bin_and_sort(torch.as_tensor(pts), 1.0, need_perm=False)
    return sp, bins.sorted_keys, bins.info.strides


def test_maskless_and_kahan_modes_match_jax(straddle):
    sp, keys, strides = straddle
    want, want_ok = jax_tile_reduce(jnp.asarray(sp.numpy()), jnp.asarray(keys.numpy()),
                                    jnp.asarray(strides.numpy()), 1.0, MAXJ=24,
                                    kahan="program", bandmask=False, safe_term=False,
                                    interpret=True)
    assert bool(want_ok)
    args = (sp, keys, strides, 1.0)
    results = {}
    for name, kw in {
        "masked": dict(bandmask=True),
        "maskless": dict(bandmask=False),
        "program_unsafe": dict(bandmask=False, kahan="program", safe_term=False),
        "plain_kahan": dict(kahan=False),
    }.items():
        e, ok = tile_pair_reduce(*args, MAXJ=24, **kw)
        assert bool(ok), name
        results[name] = float(e)
        np.testing.assert_allclose(results[name], float(want), rtol=1e-9, err_msg=name)
    counts = {bm: combine_count(tile_count_pairs(*args, MAXJ=24, bandmask=bm)[0])
              for bm in (True, False)}
    assert counts[True] == counts[False] > 0


def test_int32_keys_past_2_24():
    """packed=False (the TPU's int32-key kernel, K10): two blobs in
    opposite corners of a 260^3 box, so flat keys pass 2^24. The packed
    flag drops on both sides (f32 keys would round); the int32 path
    counts every pair."""
    rng = np.random.default_rng(8)
    blob = rng.uniform(0, 6.0, (300, 3))
    pts = np.concatenate([blob, 260.0 - rng.uniform(0, 6.0, (300, 3))]).astype(np.float32)
    g, args = _jax_sorted(pts, 1.0)
    assert int(np.max(args[1])) >= 1 << 24
    jargs = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, 1.0)
    want, want_ok = jax_tile_count(*jargs, CB=2, MAXJ=4, packed=False, interpret=True)
    p, k, s = _port(args)
    c, ok = tile_count_pairs(p, k, s, 1.0, CB=2, MAXJ=4, packed=False)
    _, packed_ok = tile_count_pairs(p, k, s, 1.0, CB=2, MAXJ=4)
    assert bool(want_ok) and bool(ok)
    assert not bool(packed_ok)
    assert combine_count(c) == jax_combine_count(np.asarray(want)) \
        == _brute(args[0].astype(np.float64), 1.0)[0]


@pytest.mark.parametrize("split", [False, True], ids=["f32", "split_f32"])
def test_rebuild_energy_vs_bruteforce(split):
    pts = np.random.default_rng(12).uniform(0, 1, (1500, 3)) * 11.0
    if split:
        hi, lo = split_f64(torch.as_tensor(pts))
    else:
        # brute force on the f32-rounded points: only the f32 arithmetic of
        # the separations differs
        hi, lo = torch.as_tensor(pts, dtype=torch.float32), None
        pts = hi.double().numpy()
    n_ref, e_ref = _brute(pts, 1.0)
    e, ok = tile_lj_rebuild_energy(hi, 1.0, lo, MAXJ=12, CB=2)
    c, _ = tile_lj_rebuild_energy(hi, 1.0, lo, MAXJ=12, CB=2, term=count_term,
                                  out_dtype=torch.int32)
    assert bool(ok) and e.dtype == torch.float32
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-5)
    assert combine_count(c) == n_ref


def test_rebuild_energy_small_n_large_maxj_and_2d():
    """MAXJ above the chunk count clamps; 2D split inputs bin on their two
    spatial columns."""
    pts = np.random.default_rng(4).uniform(0, 1, (600, 3)) * 8.0
    e, ok = tile_lj_rebuild_energy(torch.as_tensor(pts), 1.0, MAXJ=12, CB=2)
    assert bool(ok) and e.dtype == torch.float64
    np.testing.assert_allclose(float(e), _brute(pts, 1.0)[1], rtol=1e-9)
    pts2 = np.random.default_rng(12).uniform(0, 1, (700, 2)) * 14.0
    hi, lo = split_f64(torch.as_tensor(pts2))
    e2, ok2 = tile_lj_rebuild_energy(hi, 1.0, lo, MAXJ=6, CB=2)
    assert bool(ok2)
    np.testing.assert_allclose(float(e2), _brute(pts2, 1.0)[1], rtol=1e-6)


def test_auto_lj_energy_paths():
    """Thin 2D box -> the lag step; wide 2D box past the lag cap -> the
    tile step, with the same probed MAXJ as the JAX package (the inputs of
    tests/test_2d.py, which holds JAX's energies to brute force)."""
    rng = np.random.default_rng(2)
    thin = rng.uniform(0, 1, size=(400, 2)) * np.array([3.0, 50.0])
    wide = rng.uniform(0, 1, size=(3000, 2)) * 30.0
    e, path = auto_lj_energy(thin, 1.0, device="cpu")
    assert path.startswith("fused(L=")
    np.testing.assert_allclose(e, _brute(thin, 1.0)[1], rtol=1e-10)
    _, want_path = jax_auto(wide, 1.0, max_thin_lag=128, interpret=True)
    e, path = auto_lj_energy(wide, 1.0, max_thin_lag=128, device="cpu")
    assert path == want_path and path.startswith("tile(MAXJ=(")
    np.testing.assert_allclose(e, _brute(wide, 1.0)[1], rtol=1e-10)


def test_auto_lj_energy_cubic_split_and_high_dim():
    pts = np.random.default_rng(6).uniform(0, 1, (1500, 3)) * 12.0
    e, path = auto_lj_energy(pts, 1.0, split=True, max_thin_lag=128, device="cpu")
    assert path.startswith("tile(MAXJ=(")
    np.testing.assert_allclose(e, _brute(pts, 1.0)[1], rtol=1e-6)
    wide4 = np.random.default_rng(7).uniform(0, 1, (200, 4)) * 8.0
    with pytest.raises(NotImplementedError, match="slice 4"):
        auto_lj_energy(wide4, 1.0, max_thin_lag=0, device="cpu")


def test_plain_takes_payload_min_islot_and_any_term():
    """The plain version's extras: a payload plane, distributed ownership
    (pairs whose larger slot is below min_islot belong elsewhere) and any
    term callable."""
    pts = np.random.default_rng(11).uniform(0, 1, (1000, 3)) * 10.0
    g = build(pts, 1.0, device="cpu")
    args = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, 1.0)
    sp = g.sorted_pos.numpy()
    d = sp[:, None] - sp[None, :]
    dsq = (d * d).sum(-1)
    m = (dsq < 1.0) & np.tri(len(sp), k=-1, dtype=bool)
    kw = dict(CB=2, MAXJ=6, term=count_term, out_dtype=torch.int32)
    own = combine_count(tile_pair_reduce(*args, min_islot=500, **kw)[0])
    assert own == int(m.sum()) - int(m[:500].sum())
    w = np.random.default_rng(1).uniform(0.5, 2.0, len(sp))
    got, _ = tile_pair_reduce(*args, sorted_payload=torch.as_tensor(w), CB=2, MAXJ=6,
                              term=lambda dsq, wi, wj: dsq * wi * wj)
    want = (np.where(m, dsq, 0.0) * w[:, None] * w[None, :]).sum()
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    e, _ = tile_pair_reduce_plain(*args, CB=2, MAXJ=6, term=lj_term)
    assert float(e) == float(tile_pair_reduce(*args, CB=2, MAXJ=6)[0])


def test_rejects_what_jax_rejects():
    g = build(np.random.default_rng(23).uniform(0, 1, (300, 3)) * 5.0, 1.0, device="cpu")
    args = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, 1.0)
    for kw in (dict(MAXJ=(4, 4, 4, 4, 4), packed=False),
               dict(packed=False, bandmask=False),
               dict(packed=False, kahan="program"),
               dict(OH=64),
               dict(packed=False, OH=60),
               dict(MAXJ=(4, 4)),
               dict(sorted_payload=torch.ones(300, dtype=torch.float64), packed=False)):
        with pytest.raises(ValueError):
            tile_pair_reduce(*args, **kw)
    # OH row groups are accepted on the int32-key path and change nothing
    a = tile_count_pairs(*args, packed=False, OH=32, MAXJ=6)[0]
    b = tile_count_pairs(*args, packed=False, MAXJ=6)[0]
    assert combine_count(a) == combine_count(b)
