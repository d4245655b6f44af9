"""The port's bucketed pair path (zelll_tpu_torch.core.pairs), its dense
cell table (core.dense), `core.rebuild` and `ZelllConfig` against the JAX
package's on the same points, made with numpy from a seed.

Tolerances: pair and index sets, counts, flags, permutations and cell
tables exactly equal; pair sets are compared as sorted (min, max) tuples,
since pair order is unspecified (reference iters.rs:251). f64 sums,
forces and stresses to 1e-12 relative (to the largest entry for arrays):
the same terms, summed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

import zelll_tpu.core as jcore
from zelll_tpu.config import ZelllConfig as JaxConfig
from zelll_tpu.ops.lj import lj as jax_lj
from zelll_tpu.ops.lj import lj_force_factor as jax_gfn
from zelll_tpu_torch import ZelllConfig, core
from zelll_tpu_torch.ops.lj import lj, lj_force_factor

REL = 1e-12


def _jt(pts, cutoff, **kw):
    """The same points built into a JAX grid and a port grid (CPU)."""
    return (jax.jit(lambda p: jcore.build(p, cutoff, **kw))(jnp.asarray(pts)),
            core.build(torch.as_tensor(pts), cutoff, device="cpu",
                       **{k: torch.as_tensor(np.asarray(v)) for k, v in kw.items()}))


def _pair_set(i, j, count=None):
    i, j = np.asarray(i), np.asarray(j)
    if count is not None:
        i, j = i[:int(count)], j[:int(count)]
    return sorted(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-300))


def _capacity(grid) -> int:
    return int(np.prod(np.asarray(grid.info.shape) + 4))


@pytest.mark.parametrize("dim", [3, 2, 4])
def test_pair_path_matches_jax(dim):
    """pair_sum, pair_forces, pair_stress (with slot weights),
    pair_energy_per_particle, count_pairs, materialize_pairs (and its
    overflow flag) and query_neighbors, with the binary-search lookup and
    with the dense table, at a chunk size that leaves a ragged last chunk;
    the grid bins on min(dim, 3) axes with exact N-D distances on top."""
    rng = np.random.default_rng(10 + dim)
    n, cutoff = 400, 1.0
    pts = rng.uniform(0, 1, (n, dim)) * np.array([5.0, 6.0, 4.0, 3.0][:dim])
    gj, gt = _jt(pts, cutoff)
    K = int(gj.bins.max_cell_count())
    assert int(gt.bins.max_cell_count()) == K
    tj = jax.jit(lambda b: jcore.build_dense_table(b, _capacity(gj)))(gj.bins)
    tt = core.build_dense_table(gt.bins, _capacity(gj))
    assert bool(tj.fits) and bool(tt.fits)
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(tj.rows))
    kw = dict(K=K, chunk=48, cutoff_sq=cutoff**2)
    w = rng.uniform(0, 1, n)
    # the JAX side under jit: one executable per function instead of one
    # per eager operation (each keeps its memory mappings for the life of
    # the test worker)
    ref = jax.jit(lambda g, w: (
        jcore.pair_sum(g, jax_lj, **kw), jcore.pair_forces(g, jax_gfn, **kw),
        jcore.pairs.pair_stress(g, jax_gfn, slot_weights=w, **kw),
        jcore.pairs.pair_energy_per_particle(g, jax_lj, **kw),
        *(jcore.count_pairs(g, K=K, chunk=48, cutoff_sq=c) for c in (None, cutoff**2))))
    j_sum, j_forces, j_stress, j_pp, *j_counts = ref(gj, jnp.asarray(w))

    _close(float(core.pair_sum(gt, lj, **kw)), float(j_sum))
    _close(core.pair_forces(gt, lj_force_factor, **kw), j_forces)
    _close(core.pair_stress(gt, lj_force_factor, slot_weights=torch.as_tensor(w), **kw),
           j_stress)
    _close(core.pair_energy_per_particle(gt, lj, **kw), j_pp)
    for dense in (None, tt):
        for csq, jc in zip((None, cutoff**2), j_counts):
            c = core.count_pairs(gt, K=K, chunk=48, cutoff_sq=csq, dense=dense)
            want = int(jc)
            assert c.dtype == torch.int64 and int(c) == want
            i, j, cnt, over = core.materialize_pairs(gt, K=K, max_pairs=want + 5,
                                                     chunk=48, cutoff_sq=csq, dense=dense)
            ji, jj, jcnt, _ = jax.jit(lambda g: jcore.materialize_pairs(
                g, K=K, max_pairs=want + 5, chunk=48, cutoff_sq=csq))(gj)
            assert int(cnt) == int(jcnt) == want and not bool(over)
            assert _pair_set(i, j, cnt) == _pair_set(ji, jj, jcnt)
            assert (i[want:] == n).all()
        _close(float(core.pair_sum(gt, lj, dense=dense, **kw)), float(j_sum))
    _, _, cnt, over = core.materialize_pairs(gt, K=K, max_pairs=10, chunk=48)
    assert bool(over) and int(cnt) > 10

    # queries: inside, on particles, one layer outside, far outside
    q = np.vstack([rng.uniform(-0.5, 5.5, (12, dim)), pts[:4],
                   [[-0.5] * dim], [[50.0] * dim]])
    rj = jax.jit(lambda g, q: jcore.query_neighbors(g, q, K=K))(
        gj, jnp.asarray(q[:, :min(dim, 3)]))
    for dense in (None, tt):
        rt = core.query_neighbors(gt, q[:, :min(dim, 3)], K=K, dense=dense)
        np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
        np.testing.assert_array_equal(rt.mask.numpy(), np.asarray(rj.mask))
        np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
        np.testing.assert_array_equal(rt.slots.numpy(), np.asarray(rj.slots))
    assert not bool(rt.valid[-1])


def test_chessboard_and_dense_capacity_flag():
    """The reference's chessboard fixture (util.rs:309-340): 4 intra + 24
    inter candidate pairs on the 2x2x2 board, through both lookups; a
    dense table too small for the grid raises its flag, as JAX's does."""
    pts = core.generate_pointcloud((2, 2, 2), 1.0, (0.0, 0.0, 0.0))
    np.testing.assert_array_equal(pts, jcore.generate_pointcloud((2, 2, 2), 1.0,
                                                                (0.0, 0.0, 0.0)))
    g = core.build(pts, 1.0, device="cpu")
    table = core.build_dense_table(g.bins, _capacity(g))
    for dense in (None, table):
        assert int(core.count_pairs(g, K=8, chunk=4, dense=dense)) == 28
        assert int(core.count_pairs(g, K=8, cutoff_sq=0.0, dense=dense)) == 0
        i, j, cnt, _ = core.materialize_pairs(g, K=8, max_pairs=64, dense=dense)
        assert len(set(_pair_set(i, j, cnt))) == 28
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1, (200, 3)) * [6.0, 5.0, 7.0]
    gj, gt = _jt(pts, 1.0)
    small_t = core.build_dense_table(gt.bins, 8)
    small_j = jax.jit(lambda b: jcore.build_dense_table(b, 8))(gj.bins)
    assert not bool(small_t.fits) and not bool(small_j.fits)
    np.testing.assert_array_equal(small_t.rows.numpy(), np.asarray(small_j.rows))


def test_rebuild_fast_and_slow_paths_match_jax():
    """`core.rebuild`: identical positions keep the tables and the
    permutation (the fast path); moves that change keys, the geometry or
    the cutoff take the slow path; padding rows (valid=False) stay last.
    Every table, key, permutation and sorted position equals JAX's."""
    rng = np.random.default_rng(2)
    n = 300
    pts = rng.uniform(0, 5, (n, 3))
    valid = np.arange(n) < n - 20
    gj, gt = _jt(pts, 1.0, valid=valid)

    def same(a, b):
        for name in ("keys", "perm", "sorted_keys", "cell_keys", "cell_starts",
                     "cell_counts", "num_cells", "num_valid", "overflow"):
            np.testing.assert_array_equal(getattr(a.bins, name).numpy(),
                                          np.asarray(getattr(b.bins, name)), err_msg=name)
        np.testing.assert_array_equal(a.sorted_pos.numpy(), np.asarray(b.sorted_pos))
        np.testing.assert_array_equal(a.sorted_ids.numpy(), np.asarray(b.sorted_ids))
        np.testing.assert_array_equal(a.info.strides.numpy(), np.asarray(b.info.strides))

    tv, jv = torch.as_tensor(valid), jnp.asarray(valid)
    jax_rebuild = jax.jit(lambda g, p, c: jcore.rebuild(g, p, c, valid=jv))
    # fast path: nothing moved
    t1 = core.rebuild(gt, torch.as_tensor(pts), valid=tv)
    j1 = jax_rebuild(gj, jnp.asarray(pts), 1.0)
    same(t1, j1)
    assert t1.bins.cell_keys is gt.bins.cell_keys  # the table is kept
    # fast path: moves inside every cell, the box unchanged
    lo, hi = pts[valid].min(0), pts[valid].max(0)
    cells = lo + np.floor(pts - lo)
    inner = np.clip(pts + rng.uniform(-0.02, 0.02, pts.shape), cells + 1e-3,
                    cells + 1 - 1e-3)
    inner = np.clip(inner, lo, hi)
    inner[np.argmin(pts[valid], 0), range(3)] = lo
    inner[np.argmax(pts[valid], 0), range(3)] = hi
    t2 = core.rebuild(gt, torch.as_tensor(inner), valid=tv)
    j2 = jax_rebuild(gj, jnp.asarray(inner), 1.0)
    same(t2, j2)
    assert t2.bins.cell_keys is gt.bins.cell_keys
    # slow paths: a shuffle, then a cutoff change
    shuffled = rng.uniform(0, 5, (n, 3))
    t3 = core.rebuild(t2, torch.as_tensor(shuffled), valid=tv)
    j3 = jax_rebuild(j2, jnp.asarray(shuffled), 1.0)
    same(t3, j3)
    t4 = core.rebuild(t3, torch.as_tensor(shuffled), 2.0, valid=tv)
    j4 = jax_rebuild(j3, jnp.asarray(shuffled), 2.0)
    same(t4, j4)
    assert float(t4.info.cutoff) == 2.0
    K = int(t4.bins.max_cell_count())
    assert int(core.count_pairs(t4, K=K, cutoff_sq=4.0)) == int(
        jax.jit(lambda g: jcore.count_pairs(g, K=K, cutoff_sq=4.0))(j4))
    with pytest.raises(ValueError, match="shape"):
        core.rebuild(gt, torch.as_tensor(pts[:10]))


def test_config_matches_jax(monkeypatch):
    """`ZelllConfig` is the port's own copy: the same defaults, validation,
    environment overrides, dict round trip and capacity growth."""
    assert ZelllConfig().to_dict() == JaxConfig().to_dict()
    c = ZelllConfig(cutoff=10.0, precision="split", L=512)
    assert ZelllConfig.from_dict(c.to_dict()) == c
    assert c.to_dict() == JaxConfig(cutoff=10.0, precision="split", L=512).to_dict()
    for bad in (dict(precision="bf16"), dict(L=100), dict(M=1024, L=2048), dict(K=0)):
        with pytest.raises(ValueError):
            ZelllConfig(**bad)
        with pytest.raises(ValueError):
            JaxConfig(**bad)
    monkeypatch.setenv("ZELLL_CUTOFF", "2.5")
    monkeypatch.setenv("ZELLL_L", "512")
    monkeypatch.setenv("ZELLL_PRECISION", "split")
    e = ZelllConfig.from_env(M=8192)
    assert e.cutoff == 2.5 and e.L == 512 and e.M == 8192 and e.precision == "split"
    assert e.to_dict() == JaxConfig.from_env(M=8192).to_dict()
    g = ZelllConfig(L=256, M=4096, MAXJ=12, K=32).grown()
    assert (g.L, g.M, g.MAXJ, g.K) == (512, 8192, 24, 64)
    assert g.to_dict() == JaxConfig(L=256, M=4096, MAXJ=12, K=32).grown().to_dict()
    assert g.grown().grown().M >= g.grown().grown().L
