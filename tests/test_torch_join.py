"""The query join (`zelll_tpu_torch.ops.join`, kernel K12's plain version on
CPU tensors) against the JAX package's join (Pallas in interpret mode) on
the same sorted inputs, and against numpy brute force; `CellGrid`'s
`count_neighbors_batch` and `nearest_neighbor_distances` against the JAX
`CellGrid`. The CUDA kernel itself is held to the plain version on the card
by tests/test_torch_kernels.py and chip_smoke.py.

The JAX calls run under `jax.jit` (its join functions are jitted) at a few
hundred particles, and the JAX `CellGrid` is built on one point set.

Tolerances: window bounds, counts and flags exactly equal. Minima equal
the numpy brute force computed in the same order of operations exactly,
and JAX's to 4 ulp: in interpret mode XLA:CPU contracts d0 d0 + d1 d1 +
d2 d2 into fused multiply-adds, where the port (and K12, built with
--fmad=false) rounds every product. f64 sums (SDF, payload-weighted) to
1e-12 of the largest: the same terms summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

import zelll_tpu.api as jax_api
from zelll_tpu.core.grid import build as jax_build
from zelll_tpu.ops import join as jax_join
from zelll_tpu.ops.pallas_pairs import _pad_and_desentinel as jax_pad
from zelll_tpu.ops.sdf_join import sdf_term as jax_sdf_term
from zelll_tpu.ops.segments import join_bounds as jax_join_bounds
from zelll_tpu.ops.segments import segment_bands as jax_bands
from zelll_tpu_torch import CellGrid
from zelll_tpu_torch.core import build
from zelll_tpu_torch.ops import join
from zelll_tpu_torch.ops.lag_pairs import _pad_and_desentinel
from zelll_tpu_torch.ops.sdf_join import NACC, sdf_term
from zelll_tpu_torch.ops.segments import CHUNK, join_bounds, segment_bands

REL = 1e-12


def _cloud(n, box, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)) * np.asarray(box)


def _brute_dsq(queries, pos):
    """(Q, n) squared distances in the join's order of operations."""
    d = queries[:, None, :] - pos[None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


@pytest.mark.parametrize("max_j", [None, 2], ids=["resident", "windowed"])
def test_join_bounds_equal_jax(max_j):
    """The per-chunk band windows are bitwise the JAX function's, on keys
    with duplicates, out-of-box query keys below and above the particle
    keys, and padding rows on both sides."""
    rng = np.random.default_rng(7)
    strides = np.array([1, 14, 196], np.int32)
    qk = np.sort(rng.integers(-300, 3000, 300)).astype(np.int32)
    pk = np.sort(rng.integers(0, 2700, 600)).astype(np.int32)
    qp = np.asarray(jax_pad(jnp.asarray(qk), 3 * CHUNK))
    pp = np.asarray(jax_pad(jnp.asarray(pk), 5 * CHUNK))
    want = jax.jit(lambda a, b: jax_join_bounds(
        a, b, jax_bands(jnp.asarray(strides), full=True), max_j=max_j))(qp, pp)
    tq = _pad_and_desentinel(torch.as_tensor(qk), 3 * CHUNK)
    tp = _pad_and_desentinel(torch.as_tensor(pk), 5 * CHUNK)
    np.testing.assert_array_equal(tq.numpy(), qp)
    got = join_bounds(tq, tp, segment_bands(torch.as_tensor(strides), full=True),
                      max_j=max_j)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_and_port_inputs(pos, queries, cutoff, payload):
    """The JAX grid's sorted particles and the JAX-sorted queries, as the
    inputs of both join_reduce functions."""
    g = jax.jit(lambda p: jax_build(p, cutoff))(jnp.asarray(pos))
    info = g.info
    idx = np.clip(np.floor((queries - np.asarray(info.origin)) / cutoff),
                  -1, np.asarray(info.shape)).astype(np.int32)
    keys = (idx * np.asarray(info.strides)).sum(1).astype(np.int32)
    order = np.argsort(keys, kind="stable")
    perm = np.array(g.bins.perm)
    sp = np.array(g.sorted_pos)
    qpl = [queries[order, a] for a in range(3)]
    ppl = [sp[:, a] for a in range(3)] + [p[perm] for p in payload]
    return (qpl, keys[order], ppl, np.array(g.bins.sorted_keys),
            np.array(info.strides), order)


def _payload_term(xp):
    where = jnp.where if xp is jnp else torch.where

    def term(dsq, d, payload, within):
        return [where(within, payload[0] * (2.25 - dsq), 0.0 * dsq)]

    return term


_JAX_PAYLOAD = _payload_term(jnp)
_PORT_PAYLOAD = _payload_term(torch)
_CASES = {
    "count": (jax_join._count_term, join._count_term, "sum", 1, 0),
    "nearest": (jax_join._nearest_term, join._nearest_term, "min", 1, 0),
    "sdf": (jax_sdf_term, sdf_term, "sum", NACC, 2),
    "payload_sum": (_JAX_PAYLOAD, _PORT_PAYLOAD, "sum", 1, 1),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_join_reduce_matches_jax(case):
    """`join_reduce` on CPU tensors against the JAX `join_reduce` on the
    same sorted inputs: 600 particles in a 9^3 box, cutoff 1.5, queries in
    and around the box, at atoms (d == 0), exactly at the cutoff and far
    away; and against brute force."""
    jax_term, port_term, reducer, n_out, npl = _CASES[case]
    rng = np.random.default_rng(21)
    cutoff = 1.5
    pos = np.round(_cloud(600, (9.0, 9.0, 9.0), 20) * 1024) / 1024
    queries = np.concatenate([
        rng.uniform(-2, 11, (200, 3)), pos[:6], pos[6:12] + [cutoff, 0, 0],
        [[1e9, -1e9, 1e9], [-40.0, 3.0, 3.0]]])
    radii = rng.uniform(1.0, 2.0, 600)
    payload = [radii, 1 / radii][:npl]
    qpl, qk, ppl, pk, strides, order = _jax_and_port_inputs(pos, queries, cutoff,
                                                            payload)
    want, ok_j = jax_join.join_reduce(
        tuple(jnp.asarray(x) for x in qpl), jnp.asarray(qk),
        tuple(jnp.asarray(x) for x in ppl), jnp.asarray(pk), jnp.asarray(strides),
        cutoff**2, term=jax_term, n_out=n_out, reducer=reducer, interpret=True)
    got, ok = join.join_reduce([torch.as_tensor(x) for x in qpl], torch.as_tensor(qk),
                               [torch.as_tensor(x) for x in ppl], torch.as_tensor(pk),
                               torch.as_tensor(strides), cutoff**2, term=port_term,
                               n_out=n_out, reducer=reducer)
    assert bool(ok) and bool(ok_j) and got.shape == (len(queries), n_out)
    got, want = got.numpy(), np.asarray(want)
    dsq = _brute_dsq(queries[order], pos)
    within = dsq <= cutoff**2
    if case == "count":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, 0], within.sum(1))
    elif case == "nearest":
        np.testing.assert_array_equal(got[:, 0], np.where(within, dsq, np.inf).min(1))
        np.testing.assert_allclose(got, want, rtol=4 * 2.0**-52, atol=0)
        assert (got[:, 0] == 0).sum() >= 6
    else:
        scale = np.abs(want).max(0)
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale.max())
    if case == "payload_sum":
        ref = (np.where(within, 2.25 - dsq, 0) * radii[None, :]).sum(1)
        np.testing.assert_allclose(got[:, 0], ref, rtol=0, atol=REL * np.abs(ref).max())


def test_max_reducer_multi_output_and_plain_only_terms():
    """A term outside the kernel's three instances runs on CPU tensors:
    n_out = 3 with the max reducer, the componentwise largest |d| over each
    query's neighbours, against brute force."""
    pos = _cloud(300, (5.0, 5.0, 5.0), 8)
    queries = _cloud(60, (5.0, 5.0, 5.0), 9)
    cutoff = 1.4
    grid = build(torch.as_tensor(pos), cutoff)

    def term(dsq, d, payload, within):
        return [torch.where(within, da.abs(), torch.full_like(dsq, -np.inf)) for da in d]

    out, valid, ok = join.grid_join_reduce(grid, torch.as_tensor(queries), term=term,
                                           n_out=3, reducer="max")
    assert bool(ok) and bool(valid.all())
    dvec = queries[:, None, :] - pos[None]
    w = _brute_dsq(queries, pos) <= cutoff**2
    ref = np.where(w[..., None], np.abs(dvec), -np.inf).max(1)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="reducer"):
        join.grid_join_reduce(grid, torch.as_tensor(queries), term=term, n_out=3,
                              reducer="prod")
    with pytest.raises(ValueError, match="3D"):
        join.grid_join_reduce(build(torch.as_tensor(pos[:, :2]), cutoff),
                              torch.as_tensor(queries[:, :2]), term=term, n_out=3)


@pytest.mark.parametrize("trial", range(6))
def test_count_and_nearest_fuzz(trial):
    """Random boxes, densities, cutoffs and query mixes against brute force
    (no JAX): queries straddling the box edges, coincident with particles,
    exactly at the cutoff and far away; `valid` is the `try_cell_index`
    rule and out-of-range queries see no particle."""
    rng = np.random.default_rng(300 + trial)
    n = int(rng.integers(1, 900))
    box = rng.uniform(1.0, 25.0, 3)
    cutoff = float(rng.integers(1, 8)) / 2
    pos = np.round(rng.uniform(0, 1, (n, 3)) * box * 256) / 256
    queries = np.concatenate([
        rng.uniform(-0.3, 1.3, (int(rng.integers(1, 300)), 3)) * box,
        pos[rng.integers(0, n, 3)],
        pos[rng.integers(0, n, 3)] + [0.0, cutoff, 0.0],
        [[1e9, 1e9, -1e9]],
    ])
    grid = build(torch.as_tensor(pos), cutoff)
    counts, valid, ok = join.count_neighbors(grid, torch.as_tensor(queries))
    nd, valid2, ok2 = join.nearest_dsq(grid, torch.as_tensor(queries))
    assert bool(ok) and bool(ok2) and torch.equal(valid, valid2)
    dsq = _brute_dsq(queries, pos)
    within = dsq <= cutoff**2
    lo = np.floor((queries - pos.min(0)) / cutoff)
    shape = np.floor((pos.max(0) - pos.min(0)) / cutoff) + 1
    np.testing.assert_array_equal(valid.numpy(), ((lo >= -1) & (lo <= shape)).all(1))
    np.testing.assert_array_equal(counts.numpy(), within.sum(1))
    np.testing.assert_array_equal(nd.numpy(), np.where(within, dsq, np.inf).min(1))
    assert counts.dtype == torch.int32 and not valid[-1]


def test_windowed_ladder_and_large_grid():
    """The plain version keeps the JAX package's windows: an undersized
    MAXJ flags instead of dropping silently, the ladder converges to brute
    force; above `JOIN_MAX_PARTICLES` the auto wrapper runs windowed and
    stays exact on key-local queries."""
    pos = _cloud(2000, (0.9, 0.9, 0.9), 30)
    queries = _cloud(64, (0.9, 0.9, 0.9), 31)
    grid = build(torch.as_tensor(pos), 1.0)
    ref = (_brute_dsq(queries, pos) <= 1.0).sum(1)
    _, _, ok1 = join.grid_join_reduce(grid, torch.as_tensor(queries),
                                      term=join._count_term, n_out=1, MAXJ=1)
    assert not bool(ok1)
    out, _, ok = join.grid_join_reduce(grid, torch.as_tensor(queries),
                                       term=join._count_term, n_out=1, MAXJ=16)
    assert bool(ok)
    np.testing.assert_array_equal(out[:, 0].numpy(), ref)

    n = join.JOIN_MAX_PARTICLES + 8000
    side = (n / 10.0) ** (1 / 3)
    pos = _cloud(n, (side, side, side), 40)
    queries = np.asarray([7.2, 7.05, 7.05]) + np.random.default_rng(41).uniform(
        0, 1.0, (100, 3)) * np.asarray([6.0, 0.8, 0.8])
    grid = build(torch.as_tensor(pos), 1.0)
    c, valid, ok = join.count_neighbors(grid, torch.as_tensor(queries))
    assert bool(ok) and bool(valid.all())
    np.testing.assert_array_equal(c.numpy(), (_brute_dsq(queries, pos) <= 1.0).sum(1))


def test_cellgrid_count_and_nearest_match_jax():
    """`CellGrid.count_neighbors_batch` and `nearest_neighbor_distances` on
    the CPU against the JAX `CellGrid` (one point set, padded to its
    capacity class, with far and coincident queries), and against the
    distance-filtered `neighbors` list."""
    pos = _cloud(300, (6.0, 6.0, 6.0), 10)
    rng = np.random.default_rng(11)
    queries = np.concatenate([_cloud(40, (6.0, 6.0, 6.0), 12),
                              rng.uniform(-40, 40, (5, 3)), pos[:3],
                              [[1e9, -1e9, 0.0]]])
    a = jax_api.CellGrid(pos, cutoff=1.3)
    b = CellGrid(pos, cutoff=1.3, device="cpu")
    counts, valid = b.count_neighbors_batch(queries)
    dists, valid2 = b.nearest_neighbor_distances(queries)
    want_c, want_v = a.count_neighbors_batch(queries)
    want_d, _ = a.nearest_neighbor_distances(queries)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(valid, want_v)
    np.testing.assert_array_equal(valid2, want_v)
    np.testing.assert_allclose(dists, want_d, rtol=4 * 2.0**-52, atol=0)
    assert counts.dtype == np.int64
    for qi, q in enumerate(queries):
        nb = b.neighbors(q)
        if nb is None:
            assert not valid[qi] and counts[qi] == 0 and np.isinf(dists[qi])
            continue
        assert counts[qi] == len(nb)
        if nb:
            np.testing.assert_allclose(
                dists[qi], min(np.linalg.norm(np.asarray(p) - q) for _, p in nb),
                rtol=1e-15)


@pytest.mark.parametrize("dim", [2, 4])
def test_cellgrid_queries_other_dims_and_empty(dim):
    """Grids that are not 3-D take the query path (the JAX `CellGrid` counts
    so, and its nearest raises there); empty grids give zero counts,
    infinite distances and no valid query. Held to brute force."""
    rng = np.random.default_rng(dim)
    pos = rng.uniform(0, 5, (400, dim))
    queries = np.concatenate([rng.uniform(-1, 6, (50, dim)), pos[:3]])
    cg = CellGrid(pos, cutoff=1.1, device="cpu")
    before = join.join_reduce.fallbacks
    counts, valid = cg.count_neighbors_batch(queries)
    dists, valid2 = cg.nearest_neighbor_distances(queries)
    assert join.join_reduce.fallbacks == before
    d = queries[:, None] - pos[None]
    dsq = (d * d).sum(-1)
    within = (dsq <= 1.1**2) & valid[:, None]
    np.testing.assert_array_equal(counts, within.sum(1))
    np.testing.assert_array_equal(valid, valid2)
    np.testing.assert_allclose(dists, np.sqrt(np.where(within, dsq, np.inf).min(1)),
                               rtol=1e-15)
    empty = CellGrid(np.zeros((0, dim)), cutoff=1.0, device="cpu")
    c, v = empty.count_neighbors_batch(queries)
    dd, _ = empty.nearest_neighbor_distances(queries)
    assert not c.any() and not v.any() and np.isinf(dd).all()
