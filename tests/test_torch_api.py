"""The port's `CellGrid` (zelll_tpu_torch.api, ``device="cpu"``) against the
JAX package's `CellGrid` on the same points, made with numpy from a seed,
against brute force where the JAX tests hold the JAX `CellGrid` to brute
force (other dimensions, the dense table), and the JAX package's doctest
contract run against the port. The JAX `CellGrid` runs eagerly, one
executable per operation, so it is called on two point sets only.

Tolerances: pair and index sets, neighbour lists, coordination numbers,
cells and flags exactly equal; pair sets are compared as sorted
(min, max) tuples, since pair order is unspecified (reference
iters.rs:251). f64 energies, virials and stresses to 1e-12 relative (to
the largest entry for the stress): the same terms, summed in another
order."""

import doctest
import pickle

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

import zelll_tpu.api as jax_api
import zelll_tpu_torch.api as port_api
from zelll_tpu_torch import CellGrid, GridCell

REL = 1e-12


def _grids(pts, cutoff=1.0, dense=False):
    return (jax_api.CellGrid(pts, cutoff=cutoff, dense=dense),
            CellGrid(pts, cutoff=cutoff, dense=dense, device="cpu"))


def _pairs(i, j):
    i, j = np.asarray(i), np.asarray(j)
    return sorted(zip(np.minimum(i, j).tolist(), np.maximum(i, j).tolist()))


def _iter_pairs(cg):
    """The pairs the iterator yields, as sorted (min, max) tuples, after
    checking the coordinates it yields with them."""
    items = list(cg)
    ids = np.array([[a, b] for (a, _), (b, _) in items], np.int64).reshape(-1, 2)
    coords = np.array([[p, q] for (_, p), (_, q) in items]).reshape(len(items), 2, -1)
    np.testing.assert_array_equal(coords, cg.positions[ids])
    return sorted(zip(ids.min(1).tolist(), ids.max(1).tolist()))


def _same_grid(a, b, rng):
    """Every method of the reference surface, and the extensions, on two
    grids that should agree."""
    dim = a.positions.shape[1]
    assert b.cutoff() == a.cutoff() and b.aabb() == a.aabb()
    cand = _iter_pairs(b)
    assert cand == _iter_pairs(a) and len(set(cand)) == len(cand)
    assert _pairs(*b.pairs()) == cand
    assert _pairs(*b.pairs(within_cutoff=True)) == _pairs(*a.pairs(within_cutoff=True))
    e = a.lj_energy()
    assert abs(b.lj_energy() - e) <= REL * abs(e)
    w = a.virial()
    assert abs(b.virial() - w) <= REL * abs(w)
    s, t = a.stress(), b.stress()
    assert t.shape == (dim, dim)
    np.testing.assert_allclose(t, s, rtol=0, atol=REL * np.abs(s).max())
    assert abs(np.trace(t) - b.virial()) <= 1e-9 * abs(w)
    if dim == 3:
        c = b.coordination_numbers()
        assert c.dtype == np.int64
        np.testing.assert_array_equal(c, a.coordination_numbers())
    q = np.vstack([rng.uniform(-0.5, 5.5, (6, dim)), b.positions[:3],
                   [[99.0] * dim]])
    ids_b, ok_b = b.query_neighbors_batch(q)
    ids_a, ok_a = a.query_neighbors_batch(q)
    np.testing.assert_array_equal(ok_b, ok_a)
    for x, y in zip(ids_b, ids_a):
        np.testing.assert_array_equal(np.sort(x), np.sort(y))
    for p in q:
        nb, na = b.neighbors(p), a.neighbors(p)
        qb, qa = b.query_neighbors(p), a.query_neighbors(p)
        assert (nb is None) == (na is None) == (qb is None) == (qa is None)
        if nb is not None:
            assert sorted(nb) == sorted(na)
            assert sorted(i for i, _ in qb) == sorted(i for i, _ in qa)


def _brute(pts, cutoff):
    """(cutoff pairs, coordination, energy, virial, stress) in f64."""
    d = pts[:, None] - pts[None]
    dsq = (d * d).sum(-1)
    i, j = np.nonzero(np.triu(dsq < cutoff**2, 1))
    v = dsq[i, j]
    t = (1.0 / v) ** 3
    g = 24.0 * t * (2.0 * t - 1.0) / v
    dd = d[i, j]
    stress = (g[:, None, None] * dd[:, :, None] * dd[:, None, :]).sum(0)
    coord = np.bincount(np.concatenate([i, j]), minlength=len(pts))
    return (sorted(zip(i.tolist(), j.tolist())), coord,
            float((4 * t * (t - 1)).sum()), float((g * v).sum()), stress)


def test_cellgrid_matches_jax():
    """Construction, iteration, pairs, energies, virial, stress,
    coordination numbers, point queries, pickle and repr against the JAX
    package's `CellGrid` on the same points."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (700, 3)) * np.array([5.0, 6.0, 7.0])
    a, b = _grids(pts, 1.0)
    assert b.device == torch.device("cpu") and b.grid_data.sorted_pos.dtype == torch.float64
    assert repr(b) == repr(a)
    _same_grid(a, b, rng)
    c = pickle.loads(pickle.dumps(b))
    assert c.device == b.device and c.cutoff() == 1.0
    np.testing.assert_array_equal(c.positions, b.positions)
    assert _pairs(*c.pairs(True)) == _pairs(*b.pairs(True))


@pytest.mark.parametrize("dim,dense", [(3, True), (2, False), (4, False), (2, True)],
                         ids=["3d_dense", "2d", "4d", "2d_dense"])
def test_cellgrid_matches_bruteforce(dim, dense):
    """The other dimensions and the dense cell table, against brute force
    (as tests/test_cell_api.py and tests/test_dense.py hold the JAX
    `CellGrid`): pairs, energies, virial, stress, coordination numbers
    (3-D), queries and neighbours, and pickle keeps the dense flag."""
    rng = np.random.default_rng(dim + 10 * dense)
    pts = rng.uniform(0, 1, (400, dim)) * np.array([5.0, 6.0, 7.0, 3.0][:dim])
    b = CellGrid(pts, cutoff=1.0, dense=dense, device="cpu")
    assert (b._dense is not None) == dense
    within, coord, energy, virial, stress = _brute(pts, 1.0)
    assert _pairs(*b.pairs(within_cutoff=True)) == within
    cand = _iter_pairs(b)
    assert len(set(cand)) == len(cand) and set(within) <= set(cand)
    assert _pairs(*b.pairs()) == cand
    assert abs(b.lj_energy() - energy) <= REL * abs(energy)
    assert abs(b.virial() - virial) <= REL * abs(virial)
    s = b.stress()
    np.testing.assert_allclose(s, stress, rtol=0, atol=REL * np.abs(stress).max())
    if dim == 3:
        np.testing.assert_array_equal(b.coordination_numbers(), coord)
    q = np.vstack([rng.uniform(-0.5, 5.5, (6, dim)), pts[:3], [[99.0] * dim]])
    ids, ok = b.query_neighbors_batch(q)
    assert not ok[-1] and b.neighbors(q[-1]) is None and b.query_neighbors(q[-1]) is None
    for k, p in enumerate(q[:-1]):
        near = set(np.nonzero(((pts - p) ** 2).sum(-1) <= 1.0)[0].tolist())
        assert ok[k] and near <= set(ids[k].tolist())
        assert sorted(i for i, _ in b.neighbors(p)) == sorted(near)
        assert sorted(i for i, _ in b.query_neighbors(p)) == sorted(ids[k].tolist())
    c = pickle.loads(pickle.dumps(b))
    assert c._use_dense == dense and (c._dense is not None) == dense
    assert _pairs(*c.pairs(True)) == within


def test_rebuild_matches_fresh_build():
    """`rebuild` in the same capacity class (jittered positions, the
    functional rebuild underneath, held to JAX's in
    tests/test_torch_pairs.py), with fewer points, with a new cutoff, into
    another class, and from empty, each against a grid built afresh from
    the same points (which the tests above hold to JAX's and to brute
    force); handles taken before a rebuild keep their snapshot."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (300, 3)) * 4.0
    b = CellGrid(pts, 1.0, device="cpu")
    cell = b.query(pts[0])
    before = list(cell)
    moved = pts + rng.normal(0, 0.05, pts.shape)
    bigger = rng.uniform(0, 1, (600, 3)) * 5.0
    for args in ((moved,), (moved[:280],), (moved[:280], 1.5), (bigger,)):
        n_pad = b.grid_data.n
        b.rebuild(*args)
        if len(args[0]) in (300, 280):
            assert b.grid_data.n == n_pad  # 300 and 280 share a capacity class
        _same_grid(CellGrid(args[0], b.cutoff(), device="cpu"), b, rng)
    assert list(cell) == before
    empty = CellGrid(device="cpu")
    assert list(empty) == [] == list(jax_api.CellGrid()) and empty.cutoff() == 1.0
    assert empty.coordination_numbers().shape == (0,)
    assert empty.lj_energy() == 0.0 and empty.query([0.0, 0.0, 0.0]) is None
    empty.rebuild(pts, 0.5)
    _same_grid(CellGrid(pts, 0.5, device="cpu"), empty, rng)


def test_per_cell_surface_matches_jax():
    """`query`, `cells`, `GridCell` (len, iteration, neighbours full and
    half, particle_pairs) cell by cell, an empty cell, one and two layers
    outside; the per-cell pairs cover the grid's candidate pairs once."""
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform(0, 1, (150, 3)) * 3.0,
                          rng.uniform(0, 1, (50, 3)) + 8.0])
    a, b = _grids(pts)
    cells_a, cells_b = list(a.cells()), list(b.cells())
    assert [c.index for c in cells_b] == [c.index for c in cells_a]
    per_cell = []
    for ca, cb in zip(cells_a, cells_b):
        assert isinstance(cb, GridCell) and repr(cb) == repr(ca)
        assert len(cb) == len(ca) > 0 and list(cb) == list(ca) == list(cb.particles())
        for space in ("full", "half"):
            assert [c.index for c in cb.neighbors(space)] == \
                [c.index for c in ca.neighbors(space)]
        pp = cb.particle_pairs()
        assert pp == ca.particle_pairs()
        per_cell += [(min(i, j), max(i, j)) for (i, _), (j, _) in pp]
    assert sorted(per_cell) == _pairs(*b.pairs())
    with pytest.raises(ValueError):
        cells_b[0].neighbors("diagonal")
    for q in (pts[0], [5.5, 5.5, 5.5], pts.min(0) - 0.5, pts.min(0) - 2.5,
              pts.max(0) + 2.5):
        qa, qb = a.query(q), b.query(q)
        assert (qa is None) == (qb is None)
        if qb is not None:
            assert qb.index == qa.index and list(qb) == list(qa)
    mid = b.query([5.5, 5.5, 5.5])
    assert len(mid) == 0 and list(mid) == [] and mid.particle_pairs() == []


def test_doctest_contract():
    """The JAX package's `CellGrid` examples (zelll_tpu/api.py) run against
    the port on the CPU, and so do the port's own examples."""
    examples = doctest.DocTestFinder().find(jax_api.CellGrid, "CellGrid")[0]
    assert len(examples.examples) > 10
    examples.globs = {"CellGrid": lambda *a, **k: CellGrid(*a, device="cpu", **k)}
    runner = doctest.DocTestRunner(optionflags=doctest.NORMALIZE_WHITESPACE
                                   | doctest.ELLIPSIS)
    runner.run(examples)
    assert runner.failures == 0 and runner.tries == len(examples.examples)
    res = doctest.testmod(port_api, optionflags=doctest.NORMALIZE_WHITESPACE
                          | doctest.ELLIPSIS)
    assert res.attempted > 10 and res.failed == 0


def test_inputs_and_later_slices():
    """Generic iterables skip bad items (reference lib.rs:40-58), tensors
    and arrays are taken as they are, dim >= 2; the batch queries of slice
    8 and the distance histogram of slice 6a answer (held to brute
    force)."""
    items = [[0.0, 0.0, 0.0], "garbage", [1.0, 1.0, 1.0], [1, 2], None, (0.5, 0.5, 0.5)]
    assert len(CellGrid(iter(items), 1.0, device="cpu").positions) == 3
    pts = np.random.default_rng(4).uniform(0, 3, (60, 3))
    t = CellGrid(torch.as_tensor(pts), 0.7)
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.positions, pts)
    with pytest.raises(TypeError, match="dim>=2"):
        CellGrid(np.zeros((2, 1)), device="cpu")
    one = CellGrid(pts[:1], device="cpu")
    assert one.coordination_numbers().tolist() == [0] and one.pairs()[0].size == 0
    np.testing.assert_array_equal(one.stress(), np.zeros((3, 3)))
    counts, valid = t.count_neighbors_batch(pts[:4])
    dists, _ = t.nearest_neighbor_distances(pts[:4])
    dsq = ((pts[:4, None] - pts[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(counts, (dsq <= 0.49).sum(1))
    assert valid.all() and not dists.any()  # each query is a particle
    edges = np.linspace(0, 1, 5)
    iu = np.triu_indices(len(pts), 1)
    want = np.histogram(np.sqrt(((pts[iu[0]] - pts[iu[1]]) ** 2).sum(-1)), bins=edges)[0]
    np.testing.assert_array_equal(t.distance_histogram(edges), want)
