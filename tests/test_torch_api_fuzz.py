"""Seeded random configurations through the port's `CellGrid` on the CPU,
held to numpy brute force. Each seed draws a dimension (2 to 4, mostly
3), a box shape (cubic, thin or slab), a density, a cutoff, the dense
cell table or the binary search, and a particle count that lands below or
inside a capacity class (so the far padding rows of `api._pad_far` are
there or not), and checks:

* `pairs(within_cutoff=True)` equals the brute-force set of pairs with
  dsq < cutoff^2; the candidate pairs of `pairs()` and `__iter__` are
  unique and hold every cutoff pair;
* `lj_energy`, `virial` and `stress` equal their brute-force sums to 1e-9
  (f64 sums in another order), and trace(stress) equals the virial;
* in 3-D, `coordination_numbers` (K2's plain version at the probed lag
  bound) equals the brute-force counts exactly;
* `query_neighbors_batch` holds every particle within the cutoff of each
  query point, and `neighbors` equals the brute-force list (<= cutoff);
* after a `rebuild` with moved points in the same capacity class, the
  cutoff pairs and the coordination numbers are those of the moved points.

Everything runs on CPU tensors and calls no JAX."""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu_torch import CellGrid

SEEDS = range(206)
SHAPES = {"cubic": (1.0, 1.0, 1.0, 1.0), "thin": (0.25, 0.25, 4.0, 0.5),
          "slab": (2.0, 2.0, 0.2, 1.0)}
TOL = 1e-9


def _config(seed):
    """(points, cutoff, dense) of one seed; no two points closer than
    1e-3 (LJ sums stay finite)."""
    rng = np.random.default_rng(7000 + seed)
    dim = int(rng.choice([2, 3, 3, 3, 4]))
    cutoff = float(rng.uniform(0.6, 1.8))
    aspect = np.asarray(SHAPES[list(SHAPES)[seed % len(SHAPES)]][:dim])
    n = int(rng.integers(2, 260))
    density = float(rng.uniform(0.3, 3.0))  # particles per cutoff^dim
    side = (n / density / np.prod(aspect)) ** (1.0 / dim) * cutoff
    extent = np.maximum(side * aspect, 0.3 * cutoff)
    pts = rng.uniform(0, 1, (n, dim)) * extent + rng.uniform(-5, 5, dim)
    d = pts[:, None] - pts[None]
    dsq = (d * d).sum(-1)
    np.fill_diagonal(dsq, np.inf)
    keep = ~np.triu(dsq < 1e-6, 1).any(0)
    return pts[keep], cutoff, bool(seed % 3 == 0), rng


def _brute(pts, cutoff):
    """(cutoff pairs, coordination, energy, virial, stress) in f64."""
    d = pts[:, None] - pts[None]
    dsq = (d * d).sum(-1)
    inside = np.triu(dsq < cutoff**2, 1)
    i, j = np.nonzero(inside)
    v = dsq[i, j]
    t = (1.0 / v) ** 3
    g = 24.0 * t * (2.0 * t - 1.0) / v
    dd = d[i, j]
    stress = (g[:, None, None] * dd[:, :, None] * dd[:, None, :]).sum(0)
    coord = np.bincount(np.concatenate([i, j]), minlength=len(pts))
    return (set(zip(i.tolist(), j.tolist())), coord, float((4 * t * (t - 1)).sum()),
            float((g * v).sum()), stress)


def _pairs(i, j):
    return [(min(a, b), max(a, b)) for a, b in zip(i.tolist(), j.tolist())]


def _close(got, want):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("seed", SEEDS)
def test_cellgrid_matches_bruteforce(seed):
    pts, cutoff, dense, rng = _config(seed)
    n, dim = pts.shape
    cg = CellGrid(pts, cutoff, dense=dense, device="cpu")
    within, coord, energy, virial, stress = _brute(pts, cutoff)

    got = _pairs(*cg.pairs(within_cutoff=True))
    assert len(got) == len(set(got)) and set(got) == within
    cand = _pairs(*cg.pairs())
    assert len(cand) == len(set(cand)) and within <= set(cand)
    assert sorted((min(a, b), max(a, b)) for (a, _), (b, _) in cg) == sorted(cand)
    _close(cg.lj_energy(), energy)
    _close(cg.virial(), virial)
    s = cg.stress()
    _close(s, stress)
    _close(np.trace(s), cg.virial())
    if dim == 3:
        np.testing.assert_array_equal(cg.coordination_numbers(), coord)

    q = np.vstack([rng.uniform(pts.min(0) - cutoff, pts.max(0) + cutoff, (6, dim)),
                   pts[:2]])
    ids, ok = cg.query_neighbors_batch(q)
    for k, p in enumerate(q):
        dsq = ((pts - p) ** 2).sum(-1)
        near = set(np.nonzero(dsq <= cutoff**2)[0].tolist())
        if ok[k]:
            assert near <= set(ids[k].tolist())
            assert sorted(i for i, _ in cg.neighbors(p)) == sorted(near)
        else:
            assert not near and cg.neighbors(p) is None

    moved = pts + rng.uniform(-0.05, 0.05, pts.shape) * cutoff
    cg.rebuild(moved)
    within, coord, *_ = _brute(moved, cutoff)
    assert set(_pairs(*cg.pairs(within_cutoff=True))) == within
    if dim == 3:
        np.testing.assert_array_equal(cg.coordination_numbers(), coord)
