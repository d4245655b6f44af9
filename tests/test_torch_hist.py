"""The port's pair-distance histograms (the plain versions of K5 in
ops.lag_pairs and K9 in ops.tile_pairs, ops.rdf, CellGrid.distance_histogram)
against the JAX package's `pair_lag_hist` and `tile_pair_hist` (Pallas,
interpret mode) on identical sorted inputs, and against brute force. The
CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py.

Counts are integers, so every comparison is exact. Against JAX the data
are checked tie-free first: no pair's f32 dsq lies within 4 ulp of an edge,
since XLA:CPU may contract the JAX kernel's dsq into fused multiply-adds,
where the port rounds every product. Against brute force the brute force
repeats the port's rounding. Each JAX kernel runs once per configuration
under one `jax.jit`; the tile ones with CB=1 (see tests/test_torch_stress.py).

The periodic `rdf` (ghost images and the minimum image, lag and tile,
species partials) runs in f64 and is held exactly to the JAX package's
`_pbc_cum_hist` counts and to a numpy minimum-image brute force, g(r)
through the same normalisation to 1e-12; those data are checked tie-free
against the brute force's f64 dsq (no dsq within 1e-12 of a squared edge:
the ghost shift and the fold round the separation otherwise than the
brute force's round(d / box))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_slab
from test_torch_stress import edge_cluster
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.ops.rdf import _pbc_cum_hist as jax_pbc_cum_hist
from zelll_tpu.ops.rdf import _species_mask as jax_species_mask
from zelll_tpu.ops.rdf import rdf as jax_rdf
from zelll_tpu.ops.rdf import rdf_normalize as jax_rdf_normalize
from zelll_tpu.ops.rdf import rdf_normalize_partial as jax_rdf_normalize_partial
from zelll_tpu.ops.pallas_pairs import combine_count_vec as jax_combine_count_vec
from zelll_tpu.ops.pallas_pairs import pair_lag_hist as jax_lag_hist
from zelll_tpu.ops.tile_pairs import tile_pair_hist as jax_tile_hist
from zelll_tpu_torch import CellGrid
from zelll_tpu_torch.core import build
from zelll_tpu_torch.ops.lag_pairs import (
    SpeciesPairMask,
    combine_count_vec,
    pair_lag_hist,
    split_f64,
    suggest_lag,
)
from zelll_tpu_torch.ops.rdf import (
    pair_distance_histogram,
    rdf,
    rdf_normalize,
    rdf_normalize_partial,
)
from zelll_tpu_torch.ops.tile_pairs import tile_pair_hist


def pair_dsq(p, lo=None, mask=None):
    """dsq of every unique pair of sorted positions in the port's rounding
    (per axis d = p_j - p_i, split d = (hi_j - hi_i) + (lo_j - lo_i), summed
    axis by axis in the positions' dtype), optionally masked by
    ``mask(i, j)``."""
    i, j = np.triu_indices(len(p), 1)
    if mask is not None:
        keep = mask(i, j)
        i, j = i[keep], j[keep]
    d = p[j] - p[i]
    if lo is not None:
        d = d + (lo[j] - lo[i])
    dsq = d[:, 0] * d[:, 0]
    for a in range(1, p.shape[1]):
        dsq = dsq + d[:, a] * d[:, a]
    return dsq


def cumulative(dsq, edges_sq):
    """count_k = #pairs with dsq < edges_sq[k] (dsq < edges_sq[-1] implied)."""
    return np.array([(dsq < e).sum() for e in edges_sq], np.int64)


def assert_tie_free(dsq, edges_sq):
    e = np.asarray(edges_sq, np.float32)
    gap = np.abs(dsq[:, None].astype(np.float64) - e[None, :].astype(np.float64))
    assert np.all(gap > 4 * np.spacing(np.maximum(e, 1e-30))[None, :])


def brute_shells(pts, edges):
    """Shell counts of unique f64 pair distances (tests/test_rdf.py), row
    block by row block."""
    out = np.zeros(len(edges) - 1, np.int64)
    for s in range(0, len(pts), 512):
        d = pts[s:s + 512, None, :] - pts[None, :, :]
        dist = np.sqrt((d * d).sum(-1))
        i, j = np.nonzero(np.arange(s, s + len(d))[:, None] < np.arange(len(pts))[None, :])
        out += np.histogram(dist[i, j], bins=np.asarray(edges))[0]
    return out


def pbc_shells(pts, box, edges, species=None, pair=None):
    """Minimum-image shell counts of unique pairs (f64, tests/test_rdf.py's
    brute_hist_pbc), optionally of the species pair {a, b}; asserts that no
    dsq lies within 1e-12 of a squared edge."""
    d = pts[:, None] - pts[None]
    d -= box * np.round(d / box)
    dsq = (d * d).sum(-1)
    i, j = np.triu_indices(len(pts), 1)
    keep = np.ones(len(i), bool)
    if species is not None:
        a, b = pair
        keep = ((species[i] == a) & (species[j] == b)) | ((species[i] == b) & (species[j] == a))
    dsq = dsq[i, j][keep]
    esq = np.asarray(edges, np.float64) ** 2
    assert np.abs(dsq[:, None] - esq[None, :]).min() > 1e-12
    return np.histogram(np.sqrt(dsq), bins=edges)[0]


def pbc_g(counts, edges, n, box, species=None, pair=None):
    """The port's normalisation of shell counts (held to the JAX package's
    in `test_rdf_normalization_and_packing_match_jax`)."""
    vol = float(np.prod(box))
    if pair is None:
        return rdf_normalize(counts, edges, n, vol)[1]
    na, nb = int((species == pair[0]).sum()), int((species == pair[1]).sum())
    return rdf_normalize_partial(counts, edges, na, nb, vol, pair[0] == pair[1])[1]


# periodic rdf configurations (tests/test_rdf.py): ghost images on a cube,
# a partial fold (x and y, z ghosts) and "auto" on a narrow box (x and y)
PBC_RDF = {"ghosts": (600, (8.0, 8.0, 8.0), np.linspace(0.2, 2.0, 10), False, 9),
           "minimage": (400, (2.2, 2.2, 40.0), np.linspace(0.2, 1.0, 9), "auto", 50),
           "minimage_narrow": (300, (2.2, 2.4, 2.6), np.linspace(0.3, 1.0, 7), "auto", 52)}


def _sorted(pts, cutoff, cols=()):
    """The port's sorted positions, extra columns, keys and strides as
    numpy arrays (a grid of cell edge ``cutoff``)."""
    g = build(np.concatenate([pts, *[c.reshape(len(pts), -1) for c in cols]], 1),
              cutoff, device="cpu")
    sp = g.sorted_pos.numpy()
    return sp[:, :3], sp[:, 3:], g.bins.sorted_keys.numpy(), g.info.strides.numpy()


EDGES = np.linspace(0.35, 1.5, 17)


@pytest.mark.parametrize("mode", ["f32", "split", "species"])
def test_lag_hist_matches_jax(mode):
    rng = np.random.default_rng(40)
    pts = rng.uniform(0, 1, (900, 3)) * [4.0, 4.0, 30.0]
    species = rng.integers(0, 3, 900).astype(np.float64)
    lo = None
    if mode == "split":
        pts = pts + [0.0, 0.0, 3000.0]
        sp64, _, keys, strides = _sorted(pts, 1.5)
        hi, lo = (t.numpy() for t in split_f64(torch.as_tensor(sp64)))
        sp = hi
    else:
        sp, spec, keys, strides = _sorted(pts.astype(np.float32), 1.5,
                                          [species.astype(np.float32)])
        spec = spec[:, 0]
    esq = EDGES.astype(np.float32) ** 2
    L = suggest_lag(keys, strides)
    kw = dict(M=max(256, L), L=L, interpret=True)
    if mode == "species":
        def mask(i, j):
            return ((spec[i] == 0) & (spec[j] == 2)) | ((spec[i] == 2) & (spec[j] == 0))

        want = jax.jit(lambda p, k, s, w: jax_lag_hist(
            p, k, s, jnp.asarray(esq), None, w, pair_mask=jax_species_mask(0, 2),
            **kw))(sp, keys, strides, spec[:, None])
        got = pair_lag_hist(torch.as_tensor(sp), torch.as_tensor(keys),
                            torch.as_tensor(strides), esq, None,
                            torch.as_tensor(spec[:, None]),
                            pair_mask=SpeciesPairMask(0, 2), L=L)
        dsq = pair_dsq(sp, mask=mask)
    else:
        want = jax.jit(lambda p, k, s, q: jax_lag_hist(p, k, s, jnp.asarray(esq), q,
                                                        **kw))(sp, keys, strides, lo)
        got = pair_lag_hist(torch.as_tensor(sp), torch.as_tensor(keys),
                            torch.as_tensor(strides), esq,
                            None if lo is None else torch.as_tensor(lo), L=L)
        dsq = pair_dsq(sp, lo)
    dsq = dsq[dsq < esq[-1]]
    assert_tie_free(dsq, esq)
    assert got.dtype == torch.int32 and got.shape == (2, len(esq))
    counts = combine_count_vec(got)
    np.testing.assert_array_equal(counts, jax_combine_count_vec(np.asarray(want)))
    np.testing.assert_array_equal(counts, cumulative(dsq, esq))
    if mode != "species":
        return
    # periodic: `rdf` on the lag path (K5 with the keep mask, the minimum
    # image and both) and its species partial (the keep mask composed with
    # the species mask, or the species mask under a full fold), in f64,
    # against the JAX package's counts (one jitted call) and the brute force
    cases = {}
    for name, (n, box, edges, mi, seed) in PBC_RDF.items():
        r = np.random.default_rng(seed)
        box = np.asarray(box)
        cases[name] = (r.uniform(0, 1, (n, 3)) * box, box, edges, mi, r.integers(0, 2, n))

    @jax.jit
    def ref(inputs):
        out = {}
        for name, (_, box, edges, mi, _) in cases.items():
            p, spec = inputs[name]
            kw = dict(positions_lo=None, B=None, G=None, M=512, L=512, interpret=True,
                      minimage=mi)
            out[name] = jax_pbc_cum_hist(p, np.zeros(3), box, edges, **kw)
            out[name + "_species"] = jax_pbc_cum_hist(p, np.zeros(3), box, edges,
                                                      species=spec, pair=(0, 1), **kw)
        return out

    want = jax.tree_util.tree_map(np.asarray, ref({k: (v[0], v[4]) for k, v in cases.items()}))
    for name, (pts, box, edges, mi, spec) in cases.items():
        for tag, kw in ((name, {}), (name + "_species", dict(species=spec, pair=(0, 1)))):
            r_mid, g, ok = rdf(torch.as_tensor(pts), np.zeros(3), box, edges, L=512,
                               minimage=mi, **kw)
            wc = jax_combine_count_vec(want[tag][0])
            assert ok and bool(want[tag][1]), tag
            shells = pbc_shells(pts, box, edges, kw.get("species"), kw.get("pair"))
            np.testing.assert_array_equal(wc[1:] - wc[:-1], shells, err_msg=tag)
            np.testing.assert_allclose(g, pbc_g(shells, edges, len(pts), box, **kw),
                                       rtol=1e-12)
            np.testing.assert_array_equal(r_mid, 0.5 * (edges[1:] + edges[:-1]))


TILE_CASES = {  # (n, side, cutoff, bandmask, species pair, split, flag)
    "maskless": (800, 8.0, 1.5, False, None, False, True),
    "masked_species_split": (800, 8.0, 1.5, True, (1, 1), True, True),
    "dense_maskless_flag": (1500, 2.0, 1.0, False, None, False, False),
}


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_hist_matches_jax(case):
    n, side, cutoff, bandmask, pair, split, flag = TILE_CASES[case]
    rng = np.random.default_rng(41)
    pts = rng.uniform(0, side, (n, 3)) + (500.0 if split else 0.0)
    species = rng.integers(0, 3, n).astype(np.float32)
    sp64, spec, keys, strides = _sorted(pts, cutoff, [species.astype(np.float64)])
    spec = spec[:, 0]
    hi, lo = (t.numpy() for t in split_f64(torch.as_tensor(sp64)))
    lo = lo if split else None
    esq = np.linspace(0.2, cutoff, 13).astype(np.float32) ** 2
    kw = dict(MAXJ=4, CB=1, bandmask=bandmask)
    mask = None if pair is None else jax_species_mask(*pair)
    want, ok_j = jax.jit(lambda p, k, s, q, w: jax_tile_hist(
        p, k, s, jnp.asarray(esq), q, w, pair_mask=mask, interpret=True, **kw))(
            hi, keys, strides, lo, None if pair is None else spec)
    got, ok = tile_pair_hist(
        torch.as_tensor(hi), torch.as_tensor(keys), torch.as_tensor(strides), esq,
        None if lo is None else torch.as_tensor(lo),
        None if pair is None else torch.as_tensor(spec),
        pair_mask=None if pair is None else SpeciesPairMask(*pair), **kw)
    assert bool(ok) == bool(ok_j) == flag
    counts = combine_count_vec(got)
    np.testing.assert_array_equal(counts, jax_combine_count_vec(np.asarray(want)))
    if flag:
        keep = None if pair is None else (lambda i, j: (spec[i] == pair[0]) & (spec[j] == pair[1]))
        dsq = pair_dsq(hi, lo, keep)
        dsq = dsq[dsq < esq[-1]]
        assert_tie_free(dsq, esq)
        np.testing.assert_array_equal(counts, cumulative(dsq, esq))
    if case != "maskless":
        return
    # periodic: `rdf(path="tile")` (K9 with the keep mask over the payload
    # row) against the JAX package's counts and the brute force, f64
    box, edges = np.full(3, 9.0), np.linspace(0.3, 2.2, 8)
    pts = np.random.default_rng(29).uniform(0, 1, (500, 3)) * box
    want, ok_j = jax.jit(lambda p: jax_pbc_cum_hist(
        p, np.zeros(3), box, edges, positions_lo=None, B=None, G=None, M=512,
        L=512, interpret=True, path="tile", CB=1, MAXJ=16))(pts)
    _, g, ok = rdf(torch.as_tensor(pts), np.zeros(3), box, edges, path="tile", CB=1,
                   MAXJ=16)
    wc = jax_combine_count_vec(np.asarray(want))
    shells = pbc_shells(pts, box, edges)
    assert ok and bool(ok_j)
    np.testing.assert_array_equal(wc[1:] - wc[:-1], shells)
    np.testing.assert_allclose(g, pbc_g(shells, edges, len(pts), box), rtol=1e-12)


@pytest.mark.parametrize("path", ["lag", "tile"])
@pytest.mark.parametrize("n,box,rmax", [
    (500, (6.0, 6.0, 6.0), 1.5),
    (400, (2.0, 2.0, 80.0), 2.0),  # thin (bench-like) box
    (64, (1.0, 1.0, 1.0), 0.7),    # dense clump
], ids=["cube", "thin", "clump"])
def test_pair_distance_histogram_vs_bruteforce(n, box, rmax, path):
    """tests/test_rdf.py's cases on both paths (f64 points)."""
    rng = np.random.default_rng(n)
    pts = rng.uniform(0, 1, size=(n, 3)) * np.asarray(box)
    edges = np.linspace(0.0, rmax, 17)
    counts, ok = pair_distance_histogram(torch.as_tensor(pts), edges, L=256,
                                         path=path, MAXJ=16)
    assert ok and counts.dtype == np.int64
    np.testing.assert_array_equal(counts, brute_shells(pts, edges))


def test_hist_2d_and_split():
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 5, size=(300, 2))
    edges = np.linspace(0.0, 1.2, 9)
    counts, ok = pair_distance_histogram(torch.as_tensor(pts), edges, L=256)
    assert ok
    np.testing.assert_array_equal(counts, brute_shells(pts, edges))
    pts = rng.uniform(0, 1, size=(400, 3)) * np.array([3.0, 3.0, 9000.0])
    edges = np.linspace(0.0, 2.0, 13)
    hi, lo = split_f64(torch.as_tensor(pts))
    for path in ("lag", "tile"):
        counts, ok = pair_distance_histogram(hi, edges, positions_lo=lo, L=256,
                                             path=path, MAXJ=16)
        assert ok
        np.testing.assert_array_equal(counts, brute_shells(pts, edges))


@pytest.mark.parametrize("path", ["lag", "tile"])
def test_hist_nonuniform_edges_and_underflow(path):
    """edges[0] > 0 excludes closer pairs; uneven shells bin exactly."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 4, size=(350, 3))
    edges = np.array([0.3, 0.5, 1.0, 1.1, 1.7])
    counts, ok = pair_distance_histogram(torch.as_tensor(pts), edges, L=512,
                                         path=path, MAXJ=16)
    assert ok
    np.testing.assert_array_equal(counts, brute_shells(pts, edges))


def test_hist_species_partial_and_coincident_pairs():
    """Partial histograms on both paths against brute force over the pair
    {0, 2}; coincident points count in every bin above 0 (no dsq > 0 test)."""
    rng = np.random.default_rng(19)
    pts = rng.uniform(0, 5, size=(400, 3))
    pts[300:320] = pts[:20]
    species = rng.integers(0, 3, 400)
    edges = np.array([0.0, 0.5, 1.0, 1.5])
    i, j = np.triu_indices(400, 1)
    keep = ((species[i] == 0) & (species[j] == 2)) | ((species[i] == 2) & (species[j] == 0))
    dist = np.linalg.norm(pts[i] - pts[j], axis=1)
    want = np.histogram(dist[keep], bins=edges)[0]
    for path in ("lag", "tile"):
        counts, ok = pair_distance_histogram(torch.as_tensor(pts), edges, path=path,
                                             L=512, MAXJ=16, species=species,
                                             pair=(0, 2))
        assert ok
        np.testing.assert_array_equal(counts, want)
        counts, ok = pair_distance_histogram(torch.as_tensor(pts), edges, path=path,
                                             L=512, MAXJ=16)
        assert ok and counts[0] == (dist < 0.5).sum() >= 20
    with pytest.raises(ValueError, match="go together"):
        pair_distance_histogram(torch.as_tensor(pts), edges, species=species)


def test_hist_coverage_flags():
    """An undersized L or MAXJ trips the flag instead of silently dropping."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, size=(2000, 3)) * np.array([4.0, 4.0, 4.0])
    edges = np.linspace(0.0, 2.0, 5)
    _, ok = pair_distance_histogram(torch.as_tensor(pts), edges, L=128)
    assert not ok
    _, ok = pair_distance_histogram(torch.as_tensor(pts), edges, path="tile", MAXJ=1)
    assert not ok
    # the slab decomposition's histograms (parallel.sharded_pair_hist)
    torch_slab.histograms()


def test_tile_hist_limits_raise_on_both_packages():
    """K <= 64 and sum(MAXJ) <= 255 (after clamping to the chunk count)."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 30, (3000, 3)).astype(np.float32)
    sp, _, keys, strides = _sorted(pts, 1.0)
    wide = np.linspace(0.1, 1.0, 65).astype(np.float32) ** 2
    ok_edges = wide[:64]
    args = (torch.as_tensor(sp), torch.as_tensor(keys), torch.as_tensor(strides))
    with pytest.raises(ValueError, match="K = 65"):
        tile_pair_hist(*args, wide)
    with pytest.raises(AssertionError):
        jax.jit(lambda p, k, s: jax_tile_hist(p, k, s, jnp.asarray(wide),
                                              interpret=True))(sp, keys, strides)
    # 3000 points pad to CB = 64 chunks: 5 bands x 52 > 255
    with pytest.raises(ValueError, match="sum\\(MAXJ\\)"):
        tile_pair_hist(*args, ok_edges, MAXJ=52, CB=64)
    with pytest.raises(ValueError, match="sum\\(MAXJ\\)"):
        jax.jit(lambda p, k, s: jax_tile_hist(p, k, s, jnp.asarray(ok_edges), MAXJ=52,
                                              CB=64, interpret=True))(sp, keys, strides)
    # 5 x 51 fits, and with CB = 8 (24 chunks) MAXJ = 52 clamps to 24 per band
    for maxj, cb in ((51, 64), (52, 8)):
        _, ok = tile_pair_hist(*args, ok_edges, MAXJ=maxj, CB=cb)
        assert bool(ok)
    with pytest.raises(ValueError, match="ascend"):
        pair_lag_hist(*args, ok_edges[::-1].copy())
    with pytest.raises(ValueError, match="at least one edge"):
        pair_lag_hist(*args, np.zeros(0, np.float32))


def test_cellgrid_distance_histogram_vs_bruteforce():
    """The lag branch on a thin box and the tile branch (L > 2048) on a
    dense cube, whose maskless MAXJ = 8 fails and grows once; the edge
    cases of the JAX method."""
    rng = np.random.default_rng(23)
    thin = rng.uniform(0, 1, (2000, 3)) * [3.0, 3.0, 120.0]
    edges = np.linspace(0.0, 1.6, 9)
    cg = CellGrid(thin, 1.0, device="cpu")
    CellGrid.distance_histogram.retries = 0
    np.testing.assert_array_equal(cg.distance_histogram(edges), brute_shells(thin, edges))
    assert CellGrid.distance_histogram.retries == 0
    cube = np.random.default_rng(1).uniform(0, 2.0, (4000, 3))
    edges = np.linspace(0.0, 0.8, 9)
    cg = CellGrid(cube, 0.5, device="cpu")
    got = cg.distance_histogram(edges)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, brute_shells(cube, edges))
    assert CellGrid.distance_histogram.retries == 1
    assert CellGrid(device="cpu").distance_histogram(edges).tolist() == [0] * 8
    assert CellGrid(cube[:1], 0.5, device="cpu").distance_histogram([0, 1]).tolist() == [0]
    with pytest.raises(ValueError, match="dim=2"):
        CellGrid(cube[:, :2], 0.5, device="cpu").distance_histogram(edges)


def test_rdf_normalization_and_packing_match_jax():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 1000, 12)
    edges = np.linspace(0.2, 2.0, 13)
    for got, want in ((rdf_normalize(counts, edges, 500, 512.0),
                       jax_rdf_normalize(counts, edges, 500, 512.0)),
                      (rdf_normalize_partial(counts, edges, 200, 300, 512.0, False),
                       jax_rdf_normalize_partial(counts, edges, 200, 300, 512.0, False)),
                      (rdf_normalize_partial(counts, edges, 200, 200, 512.0, True),
                       jax_rdf_normalize_partial(counts, edges, 200, 200, 512.0, True))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    packed = np.array([[3, 0, 70000], [65535, 5, 1]], np.int32)
    np.testing.assert_array_equal(combine_count_vec(torch.as_tensor(packed)),
                                  jax_combine_count_vec(packed))
    # `rdf`'s periodic paths against the brute force (plain versions, f64):
    # lag and tile with ghost images, the minimum image, species partials of
    # both kinds and same-species pairs; its refusals match the JAX
    # package's
    for name, (n, box, edges, mi, seed) in PBC_RDF.items():
        r = np.random.default_rng(seed + 1)
        box = np.asarray(box)
        pts, spec = r.uniform(0, 1, (n, 3)) * box, r.integers(0, 3, n)
        runs = [dict(L=512, minimage=mi), dict(L=512, minimage=mi, species=spec, pair=(1, 1)),
                dict(L=512, minimage=mi, species=spec, pair=(0, 2))]
        if mi is False:
            runs.append(dict(path="tile", MAXJ=16))
        for kw in runs:
            _, g, ok = rdf(torch.as_tensor(pts), np.zeros(3), box, edges, **kw)
            shells = pbc_shells(pts, box, edges, kw.get("species"), kw.get("pair"))
            assert ok, (name, kw)
            np.testing.assert_allclose(
                g, pbc_g(shells, edges, n, box, kw.get("species"), kw.get("pair")),
                rtol=1e-12, err_msg=name)
    # default capacities as the JAX package sizes them (BE = B), on a box
    # whose edge cluster holds more rows near two faces than
    # `suggest_pbc_capacity(with_multi=True)`'s BE (tests/test_torch_stress.py)
    pts, box = edge_cluster()
    edges = np.linspace(0.2, 1.0, 5)
    want = pbc_g(pbc_shells(pts, box, edges), edges, len(pts), box)
    for kw in (dict(L=512), dict(path="tile", MAXJ=16)):
        _, g, ok = rdf(torch.as_tensor(pts), np.zeros(3), box, edges, **kw)
        assert ok, kw
        np.testing.assert_allclose(g, want, rtol=1e-12)
    box, pts = np.full(3, 8.0), np.random.default_rng(5).uniform(0, 8.0, (64, 3))
    spec = np.zeros(64, int)
    for fn, x in ((rdf, torch.as_tensor(pts)), (jax_rdf, jnp.asarray(pts))):
        with pytest.raises(ValueError, match="path='lag'"):
            fn(x, np.zeros(3), box, EDGES, path="tile", species=spec, pair=(0, 0))
        with pytest.raises(ValueError, match="lag-path"):
            fn(x, np.zeros(3), np.array([2.2, 2.2, 40.0]), np.linspace(0.2, 1.0, 5),
               path="tile", minimage="auto")
    with pytest.raises(ValueError, match="go together"):
        rdf(torch.as_tensor(pts), np.zeros(3), box, EDGES, species=spec)
