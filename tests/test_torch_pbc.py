"""Periodic boxes in the port (zelll_tpu_torch.ops.pbc and the periodic MD
loops of models.lj_md, plain versions of the kernels on CPU tensors),
against a numpy minimum-image brute force and against the JAX package's
ops.pbc (Pallas in interpret mode, f64).

Tolerances: pair counts and flags exact; f64 energies to 1e-10 relative
and forces to 1e-10 of the largest force against the brute force; split
f32 coordinates to the f64-grade 1e-6; energies, forces and positions to
1e-9 relative against the JAX package (summation order differs through
unstable sorts, ROADMAP queue 3). Ghost rows may come in another order
than JAX's, so ghost sets are compared as sorted rows. Six JAX
executables are compiled here, each under one jax.jit (ROADMAP Tier-1
budget), and the JAX package's NPT loop (one jitted scan): the periodic
virial rides the paths' call, `md_run_npt`'s records are held to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

import zelll_tpu.ops.pbc as jpbc
from zelll_tpu.models import lj_md as jax_md
from zelll_tpu.models.thermostats import md_run_npt as jax_md_run_npt
from zelll_tpu.ops.virial import pbc_virial as jax_pbc_virial
from zelll_tpu_torch.core.geometry import key_window
from zelll_tpu_torch.models import lj_md
from zelll_tpu_torch.models.lj_md import MDState
from zelll_tpu_torch.models.thermostats import md_run_npt
from zelll_tpu_torch.ops import pbc
from zelll_tpu_torch.ops.virial import pbc_virial
from zelll_tpu_torch.ops.lag_pairs import (
    PbcKeepTerm,
    combine_count,
    lag_coverage_ok,
    lj_term,
    pair_lag_reduce,
    pbc_keep,
    split_f64,
    suggest_lag,
)
from zelll_tpu_torch.utils.datagen import seam_cloud

F64 = torch.float64
# A rod whose folded long axis rounds in f32 (511.7 by 1.22e-5), with layers
# of a jittered lattice at its two z faces, so that every pair across z
# crosses the seam: a split fold by the f32 box alone is off by that
# rounding on each seam pair. The folded masks: z alone (x, y ghosts) and
# all three.
SEAM_BOX, SEAM_CUTOFF = np.array([3.0, 3.0, 511.7]), 1.2
SEAM_MASKS = ((False, False, True), (True, True, True))
# per-row force error over the row's scale (chip_smoke.py's TOL_ROW)
TOL_ROW = 1e-5


def seam_rod():
    return seam_cloud(SEAM_BOX, 0.9, 2, (2,), np.random.default_rng(5))


def row_scale(pts, box, cutoff):
    """Each row's force scale: the sum of both LJ parts' magnitudes over
    its minimum-image pairs."""
    d = pts[:, None, :] - pts[None, :, :]
    d -= box * np.round(d / box)
    dsq = (d * d).sum(-1)
    np.fill_diagonal(dsq, np.inf)
    t = np.where(dsq < cutoff * cutoff, 1.0 / dsq, 0.0)
    return (24.0 * t**4 * (2.0 * t**3 + 1.0) * np.sqrt(np.where(t > 0, dsq, 0.0))).sum(1)


def oracle(pts, box, cutoff):
    """Minimum-image energy, pair count and forces (f64 numpy, O(n^2))."""
    pts = np.asarray(pts, np.float64)
    box = np.asarray(box, np.float64)
    d = pts[:, None, :] - pts[None, :, :]
    d -= box * np.round(d / box)
    dsq = (d * d).sum(-1)
    np.fill_diagonal(dsq, np.inf)
    within = dsq < cutoff * cutoff
    t = 1.0 / np.where(within, dsq, 1.0)
    t3 = t * t * t
    energy = 0.5 * np.sum(np.where(within, 4.0 * t3 * (t3 - 1.0), 0.0))
    g = np.where(within, 24.0 * t3 * (2.0 * t3 - 1.0) * t, 0.0)
    return energy, int(within.sum()) // 2, (g[:, :, None] * d).sum(1)


def uniform(n, box, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, len(box))) * np.asarray(box)


def lattice(box, spacing, jitter, seed):
    """A jittered periodic lattice of about ``spacing`` (a whole number of
    sites per box length, so no two sites crowd at the seam)."""
    rng = np.random.default_rng(seed)
    steps = [b / max(1, round(b / spacing)) for b in box]
    g = np.stack(np.meshgrid(*(np.arange(round(b / h)) * h for b, h in zip(box, steps)),
                             indexing="ij"), -1).reshape(-1, len(box))
    return np.mod(g + rng.uniform(-jitter, jitter, g.shape), box)


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def rel(a, b):
    return abs(a - b) / abs(b)


# (box, cutoff, minimage specs that apply): a cube, a thin slab whose two
# narrow axes fold under "auto", and an uneven box with one narrow axis
BOXES = (((4.3, 5.1, 6.7), 1.0, (False, (True, False, False))),
         ((2.5, 2.5, 20.0), 1.0, (False, "auto", (True, False, False))),
         ((3.0, 9.0, 4.2), 1.2, (False, "auto", (True, True, True))))


def test_pbc_host_helpers_match_jax():
    """minimage_axes, suggest_pbc_capacity (axes=, with_multi=) and the
    numpy helpers equal the JAX package's; wrap_positions keeps in-box
    coordinates bit for bit and wraps the rest into [origin, origin + box);
    key_window, lag_coverage_ok and suggest_lag widen by ``reach``."""
    for box, cutoff in (((30.0, 30.0, 1e4), 10.0), ((4.3, 5.1, 6.7), 1.5),
                        ((2.5, 2.5, 40.0), 1.0), ((6.0, 6.0), 1.0)):
        np.testing.assert_array_equal(pbc.minimage_axes(box, cutoff),
                                      jpbc.minimage_axes(box, cutoff))
        for dim_axes in (None, [True] * len(box), [False] + [True] * (len(box) - 1)):
            for n in (100, 5000):
                assert pbc.suggest_pbc_capacity(n, box, cutoff, axes=dim_axes) == \
                    jpbc.suggest_pbc_capacity(n, box, cutoff, axes=dim_axes)
                assert pbc.suggest_pbc_capacity(n, box, cutoff, axes=dim_axes,
                                                with_multi=True) == \
                    jpbc.suggest_pbc_capacity(n, box, cutoff, axes=dim_axes,
                                              with_multi=True)
    assert pbc._subsets(3) == jpbc._subsets(3) and pbc._subsets(2) == jpbc._subsets(2)
    np.testing.assert_array_equal(
        pbc._resolve_minimage((2.5, 2.5, 40.0), 1.0, "auto", 3),
        jpbc._resolve_minimage((2.5, 2.5, 40.0), 1.0, "auto", 3))
    assert not pbc._resolve_minimage((2.5, 2.5), 1.0, "auto", 2).any()

    box = np.array([2.0, 3.0, 5.0])
    pts = np.array([[0.5, 1.0, 4.999], [-0.25, 3.0, 5.0], [2.0, -1e-300, 10.5],
                    [-1e-17, 1.5, -5.0]])
    got = pbc.wrap_positions(t64(pts), [0, 0, 0], box).numpy()
    np.testing.assert_array_equal(got[0], pts[0])
    assert np.all((got >= 0) & (got < box))
    np.testing.assert_allclose(got, np.mod(np.mod(pts, box), box), atol=1e-15)
    hi, lo = split_f64(t64(pts[:1]))
    assert torch.equal(pbc.wrap_positions(hi, [0, 0, 0], box), hi)
    # invalid ghost rows stay apart past 2^24 rows in f32
    far = pbc._spread(torch.tensor([2**24, 2**24 + 1, 2**24 + 2]), 4098, 3, torch.float32)
    assert len({tuple(r) for r in far.tolist()}) == 3
    a, b = t64([1.0, 1e16]), t64([1e-17, 3.0])
    s, err = pbc._twosum(a, b)
    assert s.tolist() == [1.0, 1e16 + 4.0] and err.tolist() == [1e-17, -1.0]

    strides = torch.tensor([1, 8, 64], dtype=torch.int32)
    assert int(key_window(strides)) == 73
    assert int(key_window(strides, (2, 2, 1))) == 2 + 16 + 64
    keys = torch.arange(0, 2000, 3, dtype=torch.int32)
    for reach in (None, (2, 2, 1)):
        w = int(key_window(strides, reach))
        L = suggest_lag(keys, strides, reach=reach)
        assert bool(lag_coverage_ok(keys, strides, L, reach=reach))
        assert L == 128 * -(-(w // 3 + 1) // 128)
        assert not bool(lag_coverage_ok(keys, strides, w // 3, reach=reach))


def test_pbc_extend_matches_jax():
    """The ghost multiset, signs, parents, low parts and flags of
    `pbc_extend` equal the JAX function's (one jitted call each for a
    split thin slab with images on its long axis only and a dense cube
    whose corner rows exceed a small BE), and the corner particle gets its
    7 images."""
    rng = np.random.default_rng(3)
    thin = np.array([2.5, 2.5, 20.0])
    pts = rng.uniform(0, 1, (300, 3)) * thin
    hi, lo = split_f64(t64(pts))
    cube = np.array([3.0, 3.0, 3.0])
    dense = np.concatenate([rng.uniform(0, 1, (200, 3)) * cube, [[1e-3, 2e-3, 2.999]]])
    cases = (
        (hi.double(), lo.double(), thin, 1.0, dict(B=128, G=256, axes=(False, False, True))),
        (t64(dense), None, cube, 1.2, dict(B=201, G=1407, BE=128)),
        (t64(dense), None, cube, 1.2, dict(B=201, G=1407)),
    )
    for pos, plo, box, cutoff, kw in cases:
        ext, elo, w, valid, ok, par = pbc.pbc_extend(
            pos, [0.0, 0.0, 0.0], box, cutoff, positions_lo=plo, return_parents=True, **kw)
        j = jpbc.pbc_extend(jnp.asarray(pos.numpy()), jnp.zeros(3), jnp.asarray(box), cutoff,
                            positions_lo=None if plo is None else jnp.asarray(plo.numpy()),
                            return_parents=True, **kw)
        jext, jlo, jw, jvalid, jok, jpar = (np.asarray(x) if x is not None else None for x in j)
        n = pos.shape[0]
        assert bool(ok) == bool(jok)
        assert ext.shape == jext.shape
        if not bool(ok):
            continue  # which candidates fit the capacities is unspecified
        assert int(valid.sum()) == int(jvalid.sum())
        np.testing.assert_array_equal(ext[:n].numpy(), jext[:n])

        def rows(e, lo_, w_, v, p):
            cols = [e[n:][v[n:]], w_[n:][v[n:]][:, None], p[v[n:]][:, None].astype(np.float64)]
            if lo_ is not None:
                cols.append(lo_[n:][v[n:]])
            a = np.concatenate(cols, 1)
            return a[np.lexsort(a.T[::-1])]

        got = rows(ext.numpy(), None if elo is None else elo.numpy(), w.numpy(),
                   valid.numpy(), par.numpy())
        want = rows(jext, jlo, jw, jvalid, jpar)
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got[:, 3])) <= {-1.0, 1.0}
    # the dense cube with BE = 128 flags its rows near two or more faces;
    # with room for them, the corner particle (the last row) has 7 images
    corner = np.flatnonzero((par.numpy() == 200) & valid[201:].numpy())
    assert len(corner) == 7


def test_pbc_pair_sum_vs_bruteforce():
    """`pbc_pair_sum` (through `pbc_lj_energy` and `pbc_count_pairs`) on
    the lag, tile and xla paths and with the minimum image ("auto" and
    explicit masks): counts exact, f64 energies to 1e-10, split f32 to
    1e-6, also on the seam rod whose folded axis rounds in f32 (a fold by
    the f32 box alone is off by 2.8e-5 there); 2-D boxes route to xla; the
    odd-row xla count is exact."""
    for seed, (box, cutoff, mis) in enumerate(BOXES):
        pts = uniform(int(np.prod(box) * 1.5), box, seed)
        e_ref, c_ref, _ = oracle(pts, box, cutoff)
        P = t64(pts)
        grid = lattice(box, 0.8, 0.2, seed)
        e_grid, _, _ = oracle(grid, box, cutoff)
        hi, lo = split_f64(t64(grid))
        runs = [("lag", False), ("tile", False), ("xla", False)] + \
            [("lag", mi) for mi in mis if mi is not False]
        for path, mi in runs:
            kw = dict(path=path, minimage=mi, L=1024, MAXJ=16, K=16, chunk=256)
            c, ok_c = pbc.pbc_count_pairs(P, [0.0] * 3, box, cutoff, **kw)
            e, ok_e = pbc.pbc_lj_energy(P, [0.0] * 3, box, cutoff, **kw)
            assert bool(ok_c) and bool(ok_e), (box, path, mi)
            assert c == c_ref, (box, path, mi, c, c_ref)
            assert rel(float(e), e_ref) <= 1e-10, (box, path, mi)
            if path != "xla":
                es, ok_s = pbc.pbc_lj_energy(hi, [0.0] * 3, box, cutoff, positions_lo=lo,
                                             out_dtype=F64, **kw)
                assert bool(ok_s) and rel(float(es), e_grid) <= 1e-6, (box, path, mi)
    rod = seam_rod()
    e_rod, c_rod, _ = oracle(rod, SEAM_BOX, SEAM_CUTOFF)
    hi, lo = split_f64(t64(rod))
    for mi in SEAM_MASKS:
        kw = dict(minimage=mi, L=1024)
        c, ok_c = pbc.pbc_count_pairs(t64(rod), [0.0] * 3, SEAM_BOX, SEAM_CUTOFF, **kw)
        es, ok_s = pbc.pbc_lj_energy(hi, [0.0] * 3, SEAM_BOX, SEAM_CUTOFF, positions_lo=lo,
                                     out_dtype=F64, **kw)
        assert bool(ok_c) and bool(ok_s) and c == c_rod, mi
        assert rel(float(es), e_rod) <= 1e-6, (mi, rel(float(es), e_rod))
    # 2-D goes to the xla path; its integer count keeps odd rows
    box2 = (6.0, 7.0)
    pts2 = uniform(300, box2, 9)
    e_ref, c_ref, _ = oracle(pts2, box2, 1.0)
    e, ok = pbc.pbc_lj_energy(t64(pts2), [0.0, 0.0], box2, 1.0, path="lag", K=16, chunk=256)
    c, ok_c = pbc.pbc_count_pairs(t64(pts2), [0.0, 0.0], box2, 1.0, K=16, chunk=256)
    assert bool(ok) and bool(ok_c) and c == c_ref and rel(float(e), e_ref) <= 1e-10
    odd = uniform(700, (6.0, 6.0, 6.0), 42)
    _, c_ref, _ = oracle(odd, (6.0,) * 3, 1.0)
    packed, ok = pbc.pbc_pair_sum(t64(odd), [0.0] * 3, (6.0,) * 3, 1.0, path="xla",
                                  term=lambda d: torch.ones_like(d), out_dtype=torch.int32,
                                  K=16, chunk=256)
    assert bool(ok) and packed.dtype == torch.int32 and combine_count(packed) == c_ref


def test_pbc_forces_vs_bruteforce():
    """`pbc_lj_forces` in input order on every path and minimum-image mask,
    to 1e-10 of the largest force (split f32: ||f - f_ref|| to 1e-6 of
    ||f_ref||, the parity rule of the card's checks, and on boxes whose long
    axis f32 rounds, ghost-extended or folded (the seam rod, where a fold by
    the f32 box alone is off by 4.6e-5), each row to TOL_ROW of its own
    scale); `md_step_pbc` is one semi-implicit Euler step with those forces,
    wrapped into the box."""
    for seed, (box, cutoff, mis) in enumerate(BOXES):
        pts = lattice(box, 0.9, 0.1, seed)
        _, _, f_ref = oracle(pts, box, cutoff)
        scale = np.abs(f_ref).max()
        P = t64(pts)
        hi, lo = split_f64(P)
        runs = [("lag", False), ("tile", False), ("xla", False)] + \
            [("lag", mi) for mi in mis if mi is not False]
        for path, mi in runs:
            kw = dict(path=path, minimage=mi, L=1024, MAXJ=16, K=16, chunk=256)
            f, ok = pbc.pbc_lj_forces(P, [0.0] * 3, box, cutoff, **kw)
            assert bool(ok) and f.shape == P.shape
            assert np.abs(f.numpy() - f_ref).max() <= 1e-10 * scale, (box, path, mi)
            if path != "xla":
                fs, ok = pbc.pbc_lj_forces(hi, [0.0] * 3, box, cutoff, positions_lo=lo, **kw)
                assert bool(ok)
                err = np.linalg.norm(fs.double().numpy() - f_ref) / np.linalg.norm(f_ref)
                assert err <= 1e-6, (box, path, mi, err)
    # a long axis whose length f32 rounds (229.9 by 6e-6): split ghosts are
    # shifted by the host box, so every row stays within f32 rounding of
    # its own scale (the sum of both LJ parts' magnitudes over its pairs)
    box, cutoff = np.array([3.0, 3.0, 229.9]), 1.2
    pts = lattice(box, 0.9, 0.1, 5)
    _, _, f_ref = oracle(pts, box, cutoff)
    scale = row_scale(pts, box, cutoff)
    hi, lo = split_f64(t64(pts))
    for path, mi in (("lag", False), ("tile", False), ("lag", (True, True, False))):
        fs, ok = pbc.pbc_lj_forces(hi, [0.0] * 3, box, cutoff, positions_lo=lo, path=path,
                                   minimage=mi, L=1024, MAXJ=16)
        assert bool(ok)
        row_err = np.linalg.norm(fs.double().numpy() - f_ref, axis=1) / scale
        assert row_err.max() <= TOL_ROW, (path, mi, row_err.max())
    rod = seam_rod()
    _, _, f_ref = oracle(rod, SEAM_BOX, SEAM_CUTOFF)
    scale = row_scale(rod, SEAM_BOX, SEAM_CUTOFF)
    hi, lo = split_f64(t64(rod))
    for mi in SEAM_MASKS:
        fs, ok = pbc.pbc_lj_forces(hi, [0.0] * 3, SEAM_BOX, SEAM_CUTOFF, positions_lo=lo,
                                   minimage=mi, L=1024)
        assert bool(ok)
        row_err = np.linalg.norm(fs.double().numpy() - f_ref, axis=1) / scale
        assert row_err.max() <= TOL_ROW, (mi, row_err.max())
    box, cutoff, dt = np.array([3.0, 9.0, 4.2]), 1.2, 1e-3
    pts = lattice(box, 0.9, 0.1, 7)
    vel = np.random.default_rng(7).normal(0, 0.5, pts.shape)
    _, _, f_ref = oracle(pts, box, cutoff)
    p2, v2, ok = pbc.md_step_pbc(t64(pts), t64(vel), [0.0] * 3, box, cutoff, dt,
                                 minimage="auto", L=1024)
    v_ref = vel + dt * f_ref
    assert bool(ok)
    np.testing.assert_allclose(v2.numpy(), v_ref, rtol=0, atol=1e-10 * np.abs(v_ref).max())
    np.testing.assert_allclose(p2.numpy(), np.mod(pts + dt * v_ref, box), rtol=0, atol=1e-12)


def test_pbc_flags_and_refusals():
    """The capacity and regime flags (B, G and BE exceeded, box <= 2 cutoff)
    go False and nothing else does; option checks raise as the JAX
    package's do; species forces off the lag path raise as there."""
    box = np.array([4.0, 4.0, 4.0])
    pts = uniform(300, box, 5)
    P = t64(pts)
    full = dict(B=300, G=2100, BE=300)
    assert bool(pbc.pbc_extend(P, [0.0] * 3, box, 1.0, **full)[-1])
    for kw in (dict(full, B=8), dict(full, G=64), dict(full, BE=1)):
        assert not bool(pbc.pbc_extend(P, [0.0] * 3, box, 1.0, **kw)[-1]), kw
    assert not bool(pbc.pbc_extend(P, [0.0] * 3, box, 2.0, **full)[-1])
    assert not bool(pbc.pbc_lj_energy(P, [0.0] * 3, box, 1.0, B=8, G=64)[1])
    assert not bool(pbc.pbc_lj_energy(P, [0.0] * 3, box, 1.0, L=4)[1])
    assert not bool(pbc.pbc_lj_energy(P, [0.0] * 3, (2.5, 2.5, 9.0), 1.3,
                                      minimage="auto")[1])
    with pytest.raises(ValueError, match="lag-path feature"):
        pbc.pbc_pair_sum(P, [0.0] * 3, box, 1.0, path="tile", minimage=(True, False, False))
    for kw in (dict(bandmask=True), dict(BE=128), dict(kahan=False)):
        with pytest.raises(ValueError, match="no effect under minimage"):
            pbc.pbc_pair_sum(P, [0.0] * 3, box, 1.0, minimage=(True, False, False), **kw)
    with pytest.raises(ValueError, match="no effect under minimage"):
        pbc.pbc_lj_forces(P, [0.0] * 3, box, 1.0, minimage=(True, False, False), BE=128)
    with pytest.raises(ValueError, match="unknown path"):
        pbc.pbc_lj_energy(P, [0.0] * 3, box, 1.0, path="cells")
    with pytest.raises(ValueError, match="run on the lag path"):
        pbc.pbc_lj_forces(P, [0.0] * 3, box, 1.0, species=torch.zeros(300), path="tile")


def test_pbc_payload_instances_plain():
    """The plain version of K1's payload rules: the keep mask as a
    `PbcKeepTerm` (what K1 and K6 take as mask id 2) equals the masked sum
    it stands for and the minimum-image brute force, and ``min_islot``
    splits it by the larger slot as the JAX kernel does."""
    box, cutoff = np.array([2.5, 2.5, 20.0]), 1.0
    pts = uniform(180, box, 11)
    e_ref, c_ref, _ = oracle(pts, box, cutoff)
    P = t64(pts)
    bins, sp, slo, pay, reach, mib, ok = pbc._minimage_bins(
        P, [0.0] * 3, box, cutoff, np.array([True, True, False]), B=None, G=None,
        positions_lo=None, need_perm=False)
    assert bool(ok) and reach == (2, 2, 1) and mib.tolist() == [2.5, 2.5, 0.0]
    args = (sp, bins.sorted_keys, bins.info.strides, cutoff**2, None, pay)
    L = suggest_lag(bins.sorted_keys, bins.info.strides, reach=reach)
    e = pair_lag_reduce(*args, L=L, term=PbcKeepTerm(lj_term), mi_box=mib, key_reach=reach)
    assert rel(float(e), e_ref) <= 1e-10
    w = pay[:, 0]
    masked = pair_lag_reduce(*args, L=L, mi_box=mib, key_reach=reach,
                             term=lambda d, a, b: torch.where(pbc_keep(a, b), lj_term(d), 0.0))
    assert float(masked) == float(e)
    k = int(bins.sorted_keys.shape[0]) // 2
    upper = pair_lag_reduce(*args, L=L, term=PbcKeepTerm(lj_term), mi_box=mib,
                            key_reach=reach, min_islot=k)
    lower = pair_lag_reduce(sp[:k], bins.sorted_keys[:k], bins.info.strides, cutoff**2, None,
                            pay[:k], L=L, term=PbcKeepTerm(lj_term), mi_box=mib,
                            key_reach=reach)
    assert rel(float(upper) + float(lower), e_ref) <= 1e-10
    assert PbcKeepTerm(lj_term).term is lj_term and pbc._pbc_term(lj_term) is \
        pbc._pbc_term(lj_term)
    assert torch.equal(pbc_keep(w[:, None], w[None, :]), pbc_keep(w[None, :], w[:, None]))


def test_pbc_paths_match_jax():
    """`pbc_pair_sum` on the lag, tile and xla paths and with the minimum
    image, `pbc_lj_forces` with the minimum image, and `pbc_virial` on the
    same paths, on one input through both packages (the JAX ones in one
    jitted call): counts exact, energies, virials and forces to 1e-9."""
    box, cutoff = np.array([2.5, 2.5, 12.0]), 1.0
    pts = uniform(160, box, 17)
    o = np.zeros(3)
    B, G, BE = pbc.suggest_pbc_capacity(160, box, cutoff, with_multi=True)
    lag = dict(B=B, G=G, M=512, L=512)

    @jax.jit
    def ref(p):
        return dict(
            lag=jpbc.pbc_lj_energy(p, o, box, cutoff, interpret=True, BE=BE, **lag),
            tile=jpbc.pbc_lj_energy(p, o, box, cutoff, path="tile", B=B, G=G, BE=BE,
                                    CB=1, MAXJ=16, interpret=True),
            xla=jpbc.pbc_pair_sum(p, o, box, cutoff, term=jpbc.count_term, path="xla",
                                  B=B, G=G, BE=BE, K=48, out_dtype=jnp.int32),
            mi=jpbc.pbc_lj_energy(p, o, box, cutoff, minimage="auto", interpret=True, **lag),
            mi_forces=jpbc.pbc_lj_forces(p, o, box, cutoff, minimage="auto",
                                         interpret=True, **lag),
            w_lag=jax_pbc_virial(p, o, box, cutoff, interpret=True, BE=BE, **lag),
            w_tile=jax_pbc_virial(p, o, box, cutoff, path="tile", B=B, G=G, BE=BE, CB=1,
                                  MAXJ=16, interpret=True),
            w_xla=jax_pbc_virial(p, o, box, cutoff, path="xla", B=B, G=G, BE=BE, K=48),
            w_mi=jax_pbc_virial(p, o, box, cutoff, minimage="auto", interpret=True, **lag))

    want = jax.tree_util.tree_map(np.asarray, ref(jnp.asarray(pts)))
    P = t64(pts)
    got = dict(
        lag=pbc.pbc_lj_energy(P, o, box, cutoff, BE=BE, **lag),
        tile=pbc.pbc_lj_energy(P, o, box, cutoff, path="tile", B=B, G=G, BE=BE, CB=1,
                               MAXJ=16),
        xla=pbc.pbc_count_pairs(P, o, box, cutoff, path="xla", B=B, G=G, BE=BE, K=48),
        mi=pbc.pbc_lj_energy(P, o, box, cutoff, minimage="auto", **lag),
        mi_forces=pbc.pbc_lj_forces(P, o, box, cutoff, minimage="auto", **lag),
        w_lag=pbc_virial(P, o, box, cutoff, BE=BE, **lag),
        w_tile=pbc_virial(P, o, box, cutoff, path="tile", B=B, G=G, BE=BE, CB=1, MAXJ=16),
        w_xla=pbc_virial(P, o, box, cutoff, path="xla", B=B, G=G, BE=BE, K=48),
        w_mi=pbc_virial(P, o, box, cutoff, minimage="auto", **lag))
    for key in got:
        assert bool(got[key][1]) and bool(want[key][1]), key
    assert got["xla"][0] == (int(want["xla"][0][0]) << 16) + int(want["xla"][0][1])
    for key in ("lag", "tile", "mi", "w_lag", "w_tile", "w_xla", "w_mi"):
        assert rel(float(got[key][0]), float(want[key][0])) <= 1e-9, key
    fw = want["mi_forces"][0]
    assert np.abs(got["mi_forces"][0].numpy() - fw).max() <= 1e-9 * np.abs(fw).max()


def _rows(pos, vel, box):
    a = np.concatenate([np.mod(np.asarray(pos, np.float64), box), np.asarray(vel)], 1)
    return a[np.lexsort(a.T[::-1])]


def test_pbc_md_loops_match_jax():
    """A few steps of `md_run_vv_pbc` (lag path), `md_run_skin_pbc` and
    `md_run_skin_tile_pbc` (a skin small enough to rebuild) through both
    packages: flags and rebuild counts exact, states (as sets of rows; the
    skin loops return build-sorted order) and energies to 1e-9."""
    box = 0.95 * np.array([4.0, 5.0, 6.0])
    pts = lattice(box, 0.95, 0.05, 15)
    vel = np.random.default_rng(15).normal(0, 0.3, pts.shape)
    n, c, dt, skin = len(pts), 1.0, 2e-3, 0.02
    B, G = pbc.suggest_pbc_capacity(n, box, c + skin)
    st = MDState.create(pts, vel, device="cpu")
    jst = jax_md.MDState(positions=jnp.asarray(pts), velocities=jnp.asarray(vel))
    o = np.zeros(3)

    vv, ok_vv = lj_md.md_run_vv_pbc(st, o, box, c, dt, steps=3, B=B, G=G, L=512)
    jvv, jok_vv = jax_md.md_run_vv_pbc(jst, jnp.asarray(o), jnp.asarray(box), c, dt,
                                       steps=3, B=B, G=G, M=512, L=512, interpret=True)
    assert bool(ok_vv) and bool(jok_vv)
    for a, b in ((vv.positions, jvv.positions), (vv.velocities, jvv.velocities)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9 * np.abs(np.asarray(b)).max())

    for name, kw, jkw in (("skin", dict(L=512), dict(M=512, L=512)),
                          ("skin_tile", dict(MAXJ=16, CB=1), dict(MAXJ=16, CB=1))):
        port = getattr(lj_md, f"md_run_{name}_pbc")
        jax_fn = getattr(jax_md, f"md_run_{name}_pbc")
        s, ok, e, nrb = port(st, o, box, c, dt, steps=10, B=B, G=G, skin=skin, **kw)
        js, jok, je, jnrb = jax_fn(jst, jnp.asarray(o), jnp.asarray(box), c, dt, steps=10,
                                   B=B, G=G, skin=skin, interpret=True, **jkw)
        assert bool(ok) and bool(jok) and nrb == int(jnrb) >= 1, name
        a, b = _rows(s.positions, s.velocities, box), _rows(js.positions, js.velocities, box)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())
        assert rel(float(e), float(je)) <= 1e-9, name

    # the Berendsen barostat (tests/test_npt.py): a hot gas above the target
    # pressure, `md_run_npt` on the lag path with records, both packages
    gpts = lattice(np.full(3, 6.0), 6.0 / 5, 0.04, 16)
    gvel = np.random.default_rng(16).normal(0, 3.0, gpts.shape)
    gvel -= gvel.mean(0)
    kw = dict(steps=4, P_target=0.05, tau_p=0.05, beta=1.0, record=True)
    p, v, b, ok, rec = md_run_npt(t64(gpts), t64(gvel), o, np.full(3, 6.0), 1.5, 2e-3,
                                  L=512, **kw)
    jp, jv, jb, jok, jrec = jax_md_run_npt(jnp.asarray(gpts), jnp.asarray(gvel),
                                           jnp.zeros(3), jnp.full(3, 6.0), 1.5, 2e-3, M=512,
                                           L=512, interpret=True, **kw)
    assert bool(ok) and bool(jok)
    for key in ("pressure", "volume", "temperature"):
        np.testing.assert_allclose(rec[key].numpy(), np.asarray(jrec[key]), rtol=1e-9,
                                   err_msg=key)
    assert rec["volume"][-1] > rec["volume"][0] and rec["pressure"][0] > 0.05
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-12)
    for a, c in ((p, jp), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0,
                                   atol=1e-9 * np.abs(np.asarray(c)).max())


def test_pbc_md_loops_vs_stepwise():
    """Port-only: the skin loops reproduce the rebuild-every-step
    `md_step_pbc` trajectory (no rebuild inside the skin, and a rebuild
    when the drift passes skin / 2), their energies equal a direct
    `pbc_lj_energy` of the end state, and `md_run_vv_pbc` tracks a numpy
    minimum-image velocity Verlet to 1e-9."""
    box = 0.95 * np.array([4.0, 5.0, 6.0])
    pts = lattice(box, 0.95, 0.05, 21)
    c, dt = 1.0, 2e-3
    o = np.zeros(3)
    for steps, skin, vscale, want in ((12, 0.4, 0.05, False), (30, 0.05, 0.3, True)):
        vel = np.random.default_rng(steps).normal(0, vscale, pts.shape)
        B, G = pbc.suggest_pbc_capacity(len(pts), box, c + skin)
        for name, path, kw in (("skin", "lag", dict(L=512)),
                               ("skin_tile", "tile", dict(MAXJ=16))):
            p1, v1 = t64(pts), t64(vel)
            for _ in range(steps):
                p1, v1, ok = pbc.md_step_pbc(p1, v1, o, box, c, dt, path=path, **kw)
                assert bool(ok)
            run = getattr(lj_md, f"md_run_{name}_pbc")
            st, ok, e, nrb = run(MDState.create(pts, vel, device="cpu"), o, box, c, dt,
                                 steps=steps, B=B, G=G, skin=skin, **kw)
            assert bool(ok) and nrb < steps and (nrb >= 1) == want, (name, nrb)
            a, b = _rows(st.positions, st.velocities, box), _rows(p1, v1, box)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
            e2, ok2 = pbc.pbc_lj_energy(st.positions, o, box, c, path=path, **kw)
            assert bool(ok2) and rel(float(e), float(e2)) <= 1e-9
    rng = np.random.default_rng(12)
    box, steps = np.array([5.0, 5.5, 6.0]), 4
    pts = uniform(128, box, 12)
    vel = rng.normal(0, 0.1, pts.shape)
    p_np, v_np = pts.copy(), vel.copy()
    _, _, f_np = oracle(p_np, box, c)
    for _ in range(steps):
        vh = v_np + 0.5 * 1e-5 * f_np
        p_np = np.mod(p_np + 1e-5 * vh, box)
        _, _, f_np = oracle(p_np, box, c)
        v_np = vh + 0.5 * 1e-5 * f_np
    B, G = pbc.suggest_pbc_capacity(128, box, c)
    st, ok = lj_md.md_run_vv_pbc(MDState.create(pts, vel, device="cpu"), o, box, c, 1e-5,
                                 steps=steps, B=B, G=G, L=512, path="tile", MAXJ=16)
    assert bool(ok)
    np.testing.assert_allclose(st.positions.numpy(), p_np, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(st.velocities.numpy(), v_np, rtol=1e-9, atol=1e-9)
