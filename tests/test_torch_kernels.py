"""The port's CUDA kernels (K1 to K9 and K12) against their plain PyTorch
versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Without a
card the whole module skips at collection: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the kernels are CUDA kernels with no CPU mode",
                allow_module_level=True)

from zelll_tpu_torch.core import (
    SENTINEL_KEY,
    GridInfo,
    aabb_from_positions,
    build,
    compute_keys,
    sort_by_key,
)
from zelll_tpu_torch.ops.lag_pairs import (
    SpeciesPairMask,
    _pad_and_desentinel,
    combine_count,
    combine_count_vec,
    count_term,
    lag_coverage_ok,
    lj_term,
    lj_term_fast,
    pair_lag_forces,
    pair_lag_forces_plain,
    pair_lag_hist,
    pair_lag_hist_plain,
    pair_lag_per_particle,
    pair_lag_per_particle_plain,
    pair_lag_reduce,
    pair_lag_reduce_plain,
    pair_lag_stress,
    pair_lag_stress_plain,
    split_f64,
)
from zelll_tpu_torch.ops.lj import lj_force_factor, lj_force_factor_fast, lj_virial_term
from zelll_tpu_torch.ops.segments import CHUNK, segment_bands, suggest_maxj
from zelll_tpu_torch.ops.tile_pairs import (
    tile_pair_forces,
    tile_pair_forces_plain,
    tile_pair_hist,
    tile_pair_hist_plain,
    tile_pair_reduce,
    tile_pair_reduce_plain,
    tile_pair_stress,
    tile_pair_stress_plain,
    tile_inputs,
)
from zelll_tpu_torch.utils.datagen import (
    cluster_gap,
    generate_points_lattice,
    generate_points_random,
    lj_box,
    seam_cloud,
)

CUTOFF = 10.0
# lj_term_fast on the card against its plain version: rsqrtf and
# torch.rsqrt may each be 2 ulp off, and t3 = r^-6 multiplies that
# relative error by 6 (no cancellation in t3 - 1 at separations >= 2).
# lj_force_factor_fast's t^3 inv = r^-8 multiplies it by 8, and the
# forces are held to the largest force, not term by term, so the same
# bound holds for them with 8 in place of 6.
TOL_FAST = 6 * 4 * 2.0**-23
# the first slots of the facing clusters of `_prune_cases`
GAP_SITES = (128 * 8, 128 * 40)
TOL_FAST_FORCES = 8 * 4 * 2.0**-23


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_lag_reduce_kernel_matches_plain_on_card(cuda_device):
    """K1 against its plain version on the same sorted CUDA tensors (the
    benchmark's thin box, a jittered lattice, and the inputs that fail a
    prune that is not conservative: the facing clusters of `cluster_gap`
    and the lattice drifted since its keys were built, at L = 256 and 64):
    counts exact, f32 energies to 1e-6 and f64 totals to 1e-10 (f64 sums
    in another order), the same lags, sentinel rows inert."""
    n = 20_000
    pts = generate_points_random(n, lj_box(n, CUTOFF))
    hi, lo = split_f64(torch.as_tensor(pts, device=cuda_device))
    info = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
    keys, _, shi, slo = sort_by_key(compute_keys(hi, info), hi, lo)
    padded = keys.clone()
    padded[-500:] = SENTINEL_KEY
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    for k, L in ((keys, 256), (keys, 32), (padded, 256)):
        for plo in (None, slo):
            for term, out in ((lj_term, None), (count_term, torch.int32)):
                before = pair_lag_reduce.launches
                got = pair_lag_reduce(shi, k, info.strides, csq, plo, L=L, term=term,
                                      out_dtype=out)
                assert pair_lag_reduce.launches == before + 1
                want = pair_lag_reduce_plain(shi, k, info.strides, csq, plo, L=L,
                                             term=term, out_dtype=out)
                torch.cuda.synchronize()
                if out is None:
                    assert got.dtype == torch.float32
                    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
                else:
                    assert combine_count(got) == combine_count(want)
    assert bool(lag_coverage_ok(keys, info.strides, 256))
    assert not bool(lag_coverage_ok(keys, info.strides, 32))

    # f64 totals to 1e-10 (both sides sum the same f32 terms in f64). On the
    # uniform cloud a few nearly coincident pairs carry the LJ total; on the
    # jittered lattice every pair term is of one size, so a wrong term or a
    # lost partial shows.
    lat = generate_points_lattice(n, lj_box(n, CUTOFF))
    lhi, llo = split_f64(torch.as_tensor(lat, device=cuda_device))
    linfo = GridInfo.create(aabb_from_positions(lhi), CUTOFF, auto_order=True)
    lkeys, _, lshi, lslo = sort_by_key(compute_keys(lhi, linfo), lhi, llo)
    for args in ((shi, keys, info.strides, csq, slo), (lshi, lkeys, linfo.strides, csq, llo)):
        for plo in (None, args[4]):
            got = pair_lag_reduce(*args[:4], plo, L=256, out_dtype=torch.float64)
            want = pair_lag_reduce_plain(*args[:4], plo, L=256, out_dtype=torch.float64)
            assert got.dtype == torch.float64
            np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    # the cluster prune's sharp inputs, with the lag bound at 256 and below
    # the key window
    for gshi, gslo, gkeys, gstrides in _prune_cases(lshi, lslo, lkeys, linfo.strides).values():
        for L in (256, 64):
            for plo in (None, gslo):
                for term, out in ((lj_term, torch.float64), (count_term, torch.int32)):
                    kw = dict(L=L, term=term, out_dtype=out)
                    got = pair_lag_reduce(gshi, gkeys, gstrides, csq, plo, **kw)
                    want = pair_lag_reduce_plain(gshi, gkeys, gstrides, csq, plo, **kw)
                    if out == torch.int32:
                        assert combine_count(got) == combine_count(want) > 0
                    else:
                        np.testing.assert_allclose(float(got), float(want), rtol=1e-10)

    # 2D points, one slot, no slot (no launch)
    pts2 = np.random.default_rng(1).uniform(0, 1, (3000, 2)) * [5.0, 200.0]
    g2 = build(torch.as_tensor(pts2, dtype=torch.float32, device=cuda_device), 1.0)
    args2 = (g2.sorted_pos, g2.bins.sorted_keys, g2.info.strides, 1.0)
    got = pair_lag_reduce(*args2, L=128, term=count_term, out_dtype=torch.int32)
    want = pair_lag_reduce_plain(*args2, L=128, term=count_term, out_dtype=torch.int32)
    assert combine_count(got) == combine_count(want) > 0
    np.testing.assert_allclose(float(pair_lag_reduce(*args2, L=128)),
                               float(pair_lag_reduce_plain(*args2, L=128)), rtol=1e-6)
    assert float(pair_lag_reduce(shi[:1], keys[:1], info.strides, csq)) == 0.0
    before = pair_lag_reduce.launches
    assert float(pair_lag_reduce(shi[:0], keys[:0], info.strides, csq)) == 0.0
    assert pair_lag_reduce.launches == before
    with pytest.raises(ValueError):
        pair_lag_reduce(shi, keys, info.strides, csq, L=64, term=lambda d: d)
    with pytest.raises(ValueError):
        pair_lag_reduce(shi.double(), keys, info.strides, csq, L=64)
    with pytest.raises(ValueError):
        pair_lag_reduce(shi.t().contiguous().t(), keys, info.strides, csq, L=64)


def _sorted_cube(pts, device):
    """Keys, sort and gather of the main path, on the card."""
    hi, lo = split_f64(torch.as_tensor(pts, device=device))
    info = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
    keys, _, shi, slo = sort_by_key(compute_keys(hi, info), hi, lo)
    return shi, slo, keys, info.strides


def _maxj(keys, strides, CB=8):
    n = keys.shape[0]
    C = max(-(-n // (CHUNK * CB)) * CB, CB) * CHUNK
    return suggest_maxj(_pad_and_desentinel(keys, C), segment_bands(strides), per_band=True)


@pytest.mark.gpu
def test_tile_reduce_kernel_matches_plain_on_card(cuda_device):
    """K6 against its plain version on the same sorted CUDA tensors: a
    jittered cubic lattice at the benchmark's density, the facing clusters
    of `cluster_gap` and the lattice drifted since its keys were built (f64
    totals to 1e-10, counts exact, masked and maskless, split and f32,
    lj_term_fast to TOL_FAST), an undersized MAXJ, and int32 keys past 2^24
    (K10)."""
    n = 200_000
    side = (n / 0.01) ** (1 / 3)
    shi, slo, keys, strides = _sorted_cube(
        generate_points_lattice(n, (side, side, side)), cuda_device)
    maxj = _maxj(keys, strides)
    csq = CUTOFF**2
    f64 = torch.float64
    cases = {"lattice": (shi, slo, keys, strides),
             **_prune_cases(shi, slo, keys, strides)}
    # each facing pair of `cluster_gap` lies in a window of the later
    # cluster (band 0 of its own chunk, key band and triangle held), so a
    # prune that drops it changes the count
    for bandmask in (True, False):
        inp = tile_inputs(shi.t().contiguous(), keys, strides, MAXJ=maxj, bandmask=bandmask)
        bounds, bands = inp.bounds.long().cpu(), inp.bands.long().cpu()
        for s in GAP_SITES:
            i, j = s + 32, s + 31
            first = int(bounds[i // CHUNK, 0] + bounds[i // CHUNK, 1])
            assert first <= j // CHUNK < first + int(bounds[i // CHUNK, 2])
            assert int(bands[0, 0]) <= int(keys[i]) - int(keys[j]) <= int(bands[0, 1])
    for chi, clo, ckeys, cstrides in cases.values():
        for bandmask in (True, False):
            for plo in (None, clo):
                for term, out, rtol in ((lj_term, f64, 1e-10), (lj_term_fast, f64, TOL_FAST),
                                        (count_term, torch.int32, 0)):
                    kw = dict(MAXJ=maxj, term=term, out_dtype=out, bandmask=bandmask)
                    before = tile_pair_reduce.launches
                    got, ok = tile_pair_reduce(chi, ckeys, cstrides, csq, plo, **kw)
                    assert tile_pair_reduce.launches == before + 1
                    want, ok_p = tile_pair_reduce_plain(chi, ckeys, cstrides, csq, plo, **kw)
                    torch.cuda.synchronize()
                    assert bool(ok) and bool(ok_p)
                    if out == torch.int32:
                        assert combine_count(got) == combine_count(want) > 0
                    else:
                        assert got.dtype == f64
                        np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    one = dict(MAXJ=1, term=count_term, out_dtype=torch.int32)
    got, ok = tile_pair_reduce(shi, keys, strides, csq, **one)
    want, ok_p = tile_pair_reduce_plain(shi, keys, strides, csq, **one)
    assert not bool(ok) and not bool(ok_p)
    assert combine_count(got) == combine_count(want)

    # K10: two blobs in opposite corners of a 2,600 box, keys past 2^24
    rng = np.random.default_rng(1)
    blob = (1e5 / 0.01) ** (1 / 3)
    pts = np.concatenate([rng.uniform(0, blob, (100_000, 3)),
                          2600.0 - rng.uniform(0, blob, (100_000, 3))])
    bhi, blo, bkeys, bstrides = _sorted_cube(pts, cuda_device)
    assert int(bkeys.max()) >= 1 << 24
    m = max(_maxj(bkeys, bstrides))
    for term, out in ((lj_term, f64), (count_term, torch.int32)):
        kw = dict(MAXJ=m, packed=False, term=term, out_dtype=out)
        got, ok = tile_pair_reduce(bhi, bkeys, bstrides, csq, blo, **kw)
        want, ok_p = tile_pair_reduce_plain(bhi, bkeys, bstrides, csq, blo, **kw)
        assert bool(ok) and bool(ok_p)
        if out == torch.int32:
            assert combine_count(got) == combine_count(want) > 0
        else:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    _, ok = tile_pair_reduce(bhi, bkeys, bstrides, csq, blo, MAXJ=m)
    assert not bool(ok)  # the packed flag: f32 keys would round

    with pytest.raises(ValueError):
        tile_pair_reduce(shi, keys, strides, csq, MAXJ=maxj, term=lambda d: d)
    with pytest.raises(ValueError):
        tile_pair_reduce(shi, keys, strides, csq, MAXJ=maxj, min_islot=5)
    with pytest.raises(ValueError):
        tile_pair_reduce(shi.double(), keys, strides, csq, MAXJ=maxj)


def _thin(pts, device):
    """The thin box's sorted split inputs, on the card."""
    hi, lo = split_f64(torch.as_tensor(pts, device=device))
    info = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
    keys, _, shi, slo = sort_by_key(compute_keys(hi, info), hi, lo)
    return shi, slo, keys, info.strides


def _assert_forces(got, want, rel):
    """max |got - want| <= rel * max |want|, on f64 sums of f32 terms."""
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    assert err <= rel * float(want.double().abs().max()), err


def _prune_cases(shi, slo, keys, strides):
    """The two inputs that fail a prune of the forces kernels that is not
    conservative (sorted inputs of a lattice, keys kept): the facing
    clusters of `cluster_gap` (boxes one cutoff apart, pairs at cutoff
    (1 -+ 2^-23) and (1 -+ 2^-25) across the gap, resolved by f32 at one
    site and by the split low parts only at the other), and the lattice
    moved by up to a skin of 0.5 since its keys were built."""
    pts = shi.double() + slo.double()
    gap = cluster_gap(pts.cpu().numpy(), CUTOFF, GAP_SITES)
    drift = pts + torch.as_tensor(np.random.default_rng(5).uniform(
        -0.25, 0.25, tuple(pts.shape)), device=pts.device)
    return {"cluster_gap": (*split_f64(torch.as_tensor(gap, device=shi.device)), keys, strides),
            "drifted": (*split_f64(drift), keys, strides)}


@pytest.mark.gpu
def test_lag_forces_kernel_matches_plain_on_card(cuda_device):
    """K3 against its plain version on the same sorted CUDA tensors (the
    benchmark's thin box and a jittered lattice, n = 2e5, and the lattice's
    facing clusters and drifted state of `_prune_cases`): f64 forces to
    1e-10 of the largest (sums in another order), lj_force_factor_fast to
    its rsqrt bound, L = 64 (below the key window: the lag bound
    binds) and 256, padding rows inert, Newton's third law on the lattice, and K3
    against K7 on the same thin box."""
    n = 200_000
    cases = {
        "uniform": _thin(generate_points_random(n, lj_box(n, CUTOFF)), cuda_device),
        "lattice": _thin(generate_points_lattice(n, lj_box(n, CUTOFF)), cuda_device),
    }
    cases.update(_prune_cases(*cases["lattice"]))
    csq = CUTOFF**2
    f64 = torch.float64
    for name, (shi, slo, keys, strides) in cases.items():
        for plo in (None, slo):
            for gfn, rel in ((lj_force_factor, 1e-10), (lj_force_factor_fast, TOL_FAST_FORCES)):
                for L in (64, 256):
                    before = pair_lag_forces.launches
                    got = pair_lag_forces(shi, keys, strides, csq, plo, L=L, gfn=gfn,
                                          out_dtype=f64)
                    assert pair_lag_forces.launches == before + 1
                    want = pair_lag_forces_plain(shi, keys, strides, csq, plo, L=L,
                                                 gfn=gfn, out_dtype=f64)
                    assert got.shape == (n, 3) and got.dtype == f64
                    _assert_forces(got, want, rel)
        f32 = pair_lag_forces(shi, keys, strides, csq, slo, L=256)
        assert f32.dtype == torch.float32
        _assert_forces(f32, want, 1e-6)
    shi, slo, keys, strides = cases["lattice"]
    f = pair_lag_forces(shi, keys, strides, csq, slo, L=256, out_dtype=f64)
    assert float(f.sum(0).abs().max()) <= 1e-6 * float(f.abs().sum())
    tile, ok = tile_pair_forces(shi, keys, strides, csq, slo, MAXJ=16, bandmask=True,
                                out_dtype=f64)
    assert bool(ok)
    _assert_forces(tile, f, 1e-10)
    padded = keys.clone()
    padded[-500:] = SENTINEL_KEY
    got = pair_lag_forces(shi, padded, strides, csq, slo, L=256, out_dtype=f64)
    want = pair_lag_forces_plain(shi, padded, strides, csq, slo, L=256, out_dtype=f64)
    _assert_forces(got, want, 1e-10)
    with pytest.raises(ValueError):
        pair_lag_forces(shi, keys, strides, csq, gfn=lambda d: d)
    with pytest.raises(ValueError):
        pair_lag_forces(shi.double(), keys, strides, csq)
    with pytest.raises(ValueError):
        pair_lag_forces(shi, keys, strides, csq, sorted_payload=torch.ones_like(shi))


def _full_maxj(keys, strides, CB=8):
    n = keys.shape[0]
    C = max(-(-n // (CHUNK * CB)) * CB, CB) * CHUNK
    return suggest_maxj(_pad_and_desentinel(keys, C), segment_bands(strides, full=True),
                        half=False, per_band=True)


@pytest.mark.gpu
def test_tile_forces_kernel_matches_plain_on_card(cuda_device):
    """K7 against its plain version on the same sorted CUDA tensors: a
    uniform cube and a jittered cubic lattice at the benchmark's density
    (n = 2e5; masked and maskless, split and f32, f64 forces to 1e-10 of
    the largest, lj_force_factor_fast to its rsqrt bound), the lattice's
    facing clusters and drifted state of `_prune_cases`, an undersized
    MAXJ, and int32 keys past 2^24 (K11, packed=False)."""
    n = 200_000
    side = (n / 0.01) ** (1 / 3)
    f64 = torch.float64
    csq = CUTOFF**2
    cubes = {
        "uniform": _sorted_cube(np.random.default_rng(0).uniform(0, side, (n, 3)),
                                cuda_device),
        "lattice": _sorted_cube(generate_points_lattice(n, (side, side, side)),
                                cuda_device),
    }
    cubes.update(_prune_cases(*cubes["lattice"]))
    for name, (shi, slo, keys, strides) in cubes.items():
        maxj = _full_maxj(keys, strides)
        for bandmask in (True, False):
            for plo in (None, slo):
                for gfn, rel in ((lj_force_factor, 1e-10),
                                 (lj_force_factor_fast, TOL_FAST_FORCES)):
                    kw = dict(MAXJ=maxj, bandmask=bandmask, gfn=gfn, out_dtype=f64)
                    before = tile_pair_forces.launches
                    got, ok = tile_pair_forces(shi, keys, strides, csq, plo, **kw)
                    assert tile_pair_forces.launches == before + 1
                    want, ok_p = tile_pair_forces_plain(shi, keys, strides, csq, plo,
                                                        **kw)
                    assert bool(ok) and bool(ok_p), (name, bandmask)
                    _assert_forces(got, want, rel)
        if name == "lattice":
            assert float(got.sum(0).abs().max()) <= 1e-6 * float(got.abs().sum())
    shi, slo, keys, strides = cubes["lattice"]
    got, ok = tile_pair_forces(shi, keys, strides, csq, MAXJ=1, out_dtype=f64)
    want, ok_p = tile_pair_forces_plain(shi, keys, strides, csq, MAXJ=1, out_dtype=f64)
    assert not bool(ok) and not bool(ok_p)
    _assert_forces(got, want, 1e-10)

    # K11: two blobs in opposite corners of a 2,600 box, keys past 2^24
    rng = np.random.default_rng(1)
    blob = (1e5 / 0.01) ** (1 / 3)
    pts = np.concatenate([rng.uniform(0, blob, (100_000, 3)),
                          2600.0 - rng.uniform(0, blob, (100_000, 3))])
    bhi, blo, bkeys, bstrides = _sorted_cube(pts, cuda_device)
    assert int(bkeys.max()) >= 1 << 24
    m = max(_full_maxj(bkeys, bstrides))
    kw = dict(MAXJ=m, packed=False, out_dtype=f64)
    got, ok = tile_pair_forces(bhi, bkeys, bstrides, csq, blo, **kw)
    want, ok_p = tile_pair_forces_plain(bhi, bkeys, bstrides, csq, blo, **kw)
    assert bool(ok) and bool(ok_p)
    _assert_forces(got, want, 1e-10)
    _, ok = tile_pair_forces(bhi, bkeys, bstrides, csq, blo, MAXJ=m)
    assert not bool(ok)  # the packed flag: f32 keys would round

    with pytest.raises(ValueError):
        tile_pair_forces(shi, keys, strides, csq, MAXJ=4, gfn=lambda d: d)
    with pytest.raises(ValueError):
        tile_pair_forces(shi.double(), keys, strides, csq, MAXJ=4)


def _pbc_sorted(pts, box, kind, device):
    """Sorted split inputs of a periodic box on the card, as `ops.pbc`
    makes them: (hi, lo, keys, strides, payload plane or None, mi_box or
    None, reach or None). ``kind``: "keep", ghost images on every axis
    (the keep mask's shift-sign plane); "both", x and y folded and z
    ghost-extended (``minimage="auto"`` on the thin box); "mi", x and y
    folded and z open (the minimum image alone)."""
    from zelll_tpu_torch.core.geometry import Aabb
    from zelll_tpu_torch.ops.pbc import _ghost_bins, _minimage_bins, wrap_positions

    n = len(pts)
    box = np.asarray(box, np.float64)
    hi, lo = split_f64(torch.as_tensor(pts, device=device))
    if kind == "keep":
        bins, sp, slo, signs, ok = _ghost_bins(hi, [0.0] * 3, box, CUTOFF, B=n, G=7 * n, BE=n,
                                               positions_lo=lo, need_perm=False)
        assert bool(ok)
        return (sp, slo, bins.sorted_keys, bins.info.strides, signs[:, 0].contiguous(), None,
                None)
    if kind == "both":
        bins, sp, slo, pay, reach, mib, ok = _minimage_bins(
            hi, [0.0] * 3, box, CUTOFF, np.array([True, True, False]), B=n, G=n,
            positions_lo=lo, need_perm=False)
        assert bool(ok)
        return (sp.contiguous(), slo.contiguous(), bins.sorted_keys, bins.info.strides,
                pay[:, 0].contiguous(), mib, reach)
    fold = torch.tensor([True, True, False], device=device)
    whi = torch.where(fold, wrap_positions(hi, [0.0] * 3, box), hi)
    zlo, zhi = float(whi[:, 2].min()), float(whi[:, 2].max())
    aabb = Aabb(torch.tensor([0.0, 0.0, zlo], device=device),
                torch.tensor([box[0], box[1], zhi], device=device))
    info = GridInfo.create(aabb, CUTOFF, auto_order=True)
    keys, _, shi, slo = sort_by_key(compute_keys(whi, info), whi, lo)
    reach = tuple(max(int(np.ceil(box[a] / CUTOFF)) - 1, 1) if a < 2 else 1 for a in range(3))
    return (shi, slo, keys, info.strides, None,
            torch.tensor([box[0], box[1], 0.0], dtype=torch.float32), reach)


def _pbc_cases(n, device):
    """The periodic instances' inputs on the thin box lj_box(n): the uniform
    cloud, a jittered lattice, a seam lattice (`seam_cloud`: two layers of
    spacing 1.5 at each x and y face, whose pairs across x and y cross the
    seam only, and z filled, so that the z faces pair through ghost
    images) and the lattice drifted by
    up to a skin of 0.5 since its keys were built; by kind (`_pbc_sorted`)."""
    box = np.asarray(lj_box(n, CUTOFF))
    rng = np.random.default_rng(4)
    data = {"uniform": generate_points_random(n, box),
            "lattice": generate_points_lattice(n, box),
            "seam": seam_cloud(box, 1.5, 2, (0, 1), rng)}
    out = {}
    for kind in ("keep", "mi", "both"):
        for tag, pts in data.items():
            out[(kind, tag)] = _pbc_sorted(pts, box, kind, device)
        out[(kind, "drifted")] = _drifted(out[(kind, "lattice")], rng)
    return out


def _drifted(case, rng):
    """A sorted case's coordinates moved by up to a skin of 0.5 since its
    keys were built (keys, payload and window kept)."""
    shi, slo, *rest = case
    moved = shi.double() + slo.double() + torch.as_tensor(
        rng.uniform(-0.25, 0.25, tuple(shi.shape)), device=shi.device)
    return (*split_f64(moved), *rest)


@pytest.mark.gpu
def test_pbc_lag_reduce_kernel_matches_plain_on_card(cuda_device):
    """K1's periodic instances against the plain version on the same sorted
    CUDA tensors, on the four inputs of `_pbc_cases` (n = 20,000): the keep
    mask (ghost images on every axis), the minimum image alone (x and y
    folded, z open) and both (x and y folded, z ghosts), f32 and split,
    lj_term and count_term: counts exact, f64 totals to 1e-10; on the seam
    cloud a prune without periodic images drops pairs. Other payload rules
    raise."""
    from zelll_tpu_torch.ops.lag_pairs import PbcKeepTerm, suggest_lag

    csq = CUTOFF**2
    f64 = torch.float64
    for (kind, tag), (shi, slo, keys, strides, pay, mib, reach) in \
            _pbc_cases(20_000, cuda_device).items():
        L = suggest_lag(keys, strides, reach=reach)
        for plo in (None, slo):
            for term, out in ((lj_term, f64), (count_term, torch.int32)):
                t = term if pay is None else PbcKeepTerm(term)
                kw = dict(L=L, term=t, out_dtype=out, mi_box=mib, key_reach=reach)
                before = pair_lag_reduce.launches
                got = pair_lag_reduce(shi, keys, strides, csq, plo, pay, **kw)
                assert pair_lag_reduce.launches == before + 1
                want = pair_lag_reduce_plain(shi, keys, strides, csq, plo, pay, **kw)
                torch.cuda.synchronize()
                if out == torch.int32:
                    assert combine_count(got) == combine_count(want) > 0, (kind, tag)
                else:
                    np.testing.assert_allclose(float(got), float(want), rtol=1e-10,
                                               err_msg=f"{kind} {tag}")
    shi, slo, keys, strides, pay, mib, reach = _pbc_sorted(
        generate_points_random(2000, lj_box(2000, CUTOFF)), lj_box(2000, CUTOFF), "both",
        cuda_device)
    kw = dict(mi_box=mib, key_reach=reach)
    with pytest.raises(ValueError, match="payload rule"):
        pair_lag_reduce(shi, keys, strides, csq, None, pay, term=lambda d, a, b: d, **kw)
    with pytest.raises(ValueError, match="payload rule"):
        pair_lag_reduce(shi, keys, strides, csq, None, pay, **kw)
    with pytest.raises(ValueError, match="slice 9"):
        pair_lag_reduce(shi, keys, strides, csq, None, pay, term=PbcKeepTerm(lj_term),
                        min_islot=5, **kw)
    with pytest.raises(ValueError):
        pair_lag_reduce(shi.double(), keys, strides, csq, None, pay.double(),
                        term=PbcKeepTerm(lj_term), **kw)


@pytest.mark.gpu
def test_pbc_lag_forces_kernel_matches_plain_on_card(cuda_device):
    """K3's minimum-image instance against the plain version on the same
    sorted CUDA tensors: the "mi" and "both" inputs of `_pbc_cases`
    (n = 20,000, K3 runs on the ghost-extended array too), f32 and split,
    f64 forces to 1e-10 of the largest; Newton's third law on the
    lattice with x and y folded and z open. A payload raises."""
    from zelll_tpu_torch.ops.lag_pairs import suggest_lag

    csq = CUTOFF**2
    for (kind, tag), (shi, slo, keys, strides, pay, mib, reach) in \
            _pbc_cases(20_000, cuda_device).items():
        if kind == "keep":
            continue
        L = suggest_lag(keys, strides, reach=reach)
        for plo in (None, slo):
            kw = dict(L=L, mi_box=mib, key_reach=reach, out_dtype=torch.float64)
            before = pair_lag_forces.launches
            got = pair_lag_forces(shi, keys, strides, csq, plo, **kw)
            assert pair_lag_forces.launches == before + 1
            want = pair_lag_forces_plain(shi, keys, strides, csq, plo, **kw)
            _assert_forces(got, want, 1e-10)
            if kind == "mi" and tag == "lattice":
                assert float(got.sum(0).abs().max()) <= 1e-6 * float(got.abs().sum())
    with pytest.raises(ValueError, match="slice 5b"):
        pair_lag_forces(shi, keys, strides, csq, sorted_payload=torch.ones_like(shi),
                        mi_box=mib, key_reach=reach)


@pytest.mark.gpu
def test_pbc_tile_reduce_kernel_matches_plain_on_card(cuda_device):
    """K6's payload row (the keep mask) against the plain version on the
    same sorted CUDA tensors: a ghost-extended cube at the benchmark's
    density (n = 50,000): the uniform cloud, a jittered lattice, a seam
    lattice (two layers of spacing 2.5 at each x face) and the lattice
    drifted since its keys
    were built; masked and maskless, f32 and split, lj_term, lj_term_fast
    and count_term: counts exact, f64 totals to 1e-10 (TOL_FAST). Other
    payload rules and min_islot raise."""
    from zelll_tpu_torch.ops.lag_pairs import PbcKeepTerm

    n = 50_000
    side = (n / 0.01) ** (1 / 3)
    box = np.array([side] * 3)
    rng = np.random.default_rng(6)
    data = {"uniform": generate_points_random(n, box),
            "lattice": generate_points_lattice(n, box),
            "seam": seam_cloud(box, 2.5, 2, (0,), rng)}
    cases = {tag: _pbc_sorted(pts, box, "keep", cuda_device) for tag, pts in data.items()}
    cases["drifted"] = _drifted(cases["lattice"], rng)
    csq = CUTOFF**2
    f64 = torch.float64
    for tag, (shi, slo, keys, strides, pay, _, _) in cases.items():
        maxj = _maxj(keys, strides)
        for bandmask in (False, True):
            for plo in (None, slo):
                for term, out, rtol in ((lj_term, f64, 1e-10), (lj_term_fast, f64, TOL_FAST),
                                        (count_term, torch.int32, 0)):
                    kw = dict(MAXJ=maxj, term=PbcKeepTerm(term), out_dtype=out,
                              bandmask=bandmask)
                    before = tile_pair_reduce.launches
                    got, ok = tile_pair_reduce(shi, keys, strides, csq, plo, pay, **kw)
                    assert tile_pair_reduce.launches == before + 1
                    want, ok_p = tile_pair_reduce_plain(shi, keys, strides, csq, plo, pay, **kw)
                    torch.cuda.synchronize()
                    assert bool(ok) and bool(ok_p), tag
                    if out == torch.int32:
                        assert combine_count(got) == combine_count(want) > 0, tag
                    else:
                        np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                                                   err_msg=tag)
    with pytest.raises(ValueError, match="payload rule"):
        tile_pair_reduce(shi, keys, strides, csq, None, pay, MAXJ=maxj,
                         term=lambda d, a, b: d)
    with pytest.raises(ValueError, match="slice 9"):
        tile_pair_reduce(shi, keys, strides, csq, None, pay, MAXJ=maxj,
                         term=PbcKeepTerm(lj_term), min_islot=5)


@pytest.mark.gpu
def test_md_steps_never_sync_on_card(cuda_device):
    """The full-rebuild MD steps enqueue their kernels and read nothing back
    to the host (the skin loops read one drift flag per step, by design):
    under torch's sync debug mode a synchronising call raises. The steps
    still launch K3 and K7 and keep their flags."""
    from zelll_tpu_torch.models import (
        MDState, MDStateSplit, md_step, md_step_cubic_tile, md_step_split,
    )
    from zelll_tpu_torch.utils.datagen import lattice_cloud

    rng = np.random.default_rng(0)
    n = 20_000
    thin = lattice_cloud(n, lj_box(n, CUTOFF), rng)
    side = (n / 0.01) ** (1 / 3)
    cube = lattice_cloud(n, (side, side, side), rng)
    st = MDState.create(thin.astype(np.float32), rng.normal(0, 0.3, thin.shape),
                        device=cuda_device)
    sst = MDStateSplit.from_f64(thin, st.velocities, device=cuda_device)
    cst = MDState.create(cube.astype(np.float32), rng.normal(0, 0.3, cube.shape),
                         device=cuda_device)
    _, _, ckeys, cstrides = _sorted_cube(cube, cuda_device)
    maxj = tuple(m + 1 for m in _full_maxj(ckeys, cstrides))
    k3, k7 = pair_lag_forces.launches, tile_pair_forces.launches
    flags = []
    md_step(st, CUTOFF, 1e-4)  # builds K3 before the checked steps
    md_step_cubic_tile(cst, CUTOFF, 1e-4, MAXJ=maxj)  # and K7
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            st, ok = md_step(st, CUTOFF, 1e-4)
            sst, ok_s = md_step_split(sst, CUTOFF, 1e-4)
            cst, ok_c = md_step_cubic_tile(cst, CUTOFF, 1e-4, MAXJ=maxj)
            flags += [ok, ok_s, ok_c]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(f) for f in flags)
    assert pair_lag_forces.launches == k3 + 5
    assert tile_pair_forces.launches == k7 + 3


@pytest.mark.gpu
def test_per_particle_kernel_matches_plain_on_card(cuda_device):
    """K2 against its plain version on the same sorted CUDA tensors (the
    benchmark's thin box and a jittered lattice, n = 5e4), f32 and f64:
    counts exact, f64 LJ sums to 1e-10 of the largest, f32 to 1e-6; an
    undersized L drops the same pairs on both sides; sentinel rows inert.
    Then `CellGrid.coordination_numbers` on the card, through K2, against
    brute force."""
    from zelll_tpu_torch import CellGrid

    n = 50_000
    csq = CUTOFF**2
    cases = {
        "uniform": _thin(generate_points_random(n, lj_box(n, CUTOFF)), cuda_device),
        "lattice": _thin(generate_points_lattice(n, lj_box(n, CUTOFF)), cuda_device),
    }
    for name, (shi, slo, keys, strides) in cases.items():
        pos64 = shi.double() + slo.double()
        padded = keys.clone()
        padded[-500:] = SENTINEL_KEY
        for pos in (shi, pos64):
            for k, L in ((keys, 256), (keys, 16), (padded, 256)):
                for term in (count_term, lj_term):
                    before = pair_lag_per_particle.launches
                    got = pair_lag_per_particle(pos, k, strides, csq, L=L, term=term)
                    assert pair_lag_per_particle.launches == before + 1
                    want = pair_lag_per_particle_plain(pos, k, strides, csq, L=L,
                                                       term=term)
                    torch.cuda.synchronize()
                    assert got.dtype == pos.dtype and got.shape == (n,)
                    if term is count_term:
                        assert torch.equal(got, want), (name, pos.dtype, L)
                    else:
                        rel = 1e-10 if pos.dtype == torch.float64 else 1e-6
                        err = float((got.double() - want.double()).abs().max())
                        assert err <= rel * float(want.double().abs().max()), err
        full = pair_lag_per_particle(pos64, keys, strides, csq, L=256)
        short = pair_lag_per_particle(pos64, keys, strides, csq, L=16)
        assert float(short.sum()) < float(full.sum())
    with pytest.raises(ValueError):
        pair_lag_per_particle(shi, keys, strides, csq, term=lambda d: d)
    with pytest.raises(ValueError):
        pair_lag_per_particle(shi.half(), keys, strides, csq)
    with pytest.raises(ValueError):
        pair_lag_per_particle(shi[:, :2].contiguous(), keys, strides, csq)

    pts = np.random.default_rng(3).uniform(0, 1, (3000, 3)) * [6.0, 6.0, 40.0]
    cg = CellGrid(pts, cutoff=1.0, device=cuda_device)
    before = pair_lag_per_particle.launches
    got = cg.coordination_numbers()
    assert pair_lag_per_particle.launches == before + 1
    d = pts[:, None] - pts[None]
    dsq = (d * d).sum(-1)
    np.testing.assert_array_equal(got, ((dsq < 1.0) & (dsq > 0)).sum(1))


def _join_case(pos, queries, cutoff, dtype, device):
    """Sorted join inputs on the card: (query planes, query keys, particle
    planes with the (r, 1/r) payload, particle keys with a SENTINEL_KEY tail
    of far rows as `CellGrid` pads, strides, cutoff^2)."""
    from zelll_tpu_torch.ops.join import sort_queries

    n = len(pos)
    g = build(torch.as_tensor(pos, device=device), cutoff)
    info = g.info
    qplanes, qkeys, _, _ = sort_queries(torch.as_tensor(queries, device=device),
                                        info.origin, info.shape, info.strides,
                                        cutoff, dtype, device)
    sp = g.sorted_pos.to(dtype)
    r = torch.as_tensor(np.random.default_rng(n).uniform(1.0, 2.0, n),
                        device=device)[g.bins.perm.long()].to(dtype)
    tail = 300
    far = 1e12 + torch.arange(tail, device=device, dtype=dtype) * 1e5
    pplanes = [torch.cat([sp[:, a], far if a == 0 else torch.zeros_like(far)])
               for a in range(3)]
    pplanes += [torch.cat([r, torch.ones_like(far)]),
                torch.cat([1 / r, torch.ones_like(far)])]
    pkeys = torch.cat([g.bins.sorted_keys,
                       torch.full((tail,), SENTINEL_KEY, dtype=torch.int32,
                                  device=device)])
    csq = torch.tensor(cutoff, dtype=dtype, device=device) ** 2
    return qplanes, qkeys, pplanes, pkeys, info.strides, csq


@pytest.mark.gpu
def test_join_kernel_matches_plain_on_card(cuda_device):
    """K12 against its plain version on the same sorted CUDA tensors: a
    synthetic protein and a jittered lattice (n = 2e4, coordinates on a
    2^-10 grid so that a query at an atom + (cutoff, 0, 0) lies exactly at
    the cutoff), 4095 queries with exact atom positions (d == 0), points
    exactly at the cutoff, far points at +-1e9 and a SENTINEL_KEY particle
    tail; the samplers' shape (1024 queries at the atoms + 0.5 of a
    2000-atom protein, cutoff 4: sparse clusters with slab boxes); 40,000
    queries, enough clusters for the one-warp-per-cluster form (the others
    run the form whose 4 warps share a cluster), whose sorted cells
    straddle the 32-query cluster boundaries; clusters that mix far queries
    (clipped into the corner cell) with near ones in that cell; and a plane
    of 64 queries at an atom + (cutoff, dy, dz), whose clusters' boxes
    start exactly one cutoff from the atom, so that a prune with a strict
    gap test drops the pair at exactly the cutoff. The count, nearest and
    sdf instances in f32 and f64. Counts and minima exact (the inclusive <=
    shows at the cutoff queries); f64 SDF sums to 1e-10 of the largest; f32
    ones to 1e-4 of it (f32 sums of ~1e3 terms in another order, 2-ulp exp
    and rsqrt)."""
    from zelll_tpu_torch.ops.join import (
        _count_term, _nearest_term, join_reduce, join_reduce_plain,
    )
    from zelll_tpu_torch.ops.sdf_join import NACC, sdf_term
    from zelll_tpu_torch.utils.datagen import synthetic_protein

    n, cutoff = 20_000, 5.0
    rng = np.random.default_rng(11)
    protein, _ = synthetic_protein(n, 15.0 * (n / 2000) ** (1 / 3))
    lattice = generate_points_lattice(n, (60.0, 60.0, 60.0))
    instances = ((_count_term, "sum", 1, 0), (_nearest_term, "min", 1, 0),
                 (sdf_term, "sum", NACC, 2))
    configs = []
    for name, pos in (("protein", protein), ("lattice", lattice)):
        pos = np.round(pos * 1024) / 1024
        lo, hi = pos.min(0), pos.max(0)
        at = rng.choice(n, 200, replace=False)
        queries = np.concatenate([
            rng.uniform(lo - cutoff, hi + cutoff, (3500, 3)),
            pos[at[:100]],                       # d == 0
            pos[at[100:]] + [cutoff, 0.0, 0.0],  # exactly at the cutoff
            [[1e9, -1e9, 1e9], [-1e9, 1e9, -1e9]] * 98,
        ])[:4095]                                # not a multiple of 128
        configs.append((name, pos, queries, cutoff))
    protein, lattice = configs[0][1], configs[1][1]
    small, _ = synthetic_protein(2000, 15.0)
    small = np.round(small * 1024) / 1024
    configs.append(("sampler", small, small[:1024] + 0.5, 4.0))
    lo, hi = protein.min(0), protein.max(0)
    configs.append(("one_warp_form", protein, rng.uniform(lo, hi, (40_000, 3)), cutoff))
    # the corner cell below the lattice's origin: far queries clip into it,
    # near ones lie in it, alternating in the sorted order
    corner = lattice.min(0) - 0.5 * cutoff + rng.uniform(-0.4, 0.4, (48, 3)) * cutoff
    far = np.full((48, 3), -1e9)
    mixed = np.stack([corner, far], 1).reshape(-1, 3)
    configs.append(("far_mixed", lattice, mixed, cutoff))
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(8), indexing="ij"), -1)
    offsets = (grid.reshape(-1, 2) - 4) / 8  # dy, dz, 0 among them
    atom = lattice[n // 2]
    plane = atom + np.concatenate([np.full((64, 1), cutoff), offsets], 1)
    configs.append(("cutoff_plane", lattice, plane, cutoff))
    for name, pos, queries, cut in configs:
        for dtype in (torch.float64, torch.float32):
            qp, qk, pp, pk, strides, csq = _join_case(pos, queries, cut,
                                                      dtype, cuda_device)
            for term, reducer, n_out, npl in instances:
                pl = pp[:3 + npl]
                before = join_reduce.launches
                got, ok = join_reduce(qp, qk, pl, pk, strides, csq, term=term,
                                      n_out=n_out, reducer=reducer)
                assert join_reduce.launches == before + 1
                want, ok_p = join_reduce_plain(qp, qk, pl, pk, strides, csq,
                                               term=term, n_out=n_out,
                                               reducer=reducer)
                torch.cuda.synchronize()
                assert bool(ok) and bool(ok_p)
                assert got.shape == (len(queries), n_out) and got.dtype == dtype
                tag = (name, dtype, term.__name__)
                if term is sdf_term:
                    tol = 1e-10 if dtype == torch.float64 else 1e-4
                    err = float((got.double() - want.double()).abs().max())
                    assert err <= tol * float(want.double().abs().max()), (tag, err)
                    assert torch.isfinite(got).all(), tag
                else:
                    assert torch.equal(got, want), tag
                if term is _count_term:
                    # queries at d == 0 and at the cutoff see their atom
                    assert float(got.min()) >= 0 and float(got.max()) > 1
                    if name == "cutoff_plane":
                        # the plane's box starts exactly one cutoff from the atom
                        assert float(qp[0].min()) == float(atom[0] + cut)
                    if name == "far_mixed":
                        assert int(torch.unique(qk).numel()) == 1
    with pytest.raises(ValueError):
        join_reduce(qp, qk, pp[:3], pk, strides, csq, n_out=1,
                    term=lambda dsq, d, p, w: [w.to(dsq.dtype)])
    with pytest.raises(ValueError):
        join_reduce(qp, qk, pp[:3], pk, strides, csq, term=_count_term,
                    n_out=1, reducer="max")


# -- the observables kernels: stress (K4, K8) and histograms (K5, K9) ---------


def _sorted_at(pts, device, edge=CUTOFF):
    """Split, keyed on a grid of cell edge ``edge``, sorted on the card."""
    hi, lo = split_f64(torch.as_tensor(pts, device=device))
    info = GridInfo.create(aabb_from_positions(hi), edge, auto_order=True)
    keys, _, shi, slo = sort_by_key(compute_keys(hi, info), hi, lo)
    return shi, slo, keys, info.strides


def _observable_inputs(device, n, box):
    """The three inputs each observables kernel is held to: the uniform
    cloud with 500 duplicated points (coincident pairs), the jittered
    lattice (pair terms of one size, where a wrong term shows) and the
    lattice with a SENTINEL_KEY tail."""
    pts = generate_points_random(n, box)
    pts[-500:] = pts[:500]
    uniform = _sorted_at(pts, device)
    lattice = _sorted_at(generate_points_lattice(n, box), device)
    tail = lattice[2].clone()
    tail[-1000:] = SENTINEL_KEY
    return {"uniform": uniform, "lattice": lattice,
            "sentinel_tail": (lattice[0], lattice[1], tail, lattice[3])}


def _integer_lattice(shape):
    """Integer points on a grid of spacing 1: integer squared distances,
    exactly on the integer squared edges, so a wrong edge compare shows."""
    g = np.stack(np.meshgrid(*[np.arange(k) for k in shape], indexing="ij"), -1)
    return g.reshape(-1, 3).astype(np.float64)


def _assert_stress(got, want, rel):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = float((got.double() - want.double()).abs().max())
    assert err <= rel * float(want.double().abs().max()), err


@pytest.mark.gpu
def test_lag_stress_kernel_matches_plain_on_card(cuda_device):
    """K4 against its plain version on the same sorted CUDA tensors: f64
    stress to 1e-10 of the largest component (TOL_FAST_FORCES with the
    fast factor), split, f32 and f64 coordinates, coincident points, a
    sentinel tail and an undersized L; K1's virial term against its plain
    version and against the trace."""
    n = 50_000
    csq = CUTOFF**2
    f64 = torch.float64
    for tag, (shi, slo, keys, strides) in _observable_inputs(
            cuda_device, n, lj_box(n, CUTOFF)).items():
        for plo in (slo, None):
            for gfn, tol in ((lj_force_factor, 1e-10), (lj_force_factor_fast, TOL_FAST_FORCES)):
                for L in (256, 16):
                    kw = dict(L=L, gfn=gfn, out_dtype=f64)
                    before = pair_lag_stress.launches
                    got = pair_lag_stress(shi, keys, strides, csq, plo, **kw)
                    assert pair_lag_stress.launches == before + 1
                    _assert_stress(got, pair_lag_stress_plain(shi, keys, strides, csq,
                                                              plo, **kw), tol)
        pos64 = shi.double() + slo.double()
        got = pair_lag_stress(pos64, keys, strides, csq)
        assert got.dtype == f64
        _assert_stress(got, pair_lag_stress_plain(pos64, keys, strides, csq), 1e-10)
        w = pair_lag_reduce(shi, keys, strides, csq, slo, term=lj_virial_term, out_dtype=f64)
        w_p = pair_lag_reduce_plain(shi, keys, strides, csq, slo, term=lj_virial_term,
                                    out_dtype=f64)
        np.testing.assert_allclose(float(w), float(w_p), rtol=1e-10)
        trace = torch.trace(pair_lag_stress(shi, keys, strides, csq, slo, out_dtype=f64))
        if tag != "uniform":  # coincident pairs: the virial keeps their inf
            np.testing.assert_allclose(float(trace), float(w), rtol=1e-6)
    with pytest.raises(ValueError):
        pair_lag_stress(shi, keys, strides, csq, gfn=lambda d: d)
    with pytest.raises(ValueError):
        pair_lag_stress(shi, keys, strides, csq, min_islot=5)
    with pytest.raises(ValueError):
        pair_lag_stress(shi, keys, strides, csq, None, keys.float(),
                        pair_weight=lambda a, b: a)


@pytest.mark.gpu
def test_lag_hist_kernel_matches_plain_on_card(cuda_device):
    """K5 against its plain version on the same sorted CUDA tensors: counts
    exact at K = 16, 32 and 64, split, f32 and f64 coordinates, a species
    pair mask, coincident points, a sentinel tail, an undersized L, and an
    integer lattice whose squared distances fall exactly on the edges."""
    n = 50_000
    csq = CUTOFF**2
    for tag, (shi, slo, keys, strides) in _observable_inputs(
            cuda_device, n, lj_box(n, CUTOFF)).items():
        spec = torch.as_tensor(np.random.default_rng(2).integers(0, 3, n),
                               device=cuda_device)
        for plo in (slo, None):
            for K in (16, 32, 64):
                for L in (256, 16):
                    esq = torch.linspace(0, CUTOFF, K, dtype=torch.float64).float() ** 2
                    before = pair_lag_hist.launches
                    got = pair_lag_hist(shi, keys, strides, esq, plo, L=L)
                    assert pair_lag_hist.launches == before + 1
                    want = pair_lag_hist_plain(shi, keys, strides, esq, plo, L=L)
                    assert got.dtype == torch.int32 and got.shape == (2, K)
                    np.testing.assert_array_equal(combine_count_vec(got),
                                                  combine_count_vec(want))
        pos64 = shi.double() + slo.double()
        esq = torch.linspace(0, CUTOFF, 32, dtype=torch.float64) ** 2
        for pos, pay, mask in ((pos64, None, None), (shi, spec.float(), SpeciesPairMask(0, 2)),
                               (pos64, spec.double(), SpeciesPairMask(1, 1))):
            got = pair_lag_hist(pos, keys, strides, esq, None, pay, pair_mask=mask)
            want = pair_lag_hist_plain(pos, keys, strides, esq, None, pay, pair_mask=mask)
            c = combine_count_vec(got)
            np.testing.assert_array_equal(c, combine_count_vec(want))
            assert c[-1] > 0
    shi, slo, keys, strides = _sorted_at(_integer_lattice((12, 12, 200)), cuda_device, 3.0)
    esq = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 9.0], device=cuda_device)
    for pos in (shi, shi.double()):
        got = combine_count_vec(pair_lag_hist(pos, keys, strides, esq.to(pos.dtype), L=1024))
        want = combine_count_vec(pair_lag_hist_plain(pos, keys, strides, esq.to(pos.dtype),
                                                     L=1024))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        pair_lag_hist(shi, keys, strides, esq, None, spec.float(), pair_mask=lambda a, b: a == b)
    with pytest.raises(ValueError):
        pair_lag_hist(shi, keys, strides, esq, min_islot=3)


@pytest.mark.gpu
def test_tile_stress_kernel_matches_plain_on_card(cuda_device):
    """K8 against its plain version on the same sorted CUDA tensors: a
    cube at the benchmark's density (uniform with coincident points, the
    jittered lattice and a sentinel tail), masked and maskless, split, f32
    and f64, both force factors, and an undersized MAXJ (the same flag and
    the same partial sums); K6's virial term against its plain version."""
    n = 50_000
    side = (n / 0.01) ** (1 / 3)
    csq = CUTOFF**2
    f64 = torch.float64
    for tag, (shi, slo, keys, strides) in _observable_inputs(
            cuda_device, n, (side, side, side)).items():
        maxj = _maxj(keys, strides)
        for bandmask in (False, True):
            for plo in (slo, None):
                for gfn, tol in ((lj_force_factor, 1e-10),
                                 (lj_force_factor_fast, TOL_FAST_FORCES)):
                    kw = dict(MAXJ=maxj, bandmask=bandmask, gfn=gfn, out_dtype=f64)
                    before = tile_pair_stress.launches
                    got, ok = tile_pair_stress(shi, keys, strides, csq, plo, **kw)
                    assert tile_pair_stress.launches == before + 1
                    want, ok_p = tile_pair_stress_plain(shi, keys, strides, csq, plo, **kw)
                    assert bool(ok) and bool(ok_p)
                    _assert_stress(got, want, tol)
            kw = dict(MAXJ=maxj, bandmask=bandmask, term=lj_virial_term, out_dtype=f64)
            w, _ = tile_pair_reduce(shi, keys, strides, csq, slo, **kw)
            w_p, _ = tile_pair_reduce_plain(shi, keys, strides, csq, slo, **kw)
            np.testing.assert_allclose(float(w), float(w_p), rtol=1e-10)
        pos64 = shi.double() + slo.double()
        got, _ = tile_pair_stress(pos64, keys, strides, csq, MAXJ=maxj)
        want, _ = tile_pair_stress_plain(pos64, keys, strides, csq, MAXJ=maxj)
        assert got.dtype == f64
        _assert_stress(got, want, 1e-10)
        kw = dict(MAXJ=1, bandmask=True, out_dtype=f64)
        got, ok = tile_pair_stress(shi, keys, strides, csq, slo, **kw)
        want, ok_p = tile_pair_stress_plain(shi, keys, strides, csq, slo, **kw)
        assert not bool(ok) and not bool(ok_p)
        _assert_stress(got, want, 1e-10)
    with pytest.raises(ValueError):
        tile_pair_stress(shi, keys, strides, csq, MAXJ=maxj, gfn=lambda d: d)
    with pytest.raises(ValueError):
        tile_pair_stress(shi, keys, strides, csq, MAXJ=maxj, min_islot=5)


@pytest.mark.gpu
def test_tile_hist_kernel_matches_plain_on_card(cuda_device):
    """K9 against its plain version on the same sorted CUDA tensors: counts
    exact on the cube's three inputs, masked and maskless, split, f32 and
    f64, K = 16 and 64, a species pair mask, an undersized MAXJ, an integer
    lattice whose squared distances fall exactly on the edges, and the
    inputs that fail a cluster prune that is not conservative (the facing
    clusters of `cluster_gap`, whose facing pairs lie in a window of the
    later cluster, and the lattice drifted since its keys were built), in
    split, f32 and f64 through the double box, masked and maskless, with
    and without the species mask."""
    n = 50_000
    side = (n / 0.01) ** (1 / 3)
    inputs = _observable_inputs(cuda_device, n, (side, side, side))
    for tag, (shi, slo, keys, strides) in inputs.items():
        maxj = _maxj(keys, strides)
        spec = torch.as_tensor(np.random.default_rng(3).integers(0, 3, n),
                               device=cuda_device)
        for bandmask in (False, True):
            for plo in (slo, None):
                for K in (16, 64):
                    esq = torch.linspace(0, CUTOFF, K, dtype=torch.float64).float() ** 2
                    kw = dict(MAXJ=maxj, bandmask=bandmask)
                    before = tile_pair_hist.launches
                    got, ok = tile_pair_hist(shi, keys, strides, esq, plo, **kw)
                    assert tile_pair_hist.launches == before + 1
                    want, ok_p = tile_pair_hist_plain(shi, keys, strides, esq, plo, **kw)
                    assert bool(ok) and bool(ok_p)
                    np.testing.assert_array_equal(combine_count_vec(got),
                                                  combine_count_vec(want))
        pos64 = shi.double() + slo.double()
        esq = torch.linspace(0, CUTOFF, 32, dtype=torch.float64) ** 2
        for pos, pay, mask, m in ((pos64, None, None, maxj),
                                  (shi, spec.float(), SpeciesPairMask(0, 2), maxj),
                                  (pos64, spec.double(), SpeciesPairMask(1, 1), maxj),
                                  (shi, None, None, 1)):
            kw = dict(MAXJ=m, bandmask=m == 1, pair_mask=mask)
            got, ok = tile_pair_hist(pos, keys, strides, esq.to(pos.dtype), None, pay, **kw)
            want, ok_p = tile_pair_hist_plain(pos, keys, strides, esq.to(pos.dtype), None,
                                              pay, **kw)
            assert bool(ok) == bool(ok_p) == (m != 1)
            np.testing.assert_array_equal(combine_count_vec(got), combine_count_vec(want))
    shi, slo, keys, strides = inputs["lattice"]
    maxj = _maxj(keys, strides)
    esq = torch.linspace(0, CUTOFF, 32, dtype=torch.float64) ** 2
    spec = torch.as_tensor(np.random.default_rng(4).integers(0, 2, n), device=cuda_device)
    for bandmask in (True, False):
        inp = tile_inputs(shi.t().contiguous(), keys, strides, MAXJ=maxj, bandmask=bandmask)
        bounds, bands = inp.bounds.long().cpu(), inp.bands.long().cpu()
        for s in GAP_SITES:
            i, j = s + 32, s + 31
            first = int(bounds[i // CHUNK, 0] + bounds[i // CHUNK, 1])
            assert first <= j // CHUNK < first + int(bounds[i // CHUNK, 2])
            assert int(bands[0, 0]) <= int(keys[i]) - int(keys[j]) <= int(bands[0, 1])
    for tag, (ghi, glo, gkeys, gstrides) in _prune_cases(shi, slo, keys, strides).items():
        for bandmask in (False, True):
            for pos, plo in ((ghi, glo), (ghi, None), (ghi.double() + glo.double(), None)):
                for pay, mask in ((None, None), (spec.to(pos.dtype), SpeciesPairMask(0, 1))):
                    kw = dict(MAXJ=maxj, bandmask=bandmask, pair_mask=mask)
                    e = esq.to(pos.dtype)
                    got, ok = tile_pair_hist(pos, gkeys, gstrides, e, plo, pay, **kw)
                    want, ok_p = tile_pair_hist_plain(pos, gkeys, gstrides, e, plo, pay, **kw)
                    assert bool(ok) == bool(ok_p)
                    c = combine_count_vec(got)
                    np.testing.assert_array_equal(c, combine_count_vec(want))
                    assert c[-1] > 0, (tag, bandmask, pos.dtype)
    shi, slo, keys, strides = _sorted_at(_integer_lattice((40, 40, 40)), cuda_device, 3.0)
    esq = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 9.0], device=cuda_device)
    maxj = _maxj(keys, strides)
    for pos in (shi, shi.double()):
        for bandmask in (False, True):
            kw = dict(MAXJ=maxj, bandmask=bandmask)
            got, ok = tile_pair_hist(pos, keys, strides, esq.to(pos.dtype), **kw)
            want, ok_p = tile_pair_hist_plain(pos, keys, strides, esq.to(pos.dtype), **kw)
            assert bool(ok) == bool(ok_p)
            np.testing.assert_array_equal(combine_count_vec(got), combine_count_vec(want))
    with pytest.raises(ValueError):
        tile_pair_hist(shi, keys, strides, torch.linspace(0, 9, 65, device=cuda_device))
    with pytest.raises(ValueError):
        tile_pair_hist(shi, keys, strides, esq, min_islot=3)

