"""The port's CUDA kernels (K1, K3, K6, K7) against their plain PyTorch
versions on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with a CUDA card and nvcc:

    python -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -q

(``--noconftest`` skips tests/conftest.py, which configures JAX.) Without a
card every test here skips: a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from zelll_tpu_torch.core import (
    SENTINEL_KEY,
    GridInfo,
    aabb_from_positions,
    build,
    compute_keys,
    sort_by_key,
)
from zelll_tpu_torch.ops.lag_pairs import (
    _pad_and_desentinel,
    combine_count,
    count_term,
    lag_coverage_ok,
    lj_term,
    lj_term_fast,
    pair_lag_forces,
    pair_lag_forces_plain,
    pair_lag_reduce,
    pair_lag_reduce_plain,
    split_f64,
)
from zelll_tpu_torch.ops.lj import lj_force_factor, lj_force_factor_fast
from zelll_tpu_torch.ops.segments import CHUNK, segment_bands, suggest_maxj
from zelll_tpu_torch.ops.tile_pairs import (
    tile_pair_forces,
    tile_pair_forces_plain,
    tile_pair_reduce,
    tile_pair_reduce_plain,
)
from zelll_tpu_torch.utils.datagen import (
    generate_points_lattice,
    generate_points_random,
    lj_box,
)

CUTOFF = 10.0
# lj_term_fast on the card against its plain version: rsqrtf and
# torch.rsqrt may each be 2 ulp off, and t3 = r^-6 multiplies that
# relative error by 6 (no cancellation in t3 - 1 at separations >= 2).
# lj_force_factor_fast's t^3 inv = r^-8 multiplies it by 8, and the
# forces are held to the largest force, not term by term, so the same
# bound holds for them with 8 in place of 6.
TOL_FAST = 6 * 4 * 2.0**-23
TOL_FAST_FORCES = 8 * 4 * 2.0**-23


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_lag_reduce_kernel_matches_plain_on_card(cuda_device):
    """K1 against its plain version on the same sorted CUDA tensors (the
    benchmark's thin box, and a jittered lattice): counts exact, f32
    energies to 1e-6 and f64 totals to 1e-10 (f64 sums in another order),
    the same lags, sentinel rows inert."""
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
    jittered cubic lattice at the benchmark's density (f64 totals to
    1e-10, counts exact, masked and maskless, split and f32, lj_term_fast
    to TOL_FAST), an undersized MAXJ, and int32 keys past 2^24 (K10)."""
    n = 200_000
    side = (n / 0.01) ** (1 / 3)
    shi, slo, keys, strides = _sorted_cube(
        generate_points_lattice(n, (side, side, side)), cuda_device)
    maxj = _maxj(keys, strides)
    csq = CUTOFF**2
    f64 = torch.float64
    for bandmask in (True, False):
        for plo in (None, slo):
            for term, out, rtol in ((lj_term, f64, 1e-10), (lj_term_fast, f64, TOL_FAST),
                                    (count_term, torch.int32, 0)):
                kw = dict(MAXJ=maxj, term=term, out_dtype=out, bandmask=bandmask)
                before = tile_pair_reduce.launches
                got, ok = tile_pair_reduce(shi, keys, strides, csq, plo, **kw)
                assert tile_pair_reduce.launches == before + 1
                want, ok_p = tile_pair_reduce_plain(shi, keys, strides, csq, plo, **kw)
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


@pytest.mark.gpu
def test_lag_forces_kernel_matches_plain_on_card(cuda_device):
    """K3 against its plain version on the same sorted CUDA tensors (the
    benchmark's thin box and a jittered lattice, n = 2e5): f64 forces to
    1e-10 of the largest (sums in another order), lj_force_factor_fast to
    its rsqrt bound, padding rows inert, Newton's third law on the lattice,
    and K3 against K7 on the same thin box."""
    n = 200_000
    cases = {
        "uniform": _thin(generate_points_random(n, lj_box(n, CUTOFF)), cuda_device),
        "lattice": _thin(generate_points_lattice(n, lj_box(n, CUTOFF)), cuda_device),
    }
    csq = CUTOFF**2
    f64 = torch.float64
    for name, (shi, slo, keys, strides) in cases.items():
        for plo in (None, slo):
            for gfn, rel in ((lj_force_factor, 1e-10), (lj_force_factor_fast, TOL_FAST_FORCES)):
                before = pair_lag_forces.launches
                got = pair_lag_forces(shi, keys, strides, csq, plo, L=256, gfn=gfn,
                                      out_dtype=f64)
                assert pair_lag_forces.launches == before + 1
                want = pair_lag_forces_plain(shi, keys, strides, csq, plo, L=256,
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
    the largest, lj_force_factor_fast to its rsqrt bound), an undersized
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
