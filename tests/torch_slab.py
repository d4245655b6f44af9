"""Checks of the port's slab decomposition (`zelll_tpu_torch.parallel`) on an
8-shard mesh of CPU shards, in f64 through the kernels' plain versions.

They mirror tests/test_parallel.py (every function but
``test_sharded_stress_matches_oracle``; ``sharded_stress`` is not ported
yet) on the same seeded inputs and with the same tolerances, held to brute
force and to the port's single-device functions as the JAX tests hold
JAX's; `md_step_and_repartition_match_jax` holds one sharded MD step and
one distributed repartition to the JAX package's (one jitted call on its
8 virtual CPU devices). Existing port test functions call them, so that the
suite's collected test count, which sets the xdist layout, stays as it is
(ROADMAP.md): each host names the check it runs.
"""

import numpy as np
import pytest
import torch

from zelll_tpu_torch.core import bin_and_sort, build
from zelll_tpu_torch.core.pairs import pair_energy_per_particle, pair_forces
from zelll_tpu_torch.ops.lag_pairs import (
    combine_count_vec,
    lag_coverage_ok,
    pair_lag_reduce,
)
from zelll_tpu_torch.ops.lj import lj, lj_force_factor
from zelll_tpu_torch.ops.tile_pairs import tile_pair_reduce
from zelll_tpu_torch.parallel import (
    make_mesh,
    make_sharded_potential,
    partition_by_slab,
    repartition,
    repartition_exchange,
    sharded_lj_energy,
    sharded_md_step,
    sharded_pair_hist,
)
from zelll_tpu_torch.parallel import domain, mesh as M

D = 8
CUTOFF = 1.0


def cpu_mesh(n: int = D):
    return make_mesh(n, devices="cpu")


def cloud(n=600, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, size=(n, 3)) * np.array([3.0, 3.0, 24.0])


def ref_energy(pts, cutoff):
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    v = dsq[np.triu_indices(len(pts), 1)]
    v = v[v < cutoff**2]
    t3 = (1.0 / v) ** 3
    return (4.0 * t3 * (t3 - 1.0)).sum()


def brute_forces(pts, cutoff):
    n = len(pts)
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    mask = (dsq < cutoff**2) & ~np.eye(n, dtype=bool)
    inv = 1.0 / np.where(mask, dsq, 1.0)
    t = inv**3
    g = np.where(mask, 24.0 * t * (2.0 * t - 1.0) * inv, 0.0)
    return (g[:, :, None] * d).sum(axis=1)


def shells(pts, edges):
    d = pts[:, None, :] - pts[None, :, :]
    dist = np.sqrt((d * d).sum(-1))
    return np.histogram(dist[np.triu_indices(len(pts), 1)], bins=edges)[0]


def t(x):
    return torch.as_tensor(np.asarray(x))


# -- host: test_torch_binning.py::test_stable_sort_matches_jax_exactly -------

def partition_matches_jax(jax_partition_by_slab):
    """`partition_by_slab` is the JAX package's bit for bit (z- and
    x-elongated clouds, n a multiple of 8 and not, so the key-safe pads
    show), and its pads sort last beyond sup on the major axis, mutually
    more than a cutoff apart (test_partition_by_slab_pads_on_major_axis)."""
    for n, seed in ((640, 5), (637, 41), (317, 43)):
        for pts in (cloud(n, seed), cloud(n, seed)[:, ::-1].copy()):
            got, nl = partition_by_slab(pts, CUTOFF, D)
            want, nl_j = jax_partition_by_slab(pts, CUTOFF, D)
            assert nl == nl_j and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    pts = cloud(n=317, seed=43)[:, ::-1]
    parts, n_local = partition_by_slab(pts, CUTOFF, D)
    n_pad = n_local * D - 317
    assert n_pad > 0
    pads = parts[-n_pad:]
    assert (pads[:, 0] > pts[:, 0].max() + CUTOFF).all()
    np.testing.assert_allclose(pads[:, 1], pts[:, 1].min())
    np.testing.assert_allclose(pads[:, 2], pts[:, 2].min())
    assert (np.diff(np.sort(pads[:, 0])) > CUTOFF).all()


# -- host: test_torch_binning.py::test_stable_order_within_cells_and_unsort --

def repartitions():
    """test_repartition_restores_slab_invariant,
    test_repartition_exchange_matches_allgather_repartition,
    test_repartition_exchange_flags_long_jumps and
    test_repartition_exchange_flags_small_capacity; and the ring form
    (periodic boxes) equal to `repartition` where every particle stays
    within one slab."""
    m = cpu_mesh()
    pts = cloud(n=320, seed=11)
    parts, _ = partition_by_slab(pts, CUTOFF, D)
    vel = np.arange(320 * 3).reshape(320, 3) * 1.0
    perm = np.random.default_rng(0).permutation(320)
    p2, v2 = repartition(m, cutoff=CUTOFF)(t(parts[perm]), t(vel[perm]))
    e, ok = sharded_lj_energy(m, cutoff=CUTOFF, H=64, K=16, chunk=16)(p2)
    assert bool(ok)
    np.testing.assert_allclose(float(e), ref_energy(pts, CUTOFF), rtol=1e-9)
    order = {tuple(np.round(r, 9)): i for i, r in enumerate(parts)}
    for r, v in zip(p2.numpy(), v2.numpy()):
        np.testing.assert_allclose(v, vel[order[tuple(np.round(r, 9))]])

    parts, _ = partition_by_slab(cloud(n=320, seed=21), CUTOFF, D)
    drift = t(parts + np.random.default_rng(7).normal(0, 0.3, parts.shape))
    v = t(np.arange(parts.size, dtype=np.float64).reshape(parts.shape))
    p_ref, v_ref = repartition(m, cutoff=CUTOFF)(drift, v)
    p_new, v_new, ok = repartition_exchange(m, cutoff=CUTOFF)(drift, v)
    assert bool(ok)
    assert torch.equal(p_new, p_ref) and torch.equal(v_new, v_ref)

    def ring(pos, vel):
        cap = max(pos.shape[0] // 4, 1)
        info = domain._global_grid_info(pos, CUTOFF)
        return domain._repartition_exchange_local(pos, vel, info, CUTOFF, cap, ring=True)

    p_ring, v_ring, ok = M.shard_map(ring, m, (M.AXIS, M.AXIS), (M.AXIS, M.AXIS, None))(drift, v)
    assert bool(ok)
    assert torch.equal(p_ring, p_ref) and torch.equal(v_ring, v_ref)

    parts, _ = partition_by_slab(cloud(n=320, seed=22), CUTOFF, D)
    scrambled = t(parts[np.random.default_rng(3).permutation(len(parts))])
    *_, ok = repartition_exchange(m, cutoff=CUTOFF)(scrambled, torch.zeros_like(scrambled))
    assert not bool(ok)
    parts, _ = partition_by_slab(cloud(n=320, seed=23), CUTOFF, D)
    drift = t(parts + np.random.default_rng(9).normal(0, 0.6, parts.shape))
    *_, ok = repartition_exchange(m, cutoff=CUTOFF, A=1)(drift, torch.zeros_like(drift))
    assert not bool(ok)


# -- host: test_torch_lj_md.py::test_md_step_matches_manual_integration_and_jax

def md_step_and_repartition_match_jax(jp, jax, jnp, sharding):
    """One sharded MD step (the default, XLA path) and one distributed
    repartition of the drifted result, on 8 shards, against the JAX
    package's on its 8 virtual CPU devices in one jitted call: energy,
    flags, and the new positions and velocities to 1e-9 (of the largest
    velocity: near pairs of the uniform cloud give velocities ~1e8)."""
    parts, _ = partition_by_slab(cloud(n=480, seed=8), CUTOFF, D)
    rng = np.random.default_rng(7)
    vel = rng.normal(0, 1, parts.shape)
    drift = rng.normal(0, 0.3, parts.shape)
    step = jp.sharded_md_step(jp.make_mesh(D), cutoff=CUTOFF, H=60, K=16, chunk=16, dt=1e-9)
    rx = jp.repartition_exchange(jp.make_mesh(D), cutoff=CUTOFF)

    def both(p, v, d):
        p1, v1, e, cov = step(p, v)
        return (e, cov) + tuple(rx(p1 + d, v1))

    put = [jax.device_put(jnp.asarray(a), sharding) for a in (parts, vel, drift)]
    e_j, cov_j, p_j, v_j, ok_j = jax.jit(both)(*put)
    m = cpu_mesh()
    p1, v1, e, cov = sharded_md_step(m, cutoff=CUTOFF, H=60, K=16, chunk=16, dt=1e-9)(
        t(parts), t(vel))
    p2, v2, ok = repartition_exchange(m, cutoff=CUTOFF)(p1 + t(drift), v1)
    assert bool(cov) and bool(cov_j) and bool(ok) and bool(ok_j)
    np.testing.assert_allclose(float(e), float(e_j), rtol=1e-9)
    np.testing.assert_allclose(p2.numpy(), np.asarray(p_j), rtol=1e-9, atol=1e-12)
    v_j = np.asarray(v_j)
    np.testing.assert_allclose(v2.numpy(), v_j, rtol=0, atol=1e-9 * np.abs(v_j).max())


def md_steps():
    """test_sharded_md_step_forces_match_single_device,
    test_sharded_pallas_md_step_matches_xla_path, the MD half of
    test_pallas_H_exceeds_n_local and
    test_sharded_md_step_orientation_invariant."""
    m = cpu_mesh()
    parts, n_local = partition_by_slab(cloud(n=400, seed=3), CUTOFF, D)
    dt = 1e-9
    _, v, e, cov = sharded_md_step(m, cutoff=CUTOFF, H=50, K=16, chunk=16, dt=dt)(
        t(parts), torch.zeros(parts.shape, dtype=torch.float64))
    assert bool(cov)
    np.testing.assert_allclose(float(e), ref_energy(parts, CUTOFF), rtol=1e-9)
    grid = build(t(parts), CUTOFF)
    K = int(grid.bins.max_cell_count())
    v_ref = dt * pair_forces(grid, lj_force_factor, K=K, chunk=16, cutoff_sq=CUTOFF**2).numpy()
    for d in range(D):
        a = v.numpy()[d * n_local:(d + 1) * n_local]
        b = v_ref[d * n_local:(d + 1) * n_local]
        np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0), rtol=1e-6,
                                   atol=1e-12)

    parts, _ = partition_by_slab(cloud(n=480, seed=8), CUTOFF, D)
    pos, vel = t(parts), torch.zeros(parts.shape, dtype=torch.float64)
    p1, v1, e1, c1 = sharded_md_step(m, cutoff=CUTOFF, H=60, K=16, chunk=16, dt=1e-8)(pos, vel)
    p2, v2, e2, c2 = sharded_md_step(m, cutoff=CUTOFF, H=60, dt=1e-8, use_pallas=True, M=256,
                                     L=128)(pos, vel)
    assert bool(c1) and bool(c2)
    np.testing.assert_allclose(float(e1), float(e2), rtol=1e-9)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=1e-9)

    pts = cloud(n=320, seed=12)
    parts, n_local = partition_by_slab(pts, CUTOFF, D)
    assert n_local < 128
    _, _, e2, _ = sharded_md_step(m, cutoff=CUTOFF, H=2 * n_local, dt=1e-9, use_pallas=True,
                                  M=256, L=128)(t(parts), torch.zeros(parts.shape,
                                                                     dtype=torch.float64))
    np.testing.assert_allclose(float(e2), ref_energy(pts, CUTOFF), rtol=1e-9)

    pts = cloud(n=640, seed=42)
    results = []
    for orient in (pts, pts[:, ::-1].copy()):
        parts, _ = partition_by_slab(orient, CUTOFF, D)
        p, v, e, ok = sharded_md_step(m, cutoff=CUTOFF, H=64, K=16, chunk=16, dt=1e-4)(
            t(parts), torch.zeros(parts.shape, dtype=torch.float64))
        assert bool(ok)
        results.append((p.numpy(), float(e)))
    (p_a, e_a), (p_b, e_b) = results
    np.testing.assert_allclose(e_a, e_b, rtol=1e-12)
    b = p_b[:, ::-1]
    np.testing.assert_allclose(p_a[np.lexsort(p_a.T)], b[np.lexsort(b.T)], rtol=1e-12,
                               atol=1e-12)


# -- host: test_torch_lag_pairs.py::test_coverage_and_suggest_lag_match_jax --

def energies():
    """test_per_particle_energy_sums_to_total,
    test_sharded_energy_matches_reference,
    test_sharded_pallas_energy_matches_reference,
    test_halo_flag_detects_small_H, test_capacity_flag_detects_small_K, the
    energy half of test_pallas_H_exceeds_n_local and
    test_sharded_energy_orientation_invariant; and a one-shard mesh equal to
    the single-device path on all three backends."""
    pts = cloud()
    grid = build(t(pts), CUTOFF)
    K = int(grid.bins.max_cell_count())
    e_pp = pair_energy_per_particle(grid, lj, K=K, chunk=16, cutoff_sq=CUTOFF**2)
    np.testing.assert_allclose(float(e_pp.sum()), ref_energy(pts, CUTOFF), rtol=1e-10)

    m = cpu_mesh()
    parts, _ = partition_by_slab(pts, CUTOFF, D)
    e, ok = sharded_lj_energy(m, cutoff=CUTOFF, H=64, K=16, chunk=16)(t(parts))
    assert bool(ok)
    np.testing.assert_allclose(float(e), ref_energy(pts, CUTOFF), rtol=1e-9)

    pts = cloud(n=640, seed=7)
    parts, _ = partition_by_slab(pts, CUTOFF, D)
    e, ok = sharded_lj_energy(m, cutoff=CUTOFF, H=64, use_pallas=True, M=256, L=128)(t(parts))
    assert bool(ok)
    np.testing.assert_allclose(float(e), ref_energy(pts, CUTOFF), rtol=1e-9)

    pts = cloud(n=640, seed=5)
    parts, _ = partition_by_slab(pts, CUTOFF, D)
    _, ok_small = sharded_lj_energy(m, cutoff=CUTOFF, H=2, K=16, chunk=16)(t(parts))
    assert not bool(ok_small)
    for kw in (dict(use_pallas=True, L=128), dict(use_tile=True)):
        assert not bool(sharded_lj_energy(m, cutoff=CUTOFF, H=2, **kw)(t(parts))[1])
    e_big, ok_big = sharded_lj_energy(m, cutoff=CUTOFF, H=64, K=16, chunk=16)(t(parts))
    assert bool(ok_big)
    np.testing.assert_allclose(float(e_big), ref_energy(pts, CUTOFF), rtol=1e-9)

    parts, _ = partition_by_slab(cloud(n=640, seed=9), 2.0, D)
    assert not bool(sharded_lj_energy(m, cutoff=2.0, H=64, K=2, chunk=16)(t(parts))[1])

    # the entry points' per-shard block (`domain.slab_block`): [left ghosts
    # | own] is a prefix of [left ghosts | own | right ghosts], the ghosts
    # are the neighbours' boundary rows, and `_halo_needed` counts the rows
    # a neighbour's key window reaches
    H = 16
    parts, n_local = partition_by_slab(cloud(n=640, seed=5), CUTOFF, D)

    def block(pos):
        b = domain.slab_block(pos, CUTOFF, H, right=True)
        left = domain.slab_block(pos, CUTOFF, H)
        needed = domain._halo_needed(b.bins.sorted_keys, b.info.strides)
        return b.ext, b.keys, left.ext, left.keys, torch.stack(needed), b.info.strides

    ext, keys, l_ext, l_keys, needed, strides = M.shard_map(
        block, m, (M.AXIS,), (M.AXIS,) * 5 + (None,))(t(parts))
    ext, keys = ext.reshape(D, 2 * H + n_local, 3), keys.reshape(D, -1)
    assert torch.equal(ext[:, :H + n_local], l_ext.reshape(D, H + n_local, 3))
    assert torch.equal(keys[:, :H + n_local], l_keys.reshape(D, -1))
    own, own_keys = ext[:, H:H + n_local], keys[:, H:H + n_local].numpy()
    assert torch.equal(ext[1:, :H], own[:-1, -H:]) and torch.equal(ext[:-1, -H:], own[1:, :H])
    w = int(strides.sum())
    want = np.zeros((D, 2), np.int64)
    for k in range(D - 1):
        want[k, 0] = (own_keys[k] >= own_keys[k + 1][0] - w).sum()
        want[k + 1, 1] = (own_keys[k + 1] <= own_keys[k][-1] + w).sum()
    np.testing.assert_array_equal(needed.reshape(D, 2).numpy(), want)
    assert want.max() > 0

    pts = cloud(n=320, seed=12)
    parts, n_local = partition_by_slab(pts, CUTOFF, D)
    e, _ = sharded_lj_energy(m, cutoff=CUTOFF, H=2 * n_local, use_pallas=True, M=256, L=128)(
        t(parts))
    np.testing.assert_allclose(float(e), ref_energy(pts, CUTOFF), rtol=1e-9)

    pts = cloud(n=637, seed=41)
    e_ref = ref_energy(pts, CUTOFF)
    for orient in (pts, pts[:, ::-1].copy()):
        parts, _ = partition_by_slab(orient, CUTOFF, D)
        for kw in (dict(K=16, chunk=16), dict(use_pallas=True, M=256, L=128),
                   dict(use_tile=True, MAXJ=8)):
            e, ok = sharded_lj_energy(m, cutoff=CUTOFF, H=64, **kw)(t(parts))
            assert bool(ok), kw
            np.testing.assert_allclose(float(e), e_ref, rtol=1e-9, err_msg=str(kw))

    # one shard: no halo, the single-device path on the slab-sorted block
    one = cpu_mesh(1)
    parts, _ = partition_by_slab(pts, CUTOFF, 1)
    bins, pos_s = bin_and_sort(t(parts), CUTOFF, auto_order=True)
    strides = bins.info.strides
    single = {
        "lag": float(pair_lag_reduce(pos_s, bins.sorted_keys, strides, CUTOFF**2, L=128)),
        "tile": float(tile_pair_reduce(pos_s, bins.sorted_keys, strides, CUTOFF**2,
                                       MAXJ=8)[0]),
    }
    assert bool(lag_coverage_ok(bins.sorted_keys, strides, 128))
    for name, kw in (("lag", dict(use_pallas=True, L=128)), ("tile", dict(use_tile=True))):
        e, ok = sharded_lj_energy(one, cutoff=CUTOFF, H=64, **kw)(t(parts))
        assert bool(ok) and float(e) == single[name], name
    e, ok = sharded_lj_energy(one, cutoff=CUTOFF, H=64, K=16, chunk=16)(t(parts))
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-12)
    with pytest.raises(ValueError, match="payload"):
        sharded_lj_energy(m, cutoff=CUTOFF, H=64, n_payload=1)
    with pytest.raises(ValueError, match="payload"):
        sharded_lj_energy(m, cutoff=CUTOFF, H=64, use_tile=True, n_payload=2)


# -- host: test_torch_tile_pairs.py::test_plain_takes_payload_min_islot_and_any_term

def tile_backend():
    """test_sharded_tile_backend_matches_xla: the tile path's energy and MD
    step against the default path's and brute force (the wraparound ghosts
    replaced, or shard 0's window bounds break)."""
    m = cpu_mesh()
    pts = cloud(n=320, seed=31)
    parts, _ = partition_by_slab(pts, CUTOFF, D)
    pos = t(parts)
    e_x, ok_x = sharded_lj_energy(m, cutoff=CUTOFF, H=64, K=16, chunk=16)(pos)
    e_t, ok_t = sharded_lj_energy(m, cutoff=CUTOFF, H=64, use_tile=True, MAXJ=8)(pos)
    assert bool(ok_x) and bool(ok_t)
    np.testing.assert_allclose(float(e_t), float(e_x), rtol=1e-6)
    np.testing.assert_allclose(float(e_t), ref_energy(pts, CUTOFF), rtol=1e-10)
    vel = torch.zeros_like(pos)
    px, vx, ex, okx = sharded_md_step(m, cutoff=CUTOFF, H=64, K=16, chunk=16, dt=1e-4)(pos, vel)
    pt, vt, et, okt = sharded_md_step(m, cutoff=CUTOFF, H=64, use_tile=True, MAXJ=8,
                                      dt=1e-4)(pos, vel)
    assert bool(okx) and bool(okt)
    np.testing.assert_allclose(float(et), float(ex), rtol=1e-6)
    np.testing.assert_allclose(pt.numpy(), px.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(vt.numpy(), vx.numpy(), rtol=1e-4, atol=1e-7)


# -- host: test_torch_hist.py::test_hist_coverage_flags ----------------------

def histograms():
    """test_sharded_pair_hist_matches_bruteforce and
    test_sharded_pair_hist_tile_backend: exact shells; and an undersized
    halo flagged on both paths."""
    m = cpu_mesh()
    for seed, edges, kw in ((3, np.linspace(0.0, 1.0, 9), dict(L=256)),
                            (5, np.linspace(0.0, 1.0, 7), dict(use_tile=True, MAXJ=16))):
        pts = cloud(n=700, seed=seed)
        parts, n_local = partition_by_slab(pts, edges[-1], D)
        packed, ok = sharded_pair_hist(m, edges, H=n_local, **kw)(t(parts))
        assert bool(ok) and packed.dtype == torch.int32 and tuple(packed.shape) == (2, len(edges))
        cum = combine_count_vec(packed)
        np.testing.assert_array_equal(cum[1:] - cum[:-1], shells(pts, edges))
        assert not bool(sharded_pair_hist(m, edges, H=2, **kw)(t(parts))[1])


# -- host: test_torch_potentials.py::test_potentials_match_jax ---------------

def potentials():
    """test_sharded_potential_grad_is_minus_forces on the three paths,
    test_sharded_potential_custom_term (the factor derived by autodiff) and
    test_sharded_species_energy on the lag and tile paths
    (`lennard_jones_mixed`'s species column as the payload); and an
    undersized backward pass poisoning the gradient with NaN."""
    from zelll_tpu_torch.ops.potentials import lennard_jones_mixed

    m = cpu_mesh()
    parts, _ = partition_by_slab(cloud(n=640, seed=5), CUTOFF, D)
    e_ref, f_ref = ref_energy(parts, CUTOFF), brute_forces(parts, CUTOFF)
    for kw in (dict(K=16, chunk=16), dict(use_pallas=True, M=256, L=128),
               dict(use_tile=True, MAXJ=8)):
        pot = make_sharded_potential(m, cutoff=CUTOFF, H=64, **kw)
        x = t(parts).clone().requires_grad_(True)
        e, ok = pot(x)
        (g,) = torch.autograd.grad(e, x)
        assert bool(ok) and g.shape == x.shape
        np.testing.assert_allclose(float(e.detach()), e_ref, rtol=1e-9, err_msg=str(kw))
        np.testing.assert_allclose(g.numpy(), -f_ref, rtol=1e-8, atol=1e-10, err_msg=str(kw))

    def soft(dsq):
        return (1.0 - dsq) ** 2

    parts, _ = partition_by_slab(cloud(n=640, seed=6), CUTOFF, D)
    n = len(parts)
    d = parts[:, None, :] - parts[None, :, :]
    dsq = (d * d).sum(-1)
    mask = (dsq < 1.0) & ~np.eye(n, dtype=bool)
    e_ref = 0.5 * np.where(mask, (1.0 - np.where(mask, dsq, 0.0)) ** 2, 0.0).sum()
    g_ref = 2.0 * (np.where(mask, -2.0 * (1.0 - dsq), 0.0)[:, :, None] * d).sum(axis=1)
    pot = make_sharded_potential(m, cutoff=CUTOFF, H=64, K=16, chunk=16, term=soft)
    x = t(parts).clone().requires_grad_(True)
    e, ok = pot(x)
    e.backward()
    assert bool(ok)
    np.testing.assert_allclose(float(e.detach()), e_ref, rtol=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=1e-8, atol=1e-12)
    x = t(parts).clone().requires_grad_(True)
    e, ok = make_sharded_potential(m, cutoff=CUTOFF, H=64, use_tile=True, MAXJ=8, MAXJ_F=1)(x)
    e.backward()
    assert bool(ok) and bool(torch.isnan(x.grad).all())

    pts = cloud(n=504, seed=11)
    species = (np.random.default_rng(3).random(len(pts)) < 0.4).astype(np.float64)
    pot = lennard_jones_mixed((1.0, 0.5), (1.0, 0.8))
    eps = np.where(species > 0.5, 0.5, 1.0)
    sig = np.where(species > 0.5, 0.8, 1.0)
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    np.fill_diagonal(dsq, np.inf)
    mask = np.triu(dsq < CUTOFF * CUTOFF)
    s_ij = 0.5 * (sig[:, None] + sig[None, :])
    x6 = np.where(mask, s_ij * s_ij / np.where(mask, dsq, 1.0), 0.0) ** 3
    e_ref = float(np.where(mask, 4 * np.sqrt(eps[:, None] * eps[None, :]) * x6 * (x6 - 1),
                           0.0).sum())
    # the host partition's key sort with the species column riding it
    # (504 = 8 x 63: no pad rows), as the JAX test builds it
    inf = pts.min(axis=0)
    shape = np.floor((pts.max(0) - inf) / CUTOFF).astype(np.int64) + 1
    perm = np.argsort(shape, kind="stable")
    padded = shape[perm] + 4
    strides = np.empty_like(padded)
    strides[perm] = np.concatenate([[1], np.cumprod(padded[:-1])])
    keys = (np.floor((pts - inf) / CUTOFF).astype(np.int64) * strides).sum(1)
    order = np.argsort(keys, kind="stable")
    parts = np.concatenate([pts[order], species[order, None]], axis=1)
    np.testing.assert_array_equal(parts[:, :3], partition_by_slab(pts, CUTOFF, D)[0])
    for use_tile in (False, True):
        efn = sharded_lj_energy(m, cutoff=CUTOFF, H=64, M=512, L=512, n_payload=1,
                                term=pot.term, use_pallas=not use_tile, use_tile=use_tile,
                                MAXJ=16)
        e, ok = efn(t(parts))
        assert bool(ok)
        np.testing.assert_allclose(float(e), e_ref, rtol=1e-9, err_msg=str(use_tile))


# -- host: test_torch_support.py::test_default_device_without_cuda_raises ----

def mesh_semantics():
    """The mesh's collectives: ``ppermute`` with zeros where no shard
    sends, ``psum`` added in shard order (bitwise a sequential sum),
    ``pmin``/``pmax``, ``all_gather`` stacked and tiled, shards laid
    round-robin over the devices given, outputs joined by their specs, and
    an error in one shard raised to the caller."""
    m = make_mesh(5, devices=["cpu", "cpu"])
    assert m.size == 5 and all(dv.type == "cpu" for dv in m.devices)
    vals = torch.tensor([0.1, 1e16, -1e16, 0.2, 0.3], dtype=torch.float64)

    def body(x):
        k = M.axis_index()
        got = M.ppermute(x, [(i, i + 1) for i in range(M.axis_size() - 1)])
        want = torch.zeros_like(x) if k == 0 else vals[k - 1:k].clone()
        assert torch.equal(got, want)
        assert torch.equal(M.all_gather(x), vals)
        return M.psum(x[0]), M.pmin(x[0]), M.pmax(x[0]), x * 2

    total, lo, hi, doubled = M.shard_map(body, m, (M.AXIS,), (None, None, None, M.AXIS))(vals)
    seq = vals[0]
    for v in vals[1:]:
        seq = seq + v
    assert float(total) == float(seq) and float(lo) == -1e16 and float(hi) == 1e16
    assert torch.equal(doubled, vals * 2)

    def broken(x):
        if M.axis_index() == 3:
            raise ArithmeticError("shard 3")
        return M.psum(x)

    with pytest.raises(ArithmeticError, match="shard 3"):
        M.shard_map(broken, m, (M.AXIS,), None)(vals)
    with pytest.raises(ValueError, match="equal shards"):
        M.shard_map(lambda x: x, m, (M.AXIS,), M.AXIS)(torch.zeros(7))
    with pytest.raises(RuntimeError, match="shard_map"):
        M.psum(vals)
