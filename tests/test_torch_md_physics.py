"""Physical sanity of the port's MD loops (the side of
tests/test_md_physics.py), on CPU tensors through the plain versions of
the kernels, with no JAX: Newton's third law, momentum and energy
conservation, and velocity Verlet against semi-implicit Euler. The
fixtures and limits are those of the JAX package's tests; the tile loops
get the same checks."""

import numpy as np
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu_torch.core import build
from zelll_tpu_torch.models.lj_md import (
    MDState,
    md_run,
    md_run_skin_tile,
    md_run_vv,
    md_step,
    md_step_cubic_tile,
)
from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
from zelll_tpu_torch.ops.lag_pairs import pair_lag_forces
from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces


def lattice(m, spacing, jitter, seed, sigma):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(float(m))] * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3) * spacing
    pts = g + rng.uniform(-jitter, jitter, g.shape)
    return MDState.create(pts, rng.normal(0, sigma, pts.shape), device="cpu")


def total_energy(st, cutoff):
    pe, ok = fused_lj_rebuild_energy(st.positions, cutoff, M=256, L=256)
    assert bool(ok)
    return float(pe) + 0.5 * float((st.velocities**2).sum())


def test_forces_sum_to_zero():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, size=(400, 3)) * np.array([3.0, 3.0, 20.0]) + 0.05
    g = build(pts, 1.0, device="cpu")
    args = (g.sorted_pos, g.bins.sorted_keys, g.info.strides, 1.0)
    f_lag = pair_lag_forces(*args, L=256)
    f_tile, ok = tile_pair_forces(*args, CB=1, MAXJ=8)
    assert bool(ok)
    for f in (f_lag, f_tile):
        scale = float(f.abs().max())
        np.testing.assert_allclose(f.sum(0).numpy(), 0.0, atol=1e-9 * max(scale, 1.0))


def test_md_momentum_conserved_over_steps():
    st = lattice(6, 1.1, 0.1, 1, 0.05)
    p0 = st.velocities.sum(0)
    cube = st
    for _ in range(10):
        st, ok = md_step(st, 1.2, 1e-5, M=256, L=256)
        assert bool(ok)
        cube, ok = md_step_cubic_tile(cube, 1.2, 1e-5, CB=1, MAXJ=8)
        assert bool(ok)
    for s in (st, cube):
        np.testing.assert_allclose(s.velocities.sum(0).numpy(), p0.numpy(), rtol=0,
                                   atol=1e-10)


def test_md_energy_conserved_soft_start():
    st = lattice(5, 1.12, 0.05, 2, 0.05)
    e0 = total_energy(st, 1.2)
    cube = st
    for _ in range(20):
        st, _ = md_step(st, 1.2, 2e-4, M=256, L=256)
        cube, _ = md_step_cubic_tile(cube, 1.2, 2e-4, CB=1, MAXJ=8)
    for s in (st, cube):
        e1 = total_energy(s, 1.2)
        assert abs(e1 - e0) / abs(e0) < 5e-3, (e0, e1)


def test_vv_energy_drift_beats_euler():
    """A compact 27-atom cluster whose pairs all stay inside the cutoff
    (tests/test_md_physics.py): velocity Verlet's energy error is O(dt^2),
    the semi-implicit Euler loop's O(dt)."""
    st0 = lattice(3, 1.12, 0.03, 3, 0.1)
    cutoff, dt, steps = 5.0, 1e-3, 100
    e0 = total_energy(st0, cutoff)
    st_e, ok_e, _ = md_run(st0, cutoff, dt, steps=steps, M=256, L=256)
    st_v, ok_v, _ = md_run_vv(st0, cutoff, dt, steps=steps, M=256, L=256)
    assert bool(ok_e) and bool(ok_v)
    drift_euler = abs(total_energy(st_e, cutoff) - e0)
    drift_vv = abs(total_energy(st_v, cutoff) - e0)
    assert drift_vv < drift_euler / 10, (drift_vv, drift_euler)
    assert drift_vv < 2e-4


def test_vv_and_skin_tile_momentum_conserved():
    st0 = lattice(5, 1.1, 0.05, 4, 0.05)
    p0 = st0.velocities.sum(0).numpy()
    st, ok, _ = md_run_vv(st0, 1.2, 1e-4, steps=20, M=256, L=256)
    assert bool(ok)
    np.testing.assert_allclose(st.velocities.sum(0).numpy(), p0, rtol=0, atol=1e-10)
    st, ok, _, rebuilds = md_run_skin_tile(st0, 1.2, 1e-4, steps=20, skin=0.3,
                                           CB=1, MAXJ=8)
    assert bool(ok) and rebuilds == 0
    np.testing.assert_allclose(st.velocities.sum(0).numpy(), p0, rtol=0, atol=1e-10)
