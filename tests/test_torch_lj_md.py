"""The port's MD entry points (zelll_tpu_torch.models.lj_md, plain versions
of the kernels on CPU tensors) against the JAX package's (Pallas, interpret
mode): one state, made with numpy and carried across with
`convert.md_state_from_numpy`, through both packages.

Both return their state in sorted order with an unspecified order among
equal keys, so states are compared as sets of rows (lexsorted), never row
by row. Tolerances: flags and rebuild counts exact; f64 states and
energies to 1e-9 (the force sums differ only in order); split-f32 states
to 1e-9 of their largest value (f64-grade positions from f32 parts).
Seven JAX configurations are called here (ROADMAP Tier-1 budget); `md_step`
is also held to a hand integration with brute-force forces, as
tests/test_forces_md.py holds JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelll_tpu.models import lj_md as jax_md
from zelll_tpu_torch.convert import md_state_from_numpy
from zelll_tpu_torch.models import lj_md
from zelll_tpu_torch.models.lj_md import MDState, MDStateSplit


def brute_forces(pts, cutoff):
    n = len(pts)
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    mask = (dsq < cutoff**2) & ~np.eye(n, dtype=bool)
    inv = np.where(mask, 1.0 / np.where(mask, dsq, 1.0), 0.0)
    t = inv**3
    g = np.where(mask, 24 * t * (2 * t - 1) * inv, 0.0)
    return (d * g[..., None]).sum(axis=1)


def lattice(shape, spacing, jitter, seed, sigma):
    """A jittered lattice (no overlaps, so forces stay moderate and the
    trajectories of both packages cannot part) and velocities from
    normal(0, sigma)."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*(np.arange(s) for s in shape), indexing="ij"),
                 -1).reshape(-1, len(shape))
    pts = g * spacing + rng.uniform(-jitter, jitter, g.shape)
    return pts, rng.normal(0, sigma, pts.shape)


def rows(positions, velocities):
    """The state as a lexsorted set of (position, velocity) rows."""
    a = np.concatenate([np.asarray(positions, np.float64),
                        np.asarray(velocities, np.float64)], 1)
    return a[np.lexsort(a.T[::-1])]


def port_state(pts, vel, split=False):
    return md_state_from_numpy(pts, vel, split=split, device="cpu")


def jax_state(pts, vel):
    return jax_md.MDState(positions=jnp.asarray(pts), velocities=jnp.asarray(vel))


def assert_same_rows(port, ref, rel=1e-9):
    a, b = rows(*port), rows(*ref)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max())


def test_md_step_matches_manual_integration_and_jax():
    """The inputs and limits of tests/test_forces_md.py's JAX test (rows
    are mapped back by value: x2 - dt v2 is the input position), and JAX's
    `md_step` on the same state, compared as a set."""
    rng = np.random.default_rng(1)
    n, cutoff, dt = 300, 1.0, 1e-5
    pts = rng.uniform(0, 1, size=(n, 3)) * np.array([3.0, 3.0, 12.0])
    vel = rng.normal(0, 0.1, (n, 3))
    st2, ok = lj_md.md_step(port_state(pts, vel), cutoff, dt, M=512, L=256)
    js, jok = jax_md.md_step(jax_state(pts, vel), cutoff, dt, M=512, L=256,
                             interpret=True)
    assert bool(ok) and bool(jok)
    assert_same_rows((st2.positions, st2.velocities), (js.positions, js.velocities))
    p2, v2 = st2.positions.numpy(), st2.velocities.numpy()
    orig = p2 - dt * v2
    match = (((orig[:, None, :] - pts[None, :, :]) ** 2).sum(-1)).argmin(axis=1)
    assert len(set(match.tolist())) == n
    v_ref = vel[match] + dt * brute_forces(pts, cutoff)[match]
    p_ref = pts[match] + dt * v_ref
    np.testing.assert_allclose(v2, v_ref, rtol=1e-9,
                               atol=1e-12 * max(1.0, np.abs(v_ref).max()))
    np.testing.assert_allclose(p2, p_ref, rtol=1e-9)


def test_md_step_split_matches_jax():
    """f64-grade MD far from the origin: the split state of both packages
    agrees as a set of f64 positions and f32 velocities."""
    pts, vel = lattice((3, 3, 30), 1.1, 0.05, 2, 0.1)
    pts = pts + 1.0e3
    js, jok = jax_md.md_step_split(jax_md.MDStateSplit.from_f64(jnp.asarray(pts),
                                                               jnp.asarray(vel)),
                                   1.6, 1e-3, M=512, L=256, interpret=True)
    ps, pok = lj_md.md_step_split(port_state(pts, vel, split=True), 1.6, 1e-3,
                                  M=512, L=256)
    assert bool(jok) and bool(pok)
    assert ps.pos_hi.dtype == torch.float32
    assert_same_rows((ps.positions_f64(), ps.velocities),
                     (js.positions_f64(), js.velocities))


def test_md_run_matches_jax():
    pts, vel = lattice((3, 3, 20), 1.1, 0.05, 3, 0.2)
    js, jok, je = jax_md.md_run(jax_state(pts, vel), 1.6, 1e-3, steps=6, M=512,
                                L=512, interpret=True)
    ps, pok, pe = lj_md.md_run(port_state(pts, vel), 1.6, 1e-3, steps=6, M=512,
                               L=512)
    assert bool(jok) and bool(pok)
    assert float(je) < 0
    np.testing.assert_allclose(float(pe), float(je), rtol=1e-9)
    assert_same_rows((ps.positions, ps.velocities), (js.positions, js.velocities))


def test_md_run_vv_matches_jax():
    pts, vel = lattice((3, 3, 20), 1.1, 0.05, 4, 0.2)
    js, jok, je = jax_md.md_run_vv(jax_state(pts, vel), 1.6, 1e-3, steps=6, M=512,
                                   L=512, interpret=True)
    ps, pok, pe = lj_md.md_run_vv(port_state(pts, vel), 1.6, 1e-3, steps=6, M=512,
                                  L=512)
    assert bool(jok) and bool(pok)
    np.testing.assert_allclose(float(pe), float(je), rtol=1e-9)
    assert_same_rows((ps.positions, ps.velocities), (js.positions, js.velocities))


def test_md_run_skin_matches_jax():
    """A small skin, so the drift bound trips and the loop rebuilds: the
    rebuild counts, flags, energies and states agree."""
    pts, vel = lattice((3, 3, 24), 1.1, 0.05, 5, 0.5)
    js, jok, je, jn = jax_md.md_run_skin(jax_state(pts, vel), 1.6, 2e-3, steps=10,
                                         skin=0.02, M=512, L=512, interpret=True)
    ps, pok, pe, pn = lj_md.md_run_skin(port_state(pts, vel), 1.6, 2e-3, steps=10,
                                        skin=0.02, M=512, L=512)
    assert bool(jok) and bool(pok)
    assert pn == int(jn) >= 1
    assert float(je) < 0
    np.testing.assert_allclose(float(pe), float(je), rtol=1e-9)
    assert_same_rows((ps.positions, ps.velocities), (js.positions, js.velocities))


def test_md_step_cubic_tile_matches_jax():
    pts, vel = lattice((7, 7, 7), 1.1, 0.05, 6, 0.1)
    js, jok = jax_md.md_step_cubic_tile(jax_state(pts, vel), 1.6, 1e-3, CB=2,
                                        MAXJ=6, interpret=True)
    ps, pok = lj_md.md_step_cubic_tile(port_state(pts, vel), 1.6, 1e-3, CB=2, MAXJ=6)
    assert bool(jok) and bool(pok)
    assert ps.positions.shape == pts.shape
    assert_same_rows((ps.positions, ps.velocities), (js.positions, js.velocities))


def test_md_run_skin_tile_matches_jax():
    """The cubic skin loop with a per-band MAXJ and rebuilds firing."""
    pts, vel = lattice((6, 6, 6), 1.1, 0.05, 7, 0.5)
    maxj = (3,) * 9
    js, jok, je, jn = jax_md.md_run_skin_tile(jax_state(pts, vel), 1.6, 2e-3,
                                              steps=8, skin=0.02, CB=2, MAXJ=maxj,
                                              interpret=True)
    ps, pok, pe, pn = lj_md.md_run_skin_tile(port_state(pts, vel), 1.6, 2e-3,
                                             steps=8, skin=0.02, CB=2, MAXJ=maxj)
    assert bool(jok) and bool(pok)
    assert pn == int(jn) >= 1
    assert float(je) < 0
    np.testing.assert_allclose(float(pe), float(je), rtol=1e-9)
    assert_same_rows((ps.positions, ps.velocities), (js.positions, js.velocities))


def test_md_step_cubic_tile_two_dimensions():
    """The tile step is N-dimensional (the velocity columns ride the sort
    and are never binned): a 2-D step against brute force."""
    pts, vel = lattice((12, 12), 1.1, 0.05, 8, 0.1)
    dt = 1e-3
    st, ok = lj_md.md_step_cubic_tile(port_state(pts, vel), 1.6, dt, CB=1, MAXJ=4)
    assert bool(ok)
    v_ref = vel + dt * brute_forces(pts, 1.6)
    assert_same_rows((st.positions, st.velocities), (pts + dt * v_ref, v_ref))


def test_md_refuses_what_is_not_ported():
    pts, vel = lattice((5, 5), 1.1, 0.05, 9, 0.1)
    st = port_state(pts, vel)
    with pytest.raises(NotImplementedError, match="slice 4"):
        lj_md.md_step(st, 1.6, 1e-3)
    with pytest.raises(NotImplementedError, match="slice 4"):
        lj_md.md_run(st, 1.6, 1e-3, steps=1)
    with pytest.raises(ValueError, match="3D-only"):
        lj_md.md_run_vv(st, 1.6, 1e-3, steps=1)


def test_states_and_their_devices():
    pts, vel = lattice((3, 3, 3), 1.1, 0.05, 10, 0.1)
    st = MDState.create(pts, device="cpu")
    assert st.positions.dtype == torch.float64 and not st.velocities.any()
    sp = MDStateSplit.from_f64(torch.as_tensor(pts), vel)
    assert sp.pos_hi.device.type == "cpu" and sp.velocities.dtype == torch.float32
    np.testing.assert_array_equal(sp.positions_f64().numpy(),
                                  (pts.astype(np.float32) + sp.pos_lo.numpy()
                                   .astype(np.float64)))
    hi, lo = sp.pos_hi.numpy(), sp.pos_lo.numpy()
    again = md_state_from_numpy((hi, lo), vel, split=True, device="cpu")
    assert torch.equal(again.pos_lo, sp.pos_lo)
    jsp = jax_md.MDStateSplit.from_f64(jnp.asarray(pts))
    np.testing.assert_array_equal(np.asarray(jsp.pos_lo), sp.pos_lo.numpy())
