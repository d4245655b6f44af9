"""The port's thermostats and barostat (zelll_tpu_torch.models.thermostats)
on the CPU, mirroring tests/test_thermostats.py and tests/test_npt.py. The
port draws its noise from a torch.Generator and the JAX package from a
PRNG key, so the two random streams differ: these tests hold the port to
the same statistics and limits as the JAX tests hold the JAX package, and
to the JAX package's deterministic functions exactly. The barostat has no
noise: `md_run_npt` with beta = 0 is the periodic NVE trajectory of
`md_step_pbc`, exactly (tests/test_torch_pbc.py holds it to the JAX
package's records)."""

import jax.numpy as jnp
import numpy as np
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.models.thermostats import berendsen_box_mu as jax_berendsen_box_mu
from zelll_tpu.models.thermostats import berendsen_rescale as jax_berendsen_rescale
from zelll_tpu.models.thermostats import kinetic_temperature as jax_kinetic_temperature
from zelll_tpu_torch.models.lj_md import MDState, md_run
from zelll_tpu_torch.models.thermostats import (
    berendsen_box_mu,
    berendsen_rescale,
    kinetic_temperature,
    md_run_langevin,
    md_run_npt,
    ou_step,
)
from zelll_tpu_torch.ops.pbc import md_step_pbc, suggest_pbc_capacity


def lattice(k=6, spacing=1.2, jitter=0.02, seed=0):
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*([np.arange(k)] * 3), indexing="ij"), -1).reshape(-1, 3)
    pts = g * spacing + 0.5 * spacing
    pts += rng.uniform(-jitter, jitter, pts.shape) * spacing
    return pts


def _state(pts, vel):
    return MDState.create(pts.astype(np.float32), vel.astype(np.float32), device="cpu")


def test_zero_gamma_reduces_to_nve():
    pts = lattice()
    vel = np.random.default_rng(1).normal(0, 0.05, pts.shape)
    cutoff, dt, steps = 1.5, 1e-3, 5
    gen = torch.Generator().manual_seed(0)
    st_nvt, ok1 = md_run_langevin(_state(pts, vel), cutoff, dt, kT=0.1, gamma=0.0,
                                  generator=gen, steps=steps)
    st_nve, ok2, _ = md_run(_state(pts, vel), cutoff, dt, steps=steps)
    assert bool(ok1) and bool(ok2)
    assert torch.equal(st_nvt.positions, st_nve.positions)
    assert torch.equal(st_nvt.velocities, st_nve.velocities)
    # the barostat off (beta = 0): `md_run_npt` is the periodic NVE
    # trajectory of `md_step_pbc` at the same capacities, bitwise, on both
    # paths, and the box stays
    box, o = np.full(3, 7.2), np.zeros(3)
    p0, v0 = torch.as_tensor(pts), torch.as_tensor(vel)
    B, G = suggest_pbc_capacity(len(pts), box / 1.5 ** (1 / 3), cutoff)
    for path, kw in (("lag", dict(L=512, B=B, G=G)), ("tile", dict(MAXJ=16, B=B, G=G))):
        p1, v1, b1, ok = md_run_npt(p0, v0, o, box, cutoff, dt, steps=steps, P_target=1.0,
                                    tau_p=1.0, beta=0.0, path=path, **kw)
        assert bool(ok) and b1.tolist() == box.tolist()
        p2, v2 = p0, v0
        for _ in range(steps):
            p2, v2, ok2 = md_step_pbc(p2, v2, o, box, cutoff, dt, path=path, **kw)
            assert bool(ok2)
        assert torch.equal(p1, p2) and torch.equal(v1, v2), path


def test_ou_step_statistics():
    """The exact OU step equilibrates a large ensemble to kT."""
    gen = torch.Generator().manual_seed(42)
    v = torch.zeros((20000, 3))
    kT, gamma, dt = 0.35, 2.0, 0.5
    for _ in range(40):
        v = ou_step(v, gen, kT, gamma, dt)
    assert v.dtype == torch.float32
    t = float(kinetic_temperature(v))
    assert abs(t - kT) < 0.02 * kT
    # the velocity distribution is normal(0, sqrt(kT)) per component
    assert abs(float(v.mean())) < 0.01
    assert abs(float(v.std()) - np.sqrt(kT)) < 0.01 * np.sqrt(kT)


def test_langevin_thermalizes_lattice():
    """A cold LJ lattice heats to the target temperature under Langevin
    (loose band: small system, short run), and the same generator state
    gives the same trajectory."""
    pts = lattice(k=5, spacing=1.1)
    kT = 0.05
    runs = []
    for _ in range(2):
        st, ok, temps = md_run_langevin(
            _state(pts, np.zeros_like(pts)), 1.4, 2e-3, kT=kT, gamma=20.0,
            generator=torch.Generator().manual_seed(3), steps=120,
            record_temperature=True)
        runs.append((st, temps))
        assert bool(ok) and temps.shape == (120,)
        tail = float(temps[-30:].mean())
        # virial sharing with the potential keeps T near (not exactly at) kT
        assert 0.4 * kT < tail < 2.5 * kT
        assert torch.isfinite(st.positions).all()
    assert torch.equal(runs[0][0].positions, runs[1][0].positions)
    assert torch.equal(runs[0][1], runs[1][1])
    # an int seed makes a generator on the state's device
    st, ok = md_run_langevin(_state(pts, np.zeros_like(pts)), 1.4, 2e-3, kT=kT,
                             gamma=20.0, generator=3, steps=2)
    assert bool(ok) and st.positions.shape == pts.shape


def test_berendsen_rescale_direction():
    rng = np.random.default_rng(5)
    v = rng.normal(0, 1.0, (500, 3)).astype(np.float32)
    t0 = float(kinetic_temperature(torch.as_tensor(v)))
    np.testing.assert_allclose(t0, float(jax_kinetic_temperature(jnp.asarray(v))),
                               rtol=1e-6)
    v2 = berendsen_rescale(torch.as_tensor(v), kT_target=0.5 * t0, tau=10.0, dt=1.0)
    assert float(kinetic_temperature(v2)) < t0  # cooling toward the target
    np.testing.assert_allclose(
        v2.numpy(), np.asarray(jax_berendsen_rescale(jnp.asarray(v), 0.5 * t0, 10.0, 1.0)),
        rtol=1e-6)
    v3 = berendsen_rescale(torch.as_tensor(v), kT_target=2.0 * t0, tau=10.0, dt=1.0)
    assert float(kinetic_temperature(v3)) > t0
    # the box scale: expand above the target pressure, shrink below it, the
    # clip, beta = 0 exactly 1 (tests/test_npt.py), and the JAX package's
    # value to the last bit
    for args, kw in (((2.0, 1.0, 1.0, 0.01), {}), ((0.5, 1.0, 1.0, 0.01), {}),
                     ((1e9, 1.0, 1.0, 1.0), {}), ((-1e9, 1.0, 1.0, 1.0), {}),
                     ((5.0, 1.0, 1.0, 0.01), dict(beta=0.0)),
                     ((0.3, 0.1, 0.5, 0.02), dict(beta=2.0, dim=2, clip=0.1))):
        mu = float(berendsen_box_mu(*args, **kw))
        assert mu == float(jax_berendsen_box_mu(*args, **kw)), (args, kw)
    assert float(berendsen_box_mu(2.0, 1.0, 1.0, 0.01)) > 1.0
    assert float(berendsen_box_mu(0.5, 1.0, 1.0, 0.01)) < 1.0
    assert float(berendsen_box_mu(1e9, 1.0, 1.0, 1.0)) <= 1.02
    assert float(berendsen_box_mu(-1e9, 1.0, 1.0, 1.0)) >= 0.98
    assert float(berendsen_box_mu(5.0, 1.0, 1.0, 0.01, beta=0.0)) == 1.0
    p = torch.tensor(2.0, dtype=torch.float32)
    assert berendsen_box_mu(p, 1.0, 1.0, 0.01).dtype == torch.float32
