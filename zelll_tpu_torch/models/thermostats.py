"""Thermostats and a barostat for the MD workloads: NVT and NPT on the device.

PyTorch counterpart of ``zelll_tpu/models/thermostats.py`` (unit mass,
k_B = 1 reduced units):

* **Langevin (leapfrog OBA splitting).** One exact Ornstein-Uhlenbeck
  "O" step ``v <- c1 v + c2 xi`` with ``c1 = exp(-gamma dt)``,
  ``c2 = sqrt((1 - c1^2) kT)`` before each force kick: `md_run_langevin`
  runs the NVT trajectory over `lj_md.md_step` (a full rebuild per step,
  forces by kernel K3 on the card). ``gamma = 0`` reduces exactly to the
  NVE `md_step` trajectory.
* **Berendsen weak-coupling rescale** ``v *= sqrt(1 + dt/tau (T0/T - 1))``
  (`berendsen_rescale`): not canonical, standard for equilibration.
* `kinetic_temperature`: the instantaneous ``T = <|v|^2> / dim``.
* **Berendsen barostat** (`berendsen_box_mu`, `md_run_npt`): an isotropic
  box rescale per step toward a target pressure, driven by the virial
  pressure ``P = (2 KE + W) / (dim V)`` of a periodic box (``ops.pbc``
  forces, ``ops.virial.pbc_virial``). There is no noise, so the port
  follows the JAX package's trajectory itself.

The Langevin noise comes from a ``torch.Generator`` where the JAX package
takes a PRNG key: the same generator state gives the same trajectory, but
not the JAX package's numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.pbc import _prepare, pbc_lj_forces, suggest_pbc_capacity, wrap_positions
from ..ops.virial import kinetic_energy, pbc_virial, pressure
from .lj_md import MDState, md_step

__all__ = [
    "kinetic_temperature",
    "ou_step",
    "berendsen_rescale",
    "berendsen_box_mu",
    "md_run_langevin",
    "md_run_npt",
]


def kinetic_temperature(velocities: torch.Tensor) -> torch.Tensor:
    """Instantaneous kinetic temperature (unit mass, k_B = 1):
    ``T = sum |v|^2 / (dim n)``."""
    n, dim = velocities.shape
    return (velocities * velocities).sum() / (dim * n)


def _normal(like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal noise shaped like ``like``, drawn on the generator's
    device and moved to ``like``'s."""
    xi = torch.randn(like.shape, generator=generator, dtype=like.dtype,
                     device=generator.device)
    return xi.to(like.device)


def ou_step(velocities: torch.Tensor, generator: torch.Generator, kT, gamma, dt):
    """Exact Ornstein-Uhlenbeck velocity update (the Langevin "O" step):
    ``v <- exp(-gamma dt) v + sqrt((1 - exp(-2 gamma dt)) kT) xi``, xi drawn
    from ``generator``."""
    c1 = math.exp(-float(gamma) * float(dt))
    c2 = math.sqrt(max(1.0 - c1 * c1, 0.0) * float(kT))
    return c1 * velocities + c2 * _normal(velocities, generator)


def berendsen_rescale(velocities: torch.Tensor, kT_target, tau, dt):
    """Berendsen weak-coupling rescale toward ``kT_target`` with time
    constant ``tau`` (equilibration only, not a canonical ensemble)."""
    t_now = kinetic_temperature(velocities)
    lam = torch.sqrt(torch.clamp(1.0 + dt / tau * (kT_target / (t_now + 1e-30) - 1.0),
                                 min=0.0))
    return velocities * lam


def md_run_langevin(state: MDState, cutoff, dt, kT, gamma, generator, *,
                    steps: int, M: int = 4096, L: int = 256,
                    record_temperature: bool = False):
    """NVT Langevin trajectory on the device: per step, one OU velocity
    update, then one full-rebuild LJ step (`md_step`). Returns (state,
    all_covered[, temperatures (steps,)]), all on the state's device; the
    loop reads nothing back to the host.

    ``generator``: a ``torch.Generator`` (on any device), or an int seed
    for a new generator on the state's device.
    """
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=state.positions.device).manual_seed(int(generator))
    ok = torch.ones((), dtype=torch.bool, device=state.positions.device)
    temps = []
    for _ in range(steps):
        vel = ou_step(state.velocities, generator, kT, gamma, dt)
        state, step_ok = md_step(MDState(positions=state.positions, velocities=vel),
                                 cutoff, dt, M=M, L=L)
        ok = ok & step_ok
        if record_temperature:
            temps.append(kinetic_temperature(state.velocities))
    if record_temperature:
        dtype = state.velocities.dtype
        t = torch.stack(temps) if temps else torch.zeros((0,), dtype=dtype,
                                                          device=ok.device)
        return state, ok, t
    return state, ok


def berendsen_box_mu(P_inst, P_target, tau_p, dt, *, beta: float = 1.0,
                     dim: int = 3, clip: float = 0.02) -> torch.Tensor:
    """Berendsen weak-coupling isotropic box scale factor per step:

        mu = (1 - beta dt / tau_p (P_target - P_inst))^(1 / dim)

    ``beta`` is the (reduced) isothermal compressibility; only beta / tau_p
    matters. Clipped to [1 - clip, 1 + clip], so one noisy virial spike
    cannot collapse the box. ``beta = 0`` disables the barostat exactly
    (mu = 1). A host ``P_inst`` is taken in f64."""
    p_inst = P_inst if isinstance(P_inst, torch.Tensor) else \
        torch.tensor(float(P_inst), dtype=torch.float64)
    mu_d = 1.0 - beta * dt / tau_p * (P_target - p_inst)
    mu = torch.clamp(mu_d, 0.5, 2.0) ** (1.0 / dim)
    return torch.clamp(mu, 1.0 - clip, 1.0 + clip)


def md_run_npt(positions, velocities, origin, box, cutoff, dt, *, steps: int,
               P_target, tau_p, beta: float = 1.0, kT_target=None, tau_T=None,
               B: int | None = None, G: int | None = None,
               capacity_headroom: float = 1.5, path: str = "lag", M: int = 1024,
               L: int = 256, K: int = 32, chunk: int = 64, MAXJ=8, CB: int = 8,
               record: bool = False, device=None):
    """NPT trajectory under cubic or orthorhombic PBC: per step one LJ force
    kick and drift (`ops.pbc.pbc_lj_forces`), an optional Berendsen
    velocity rescale toward ``kT_target``, then a Berendsen isotropic box
    rescale toward ``P_target`` driven by the instantaneous virial pressure
    P = (2 KE + W) / (dim V), W the fused scalar pair virial
    (`ops.virial.pbc_virial`, the same path as the forces: K3 and K1, or K7
    and K6 with the keep mask on the card). Positions scale about
    ``origin`` with the box and are wrapped.

    The ghost capacities B and G are sized on the host from the initial box
    shrunk by ``capacity_headroom`` in particles per cell (compression
    grows the boundary population); the flag still guards every step and
    goes False when the box falls to 2 cutoff or below. The loop reads
    nothing back to the host. Returns (positions, velocities, box, ok[,
    {"pressure", "volume", "temperature"} (steps,) tensors with
    ``record=True``]), on the positions' device; ``box`` in their dtype.
    """
    positions, _ = _prepare(positions, None, device)
    dev, dtype = positions.device, positions.dtype
    n, dim = positions.shape
    if B is None or G is None:
        host_box = np.asarray(torch.as_tensor(box).cpu(), np.float64).reshape(dim)
        Bd, Gd = suggest_pbc_capacity(n, host_box / capacity_headroom ** (1 / dim), cutoff)
        B = Bd if B is None else B
        G = Gd if G is None else G
    kw = dict(path=path, M=M, L=L, K=K, chunk=chunk, MAXJ=MAXJ, CB=CB, B=B, G=G)
    pos = positions
    vel = torch.as_tensor(velocities, device=dev)
    origin = torch.as_tensor(origin, dtype=dtype, device=dev).reshape(dim)
    bx = torch.as_tensor(box, dtype=dtype, device=dev).reshape(dim)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    rec = []
    for _ in range(steps):
        f, ok1 = pbc_lj_forces(pos, origin, bx, cutoff, **kw)
        vel = vel + dt * f
        if kT_target is not None:
            vel = berendsen_rescale(vel, kT_target, tau_T, dt)
        pos = pos + dt * vel
        w, ok2 = pbc_virial(pos, origin, bx, cutoff, **kw)
        p_inst = pressure(w, kinetic_energy(vel), torch.prod(bx), dim)
        mu = berendsen_box_mu(p_inst, P_target, tau_p, dt, beta=beta, dim=dim)
        bx = mu * bx
        pos = wrap_positions(origin + (pos - origin) * mu, origin, bx)
        # the minimum-image regime (box > 2 cutoff) must survive shrinking
        ok = ok & ok1 & ok2 & (bx > 2.0 * cutoff).all()
        if record:
            rec.append(torch.stack([p_inst.to(dtype), torch.prod(bx),
                                    kinetic_temperature(vel)]))
    if not record:
        return pos, vel, bx, ok
    r = torch.stack(rec) if rec else torch.zeros((0, 3), dtype=dtype, device=dev)
    return pos, vel, bx, ok, {"pressure": r[:, 0], "volume": r[:, 1],
                              "temperature": r[:, 2]}
