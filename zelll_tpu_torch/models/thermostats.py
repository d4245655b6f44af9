"""Thermostats for the MD workloads: NVT sampling on the device.

PyTorch counterpart of the constant-volume part of
``zelll_tpu/models/thermostats.py`` (unit mass, k_B = 1 reduced units):

* **Langevin (leapfrog OBA splitting).** One exact Ornstein-Uhlenbeck
  "O" step ``v <- c1 v + c2 xi`` with ``c1 = exp(-gamma dt)``,
  ``c2 = sqrt((1 - c1^2) kT)`` before each force kick: `md_run_langevin`
  runs the NVT trajectory over `lj_md.md_step` (a full rebuild per step,
  forces by kernel K3 on the card). ``gamma = 0`` reduces exactly to the
  NVE `md_step` trajectory.
* **Berendsen weak-coupling rescale** ``v *= sqrt(1 + dt/tau (T0/T - 1))``
  (`berendsen_rescale`): not canonical, standard for equilibration.
* `kinetic_temperature`: the instantaneous ``T = <|v|^2> / dim``.

The noise comes from a ``torch.Generator`` where the JAX package takes a
PRNG key: the same generator state gives the same trajectory, but not the
JAX package's numbers. The barostat (``berendsen_box_mu``, ``md_run_npt``)
needs periodic boxes and is not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import math

import torch

from .lj_md import MDState, md_step

__all__ = [
    "kinetic_temperature",
    "ou_step",
    "berendsen_rescale",
    "md_run_langevin",
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
