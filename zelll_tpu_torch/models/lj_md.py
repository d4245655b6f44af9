"""Lennard-Jones molecular dynamics: the flagship end-to-end workload.

PyTorch counterpart of ``zelll_tpu/models/lj_md.py``. Every step re-bins
and re-sorts the particles (a full rebuild) and evaluates the LJ forces
with a hand-written kernel: K3 (``ops.lag_pairs.pair_lag_forces``) for
thin boxes, K7 (``ops.tile_pairs``) for cubic and wide ones. State stays
in sorted order between steps and the velocities ride the sort as payload
columns, so forces land in the matching order and no pair list exists.
The Verlet-skin loops (`md_run_skin`, `md_run_skin_tile`) build the grid
with cell edge ``cutoff + skin`` and reuse it while no particle has moved
more than ``skin / 2`` since the last build.

State comes back in cell-key order with an unspecified order among equal
keys (the sorts are unstable); compare states as sets of rows.

Where the JAX package runs ``lax.scan`` and ``lax.cond`` on the device,
these are Python loops. Each step enqueues its kernels without reading
anything back, except the skin loops' drift test: one device-to-host read
per step decides whether to rebuild.
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..core.binning import bin_and_sort
from ..core.geometry import GridInfo, aabb_from_positions
from ..ops.lag_pairs import (
    lag_coverage_ok,
    lj_term,
    pair_lag_forces,
    pair_lag_reduce,
    split_f64,
)
from ..ops.lj import lj_force_factor, lj_force_factor_fast
from ..ops.tile_pairs import _forces, tile_forces_core, tile_inputs, tile_pair_reduce

__all__ = [
    "MDState",
    "MDStateSplit",
    "md_step",
    "md_step_split",
    "md_run",
    "md_run_vv",
    "md_run_skin",
    "md_step_cubic_tile",
    "md_run_skin_tile",
]


@dataclasses.dataclass(frozen=True)
class MDState:
    positions: torch.Tensor  # (n, dim)
    velocities: torch.Tensor  # (n, dim)

    @classmethod
    def create(cls, positions, velocities=None, *, dtype=None, device=None):
        """A state on ``device`` (CUDA unless given, or the device of a
        positions tensor); velocities default to zero."""
        device = resolve_device(device, positions)
        pos = torch.as_tensor(positions, dtype=dtype, device=device)
        vel = (torch.zeros_like(pos) if velocities is None else
               torch.as_tensor(velocities, dtype=pos.dtype, device=device))
        return cls(positions=pos, velocities=vel)


@dataclasses.dataclass(frozen=True)
class MDStateSplit:
    """MD state with split-precision coordinates: positions are carried as
    (hi, lo) f32 parts with hi + lo == the f64 position (`split_f64`), so
    both the forces and the position update are f64-grade at f32 speed."""

    pos_hi: torch.Tensor  # (n, 3) f32
    pos_lo: torch.Tensor  # (n, 3) f32
    velocities: torch.Tensor  # (n, 3) f32

    @classmethod
    def from_f64(cls, positions, velocities=None, *, device=None):
        """Split f64 positions on ``device`` (CUDA unless given, or the
        device of a positions tensor); velocities default to zero."""
        device = resolve_device(device, positions)
        hi, lo = split_f64(torch.as_tensor(positions, dtype=torch.float64,
                                           device=device))
        vel = (torch.zeros_like(hi) if velocities is None else
               torch.as_tensor(velocities, dtype=torch.float32, device=device))
        return cls(pos_hi=hi, pos_lo=lo, velocities=vel)

    def positions_f64(self) -> torch.Tensor:
        return self.pos_hi.to(torch.float64) + self.pos_lo.to(torch.float64)


def _csq(cutoff, dtype) -> torch.Tensor:
    """cutoff^2 in ``dtype``, as a host scalar the kernels read without a
    device round trip."""
    return torch.as_tensor(cutoff, dtype=dtype) ** 2


def _all_true(like: torch.Tensor) -> torch.Tensor:
    return torch.ones((), dtype=torch.bool, device=like.device)


def _sort_rows(rows: torch.Tensor, edge, auto_order: bool = False):
    """Keys, one sort and one gather of (n, 3 + payload) rows: returns
    (sorted rows, sorted keys, strides)."""
    bins, cols = bin_and_sort(rows, edge, max_cells=1, need_perm=False,
                              auto_order=auto_order)
    return cols, bins.sorted_keys, bins.info.strides


def _lag_energy(positions, cutoff, csq, *, M, L):
    """Final LJ energy of a 3-D state through K1, and its coverage flag."""
    spos, keys, strides = _sort_rows(positions, cutoff)
    energy = pair_lag_reduce(spos, keys, strides, csq, M=M, L=L, term=lj_term)
    return energy, lag_coverage_ok(keys, strides, L)


def _drifted(delta: torch.Tensor, half_skin_sq, axis: int) -> bool:
    """Whether any particle moved more than skin / 2 since the last build:
    the skin loops' one read back to the host per step."""
    return bool((delta * delta).sum(axis).max() > half_skin_sq)


def md_step(state: MDState, cutoff, dt, *, M: int = 4096, L: int = 256,
            K: int = 32):
    """One MD step with a full grid rebuild, semi-implicit Euler (the
    one-force-evaluation form): v += dt f(x); x += dt v.

    Returns (new_state, coverage_ok), the state in sorted order. 3-D runs
    the lag forces kernel (K3); other dimensions take the JAX package's
    bucketed ``core.pairs`` path (with ``K`` its cell capacity), which the
    port does not have yet.
    """
    pos, vel = state.positions, state.velocities
    if pos.shape[1] != 3:
        raise NotImplementedError(
            "md_step with dim != 3 takes the bucketed core.pairs.pair_forces "
            "path, which the port does not have yet (ROADMAP queue 1, "
            "slice 4)"
        )
    del K
    cols, keys, strides = _sort_rows(torch.cat([pos, vel], 1), cutoff)
    spos, svel = cols[:, :3], cols[:, 3:]
    f = pair_lag_forces(spos, keys, strides, _csq(cutoff, pos.dtype), M=M, L=L,
                        gfn=lj_force_factor)
    vel_new = svel + dt * f
    pos_new = spos + dt * vel_new
    return MDState(positions=pos_new, velocities=vel_new), \
        lag_coverage_ok(keys, strides, L)


def md_step_split(state: MDStateSplit, cutoff, dt, *, M: int = 4096,
                  L: int = 256):
    """One f64-grade MD step with a full grid rebuild: split-precision
    forces (hi/lo planes through K3) and a compensated two-sum position
    update, all in f32 arithmetic. The keys come from the hi parts.
    Returns (new_state, coverage_ok)."""
    hi, lo, vel = state.pos_hi, state.pos_lo, state.velocities
    cols, keys, strides = _sort_rows(torch.cat([hi, lo, vel], 1), cutoff)
    shi, slo, svel = cols[:, :3], cols[:, 3:6], cols[:, 6:9]
    f = pair_lag_forces(shi, keys, strides, _csq(cutoff, hi.dtype), slo, M=M,
                        L=L, gfn=lj_force_factor)
    vel_new = svel + dt * f
    # two-sum position update: t = lo + dt*v is small, so hi_new + lo_new
    # == hi + (lo + dt*v) exactly to f32x2 (fast two-sum, |hi| >= |t|)
    t = slo + dt * vel_new
    hi_new = shi + t
    lo_new = (shi - hi_new) + t
    return (MDStateSplit(pos_hi=hi_new, pos_lo=lo_new, velocities=vel_new),
            lag_coverage_ok(keys, strides, L))


def md_run(state: MDState, cutoff, dt, *, steps: int, M: int = 4096,
           L: int = 256):
    """``steps`` steps of `md_step`; returns (state, all_covered,
    final_energy), the energy through K1 on a fresh sort."""
    ok = _all_true(state.positions)
    for _ in range(steps):
        state, ok_s = md_step(state, cutoff, dt, M=M, L=L)
        ok = ok & ok_s
    csq = _csq(cutoff, state.positions.dtype)
    energy, _ = _lag_energy(state.positions, cutoff, csq, M=M, L=L)
    return state, ok, energy


def md_run_vv(state: MDState, cutoff, dt, *, steps: int, M: int = 4096,
              L: int = 256):
    """Velocity-Verlet trajectory: second order, at one force evaluation
    per step (the previous step's forces are carried; the half-kicked
    velocities ride the re-sort, so the new forces land in the matching
    order), plus one to start. 3-D only.

    Returns (state, all_covered, final_energy).
    """
    if state.positions.shape[1] != 3:
        raise ValueError(
            "md_run_vv is 3D-only (fused lag kernel); use md_run for "
            f"dim={state.positions.shape[1]} (XLA bucketed dispatch)"
        )
    csq = _csq(cutoff, state.positions.dtype)

    def sort_and_forces(pos, vel):
        cols, keys, strides = _sort_rows(torch.cat([pos, vel], 1), cutoff)
        spos, svel = cols[:, :3], cols[:, 3:]
        f = pair_lag_forces(spos, keys, strides, csq, M=M, L=L,
                            gfn=lj_force_factor)
        return spos, svel, f, lag_coverage_ok(keys, strides, L)

    pos, vel, f, ok = sort_and_forces(state.positions, state.velocities)
    for _ in range(steps):
        vhalf = vel + (0.5 * dt) * f
        pos = pos + dt * vhalf
        pos, vhalf, f, ok_s = sort_and_forces(pos, vhalf)
        vel = vhalf + (0.5 * dt) * f
        ok = ok & ok_s
    energy, _ = _lag_energy(pos, cutoff, csq, M=M, L=L)
    return MDState(positions=pos, velocities=vel), ok, energy


def _skin_scalars(cutoff, skin, dtype):
    """(cell edge, cutoff^2, (skin / 2)^2) in ``dtype``, as the JAX
    package rounds them."""
    skin_t = torch.as_tensor(skin, dtype=dtype)
    edge = torch.as_tensor(cutoff, dtype=dtype) + skin_t
    return edge, _csq(cutoff, dtype), (skin_t / 2) ** 2


def md_run_skin(state: MDState, cutoff, dt, *, steps: int, skin: float = 0.5,
                M: int = 4096, L: int = 256):
    """``steps`` MD steps with Verlet-skin grid reuse (thin boxes, K3).

    The grid is built with cell edge ``cutoff + skin`` and reused while no
    particle has drifted more than ``skin / 2`` from its position at the
    last build; the forces still filter by the true ``cutoff``. A pair
    within ``cutoff`` now was within ``cutoff + skin`` at the build, so it
    is inside the build keys' window: no pair is missed while the drift
    bound holds, and the drift test runs before each force evaluation.
    Steps between rebuilds run no sort. Coverage of L is checked at every
    build and folded into the returned flag.

    Returns (state, all_covered, energy, n_rebuilds).
    """
    edge, csq, half_skin_sq = _skin_scalars(cutoff, skin,
                                            state.positions.dtype)

    def build(pos, vel):
        cols, keys, strides = _sort_rows(torch.cat([pos, vel], 1), edge)
        return cols[:, :3], cols[:, 3:], keys, strides, \
            lag_coverage_ok(keys, strides, L)

    spos, svel, keys, strides, ok = build(state.positions, state.velocities)
    ref, rebuilds = spos, 0
    for _ in range(steps):
        if _drifted(spos - ref, half_skin_sq, -1):
            spos, svel, keys, strides, ok_b = build(spos, svel)
            ref, rebuilds, ok = spos, rebuilds + 1, ok & ok_b
        f = pair_lag_forces(spos, keys, strides, csq, M=M, L=L,
                            gfn=lj_force_factor)
        svel = svel + dt * f
        spos = spos + dt * svel
    energy, ok_e = _lag_energy(spos, cutoff, csq, M=M, L=L)
    return MDState(positions=spos, velocities=svel), ok & ok_e, energy, rebuilds


def _sort_planes(pos: torch.Tensor, vel: torch.Tensor, edge):
    """Keys on a fresh ``auto_order`` grid of cell edge ``edge``, one sort,
    and the sorted (dim, n) position and velocity planes. The grid comes
    from the positions alone, so velocity columns are never taken for
    coordinates. Returns (positions, velocities, sorted keys, strides)."""
    dim = pos.shape[0]
    info = GridInfo.create(aabb_from_positions(pos.t()), edge, auto_order=True)
    bins, planes = bin_and_sort(torch.cat([pos, vel]).t(), edge, max_cells=1,
                                need_perm=False, stacked=False, info=info)
    return (torch.stack(planes[:dim]), torch.stack(planes[dim:]),
            bins.sorted_keys, bins.info.strides)


def md_step_cubic_tile(state: MDState, cutoff, dt, *, CB: int = 8, MAXJ=8,
                       fast: bool = False, bandmask: bool = False):
    """MD step for cubic and wide boxes through the segment-tile forces
    kernel (K7): like `md_step`, a full rebuild with the velocities riding
    the sort, and the state in sorted order. ``MAXJ`` may be a per-band
    tuple (9 entries in 3-D); ``bandmask=False`` runs the maskless tiles
    over disjoint-trimmed windows, and the flag then also guards their
    disjointness. ``fast`` selects `lj_force_factor_fast`.
    Returns (new_state, coverage_ok)."""
    pos, vel = state.positions, state.velocities
    spos, svel, keys, strides = _sort_planes(pos.t(), vel.t(), cutoff)
    f, ok = tile_forces_core(
        spos, keys, strides, _csq(cutoff, pos.dtype), CB=CB, MAXJ=MAXJ,
        gfn=lj_force_factor_fast if fast else lj_force_factor,
        bandmask=bandmask, safe_term=False)
    vel_new = svel + dt * f
    pos_new = spos + dt * vel_new
    return MDState(positions=pos_new.t(), velocities=vel_new.t()), ok


def md_run_skin_tile(state: MDState, cutoff, dt, *, steps: int,
                     skin: float = 0.5, CB: int = 8, MAXJ=8,
                     fast: bool = False, bandmask: bool = False):
    """Verlet-skin MD for cubic and wide boxes over the tile forces kernel
    (K7): the sibling of `md_run_skin`, with the same drift bound and
    rebuild-on-demand contract. The state is carried as (dim, n) planes.
    Steps between rebuilds reuse the build's keys and window bounds, so
    they run the forces kernel on the stale sorted order and nothing
    else. The final energy runs K6 on a fresh cutoff grid at the widest
    per-band capacity.

    Returns (state, all_covered, energy, n_rebuilds).
    """
    gfn = lj_force_factor_fast if fast else lj_force_factor
    edge, csq, half_skin_sq = _skin_scalars(cutoff, skin,
                                            state.positions.dtype)

    def build(pos, vel):
        spos, svel, keys, strides = _sort_planes(pos, vel, edge)
        inp = tile_inputs(spos, keys, strides, CB=CB, MAXJ=MAXJ,
                          bandmask=bandmask, full=True)
        return spos, svel, inp

    spos, svel, inp = build(state.positions.t(), state.velocities.t())
    kernel = spos.device.type == "cuda"
    ref, rebuilds, ok = spos, 0, _all_true(spos)
    for _ in range(steps):
        if _drifted(spos - ref, half_skin_sq, 0):
            spos, svel, inp = build(spos, svel)
            ref, rebuilds = spos, rebuilds + 1
        else:
            inp = dataclasses.replace(inp, pos=spos)
        f = _forces(inp, csq, kernel, gfn=gfn, out_dtype=None, safe_term=False)
        ok = ok & inp.coverage_ok
        svel = svel + dt * f
        spos = spos + dt * svel
    pos = spos.t()
    cols, keys, strides = _sort_rows(pos, cutoff, auto_order=True)
    energy, ok_e = tile_pair_reduce(
        cols, keys, strides, csq,
        MAXJ=MAXJ if isinstance(MAXJ, int) else max(MAXJ))
    return (MDState(positions=pos, velocities=svel.t()), ok & ok_e, energy,
            rebuilds)

