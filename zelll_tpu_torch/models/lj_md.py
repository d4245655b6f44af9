"""Lennard-Jones molecular dynamics: the flagship end-to-end workload.

PyTorch counterpart of ``zelll_tpu/models/lj_md.py``. Every step re-bins
and re-sorts the particles (a full rebuild) and evaluates the LJ forces
with a hand-written kernel: K3 (``ops.lag_pairs.pair_lag_forces``) for
thin boxes, K7 (``ops.tile_pairs``) for cubic and wide ones. State stays
in sorted order between steps and the velocities ride the sort as payload
columns, so forces land in the matching order and no pair list exists.
The Verlet-skin loops (`md_run_skin`, `md_run_skin_tile`) build the grid
with cell edge ``cutoff + skin`` and reuse it while no particle has moved
more than ``skin / 2`` since the last build. The periodic loops
(`md_run_vv_pbc`, `md_run_skin_pbc`, `md_run_skin_tile_pbc`) run the same
integrators in an orthorhombic box through `ops.pbc`. The species steps
(`md_step_species`, `md_run_species`) carry a species column through the
sort as one more payload column and take a payload potential
(`ops.potentials.lennard_jones_mixed`), K3's and K1's species instances
on the card.

State comes back in cell-key order with an unspecified order among equal
keys (the sorts are unstable); compare states as sets of rows.

Where the JAX package runs ``lax.scan`` and ``lax.cond`` on the device,
these are Python loops. Each 3-D step enqueues its kernels without
reading anything back, except the skin loops' drift test: one
device-to-host read per step decides whether to rebuild. `md_step` in
other dimensions reads the number of occupied cells once per step (the
bucketed ``core.pairs`` loop).
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..core.binning import bin_and_sort, compute_keys
from ..core.geometry import GridInfo, aabb_from_positions
from ..core.grid import CellGridData
from ..core.pairs import pair_forces
from ..ops.lag_pairs import (
    lag_coverage_ok,
    lj_term,
    pair_lag_forces,
    pair_lag_reduce,
    split_f64,
)
from ..ops.lj import lj_force_factor, lj_force_factor_fast
from ..ops.pbc import pbc_extend, pbc_lj_forces, pbc_pair_sum, wrap_positions
from ..ops.tile_pairs import _forces, tile_forces_core, tile_inputs, tile_pair_reduce

__all__ = [
    "MDState",
    "MDStateSplit",
    "md_step",
    "md_step_split",
    "md_step_species",
    "md_run_species",
    "md_run",
    "md_run_vv",
    "md_run_skin",
    "md_step_cubic_tile",
    "md_run_skin_tile",
    "md_run_vv_pbc",
    "md_run_skin_pbc",
    "md_run_skin_tile_pbc",
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
    the lag forces kernel (K3); other dimensions take the bucketed
    ``core.pairs.pair_forces`` path with ``K`` its cell capacity, and
    coverage_ok says whether every cell fits in K. That path reads the
    number of occupied cells back to the host once.
    """
    pos, vel = state.positions, state.velocities
    if pos.shape[1] != 3:
        bins, spos = bin_and_sort(pos, cutoff, need_perm=True)
        perm = bins.perm.long()
        svel = vel[perm]
        grid = CellGridData(bins=bins, sorted_pos=spos, sorted_ids=bins.perm)
        # pair_forces returns input order; re-sort to the new sorted order
        f = pair_forces(grid, lj_force_factor, K=K, chunk=64,
                        cutoff_sq=_csq(cutoff, pos.dtype))[perm]
        vel_new = svel + dt * f
        pos_new = spos + dt * vel_new
        return MDState(positions=pos_new, velocities=vel_new), \
            bins.max_cell_count() <= K
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


def md_step_species(state: MDState, species, cutoff, dt, *, pot, M: int = 4096,
                    L: int = 256):
    """One multi-species MD step with a full grid rebuild: the species
    column rides the sort as one more payload column beside the velocities
    (never a gather), and K3 evaluates the payload force factor
    ``pot.gfn(dsq, s_i, s_j)`` (`ops.potentials.lennard_jones_mixed`; on
    CPU tensors any payload gfn) over the sorted species plane.

    Returns (new_state, new_species, coverage_ok): state and species in
    the new sorted order, the species in the positions' dtype (3-D).
    """
    pos, vel = state.positions, state.velocities
    if pos.shape[1] != 3:
        raise ValueError("md_step_species is 3-D (the lag kernel)")
    spec = torch.as_tensor(species, device=pos.device).to(pos.dtype).reshape(-1, 1)
    cols, keys, strides = _sort_rows(torch.cat([pos, vel, spec], 1), cutoff)
    spos, svel, sspec = cols[:, :3], cols[:, 3:6], cols[:, 6:]
    f = pair_lag_forces(spos, keys, strides, _csq(cutoff, pos.dtype), None, sspec, M=M,
                        L=L, gfn=pot.gfn)
    vel_new = svel + dt * f
    pos_new = spos + dt * vel_new
    return (MDState(positions=pos_new, velocities=vel_new), sspec[:, 0],
            lag_coverage_ok(keys, strides, L))


def md_run_species(state: MDState, species, cutoff, dt, *, pot, steps: int,
                   M: int = 4096, L: int = 256):
    """``steps`` steps of `md_step_species`, then the payload energy
    ``pot.term(dsq, s_i, s_j)`` of the final configuration through K1 on a
    fresh sort with the species column. Returns (state, species,
    all_covered, energy)."""
    spec = torch.as_tensor(species, device=state.positions.device).to(
        state.positions.dtype).reshape(-1)
    ok = _all_true(state.positions)
    for _ in range(steps):
        state, spec, ok_s = md_step_species(state, spec, cutoff, dt, pot=pot, M=M, L=L)
        ok = ok & ok_s
    cols, keys, strides = _sort_rows(torch.cat([state.positions, spec[:, None]], 1),
                                     cutoff)
    energy = pair_lag_reduce(cols[:, :3].contiguous(), keys, strides,
                             _csq(cutoff, state.positions.dtype), None, cols[:, 3:],
                             M=M, L=L, term=pot.term)
    return state, spec, ok, energy


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



def md_run_vv_pbc(state: MDState, origin, box, cutoff, dt, *, steps: int, B: int,
                  G: int, path: str = "lag", M: int = 1024, L: int = 256, K: int = 32,
                  chunk: int = 64, MAXJ=8, CB: int = 8):
    """Velocity-Verlet trajectory under orthorhombic PBC: the state stays in
    input order (`ops.pbc.pbc_lj_forces` un-sorts each pass), so the forces
    carry from step to step directly, one force evaluation per step plus
    one to start. Positions are wrapped into the box after each drift.
    Returns (state, all_covered)."""
    kw = dict(B=B, G=G, path=path, M=M, L=L, K=K, chunk=chunk, MAXJ=MAXJ, CB=CB)
    pos, vel = state.positions, state.velocities
    f, ok = pbc_lj_forces(pos, origin, box, cutoff, **kw)
    for _ in range(steps):
        vhalf = vel + (0.5 * dt) * f
        pos = wrap_positions(pos + dt * vhalf, origin, box)
        f, ok_s = pbc_lj_forces(pos, origin, box, cutoff, **kw)
        vel = vhalf + (0.5 * dt) * f
        ok = ok & ok_s
    return MDState(positions=pos, velocities=vel), ok


def _pbc_build(pos, vel, org, bx, edge, *, B: int, G: int):
    """A periodic skin build: wrap the real rows, make the ghost images
    with margin ``edge`` (cutoff + skin), key everything on a fresh
    ``auto_order`` grid of cell edge ``edge`` and sort it once. Ghost
    velocities are 0. Returns (sorted positions, velocities, keys, grid
    info, the real slots and the ghost slots (each ascending), each ghost
    slot's parent slot, each ghost's offset from its parent, and the ghost
    flag)."""
    n, dim = pos.shape
    p = wrap_positions(pos, org, bx)
    ext, _, _, valid, okg, gparent = pbc_extend(p, org, bx, edge, B=B, G=G,
                                                return_parents=True)
    n_ext = ext.shape[0]
    device = ext.device
    vin = torch.cat([vel, torch.zeros((n_ext - n, dim), dtype=vel.dtype, device=device)])
    is_ghost = torch.cat([torch.zeros((n,), dtype=torch.int32, device=device),
                          torch.ones((n_ext - n,), dtype=torch.int32, device=device)])
    parent = torch.cat([torch.arange(n, device=device), gparent.to(torch.int64)])
    info = GridInfo.create(aabb_from_positions(ext, valid), edge, auto_order=True)
    keys, perm = torch.sort(compute_keys(ext, info, valid))
    spos, svel, sghost, spar = ext[perm], vin[perm], is_ghost[perm], parent[perm]
    slot_of_input = torch.empty_like(perm)
    slot_of_input[perm] = torch.arange(n_ext, device=device)
    # real slots, then ghost slots, each ascending
    by_flag = torch.sort(sghost, stable=True)[1]
    real_slots, ghost_slots = by_flag[:n], by_flag[n:]
    gpar_slot = slot_of_input[spar[ghost_slots]]
    gshift = spos[ghost_slots] - spos[gpar_slot]
    return (spos, svel, keys, info, real_slots, ghost_slots, gpar_slot, gshift,
            sghost == 0, okg)


def _pbc_scalars(origin, box, cutoff, skin, like: torch.Tensor):
    dtype, device = like.dtype, like.device
    dim = like.shape[1]
    org = torch.as_tensor(origin, dtype=dtype, device=device).reshape(dim)
    bx = torch.as_tensor(box, dtype=dtype, device=device).reshape(dim)
    edge, csq, half_skin_sq = _skin_scalars(cutoff, skin, dtype)
    return org, bx, edge, csq, half_skin_sq


def md_run_skin_pbc(state: MDState, origin, box, cutoff, dt, *, steps: int, B: int,
                    G: int, skin: float = 0.5, M: int = 4096, L: int = 256):
    """Verlet-skin MD under orthorhombic PBC (thin boxes, K3), the periodic
    sibling of `md_run_skin`: the grid and the ghost images are built with
    margin ``cutoff + skin`` and reused while no real particle has drifted
    more than ``skin / 2``. Ghost rows follow their parents exactly
    (``ghost = parent + (image - parent) at the build``, one G-sized gather
    and scatter per step) and their velocities stay 0, so any pair within
    the cutoff now had its image within cutoff + skin at the build. A
    rebuild takes the real rows, wraps them and extends them again. The
    final energy is `pbc_pair_sum` (K1 with the keep mask) of the wrapped
    real rows.

    Returns (state (real rows in build-sorted order), all_covered, energy,
    n_rebuilds)."""
    pos, vel = state.positions, state.velocities
    org, bx, edge, csq, half_skin_sq = _pbc_scalars(origin, box, cutoff, skin, pos)

    def build(p, v):
        (spos, svel, keys, info, real_slots, ghost_slots, gpar_slot, gshift,
         real, okg) = _pbc_build(p, v, org, bx, edge, B=B, G=G)
        ok = okg & lag_coverage_ok(keys, info.strides, L)
        return (spos, svel, keys, info.strides, real_slots, ghost_slots, gpar_slot,
                gshift, real[:, None], ok)

    (spos, svel, keys, strides, real_slots, ghost_slots, gpar_slot, gshift, real,
     ok) = build(pos, vel)
    ref, rebuilds = spos, 0
    for _ in range(steps):
        if _drifted(torch.where(real, spos - ref, 0.0), half_skin_sq, -1):
            (spos, svel, keys, strides, real_slots, ghost_slots, gpar_slot, gshift,
             real, ok_b) = build(spos[real_slots], svel[real_slots])
            ref, rebuilds, ok = spos, rebuilds + 1, ok & ok_b
        f = pair_lag_forces(spos, keys, strides, csq, M=M, L=L, gfn=lj_force_factor)
        svel = svel + dt * torch.where(real, f, 0.0)
        spos = spos + dt * svel  # ghost velocities stay 0
        spos[ghost_slots] = spos[gpar_slot] + gshift
    R = wrap_positions(spos[real_slots], org, bx)
    V = svel[real_slots]
    energy, ok_e = pbc_pair_sum(R, org, bx, cutoff, term=lj_term, B=B, G=G, M=M, L=L)
    return MDState(positions=R, velocities=V), ok & ok_e, energy, rebuilds


def md_run_skin_tile_pbc(state: MDState, origin, box, cutoff, dt, *, steps: int,
                         B: int, G: int, skin: float = 0.5, CB: int = 8, MAXJ=8,
                         MAXJ_E: int | None = None, fast: bool = False,
                         bandmask: bool = False):
    """Verlet-skin MD under orthorhombic PBC on the segment-tile kernels, the
    cubic and wide boxes' sibling of `md_run_skin_pbc` with the same
    contract: K7 on the ghost-extended array for the steps (it writes
    every row's own side, so ghost forces are simply not applied), the
    window bounds of each build reused between rebuilds and their coverage
    folded into the flag every step, and the final energy through
    `pbc_pair_sum(path="tile")` (K6 with the keep mask) at ``MAXJ_E``
    (default: the largest of ``MAXJ``). The state is carried as (3, n)
    planes. ``fast`` selects `lj_force_factor_fast`.

    Returns (state (real rows in build-sorted order, wrapped),
    all_covered, energy, n_rebuilds)."""
    pos, vel = state.positions, state.velocities
    if pos.shape[1] != 3:
        raise ValueError("md_run_skin_tile_pbc is 3-D (2-D PBC routes to the xla path)")
    gfn = lj_force_factor_fast if fast else lj_force_factor
    org, bx, edge, csq, half_skin_sq = _pbc_scalars(origin, box, cutoff, skin, pos)
    kernel = pos.device.type == "cuda"

    def build(p, v):
        (spos, svel, keys, info, real_slots, ghost_slots, gpar_slot, gshift,
         real, okg) = _pbc_build(p, v, org, bx, edge, B=B, G=G)
        planes = spos.t().contiguous()
        inp = tile_inputs(planes, keys, info.strides, CB=CB, MAXJ=MAXJ,
                          bandmask=bandmask, full=True)
        return (planes, svel.t().contiguous(), inp, real_slots, ghost_slots,
                gpar_slot, gshift.t(), real, okg)

    (spos, svel, inp, real_slots, ghost_slots, gpar_slot, gshift, real,
     ok) = build(pos, vel)
    ref, rebuilds = spos, 0
    for _ in range(steps):
        if _drifted(torch.where(real, spos - ref, 0.0), half_skin_sq, 0):
            (spos, svel, inp, real_slots, ghost_slots, gpar_slot, gshift, real,
             ok_b) = build(spos[:, real_slots].t(), svel[:, real_slots].t())
            ref, rebuilds, ok = spos, rebuilds + 1, ok & ok_b
        else:
            inp = dataclasses.replace(inp, pos=spos)
        f = _forces(inp, csq, kernel, gfn=gfn, out_dtype=None, safe_term=False)
        ok = ok & inp.coverage_ok
        svel = svel + dt * torch.where(real, f, 0.0)
        spos = spos + dt * svel  # ghost velocities stay 0
        spos[:, ghost_slots] = spos[:, gpar_slot] + gshift
    R = wrap_positions(spos[:, real_slots].t(), org, bx)
    V = svel[:, real_slots].t()
    mj_e = MAXJ_E if MAXJ_E is not None else (MAXJ if isinstance(MAXJ, int) else max(MAXJ))
    energy, ok_e = pbc_pair_sum(R, org, bx, cutoff, term=lj_term, B=B, G=G, path="tile",
                                CB=CB, MAXJ=mj_e, bandmask=bandmask)
    return MDState(positions=R, velocities=V), ok & ok_e, energy, rebuilds
