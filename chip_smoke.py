#!/usr/bin/env python3
"""Drive the zelll_tpu_torch port on one CUDA card, and check it.

Run from the root of a checkout, on a machine with one CUDA card, ``nvcc``
(on PATH, under CUDA_HOME, or in /usr/local/cuda) and ``g++``:

    python3 chip_smoke.py

It builds every kernel from the sources in the checkout, holds each against
its plain PyTorch version on the card, and drives both legs of the
benchmark's main path at n = 1e7 with a full rebuild per step: the thin box
(keys -> sort -> lag reduction, K1) and the cubic box (keys -> sort ->
window bounds -> segment-tile reduction, K6). It checks the f64-grade
energy and the pair count of each leg against the exact-f64 oracle at
n = 1e6. Then it drives the MD protocol at n = 1e7 (a perturbed lattice,
v ~ normal(0, 0.3), dt = 1e-4, cutoff 10): the thin box through
`md_step`, `md_step_split` and the Verlet-skin `md_run_skin` (forces by
K3), the cubic box through `md_step_cubic_tile` and `md_run_skin_tile`
(forces by K7), and holds the f64-grade forces of both kernels to the
exact-f64 oracle at n = 1e6. It prints one JSON line per phase. Any failed
phase exits non-zero. The last line is the contract line
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit as nvidia-smi reports them.

Bounds (``bound_ms``) are taken against the published H100 SXM peaks:
3.35 TB/s of device memory and 67 TFLOP/s f32 outside the tensor cores.
That rate counts an FMA as two operations, so the operations bound counts
the FP32 instructions the function needs (with FMA contraction, which K1
itself gives up) at half of it.

Each kernel is held to its plain version on the benchmark's uniform cloud,
whose LJ total is carried by a few nearly coincident pairs, and on a
jittered lattice with a minimum separation, whose pair terms are all of
similar size, so that a wrong term or a lost partial shows. Both sides sum
the same f32 terms in f64 and differ only in the order of the sums: their
f64 totals (``out_dtype=torch.float64``) must agree to 1e-10, and the pair
counts exactly. ``lj_term_fast`` uses rsqrtf in K6 and torch.rsqrt in the
plain version; each may be 2 ulp off, and t^3 = r^-6 multiplies the
relative error by 6, so its totals must agree to 6 x 4 x 2^-23.

The forces kernels (K3, K7) are held to their plain versions the same way,
on f64 outputs: max |f - f_plain| <= 1e-10 max |f_plain| in every case,
8 x 4 x 2^-23 of it with ``lj_force_factor_fast`` (t^3 inv = r^-8). Their
bounds count the work of the function once per unique pair, as K6's does:
the half-stencil candidates, and for each cutoff pair the force factor
and g d on both sides (3 multiplies, 6 adds), so a kernel that evaluates
each pair from both ends cannot look better than it is.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
CUTOFF = 10.0
L_MAIN = 256  # the benchmark's lag bound (bench.py's default)
N_MAIN = 10_000_000
N_CHECK = 200_000
N_PARITY = 1_000_000
N_TILE_CHECK = 200_000
STEPS = 10
CB = 8  # the tile path's padding granule (tile_lj_rebuild_energy's default)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F32_INSTR_PER_S = PEAK_F32_FLOPS / 2  # one FMA is two flops
# FP32 instructions per candidate pair in the key window: per axis sub,
# [sub, add,] fma into dsq, then the cutoff compare (the key compare runs on
# the integer pipe). Per pair inside the cutoff: the IEEE division (4 FMAs
# and a range check around the reciprocal), t*t*t, t3 - 1, 4*t3, the
# product, and the f64 add, counted as 2 (FP64 runs at half the rate).
INSTR_PER_CANDIDATE = {True: 3 * 4 + 1, False: 3 * 2 + 1}
INSTR_PER_PAIR = 5 + 5 + 2
# K6's cubic step runs lj_term_fast: rsqrt, r*r, t*t*t, t3 - 1, 4*t3, the
# product, and the f64 add, counted as 2.
INSTR_PER_PAIR_FAST = 1 + 1 + 2 + 1 + 1 + 1 + 2
# The forces kernels per cutoff pair: the force factor (the IEEE division
# as above, t = inv^3, 24 t, 2t - 1, the two products) and g d on both
# sides of the pair (3 multiplies and 6 adds); the fast factor replaces
# the division by rsqrt and r*r.
INSTR_PER_FORCE_PAIR = 5 + 2 + 1 + 1 + 2 + 3 + 6
INSTR_PER_FORCE_PAIR_FAST = 1 + 1 + 2 + 1 + 1 + 2 + 3 + 6
TOL_REL = 1e-6  # against the exact-f64 oracle
TOL_KERNEL = 1e-10  # a kernel against its plain version, f64 totals
TOL_FAST = 6 * 4 * 2.0**-23  # the same with lj_term_fast (see above)
TOL_FAST_FORCES = 8 * 4 * 2.0**-23  # forces with lj_force_factor_fast
TOL_NEWTON = 1e-6  # |sum_i f_i| against sum_i |f_i| on a lattice
# The MD protocol (the JAX package's benchmarks/steady_state.py)
MD_DT = 1e-4
MD_SKIN = 0.5
MD_STEPS = 10
SKIN_STEPS = 50


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        print(json.dumps({"error": what}), flush=True)
        raise SystemExit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def max_rel(cases: dict) -> float:
    """The largest energy rel_err over the cases of `kernel_vs_plain`."""
    return max(c[m]["rel_err"] for c in cases.values() for m in ("split", "f32"))


def max_tile_rel(cases: dict) -> float:
    """The largest lj_term rel_err over the cases of `tile_vs_plain`."""
    return max(m["rel_err"] for c in cases.values() for m in c.values()
               if isinstance(m, dict))


def ptxas_summary(log: str) -> list:
    """The distinct register and spill lines of a build log."""
    return sorted({ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln})


def profile_steps(step, steps: int = 3) -> dict:
    """Device time per step by kernel under torch.profiler, and the share
    of the wall time the card was busy."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(steps):
            step(i)
        end.record()
        end.synchronize()
    by_kernel = sorted(((e.self_device_time_total / (steps * 1e3), e.key[:90])
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    busy_ms = sum(ms for ms, _ in by_kernel)
    wall_ms = start.elapsed_time(end) / steps
    return dict(step_ms=wall_ms,
                device_busy_share=busy_ms / wall_ms if busy_ms else "not measured",
                ms_per_step_by_kernel=[[round(ms, 4), k] for ms, k in by_kernel[:12]])


def once_ms(fn):
    """Device time of one call of ``fn`` (no warm-up: for the plain
    versions, which take seconds), and its result."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def bound(n_bytes: int, instructions: int) -> dict:
    """The least time the card could take: bytes at the memory rate or
    FP32 instructions at the instruction rate, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = instructions / PEAK_F32_INSTR_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, fp32_instructions=instructions)


def stencil_candidates(skeys: torch.Tensor, info) -> int:
    """Half-stencil candidate pairs from the cell table: same-cell pairs
    plus the products of the counts of each half-stencil neighbour pair of
    cells (the work of a function that visits each candidate once)."""
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY, half_stencil

    real = skeys[skeys != SENTINEL_KEY]
    cell_keys, counts = torch.unique_consecutive(real, return_counts=True)
    candidates = int((counts * (counts - 1) // 2).sum())
    for off in half_stencil(info).tolist():
        nb = cell_keys + off
        idx = torch.searchsorted(cell_keys, nb).clamp(max=cell_keys.shape[0] - 1)
        hit = cell_keys[idx] == nb
        candidates += int((counts * torch.where(hit, counts[idx], 0)).sum())
    return candidates


def sort_split(pts64: np.ndarray, dev, edge: float = CUTOFF):
    """f64 points split into f32 (hi, lo), keyed on an ``auto_order`` grid of
    cell edge ``edge``, sorted and gathered on the card. Returns (sorted hi,
    sorted lo, sorted keys, grid info, perm)."""
    from zelll_tpu_torch.core import GridInfo, aabb_from_positions, compute_keys, sort_by_key
    from zelll_tpu_torch.ops.lag_pairs import split_f64

    hi, lo = split_f64(torch.as_tensor(pts64, device=dev))
    info = GridInfo.create(aabb_from_positions(hi), edge, auto_order=True)
    keys, perm, shi, slo = sort_by_key(compute_keys(hi, info), hi, lo)
    return shi, slo, keys, info, perm


def probe_maxj(keys: torch.Tensor, strides, full: bool = False) -> tuple:
    """Per-band window capacities measured on these keys (padding as CB
    gives it), as bench.py's cubic mode probes them: of the half stencil,
    or of the full stencil the forces read (``full=True``)."""
    from zelll_tpu_torch.ops.lag_pairs import _pad_and_desentinel
    from zelll_tpu_torch.ops.segments import CHUNK, segment_bands, suggest_maxj

    n = keys.shape[0]
    padded = _pad_and_desentinel(keys, max(-(-n // (CHUNK * CB)) * CB, CB) * CHUNK)
    return suggest_maxj(padded, segment_bands(strides, full=full), half=not full,
                        per_band=True)


def md_maxj(pos: torch.Tensor) -> tuple:
    """The cubic MD loops' per-band MAXJ: probed once on the start state's
    keys, on the skin grid (edge cutoff + skin, as the JAX package's
    benchmarks/steady_state.py probes it) and on the cutoff grid that
    `md_step_cubic_tile` rebuilds every step, band by band the larger, plus
    a margin of 1 for the drift between rebuilds."""
    from zelll_tpu_torch.core import GridInfo, aabb_from_positions, compute_keys

    probes = []
    for edge in (CUTOFF, CUTOFF + MD_SKIN):
        info = GridInfo.create(aabb_from_positions(pos), edge, auto_order=True)
        probes.append(probe_maxj(torch.sort(compute_keys(pos, info))[0], info.strides,
                                 full=True))
    return tuple(max(a, b) + 1 for a, b in zip(*probes))


def force_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, max |want|) in f64."""
    torch.cuda.synchronize()
    diff = float((got.double() - want.double()).abs().max())
    return diff, float(want.double().abs().max())


def newton_share(f: torch.Tensor) -> float:
    """|sum_i f_i| (largest axis) against sum_i |f_i|: 0 under Newton's
    third law but for the rounding of the sums."""
    f = f.double()
    return float(f.sum(0).abs().max()) / float(f.abs().sum())


def forces_vs_plain(dev, n: int) -> dict:
    """K3 and K7 against their plain versions on identical sorted inputs,
    f64 outputs on both sides, max |df| <= TOL_KERNEL max |f_plain|
    (TOL_FAST_FORCES with the fast factor); Newton's third law on the
    lattices; K3 against K7 on one thin box."""
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY
    from zelll_tpu_torch.ops.lag_pairs import pair_lag_forces, pair_lag_forces_plain
    from zelll_tpu_torch.ops.lj import lj_force_factor, lj_force_factor_fast
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces, tile_pair_forces_plain
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    f64 = torch.float64
    csq = CUTOFF**2
    factors = ((lj_force_factor, TOL_KERNEL), (lj_force_factor_fast, TOL_FAST_FORCES))

    def compare(kernel, got, want, tol, what):
        err, scale = force_err(got, want)
        check(np.isfinite(err) and scale > 0 and err <= tol * scale,
              f"{kernel} forces off their plain version ({what}): max |df| {err} "
              f"> {tol} x {scale}")
        return dict(max_abs_err=err, max_abs_force=scale, err_over_max=err / scale)

    def lag_cases(shi, slo, keys, strides, tag):
        out = {}
        for lo in (slo, None):
            for gfn, tol in factors:
                what = f"{tag} {'split' if lo is not None else 'f32'} {gfn.__name__}"
                got = pair_lag_forces(shi, keys, strides, csq, lo, L=L_MAIN, gfn=gfn,
                                      out_dtype=f64)
                want = pair_lag_forces_plain(shi, keys, strides, csq, lo, L=L_MAIN,
                                             gfn=gfn, out_dtype=f64)
                out[what] = compare("K3", got, want, tol, what)
        return out

    k3 = {}
    thin = lj_box(n, CUTOFF)
    for tag, pts in (("uniform", generate_points_random(n, thin)),
                     ("lattice", generate_points_lattice(n, thin))):
        shi, slo, keys, info, _ = sort_split(pts, dev)
        k3.update(lag_cases(shi, slo, keys, info.strides, tag))
    padded = keys.clone()
    padded[-1000:] = SENTINEL_KEY
    k3.update(lag_cases(shi, slo, padded, info.strides, "lattice sentinel_tail"))
    f3 = pair_lag_forces(shi, keys, info.strides, csq, slo, L=L_MAIN, out_dtype=f64)
    k3_newton = newton_share(f3)
    check(k3_newton <= TOL_NEWTON, f"K3 forces on the lattice sum to {k3_newton}")
    # two independent kernels of one function, on the same thin box
    f7, ok7 = tile_pair_forces(shi, keys, info.strides, csq, slo,
                               MAXJ=probe_maxj(keys, info.strides, full=True), out_dtype=f64)
    check(bool(ok7), "K7 coverage failed on the thin lattice")
    k3_vs_k7 = compare("K7", f7, f3, TOL_KERNEL, "against K3 on the thin lattice")

    def tile_cases(shi, slo, keys, strides, tag, *, maxj, bandmasks=(False, True),
                   factors=factors, packed=True, expect_ok=True):
        out = {}
        for bandmask in bandmasks:
            for lo in (slo, None):
                for gfn, tol in factors:
                    what = (f"{tag} {'masked' if bandmask else 'maskless'} "
                            f"{'split' if lo is not None else 'f32'} {gfn.__name__}")
                    kw = dict(MAXJ=maxj, bandmask=bandmask, packed=packed, gfn=gfn,
                              out_dtype=f64)
                    got, ok = tile_pair_forces(shi, keys, strides, csq, lo, **kw)
                    want, ok_p = tile_pair_forces_plain(shi, keys, strides, csq, lo, **kw)
                    check(bool(ok) == bool(ok_p) == expect_ok,
                          f"K7 coverage flags {bool(ok)} / {bool(ok_p)} ({what})")
                    out[what] = compare("K7", got, want, tol, what)
        return out

    k7 = {}
    side = (n / 0.01) ** (1 / 3)
    cube = np.random.default_rng(0).uniform(0, side, (n, 3))
    for tag, pts in (("uniform", cube),
                     ("lattice", generate_points_lattice(n, (side, side, side)))):
        shi, slo, keys, info, _ = sort_split(pts, dev)
        maxj = probe_maxj(keys, info.strides, full=True)
        k7.update(tile_cases(shi, slo, keys, info.strides, tag, maxj=maxj))
    f7 = tile_pair_forces(shi, keys, info.strides, csq, slo, MAXJ=maxj, out_dtype=f64)[0]
    k7_newton = newton_share(f7)
    check(k7_newton <= TOL_NEWTON, f"K7 forces on the lattice sum to {k7_newton}")
    k7.update(tile_cases(shi, slo, keys, info.strides, "lattice maxj_1", maxj=1,
                         bandmasks=(True,), factors=factors[:1], expect_ok=False))
    padded = keys.clone()
    padded[-1000:] = SENTINEL_KEY
    k7.update(tile_cases(shi, slo, padded, info.strides, "lattice sentinel_tail",
                         maxj=maxj, factors=factors[:1]))
    # K11: int32 keys past 2^24 (packed=False): two dense blobs in opposite
    # corners of a 2,600 box
    rng = np.random.default_rng(1)
    blob = (n / 2 / 0.01) ** (1 / 3)
    blobs = np.concatenate([rng.uniform(0, blob, (n // 2, 3)),
                            2600.0 - rng.uniform(0, blob, (n // 2, 3))])
    shi, slo, keys, info, _ = sort_split(blobs, dev)
    max_key = int(keys.max())
    check(max_key >= 1 << 24, f"the blob grid's keys stop at {max_key}")
    bmaxj = max(probe_maxj(keys, info.strides, full=True))
    k7.update(tile_cases(shi, slo, keys, info.strides, "int32_keys", maxj=bmaxj,
                         bandmasks=(True,), factors=factors[:1], packed=False))
    k7.update(tile_cases(shi, slo, keys, info.strides, "int32_keys packed_flag",
                         maxj=bmaxj, bandmasks=(True,), factors=factors[:1],
                         expect_ok=False))
    worst = max(c["err_over_max"] for c in (*k3.values(), *k7.values(), k3_vs_k7))
    return dict(n=n, lag_forces=k3, tile_forces=k7, k3_vs_k7=k3_vs_k7,
                lattice_newton_share=dict(K3=k3_newton, K7=k7_newton),
                blob_max_key=max_key, max_err_over_max=worst)


def reset_launches() -> None:
    from zelll_tpu_torch.ops.lag_pairs import pair_lag_forces, pair_lag_reduce
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces, tile_pair_reduce

    for fn in (pair_lag_reduce, pair_lag_forces, tile_pair_reduce, tile_pair_forces):
        fn.launches = 0


def read_launches() -> dict:
    from zelll_tpu_torch.ops.lag_pairs import pair_lag_forces, pair_lag_reduce
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces, tile_pair_reduce

    return dict(lag_reduce=pair_lag_reduce.launches, lag_forces=pair_lag_forces.launches,
                tile_reduce=tile_pair_reduce.launches,
                tile_forces=tile_pair_forces.launches)


def time_steps(step, state, steps: int):
    """``steps`` MD steps after one warm-up step: device ms per step from
    CUDA events, host ms per step, and whether every flag was True.
    Returns (fields, last state)."""
    state, ok = step(state)
    check(bool(ok), "coverage failed in the warm-up step")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flags = []
    t_host = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, ok = step(state)
        flags.append(ok)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / steps
    all_ok = bool(torch.stack(flags).all())
    check(all_ok, "a coverage flag dropped inside the timed steps")
    return dict(step_ms=start.elapsed_time(end) / steps, host_step_ms=host_ms,
                steps=steps, all_flags_true=all_ok), state


def time_skin(run, state, steps: int) -> dict:
    """One Verlet-skin run of ``steps`` steps (after a 2-step warm-up run):
    device and host ms per step, rebuilds, the final energy and flag."""
    run(state, 2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    _, ok, energy, rebuilds = run(state, steps)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / steps
    energy = float(energy)
    check(bool(ok), "a coverage flag dropped in the skin loop")
    check(np.isfinite(energy), "non-finite energy after the skin loop")
    return dict(step_ms=start.elapsed_time(end) / steps, host_step_ms=host_ms,
                steps=steps, skin=MD_SKIN, rebuilds=rebuilds, energy=energy,
                ok=bool(ok))


def md_states(n: int, box, dev):
    """The MD protocol's start: `lattice_cloud` in ``box`` and velocities
    from normal(0, 0.3), both from default_rng(0). Returns (f64 points,
    f32 MDState, split MDStateSplit)."""
    from zelll_tpu_torch.models import MDState, MDStateSplit
    from zelll_tpu_torch.utils.datagen import lattice_cloud

    rng = np.random.default_rng(0)
    pts = lattice_cloud(n, box, rng)
    vel = rng.normal(0, 0.3, pts.shape)
    st = MDState.create(pts.astype(np.float32), vel.astype(np.float32), device=dev)
    return pts, st, MDStateSplit.from_f64(pts, vel, device=dev)


def md_main_path(dev, n: int) -> dict:
    """The thin box's MD legs: `md_step` and `md_step_split` (a full
    rebuild per step, forces by K3) and `md_run_skin` (Verlet skin)."""
    from zelll_tpu_torch.models import md_run_skin, md_step, md_step_split
    from zelll_tpu_torch.utils.datagen import lj_box

    _, st, sst = md_states(n, lj_box(n, CUTOFF), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = {}
    out["md_step"], _ = time_steps(lambda s: md_step(s, CUTOFF, MD_DT, L=L_MAIN),
                                   st, MD_STEPS)
    out["md_step_split"], _ = time_steps(
        lambda s: md_step_split(s, CUTOFF, MD_DT, L=L_MAIN), sst, MD_STEPS)
    out["md_run_skin"] = time_skin(
        lambda s, k: md_run_skin(s, CUTOFF, MD_DT, steps=k, skin=MD_SKIN, L=L_MAIN),
        st, SKIN_STEPS)
    launches = read_launches()
    check(launches["lag_forces"] > 0, "the thin MD path never launched K3")
    check(launches["lag_reduce"] > 0, "the thin MD path never launched K1")
    return dict(n=st.positions.shape[0], L=L_MAIN, dt=MD_DT, legs=out,
                launches=launches, max_memory_allocated=torch.cuda.max_memory_allocated())


def md_cubic_main_path(dev, n: int) -> dict:
    """The cubic box's MD legs: `md_step_cubic_tile` (a full rebuild per
    step, forces by K7, maskless, the exact factor) and
    `md_run_skin_tile`, at the probed per-band MAXJ."""
    from zelll_tpu_torch.models import md_run_skin_tile, md_step_cubic_tile

    side = (n / 0.01) ** (1 / 3)
    _, st, _ = md_states(n, (side, side, side), dev)
    maxj = md_maxj(st.positions)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = {}
    out["md_step_cubic_tile"], _ = time_steps(
        lambda s: md_step_cubic_tile(s, CUTOFF, MD_DT, MAXJ=maxj), st, MD_STEPS)
    out["md_run_skin_tile"] = time_skin(
        lambda s, k: md_run_skin_tile(s, CUTOFF, MD_DT, steps=k, skin=MD_SKIN,
                                      MAXJ=maxj), st, SKIN_STEPS)
    launches = read_launches()
    check(launches["tile_forces"] > 0, "the cubic MD path never launched K7")
    check(launches["tile_reduce"] > 0, "the cubic MD path never launched K6")
    return dict(n=st.positions.shape[0], side=side, MAXJ=maxj, dt=MD_DT, legs=out,
                launches=launches, max_memory_allocated=torch.cuda.max_memory_allocated())


def md_profile(dev, n: int) -> dict:
    """Device time by kernel and the busy share: 3 steps of `md_step` and
    of `md_step_cubic_tile`, and one 10-step call of each skin loop (its
    numbers are per call: one build, 10 steps, the final energy)."""
    from zelll_tpu_torch.models import (
        md_run_skin, md_run_skin_tile, md_step, md_step_cubic_tile,
    )
    from zelll_tpu_torch.utils.datagen import lj_box

    out = {}
    _, st, _ = md_states(n, lj_box(n, CUTOFF), dev)
    held = [st]

    def thin(i):
        held[0] = md_step(held[0], CUTOFF, MD_DT, L=L_MAIN)[0]

    out["md_step"] = profile_steps(thin)
    out["md_run_skin_10_steps"] = profile_steps(
        lambda i: md_run_skin(st, CUTOFF, MD_DT, steps=10, skin=MD_SKIN, L=L_MAIN), 1)
    side = (n / 0.01) ** (1 / 3)
    _, st, _ = md_states(n, (side, side, side), dev)
    maxj = md_maxj(st.positions)
    held = [st]

    def cubic(i):
        held[0] = md_step_cubic_tile(held[0], CUTOFF, MD_DT, MAXJ=maxj)[0]

    out["md_step_cubic_tile"] = profile_steps(cubic)
    out["md_run_skin_tile_10_steps"] = profile_steps(
        lambda i: md_run_skin_tile(st, CUTOFF, MD_DT, steps=10, skin=MD_SKIN, MAXJ=maxj), 1)
    return out


def lag_forces_alone(dev, n: int) -> dict:
    """K3 alone on the thin MD start state's sorted inputs (n = 1e7): its
    ms, one plain call's ms, the work of the function and its bound, and
    the kernel against the plain version (f64 outputs)."""
    from zelll_tpu_torch.core import key_window
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count, count_term, pair_lag_forces, pair_lag_forces_plain, pair_lag_reduce,
    )
    from zelll_tpu_torch.utils.datagen import lj_box

    pts, _, _ = md_states(n, lj_box(n, CUTOFF), dev)
    shi, slo, keys, info, _ = sort_split(pts, dev)
    n = shi.shape[0]
    strides = info.strides
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    pairs = combine_count(pair_lag_reduce(shi, keys, strides, csq, slo, L=L_MAIN,
                                          term=count_term, out_dtype=torch.int32))
    candidates = stencil_candidates(keys, info)
    first = torch.searchsorted(keys, keys - key_window(strides))
    slots = torch.arange(n, device=dev)
    window = int(torch.clamp(slots - first, max=L_MAIN).sum())
    out = dict(n=n, pairs=pairs, candidates=candidates, candidates_per_slot=candidates / n,
               lag_window_pairs=window, evaluations=2 * window,
               evaluations_per_candidate=2 * window / candidates)
    for tag, lo in (("f32", None), ("split", slo)):
        ms = cuda_ms(lambda: pair_lag_forces(shi, keys, strides, csq, lo, L=L_MAIN), 10)
        plain_ms, want = once_ms(lambda: pair_lag_forces_plain(
            shi, keys, strides, csq, lo, L=L_MAIN, out_dtype=torch.float64))
        got = pair_lag_forces(shi, keys, strides, csq, lo, L=L_MAIN, out_dtype=torch.float64)
        err, scale = force_err(got, want)
        check(err <= TOL_KERNEL * scale, f"K3 {tag} at n = {n}: max |df| {err}")
        b = bound(n * 4 * ((6 if lo is not None else 3) + 1 + 3),
                  candidates * INSTR_PER_CANDIDATE[lo is not None]
                  + pairs * INSTR_PER_FORCE_PAIR)
        out[tag] = dict(ms=ms, plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms,
                        max_abs_err=err, max_abs_force=scale)
    return out


def tile_forces_alone(dev, n: int) -> dict:
    """K7 alone on the cubic MD start state's sorted inputs (n = 1e7, f32,
    maskless, the exact factor, as `md_step_cubic_tile` runs it): its ms,
    one plain call's ms, the work and the bound, and the kernel against
    the plain version (f64 outputs)."""
    from zelll_tpu_torch.ops.lag_pairs import combine_count, count_term
    from zelll_tpu_torch.ops.segments import CHUNK, segment_bands, suggest_maxj
    from zelll_tpu_torch.ops.tile_pairs import (
        forces_tiles, forces_tiles_plain, reduce_tiles, tile_inputs,
    )

    side = (n / 0.01) ** (1 / 3)
    pts, st, _ = md_states(n, (side, side, side), dev)
    maxj = md_maxj(st.positions)
    del st
    shi, _, keys, info, _ = sort_split(pts, dev)
    n = shi.shape[0]
    planes = shi.t().contiguous()
    inp = tile_inputs(planes, keys, info.strides, CB=CB, MAXJ=maxj, bandmask=False,
                      full=True)
    check(bool(inp.coverage_ok), f"K7 coverage failed alone at MAXJ={maxj}")
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    # the pairs, once each, from K6 over the half stencil of the same keys
    half_maxj = suggest_maxj(inp.keys, segment_bands(info.strides), per_band=True)
    half = tile_inputs(planes, keys, info.strides, CB=CB, MAXJ=half_maxj)
    check(bool(half.coverage_ok), "K6 coverage failed on the MD cube")
    pairs = combine_count(reduce_tiles(half, csq, term=count_term, out_dtype=torch.int32))
    candidates = stencil_candidates(keys, info)
    evaluations = int(inp.bounds[:, 2::3].sum()) * CHUNK * CHUNK
    ms = cuda_ms(lambda: forces_tiles(inp, csq), 10)
    plain_ms, want = once_ms(lambda: forces_tiles_plain(inp, csq, out_dtype=torch.float64))
    got = forces_tiles(inp, csq, out_dtype=torch.float64)
    err, scale = force_err(got, want)
    check(err <= TOL_KERNEL * scale, f"K7 at n = {n}: max |df| {err}")
    newton = newton_share(got.t())  # K7 writes (3, n) planes
    check(newton <= TOL_NEWTON, f"K7 forces on the MD lattice sum to {newton}")
    b = bound(n * 4 * (3 + 1 + 3) + inp.bounds.numel() * 4,
              candidates * INSTR_PER_CANDIDATE[False] + pairs * INSTR_PER_FORCE_PAIR)
    return dict(n=n, mode="f32 maskless lj_force_factor", MAXJ=maxj, ms=ms,
                plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms, pairs=pairs,
                candidates=candidates, candidates_per_slot=candidates / n,
                tile_evaluations=evaluations,
                evaluations_per_candidate=evaluations / candidates, max_abs_err=err,
                max_abs_force=scale, newton_share=newton)


def forces_parity(dev, n: int) -> dict:
    """f64-grade forces (split coordinates) against the exact-f64 oracle at
    n = 1e6: K3 on the thin box and K7 on the cube, each on the benchmark's
    uniform points and on `lattice_cloud`; rows mapped back to input order
    through the sort's permutation. Limit: ||f - f_ref|| / ||f_ref|| <=
    TOL_REL."""
    from zelll_tpu_torch import oracle
    from zelll_tpu_torch.ops.lag_pairs import lag_coverage_ok, pair_lag_forces
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces
    from zelll_tpu_torch.utils.datagen import generate_points_random, lattice_cloud, lj_box

    thin = lj_box(n, CUTOFF)
    side = (n / 0.01) ** (1 / 3)
    cube = (side, side, side)
    datasets = {
        "thin_uniform": generate_points_random(n, thin),
        "thin_lattice": lattice_cloud(n, thin, np.random.default_rng(0)),
        "cubic_uniform": np.random.default_rng(0).uniform(0, side, (n, 3)),
        "cubic_lattice": lattice_cloud(n, cube, np.random.default_rng(0)),
    }
    out = {}
    for name, pts in datasets.items():
        shi, slo, keys, info, perm = sort_split(pts, dev)
        csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
        if name.startswith("thin"):
            f = pair_lag_forces(shi, keys, info.strides, csq, slo, L=L_MAIN)
            ok = lag_coverage_ok(keys, info.strides, L_MAIN)
        else:
            f, ok = tile_pair_forces(shi, keys, info.strides, csq, slo,
                                     MAXJ=probe_maxj(keys, info.strides, full=True))
        check(bool(ok), f"coverage failed for the forces of {name}")
        mine = torch.empty_like(f)
        mine[perm] = f
        ref = oracle.forces(pts, CUTOFF)
        got = mine.double().cpu().numpy()
        err = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        check(np.isfinite(err) and err <= TOL_REL,
              f"force_rel_err_vs_oracle {err} ({name})")
        out[name] = dict(n=len(pts), force_rel_err_vs_oracle=err,
                         kernel="K3" if name.startswith("thin") else "K7")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    sys.path.insert(0, ROOT)
    from zelll_tpu_torch import oracle
    from zelll_tpu_torch.core import (
        GridInfo, aabb_from_positions, compute_keys, key_window, sort_by_key,
    )
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY
    from zelll_tpu_torch.ops import lag_pairs, tile_pairs
    from zelll_tpu_torch.ops.fused import auto_lj_energy, fused_lj_rebuild_energy
    from zelll_tpu_torch.ops.lag_pairs import (
        _pad_and_desentinel, combine_count, count_term, lag_coverage_ok, lj_term,
        lj_term_fast, pair_lag_reduce, pair_lag_reduce_plain, split_f64,
    )
    from zelll_tpu_torch.ops.segments import CHUNK, segment_bands, suggest_maxj
    from zelll_tpu_torch.ops.tile_pairs import (
        reduce_tiles, reduce_tiles_plain, tile_inputs, tile_lj_rebuild_energy,
        tile_pair_reduce, tile_pair_reduce_plain,
    )
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    dev = torch.device("cuda")

    # -- 1. device ------------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired):
        smi_line = ""
    smi_line = smi_line or "nvidia-smi: not available"
    emit("device", name=name, count=count, nvidia_smi=smi_line,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. build every kernel (and the oracle) at once ------------------------
    t0 = time.perf_counter()
    loaders = {"lag_reduce": lag_pairs.load_kernel, "tile_reduce": tile_pairs.load_kernel,
               "lag_forces": lag_pairs.load_forces_kernel,
               "tile_forces": tile_pairs.load_forces_kernel}
    with ThreadPoolExecutor(len(loaders) + 1) as pool:
        builds = [pool.submit(load) for load in loaders.values()]
        have_oracle = pool.submit(oracle.available)
        for b in builds:
            b.result()
        check(have_oracle.result(), "the oracle did not build")
    emit("build", seconds=time.perf_counter() - t0,
         **{f"{name}_ptxas": ptxas_summary(load.log) for name, load in loaders.items()})

    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2

    def kernel_vs_plain(shi, slo, keys, strides, L):
        """K1 and its plain version on identical sorted inputs: counts
        exact, f64 energy totals to TOL_KERNEL, the same coverage flag."""
        out = {}
        f64 = torch.float64
        for split in (True, False):
            lo = slo if split else None
            e_k = float(pair_lag_reduce(shi, keys, strides, csq, lo, L=L, out_dtype=f64))
            e_p = float(pair_lag_reduce_plain(shi, keys, strides, csq, lo, L=L,
                                              out_dtype=f64))
            c_k = combine_count(pair_lag_reduce(shi, keys, strides, csq, lo, L=L,
                                                term=count_term, out_dtype=torch.int32))
            c_p = combine_count(pair_lag_reduce_plain(
                shi, keys, strides, csq, lo, L=L, term=count_term, out_dtype=torch.int32))
            tag = "split" if split else "f32"
            check(c_k == c_p, f"K1 count {c_k} != plain {c_p} ({tag}, L={L})")
            check(np.isfinite(e_k) and rel(e_k, e_p) <= TOL_KERNEL,
                  f"K1 energy {e_k} vs plain {e_p} ({tag}, L={L})")
            out[tag] = dict(energy=e_k, plain_energy=e_p, abs_err=abs(e_k - e_p),
                            rel_err=rel(e_k, e_p), pairs=c_k)
        ok_k = bool(lag_coverage_ok(keys, strides, L))
        ok_p = bool(lag_coverage_ok(keys.cpu(), strides.cpu(), L))
        check(ok_k == ok_p, f"coverage flags differ at L={L}")
        out["ok"] = ok_k
        return out

    # -- 3. K1 against its plain version, n = 2e5 --------------------------------
    pts = generate_points_random(N_CHECK, lj_box(N_CHECK, CUTOFF))
    shi, slo, keys, info, _ = sort_split(pts, dev)
    strides = info.strides
    cases = {f"L{L}": kernel_vs_plain(shi, slo, keys, strides, L)
             for L in (L_MAIN, 32)}
    check(cases[f"L{L_MAIN}"]["ok"] and not cases["L32"]["ok"],
          "expected coverage at L=256 and none at L=32")
    padded = keys.clone()
    padded[-1000:] = 2**31 - 1  # SENTINEL_KEY rows
    cases["sentinel_tail"] = kernel_vs_plain(shi, slo, padded, strides, L_MAIN)
    shi, slo, keys, info, _ = sort_split(
        generate_points_lattice(N_CHECK, lj_box(N_CHECK, CUTOFF)), dev)
    cases["lattice"] = kernel_vs_plain(shi, slo, keys, info.strides, L_MAIN)
    emit("kernel_vs_plain", n=N_CHECK, cases=cases, max_rel_err=max_rel(cases))

    # -- 4. the main path at n = 1e7 -------------------------------------------
    pts = generate_points_random(N_MAIN, lj_box(N_MAIN, CUTOFF))
    pos64 = torch.as_tensor(pts, device=dev)
    hi, lo = split_f64(pos64)
    del pos64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    main = {}
    pair_lag_reduce.launches = 0
    tile_pair_reduce.launches = 0
    for split in (True, False):
        plo = lo if split else None
        e0, ok0 = fused_lj_rebuild_energy(hi, CUTOFF, plo, L=L_MAIN)  # warm-up
        check(bool(ok0), f"lag coverage failed at L={L_MAIN}")
        energies, oks = [], []
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_host = time.perf_counter()
        start.record()
        for i in range(STEPS):
            p = hi + (i % 2) * 1e-6  # per-step jitter, as bench.py applies
            e, ok = fused_lj_rebuild_energy(p, CUTOFF, plo, L=L_MAIN)
            energies.append(e)
            oks.append(ok)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / STEPS
        step_ms = start.elapsed_time(end) / STEPS
        check(all(bool(o) for o in oks), "coverage failed inside the timed steps")
        check(all(np.isfinite(float(x)) for x in energies), "non-finite energy")
        c, _ = fused_lj_rebuild_energy(hi, CUTOFF, plo, L=L_MAIN, term=count_term,
                                       out_dtype=torch.int32)
        npairs = combine_count(c)
        main["split" if split else "f32"] = dict(
            step_ms=step_ms, host_step_ms=host_ms, pairs=npairs,
            pairs_per_sec=npairs / (step_ms * 1e-3),
            energy_per_atom=float(e0) / N_MAIN)
    launches = pair_lag_reduce.launches
    check(launches > 0, "the main path never launched K1")
    peak_bytes = torch.cuda.max_memory_allocated()
    emit("main_path", n=N_MAIN, L=L_MAIN, steps=STEPS, modes=main,
         lag_reduce_launches=launches, tile_reduce_launches=tile_pair_reduce.launches,
         max_memory_allocated=peak_bytes)

    # where a split step's device time goes, by kernel, and the busy share
    emit("profile", mode="split", **profile_steps(
        lambda i: fused_lj_rebuild_energy(hi + (i % 2) * 1e-6, CUTOFF, lo, L=L_MAIN)))

    # K1 alone at the main path's shapes, its bound, the sort, the plain version
    shi, slo, keys, info, _ = sort_split(pts, dev)
    strides = info.strides
    w = key_window(strides)
    first = torch.searchsorted(keys, keys - w)
    slots = torch.arange(N_MAIN, device=dev)
    candidates = int(torch.clamp(slots - first, max=L_MAIN).sum())
    k1 = {}
    for split in (True, False):
        plo = slo if split else None
        tag = "split" if split else "f32"
        ms = cuda_ms(lambda: pair_lag_reduce(shi, keys, strides, csq, plo, L=L_MAIN), 10)
        plain_ms = cuda_ms(
            lambda: pair_lag_reduce_plain(shi, keys, strides, csq, plo, L=L_MAIN), 2)
        keys_sort_ms = cuda_ms(lambda: sort_by_key(
            compute_keys(hi, GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)),
            *((hi, lo) if split else (hi,))), 10)
        b = bound(N_MAIN * 4 * ((6 if split else 3) + 1),
                  candidates * INSTR_PER_CANDIDATE[split]
                  + main[tag]["pairs"] * INSTR_PER_PAIR)
        k1[tag] = dict(ms=ms, plain_ms=plain_ms, keys_sort_ms=keys_sort_ms, **b,
                       share_of_bound=b["bound_ms"] / ms, step_ms=main[tag]["step_ms"])
    compare = {"uniform": kernel_vs_plain(shi, slo, keys, strides, L_MAIN)}
    del shi, slo, keys
    shi, slo, keys, info, _ = sort_split(
        generate_points_lattice(N_MAIN, lj_box(N_MAIN, CUTOFF)), dev)
    compare["lattice"] = kernel_vs_plain(shi, slo, keys, info.strides, L_MAIN)
    del shi, slo, keys
    # the uniform totals reach 5e27, so their absolute errors say nothing:
    # the kernel line reports the lattice's, whose terms are all of one size
    max_abs_err = max(compare["lattice"][m]["abs_err"] for m in ("split", "f32"))
    emit("lag_reduce_alone", n=N_MAIN, candidates=candidates,
         candidates_per_slot=candidates / N_MAIN, **k1, compare=compare,
         max_rel_err=max_rel(compare), lattice_max_abs_err=max_abs_err)

    # -- 5. f64-grade parity with the exact-f64 oracle, n = 1e6 -------------------
    pts = generate_points_random(N_PARITY, lj_box(N_PARITY, CUTOFF))
    e_ref, n_ref = oracle.lj_energy(pts, CUTOFF)
    hi, lo = split_f64(torch.as_tensor(pts, device=dev))
    e, ok = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=L_MAIN)
    c, _ = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=L_MAIN, term=count_term,
                                   out_dtype=torch.int32)
    e_f32, _ = fused_lj_rebuild_energy(hi, CUTOFF, L=L_MAIN)
    energy_err = rel(float(e), e_ref)
    count_err = rel(combine_count(c), n_ref)
    check(bool(ok), "coverage failed at the parity size")
    check(energy_err <= TOL_REL, f"energy_rel_err_vs_oracle {energy_err}")
    check(count_err <= TOL_REL, f"count_rel_err_vs_oracle {count_err}")
    emit("parity", n=N_PARITY, energy_rel_err_vs_oracle=energy_err,
         count_rel_err_vs_oracle=count_err, oracle_pairs=n_ref,
         f32_energy_rel_err_vs_oracle=rel(float(e_f32), e_ref))

    # -- 6. K6 against its plain version, n = 2e5 ---------------------------------
    def tile_vs_plain(shi, slo, keys, strides, maxj, *, bandmasks=(False, True),
                      fast=False, packed=True, expect_ok=True):
        """K6 and its plain version on identical sorted inputs: counts
        exact, f64 lj_term totals to TOL_KERNEL (lj_term_fast to
        TOL_FAST), the same coverage flag."""
        out = {}
        f64 = torch.float64
        for bandmask in bandmasks:
            for split in (True, False):
                lo = slo if split else None
                kw = dict(MAXJ=maxj, bandmask=bandmask, packed=packed)
                tag = f"{'masked' if bandmask else 'maskless'}_{'split' if split else 'f32'}"
                e_k, ok_k = tile_pair_reduce(shi, keys, strides, csq, lo, out_dtype=f64, **kw)
                e_p, ok_p = tile_pair_reduce_plain(shi, keys, strides, csq, lo,
                                                   out_dtype=f64, **kw)
                cnt = dict(term=count_term, out_dtype=torch.int32, **kw)
                c_k = combine_count(tile_pair_reduce(shi, keys, strides, csq, lo, **cnt)[0])
                c_p = combine_count(tile_pair_reduce_plain(shi, keys, strides, csq, lo,
                                                           **cnt)[0])
                e_k, e_p = float(e_k), float(e_p)
                check(bool(ok_k) == bool(ok_p) == expect_ok,
                      f"K6 coverage flags {bool(ok_k)} / {bool(ok_p)} ({tag})")
                check(c_k == c_p, f"K6 count {c_k} != plain {c_p} ({tag})")
                check(np.isfinite(e_k) and rel(e_k, e_p) <= TOL_KERNEL,
                      f"K6 energy {e_k} vs plain {e_p} ({tag})")
                case = dict(energy=e_k, plain_energy=e_p, abs_err=abs(e_k - e_p),
                            rel_err=rel(e_k, e_p), pairs=c_k, ok=bool(ok_k))
                if fast:
                    fk = float(tile_pair_reduce(shi, keys, strides, csq, lo, out_dtype=f64,
                                                term=lj_term_fast, **kw)[0])
                    fp = float(tile_pair_reduce_plain(shi, keys, strides, csq, lo,
                                                      out_dtype=f64, term=lj_term_fast,
                                                      **kw)[0])
                    check(rel(fk, fp) <= TOL_FAST, f"K6 lj_term_fast {fk} vs plain {fp}")
                    case["fast_rel_err"] = rel(fk, fp)
                out[tag] = case
        return out

    def cube(n):
        """bench.py's cubic cloud: uniform, density 0.01, default_rng(0)."""
        side = (n / 0.01) ** (1 / 3)
        return np.random.default_rng(0).uniform(0, side, (n, 3)), side

    pts, side = cube(N_TILE_CHECK)
    shi, slo, keys, info, _ = sort_split(pts, dev)
    maxj = probe_maxj(keys, info.strides)
    tcases = {"uniform": tile_vs_plain(shi, slo, keys, info.strides, maxj)}
    tcases["maxj_1"] = tile_vs_plain(shi, slo, keys, info.strides, 1, bandmasks=(True,),
                                     expect_ok=False)
    padded = keys.clone()
    padded[-1000:] = SENTINEL_KEY
    tcases["sentinel_tail"] = tile_vs_plain(shi, slo, padded, info.strides, maxj)
    shi, slo, keys, info, _ = sort_split(
        generate_points_lattice(N_TILE_CHECK, (side, side, side)), dev)
    tcases["lattice"] = tile_vs_plain(shi, slo, keys, info.strides,
                                      probe_maxj(keys, info.strides), fast=True)
    # K10: int32 keys past 2^24 (packed=False): two dense blobs in opposite
    # corners of a 2,600 box
    rng = np.random.default_rng(1)
    blob = (N_TILE_CHECK / 2 / 0.01) ** (1 / 3)
    blobs = np.concatenate([rng.uniform(0, blob, (N_TILE_CHECK // 2, 3)),
                            2600.0 - rng.uniform(0, blob, (N_TILE_CHECK // 2, 3))])
    shi, slo, keys, info, _ = sort_split(blobs, dev)
    max_key = int(keys.max())
    check(max_key >= 1 << 24, f"the blob grid's keys stop at {max_key}")
    bmaxj = max(probe_maxj(keys, info.strides))
    tcases["int32_keys"] = tile_vs_plain(shi, slo, keys, info.strides, bmaxj,
                                         bandmasks=(True,), packed=False)
    tcases["int32_keys_packed_flag"] = tile_vs_plain(
        shi, slo, keys, info.strides, bmaxj, bandmasks=(True,), expect_ok=False)
    del shi, slo, keys
    emit("tile_vs_plain", n=N_TILE_CHECK, maxj=maxj, cases=tcases,
         max_rel_err=max_tile_rel(tcases), blob_max_key=max_key)

    # -- 7. the cubic main path at n = 1e7 (bench.py's cubic mode) -------------------
    pts, side = cube(N_MAIN)
    pos = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    del pts
    cinfo = GridInfo.create(aabb_from_positions(pos), CUTOFF, auto_order=True)
    ckeys, _ = torch.sort(compute_keys(pos, cinfo))
    cmaxj = probe_maxj(ckeys, cinfo.strides)
    del ckeys
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair_lag_reduce.launches = 0
    tile_pair_reduce.launches = 0
    step_kw = dict(MAXJ=cmaxj, kahan=False, term=lj_term_fast, safe_term=False)
    c, ok_c = tile_lj_rebuild_energy(pos, CUTOFF, MAXJ=cmaxj, term=count_term,
                                     out_dtype=torch.int32)
    cpairs = combine_count(c)
    check(bool(ok_c), f"tile coverage failed at MAXJ={cmaxj}")
    e0, ok0 = tile_lj_rebuild_energy(pos, CUTOFF, **step_kw)  # warm-up
    check(bool(ok0), f"tile coverage failed at MAXJ={cmaxj}")
    energies, oks = [], []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    for i in range(STEPS):
        p = pos + (i % 2) * 1e-6  # per-step jitter, as bench.py applies
        e, ok = tile_lj_rebuild_energy(p, CUTOFF, **step_kw)
        energies.append(e)
        oks.append(ok)
    end.record()
    end.synchronize()
    cubic_host_ms = (time.perf_counter() - t_host) * 1e3 / STEPS
    cubic_ms = start.elapsed_time(end) / STEPS
    tile_launches = tile_pair_reduce.launches
    k1_in_cubic = pair_lag_reduce.launches
    check(all(bool(o) for o in oks), "tile coverage failed inside the timed steps")
    check(all(np.isfinite(float(x)) for x in energies), "non-finite cubic energy")
    check(tile_launches > 0, "the cubic main path never launched K6")
    emit("cubic_main_path", n=N_MAIN, side=side, steps=STEPS, MAXJ=cmaxj,
         cubic_step_ms=cubic_ms, cubic_host_step_ms=cubic_host_ms, pairs=cpairs,
         cubic_pairs_per_sec=cpairs / (cubic_ms * 1e-3),
         energy_per_atom=float(e0) / N_MAIN, tile_reduce_launches=tile_launches,
         lag_reduce_launches=k1_in_cubic,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    emit("cubic_profile", mode="f32", **profile_steps(
        lambda i: tile_lj_rebuild_energy(pos + (i % 2) * 1e-6, CUTOFF, **step_kw)))

    # -- 8. K6 alone at the cubic path's shapes, its bound, the plain version ------
    def tile_prep(x, maxj):
        """What tile_lj_rebuild_energy does before K6: keys, sort, gathers
        into planes, padded keys, window bounds and the disjoint trim."""
        info = GridInfo.create(aabb_from_positions(x), CUTOFF, auto_order=True)
        skeys, perm = torch.sort(compute_keys(x, info))
        planes = x.t().index_select(1, perm).contiguous()
        return tile_inputs(planes, skeys, info.strides, CB=CB, MAXJ=maxj,
                           bandmask=False), skeys, info

    inp, skeys, info = tile_prep(pos, cmaxj)
    check(bool(inp.coverage_ok), "tile coverage failed for K6 alone")
    candidates = stencil_candidates(skeys, info)
    tiles = int(inp.bounds[:, 2::3].sum())
    evaluations = tiles * CHUNK * CHUNK
    csq32 = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    k6_ms = cuda_ms(lambda: reduce_tiles(inp, csq32, term=lj_term_fast), 10)
    k6_plain_ms = cuda_ms(lambda: reduce_tiles_plain(inp, csq32, term=lj_term_fast,
                                                     safe_term=False), 1)
    prep_ms = cuda_ms(lambda: tile_prep(pos, cmaxj), 10)
    k6_bound = bound(N_MAIN * 4 * (3 + 1) + inp.bounds.numel() * 4,
                     candidates * INSTR_PER_CANDIDATE[False] + cpairs * INSTR_PER_PAIR_FAST)
    # the main path's own call, and a lattice, against the plain version
    f64 = torch.float64
    k6_compare = {}
    for tag, x in (("uniform", pos), ("lattice", None)):
        if x is None:
            del inp, skeys
            x = torch.as_tensor(generate_points_lattice(N_MAIN, (side, side, side)),
                                dtype=torch.float32, device=dev)
            linfo = GridInfo.create(aabb_from_positions(x), CUTOFF, auto_order=True)
            lmaxj = probe_maxj(torch.sort(compute_keys(x, linfo))[0], linfo.strides)
            inp, _, _ = tile_prep(x, lmaxj)
            check(bool(inp.coverage_ok), "tile coverage failed on the lattice")
        case = {}
        for term, tol in ((lj_term_fast, TOL_FAST), (lj_term, TOL_KERNEL)):
            got = float(reduce_tiles(inp, csq32, term=term, out_dtype=f64))
            want = float(reduce_tiles_plain(inp, csq32, term=term, out_dtype=f64,
                                            safe_term=False))
            check(np.isfinite(got) and rel(got, want) <= tol,
                  f"K6 {term.__name__} {got} vs plain {want} ({tag}, n = 1e7)")
            case[term.__name__] = dict(energy=got, plain_energy=want,
                                       abs_err=abs(got - want), rel_err=rel(got, want))
        c_k = combine_count(reduce_tiles(inp, csq32, term=count_term, out_dtype=torch.int32))
        c_p = combine_count(reduce_tiles_plain(inp, csq32, term=count_term,
                                               out_dtype=torch.int32))
        check(c_k == c_p, f"K6 count {c_k} != plain {c_p} ({tag}, n = 1e7)")
        case["pairs"] = c_k
        k6_compare[tag] = case
    del inp, x, pos
    # the uniform totals are carried by a few near pairs: the kernel line
    # reports the lattice's absolute error, whose terms are all of one size
    tile_max_abs_err = k6_compare["lattice"]["lj_term"]["abs_err"]
    emit("tile_reduce_alone", n=N_MAIN, mode="f32 maskless lj_term_fast", MAXJ=cmaxj,
         ms=k6_ms, plain_ms=k6_plain_ms, keys_sort_bounds_ms=prep_ms,
         **k6_bound, share_of_bound=k6_bound["bound_ms"] / k6_ms, candidates=candidates,
         candidates_per_slot=candidates / N_MAIN, cutoff_pairs=cpairs,
         tile_evaluations=evaluations, evaluations_per_candidate=evaluations / candidates,
         step_ms=cubic_ms, compare=k6_compare, lattice_max_abs_err=tile_max_abs_err)

    # -- 9. cubic f64-grade parity with the exact-f64 oracle, n = 1e6 ---------------
    pts, side = cube(N_PARITY)
    e_ref, n_ref = oracle.lj_energy(pts, CUTOFF)
    hi, lo = split_f64(torch.as_tensor(pts, device=dev))
    pinfo = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
    pmaxj = probe_maxj(torch.sort(compute_keys(hi, pinfo))[0], pinfo.strides)
    e, ok = tile_lj_rebuild_energy(hi, CUTOFF, lo, MAXJ=pmaxj, kahan=True)
    c, ok_c = tile_lj_rebuild_energy(hi, CUTOFF, lo, MAXJ=pmaxj, term=count_term,
                                     out_dtype=torch.int32)
    e_auto, path = auto_lj_energy(pts, CUTOFF, split=True, device=dev)
    energy_err = rel(float(e), e_ref)
    count_err = rel(combine_count(c), n_ref)
    check(bool(ok) and bool(ok_c), "tile coverage failed at the cubic parity size")
    check(energy_err <= TOL_REL, f"cubic energy_rel_err_vs_oracle {energy_err}")
    check(count_err <= TOL_REL, f"cubic count_rel_err_vs_oracle {count_err}")
    check(path.startswith("tile(MAXJ="), f"auto_lj_energy took {path} on the cube")
    # the same f32 terms summed in f64, each total rounded to f32 once
    check(rel(e_auto, float(e)) <= 2.0**-22, f"auto_lj_energy {e_auto} vs {float(e)}")
    emit("cubic_parity", n=N_PARITY, side=side, MAXJ=pmaxj,
         energy_rel_err_vs_oracle=energy_err, count_rel_err_vs_oracle=count_err,
         oracle_pairs=n_ref, auto_path=path,
         auto_energy_rel_err_vs_oracle=rel(e_auto, e_ref))

    # -- 10. the forces kernels against their plain versions, n = 2e5 ---------------
    emit("forces_vs_plain", **forces_vs_plain(dev, N_CHECK))

    # -- 11. the MD main paths at n = 1e7: thin (K3) and cubic (K7) ----------------
    md = md_main_path(dev, N_MAIN)
    emit("md_main_path", **md)
    md_cubic = md_cubic_main_path(dev, N_MAIN)
    emit("md_cubic_main_path", **md_cubic)
    emit("md_profile", **md_profile(dev, N_MAIN))

    # -- 12. K3 and K7 alone at the MD paths' shapes, n = 1e7 ----------------------
    k3 = lag_forces_alone(dev, N_MAIN)
    emit("lag_forces_alone", **k3)
    k7 = tile_forces_alone(dev, N_MAIN)
    emit("tile_forces_alone", **k7)

    # -- 13. f64-grade forces against the exact-f64 oracle, n = 1e6 ----------------
    emit("forces_parity", **forces_parity(dev, N_PARITY))

    # -- 14. every ported kernel ---------------------------------------------------
    split_k1 = k1["split"]
    f32_k3 = k3["f32"]
    print(json.dumps({"kernels": [{
        "name": "lag_reduce",
        "route": "cuda",
        "source": "zelll_tpu_torch/csrc/lag_reduce.cu",
        "replaces": "zelll_tpu/ops/pallas_pairs.py:230",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": split_k1["ms"],
        "plain_ms": split_k1["plain_ms"],
        "bound_ms": split_k1["bound_ms"],
        "bound_by": split_k1["bound_by"],
        "library_ms": None,
    }, {
        "name": "tile_reduce",
        "route": "cuda",
        "source": "zelll_tpu_torch/csrc/tile_reduce.cu",
        "replaces": "zelll_tpu/ops/tile_pairs.py:259",
        "also_replaces": "zelll_tpu/ops/tile_pairs.py:67 (packed=False)",
        "launches": tile_launches,
        "max_abs_err": tile_max_abs_err,
        "ms": k6_ms,
        "plain_ms": k6_plain_ms,
        "bound_ms": k6_bound["bound_ms"],
        "bound_by": k6_bound["bound_by"],
        "library_ms": None,
    }, {
        "name": "lag_forces",
        "route": "cuda",
        "source": "zelll_tpu_torch/csrc/lag_forces.cu",
        "replaces": "zelll_tpu/ops/pallas_pairs.py:583",
        "launches": md["launches"]["lag_forces"],
        "max_abs_err": f32_k3["max_abs_err"],
        "ms": f32_k3["ms"],
        "plain_ms": f32_k3["plain_ms"],
        "bound_ms": f32_k3["bound_ms"],
        "bound_by": f32_k3["bound_by"],
        "library_ms": None,
    }, {
        "name": "tile_forces",
        "route": "cuda",
        "source": "zelll_tpu_torch/csrc/tile_forces.cu",
        "replaces": "zelll_tpu/ops/tile_pairs.py:1025",
        "also_replaces": "zelll_tpu/ops/tile_pairs.py:1295 (packed=False)",
        "launches": md_cubic["launches"]["tile_forces"],
        "max_abs_err": k7["max_abs_err"],
        "ms": k7["ms"],
        "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"],
        "bound_by": k7["bound_by"],
        "library_ms": None,
    }]}), flush=True)

    # -- 15. the card, then the contract line -----------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
