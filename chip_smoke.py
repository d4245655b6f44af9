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
exact-f64 oracle at n = 1e6. Then the reference-parity API: the
per-particle kernel K2 against its plain version (n = 2e5, f32 and f64),
`CellGrid` on the card at n = 1e6 in f64 (build, both `rebuild` paths,
`coordination_numbers` through K2, `pairs`, `lj_energy`, `virial`,
`stress`, point queries), each held to the exact-f64 oracle, its edges
(a cube at a wide lag, iteration and the per-cell surface, `md_step` in
2-D and `auto_lj_energy` in 4-D against the port's own CPU run), and K2
alone at n = 1e7. Then the queries and the psssh workload: the query join
K12 against its plain version (n = 2e5, count, nearest and sdf, f32 and
f64), the psssh ``eval`` protocol (a 64^3 query grid, cutoffs 1-10, on a
2000-atom and a 200,000-atom synthetic protein) held to a numpy SDF over
the oracle's candidates, both batched samplers at the psssh benchmark's
defaults, `CellGrid`'s batch counts and nearest distances at n = 1e6
against the oracle, and K12 alone at the eval size. Then the open-boundary
observables: the stress kernels K4 and K8 and the histogram kernels K5 and
K9 against their plain versions (n = 2e5), the observables protocols at
n = 1e7 through the entry points (`virial_rebuild`, `fused_stress_open`
on both paths, `pair_distance_histogram` on both paths and species
partial, `md_run_langevin` over the thin MD start state with the pressure
tensor and histogram of its end state, and `CellGrid.distance_histogram`
at n = 1e6), each call's launches counted alone, their f64-grade parity
with the exact-f64 oracle at n = 1e6, and each kernel alone at n = 1e7
against its bound. Then periodic boxes (`ops.pbc`, the periodic MD
loops): the new kernel instances (K1 with the periodic keep mask, with
the minimum image and with both; K3 with the minimum image; K6 with the
keep mask) against their plain versions at n = 2e5 on four inputs, a
seam lattice among them (`pbc_vs_plain`), the protocols of the JAX
package's periodic benchmarks at n = 1e7 through the entry points, the
launches counted over each timed window (`pbc_main_path`: the rebuild, the MD step
and the Verlet-skin steady state of the thin box, with ghost images and
with the minimum image, and of the cube), their f64-grade parity on every
path at n = 1e6 against the oracle run on numpy ghost images
(`pbc_parity`), and each instance alone at n = 1e7 (`pbc_alone`). It
prints one JSON line per phase. Any failed phase
exits non-zero. The last line is the contract line
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
each pair from both ends cannot look better than it is. All four of K1,
K3, K6 and K7 are cluster-pair sweeps, each held to its plain version also
on the inputs that fail a cluster prune that is not conservative
(`prune_cases`); their alone phases print the lane evaluations the prune
leaves (counted by ``ops/cluster_prune.py``) and their ptxas lines.

The stress kernels (K4, K8) are held to their plain versions on f64
outputs like the forces kernels; the histogram kernels (K5, K9) on exact
counts. Their bounds count the half-stencil candidates and, per cutoff
pair, the stress products or the binary search over the edges.
"""

from __future__ import annotations

import cProfile
import itertools
import json
import os
import pstats
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
# K2 with the count term per cutoff pair: one f64 add at each end, each
# counted as 2 (FP64 runs at half the FP32 rate). Its candidates cost what
# K1's f32 ones do, twice that in f64.
INSTR_PER_COUNT_PAIR = 2 * 2
# The stress kernels (K4, K8) per cutoff pair: the force factor (11, as
# above), g d_a for 3 axes, (g d_a) d_b for the 6 components, and 6 f64
# adds counted twice. The histogram kernels (K5, K9) per pair inside the
# cutoff: the binary search's ceil(log2 K) FP32 compares (the bin's shared
# atomic runs on another pipe).
INSTR_PER_STRESS_PAIR = 11 + 3 + 6 + 6 * 2
# K12 per query-particle candidate in a query's band ranges: the same 7
# as a half-stencil candidate above. Per particle inside the cutoff: count
# 1 add, nearest 1 min; sdf the d > 0 test, rsqrt, d = dsq rs, -d/r, two
# exps (a multiply and ex2 each), c1 (2), c3, c2, the 3 value sums and the 9
# gradient FMAs. FP64 instructions count twice (half the FP32 rate).
INSTR_PER_JOIN_PAIR = {"count": 1, "nearest": 1,
                       "sdf": 1 + 1 + 1 + 1 + 4 + 2 + 1 + 1 + 3 + 9}
# The psssh protocols (the JAX package's benchmarks/sdf_queries.py and
# psssh_sample.py): a 64^3 query grid over the structure's box, cutoffs
# 1, 2, 5 and 10; 1024 chains, 200 burn-in draws, 50 draws at cutoff 4.
EVAL_L = 64
EVAL_CUTOFFS = (1.0, 2.0, 5.0, 10.0)
N_PROTEIN = 2000
N_PROTEIN_LARGE = 200_000
N_JOIN_QUERIES = 4096
SAMPLE_CHAINS, SAMPLE_BURNIN, SAMPLE_DRAWS, SAMPLE_CUTOFF = 1024, 200, 50, 4.0
TOL_SDF_F32 = 1e-4  # f32 SDF sums of ~1e3 terms in another order, 2-ulp exp
TOL_REL = 1e-6  # against the exact-f64 oracle
TOL_KERNEL = 1e-10  # a kernel against its plain version, f64 totals
TOL_FAST = 6 * 4 * 2.0**-23  # the same with lj_term_fast (see above)
TOL_FAST_FORCES = 8 * 4 * 2.0**-23  # forces with lj_force_factor_fast
TOL_NEWTON = 1e-6  # |sum_i f_i| against sum_i |f_i| on a lattice
# Each row's force error against its own scale, the sum over its pairs of
# both LJ parts' magnitudes (24 r^-8 (2 r^-6 + 1) r). Split mode evaluates
# each pair term in f32: dsq carries a few roundings, which the r^-14 part
# amplifies sevenfold, so a term may be off by about 2e-6 of itself. A pair
# dropped or misplaced at a seam costs at least 5e-4 of a lattice row's
# scale (a pair at r = 10 beside the neighbours at spacing 4.6).
TOL_ROW = 1e-5
# The MD protocol (the JAX package's benchmarks/steady_state.py)
MD_DT = 1e-4
MD_SKIN = 0.5
MD_STEPS = 10
SKIN_STEPS = 50
# The observables protocols (the JAX package's benchmarks/observables_bench.py
# and rdf_bench.py): a cube at MAXJ 24 for the stress and virial, K = 32
# edges over [0, 10] and MAXJ 12 for the tile histogram, 5 timed calls each.
OBS_MAXJ = 24
HIST_K = 32
HIST_MAXJ = 12
OBS_REPS = 5
# Langevin NVT over the thin MD start state: the start's own temperature
# (v ~ normal(0, 0.3)), gamma 1, a few steps
NVT_KT = 0.09
NVT_GAMMA = 1.0
NVT_STEPS = 5
TOL_SPLIT = 2e-6  # split stress and virial against the f64 oracle (tpu_parity)
TOL_HIST = 1e-4  # split histograms: cumulative deviation over the total
PLAIN_LIMIT_S = 10.0  # a plain pass slower than this at n = 1e7 is timed at 1e6


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
    device = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    by_kernel = sorted(((e.self_device_time_total / (steps * 1e3), e.key[:90])
                        for e in device), reverse=True)
    busy_ms = sum(ms for ms, _ in by_kernel)
    wall_ms = start.elapsed_time(end) / steps
    return dict(step_ms=wall_ms,
                device_busy_share=busy_ms / wall_ms if busy_ms else "not measured",
                device_ops_per_step=sum(e.count for e in device) / steps,
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


def prune_cases(shi: torch.Tensor, slo: torch.Tensor) -> dict:
    """Sorted split coordinates that fail a prune of K3 or K7 that is not
    conservative, made from a sorted lattice whose keys the caller keeps:
    the facing clusters of `cluster_gap` (boxes one cutoff apart, pairs at
    cutoff (1 -+ 2^-23) and (1 -+ 2^-25) across the gap), and the lattice
    moved by up to a skin of 0.5 since its keys were built."""
    from zelll_tpu_torch.ops.lag_pairs import split_f64
    from zelll_tpu_torch.utils.datagen import cluster_gap

    pts = shi.double() + slo.double()
    gap = cluster_gap(pts.cpu().numpy(), CUTOFF, (128 * 8, 128 * 40))
    drift = pts + torch.as_tensor(np.random.default_rng(5).uniform(
        -0.25, 0.25, tuple(pts.shape)), device=pts.device)
    return {"cluster_gap": split_f64(torch.as_tensor(gap, device=shi.device)),
            "drifted": split_f64(drift)}


def forces_vs_plain(dev, n: int) -> dict:
    """K3 and K7 against their plain versions on identical sorted inputs,
    f64 outputs on both sides, max |df| <= TOL_KERNEL max |f_plain|
    (TOL_FAST_FORCES with the fast factor), on the uniform cloud, the
    lattice, a sentinel tail, an undersized MAXJ or L and the two
    `prune_cases`; Newton's third law on the lattices; K3 against K7 on one
    thin box."""
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

    def lag_cases(shi, slo, keys, strides, tag, L=L_MAIN):
        out = {}
        for lo in (slo, None):
            for gfn, tol in factors:
                what = f"{tag} {'split' if lo is not None else 'f32'} {gfn.__name__}"
                got = pair_lag_forces(shi, keys, strides, csq, lo, L=L, gfn=gfn,
                                      out_dtype=f64)
                want = pair_lag_forces_plain(shi, keys, strides, csq, lo, L=L,
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
    # the lag bound below the key window, and the inputs that fail a prune
    # that is not conservative
    k3.update(lag_cases(shi, slo, keys, info.strides, "lattice L64", L=64))
    for tag, case in prune_cases(shi, slo).items():
        k3.update(lag_cases(*case, keys, info.strides, f"lattice {tag}"))
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
    for tag, case in prune_cases(shi, slo).items():
        k7.update(tile_cases(*case, keys, info.strides, f"lattice {tag}", maxj=maxj,
                             factors=factors[:1]))
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


def _kernel_wrappers():
    """Every kernel wrapper by its name in the launch counts."""
    from zelll_tpu_torch.ops.join import join_reduce
    from zelll_tpu_torch.ops.lag_pairs import (
        pair_lag_forces, pair_lag_hist, pair_lag_per_particle, pair_lag_reduce,
        pair_lag_stress,
    )
    from zelll_tpu_torch.ops.tile_pairs import (
        tile_pair_forces, tile_pair_hist, tile_pair_reduce, tile_pair_stress,
    )

    return dict(lag_reduce=pair_lag_reduce, lag_forces=pair_lag_forces,
                lag_per_particle=pair_lag_per_particle, lag_stress=pair_lag_stress,
                lag_hist=pair_lag_hist, tile_reduce=tile_pair_reduce,
                tile_forces=tile_pair_forces, tile_stress=tile_pair_stress,
                tile_hist=tile_pair_hist, join_reduce=join_reduce)


def reset_launches() -> None:
    """Zero every kernel's launch count, the join's fallback count and the
    histogram ladder's retries."""
    from zelll_tpu_torch import CellGrid
    from zelll_tpu_torch.ops.join import join_reduce

    for fn in _kernel_wrappers().values():
        fn.launches = 0
    join_reduce.fallbacks = 0
    CellGrid.distance_histogram.retries = 0


def read_launches() -> dict:
    from zelll_tpu_torch import CellGrid
    from zelll_tpu_torch.ops.join import join_reduce

    return dict(**{name: fn.launches for name, fn in _kernel_wrappers().items()},
                join_fallbacks=join_reduce.fallbacks,
                hist_ladder_retries=CellGrid.distance_histogram.retries)


def counted(fn, kernel: str):
    """``fn()`` with the launch counts zeroed just before it and read just
    after: its result, which must have come from exactly one launch of
    ``kernel`` and nothing else."""
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = read_launches()
    others = sum(v for k, v in counts.items() if k != kernel)
    check(counts[kernel] == 1 and others == 0,
          f"expected one launch of {kernel} alone, counted {counts}")
    return out


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


def time_skin(run, state, steps: int, what: str = "", expect=None) -> dict:
    """One Verlet-skin run of ``steps`` steps (after a 2-step warm-up run):
    device and host ms per step, rebuilds, the final energy and flag. With
    ``expect`` (one run's launches per step and per run) the counts are
    zeroed just before the warm-up and read just after the timed run; they
    must be steps + 2 times the per-step ones and twice the per-run ones."""
    if expect is not None:
        reset_launches()
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
    check(bool(ok), f"a coverage flag dropped in the skin loop {what}")
    check(np.isfinite(energy), f"non-finite energy after the skin loop {what}")
    out = dict(step_ms=start.elapsed_time(end) / steps, host_step_ms=host_ms,
               steps=steps, skin=MD_SKIN, rebuilds=rebuilds, energy=energy, ok=bool(ok))
    if expect is not None:
        per_step, per_run = expect
        counts = read_launches()
        want = {k: (steps + 2) * per_step.get(k, 0) + 2 * per_run.get(k, 0) for k in counts}
        check(counts == want, f"skin loop launches {counts} != {want} {what}")
        out["launches"] = {k: v for k, v in counts.items() if v}
    return out


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
    ms, one plain call's ms, the work of the function and its bound, the
    lane evaluations its cluster prune leaves, its ptxas lines, and the
    kernel against the plain version (f64 outputs)."""
    from zelll_tpu_torch.core import key_window
    from zelll_tpu_torch.ops import lag_pairs
    from zelll_tpu_torch.ops.cluster_prune import CLUSTER, lag_cluster_entries
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
               evaluations_per_candidate=2 * window / candidates,
               ptxas=ptxas_summary(lag_pairs.load_forces_kernel.log))
    for tag, lo in (("f32", None), ("split", slo)):
        # the lanes the prune leaves: each own cluster's sweep entries, once
        # for each of its 32 lanes (ops/cluster_prune.py, the kernel's boxes)
        entries = lag_cluster_entries(shi.t(), None if lo is None else lo.t(), keys,
                                      strides, csq, L_MAIN)
        pruned = int(entries.sum()) * CLUSTER
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
                        max_abs_err=err, max_abs_force=scale,
                        sweep_entries_per_slot=int(entries.sum()) / n,
                        pruned_evaluations=pruned,
                        pruned_evaluations_per_candidate=pruned / candidates)
    return out


def tile_forces_alone(dev, n: int) -> dict:
    """K7 alone on the cubic MD start state's sorted inputs (n = 1e7, f32,
    maskless, the exact factor, as `md_step_cubic_tile` runs it): its ms,
    one plain call's ms, the work and the bound, the lane evaluations of
    full 128 x 128 tiles and those its cluster prune leaves, its ptxas lines,
    and the kernel against the plain version (f64 outputs)."""
    from zelll_tpu_torch.ops import tile_pairs
    from zelll_tpu_torch.ops.cluster_prune import CLUSTER, tile_cluster_entries
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
    # the lanes the prune leaves: each own cluster's sweep entries, once for
    # each of its 32 lanes (ops/cluster_prune.py, the kernel's boxes)
    entries = int(tile_cluster_entries(inp, csq).sum())
    pruned = entries * CLUSTER
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
                evaluations_per_candidate=evaluations / candidates,
                sweep_entries_per_slot=entries / n, pruned_evaluations=pruned,
                pruned_evaluations_per_candidate=pruned / candidates, max_abs_err=err,
                max_abs_force=scale, newton_share=newton,
                ptxas=ptxas_summary(tile_pairs.load_forces_kernel.log))


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


def per_particle_vs_plain(dev, n: int) -> dict:
    """K2 against its plain version on identical sorted inputs, n = 2e5 on
    the thin box: the uniform cloud, a jittered lattice, and the lattice
    with a `CellGrid`-style padded tail (SENTINEL_KEY keys on far, spread
    coordinates), in f32 and f64. `count_term` exactly; `lj_term` to
    TOL_KERNEL of max |out| in f64 (1e-6 in f32: the same f64 sums, each
    rounded to f32 once); an undersized L drops the same pairs on both
    sides."""
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY
    from zelll_tpu_torch.ops.lag_pairs import (
        count_term, lj_term, pair_lag_per_particle, pair_lag_per_particle_plain,
    )
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    csq = CUTOFF**2
    box = lj_box(n, CUTOFF)
    cases, worst, lattice_f64_lj_err = {}, 0.0, 0.0
    for tag, pts in (("uniform", generate_points_random(n, box)),
                     ("lattice", generate_points_lattice(n, box))):
        shi, slo, keys, info, _ = sort_split(pts, dev)
        inputs = [(tag, keys, None)]
        if tag == "lattice":
            tail = keys.clone()
            tail[-1000:] = SENTINEL_KEY
            k = torch.arange(1, 1001, dtype=torch.float64, device=dev)
            far = torch.stack([1e12 + k * 2.0**17, 1e12 + 0 * k, 1e12 + 0 * k], 1)
            inputs.append(("lattice sentinel_tail", tail, far))
        for name, k_in, far in inputs:
            for dtype in (torch.float32, torch.float64):
                pos = shi if dtype == torch.float32 else shi.double() + slo.double()
                if far is not None:
                    pos = pos.clone()
                    pos[-1000:] = far.to(dtype)
                for L in (L_MAIN, 16):
                    for term in (count_term, lj_term):
                        what = f"{name} {str(dtype)[6:]} L{L} {term.__name__}"
                        got = pair_lag_per_particle(pos, k_in, info.strides, csq, L=L,
                                                    term=term)
                        want = pair_lag_per_particle_plain(pos, k_in, info.strides, csq,
                                                           L=L, term=term)
                        torch.cuda.synchronize()
                        check(got.dtype == dtype and got.shape == (n,),
                              f"K2 output {got.dtype} {tuple(got.shape)} ({what})")
                        err = float((got.double() - want.double()).abs().max())
                        scale = float(want.double().abs().max())
                        if term is count_term:
                            check(err == 0.0, f"K2 counts off their plain version by "
                                  f"{err} ({what})")
                            cases[what] = dict(coordination_total=float(want.double().sum()))
                        else:
                            tol = TOL_KERNEL if dtype == torch.float64 else 1e-6
                            check(np.isfinite(err) and err <= tol * scale,
                                  f"K2 lj_term off its plain version: {err} > {tol} x "
                                  f"{scale} ({what})")
                            cases[what] = dict(max_abs_err=err, max_abs_out=scale,
                                               err_over_max=err / scale)
                            worst = max(worst, err / scale)
                            if name == "lattice" and dtype == torch.float64 and L == L_MAIN:
                                lattice_f64_lj_err = err
            full = cases[f"{name} float64 L{L_MAIN} count_term"]["coordination_total"]
            short = cases[f"{name} float64 L16 count_term"]["coordination_total"]
            check(short < full, f"L = 16 dropped no pairs ({name}): {short} vs {full}")
    return dict(n=n, cases=cases, max_err_over_max=worst,
                lattice_f64_lj_max_abs_err=lattice_f64_lj_err)


def host_ms(fn):
    """Host-clock ms of ``fn`` ending in a device synchronise, and its
    result (the API's methods read their results back anyway)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def pair_codes(i, j, n: int) -> np.ndarray:
    """Unordered pairs as sorted int64 codes min * n + max."""
    i, j = np.asarray(i, np.int64), np.asarray(j, np.int64)
    return np.sort(np.minimum(i, j) * n + np.maximum(i, j))


def api_main_path(dev, n: int) -> dict:
    """The reference-parity API on the card (f64), on the main path's thin
    box at n = 1e6: build, `rebuild` (the same positions: the fast path;
    jittered: the slow path), `coordination_numbers` (K2),
    `pairs(within_cutoff=True)`, `lj_energy`, `virial`, `stress` and
    `query_neighbors_batch`, each timed on the host clock, then held to the
    exact-f64 oracle: the pair set and the coordination numbers exactly,
    the energy to TOL_REL, 16 of 4096 point queries as candidate sets. The
    launch counts are zeroed just before and read just after."""
    from zelll_tpu_torch import CellGrid, oracle
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    box = lj_box(n, CUTOFF)
    pts = generate_points_random(n, box)
    moved = pts + np.random.default_rng(2).uniform(-1e-3, 1e-3, pts.shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms = {}
    ms["build"], cg = host_ms(lambda: CellGrid(pts, CUTOFF, device=dev))
    table = cg.grid_data.bins.cell_keys
    ms["rebuild_same"], _ = host_ms(lambda: cg.rebuild(pts))
    fast = cg.grid_data.bins.cell_keys is table
    ms["rebuild_moved"], _ = host_ms(lambda: cg.rebuild(moved))
    slow = cg.grid_data.bins.cell_keys is not table
    ms["coordination_numbers"], coord = host_ms(cg.coordination_numbers)
    ms["pairs_within_cutoff"], (pi, pj) = host_ms(lambda: cg.pairs(within_cutoff=True))
    ms["lj_energy"], energy = host_ms(cg.lj_energy)
    ms["virial"], virial = host_ms(cg.virial)
    ms["stress"], stress = host_ms(cg.stress)
    rng = np.random.default_rng(3)
    lo, hi = moved.min(0), moved.max(0)
    queries = rng.uniform(lo - CUTOFF, hi + CUTOFF, (4096, 3))
    ms["query_neighbors_batch_4096"], (qids, qok) = host_ms(
        lambda: cg.query_neighbors_batch(queries))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(fast, "rebuild with unchanged positions did not keep the cell table")
    check(slow, "rebuild with moved positions kept the old cell table")
    check(launches["lag_per_particle"] > 0, "the API path never launched K2")

    oi, oj = oracle.pairs(moved, CUTOFF)
    same_pairs = np.array_equal(pair_codes(pi, pj, n), pair_codes(oi, oj, n))
    check(same_pairs, f"pairs(within_cutoff=True): {len(pi)} pairs, the oracle {len(oi)}")
    want_coord = np.bincount(np.concatenate([oi, oj]), minlength=n)
    check(np.array_equal(coord, want_coord), "coordination_numbers differ from the "
          f"oracle's pairs at {int((coord != want_coord).sum())} particles")
    e_ref, n_ref = oracle.lj_energy(moved, CUTOFF)
    energy_err = rel(energy, e_ref)
    check(n_ref == len(oi) and energy_err <= TOL_REL,
          f"CellGrid lj_energy {energy} vs oracle {e_ref}")
    trace_err = rel(float(np.trace(stress)), virial)
    check(np.isfinite(virial) and trace_err <= 1e-9,
          f"trace(stress) {np.trace(stress)} vs virial {virial}")
    picked = rng.choice(4096, 16, replace=False)
    for q in picked:
        want = oracle.query_neighbors(moved, CUTOFF, queries[q])
        check((want is None) == (not qok[q]), f"query {q}: valid {qok[q]}, oracle {want}")
        if want is not None:
            check(np.array_equal(np.sort(qids[q]), np.sort(want)),
                  f"query {q}: {len(qids[q])} candidates, the oracle {len(want)}")
    # where one chunk loop's time goes (lj_energy: ~n / 10 / 256 chunks)
    prof = profile_steps(lambda i: cg.lj_energy(), 1)
    num_cells = int(cg.grid_data.bins.num_cells)
    return dict(n=n, box=box, ms=ms, launches=launches, max_memory_allocated=peak,
                lj_energy_profile=prof,
                K=cg._K, occupied_cells=num_cells,
                chunk_loop_iterations=-(-num_cells // cg._chunk()),
                pairs=len(pi), oracle_pairs=n_ref, pair_set_equal=same_pairs,
                coordination_equal=True, energy=energy,
                energy_rel_err_vs_oracle=energy_err, virial=virial,
                trace_stress_rel_err_vs_virial=trace_err,
                queries_valid=int(np.sum(qok)), queries_checked=len(picked))


def api_edges(dev) -> dict:
    """The rest of the API on the card: `coordination_numbers` on a cube at
    n = 1e5 (a wide lag) against the oracle's pairs; `__iter__` and the
    per-cell surface at n = 2e3 against brute force; `md_step` with dim = 2
    and `auto_lj_energy` with dim = 4 at n ~ 1e4 against the port's own CPU
    run of the same inputs, to 1e-12."""
    from zelll_tpu_torch import CellGrid, MDState, auto_lj_energy, md_step, oracle

    out = {}
    n = 100_000
    side = (n / 0.01) ** (1 / 3)
    cube = np.random.default_rng(4).uniform(0, side, (n, 3))
    cg = CellGrid(cube, CUTOFF, device=dev)
    ms, coord = host_ms(cg.coordination_numbers)
    oi, oj = oracle.pairs(cube, CUTOFF)
    check(np.array_equal(coord, np.bincount(np.concatenate([oi, oj]), minlength=n)),
          "cube coordination_numbers differ from the oracle's pairs")
    from zelll_tpu_torch.ops.lag_pairs import suggest_lag

    g = cg.grid_data
    out["cube_coordination"] = dict(n=n, side=side, ms=ms, pairs=len(oi),
                                    L=suggest_lag(g.bins.sorted_keys, g.info.strides))

    n = 2000
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1, (n, 3)) * [30.0, 30.0, 60.0]
    cg = CellGrid(pts, CUTOFF, device=dev)
    d = pts[:, None] - pts[None]
    dsq = (d * d).sum(-1)
    iu, ju = np.nonzero(np.triu(dsq < CUTOFF**2, 1))
    within = set(zip(iu.tolist(), ju.tolist()))
    items = list(cg)
    ids = np.array([[a, b] for (a, _), (b, _) in items], np.int64)
    coords = np.array([[p, q] for (_, p), (_, q) in items])
    cand = list(zip(ids.min(1).tolist(), ids.max(1).tolist()))
    check(len(set(cand)) == len(cand) and within <= set(cand),
          "__iter__ repeats a pair or misses a cutoff pair")
    check(np.array_equal(coords, pts[ids]), "__iter__ yields wrong coordinates")
    strides = cg.grid_data.info.strides.cpu().numpy().astype(np.int64)
    keys = np.floor((pts - pts.min(0)) / CUTOFF).astype(np.int64) @ strides
    members, per_cell = {}, []
    for cell in cg.cells():
        for i, _ in cell:
            members[i] = cell.index
        per_cell += [(min(a, b), max(a, b)) for (a, _), (b, _) in cell.particle_pairs()]
    check(sorted(members) == list(range(n))
          and all(keys[i] == k for i, k in members.items()),
          "cells() does not partition the particles by key")
    check(sorted(per_cell) == sorted(cand), "per-cell pairs differ from __iter__")
    for i in (0, 7, 1999):
        got = sorted(k for k, _ in cg.neighbors(pts[i]))
        check(got == np.nonzero(dsq[i] <= CUTOFF**2)[0].tolist(),
              f"neighbors({i}) differs from brute force")
    out["iteration_and_cells"] = dict(n=n, candidates=len(cand), cutoff_pairs=len(within),
                                      cells=len(set(members.values())))

    side = 100
    g2 = np.stack(np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), -1)
    pts2 = g2.reshape(-1, 2) * 1.1 + rng.uniform(-0.05, 0.05, (side * side, 2))
    vel2 = rng.normal(0, 0.2, pts2.shape)
    runs = []
    for where in (dev, "cpu"):
        st, ok = md_step(MDState.create(pts2, vel2, device=where), 1.6, 1e-3, K=8)
        runs.append((st.positions.cpu().numpy(), st.velocities.cpu().numpy(), bool(ok)))
    (pg, vg, okg), (pc, vc, okc) = runs
    md_err = max(float(np.abs(pg - pc).max() / np.abs(pc).max()),
                 float(np.abs(vg - vc).max() / np.abs(vc).max()))
    check(okg and okc and md_err <= 1e-12, f"md_step dim = 2: card vs CPU {md_err}")
    out["md_step_dim2"] = dict(n=len(pts2), rel_err_card_vs_cpu=md_err)
    pts4 = np.random.default_rng(6).uniform(0, 1, (10_000, 4)) * [40.0, 40.0, 40.0, 4.0]
    e_g, path_g = auto_lj_energy(pts4, 1.0, max_thin_lag=0, device=dev)
    e_c, path_c = auto_lj_energy(pts4, 1.0, max_thin_lag=0, device="cpu")
    e_err = rel(e_g, e_c)
    check(path_g == path_c and path_g.startswith("xla(K=") and e_err <= 1e-12,
          f"auto_lj_energy dim = 4: {e_g} ({path_g}) vs CPU {e_c} ({path_c})")
    out["auto_lj_energy_dim4"] = dict(n=len(pts4), path=path_g, energy=e_g,
                                      rel_err_card_vs_cpu=e_err)
    return out


def per_particle_alone(dev, n: int) -> dict:
    """K2 alone on the thin box's sorted inputs (n = 1e7, the main path's
    keys), f32 and f64 coordinates, `count_term` (the API's term): its ms,
    one plain call's ms, the work of the function and its bound, and the
    kernel against the plain version. The bound counts each unique pair
    once: the half-stencil candidates and, per cutoff pair, the term and
    the two adds; FP64 instructions count twice (half the FP32 rate)."""
    from zelll_tpu_torch.ops.lag_pairs import pair_lag_per_particle, pair_lag_per_particle_plain
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    pts = generate_points_random(n, lj_box(n, CUTOFF))
    shi, slo, keys, info, _ = sort_split(pts, dev)
    del pts
    strides = info.strides
    csq = CUTOFF**2
    candidates = stencil_candidates(keys, info)
    out = dict(n=n, candidates=candidates, candidates_per_slot=candidates / n)
    for tag, pos in (("f32", shi), ("f64", shi.double() + slo.double())):
        ms = cuda_ms(lambda: pair_lag_per_particle(pos, keys, strides, csq, L=L_MAIN), 10)
        plain_ms, want = once_ms(lambda: pair_lag_per_particle_plain(
            pos, keys, strides, csq, L=L_MAIN))
        got = pair_lag_per_particle(pos, keys, strides, csq, L=L_MAIN)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        check(err == 0.0, f"K2 {tag} counts at n = {n} off the plain version by {err}")
        pairs = int(round(float(want.double().sum()))) // 2
        size = 4 if tag == "f32" else 8
        width = 1 if tag == "f32" else 2
        b = bound(n * (4 * size + 4),
                  width * candidates * INSTR_PER_CANDIDATE[False]
                  + pairs * INSTR_PER_COUNT_PAIR)
        out[tag] = dict(ms=ms, plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms,
                        pairs=pairs, max_abs_err=err)
    return out



# -- slice 8: the query join (K12) and the psssh workload ----------------------


def protein(n: int, seed: int = 0):
    """The benchmarks' synthetic globular structure at their density: 2000
    atoms in a 15 A ball, the radius scaled as n^(1/3) for other sizes."""
    from zelll_tpu_torch.utils.datagen import synthetic_protein

    return synthetic_protein(n, 15.0 * (n / N_PROTEIN) ** (1 / 3), seed=seed)


def join_inputs(pos, radii, queries, cutoff: float, dtype, dev, tail: int = 0):
    """Sorted join inputs on the card, as `SmoothDistanceField` and
    `query_join_reduce` prepare them: (query planes, query keys, particle
    planes x, y, z, r, 1/r, particle keys, strides, cutoff^2), with
    ``tail`` far rows of SENTINEL_KEY after the atoms, as `CellGrid` pads."""
    from zelll_tpu_torch.core import build
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY
    from zelll_tpu_torch.ops.join import sort_queries

    g = build(torch.as_tensor(pos, device=dev), cutoff)
    info = g.info
    qplanes, qkeys, _, _ = sort_queries(torch.as_tensor(queries, device=dev), info.origin,
                                        info.shape, info.strides, cutoff, dtype, dev)
    sp = g.sorted_pos.to(dtype)
    r = torch.as_tensor(radii, device=dev)[g.bins.perm.long()].to(dtype)
    far = 1e12 + torch.arange(tail, device=dev, dtype=dtype) * 1e5
    zeros, ones = torch.zeros_like(far), torch.ones_like(far)
    pplanes = [torch.cat([sp[:, 0], far]), torch.cat([sp[:, 1], zeros]),
               torch.cat([sp[:, 2], zeros]), torch.cat([r, ones]), torch.cat([1 / r, ones])]
    pkeys = torch.cat([g.bins.sorted_keys,
                       torch.full((tail,), SENTINEL_KEY, dtype=torch.int32, device=dev)])
    return qplanes, qkeys, pplanes, pkeys, info.strides, torch.tensor(
        cutoff, dtype=dtype, device=dev) ** 2


def join_instances():
    from zelll_tpu_torch.ops.join import _count_term, _nearest_term
    from zelll_tpu_torch.ops.sdf_join import NACC, sdf_term

    return {"count": (_count_term, "sum", 1, 0), "nearest": (_nearest_term, "min", 1, 0),
            "sdf": (sdf_term, "sum", NACC, 2)}


def join_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, max |want|) over the finite entries of ``want``;
    an infinite entry (a query with no particle in range, nearest) must be
    matched exactly."""
    finite = torch.isfinite(want)
    same_inf = bool((got[~finite] == want[~finite]).all())
    if not bool(finite.any()):
        return (0.0 if same_inf else float("inf")), 0.0
    diff = (got.double() - want.double())[finite].abs().max()
    return (float(diff) if same_inf else float("inf"),
            float(want.double()[finite].abs().max()))


def join_vs_plain(dev, n: int) -> dict:
    """K12 against its plain version on identical sorted inputs: a synthetic
    protein and a jittered lattice of n atoms (coordinates on a 2^-10 grid,
    so that a query at an atom + (cutoff, 0, 0) lies exactly at the cutoff),
    cutoff 10, 4096 queries: uniform over the box and one cutoff around it,
    100 at atoms (d == 0), 100 exactly at the cutoff, 196 at +-1e9, and a
    tail of 1000 SENTINEL_KEY rows on the particle side; apart, a plane of
    64 queries at an atom + (cutoff, dy, dz), and the samplers' shape (1024
    queries at the atoms + 0.5 of the 2000-atom protein, cutoff 4). count,
    nearest and sdf in f32 and f64: counts and minima exact, f64 SDF sums to
    TOL_KERNEL of the largest, f32 to TOL_SDF_F32."""
    from zelll_tpu_torch.ops.join import join_reduce, join_reduce_plain
    from zelll_tpu_torch.utils.datagen import generate_points_lattice

    rng = np.random.default_rng(12)
    side = (n / 0.1) ** (1 / 3)
    structures = {"protein": protein(n)[0],
                  "lattice": generate_points_lattice(n, (side, side, side))}
    cases, worst, lattice_err = {}, 0.0, 0.0
    configs = []
    for name, pos in structures.items():
        pos = np.round(pos * 1024) / 1024
        at = rng.choice(n, 200, replace=False)
        lo, hi = pos.min(0), pos.max(0)
        queries = np.concatenate([
            rng.uniform(lo - CUTOFF, hi + CUTOFF, (N_JOIN_QUERIES - 396, 3)),
            pos[at[:100]], pos[at[100:]] + [CUTOFF, 0.0, 0.0],
            np.array([[1e9, -1e9, 1e9], [-1e9, 1e9, -1e9]] * 98)])
        configs.append((name, pos, queries, CUTOFF))
        # a plane of 64 queries at an atom + (cutoff, dy, dz): their
        # clusters' boxes start exactly one cutoff from the atom, so a prune
        # with a strict gap test drops the pair at exactly the cutoff
        grid = np.stack(np.meshgrid(np.arange(8), np.arange(8), indexing="ij"), -1)
        plane = pos[at[0]] + np.concatenate(
            [np.full((64, 1), CUTOFF), (grid.reshape(-1, 2) - 4) / 8], 1)
        configs.append((f"{name}_cutoff_plane", pos, plane, CUTOFF))
    # the samplers' shape: 1024 queries at the atoms + 0.5 of the 2000-atom
    # protein, cutoff 4 (sparse clusters, the form whose warps share one)
    small = np.round(protein(N_PROTEIN)[0] * 1024) / 1024
    configs.append(("sampler", small, small[:SAMPLE_CHAINS] + 0.5, SAMPLE_CUTOFF))
    for name, pos, queries, cutoff in configs:
        radii = rng.uniform(1.0, 2.0, len(pos))
        for dtype in (torch.float32, torch.float64):
            qp, qk, pp, pk, strides, csq = join_inputs(pos, radii, queries, cutoff, dtype,
                                                       dev, tail=1000)
            for inst, (term, reducer, n_out, npl) in join_instances().items():
                kw = dict(term=term, n_out=n_out, reducer=reducer)
                got, ok = join_reduce(qp, qk, pp[:3 + npl], pk, strides, csq, **kw)
                want, ok_p = join_reduce_plain(qp, qk, pp[:3 + npl], pk, strides, csq, **kw)
                torch.cuda.synchronize()
                tag = f"{name} {str(dtype)[6:]} {inst}"
                check(bool(ok) and bool(ok_p), f"K12 key flags false ({tag})")
                err, scale = join_err(got, want)
                if inst == "sdf":
                    tol = TOL_KERNEL if dtype == torch.float64 else TOL_SDF_F32
                    check(bool(torch.isfinite(got).all()) and err <= tol * scale,
                          f"K12 {tag}: max |err| {err} of {scale}")
                    if dtype == torch.float64:
                        worst = max(worst, err / scale)
                        if name == "lattice":
                            lattice_err = err
                else:
                    check(torch.equal(got, want), f"K12 {tag} differs from its plain version")
                first = got[:, 0].double()
                cases[tag] = dict(max_abs_err=err, max_abs=scale,
                                  first_output_total=float(first[torch.isfinite(first)].sum()))
    return dict(n=n, cutoff=CUTOFF, queries=N_JOIN_QUERIES, cases=cases,
                sdf_f64_max_err_over_max=worst, lattice_f64_sdf_max_abs_err=lattice_err)


def sdf_reference(pos, radii, cutoff: float, query, ids):
    """The field's value and gradient at one query from its oracle candidates,
    in numpy f64 straight from the math (numdual.rs:11-61); (nan, nan) where
    no atom is within the cutoff."""
    d_vec = query[None, :] - pos[ids]
    dsq = d_vec[:, 0] * d_vec[:, 0] + d_vec[:, 1] * d_vec[:, 1] + d_vec[:, 2] * d_vec[:, 2]
    within = dsq <= cutoff * cutoff
    live = within & (dsq > 0)
    r = radii[ids]
    d = np.sqrt(np.where(live, dsq, 1.0))
    e1 = np.where(live, np.exp(-d / r), 0.0)
    e3 = np.where(live, np.exp(-d), 0.0)
    z = (within & (dsq == 0)).astype(float)
    u = d_vec / d[:, None]
    s1, s2, s3 = (e1 + z).sum(), ((e3 + z) * r).sum(), (e3 + z).sum()
    if s1 == 0:
        return np.nan, np.full(3, np.nan)
    a1 = ((e1 / r)[:, None] * u).sum(0)
    a2 = ((e3 * r)[:, None] * u).sum(0)
    a3 = (e3[:, None] * u).sum(0)
    sigma, ln1 = s2 / s3, np.log(s1)
    return -sigma * ln1, ln1 * (a2 * s3 - s2 * a3) / (s3 * s3) + sigma * a1 / s1


def sdf_eval_main_path(dev) -> dict:
    """The psssh ``eval`` protocol (`psssh.eval_grid`, the reference's
    cli.rs:150-195) on the card in f64: a 64^3 query grid over the
    structure's box, cutoffs 1, 2, 5 and 10, on the 2000-atom synthetic
    protein and on 200,000 atoms at its density (~70 A). us/query by the host
    clock (what eval_grid returns) and by CUDA events, K12's share of the
    evaluate call, peak memory; then 4096 sampled queries held to a numpy f64
    SDF over `oracle.query_neighbors_batch` candidates (value and gradient
    to TOL_KERNEL of the largest, valid equal to the oracle's None). The
    launch and fallback counts are zeroed just before each cutoff's two
    eval_grid runs (warm-up and timed) and read just after, before any
    timing or checking call: two K12 launches per cutoff, no fallback.
    K12's own device time per launch comes from the profiler: at the small
    cutoffs the wrapper's host work outlasts it."""
    from zelll_tpu_torch import SmoothDistanceField, oracle
    from zelll_tpu_torch.models.psssh import eval_grid
    from zelll_tpu_torch.ops.join import join_reduce, sort_queries
    from zelll_tpu_torch.ops.sdf_join import NACC, sdf_term

    out = {}
    rng = np.random.default_rng(13)
    for n in (N_PROTEIN, N_PROTEIN_LARGE):
        pos, radii = protein(n)
        runs = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches = {}
        for cutoff in EVAL_CUTOFFS:
            sdf = SmoothDistanceField(pos, radii, cutoff=cutoff, device=dev)
            torch.cuda.synchronize()
            reset_launches()
            eval_grid(sdf, EVAL_L)  # warm-up: the first launch loads the kernel
            grid, vals, grads, dt = eval_grid(sdf, EVAL_L)
            main = read_launches()
            check(main["join_reduce"] == 2 and main["join_fallbacks"] == 0,
                  f"the eval path (n = {n}, cutoff {cutoff}) ran {main}, not two K12 "
                  "launches and no fallback")
            for k, v in main.items():
                launches[k] = launches.get(k, 0) + v
            q = EVAL_L**3
            ev_ms = cuda_ms(lambda: sdf.evaluate(grid), 3)
            jd = sdf._join
            qp, qk, _, _ = sort_queries(torch.as_tensor(grid, device=dev), jd.origin,
                                        jd.shape, jd.strides, cutoff, torch.float64, dev)

            def k12():
                return join_reduce(qp, qk, list(jd.pplanes), jd.pkeys, jd.strides,
                                   jd.cutoff**2, term=sdf_term, n_out=NACC)

            k12_ms = cuda_ms(k12, 5)
            by_kernel = profile_steps(lambda i: k12(), 10)["ms_per_step_by_kernel"]
            k12_device_ms = sum(m for m, k in by_kernel if "join_kernel" in k)
            picked = rng.choice(q, N_JOIN_QUERIES, replace=False)
            cands = oracle.query_neighbors_batch(pos, cutoff, grid[picked])
            ref_v = np.full(len(picked), np.nan)
            ref_g = np.full((len(picked), 3), np.nan)
            for k, (qi, ids) in enumerate(zip(picked, cands)):
                if ids is not None:
                    ref_v[k], ref_g[k] = sdf_reference(pos, radii, cutoff, grid[qi], ids)
            _, _, valid = sdf.evaluate(grid[picked])
            want_valid = np.array([ids is not None for ids in cands])
            check(np.array_equal(valid, want_valid),
                  f"valid differs from the oracle at {int((valid != want_valid).sum())} queries")
            v, g = vals[picked], grads[picked]
            defined = np.isfinite(ref_v)
            check(np.array_equal(np.isfinite(v), defined),
                  f"n = {n}, cutoff {cutoff}: the field is defined at other queries")
            v_err = float(np.abs(v[defined] - ref_v[defined]).max() / np.abs(ref_v[defined]).max()
                          ) if defined.any() else 0.0
            g_err = float(np.abs(g[defined] - ref_g[defined]).max() / np.abs(ref_g[defined]).max()
                          ) if defined.any() else 0.0
            check(v_err <= TOL_KERNEL and g_err <= TOL_KERNEL,
                  f"n = {n}, cutoff {cutoff}: value err {v_err}, gradient err {g_err}")
            runs[str(cutoff)] = dict(
                us_per_query_host=dt / q * 1e6, ns_total_host=dt * 1e9,
                us_per_query_events=ev_ms / q * 1e3, evaluate_ms_events=ev_ms,
                k12_ms=k12_ms, k12_device_ms=k12_device_ms,
                k12_share_of_evaluate=k12_ms / ev_ms,
                defined=int(np.isfinite(vals).sum()), checked=len(picked),
                checked_defined=int(defined.sum()), value_err_over_max=v_err,
                gradient_err_over_max=g_err)
        out[f"n{n}"] = dict(n=n, radius=15.0 * (n / N_PROTEIN) ** (1 / 3), queries=EVAL_L**3,
                            cutoffs=runs, launches=launches,
                            max_memory_allocated=torch.cuda.max_memory_allocated())
    return out


def psssh_sample_main_path(dev) -> dict:
    """`sample_surface` on the 2000-atom protein with the defaults of the JAX
    package's benchmarks/psssh_sample.py (1024 chains, 200 burn-in, 50 draws,
    cutoff 4) for the HMC and lockstep NUTS samplers: draws/s on the host
    clock, K12 launches (zeroed just before each run, read just after), and
    the sample quality of tests/test_psssh.py: >= 95 % valid, median
    |sdf - 1.05| < 0.5. Then one leapfrog step's gradient call: host ms per
    call, the same by Python function (cProfile), and its device profile."""
    from zelll_tpu_torch import SmoothDistanceField
    from zelll_tpu_torch.models.psssh import sample_surface

    pos, radii = protein(N_PROTEIN)
    sdf = SmoothDistanceField(pos, radii, cutoff=SAMPLE_CUTOFF, device=dev)
    out = {}
    for sampler in ("hmc", "nuts-batched"):
        torch.cuda.synchronize()
        reset_launches()
        ms, pts = host_ms(lambda: sample_surface(
            sdf, chains=SAMPLE_CHAINS, burnin=SAMPLE_BURNIN, draws=SAMPLE_DRAWS, seed=0,
            sampler=sampler))
        launches = read_launches()
        vals, _, ok = sdf.evaluate(pts)
        median = float(np.median(np.abs(vals[ok] - sdf.surface_radius)))
        check(pts.shape == (SAMPLE_CHAINS * SAMPLE_DRAWS, 3) and np.isfinite(pts).all(),
              f"{sampler}: samples of shape {pts.shape}")
        check(launches["join_reduce"] > 0, f"{sampler} never launched K12")
        check(launches["join_fallbacks"] == 0, f"{sampler} took the join's fallback")
        check(ok.mean() >= 0.95 and median < 0.5,
              f"{sampler}: {ok.mean():.3f} valid, median |sdf - 1.05| {median}")
        out[sampler] = dict(seconds=ms / 1e3, draws=len(pts),
                            draws_per_s=len(pts) / (ms / 1e3), valid_share=float(ok.mean()),
                            median_abs_sdf_minus_level=median, launches=launches)
    # where one leapfrog step's gradient call goes: host ms per call, and
    # the device's kernels and busy share under the profiler
    vgrad = sdf.hmc_vgrad_fn()
    q = torch.as_tensor(pos[:SAMPLE_CHAINS] + 0.5, device=dev)
    calls = 100
    vgrad_ms, _ = host_ms(lambda: [vgrad(q) for _ in range(calls)])
    # the host's ms per call by Python function (own time; a C call made
    # through ctypes counts to its caller)
    prof = cProfile.Profile()
    host_ms(lambda: prof.runcall(lambda: [vgrad(q) for _ in range(calls)]))
    by_function = sorted(((tt / calls * 1e3, f"{os.path.basename(f)}:{line}:{fn}")
                          for (f, line, fn), (_, _, tt, _, _) in pstats.Stats(prof).stats.items()),
                         reverse=True)
    return dict(n=N_PROTEIN, cutoff=SAMPLE_CUTOFF, chains=SAMPLE_CHAINS,
                burnin=SAMPLE_BURNIN, draws=SAMPLE_DRAWS, samplers=out,
                vgrad_host_ms_per_call=vgrad_ms / calls,
                vgrad_host_ms_by_function=[[round(ms, 4), f] for ms, f in by_function[:12]],
                vgrad_profile=profile_steps(lambda i: vgrad(q), 20))


def api_queries(dev, n: int) -> dict:
    """`CellGrid.count_neighbors_batch` and `nearest_neighbor_distances` in
    f64 on the API phase's thin box (n = 1e6), 64^3 queries on a lattice over
    the box and one cutoff around it, each timed on the host clock; 4096
    sampled queries held to a numpy f64 filter over the oracle's candidates
    (counts and distances exactly, valid equal to the oracle's None); no
    join fallback."""
    from zelll_tpu_torch import CellGrid, oracle
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    pts = generate_points_random(n, lj_box(n, CUTOFF))
    cg = CellGrid(pts, CUTOFF, device=dev)
    lo, hi = pts.min(0) - CUTOFF, pts.max(0) + CUTOFF
    axes = [np.linspace(lo[a], hi[a], EVAL_L) for a in range(3)]
    queries = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    torch.cuda.synchronize()
    reset_launches()
    ms = {}
    ms["count_neighbors_batch"], (counts, valid) = host_ms(
        lambda: cg.count_neighbors_batch(queries))
    ms["nearest_neighbor_distances"], (dists, valid2) = host_ms(
        lambda: cg.nearest_neighbor_distances(queries))
    launches = read_launches()
    check(launches["join_reduce"] == 2, f"the API queries launched K12 {launches}")
    check(launches["join_fallbacks"] == 0, "the API queries took the join's fallback")
    check(np.array_equal(valid, valid2), "the two API queries disagree on valid")
    picked = np.random.default_rng(14).choice(len(queries), N_JOIN_QUERIES, replace=False)
    cands = oracle.query_neighbors_batch(pts, CUTOFF, queries[picked])
    for qi, ids in zip(picked, cands):
        check((ids is None) == (not valid[qi]), f"query {qi}: valid {valid[qi]}, oracle {ids}")
        if ids is None:
            check(counts[qi] == 0 and np.isinf(dists[qi]), f"invalid query {qi} saw particles")
            continue
        d = queries[qi][None, :] - pts[ids]
        dsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        inside = dsq[dsq <= CUTOFF * CUTOFF]
        check(counts[qi] == len(inside), f"query {qi}: count {counts[qi]}, oracle {len(inside)}")
        want = float(np.sqrt(inside.min())) if len(inside) else np.inf
        check(dists[qi] == want, f"query {qi}: nearest {dists[qi]}, oracle {want}")
    return dict(n=n, queries=len(queries), ms=ms, launches=launches,
                valid=int(valid.sum()), with_neighbours=int((counts > 0).sum()),
                checked=len(picked))


def join_alone(dev) -> dict:
    """K12 alone at the samplers' size (one gradient call: 1024 queries
    over the 2000-atom protein, cutoff 4, f64 sdf; device time from the
    profiler, the whole call's from CUDA events) and at the eval
    protocol's size (200,000 atoms, a 64^3 query grid, cutoff 10), count,
    nearest and sdf in f32 and f64, timed with CUDA events; candidates per query (the particles in each query's 9 band
    ranges, what the kernel visits), within-cutoff pairs, the bound (bytes
    in and out; operations per candidate and per pair as INSTR_PER_* count
    them) and the share; the plain version timed once per f64 instance; at
    both sizes the buffer entries each query's lane evaluates after the
    cluster prune (ops/cluster_prune.py), beside its candidates (f64 also at
    the eval protocol's other cutoffs), and K12's ptxas lines."""
    from zelll_tpu_torch.ops import join
    from zelll_tpu_torch.ops.cluster_prune import CLUSTER, join_cluster_entries
    from zelll_tpu_torch.ops.join import join_reduce, join_reduce_plain
    from zelll_tpu_torch.ops.segments import segment_bands

    def band_candidates(qk, pk, strides):
        bands = segment_bands(strides, full=True).long()
        keys64, q64 = pk.long(), qk.long()
        candidates = 0
        for lo_s, hi_s in bands.tolist():
            candidates += int((torch.searchsorted(keys64, q64 - lo_s, right=True)
                               - torch.searchsorted(keys64, q64 - hi_s)).sum())
        return candidates

    def entries_per_query(qp, qk, pp, pk, strides, csq):
        """The buffer entries of each query's cluster, over the queries: one
        lane evaluation each."""
        ent = join_cluster_entries(torch.stack(list(qp)), qk, torch.stack(pp[:3]), pk,
                                   strides, csq)
        real = torch.full_like(ent, CLUSTER)
        real[-1] = len(qk) - (len(ent) - 1) * CLUSTER
        return float((ent * real).sum()) / len(qk)

    # the samplers' size: one gradient call's join, f64 sdf, the psssh
    # protein with 1024 chains at its atoms + 0.5 (as psssh_sample_main_path's
    # vgrad_profile), cutoff 4
    pos, radii = protein(N_PROTEIN)
    qp, qk, pp, pk, strides, csq = join_inputs(pos, radii, pos[:SAMPLE_CHAINS] + 0.5,
                                               SAMPLE_CUTOFF, torch.float64, dev)
    instances = join_instances()
    count = dict(zip(("term", "reducer", "n_out"), instances["count"][:3]))
    pairs = int(join_reduce(qp, qk, pp[:3], pk, strides, csq, **count)[0].double().sum())
    candidates = band_candidates(qk, pk, strides)
    term, reducer, n_out, npl = instances["sdf"]
    kw = dict(term=term, n_out=n_out, reducer=reducer, keys_sorted=True)

    def call():
        return join_reduce(qp, qk, pp[:3 + npl], pk, strides, csq, **kw)

    # at this size the wrapper's host time exceeds the kernel's, so CUDA
    # events around calls time the host: the kernel's own device time comes
    # from the profiler (CUPTI), the call's from the events
    call_ms = cuda_ms(call, 100)
    by_kernel = profile_steps(lambda i: call(), 20)["ms_per_step_by_kernel"]
    ms = sum(m for m, k in by_kernel if "join_kernel" in k)
    check(ms > 0, f"the profiler saw no K12 launch at the samplers' size: {by_kernel}")
    b = bound(SAMPLE_CHAINS * (4 * 8 + n_out * 8) + len(pos) * ((3 + npl) * 8 + 4),
              2 * (candidates * INSTR_PER_CANDIDATE[False] + pairs * INSTR_PER_JOIN_PAIR["sdf"]))
    sampler = dict(atoms=len(pos), queries=SAMPLE_CHAINS, cutoff=SAMPLE_CUTOFF,
                   dtype="float64", instance="sdf", ms=ms, call_ms=call_ms, **b,
                   share_of_bound=b["bound_ms"] / ms, candidates=candidates, pairs=pairs,
                   candidates_per_query=candidates / SAMPLE_CHAINS,
                   entries_per_query=entries_per_query(qp, qk, pp, pk, strides, csq))

    pos, radii = protein(N_PROTEIN_LARGE)
    lo, hi = pos.min(0), pos.max(0)
    axes = [np.linspace(lo[a], hi[a], EVAL_L) for a in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    out = {"sampler_size": sampler}
    for dtype in (torch.float32, torch.float64):
        qp, qk, pp, pk, strides, csq = join_inputs(pos, radii, grid, CUTOFF, dtype, dev)
        candidates = band_candidates(qk, pk, strides)
        nq, npart = len(grid), len(pos)
        size = dtype.itemsize
        width = 1 if dtype == torch.float32 else 2
        tag = str(dtype)[6:]
        pairs = None
        for inst, (term, reducer, n_out, npl) in join_instances().items():
            kw = dict(term=term, n_out=n_out, reducer=reducer)
            planes = pp[:3 + npl]
            ms = cuda_ms(lambda: join_reduce(qp, qk, planes, pk, strides, csq, **kw), 10)
            res, _ = join_reduce(qp, qk, planes, pk, strides, csq, **kw)
            if inst == "count":
                pairs = int(res.double().sum())
            b = bound(nq * (4 * size + n_out * size) + npart * ((3 + npl) * size + 4),
                      width * (candidates * INSTR_PER_CANDIDATE[False]
                               + pairs * INSTR_PER_JOIN_PAIR[inst]))
            case = dict(ms=ms, **b, share_of_bound=b["bound_ms"] / ms)
            if dtype == torch.float64:
                case["plain_ms"], want = once_ms(lambda: join_reduce_plain(
                    qp, qk, planes, pk, strides, csq, **kw))
                err, scale = join_err(res, want[0])
                check(err <= TOL_KERNEL * scale if inst == "sdf" else torch.equal(res, want[0]),
                      f"K12 {inst} at the eval size: max |err| {err} of {scale}")
                case["max_abs_err"] = err
            out.setdefault(tag, {})[inst] = case
        out[tag]["candidates"] = candidates
        out[tag]["candidates_per_query"] = candidates / len(grid)
        out[tag]["entries_per_query"] = entries_per_query(qp, qk, pp, pk, strides, csq)
        out[tag]["pairs"] = pairs
        out[tag]["pairs_per_query"] = pairs / len(grid)
    # the eval protocol's smaller cutoffs, f64: a cluster of 32 sorted grid
    # queries spans more cells as the cells shrink, so its union ranges and
    # box grow against each query's own candidates
    for cutoff in EVAL_CUTOFFS:
        if cutoff != CUTOFF:
            qp, qk, pp, pk, strides, csq = join_inputs(pos, radii, grid, cutoff,
                                                       torch.float64, dev)
            out["float64"].setdefault("by_cutoff", {})[f"{cutoff:g}"] = dict(
                candidates_per_query=band_candidates(qk, pk, strides) / len(grid),
                entries_per_query=entries_per_query(qp, qk, pp, pk, strides, csq))
    return dict(n=N_PROTEIN_LARGE, queries=len(grid), cutoff=CUTOFF, **out,
                ptxas=ptxas_summary(join.load_kernel.log))


# -- slice 6a: the open-boundary observables (K4, K5, K8, K9) -------------------


def cube_points(n: int, seed: int = 0):
    """bench.py's cubic cloud: uniform, density 0.01. Returns (points, side)."""
    side = (n / 0.01) ** (1 / 3)
    return np.random.default_rng(seed).uniform(0, side, (n, 3)), side


def hist_edges_sq(K: int, dtype=torch.float32) -> torch.Tensor:
    """rdf_bench.py's edges, linspace(0, cutoff, K), squared in ``dtype``."""
    return torch.as_tensor(np.linspace(0.0, CUTOFF, K), dtype=dtype) ** 2


def stress_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, max |want|) over the components, in f64."""
    torch.cuda.synchronize()
    return (float((got.double() - want.double()).abs().max()),
            float(want.double().abs().max()))


def obs_vs_plain(dev, n: int) -> dict:
    """K4, K5, K8 and K9 against their plain versions on identical sorted
    inputs at n = 2e5: the uniform cloud, the jittered lattice (only it
    fails a wrong term) and the lattice with a SENTINEL_KEY tail, each in
    split and f32; thin boxes for K4/K5, cubes for K8/K9. Stress on f64
    outputs, max |d sigma| <= TOL_KERNEL max |sigma| (TOL_FAST_FORCES with
    the fast factor); histograms at K = 16, 32 and 64, species-partial and,
    on the tile path, masked, maskless and MAXJ = 1: counts exactly equal,
    and the same flags. K9 also in f64 (the double box), on the inputs
    that fail a cluster prune that is not conservative (`prune_cases`, the
    lattice's keys kept) and in 1 and 2 dimensions."""
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY
    from zelll_tpu_torch.ops.lag_pairs import (
        SpeciesPairMask, combine_count_vec, pair_lag_hist, pair_lag_hist_plain,
        pair_lag_stress, pair_lag_stress_plain,
    )
    from zelll_tpu_torch.ops.lj import lj_force_factor, lj_force_factor_fast
    from zelll_tpu_torch.ops.tile_pairs import (
        tile_pair_hist, tile_pair_hist_plain, tile_pair_stress, tile_pair_stress_plain,
    )
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    f64 = torch.float64
    csq = CUTOFF**2
    factors = ((lj_force_factor, TOL_KERNEL), (lj_force_factor_fast, TOL_FAST_FORCES))
    species = torch.as_tensor(np.random.default_rng(7).integers(0, 3, n), device=dev)
    out = {"K4": {}, "K5": {}, "K8": {}, "K9": {}}
    worst = 0.0

    def inputs(pts):
        shi, slo, keys, info, _ = sort_split(pts, dev)
        tail = keys.clone()
        tail[-1000:] = SENTINEL_KEY
        return (shi, slo, keys, info.strides), (shi, slo, tail, info.strides)

    def stress_case(kernel, got, want, tol, what):
        nonlocal worst
        err, scale = stress_err(got, want)
        check(np.isfinite(err) and scale > 0 and err <= tol * scale,
              f"{kernel} stress off its plain version ({what}): {err} > {tol} x {scale}")
        worst = max(worst, err / scale)
        out[kernel][what] = dict(max_abs_err=err, max_abs_stress=scale)

    def hist_case(kernel, got, want, what):
        c, w = combine_count_vec(got), combine_count_vec(want)
        check(np.array_equal(c, w), f"{kernel} counts differ from its plain version ({what})")
        out[kernel][what] = dict(pairs=int(c[-1]))

    thin = lj_box(n, CUTOFF)
    cases = {}
    for tag, pts in (("uniform", generate_points_random(n, thin)),
                     ("lattice", generate_points_lattice(n, thin))):
        cases[tag], tail = inputs(pts)
    cases["sentinel_tail"] = tail
    for tag, (shi, slo, keys, strides) in cases.items():
        for mode, lo in (("split", slo), ("f32", None)):
            for gfn, tol in factors:
                kw = dict(L=L_MAIN, gfn=gfn, out_dtype=f64)
                stress_case("K4", pair_lag_stress(shi, keys, strides, csq, lo, **kw),
                            pair_lag_stress_plain(shi, keys, strides, csq, lo, **kw), tol,
                            f"{tag} {mode} {gfn.__name__}")
            for K in (16, 32, 64):
                esq = hist_edges_sq(K)
                hist_case("K5", pair_lag_hist(shi, keys, strides, esq, lo, L=L_MAIN),
                          pair_lag_hist_plain(shi, keys, strides, esq, lo, L=L_MAIN),
                          f"{tag} {mode} K{K}")
            esq = hist_edges_sq(HIST_K)
            kw = dict(L=L_MAIN, pair_mask=SpeciesPairMask(0, 2))
            hist_case("K5", pair_lag_hist(shi, keys, strides, esq, lo, species, **kw),
                      pair_lag_hist_plain(shi, keys, strides, esq, lo, species, **kw),
                      f"{tag} {mode} species(0, 2)")

    pts, side = cube_points(n)
    cases = {}
    for tag, p in (("uniform", pts), ("lattice", generate_points_lattice(n, (side,) * 3))):
        cases[tag], tail = inputs(p)
    cases["sentinel_tail"] = tail
    for tag, (shi, slo, keys, strides) in cases.items():
        maxj = probe_maxj(keys, strides)
        for mode, lo in (("split", slo), ("f32", None)):
            for bandmask in (False, True):
                bm = "masked" if bandmask else "maskless"
                for gfn, tol in factors:
                    kw = dict(MAXJ=maxj, bandmask=bandmask, gfn=gfn, out_dtype=f64)
                    got, ok = tile_pair_stress(shi, keys, strides, csq, lo, **kw)
                    want, ok_p = tile_pair_stress_plain(shi, keys, strides, csq, lo, **kw)
                    check(bool(ok) and bool(ok_p), f"K8 flags {bool(ok)}/{bool(ok_p)} ({tag})")
                    stress_case("K8", got, want, tol, f"{tag} {mode} {bm} {gfn.__name__}")
                for K in (16, 32, 64):
                    kw = dict(MAXJ=maxj, bandmask=bandmask)
                    got, ok = tile_pair_hist(shi, keys, strides, hist_edges_sq(K), lo, **kw)
                    want, ok_p = tile_pair_hist_plain(shi, keys, strides, hist_edges_sq(K),
                                                      lo, **kw)
                    check(bool(ok) and bool(ok_p), f"K9 flags {bool(ok)}/{bool(ok_p)} ({tag})")
                    hist_case("K9", got, want, f"{tag} {mode} {bm} K{K}")
            kw = dict(MAXJ=maxj, pair_mask=SpeciesPairMask(1, 1))
            esq = hist_edges_sq(HIST_K)
            got, _ = tile_pair_hist(shi, keys, strides, esq, lo, species, **kw)
            want, _ = tile_pair_hist_plain(shi, keys, strides, esq, lo, species, **kw)
            hist_case("K9", got, want, f"{tag} {mode} species(1, 1)")
            kw = dict(MAXJ=1, bandmask=True)
            got, ok = tile_pair_hist(shi, keys, strides, esq, lo, **kw)
            want, ok_p = tile_pair_hist_plain(shi, keys, strides, esq, lo, **kw)
            check(not bool(ok) and not bool(ok_p), f"K9 flags at MAXJ = 1 ({tag})")
            hist_case("K9", got, want, f"{tag} {mode} MAXJ1")
            got, ok = tile_pair_stress(shi, keys, strides, csq, lo, out_dtype=f64, **kw)
            want, ok_p = tile_pair_stress_plain(shi, keys, strides, csq, lo, out_dtype=f64,
                                                **kw)
            check(not bool(ok) and not bool(ok_p), f"K8 flags at MAXJ = 1 ({tag})")
            stress_case("K8", got, want, TOL_KERNEL, f"{tag} {mode} MAXJ1")
    # K9 also through the f64 box, on the inputs that fail a cluster prune
    # that is not conservative (the lattice's keys kept), and in 1 and 2
    # dimensions
    shi, slo, keys, strides = cases["lattice"]
    maxj = probe_maxj(keys, strides)
    esq = hist_edges_sq(HIST_K, f64)
    for what, (h, l) in {"lattice": (shi, slo), **prune_cases(shi, slo)}.items():
        for mode, pos, lo in (("split", h, l), ("f32", h, None),
                              ("f64", h.double() + l.double(), None)):
            for bandmask in (False, True):
                kw = dict(MAXJ=maxj, bandmask=bandmask)
                e = esq.to(pos.dtype)
                got, ok = tile_pair_hist(pos, keys, strides, e, lo, **kw)
                want, ok_p = tile_pair_hist_plain(pos, keys, strides, e, lo, **kw)
                check(bool(ok) == bool(ok_p), f"K9 flags {bool(ok)}/{bool(ok_p)} ({what})")
                hist_case("K9", got, want, f"prune {what} {mode} bandmask={bandmask}")
        got, _ = tile_pair_hist(h.double() + l.double(), keys, strides, esq, None,
                                species.double(), MAXJ=maxj, pair_mask=SpeciesPairMask(0, 2))
        want, _ = tile_pair_hist_plain(h.double() + l.double(), keys, strides, esq, None,
                                       species.double(), MAXJ=maxj,
                                       pair_mask=SpeciesPairMask(0, 2))
        hist_case("K9", got, want, f"prune {what} f64 species(0, 2)")
    rng = np.random.default_rng(8)
    for dim, density in ((1, 1.0), (2, 0.1)):
        pts = rng.uniform(0, (n / density) ** (1 / dim), (n, dim))
        shi, slo, keys, info, _ = sort_split(pts, dev)
        maxj = probe_maxj(keys, info.strides)
        for mode, lo in (("split", slo), ("f32", None)):
            kw = dict(MAXJ=maxj, bandmask=True)
            got, ok = tile_pair_hist(shi, keys, info.strides, hist_edges_sq(HIST_K), lo, **kw)
            want, ok_p = tile_pair_hist_plain(shi, keys, info.strides, hist_edges_sq(HIST_K),
                                              lo, **kw)
            check(bool(ok) == bool(ok_p), f"K9 flags {bool(ok)}/{bool(ok_p)} ({dim}-D)")
            hist_case("K9", got, want, f"{dim}-D {mode}")
    # the kernel line's errors: the lattice, whose stress terms are all of
    # one size (a few near pairs carry the uniform cloud's)
    lattice = {k: max(c["max_abs_err"] for w, c in out[k].items() if w.startswith("lattice"))
               for k in ("K4", "K8")}
    return dict(n=n, cases=out, max_err_over_max=worst, lattice_max_abs_err=lattice)


def observables_main_path(dev, n: int) -> dict:
    """The observables protocols at n = 1e7 through the entry points, each
    call counted alone (launch counts zeroed just before it and read just
    after, each exact) and then timed: device ms by CUDA events, host ms
    where the call reads back, and the energy step beside it
    (observables_bench.py's x_over_baseline). The thin box: `virial_rebuild`
    (K1 with lj_virial_term), `fused_stress_open` f32 and split (K4),
    `pair_distance_histogram` (K5) and its species partial. The cube:
    the tile virial (K6), `fused_stress_open(path="tile")` (K8),
    `pair_distance_histogram(path="tile")` (K9) and its species partial.
    NVT: `md_run_langevin` over the thin MD start state (K3), then the
    pressure tensor of the end state (K4) and its histogram (K5). API:
    `CellGrid.distance_histogram` at n = 1e6 in f64 (K5)."""
    from zelll_tpu_torch import CellGrid
    from zelll_tpu_torch.models import md_run_langevin
    from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
    from zelll_tpu_torch.ops.lag_pairs import lj_term, split_f64
    from zelll_tpu_torch.ops.lj import lj_virial_term
    from zelll_tpu_torch.ops.rdf import pair_distance_histogram
    from zelll_tpu_torch.ops.tile_pairs import tile_lj_rebuild_energy
    from zelll_tpu_torch.ops.virial import (
        fused_stress_open, kinetic_stress, pressure_tensor, virial_rebuild,
    )
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    edges = np.linspace(0.0, CUTOFF, HIST_K)
    launches = {}
    out = {}

    def run(name, fn, kernel, *, host=False):
        """One counted call, its flag, then OBS_REPS timed calls."""
        result = counted(fn, kernel)
        check(bool(result[1]), f"{name}: the coverage flag dropped")
        launches[kernel] = launches.get(kernel, 0) + 1
        row = dict(kernel=kernel, launches=1, ms=cuda_ms(fn, OBS_REPS))
        if host:
            t = time.perf_counter()
            for _ in range(OBS_REPS):
                fn()
            torch.cuda.synchronize()
            row["host_ms"] = (time.perf_counter() - t) * 1e3 / OBS_REPS
        out[name] = row
        return result

    box = lj_box(n, CUTOFF)
    pts = generate_points_random(n, box)
    hi, lo = split_f64(torch.as_tensor(pts, device=dev))
    pos = hi
    del pts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    energy = run("thin_energy", lambda: fused_lj_rebuild_energy(pos, CUTOFF, L=L_MAIN),
                 "lag_reduce")
    w = run("thin_virial", lambda: virial_rebuild(pos, CUTOFF, L=L_MAIN), "lag_reduce")
    sig = run("thin_stress_f32", lambda: fused_stress_open(pos, CUTOFF, L=L_MAIN),
              "lag_stress")
    sig_s = run("thin_stress_split",
                lambda: fused_stress_open(pos, CUTOFF, L=L_MAIN, positions_lo=lo),
                "lag_stress")
    species = torch.as_tensor(np.random.default_rng(9).integers(0, 3, n), device=dev)
    h = run("thin_hist", lambda: pair_distance_histogram(pos, edges, L=L_MAIN),
            "lag_hist", host=True)
    hs = run("thin_hist_species", lambda: pair_distance_histogram(
        pos, edges, L=L_MAIN, species=species, pair=(0, 1)), "lag_hist", host=True)
    thin_check = dict(
        energy=float(energy[0]), virial=float(w[0]),
        stress_f32_trace_rel_err_vs_virial=rel(float(torch.trace(sig[0])), float(w[0])),
        stress_split_trace=float(torch.trace(sig_s[0])), hist_pairs=int(h[0].sum()),
        species_pairs=int(hs[0].sum()))
    check(thin_check["stress_f32_trace_rel_err_vs_virial"] <= 1e-4,
          f"trace(stress) vs virial on the thin box: {thin_check}")
    check(0 < hs[0].sum() < h[0].sum(), f"thin histograms: {thin_check}")
    del pos, hi, lo, species
    peak_thin = torch.cuda.max_memory_allocated()

    cpts, side = cube_points(n)
    cpos = torch.as_tensor(cpts, dtype=torch.float32, device=dev)
    del cpts
    species = torch.as_tensor(np.random.default_rng(10).integers(0, 3, n), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce = run("cubic_energy", lambda: tile_lj_rebuild_energy(cpos, CUTOFF, MAXJ=OBS_MAXJ,
                                                            term=lj_term), "tile_reduce")
    cw = run("cubic_virial", lambda: tile_lj_rebuild_energy(
        cpos, CUTOFF, MAXJ=OBS_MAXJ, term=lj_virial_term), "tile_reduce")
    csig = run("cubic_stress", lambda: fused_stress_open(cpos, CUTOFF, path="tile",
                                                         MAXJ=OBS_MAXJ), "tile_stress")
    ch = run("cubic_hist", lambda: pair_distance_histogram(
        cpos, edges, path="tile", MAXJ=HIST_MAXJ), "tile_hist", host=True)
    chs = run("cubic_hist_species", lambda: pair_distance_histogram(
        cpos, edges, path="tile", MAXJ=HIST_MAXJ, species=species, pair=(2, 2)),
        "tile_hist", host=True)
    cubic_check = dict(
        energy=float(ce[0]), virial=float(cw[0]),
        stress_trace_rel_err_vs_virial=rel(float(torch.trace(csig[0])), float(cw[0])),
        hist_pairs=int(ch[0].sum()), species_pairs=int(chs[0].sum()))
    check(cubic_check["stress_trace_rel_err_vs_virial"] <= 1e-4,
          f"trace(stress) vs virial on the cube: {cubic_check}")
    check(0 < chs[0].sum() < ch[0].sum(), f"cubic histograms: {cubic_check}")
    del cpos, species
    peak_cubic = torch.cuda.max_memory_allocated()
    for name, base in (("thin", "thin_energy"), ("cubic", "cubic_energy")):
        for k, row in out.items():
            if k.startswith(name) and k != base:
                row["x_over_energy_step"] = row["ms"] / out[base]["ms"]

    # NVT: Langevin steps over the thin MD protocol's start state
    mpts, st, _ = md_states(n, lj_box(n, CUTOFF), dev)
    volume = float(np.prod(mpts.max(0) - mpts.min(0)))
    del mpts
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    st, ok, temps = md_run_langevin(st, CUTOFF, MD_DT, NVT_KT, NVT_GAMMA, gen,
                                    steps=NVT_STEPS, L=L_MAIN, record_temperature=True)
    end.record()
    end.synchronize()
    nvt_host = (time.perf_counter() - t_host) * 1e3 / NVT_STEPS
    counts = read_launches()
    check(counts["lag_forces"] == NVT_STEPS and
          sum(counts.values()) == NVT_STEPS, f"md_run_langevin launched {counts}")
    launches["lag_forces"] = launches.get("lag_forces", 0) + NVT_STEPS
    temps = temps.cpu().numpy().tolist()
    check(bool(ok) and all(np.isfinite(temps)) and 0.5 * NVT_KT < temps[-1] < 2 * NVT_KT,
          f"md_run_langevin: ok {bool(ok)}, temperatures {temps}")
    sig_nvt = run("nvt_stress", lambda: fused_stress_open(st.positions, CUTOFF, L=L_MAIN),
                  "lag_stress")
    p_tensor = pressure_tensor(sig_nvt[0].double(), kinetic_stress(st.velocities).double(),
                               volume)
    h_nvt = run("nvt_hist", lambda: pair_distance_histogram(st.positions, edges, L=L_MAIN),
                "lag_hist", host=True)
    p_np = p_tensor.cpu().numpy()
    check(np.isfinite(p_np).all() and np.allclose(p_np, p_np.T) and h_nvt[0].sum() > 0,
          f"NVT end state: pressure tensor {p_np.tolist()}")
    nvt = dict(n=st.positions.shape[0], steps=NVT_STEPS, kT=NVT_KT, gamma=NVT_GAMMA,
               dt=MD_DT, step_ms=start.elapsed_time(end) / NVT_STEPS,
               host_step_ms=nvt_host, temperatures=temps,
               pressure_tensor=p_np.tolist(), pressure=float(np.trace(p_np)) / 3,
               hist_pairs=int(h_nvt[0].sum()))
    del st

    # API: CellGrid.distance_histogram in f64 on the API cell's box
    n_api = N_PARITY
    api_pts = generate_points_random(n_api, lj_box(n_api, CUTOFF))
    cg = CellGrid(api_pts, CUTOFF, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    api_ms, api_hist = host_ms(lambda: cg.distance_histogram(edges))
    counts = read_launches()
    check(counts["lag_hist"] == 1 and sum(counts.values()) == 1,
          f"CellGrid.distance_histogram launched {counts}")
    launches["lag_hist"] = launches.get("lag_hist", 0) + 1
    out["api_distance_histogram"] = dict(kernel="lag_hist", launches=1, host_ms=api_ms,
                                         n=n_api, pairs=int(api_hist.sum()))
    return dict(n=n, calls=out, launches=launches, thin=thin_check, cubic=cubic_check,
                cubic_side=side, nvt=nvt, max_memory_allocated=max(peak_thin, peak_cubic))


def oracle_stress(pts: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The exact f64 stress over the given pairs (in row blocks)."""
    sig = np.zeros((3, 3))
    for s in range(0, len(i), 1 << 22):
        d = pts[i[s:s + (1 << 22)]] - pts[j[s:s + (1 << 22)]]
        dsq = (d * d).sum(1)
        inv = 1.0 / dsq
        t = inv**3
        g = 24 * t * (2 * t - 1) * inv
        sig += np.einsum("p,pa,pb->ab", g, d, d)
    return sig


def oracle_shells(pts: np.ndarray, i: np.ndarray, j: np.ndarray, edges) -> tuple:
    """Shell counts of the given pairs on ``edges`` by their f64 dsq
    (summed axis by axis, as the f64 kernels do), and whether any dsq lies
    within 4 ulp of a squared edge (a tie that another rounding could
    move across the edge)."""
    esq = np.asarray(edges, np.float64) ** 2
    counts = np.zeros(len(esq) - 1, np.int64)
    tie = False
    for s in range(0, len(i), 1 << 22):
        d = pts[i[s:s + (1 << 22)]] - pts[j[s:s + (1 << 22)]]
        dsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        k = np.searchsorted(esq, dsq, side="right")
        counts += np.bincount(k, minlength=len(esq) + 1)[1:len(esq)]
        # the nearest edge of each dsq is the one at or below it, or above
        near = np.minimum(np.abs(dsq - esq[np.maximum(k - 1, 0)]),
                          np.abs(esq[np.minimum(k, len(esq) - 1)] - dsq))
        tie |= bool((near <= 4 * np.spacing(esq.max())).any())
    return counts, tie


def obs_parity(dev, n: int) -> dict:
    """The observables against the exact-f64 oracle at n = 1e6 (sums over
    `oracle.pairs`): split stress on both paths and the split virial within
    TOL_SPLIT of max |sigma| (of |W|); the f32 rows within tpu_parity.py's
    f32_tol against the f64 stress of the f32 coordinates; split histograms
    within TOL_HIST of the total in cumulative deviation; and
    `CellGrid.distance_histogram` (f64) equal to the oracle's shell counts
    on tie-free edges."""
    from zelll_tpu_torch import CellGrid, oracle
    from zelll_tpu_torch.ops.lag_pairs import split_f64
    from zelll_tpu_torch.ops.rdf import pair_distance_histogram
    from zelll_tpu_torch.ops.virial import fused_stress_open, virial_rebuild
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    edges = np.linspace(0.0, CUTOFF, 17)
    out = {}
    thin_pts = generate_points_random(n, lj_box(n, CUTOFF))
    cube_pts, side = cube_points(n)
    for name, pts, path, kw in (("thin", thin_pts, "lag", dict(L=L_MAIN)),
                                ("cubic", cube_pts, "tile", dict(MAXJ=OBS_MAXJ))):
        hi, lo = split_f64(torch.as_tensor(pts, device=dev))
        hi64 = hi.double().cpu().numpy()
        f32_tol = max(float(np.max(pts.max(0) - pts.min(0))) * 2**-24 / CUTOFF * 300, 3e-5)
        oi, oj = oracle.pairs(pts, CUTOFF)
        ref = oracle_stress(pts, oi, oj)
        scale = float(np.abs(ref).max())
        oi32, oj32 = oracle.pairs(hi64, CUTOFF)
        ref32 = oracle_stress(hi64, oi32, oj32)
        sig, ok = fused_stress_open(hi, CUTOFF, path=path, positions_lo=lo, **kw)
        sig32, ok32 = fused_stress_open(hi, CUTOFF, path=path, **kw)
        check(bool(ok) and bool(ok32), f"{name} parity: a stress flag dropped")
        row = dict(path=path, oracle_pairs=len(oi),
                   stress_split_err=float(np.abs(sig.double().cpu().numpy() - ref).max())
                   / scale,
                   stress_f32_err=float(np.abs(sig32.double().cpu().numpy() - ref32).max())
                   / float(np.abs(ref32).max()), f32_tol=f32_tol)
        check(row["stress_split_err"] <= TOL_SPLIT, f"{name} split stress vs oracle: {row}")
        check(row["stress_f32_err"] <= f32_tol, f"{name} f32 stress vs oracle: {row}")
        if path == "lag":
            w, okw = virial_rebuild(hi, CUTOFF, lo, L=L_MAIN)
            row["virial_split_err"] = rel(float(w), float(np.trace(ref)))
            check(bool(okw) and row["virial_split_err"] <= TOL_SPLIT,
                  f"{name} split virial vs oracle: {row}")
        counts, okh = pair_distance_histogram(hi, edges, positions_lo=lo, path=path, **kw)
        ref_counts, _ = oracle_shells(pts, oi, oj, edges)
        cum, cum_ref = np.cumsum(counts), np.cumsum(ref_counts)
        row["hist_split_cum_dev"] = float(np.abs(cum - cum_ref).max()) / max(cum_ref[-1], 1)
        check(okh and row["hist_split_cum_dev"] <= TOL_HIST, f"{name} split hist: {row}")
        out[name] = row
    # CellGrid on the API cell's box, f64: tie-free edges (the f64 kernel
    # bins exactly the oracle's dsq)
    edges_api = np.linspace(0.05, CUTOFF, 23) - 1e-7
    oi, oj = oracle.pairs(thin_pts, CUTOFF)
    want, tie = oracle_shells(thin_pts, oi, oj, edges_api)
    check(not tie, "the API parity edges are not tie-free")
    got = CellGrid(thin_pts, CUTOFF, device=dev).distance_histogram(edges_api)
    check(np.array_equal(got, want), f"CellGrid.distance_histogram: {got} vs {want}")
    out["cellgrid_distance_histogram"] = dict(equal=True, pairs=int(got.sum()))
    return dict(n=n, cube_side=side, **out)


def timed_launches(fn, wrapper) -> tuple:
    """`cuda_ms` of ``fn`` over 10 runs and the launches ``wrapper`` counted
    in them (one warm-up and the 10 timed runs: 11)."""
    wrapper.launches = 0
    ms = cuda_ms(fn, 10)
    return ms, wrapper.launches


def plain_time(plain_ms_at, n: int) -> dict:
    """The device ms of one plain pass at n (``plain_ms_at(m)`` prepares m
    points and times the pass alone), or at 1e6 where the pass at 1e6 says
    one at n would take over PLAIN_LIMIT_S."""
    ms6 = plain_ms_at(N_PARITY)
    if ms6 * n / N_PARITY / 1e3 > PLAIN_LIMIT_S:
        return dict(plain_ms=ms6, plain_n=N_PARITY)
    return dict(plain_ms=plain_ms_at(n), plain_n=n)


def stress_alone(dev, n: int) -> dict:
    """K4 (thin box) and K8 (cube, maskless, MAXJ 24) alone at n = 1e7 on the
    protocols' sorted inputs, f32 and split: ms and the launches counted
    in the timed runs, the work of the function (its half-stencil
    candidates and cutoff pairs) and its bound, the share of it, one plain
    pass (at 1e6 where one at 1e7 would take over 10 s), and the kernel
    against the plain version at n = 1e6."""
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count, count_term, pair_lag_reduce, pair_lag_stress, pair_lag_stress_plain,
    )
    from zelll_tpu_torch.ops.tile_pairs import (
        stress_tiles, stress_tiles_plain, tile_inputs, tile_pair_reduce, tile_pair_stress,
    )
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    out = {}

    def thin(m):
        return sort_split(generate_points_random(m, lj_box(m, CUTOFF)), dev)

    shi, slo, keys, info, _ = thin(n)
    strides = info.strides
    pairs = combine_count(pair_lag_reduce(shi, keys, strides, csq, slo, L=L_MAIN,
                                          term=count_term, out_dtype=torch.int32))
    candidates = stencil_candidates(keys, info)
    for tag, lo in (("f32", None), ("split", slo)):
        ms, launches = timed_launches(
            lambda: pair_lag_stress(shi, keys, strides, csq, lo, L=L_MAIN), pair_lag_stress)
        b = bound(n * 4 * ((6 if lo is not None else 3) + 1),
                  candidates * INSTR_PER_CANDIDATE[lo is not None]
                  + pairs * INSTR_PER_STRESS_PAIR)
        out[f"K4_{tag}"] = dict(ms=ms, launches=launches, **b,
                                share_of_bound=b["bound_ms"] / ms)
    del shi, slo, keys

    def k4_plain(m):
        h, lo_, k, inf, _ = thin(m)
        return once_ms(lambda: pair_lag_stress_plain(h, k, inf.strides, csq, lo_,
                                                     L=L_MAIN))[0]

    out["K4_split"].update(plain_time(k4_plain, n))
    out.update(K4_pairs=pairs, K4_candidates=candidates)

    pts, _ = cube_points(n)
    shi, slo, keys, info, _ = sort_split(pts, dev)
    del pts
    strides = info.strides
    inp = tile_inputs(shi.t().contiguous(), keys, strides, CB=CB, MAXJ=OBS_MAXJ,
                      bandmask=False)
    inp_s = tile_inputs(shi.t().contiguous(), keys, strides, slo.t().contiguous(), CB=CB,
                        MAXJ=OBS_MAXJ, bandmask=False)
    check(bool(inp.coverage_ok), f"K8 coverage failed alone at MAXJ = {OBS_MAXJ}")
    cpairs = combine_count(tile_pair_reduce(shi, keys, strides, csq, MAXJ=OBS_MAXJ,
                                            term=count_term, out_dtype=torch.int32)[0])
    ccand = stencil_candidates(keys, info)
    for tag, x in (("f32", inp), ("split", inp_s)):
        ms, launches = timed_launches(lambda: stress_tiles(x, csq), tile_pair_stress)
        b = bound(n * 4 * ((6 if x.lo is not None else 3) + 1) + x.bounds.numel() * 4,
                  ccand * INSTR_PER_CANDIDATE[x.lo is not None] + cpairs * INSTR_PER_STRESS_PAIR)
        out[f"K8_{tag}"] = dict(ms=ms, launches=launches, **b,
                                share_of_bound=b["bound_ms"] / ms)
    out.update(K8_pairs=cpairs, K8_candidates=ccand,
               K8_tile_evaluations=int(inp.bounds[:, 2::3].sum()) * 128 * 128)
    del inp, inp_s, shi, slo, keys

    def k8_plain(m):
        p, _ = cube_points(m)
        h, _, k, inf, _ = sort_split(p, dev)
        x = tile_inputs(h.t().contiguous(), k, inf.strides, CB=CB, MAXJ=OBS_MAXJ,
                        bandmask=False)
        return once_ms(lambda: stress_tiles_plain(x, csq))[0]

    out["K8_f32"].update(plain_time(k8_plain, n))
    # the kernels against their plain versions at the parity size (f64 sums)
    shi, slo, keys, info, _ = thin(N_PARITY)
    got = pair_lag_stress(shi, keys, info.strides, csq, slo, L=L_MAIN, out_dtype=torch.float64)
    want = pair_lag_stress_plain(shi, keys, info.strides, csq, slo, L=L_MAIN,
                                 out_dtype=torch.float64)
    out["K4_vs_plain_1e6"] = stress_err(got, want)
    check(out["K4_vs_plain_1e6"][0] <= TOL_KERNEL * out["K4_vs_plain_1e6"][1], "K4 at 1e6")
    p, _ = cube_points(N_PARITY)
    h, _, k, inf, _ = sort_split(p, dev)
    x = tile_inputs(h.t().contiguous(), k, inf.strides, CB=CB, MAXJ=OBS_MAXJ, bandmask=False)
    out["K8_vs_plain_1e6"] = stress_err(stress_tiles(x, csq, out_dtype=torch.float64),
                                        stress_tiles_plain(x, csq, out_dtype=torch.float64))
    check(out["K8_vs_plain_1e6"][0] <= TOL_KERNEL * out["K8_vs_plain_1e6"][1], "K8 at 1e6")
    return dict(n=n, MAXJ=OBS_MAXJ, **out)


def hist_alone(dev, n: int) -> dict:
    """K5 (thin box) and K9 (cube, maskless, MAXJ 12) alone at n = 1e7 on the
    protocols' sorted inputs, K = 32, f32 and split: ms and the launches
    counted in the timed runs, the work of the function (candidates, and
    ceil(log2 K) compares per cutoff pair) and its bound, the share of it,
    one plain pass (at 1e6 where one at 1e7 would take over 10 s), and the
    counts against the plain version; K9's lane evaluations per half-stencil
    candidate, all 128 x 128 lanes of every tile (the earlier tile design)
    and those the cluster prune leaves (the sweep), and its ptxas lines."""
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count_vec, pair_lag_hist, pair_lag_hist_plain,
    )
    from zelll_tpu_torch.ops import tile_pairs
    from zelll_tpu_torch.ops.cluster_prune import CLUSTER, tile_cluster_entries
    from zelll_tpu_torch.ops.tile_pairs import (
        hist_tiles, hist_tiles_plain, tile_inputs, tile_pair_hist,
    )
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    esq = hist_edges_sq(HIST_K).to(dev)
    per_pair = int(np.ceil(np.log2(HIST_K)))
    out = {}

    def thin(m):
        return sort_split(generate_points_random(m, lj_box(m, CUTOFF)), dev)

    shi, slo, keys, info, _ = thin(n)
    strides = info.strides
    pairs = int(combine_count_vec(pair_lag_hist(shi, keys, strides, esq, slo, L=L_MAIN))[-1])
    candidates = stencil_candidates(keys, info)
    for tag, lo in (("f32", None), ("split", slo)):
        ms, launches = timed_launches(
            lambda: pair_lag_hist(shi, keys, strides, esq, lo, L=L_MAIN), pair_lag_hist)
        b = bound(n * 4 * ((6 if lo is not None else 3) + 1) + HIST_K * 8,
                  candidates * INSTR_PER_CANDIDATE[lo is not None] + pairs * per_pair)
        out[f"K5_{tag}"] = dict(ms=ms, launches=launches, **b,
                                share_of_bound=b["bound_ms"] / ms)
    got = combine_count_vec(pair_lag_hist(shi, keys, strides, esq, L=L_MAIN))
    plain_ms, want = once_ms(lambda: pair_lag_hist_plain(shi, keys, strides, esq, L=L_MAIN))
    check(np.array_equal(got, combine_count_vec(want)), f"K5 counts at n = {n}")
    out["K5_f32"].update(plain_ms=plain_ms, plain_n=n)
    out.update(K5_pairs=pairs, K5_candidates=candidates)
    del shi, slo, keys

    pts, _ = cube_points(n)
    shi, slo, keys, info, _ = sort_split(pts, dev)
    del pts
    inp = tile_inputs(shi.t().contiguous(), keys, info.strides, CB=CB, MAXJ=HIST_MAXJ,
                      bandmask=False)
    inp_s = tile_inputs(shi.t().contiguous(), keys, info.strides, slo.t().contiguous(),
                        CB=CB, MAXJ=HIST_MAXJ, bandmask=False)
    check(bool(inp.coverage_ok), f"K9 coverage failed alone at MAXJ = {HIST_MAXJ}")
    cpairs = int(combine_count_vec(hist_tiles(inp, esq))[-1])
    ccand = stencil_candidates(keys, info)
    for tag, x in (("f32", inp), ("split", inp_s)):
        ms, launches = timed_launches(lambda: hist_tiles(x, esq), tile_pair_hist)
        b = bound(n * 4 * ((6 if x.lo is not None else 3) + 1) + x.bounds.numel() * 4
                  + HIST_K * 8, ccand * INSTR_PER_CANDIDATE[x.lo is not None]
                  + cpairs * per_pair)
        out[f"K9_{tag}"] = dict(ms=ms, launches=launches, **b,
                                share_of_bound=b["bound_ms"] / ms)
    # the lanes the cluster prune leaves: K6's half-stencil entries, once
    # for each of the cluster's 32 lanes (ops/cluster_prune.py)
    edge = float(esq[-1])
    k9_lanes = {tag: int(tile_cluster_entries(x, edge, half=True).sum()) * CLUSTER
                for tag, x in (("f32", inp), ("split", inp_s))}
    tiles = int(inp.bounds[:, 2::3].sum()) * 128 * 128
    out.update(K9_pairs=cpairs, K9_candidates=ccand, K9_tile_evaluations=tiles,
               K9_tile_evaluations_per_candidate=tiles / ccand,
               K9_pruned_evaluations=k9_lanes,
               K9_pruned_evaluations_per_candidate={t: v / ccand for t, v in k9_lanes.items()},
               K9_ptxas=ptxas_summary(tile_pairs.load_hist_kernel.log))
    del inp, inp_s, shi, slo, keys

    def k9_plain(m):
        p, _ = cube_points(m)
        h, _, k, inf, _ = sort_split(p, dev)
        x = tile_inputs(h.t().contiguous(), k, inf.strides, CB=CB, MAXJ=HIST_MAXJ,
                        bandmask=False)
        got = combine_count_vec(hist_tiles(x, esq))
        ms, want = once_ms(lambda: hist_tiles_plain(x, esq))
        check(np.array_equal(got, combine_count_vec(want)), f"K9 counts at n = {m}")
        return ms

    out["K9_f32"].update(plain_time(k9_plain, n))
    return dict(n=n, K=HIST_K, MAXJ=HIST_MAXJ, **out)




# -- periodic boxes (ops/pbc.py: K1 keep mask and minimum image, K3 minimum
# image, K6 keep mask) --------------------------------------------------------

# The JAX package's periodic benchmarks: benchmarks/pbc_bench.py and
# pbc_md_bench.py (MAXJ 24 on the cube, dt 1e-4 from rest, 5 reps),
# pbc_steady_state.py (lattice clouds, skin 0.5, dt 1e-4, 50 steps, MAXJ 20)
PBC_MAXJ = 24
PBC_SS_MAXJ = 20
PBC_REPS = 5
# FP32 instructions of the periodic instances beside INSTR_PER_CANDIDATE and
# INSTR_PER_PAIR: the keep mask (w_i w_j, == 0, w_i + w_j, >= 0), which the
# function needs on the cutoff pairs only, and the minimum image's fold per
# folded axis and candidate, ahead of the cutoff test (two compares, a
# select, the subtraction; split mode also the two-diff's four operations
# and its add)
INSTR_KEEP = 4
INSTR_MI_FOLD = {False: 4, True: 10}


def pbc_sorted(pts: np.ndarray, box, kind: str, dev, *, B=None, G=None, BE=None,
               ghosts_per_row: int = 7):
    """Sorted split inputs of a periodic box on the card, as `ops.pbc`
    makes them: (hi, lo, keys, strides, payload plane or None, mi_box or
    None, reach or None, ok). ``kind``: "keep", ghost images on every axis
    (the keep mask over the shift-sign plane, `pbc_pair_sum`'s lag and tile
    paths); "both", x and y folded and z ghost-extended (``minimage="auto"``
    on the thin box); "mi", x and y folded and z open (the minimum image
    alone). Capacities default to n rows (every row may be a boundary row)
    and ``ghosts_per_row`` images per row."""
    from zelll_tpu_torch.core import GridInfo, compute_keys, sort_by_key
    from zelll_tpu_torch.core.geometry import Aabb
    from zelll_tpu_torch.ops.lag_pairs import split_f64
    from zelll_tpu_torch.ops.pbc import _ghost_bins, _minimage_bins, wrap_positions

    n = len(pts)
    box = np.asarray(box, np.float64)
    hi, lo = split_f64(torch.as_tensor(pts, device=dev))
    if kind == "keep":
        bins, sp, slo, signs, ok = _ghost_bins(
            hi, [0.0] * 3, box, CUTOFF, B=B or n, G=G or ghosts_per_row * n, BE=BE or B or n,
            positions_lo=lo, need_perm=False)
        return (sp, slo, bins.sorted_keys, bins.info.strides, signs[:, 0].contiguous(), None,
                None, ok)
    if kind == "both":
        bins, sp, slo, pay, reach, mib, ok = _minimage_bins(
            hi, [0.0] * 3, box, CUTOFF, np.array([True, True, False]), B=B or n,
            G=G or n, positions_lo=lo, need_perm=False)
        return (sp.contiguous(), slo.contiguous(), bins.sorted_keys, bins.info.strides,
                pay[:, 0].contiguous(), mib, reach, ok)
    fold = torch.tensor([True, True, False], device=dev)
    whi = torch.where(fold, wrap_positions(hi, [0.0] * 3, box), hi)
    zlo, zhi = float(whi[:, 2].min()), float(whi[:, 2].max())
    aabb = Aabb(torch.tensor([0.0, 0.0, zlo], device=dev),
                torch.tensor([box[0], box[1], zhi], device=dev))
    info = GridInfo.create(aabb, CUTOFF, auto_order=True)
    keys, _, shi, slo = sort_by_key(compute_keys(whi, info), whi, lo)
    reach = tuple(max(int(np.ceil(box[a] / CUTOFF)) - 1, 1) if a < 2 else 1 for a in range(3))
    return (shi, slo, keys, info.strides, None,
            torch.tensor([box[0], box[1], 0.0], dtype=torch.float32), reach,
            torch.ones((), dtype=torch.bool, device=dev))


def drifted(case: tuple, seed: int = 5) -> tuple:
    """A sorted case's coordinates moved by up to a skin of 0.5 since its
    keys were built (keys, payload and window kept)."""
    from zelll_tpu_torch.ops.lag_pairs import split_f64

    shi, slo, *rest = case
    moved = shi.double() + slo.double() + torch.as_tensor(np.random.default_rng(seed).uniform(
        -0.25, 0.25, tuple(shi.shape)), device=shi.device)
    return (*split_f64(moved), *rest)


def window_candidates(keys: torch.Tensor, strides, L: int, reach=None) -> int:
    """The lag window's candidate pairs (i, j < i) of the real rows: the
    work of the lag kernels' function, with the window widened by
    ``reach``."""
    from zelll_tpu_torch.core import key_window
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY

    real = keys != SENTINEL_KEY
    first = torch.searchsorted(keys, keys - key_window(strides, reach))
    slots = torch.arange(keys.shape[0], device=keys.device)
    return int(torch.where(real, torch.clamp(slots - first, max=L), 0).sum())


def pbc_vs_plain(dev, n: int) -> dict:
    """The periodic kernel instances against their plain versions on
    identical sorted inputs (n = 2e5), each alone: K1 with the keep mask
    (thin box, ghost images on every axis), with the minimum image alone
    (x and y folded, z open) and with both (``minimage="auto"``), f32 and
    split, LJ and count; K3 with the minimum image (alone and on the
    ghost-extended z), f32 and split; K6 with the keep mask (ghost-extended
    cube), maskless and masked, f32 and split, LJ, fast LJ and count. Each
    on the uniform cloud, a jittered lattice, a seam lattice (`seam_cloud`:
    two layers at each x and y face of the thin box, spacing 1.5, and at
    each x face of the cube, spacing 2.5; their pairs across those axes
    cross the seam only, one spacing apart like the pairs inside, and the
    other faces pair through ghost images) and the lattice drifted since
    its keys were built. Counts exact, f64 totals to TOL_KERNEL (TOL_FAST),
    forces to TOL_KERNEL of the largest. On the seam clouds the lane
    evaluations of the periodic prune are printed beside those of a prune
    without periodic images, which drops pairs there."""
    from zelll_tpu_torch.ops.cluster_prune import lag_cluster_entries
    from zelll_tpu_torch.ops.lag_pairs import (
        PbcKeepTerm, combine_count, count_term, lj_term, lj_term_fast, pair_lag_forces,
        pair_lag_forces_plain, pair_lag_reduce, pair_lag_reduce_plain, suggest_lag,
    )
    from zelll_tpu_torch.ops.pbc import suggest_pbc_capacity
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_reduce, tile_pair_reduce_plain
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box, seam_cloud,
    )

    csq = CUTOFF**2
    f64 = torch.float64
    rng = np.random.default_rng(4)
    thin = np.asarray(lj_box(n, CUTOFF))
    data = {"uniform": generate_points_random(n, thin),
            "lattice": generate_points_lattice(n, thin),
            "seam": seam_cloud(thin, 1.5, 2, (0, 1), rng)}
    k1, k3, prune, errs = {}, {}, {}, {"K1": 0.0, "K3": 0.0, "K6": 0.0}
    B, G, BE = suggest_pbc_capacity(n, thin, CUTOFF, with_multi=True)
    # the seam cloud is all boundary: every row near an x and a y face
    caps = {"keep": dict(B=B, G=G, BE=BE), "both": {}, "mi": {}}
    seam_caps = {"keep": dict(ghosts_per_row=4), "both": {}, "mi": {}}
    for kind in ("keep", "mi", "both"):
        cases = {tag: pbc_sorted(pts, thin, kind, dev,
                                 **(seam_caps if tag == "seam" else caps)[kind])
                 for tag, pts in data.items()}
        cases["drifted"] = drifted(cases["lattice"])
        for tag, (shi, slo, keys, strides, pay, mib, reach, ok) in cases.items():
            check(bool(ok), f"the periodic inputs' flag ({kind}, {tag})")
            L = suggest_lag(keys, strides, reach=reach)
            for lo in (None, slo):
                mode = "split" if lo is not None else "f32"
                kw = dict(L=L, mi_box=mib, key_reach=reach)
                case = {}
                for term, out in ((lj_term, f64), (count_term, torch.int32)):
                    t = term if pay is None else PbcKeepTerm(term)
                    got = pair_lag_reduce(shi, keys, strides, csq, lo, pay, term=t,
                                          out_dtype=out, **kw)
                    want = pair_lag_reduce_plain(shi, keys, strides, csq, lo, pay, term=t,
                                                 out_dtype=out, **kw)
                    if out == torch.int32:
                        c_k, c_p = combine_count(got), combine_count(want)
                        check(c_k == c_p > 0, f"K1 {kind} count {c_k} != {c_p} ({tag} {mode})")
                        case["pairs"] = c_k
                    else:
                        e_k, e_p = float(got), float(want)
                        check(np.isfinite(e_k) and rel(e_k, e_p) <= TOL_KERNEL,
                              f"K1 {kind} energy {e_k} vs {e_p} ({tag} {mode})")
                        case.update(rel_err=rel(e_k, e_p), abs_err=abs(e_k - e_p))
                        if tag == "lattice":
                            errs["K1"] = max(errs["K1"], abs(e_k - e_p))
                k1[f"{kind} {tag} {mode} L{L}"] = case
                if kind != "keep":
                    got = pair_lag_forces(shi, keys, strides, csq, lo, out_dtype=f64, **kw)
                    want = pair_lag_forces_plain(shi, keys, strides, csq, lo, out_dtype=f64,
                                                 **kw)
                    err, scale = force_err(got, want)
                    check(np.isfinite(err) and scale > 0 and err <= TOL_KERNEL * scale,
                          f"K3 {kind} forces: max |df| {err} > {TOL_KERNEL} x {scale} "
                          f"({tag} {mode})")
                    k3[f"{kind} {tag} {mode}"] = dict(max_abs_err=err, err_over_max=err / scale)
                    if tag == "lattice":
                        errs["K3"] = max(errs["K3"], err)
                if tag == "seam" and kind != "keep":
                    # each own cluster's sweep entries, periodic and open
                    args = (shi.t(), None if lo is None else lo.t(), keys, strides, csq, L)
                    per = int(lag_cluster_entries(*args, half=True, mi_box=mib,
                                                  reach=reach).sum())
                    flat = int(lag_cluster_entries(*args, half=True, reach=reach).sum())
                    check(per > flat, f"the seam case's open prune kept {flat} >= {per}")
                    prune[f"{kind} {mode}"] = dict(periodic_entries=per, open_entries=flat)
    side = (n / 0.01) ** (1 / 3)
    cube = np.array([side] * 3)
    cdata = {"uniform": generate_points_random(n, cube),
             "lattice": generate_points_lattice(n, cube),
             "seam": seam_cloud(cube, 2.5, 2, (0,), rng)}
    Bc, Gc, BEc = suggest_pbc_capacity(n, cube, CUTOFF, with_multi=True)
    ccaps = dict(B=Bc, G=Gc, BE=BEc)
    ccases = {tag: pbc_sorted(pts, cube, "keep", dev,
                              **(dict(ghosts_per_row=3) if tag == "seam" else ccaps))
              for tag, pts in cdata.items()}
    ccases["drifted"] = drifted(ccases["lattice"])
    k6 = {}
    for tag, (shi, slo, keys, strides, pay, _, _, ok) in ccases.items():
        check(bool(ok), f"the periodic cube's flag ({tag})")
        maxj = probe_maxj(keys, strides)
        for bandmask in (False, True):
            for lo in (None, slo):
                what = f"{tag} {'masked' if bandmask else 'maskless'} " \
                       f"{'split' if lo is not None else 'f32'}"
                case = {}
                terms = ((lj_term, f64, TOL_KERNEL), (count_term, torch.int32, 0))
                if tag == "lattice":
                    terms += ((lj_term_fast, f64, TOL_FAST),)
                for term, out, tol in terms:
                    kw = dict(MAXJ=maxj, bandmask=bandmask, term=PbcKeepTerm(term),
                              out_dtype=out)
                    got, ok_k = tile_pair_reduce(shi, keys, strides, csq, lo, pay, **kw)
                    want, ok_p = tile_pair_reduce_plain(shi, keys, strides, csq, lo, pay, **kw)
                    check(bool(ok_k) == bool(ok_p) and bool(ok_k),
                          f"K6 keep coverage {bool(ok_k)} / {bool(ok_p)} ({what})")
                    if out == torch.int32:
                        c_k, c_p = combine_count(got), combine_count(want)
                        check(c_k == c_p > 0, f"K6 keep count {c_k} != {c_p} ({what})")
                        case["pairs"] = c_k
                    else:
                        e_k, e_p = float(got), float(want)
                        check(np.isfinite(e_k) and rel(e_k, e_p) <= tol,
                              f"K6 keep {term.__name__} {e_k} vs {e_p} ({what})")
                        case[f"{term.__name__}_rel_err"] = rel(e_k, e_p)
                        if tag == "lattice" and term is lj_term:
                            errs["K6"] = max(errs["K6"], abs(e_k - e_p))
                k6[what] = case
    return dict(n=n, thin_box=thin.tolist(), cube_side=side, K1=k1, K3=k3, K6=k6,
                seam_prune=prune, lattice_max_abs_err=errs)


def periodic_reference(pts: np.ndarray, box, cutoff: float):
    """Exact-f64 minimum-image energy, pair count and forces of points in
    [0, box): the oracle on the points and their ghost images (numpy f64,
    every image within ``cutoff`` of a face, up to 7 for a corner), each
    real pair kept once. Every real particle meets exactly one copy of each
    partner (box > 2 cutoff), so the oracle's forces of the real rows are
    the minimum-image forces; a pair of two real rows counts once and a
    real-ghost pair half (its mirror pairs the other end's real row).
    Returns (energy, count, forces, each real row's force scale: the sum
    over its pairs of the magnitudes of both LJ parts)."""
    from itertools import product

    from zelll_tpu_torch import oracle

    n = len(pts)
    box = np.asarray(box, np.float64)
    low, high = pts < cutoff, pts >= box - cutoff
    shift = np.where(low, box, np.where(high, -box, 0.0))
    ext = [pts]
    for m in product((0, 1), repeat=3):
        if any(m):
            m = np.asarray(m, bool)
            sel = np.all((low | high)[:, m], axis=1)
            ext.append(pts[sel] + np.where(m, shift[sel], 0.0))
    ext = np.concatenate(ext)
    forces = oracle.forces(ext, cutoff)[:n]
    i, j = oracle.pairs(ext, cutoff)
    i, j = i.astype(np.int64), j.astype(np.int64)
    d = ext[i] - ext[j]
    t = 1.0 / (d * d).sum(1)
    t3 = t * t * t
    size = 24.0 * t * t3 * (2.0 * t3 + 1.0) * np.sqrt((d * d).sum(1))
    scale = (np.bincount(i, size, len(ext)) + np.bincount(j, size, len(ext)))[:n]
    del d, t, t3, size
    real = (i < n).astype(np.int64) + (j < n)
    keep = real > 0
    i, j, w = i[keep], j[keep], np.where(real[keep] == 2, 1.0, 0.5)
    d = ext[i] - ext[j]
    dsq = (d * d).sum(1)
    t3 = (1.0 / dsq) ** 3
    energy = float((w * 4.0 * t3 * (t3 - 1.0)).sum())
    count = float(w.sum())
    check(count == int(count), f"the periodic reference's half pairs do not pair up: {count}")
    return energy, int(count), forces, scale


def pbc_parity(dev, n: int) -> dict:
    """f64-grade periodic energy, pair count and forces on each path against
    `periodic_reference` at n = 1e6: the thin box with ghost images (lag),
    with ``minimage="auto"`` (lag) and through `core.pairs` (xla, in f64:
    that path has no split mode), and the cube with ghost images (tile, and
    xla in f64). Split coordinates of f64 points wrapped into the box, on
    the benchmark's uniform cloud and on a jittered lattice: on the former a
    few near-coincident pairs carry the energy and the force norm, so only
    the latter shows a wrong term elsewhere (a seam fault among them).
    Limits: energy and count rel_err <= TOL_REL; ||f - f_ref|| / ||f_ref||
    <= TOL_REL; each row's ||f_i - f_ref_i|| against its own scale (see
    `periodic_reference`) <= TOL_ROW."""
    from zelll_tpu_torch.ops.lag_pairs import split_f64
    from zelll_tpu_torch.ops.pbc import pbc_count_pairs, pbc_lj_energy, pbc_lj_forces
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    side = (n / 0.01) ** (1 / 3)
    boxes = {"thin": np.asarray(lj_box(n, CUTOFF)), "cubic": np.array([side] * 3)}
    clouds = {"uniform": generate_points_random, "lattice": generate_points_lattice}
    out = {}
    for (name, box), (cloud, make) in itertools.product(boxes.items(), clouds.items()):
        pts = np.mod(make(n, box), box)
        e_ref, c_ref, f_ref, f_scale = periodic_reference(pts, box, CUTOFF)
        p64 = torch.as_tensor(pts, device=dev)
        hi, lo = split_f64(p64)
        runs = ((("lag", dict(L=L_MAIN)), ("lag_minimage", dict(L=L_MAIN, minimage="auto")),
                 ("xla", dict(path="xla")))
                if name == "thin" else
                (("tile", dict(path="tile", MAXJ=PBC_MAXJ)), ("xla", dict(path="xla"))))
        res = {}
        for path, kw in runs:
            kw = dict(kw)
            if path == "xla":
                args, kw["K"] = (p64,), 48
            else:
                args, kw["positions_lo"] = (hi,), lo
            if "L" in kw:
                kw["L"] = probe_pbc_lag(lambda L: pbc_lj_energy(
                    *args, [0.0] * 3, box, CUTOFF, **{**kw, "L": L})[1], kw["L"])
            e, ok_e = pbc_lj_energy(*args, [0.0] * 3, box, CUTOFF, out_dtype=torch.float64, **kw)
            c, ok_c = pbc_count_pairs(*args, [0.0] * 3, box, CUTOFF, **kw)
            f, ok_f = pbc_lj_forces(*args, [0.0] * 3, box, CUTOFF, **kw)
            check(bool(ok_e) and bool(ok_c) and bool(ok_f),
                  f"periodic parity flags ({name} {cloud} {path})")
            got = f.double().cpu().numpy()
            row_err = np.linalg.norm(got - f_ref, axis=1)
            errs = dict(energy_rel_err_vs_reference=rel(float(e), e_ref),
                        count_rel_err_vs_reference=rel(c, c_ref),
                        force_rel_err_vs_reference=float(np.linalg.norm(row_err)
                                                         / np.linalg.norm(f_ref)),
                        force_row_err_vs_reference=float(np.max(
                            row_err / np.maximum(f_scale, np.finfo(np.float64).tiny))))
            for what, err in errs.items():
                tol = TOL_ROW if what.startswith("force_row") else TOL_REL
                check(np.isfinite(err) and err <= tol,
                      f"periodic {what} {err} > {tol} ({name} {cloud} {path})")
            res[path] = dict(**errs, L=kw.get("L"))
        out[f"{name}_{cloud}"] = dict(n=n, box=box.tolist(), reference_pairs=c_ref, paths=res)
    return out


def probe_pbc_lag(flag, L: int, limit: int = 8192) -> int:
    """The smallest power-of-two multiple of L whose coverage flag
    ``flag(L)`` holds (a host read per probe)."""
    while not bool(flag(L)):
        check(L < limit, f"no lag bound up to {limit} covers the periodic window")
        L *= 2
    return L


def window_launches(expect: dict, calls: int) -> dict:
    """The launch counts since the last `reset_launches`, each of which must
    be ``calls`` times its count in ``expect`` (0 where not named): the
    non-zero ones."""
    counts = read_launches()
    want = {k: calls * expect.get(k, 0) for k in counts}
    check(counts == want, f"periodic launches {counts} != {want}")
    return {k: v for k, v in counts.items() if v}


def timed_call(fn, reps: int, expect: dict | None = None):
    """``fn(i)`` for i < reps after one warm-up: device ms per call from
    CUDA events, host ms per call, every returned flag True and the last
    call's result. With ``expect`` (one call's launches) the counts are
    zeroed just before the warm-up and read just after the timed calls;
    they must be reps + 1 times ``expect``."""
    if expect is not None:
        reset_launches()
    out = fn(0)
    check(bool(out[-1]), "a periodic flag is False in the warm-up")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    flags = []
    t_host = time.perf_counter()
    start.record()
    for i in range(reps):
        out = fn(i)
        flags.append(out[-1])
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / reps
    check(all(bool(f) for f in flags), "a periodic flag dropped inside the timed calls")
    res = dict(ms=start.elapsed_time(end) / reps, host_ms=host_ms, reps=reps, out=out)
    if expect is not None:
        res.update(launches=window_launches(expect, reps + 1), calls=reps + 1)
    return res


def pbc_main_path(dev, n: int) -> dict:
    """The periodic protocols at n = 1e7 through the entry points, nothing
    cut. benchmarks/pbc_bench.py: the thin box (30 x 30 x n/9, cutoff 10,
    uniform, f32) with ghost images on every axis (`pbc_pair_sum`, lag,
    K1 with the keep mask) and with ``minimage="auto"`` (K1 with both), the
    cube (side (n/0.01)^(1/3), uniform) on the tile path (K6 with the keep
    mask, MAXJ 24, maskless); pbc_md_bench.py: `md_step_pbc` on that cube
    (tile, K7, MAXJ 24, dt 1e-4 from rest), and `md_step_pbc` with the
    minimum image on the thin box (K3); pbc_steady_state.py: the skin
    loops on lattice clouds (skin 0.5, dt 1e-4, 50 steps):
    `md_run_skin_tile_pbc` on the cube (MAXJ 20) and `md_run_skin_pbc` on
    the thin box. Each call's ms (CUDA events) and host ms beside the
    open-boundary call of the same box, their ratio, B, G, BE, the lag
    bound, every flag (all must hold) and the launches of the timed
    calls and their warm-up, zeroed just before and read just after each
    window, each exact."""
    from zelll_tpu_torch.models import (
        MDState, md_run_skin, md_run_skin_pbc, md_run_skin_tile, md_run_skin_tile_pbc,
        md_step, md_step_cubic_tile,
    )
    from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
    from zelll_tpu_torch.ops.pbc import (
        md_step_pbc, minimage_axes, pbc_pair_sum, suggest_pbc_capacity,
    )
    from zelll_tpu_torch.ops.tile_pairs import tile_lj_rebuild_energy
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    out = {}
    o = [0.0] * 3
    thin = np.asarray(lj_box(n, CUTOFF))
    pos = torch.as_tensor(generate_points_random(n, thin), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def rebuild_cell(name, call, open_call, expect, caps):
        t = timed_call(lambda i: call(pos_of[name] + (i % 2) * 1e-6), PBC_REPS, expect)
        t_open = timed_call(lambda i: open_call(pos_of[name] + (i % 2) * 1e-6), PBC_REPS)
        e = float(t["out"][0])
        check(np.isfinite(e), f"non-finite periodic energy {e} ({name})")
        out[name] = dict(pbc_rebuild_ms=t["ms"], host_ms=t["host_ms"],
                         open_step_ms=t_open["ms"], open_host_ms=t_open["host_ms"],
                         overhead=t["ms"] / t_open["ms"], launches=t["launches"],
                         calls=t["calls"], **caps, energy_per_atom=e / n, ok=True)

    pos_of = {"thin_ghosts": pos, "thin_minimage": pos}
    B, G, BE = suggest_pbc_capacity(n, thin, CUTOFF, with_multi=True)
    kw = dict(B=B, G=G, BE=BE)
    L = probe_pbc_lag(lambda L: pbc_pair_sum(pos, o, thin, CUTOFF, L=L, **kw)[1], L_MAIN)
    rebuild_cell("thin_ghosts", lambda p: pbc_pair_sum(p, o, thin, CUTOFF, L=L, **kw),
                 lambda p: fused_lj_rebuild_energy(p, CUTOFF, L=L_MAIN),
                 {"lag_reduce": 1}, dict(B=B, G=G, BE=BE, L=L))
    Bm, Gm = suggest_pbc_capacity(n, thin, CUTOFF, axes=~minimage_axes(thin, CUTOFF))
    kwm = dict(B=Bm, G=Gm, minimage="auto")
    Lm = probe_pbc_lag(lambda L: pbc_pair_sum(pos, o, thin, CUTOFF, L=L, **kwm)[1], L_MAIN)
    rebuild_cell("thin_minimage", lambda p: pbc_pair_sum(p, o, thin, CUTOFF, L=Lm, **kwm),
                 lambda p: fused_lj_rebuild_energy(p, CUTOFF, L=L_MAIN),
                 {"lag_reduce": 1}, dict(B=Bm, G=Gm, L=Lm))
    vel = torch.zeros_like(pos)
    md_thin = lambda s: md_step_pbc(s[0], s[1], o, thin, CUTOFF, MD_DT, L=Lm, **kwm)
    t = timed_call(lambda i: md_thin((pos, vel)), PBC_REPS, {"lag_forces": 1})
    t_open = timed_call(lambda i: md_step(MDState(pos, vel), CUTOFF, MD_DT, L=L_MAIN), PBC_REPS)
    check(bool(torch.isfinite(t["out"][0]).all()),
          "non-finite positions after md_step_pbc (thin)")
    out["thin_minimage_md_step"] = dict(
        pbc_md_step_ms=t["ms"], host_ms=t["host_ms"], open_step_ms=t_open["ms"],
        overhead=t["ms"] / t_open["ms"], launches=t["launches"], calls=t["calls"],
        B=Bm, G=Gm, L=Lm, ok=True)
    del pos, vel

    side = (n / 0.01) ** (1 / 3)
    cube = np.array([side] * 3)
    pos = torch.as_tensor(np.random.default_rng(7).random((n, 3)) * cube, dtype=torch.float32,
                          device=dev)
    pos_of["cube_tile"] = pos
    Bc, Gc, BEc = suggest_pbc_capacity(n, cube, CUTOFF, with_multi=True)
    kwc = dict(B=Bc, G=Gc, BE=BEc, path="tile", MAXJ=PBC_MAXJ, bandmask=False)
    rebuild_cell("cube_tile", lambda p: pbc_pair_sum(p, o, cube, CUTOFF, kahan=False, **kwc),
                 lambda p: tile_lj_rebuild_energy(p, CUTOFF, MAXJ=PBC_MAXJ, bandmask=False,
                                                  safe_term=False, kahan=False),
                 {"tile_reduce": 1}, dict(B=Bc, G=Gc, BE=BEc, MAXJ=PBC_MAXJ))
    vel = torch.zeros_like(pos)
    md_cube = lambda s: md_step_pbc(s[0], s[1], o, cube, CUTOFF, MD_DT, **kwc)
    t = timed_call(lambda i: md_cube((pos, vel)), PBC_REPS, {"tile_forces": 1})
    t_open = timed_call(lambda i: md_step_cubic_tile(MDState(pos, vel), CUTOFF, MD_DT,
                                                     MAXJ=PBC_MAXJ), PBC_REPS)
    check(bool(torch.isfinite(t["out"][0]).all()),
          "non-finite positions after md_step_pbc (cube)")
    out["cube_md_step"] = dict(pbc_md_step_ms=t["ms"], host_ms=t["host_ms"],
                               open_step_ms=t_open["ms"], overhead=t["ms"] / t_open["ms"],
                               launches=t["launches"], calls=t["calls"], B=Bc, G=Gc,
                               BE=BEc, MAXJ=PBC_MAXJ, ok=True)
    del pos, vel, pos_of

    # the steady state: lattice clouds, Verlet skin with ghost tracking
    for name, box in (("cube_steady", cube), ("thin_steady", thin)):
        _, st, _ = md_states(n, tuple(box), dev)
        Bs, Gs = suggest_pbc_capacity(st.positions.shape[0], box, CUTOFF + MD_SKIN)
        if name == "cube_steady":
            run = lambda s, k: md_run_skin_tile_pbc(s, o, box, CUTOFF, MD_DT, steps=k, B=Bs,
                                                    G=Gs, skin=MD_SKIN, MAXJ=PBC_SS_MAXJ)
            run_open = lambda s, k: md_run_skin_tile(s, CUTOFF, MD_DT, steps=k, skin=MD_SKIN,
                                                     MAXJ=PBC_SS_MAXJ)
            expect, Ls = ({"tile_forces": 1}, {"tile_reduce": 1}), None
        else:
            Ls = probe_pbc_lag(lambda L: md_run_skin_pbc(
                st, o, box, CUTOFF, MD_DT, steps=1, B=Bs, G=Gs, skin=MD_SKIN, L=L)[1], L_MAIN)
            run = lambda s, k: md_run_skin_pbc(s, o, box, CUTOFF, MD_DT, steps=k, B=Bs, G=Gs,
                                               skin=MD_SKIN, L=Ls)
            run_open = lambda s, k: md_run_skin(s, CUTOFF, MD_DT, steps=k, skin=MD_SKIN,
                                                L=L_MAIN)
            expect = ({"lag_forces": 1}, {"lag_reduce": 1})
        t = time_skin(run, st, SKIN_STEPS, name, expect)
        t_open = time_skin(run_open, st, SKIN_STEPS, f"{name}, open")
        out[name] = dict(pbc_steady_ms=t["step_ms"], host_ms=t["host_step_ms"],
                         rebuilds=t["rebuilds"], energy=t["energy"],
                         open_step_ms=t_open["step_ms"], open_rebuilds=t_open["rebuilds"],
                         overhead=t["step_ms"] / t_open["step_ms"], launches=t["launches"],
                         steps_counted=SKIN_STEPS + 2, runs_counted=2,
                         n=st.positions.shape[0], B=Bs, G=Gs, L=Ls, steps=SKIN_STEPS,
                         ok=t["ok"])
        del st
    return dict(n=n, cutoff=CUTOFF, dt=MD_DT, skin=MD_SKIN, cells=out,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def pbc_alone(dev, n: int) -> dict:
    """Each periodic kernel instance alone at the main path's shapes
    (n = 1e7, sorted as `pbc_main_path` sorts them, split coordinates of the
    same points): K1 with the keep mask on the thin ghost-extended array and
    with both rules on the thin ``minimage="auto"`` array (f32 and split),
    K3 with the minimum image on the latter, K6 with the keep mask on the
    ghost-extended cube (f32, `lj_term`, maskless). Each: ms, one plain
    call's ms (f64 outputs, held to the kernel's), the work of the function
    (the lag window's candidates, or the half-stencil ones for K6, the
    cutoff pairs and the kept ones) and its bound. K1 and K3 are also held
    to their plain versions on a jittered lattice of the same size, f32 and
    split."""
    from zelll_tpu_torch.ops import lag_pairs
    from zelll_tpu_torch.ops.lag_pairs import (
        PbcKeepTerm, combine_count, count_term, lj_term, pair_lag_forces,
        pair_lag_forces_plain, pair_lag_reduce, pair_lag_reduce_plain,
    )
    from zelll_tpu_torch.ops.pbc import minimage_axes, suggest_pbc_capacity
    from zelll_tpu_torch.ops.tile_pairs import reduce_tiles, reduce_tiles_plain, tile_inputs
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    f64 = torch.float64
    out = {}
    thin = np.asarray(lj_box(n, CUTOFF))
    pts = np.mod(generate_points_random(n, thin), thin)
    lattice = np.mod(generate_points_lattice(n, thin), thin)
    B, G, BE = suggest_pbc_capacity(n, thin, CUTOFF, with_multi=True)
    Bm, Gm = suggest_pbc_capacity(n, thin, CUTOFF, axes=~minimage_axes(thin, CUTOFF))
    for name, kind, caps in (("K1_keep", "keep", dict(B=B, G=G, BE=BE)),
                             ("K1_keep_minimage", "both", dict(B=Bm, G=Gm))):
        shi, slo, keys, strides, pay, mib, reach, ok = pbc_sorted(pts, thin, kind, dev, **caps)
        check(bool(ok), f"{name}: the periodic inputs' flag")
        rows = shi.shape[0]
        L = probe_pbc_lag(lambda L: lag_pairs.lag_coverage_ok(keys, strides, L, reach=reach),
                          L_MAIN)
        kw = dict(L=L, mi_box=mib, key_reach=reach, term=PbcKeepTerm(lj_term))
        candidates = window_candidates(keys, strides, L, reach)
        for lo in (None, slo):
            mode = "split" if lo is not None else "f32"
            split = lo is not None
            ms = cuda_ms(lambda: pair_lag_reduce(shi, keys, strides, csq, lo, pay, **kw), 10)
            plain_ms, want = once_ms(lambda: pair_lag_reduce_plain(
                shi, keys, strides, csq, lo, pay, out_dtype=f64, **kw))
            got = float(pair_lag_reduce(shi, keys, strides, csq, lo, pay, out_dtype=f64, **kw))
            check(rel(got, float(want)) <= TOL_KERNEL, f"{name} {mode} at 1e7: {got} vs {want}")
            pairs = combine_count(pair_lag_reduce(
                shi, keys, strides, csq, lo, pay, out_dtype=torch.int32,
                **{**kw, "term": PbcKeepTerm(count_term)}))
            # the keep test is needed on the cutoff pairs only, kept or not
            cut_pairs = combine_count(pair_lag_reduce(
                shi, keys, strides, csq, lo, None, out_dtype=torch.int32,
                **{**kw, "term": count_term}))
            per_candidate = INSTR_PER_CANDIDATE[split] + \
                (2 * INSTR_MI_FOLD[split] if mib is not None else 0)
            b = bound(rows * 4 * ((6 if split else 3) + 1 + 1),
                      candidates * per_candidate + cut_pairs * INSTR_KEEP
                      + pairs * INSTR_PER_PAIR)
            out.setdefault(name, dict(rows=rows, L=L, candidates=candidates))[mode] = dict(
                ms=ms, plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms, pairs=pairs,
                cutoff_pairs=cut_pairs, rel_err=rel(got, float(want)))
        if kind == "both":
            pairs = out[name]["f32"]["pairs"]
            for lo in (None, slo):
                mode = "split" if lo is not None else "f32"
                split = lo is not None
                fkw = dict(L=L, mi_box=mib, key_reach=reach)
                ms = cuda_ms(lambda: pair_lag_forces(shi, keys, strides, csq, lo, **fkw), 10)
                plain_ms, want = once_ms(lambda: pair_lag_forces_plain(
                    shi, keys, strides, csq, lo, out_dtype=f64, **fkw))
                got = pair_lag_forces(shi, keys, strides, csq, lo, out_dtype=f64, **fkw)
                err, scale = force_err(got, want)
                check(err <= TOL_KERNEL * scale, f"K3 minimum image {mode} at 1e7: {err}")
                b = bound(rows * 4 * ((6 if split else 3) + 1 + 3),
                          candidates * (INSTR_PER_CANDIDATE[split] + 2 * INSTR_MI_FOLD[split])
                          + pairs * INSTR_PER_FORCE_PAIR)
                out.setdefault("K3_minimage", dict(rows=rows, L=L, candidates=candidates))[mode] \
                    = dict(ms=ms, plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms,
                           max_abs_err=err, max_abs_force=scale)
        del shi, slo, keys, pay
        # the uniform cloud's largest force (near-coincident pairs) hides
        # any error of the rest: hold K1 and K3 to their plain versions at
        # this size on a jittered lattice too, whose pairs keep apart
        shi, slo, keys, strides, pay, mib, reach, ok = pbc_sorted(lattice, thin, kind, dev,
                                                                  **caps)
        check(bool(ok), f"{name}: the lattice's periodic flag")
        L = probe_pbc_lag(lambda L: lag_pairs.lag_coverage_ok(keys, strides, L, reach=reach),
                          L_MAIN)
        kw = dict(L=L, mi_box=mib, key_reach=reach)
        lat = out[name]["lattice"] = dict(rows=shi.shape[0], L=L)
        for lo in (None, slo):
            mode = "split" if lo is not None else "f32"
            t = PbcKeepTerm(lj_term)
            got = float(pair_lag_reduce(shi, keys, strides, csq, lo, pay, term=t,
                                        out_dtype=f64, **kw))
            want = float(pair_lag_reduce_plain(shi, keys, strides, csq, lo, pay, term=t,
                                               out_dtype=f64, **kw))
            check(np.isfinite(got) and rel(got, want) <= TOL_KERNEL,
                  f"{name} {mode} on the lattice at 1e7: {got} vs {want}")
            lat[f"{mode}_rel_err"] = rel(got, want)
            if kind == "both":
                got = pair_lag_forces(shi, keys, strides, csq, lo, out_dtype=f64, **kw)
                want = pair_lag_forces_plain(shi, keys, strides, csq, lo, out_dtype=f64, **kw)
                err, scale = force_err(got, want)
                check(np.isfinite(err) and scale > 0 and err <= TOL_KERNEL * scale,
                      f"K3 minimum image {mode} on the lattice at 1e7: {err} > "
                      f"{TOL_KERNEL} x {scale}")
                out["K3_minimage"][mode].update(lattice_max_abs_err=err,
                                                lattice_max_abs_force=scale)
                del got, want
        del shi, slo, keys, pay
    side = (n / 0.01) ** (1 / 3)
    cube = np.array([side] * 3)
    cpts = np.random.default_rng(7).random((n, 3)) * cube
    Bc, Gc, BEc = suggest_pbc_capacity(n, cube, CUTOFF, with_multi=True)
    shi, _, keys, strides, pay, _, _, ok = pbc_sorted(cpts, cube, "keep", dev, B=Bc, G=Gc,
                                                      BE=BEc)
    check(bool(ok), "K6_keep: the periodic inputs' flag")
    rows = shi.shape[0]
    from zelll_tpu_torch.core import GridInfo, aabb_from_positions
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY

    inp = tile_inputs(shi.t().contiguous(), keys, strides, CB=CB, MAXJ=PBC_MAXJ, bandmask=False)
    check(bool(inp.coverage_ok), "K6_keep coverage at MAXJ 24")
    real = keys != SENTINEL_KEY
    info = GridInfo.create(aabb_from_positions(shi[real]), CUTOFF, auto_order=True)
    candidates = stencil_candidates(keys, info)
    term = PbcKeepTerm(lj_term)
    ms = cuda_ms(lambda: reduce_tiles(inp, csq, term=term, payload=pay), 10)
    plain_ms, want = once_ms(lambda: reduce_tiles_plain(inp, csq, term=term, payload=pay,
                                                        out_dtype=f64))
    got = float(reduce_tiles(inp, csq, term=term, payload=pay, out_dtype=f64))
    check(rel(got, float(want)) <= TOL_KERNEL, f"K6 keep at 1e7: {got} vs {want}")
    pairs = combine_count(reduce_tiles(inp, csq, term=PbcKeepTerm(count_term), payload=pay,
                                       out_dtype=torch.int32))
    cut_pairs = combine_count(reduce_tiles(inp, csq, term=count_term, out_dtype=torch.int32))
    b = bound(rows * 4 * (3 + 1 + 1) + inp.bounds.numel() * 4,
              candidates * INSTR_PER_CANDIDATE[False] + cut_pairs * INSTR_KEEP
              + pairs * INSTR_PER_PAIR)
    out["K6_keep"] = dict(rows=rows, MAXJ=PBC_MAXJ, candidates=candidates, f32=dict(
        ms=ms, plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms, pairs=pairs,
        cutoff_pairs=cut_pairs, rel_err=rel(got, float(want))))
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
    from zelll_tpu_torch.ops import join, lag_pairs, tile_pairs
    from zelll_tpu_torch.ops.cluster_prune import (
        CLUSTER, lag_cluster_entries, tile_cluster_entries,
    )
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
               "tile_forces": tile_pairs.load_forces_kernel,
               "lag_per_particle": lag_pairs.load_per_particle_kernel,
               "join_reduce": join.load_kernel,
               "lag_stress": lag_pairs.load_stress_kernel,
               "lag_hist": lag_pairs.load_hist_kernel,
               "tile_stress": tile_pairs.load_stress_kernel,
               "tile_hist": tile_pairs.load_hist_kernel}
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
    # the lag bound below the key window, and the inputs that fail a cluster
    # prune that is not conservative
    cases["lattice_L64"] = kernel_vs_plain(shi, slo, keys, info.strides, 64)
    for tag, (ghi, glo) in prune_cases(shi, slo).items():
        for L in (L_MAIN, 64):
            cases[f"{tag}_L{L}"] = kernel_vs_plain(ghi, glo, keys, info.strides, L)
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
    stencil = stencil_candidates(keys, info)
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
        # the lanes the cluster prune leaves: each own cluster's sweep
        # entries, once for each of its 32 lanes (ops/cluster_prune.py)
        entries = int(lag_cluster_entries(shi.t(), None if plo is None else plo.t(), keys,
                                          strides, csq, L_MAIN, half=True).sum())
        k1[tag] = dict(ms=ms, plain_ms=plain_ms, keys_sort_ms=keys_sort_ms, **b,
                       share_of_bound=b["bound_ms"] / ms, step_ms=main[tag]["step_ms"],
                       sweep_entries_per_slot=entries / N_MAIN,
                       pruned_evaluations=entries * CLUSTER,
                       pruned_evaluations_per_candidate=entries * CLUSTER / stencil,
                       pruned_evaluations_per_window_pair=entries * CLUSTER / candidates)
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
         candidates_per_slot=candidates / N_MAIN, stencil_candidates=stencil,
         stencil_candidates_per_slot=stencil / N_MAIN, **k1, compare=compare,
         max_rel_err=max_rel(compare), lattice_max_abs_err=max_abs_err,
         ptxas=ptxas_summary(lag_pairs.load_kernel.log))

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

    pts, side = cube_points(N_TILE_CHECK)
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
    lmaxj = probe_maxj(keys, info.strides)
    tcases["lattice"] = tile_vs_plain(shi, slo, keys, info.strides, lmaxj, fast=True)
    # the inputs that fail a cluster prune that is not conservative
    for tag, (ghi, glo) in prune_cases(shi, slo).items():
        tcases[tag] = tile_vs_plain(ghi, glo, keys, info.strides, lmaxj, fast=True)
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
    pts, side = cube_points(N_MAIN)
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
    evaluations = tiles * CHUNK * CHUNK  # all 128 x 128 lanes of every tile
    # the lanes the cluster prune leaves: each own cluster's sweep entries,
    # once for each of its 32 lanes (ops/cluster_prune.py)
    k6_entries = int(tile_cluster_entries(inp, csq, half=True).sum())
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
         sweep_entries_per_slot=k6_entries / N_MAIN, pruned_evaluations=k6_entries * CLUSTER,
         pruned_evaluations_per_candidate=k6_entries * CLUSTER / candidates,
         step_ms=cubic_ms, compare=k6_compare, lattice_max_abs_err=tile_max_abs_err,
         ptxas=ptxas_summary(tile_pairs.load_kernel.log))

    # -- 9. cubic f64-grade parity with the exact-f64 oracle, n = 1e6 ---------------
    pts, side = cube_points(N_PARITY)
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

    # -- 14. K2 against its plain version, n = 2e5 ----------------------------------
    k2_check = per_particle_vs_plain(dev, N_CHECK)
    emit("per_particle_vs_plain", **k2_check)

    # -- 15. the reference-parity API on the card: CellGrid at n = 1e6 --------------
    api = api_main_path(dev, N_PARITY)
    emit("api_main_path", **api)
    emit("api_edges", **api_edges(dev))

    # -- 16. K2 alone at n = 1e7 ----------------------------------------------------
    k2 = per_particle_alone(dev, N_MAIN)
    emit("per_particle_alone", **k2)

    # -- 17. the query join (K12) and the psssh workload ----------------------------
    jv = join_vs_plain(dev, N_CHECK)
    emit("join_vs_plain", **jv)
    sdf_eval = sdf_eval_main_path(dev)
    emit("sdf_eval_main_path", **sdf_eval)
    emit("psssh_sample_main_path", **psssh_sample_main_path(dev))
    emit("api_queries", **api_queries(dev, N_PARITY))
    k12 = join_alone(dev)
    emit("join_alone", **k12)

    # -- 18. the open-boundary observables (K4, K5, K8, K9) ------------------------
    ov = obs_vs_plain(dev, N_CHECK)
    emit("obs_vs_plain", **ov)
    obs = observables_main_path(dev, N_MAIN)
    emit("observables_main_path", **obs)
    emit("obs_parity", **obs_parity(dev, N_PARITY))
    sa = stress_alone(dev, N_MAIN)
    emit("stress_alone", **sa)
    ha = hist_alone(dev, N_MAIN)
    emit("hist_alone", **ha)

    # -- 19. periodic boxes (K1 keep mask and minimum image, K3 minimum image,
    # K6 keep mask) ----------------------------------------------------------------
    pv = pbc_vs_plain(dev, N_CHECK)
    emit("pbc_vs_plain", **pv)
    pbc = pbc_main_path(dev, N_MAIN)
    emit("pbc_main_path", **pbc)
    emit("pbc_parity", **pbc_parity(dev, N_PARITY))
    pa = pbc_alone(dev, N_MAIN)
    emit("pbc_alone", **pa)

    # -- 20. every ported kernel ---------------------------------------------------
    split_k1 = k1["split"]
    k12_sdf = k12["float64"]["sdf"]
    f32_k3 = k3["f32"]
    f64_k2 = k2["f64"]
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
    }, {
        "name": "lag_per_particle",
        "route": "cuda",
        "source": "zelll_tpu_torch/csrc/lag_per_particle.cu",
        "replaces": "zelll_tpu/ops/pallas_pairs.py:401",
        "launches": api["launches"]["lag_per_particle"],
        "max_abs_err": k2_check["lattice_f64_lj_max_abs_err"],
        "ms": f64_k2["ms"],
        "plain_ms": f64_k2["plain_ms"],
        "bound_ms": f64_k2["bound_ms"],
        "bound_by": f64_k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "join_reduce",
        "route": "cuda",
        "source": "zelll_tpu_torch/csrc/join_reduce.cu",
        "replaces": "zelll_tpu/ops/join.py:66",
        "launches": sdf_eval[f"n{N_PROTEIN_LARGE}"]["launches"]["join_reduce"],
        "max_abs_err": jv["lattice_f64_sdf_max_abs_err"],
        "ms": k12_sdf["ms"],
        "plain_ms": k12_sdf["plain_ms"],
        "bound_ms": k12_sdf["bound_ms"],
        "bound_by": k12_sdf["bound_by"],
        "share_of_bound": k12_sdf["share_of_bound"],
        "library_ms": None,
    }, *({
        "name": name,
        "route": "cuda",
        "source": f"zelll_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": obs["launches"][name],
        "max_abs_err": err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "plain_n": row.get("plain_n", N_MAIN),
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "share_of_bound": row["share_of_bound"],
        "library_ms": None,
    } for name, replaces, row, err in (
        ("lag_stress", "zelll_tpu/ops/pallas_pairs.py:1018", sa["K4_split"],
         ov["lattice_max_abs_err"]["K4"]),
        ("lag_hist", "zelll_tpu/ops/pallas_pairs.py:1314", ha["K5_f32"], 0),
        ("tile_stress", "zelll_tpu/ops/tile_pairs.py:735", sa["K8_f32"],
         ov["lattice_max_abs_err"]["K8"]),
        ("tile_hist", "zelll_tpu/ops/tile_pairs.py:453", ha["K9_f32"], 0),
    )), *({
        "name": name,
        "route": "cuda",
        "source": f"zelll_tpu_torch/csrc/{src}.cu",
        "replaces": replaces,
        "instance": instance,
        "launches": sum(pbc["cells"][cell]["launches"].get(src, 0) for cell in cells),
        "max_abs_err": pv["lattice_max_abs_err"][kernel],
        "ms": pa[row]["f32"]["ms"],
        "plain_ms": pa[row]["f32"]["plain_ms"],
        "bound_ms": pa[row]["f32"]["bound_ms"],
        "bound_by": pa[row]["f32"]["bound_by"],
        "share_of_bound": pa[row]["f32"]["share_of_bound"],
        "library_ms": None,
    } for name, src, kernel, row, cells, replaces, instance in (
        ("lag_reduce_keep", "lag_reduce", "K1", "K1_keep", ("thin_ghosts", "thin_steady"),
         "zelll_tpu/ops/pallas_pairs.py:230 (sorted_payload; ops/pbc.py:736)",
         "periodic keep mask (mask id 2), thin box with ghost images, f32"),
        ("lag_reduce_keep_minimage", "lag_reduce", "K1", "K1_keep_minimage",
         ("thin_minimage",), "zelll_tpu/ops/pallas_pairs.py:230 (mi_box, key_reach; :193)",
         "keep mask and minimum image, thin box minimage='auto', f32"),
        ("lag_forces_minimage", "lag_forces", "K3", "K3_minimage", ("thin_minimage_md_step",),
         "zelll_tpu/ops/pallas_pairs.py:583 (mi_box, key_reach)",
         "minimum image, thin box minimage='auto', f32"),
        ("tile_reduce_keep", "tile_reduce", "K6", "K6_keep", ("cube_tile", "cube_steady"),
         "zelll_tpu/ops/tile_pairs.py:259 (n_payload=1; ops/pbc.py:864-873)",
         "periodic keep mask over the payload row, cube with ghost images, f32 lj_term"),
    ))]}), flush=True)

    # -- 21. the card, then the contract line -----------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
