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
(`pbc_parity`), and each instance alone at n = 1e7 (`pbc_alone`). Then
the pair potentials and species (the term table in K1, K3, K6 and K7).
Then the periodic observables and the barostat: the new instances (K4 and
K5 with the keep mask, the minimum image and both, K5 also with the keep
mask composed with a species mask; K8 and K9 with the keep mask) against
their plain versions at n = 2e5 (`pbc_obs_vs_plain`), `pbc_stress_fused`,
`rdf` and `pbc_virial` at n = 1e7 on the thin box and the cube through the
entry points, each call's launches counted (`pbc_obs_main_path`),
`md_run_npt` on the cube (`npt_main_path`), their split parity at n = 1e6
against the oracle on numpy ghost images (`pbc_obs_parity`), and each new
instance alone at n = 1e7 (in `stress_alone` and `hist_alone`). Then the
differentiable potentials and the term table in K2, K4 and K8:
`make_pair_potential`'s value and gradient at n = 1e7 (thin: K1 + K3,
split and f32; cube: K6 + K7; LJ and a factory's term), each call's
launches counted and its result held to the direct calls on the same
sorted inputs (`autodiff_main_path`), its split parity at n = 1e6 against
the oracle (`autodiff_parity`), the new table instances against their
plain versions at n = 2e5 (`table_obs_vs_plain`), a factory's gfn through
`fused_stress_open` and `pbc_stress_fused` at n = 1e6 against an f64
reference (`factory_obs_main_path`), and each table instance beside its
LJ instance at n = 1e7 (`table_obs_alone`). Then the slab decomposition
(`zelll_tpu_torch.parallel`) on 4 shards of the card: the min_islot
instances of K1, K5, K6 and K9 against their plain versions on the slab
path's own halo-extended blocks (`slab_vs_plain`), and the entry points
at n = 1e7 on the thin box (lag kernels) and the cube (tile kernels)
against the single-device calls, each instance then alone on a shard's
block (`slab_main_path`). It prints
one JSON line per phase, with the phase's seconds. Any failed phase exits
non-zero. The last line is the contract line
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
# the lockstep NUTS sampler's run, cut for the script's time (host-bound,
# one flag read per leaf): half of tests/test_psssh.py's 100 burn-in steps,
# 25 draws
NUTS_BURNIN, NUTS_DRAWS = 50, 25
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


_LAST_EMIT = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the previous line
    (the phase's own time)."""
    now = time.perf_counter()
    seconds, _LAST_EMIT[0] = now - _LAST_EMIT[0], now
    print(json.dumps({"phase": phase, "phase_seconds": seconds, **fields}), flush=True)


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
    """The distinct register and spill lines of a build log; a line with
    spills names its kernel function."""
    out, func = set(), ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            func = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "registers" in ln or "spill" in ln:
            spills = "spill" in ln and " 0 bytes spill stores" not in ln
            out.add(f"{func}: {ln.strip()}" if spills else ln.strip())
    return sorted(out)


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


def periodic_stencil_candidates(skeys: torch.Tensor, strides, folds=(0, 0, 0)) -> int:
    """`stencil_candidates` of a periodic box's sorted keys: same-cell pairs
    plus the half-stencil neighbour-cell products on the keys' grid (the
    ghost-extended one where ghosts were made), an axis with ``folds[a] =
    m > 0`` wrapping after its m cells (a minimum-image fold: the last
    cell's neighbour is the first). With m >= 3 (the box spans more than
    two cutoffs) each pair of cells is counted once."""
    from zelll_tpu_torch.core.geometry import SENTINEL_KEY, rel_offsets

    real = skeys[skeys != SENTINEL_KEY]
    cell_keys, counts = torch.unique_consecutive(real, return_counts=True)
    s = [int(v) for v in torch.as_tensor(strides).tolist()]
    # strides are the exclusive products of (shape + 4) in the axis order,
    # so the digits of the key shifted by 2 per axis are each axis's cell
    # index + 2 (ghost cells sit at -1 and shape)
    order = sorted(range(len(s)), key=lambda a: s[a])
    shifted = cell_keys.long() + 2 * sum(s)
    coords = [None] * len(s)
    for k, a in enumerate(order):
        digit = shifted // s[a]
        if k + 1 < len(s):
            digit = digit % (s[order[k + 1]] // s[a])
        coords[a] = digit - 2
    candidates = int((counts * (counts - 1) // 2).sum())
    rel = rel_offsets(len(s))
    for off in rel[: len(rel) // 2]:
        nb = torch.zeros_like(shifted)
        for a in range(len(s)):
            c = coords[a] + int(off[a])
            nb += (c % folds[a] if folds[a] else c) * s[a]
        nb = nb.to(cell_keys.dtype)
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
    """Zero every kernel's launch count (and those of the min_islot
    instances), the join's fallback count and the histogram ladder's
    retries."""
    from zelll_tpu_torch import CellGrid
    from zelll_tpu_torch.ops.join import join_reduce

    for fn in _kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "islot_launches"):
            fn.islot_launches = 0
    join_reduce.fallbacks = 0
    CellGrid.distance_histogram.retries = 0


def read_launches() -> dict:
    from zelll_tpu_torch import CellGrid
    from zelll_tpu_torch.ops.join import join_reduce

    wrappers = _kernel_wrappers()
    return dict(**{name: fn.launches for name, fn in wrappers.items()},
                **{f"{name}_islot": fn.islot_launches for name, fn in wrappers.items()
                   if hasattr(fn, "islot_launches")},
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
    the thin box: the uniform cloud, a jittered lattice, the lattice with a
    `CellGrid`-style padded tail (SENTINEL_KEY keys on far, spread
    coordinates), and the inputs that fail a cluster prune that is not
    conservative (`prune_cases`, the lattice's keys kept), in f32 and f64.
    `count_term` exactly; `lj_term` to TOL_KERNEL of max |out| in f64
    (1e-6 in f32: the same f64 sums, each rounded to f32 once); an
    undersized L drops the same pairs on both sides."""
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
        inputs = [(tag, keys, None, shi, slo)]
        if tag == "lattice":
            tail = keys.clone()
            tail[-1000:] = SENTINEL_KEY
            k = torch.arange(1, 1001, dtype=torch.float64, device=dev)
            far = torch.stack([1e12 + k * 2.0**17, 1e12 + 0 * k, 1e12 + 0 * k], 1)
            inputs.append(("lattice sentinel_tail", tail, far, shi, slo))
            inputs += [(f"prune {what}", keys, None, h, l)
                       for what, (h, l) in prune_cases(shi, slo).items()]
        for name, k_in, far, h, l in inputs:
            for dtype in (torch.float32, torch.float64):
                pos = h if dtype == torch.float32 else h.double() + l.double()
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
    launch counts are zeroed just before and read just after. Then
    `coordination_numbers` again: the median host ms of OBS_REPS calls and
    a profile of its calls (K2's device ms, the busy share)."""
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
    # coordination_numbers again: the median host ms of OBS_REPS calls (one
    # call's host time swings by more than K2's device time), and where its
    # time goes
    ms["coordination_numbers_median"] = float(np.median(
        [host_ms(cg.coordination_numbers)[0] for _ in range(OBS_REPS)]))
    coord_prof = profile_steps(lambda i: cg.coordination_numbers(), OBS_REPS)
    num_cells = int(cg.grid_data.bins.num_cells)
    return dict(n=n, box=box, ms=ms, launches=launches, max_memory_allocated=peak,
                lj_energy_profile=prof, coordination_numbers_profile=coord_prof,
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
    the two adds; FP64 instructions count twice (half the FP32 rate). Also
    the lane evaluations per half-stencil candidate: the first design's two
    thread walks (each lag-window pair from both ends) and those the
    cluster prune leaves (K3's two-sided entries, counted in f32 and f64),
    and the ptxas lines."""
    from zelll_tpu_torch.ops import lag_pairs
    from zelll_tpu_torch.ops.cluster_prune import CLUSTER, lag_cluster_entries
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
        lanes = int(lag_cluster_entries(pos.t(), None, keys, strides, csq, L_MAIN,
                                        half=False).sum()) * CLUSTER
        out[tag] = dict(ms=ms, plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms,
                        pairs=pairs, max_abs_err=err, pruned_evaluations=lanes,
                        pruned_evaluations_per_candidate=lanes / candidates)
    walk = 2 * window_candidates(keys, strides, L_MAIN)
    out.update(walk_evaluations=walk, walk_evaluations_per_candidate=walk / candidates,
               ptxas=ptxas_summary(lag_pairs.load_per_particle_kernel.log))
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
    cutoff 4) for the HMC sampler, and the lockstep NUTS sampler with
    NUTS_BURNIN and NUTS_DRAWS (cut for the script's time): draws/s on the host
    clock, K12 launches (zeroed just before each run, read just after), and
    the sample quality of tests/test_psssh.py: >= 95 % valid, median
    |sdf - 1.05| < 0.5. Then one leapfrog step's gradient call: host ms per
    call, the same by Python function (cProfile), and its device profile."""
    from zelll_tpu_torch import SmoothDistanceField
    from zelll_tpu_torch.models.psssh import sample_surface

    pos, radii = protein(N_PROTEIN)
    sdf = SmoothDistanceField(pos, radii, cutoff=SAMPLE_CUTOFF, device=dev)
    out = {}
    for sampler, burnin, draws in (("hmc", SAMPLE_BURNIN, SAMPLE_DRAWS),
                                   ("nuts-batched", NUTS_BURNIN, NUTS_DRAWS)):
        torch.cuda.synchronize()
        reset_launches()
        ms, pts = host_ms(lambda: sample_surface(
            sdf, chains=SAMPLE_CHAINS, burnin=burnin, draws=draws, seed=0,
            sampler=sampler))
        launches = read_launches()
        vals, _, ok = sdf.evaluate(pts)
        median = float(np.median(np.abs(vals[ok] - sdf.surface_radius)))
        check(pts.shape == (SAMPLE_CHAINS * draws, 3) and np.isfinite(pts).all(),
              f"{sampler}: samples of shape {pts.shape}")
        check(launches["join_reduce"] > 0, f"{sampler} never launched K12")
        check(launches["join_fallbacks"] == 0, f"{sampler} took the join's fallback")
        check(ok.mean() >= 0.95 and median < 0.5,
              f"{sampler}: {ok.mean():.3f} valid, median |sdf - 1.05| {median}")
        out[sampler] = dict(seconds=ms / 1e3, burnin=burnin, draws=len(pts),
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


def count_diff(got, want) -> int:
    """The largest difference of two cumulative count vectors (numpy)."""
    return int(np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64)).max())


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
    and the same flags. K4, K5, K8 and K9 also in f64 (the double box) and
    on the inputs that fail a cluster prune that is not conservative
    (`prune_cases`, the lattice's keys kept), K4 at L = 256 and 16, K5 and
    K9 with a species mask, K8 and K9 masked and maskless, K8 on the
    uniform cloud with coincident points (dsq = 0, excluded); K9 in 1 and 2
    dimensions."""
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
        out[kernel][what] = dict(pairs=int(c[-1]), count_diff=count_diff(c, w))

    thin = lj_box(n, CUTOFF)
    cases = {}
    for tag, pts in (("uniform", generate_points_random(n, thin)),
                     ("lattice", generate_points_lattice(n, thin))):
        cases[tag], tail = inputs(pts)
    cases["sentinel_tail"] = tail
    thin_lattice = cases["lattice"]
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

    # K4 and K5 through the f64 box and on the prune's hard inputs, K4 at
    # L = 256 and 16, K5 with and without the species mask
    shi, slo, keys, strides = thin_lattice
    hard = {"lattice": (shi, slo), **prune_cases(shi, slo)}
    for what, (h, l) in hard.items():
        for mode, pos, lo in (("split", h, l), ("f32", h, None),
                              ("f64", h.double() + l.double(), None)):
            for L in (L_MAIN, 16):
                kw = dict(L=L, out_dtype=f64)
                stress_case("K4", pair_lag_stress(pos, keys, strides, csq, lo, **kw),
                            pair_lag_stress_plain(pos, keys, strides, csq, lo, **kw),
                            TOL_KERNEL, f"prune {what} {mode} L{L}")
    esq = hist_edges_sq(HIST_K, f64)
    for what, (h, l) in hard.items():
        for mode, pos, lo in (("split", h, l), ("f32", h, None),
                              ("f64", h.double() + l.double(), None)):
            e = esq.to(pos.dtype)
            for pay, mask in ((None, None), (species.to(pos.dtype), SpeciesPairMask(0, 2))):
                kw = dict(L=L_MAIN, pair_mask=mask)
                got = pair_lag_hist(pos, keys, strides, e, lo, pay, **kw)
                want = pair_lag_hist_plain(pos, keys, strides, e, lo, pay, **kw)
                hist_case("K5", got, want, f"prune {what} {mode} mask={mask}")

    pts, side = cube_points(n)
    pts[-500:] = pts[:500]  # coincident pairs: dsq = 0, which K8 excludes
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
    # K8 and K9 also through the f64 box, on the inputs that fail a cluster
    # prune that is not conservative (the lattice's keys kept), and K9 in 1
    # and 2 dimensions
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
                got, ok = tile_pair_stress(pos, keys, strides, csq, lo, out_dtype=f64, **kw)
                want, ok_p = tile_pair_stress_plain(pos, keys, strides, csq, lo,
                                                    out_dtype=f64, **kw)
                check(bool(ok) == bool(ok_p), f"K8 flags {bool(ok)}/{bool(ok_p)} ({what})")
                stress_case("K8", got, want, TOL_KERNEL,
                            f"prune {what} {mode} bandmask={bandmask}")
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
    counts = {k: max(c["count_diff"] for c in out[k].values()) for k in ("K5", "K9")}
    return dict(n=n, cases=out, max_err_over_max=worst, lattice_max_abs_err=lattice,
                max_count_diff=counts)


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
    """The observables against the exact-f64 oracle at n (main: 5e5; sums over
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
    against the plain version at n = 1e6; the lane evaluations per
    half-stencil candidate of K4 (each lag-window candidate, as its first
    design's thread walk, and those the cluster prune leaves) and of K8 (all
    128 x 128 lanes of every tile, its first design, and those the prune
    leaves), and their ptxas lines."""
    from zelll_tpu_torch.ops import lag_pairs, tile_pairs
    from zelll_tpu_torch.ops.cluster_prune import (
        CLUSTER, lag_cluster_entries, tile_cluster_entries,
    )
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
    # the lanes the cluster prune leaves: K1's one-sided entries at csq, once
    # for each of the cluster's 32 lanes (ops/cluster_prune.py)
    k4_lanes = {tag: int(lag_cluster_entries(shi.t(), None if lo is None else lo.t(), keys,
                                             strides, csq, L_MAIN, half=True).sum()) * CLUSTER
                for tag, lo in (("f32", None), ("split", slo))}
    walk = window_candidates(keys, strides, L_MAIN)
    out.update(K4_walk_evaluations=walk, K4_walk_evaluations_per_candidate=walk / candidates,
               K4_pruned_evaluations=k4_lanes,
               K4_pruned_evaluations_per_candidate={t: v / candidates
                                                    for t, v in k4_lanes.items()},
               K4_ptxas=ptxas_summary(lag_pairs.load_stress_kernel.log))
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
    # the lanes the cluster prune leaves: K6's half-stencil entries, once
    # for each of the cluster's 32 lanes (ops/cluster_prune.py)
    k8_lanes = {tag: int(tile_cluster_entries(x, csq, half=True).sum()) * CLUSTER
                for tag, x in (("f32", inp), ("split", inp_s))}
    tiles = int(inp.bounds[:, 2::3].sum()) * 128 * 128
    out.update(K8_pairs=cpairs, K8_candidates=ccand, K8_tile_evaluations=tiles,
               K8_tile_evaluations_per_candidate=tiles / ccand,
               K8_pruned_evaluations=k8_lanes,
               K8_pruned_evaluations_per_candidate={t: v / ccand for t, v in k8_lanes.items()},
               K8_ptxas=ptxas_summary(tile_pairs.load_stress_kernel.log))
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
    # the periodic instances (K4 keep mask and minimum image, K8 keep mask)
    out.update(pbc_obs_alone(dev, n, "stress"))
    return dict(n=n, MAXJ=OBS_MAXJ, **out)


def hist_alone(dev, n: int) -> dict:
    """K5 (thin box) and K9 (cube, maskless, MAXJ 12) alone at n = 1e7 on the
    protocols' sorted inputs, K = 32, f32 and split: ms and the launches
    counted in the timed runs, the work of the function (candidates, and
    ceil(log2 K) compares per cutoff pair) and its bound, the share of it,
    one plain pass (at 1e6 where one at 1e7 would take over 10 s), and the
    counts against the plain version; the lane evaluations per half-stencil
    candidate of K5 (each lag-window candidate, as its first design's
    thread walk, and those the cluster prune leaves) and of K9 (all 128 x
    128 lanes of every tile, the earlier tile design, and those the prune
    leaves), and their ptxas lines. Each kernel is timed through its
    launch function, without its wrapper's host checks; K5 also through its
    wrapper `pair_lag_hist` (`wrapper_ms`), and its f32 species-mask
    instance alone."""
    from zelll_tpu_torch.ops.lag_pairs import (
        SpeciesPairMask, combine_count_vec, pair_lag_hist, pair_lag_hist_plain,
    )
    from zelll_tpu_torch.ops import lag_pairs, tile_pairs
    from zelll_tpu_torch.ops.cluster_prune import (
        CLUSTER, lag_cluster_entries, tile_cluster_entries,
    )
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
    strides = torch.as_tensor(info.strides, dtype=torch.int32, device=dev)
    pairs = int(combine_count_vec(pair_lag_hist(shi, keys, strides, esq, slo, L=L_MAIN))[-1])
    candidates = stencil_candidates(keys, info)
    for tag, lo in (("f32", None), ("split", slo)):
        # the launch function: `pair_lag_hist` less its host read of the
        # edges, which puts the host's time between the timed launches
        # (K9 is timed through `hist_tiles` alike); the wrapper beside it
        ms, launches = timed_launches(
            lambda: lag_pairs._lag_hist_cuda(shi, keys, strides, esq, lo, None, L=L_MAIN,
                                             pair_mask=None), pair_lag_hist)
        wrapper_ms = cuda_ms(lambda: pair_lag_hist(shi, keys, strides, esq, lo, L=L_MAIN), 10)
        b = bound(n * 4 * ((6 if lo is not None else 3) + 1) + HIST_K * 8,
                  candidates * INSTR_PER_CANDIDATE[lo is not None] + pairs * per_pair)
        out[f"K5_{tag}"] = dict(ms=ms, launches=launches, wrapper_ms=wrapper_ms, **b,
                                share_of_bound=b["bound_ms"] / ms)
    # the species-mask instance, f32, through the launch function
    species = torch.as_tensor(np.random.default_rng(9).integers(0, 3, n), device=dev).float()
    ms, launches = timed_launches(
        lambda: lag_pairs._lag_hist_cuda(shi, keys, strides, esq, None, species, L=L_MAIN,
                                         pair_mask=SpeciesPairMask(0, 1)), pair_lag_hist)
    out["K5_species_f32"] = dict(ms=ms, launches=launches)
    del species
    got = combine_count_vec(pair_lag_hist(shi, keys, strides, esq, L=L_MAIN))
    plain_ms, want = once_ms(lambda: pair_lag_hist_plain(shi, keys, strides, esq, L=L_MAIN))
    check(np.array_equal(got, combine_count_vec(want)), f"K5 counts at n = {n}")
    out["K5_f32"].update(plain_ms=plain_ms, plain_n=n)
    # the lanes the cluster prune leaves: K1's one-sided entries at the
    # threshold edges[K - 1], once for each of the cluster's 32 lanes
    edge = float(esq[-1])
    k5_lanes = {tag: int(lag_cluster_entries(shi.t(), None if lo is None else lo.t(), keys,
                                             strides, edge, L_MAIN, half=True).sum()) * CLUSTER
                for tag, lo in (("f32", None), ("split", slo))}
    walk = window_candidates(keys, strides, L_MAIN)
    out.update(K5_pairs=pairs, K5_candidates=candidates, K5_walk_evaluations=walk,
               K5_walk_evaluations_per_candidate=walk / candidates,
               K5_pruned_evaluations=k5_lanes,
               K5_pruned_evaluations_per_candidate={t: v / candidates
                                                    for t, v in k5_lanes.items()},
               K5_ptxas=ptxas_summary(lag_pairs.load_hist_kernel.log))
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
    # the periodic instances (K5 keep mask, species and minimum image, K9
    # keep mask)
    out.update(pbc_obs_alone(dev, n, "hist"))
    return dict(n=n, K=HIST_K, MAXJ=HIST_MAXJ, **out)




# -- periodic boxes (ops/pbc.py: K1 keep mask and minimum image, K3 minimum
# image, K6 keep mask) --------------------------------------------------------

# The JAX package's periodic benchmarks: benchmarks/pbc_bench.py and
# pbc_md_bench.py (MAXJ 24 on the cube, dt 1e-4 from rest, 5 reps),
# pbc_steady_state.py (lattice clouds, skin 0.5, dt 1e-4, 50 steps, MAXJ 20)
PBC_MAXJ = 24
# a thin box's folded width whose f32 rounding is near the most of its
# binade (30.7 rounds by 7.6e-7), for the split minimum image's box low part
ROUND_WIDTH = 30.7
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
        # B defaults to n / 2: the sorted-extremes path's merge region holds
        # min(2 B, n) real rows, and at B = n its flag (the JAX package's)
        # asks for an empty top cell
        bins, sp, slo, pay, reach, mib, ok = _minimage_bins(
            hi, [0.0] * 3, box, CUTOFF, np.array([True, True, False]), B=B or n // 2,
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
    # f64 host lengths, as _minimage_bins gives them: split mode's fold
    # carries what their f32 rounding drops
    return (shi, slo, keys, info.strides, None,
            torch.tensor([box[0], box[1], 0.0], dtype=torch.float64), reach,
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
    other faces pair through ghost images), the lattice drifted since its
    keys were built, and on the thin box a seam lattice whose folded x and
    y lengths round in f32 (ROUND_WIDTH, where the split fold carries the
    box's low part). Counts exact, f64 totals to TOL_KERNEL (TOL_FAST),
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
    round_box = np.array([ROUND_WIDTH, ROUND_WIDTH, thin[2]])
    data = {"uniform": (generate_points_random(n, thin), thin),
            "lattice": (generate_points_lattice(n, thin), thin),
            "seam": (seam_cloud(thin, 1.5, 2, (0, 1), rng), thin),
            "seam_round": (seam_cloud(round_box, 1.5, 2, (0, 1), rng), round_box)}
    k1, k3, prune, errs = {}, {}, {}, {"K1": 0.0, "K3": 0.0, "K6": 0.0}
    B, G, BE = suggest_pbc_capacity(n, thin, CUTOFF, with_multi=True)
    # the seam clouds are all boundary: every row near an x and a y face
    caps = {"keep": dict(B=B, G=G, BE=BE), "both": {}, "mi": {}}
    seam_caps = {"keep": dict(ghosts_per_row=4), "both": {}, "mi": {}}
    for kind in ("keep", "mi", "both"):
        cases = {tag: pbc_sorted(pts, box, kind, dev,
                                 **(seam_caps if tag.startswith("seam") else caps)[kind])
                 for tag, (pts, box) in data.items()}
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
    `periodic_reference` at n (main: 5e5): the thin box with ghost images (lag),
    with ``minimage="auto"`` (lag) and through `core.pairs` (xla, in f64:
    that path has no split mode), and the cube with ghost images (tile, and
    xla in f64). Split coordinates of f64 points wrapped into the box, on
    the benchmark's uniform cloud and on a jittered lattice: on the former a
    few near-coincident pairs carry the energy and the force norm, so only
    the latter shows a wrong term elsewhere (a seam fault among them); and
    the lattice on a thin box whose folded x and y lengths round in f32
    (ROUND_WIDTH; the split fold carries the box's low part). Limits:
    energy and count rel_err <= TOL_REL; ||f - f_ref|| / ||f_ref||
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
    round_box = np.array([ROUND_WIDTH, ROUND_WIDTH, boxes["thin"][2]])
    cells = list(itertools.product(boxes.items(), clouds.items()))
    cells.append((("thin_round", round_box), ("lattice", generate_points_lattice)))
    clouds = [np.mod(make(n, box), box) for (_, box), (_, make) in cells]
    # the references (the single-threaded oracle on the host) run in a pool
    # while the card runs the paths
    pool = ThreadPoolExecutor(3)
    refs = [pool.submit(periodic_reference, pts, box, CUTOFF)
            for ((_, box), _), pts in zip(cells, clouds)]
    for ((name, box), (cloud, _)), pts, ref in zip(cells, clouds, refs):
        p64 = torch.as_tensor(pts, device=dev)
        hi, lo = split_f64(p64)
        runs = ((("lag", dict(L=L_MAIN)), ("lag_minimage", dict(L=L_MAIN, minimage="auto")),
                 ("xla", dict(path="xla")))
                if name == "thin" else
                (("lag", dict(L=L_MAIN)), ("lag_minimage", dict(L=L_MAIN, minimage="auto")))
                if name == "thin_round" else
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
            e_ref, c_ref, f_ref, f_scale = ref.result()
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
    pool.shutdown()
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
    window, each exact. The thin ``minimage="auto"`` rebuild takes
    `_minimage_bins`' sorted-extremes path; the same rebuild through its
    general path (`minimage_general_sum`) is timed beside it, and the two
    must give the same pair count and energy."""
    from zelll_tpu_torch.models import (
        MDState, md_run_skin, md_run_skin_pbc, md_run_skin_tile, md_run_skin_tile_pbc,
        md_step, md_step_cubic_tile,
    )
    from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
    from zelll_tpu_torch.ops.lag_pairs import combine_count, count_term, lj_term
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
    # the same rebuild through _minimage_bins' general path (pbc_extend and
    # the n + G row sort) on a copy of the inputs: the same pairs and energy
    mimask = minimage_axes(thin, CUTOFF)
    pos_of["thin_minimage_general"] = pos.clone()
    rebuild_cell("thin_minimage_general",
                 lambda p: minimage_general_sum(p, thin, mimask, Bm, Gm, Lm),
                 lambda p: fused_lj_rebuild_energy(p, CUTOFF, L=L_MAIN),
                 {"lag_reduce": 1}, dict(B=Bm, G=Gm, L=Lm))
    same = {}
    for term, out_dtype in ((count_term, torch.int32), (lj_term, torch.float64)):
        fast, ok_f = pbc_pair_sum(pos, o, thin, CUTOFF, L=Lm, term=term, out_dtype=out_dtype,
                                  **kwm)
        gen, ok_g = minimage_general_sum(pos.clone(), thin, mimask, Bm, Gm, Lm, term=term,
                                         out_dtype=out_dtype)
        check(bool(ok_f) and bool(ok_g), "thin minimage flags (fast or general path)")
        if out_dtype == torch.int32:
            same["pairs"] = combine_count(fast)
            check(combine_count(fast) == combine_count(gen),
                  f"fast path pairs {combine_count(fast)} != general {combine_count(gen)}")
        else:
            same["energy_rel_diff"] = rel(float(fast), float(gen))
            check(rel(float(fast), float(gen)) <= TOL_KERNEL,
                  f"fast path energy {float(fast)} vs general {float(gen)}")
    out["thin_minimage_fast_vs_general"] = same
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


# -- pair potentials and species (the term table's instances) -----------------

# The JAX package's potential tests: a jittered lattice of spacing 1.25 at
# cutoff 2.5 and these parameters (tests/test_potentials.py), the shifted
# LJ and lennard_jones(1, 1); the mixed pair of benchmarks/tpu_parity.py.
POT_CUTOFF = 2.5
POT_SPACING = 1.25
MIXED_EPS, MIXED_SIGMA = (1.0, 0.5), (1.0, 1.2)
# A table or species instance against its plain version on the card: each
# instance repeats its torch function operation by operation on the same
# f32 constants (the species table holds the function's own f32 pair
# parameters; --fmad=false, IEEE division, the same expf), so its f32 terms
# equal the plain version's and only the f64 sums' order differs: energies
# to TOL_TABLE of the sum of |term|, forces per row to TOL_TABLE of the
# row's sum of |g| |d|. A term one f32 ulp off (an FMA contraction, __expf)
# moves these by about 1e-8; the largest readings on an H100 were 4.9e-16
# (energies) and 1.2e-15 (rows).
TOL_TABLE = 1e-12


def table_potentials() -> dict:
    from zelll_tpu_torch.ops import potentials as P

    return {"lennard_jones": P.lennard_jones(0.7, 1.1), "wca": P.wca(0.7, 1.1),
            "soft_sphere": P.soft_sphere(0.5, 1.2, n=8), "gaussian": P.gaussian(2.0, 0.8),
            "morse": P.morse(1.3, 2.0, 1.1), "yukawa": P.yukawa(1.5, 0.7),
            "buckingham": P.buckingham(1000.0, 0.3, 1.0), "harmonic": P.harmonic(3.0, 1.0),
            "shifted_lj": P.shifted(P.lennard_jones(), POT_CUTOFF),
            "lj_1_1": P.lennard_jones(1.0, 1.0)}


def pot_lattice(n: int, rng) -> np.ndarray:
    """A jittered thin lattice of spacing POT_SPACING (+-0.2), 8 x 8 x n/64
    points."""
    shape = (8, 8, max(n // 64, 8))
    cells = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    pts = (cells.reshape(-1, 3) + 0.5) * POT_SPACING
    return pts + rng.uniform(-0.2, 0.2, pts.shape)


def pot_cases(n: int, dev, rng) -> dict:
    """Sorted split inputs at POT_CUTOFF: the lattice and the prune's hard
    inputs on it (the facing clusters of `cluster_gap`, and the lattice
    drifted by up to 0.1 since its keys were built). Each (hi, lo, keys,
    info)."""
    from zelll_tpu_torch.ops.lag_pairs import split_f64
    from zelll_tpu_torch.utils.datagen import cluster_gap

    shi, slo, keys, info, _ = sort_split(pot_lattice(n, rng), dev, POT_CUTOFF)
    p64 = shi.double() + slo.double()
    gap = cluster_gap(p64.cpu().numpy(), POT_CUTOFF, (128 * 8, 128 * 40))
    drift = p64 + torch.as_tensor(rng.uniform(-0.1, 0.1, tuple(p64.shape)), device=dev)
    return {"lattice": (shi, slo, keys, info),
            "cluster_gap": (*split_f64(torch.as_tensor(gap, device=dev)), keys, info),
            "drifted": (*split_f64(drift), keys, info)}


def abs_term(term):
    def f(dsq, *pay):
        return term(dsq, *pay).abs()
    return f


def energy_check(got, want, scale, what) -> float:
    """|got - want| against TOL_TABLE of the sum of |term|."""
    err = abs(float(got) - float(want)) / max(float(scale), np.finfo(np.float64).tiny)
    check(np.isfinite(float(got)) and err <= TOL_TABLE,
          f"table energy {float(got)} vs plain {float(want)}: {err} ({what})")
    return err


def row_check(got, want, scale, what, tol: float = TOL_TABLE) -> float:
    """Each row's |f - f_want| against ``tol`` of its scale (the plain
    version's rows: TOL_TABLE of the row's sum of |g| |d|)."""
    err = (got.double() - want.double()).norm(dim=1)
    worst = float((err / scale.clamp_min(torch.finfo(torch.float64).tiny)).max())
    check(np.isfinite(worst) and worst <= tol, f"table forces per row {worst} ({what})")
    return worst


def force_row_scale(sorted_pos, sorted_keys, strides, cutoff_sq, sorted_pos_lo=None,
                    sorted_payload=None, *, L: int, gfn, mi_box=None, key_reach=None):
    """Each row's f64 sum of |g| |d| over the pairs `pair_lag_forces_plain`
    takes (its key window, separations, minimum image and cutoff test):
    the scale a row's force error is held to where its terms cancel."""
    from zelll_tpu_torch.core import key_window
    from zelll_tpu_torch.ops.lag_pairs import (
        _lag_separations, _mi_box, _pad_and_desentinel, split_cutoff_test,
    )

    n = sorted_pos.shape[0]
    device, dtype = sorted_pos.device, sorted_pos.dtype
    keys = _pad_and_desentinel(sorted_keys, n)
    w = key_window(strides, key_reach).to(device)
    csq = torch.as_tensor(cutoff_sq, dtype=dtype, device=device)
    pay = None if sorted_payload is None else sorted_payload.to(dtype)
    mib = _mi_box(mi_box, device)
    out = torch.zeros((n,), dtype=torch.float64, device=device)
    for lag in range(1, min(L, n - 1) + 1):
        keymask = keys[:-lag] >= keys[lag:] - w
        if not bool(keymask.any()):
            break
        d, dsq, shifts = _lag_separations(sorted_pos, sorted_pos_lo, lag, mib)
        inside = dsq < csq
        if sorted_pos_lo is not None:
            inside = split_cutoff_test(
                inside, dsq, csq, sorted_pos[lag:].unbind(1), sorted_pos[:-lag].unbind(1),
                sorted_pos_lo[lag:].unbind(1), sorted_pos_lo[:-lag].unbind(1),
                None if shifts is None else shifts.unbind(1))
        mask = keymask & inside & (dsq > 0)
        safe = torch.where(mask, dsq, torch.ones_like(dsq))
        g = gfn(safe) if pay is None else gfn(safe, *pay[lag:].unbind(1), *pay[:-lag].unbind(1))
        m = torch.where(mask, g, torch.zeros_like(g)).double().abs() * d.double().norm(dim=1)
        out[lag:] += m
        out[:-lag] += m
    return out


def species_plane(n: int, rng, dev, odd: bool = True) -> torch.Tensor:
    """Species 0 and 1 at random; with ``odd``, every tenth row one of the
    values the JAX rule maps to species 0 for two species (2 = S, -1, 0.5)
    or keeps (1 = S - 1)."""
    s = rng.integers(0, 2, n).astype(np.float64)
    if odd:
        vals = np.array([1.0, 2.0, -1.0, 0.5])
        s[::10] = vals[rng.integers(0, 4, len(s[::10]))]
    return torch.as_tensor(s, dtype=torch.float32, device=dev)


def potentials_vs_plain(dev, n: int) -> dict:
    """Every factory of ops.potentials (the JAX tests' parameters, the
    shifted LJ and lennard_jones(1, 1)) and the mixed pair through the new
    instances of K1, K3, K6 and K7 against the plain version on the card,
    at n = 1e6 on a jittered thin lattice at POT_CUTOFF (8 x 8 cells of
    1.25 across): f32 and split in turns by factory (each kernel's f32 and
    split table instances run), energy and virial modes, K6 and K7 with
    and without the band mask in turns, K3 and K7 to f64 and f32 outputs;
    the species instances (K1 and K6 f32, K3 f32 and split) over a plane
    holding 0, 1 and the values the JAX rule maps (2, -1, 0.5); the
    prune's hard inputs (the facing clusters, the drifted lattice) with
    the LJ and Morse terms in both modes, through K1 and K3 (their keys are
    the lattice's, so the tile windows hold other pairs than the lag
    window: the card tests hold K6 and K7 to their own plain versions
    there); the periodic instances on the
    lattice's own box (ghost images: K1 and K6 with the keep mask;
    ``minimage="auto"``: K1 with both rules, K3 with the minimum image).
    The plain reference of every kernel is the lag path's plain version
    on the same sorted inputs (`pair_lag_reduce_plain`,
    `pair_lag_forces_plain`): K6 and K7 sum the same pairs, and their own
    plain versions (held to them on the card tests' 2e4 points) take
    about 100 times as long here. Energies to TOL_TABLE of the sum of
    |term|, forces per row to TOL_TABLE of the row's sum of |g| |d|."""
    from zelll_tpu_torch.ops.lag_pairs import (
        PbcKeepTerm, pair_lag_forces, pair_lag_forces_plain, pair_lag_reduce,
        pair_lag_reduce_plain, split_f64, suggest_lag,
    )
    from zelll_tpu_torch.ops.pbc import _ghost_bins, _minimage_bins
    from zelll_tpu_torch.ops.potentials import lennard_jones_mixed
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces, tile_pair_reduce
    from zelll_tpu_torch.ops.virial import virial_term_from_gfn

    t_start = time.perf_counter()
    rng = np.random.default_rng(3)
    f64 = torch.float64
    csq = torch.tensor(POT_CUTOFF, dtype=torch.float32) ** 2
    pots = table_potentials()
    mixed = lennard_jones_mixed(MIXED_EPS, MIXED_SIGMA)
    hard = ("lennard_jones", "morse")
    worst = {"energy": 0.0, "forces_row": 0.0}
    checked = dict.fromkeys(("K1", "K3", "K6", "K7"), 0)

    def note(kind, kernel, err):
        worst[kind] = max(worst[kind], err)
        checked[kernel] += 1

    def energies(args, term, what, pay=None, tile=None, **kw):
        """K1 (and K6 with ``tile``, its kwargs) against the lag plain sum."""
        lag = args if pay is None else args + (pay,)
        want = pair_lag_reduce_plain(*lag, term=term, out_dtype=f64, **kw)
        absum = pair_lag_reduce_plain(
            *lag, out_dtype=f64, **kw,
            term=PbcKeepTerm(abs_term(term.term)) if isinstance(term, PbcKeepTerm)
            else abs_term(term))
        note("energy", "K1", energy_check(pair_lag_reduce(*lag, term=term, out_dtype=f64,
                                                          **kw), want, absum, f"K1 {what}"))
        if tile is not None:
            tpay = None if pay is None else pay.reshape(-1)
            got, ok = tile_pair_reduce(*args, tpay, term=term, out_dtype=f64, **tile)
            check(bool(ok), f"K6 coverage ({what})")
            note("energy", "K6", energy_check(got, want, absum, f"K6 {what} {tile}"))

    def forces(args, gfn, what, pay=None, tile=None, **kw):
        """K3 (and K7 with ``tile``) against the lag plain forces, per row."""
        lag = args if pay is None else args + (pay,)
        want = pair_lag_forces_plain(*lag, gfn=gfn, out_dtype=f64, **kw)
        scale = force_row_scale(*lag, gfn=gfn, **kw)
        note("forces_row", "K3", row_check(pair_lag_forces(*lag, gfn=gfn, out_dtype=f64, **kw),
                                           want, scale, f"K3 {what}"))
        check(bool(torch.isfinite(pair_lag_forces(*lag, gfn=gfn, **kw)).all()),
              f"K3 f32 forces ({what})")
        if tile is not None:
            got, ok = tile_pair_forces(*args, gfn=gfn, out_dtype=f64, **tile)
            check(bool(ok), f"K7 coverage ({what})")
            note("forces_row", "K7", row_check(got, want, scale, f"K7 {what} {tile}"))
            f32, _ = tile_pair_forces(*args, gfn=gfn, **tile)
            check(bool(torch.isfinite(f32).all()), f"K7 f32 forces ({what})")

    reset_launches()
    for name, (shi, slo, keys, info) in pot_cases(n, dev, rng).items():
        strides = info.strides
        L = suggest_lag(keys, strides)
        maxj = probe_maxj(keys, strides)
        fmaxj = probe_maxj(keys, strides, full=True)
        for k, (pname, pot) in enumerate(pots.items()):
            if name != "lattice" and pname not in hard:
                continue
            for split in ((False, True) if pname in hard else ((k % 2) == 1,)):
                what = f"{name} {pname} {'split' if split else 'f32'}"
                args = (shi, keys, strides, csq, slo if split else None)
                bandmask = (k // 2) % 2 == 1
                # the hard inputs keep the lattice's keys: the lag and tile
                # windows then hold other pairs, so K6 and K7 run there on
                # the card tests (against their own plain versions)
                tile = name == "lattice"
                for term in (pot.term, virial_term_from_gfn(pot.gfn)):
                    energies(args, term, what, L=L,
                             tile=dict(MAXJ=maxj, bandmask=bandmask) if tile else None)
                forces(args, pot.gfn, what, L=L,
                       tile=dict(MAXJ=fmaxj, bandmask=bandmask) if tile else None)
        # the species instances: K1 and K6 f32, K3 f32 and split
        sp = species_plane(shi.shape[0], rng, dev)
        for bandmask in ((False, True) if name == "lattice" else (None,)):
            energies((shi, keys, strides, csq, None), mixed.term, f"species {name}",
                     pay=sp[:, None], L=L,
                     tile=None if bandmask is None else dict(MAXJ=maxj, bandmask=bandmask))
        for plo in (None, slo):
            forces((shi, keys, strides, csq, plo), mixed.gfn, f"species {name}",
                   pay=sp[:, None], L=L)
        if name == "lattice":
            pts = (shi.double() + slo.double()).cpu().numpy()
    # the periodic instances on the lattice's own box
    box = np.ceil(pts.max(0) / POT_SPACING) * POT_SPACING
    hi, lo = split_f64(torch.as_tensor(np.mod(pts, box), device=dev))
    m = hi.shape[0]
    gbins, gsp, gslo, signs, ok = _ghost_bins(hi, [0.0] * 3, box, POT_CUTOFF, B=m, G=3 * m,
                                              BE=m, positions_lo=lo, need_perm=False)
    check(bool(ok), "ghost images of the potentials' lattice")
    # B as suggested (the sorted-extremes path takes B < 2^18 rows)
    mbins, msp, mslo, mpay, reach, mbox, ok = _minimage_bins(
        hi, [0.0] * 3, box, POT_CUTOFF, np.array([True, True, False]), B=None, G=None,
        positions_lo=lo, need_perm=False)
    check(bool(ok), "minimum-image bins of the potentials' lattice")
    gL = suggest_lag(gbins.sorted_keys, gbins.info.strides)
    gmaxj = probe_maxj(gbins.sorted_keys, gbins.info.strides)
    mL = suggest_lag(mbins.sorted_keys, mbins.info.strides, reach=reach)
    for pname in hard:
        pot = pots[pname]
        for split in (False, True):
            what = f"{pname} split={split}"
            gargs = (gsp, gbins.sorted_keys, gbins.info.strides, csq, gslo if split else None)
            margs = (msp, mbins.sorted_keys, mbins.info.strides, csq, mslo if split else None)
            mkw = dict(L=mL, mi_box=mbox, key_reach=reach)
            for term in (pot.term, virial_term_from_gfn(pot.gfn)):
                energies(gargs, PbcKeepTerm(term), f"keep {what}", pay=signs, L=gL,
                         tile=dict(MAXJ=gmaxj, bandmask=split))
                energies(margs, PbcKeepTerm(term), f"keep + minimum image {what}", pay=mpay,
                         **mkw)
            forces(margs, pot.gfn, f"minimum image {what}", **mkw)
    counts = read_launches()
    for k in ("lag_reduce", "lag_forces", "tile_reduce", "tile_forces"):
        check(counts[k] > 0, f"potentials_vs_plain never launched {k}")
    return dict(n=n, cutoff=POT_CUTOFF, spacing=POT_SPACING, potentials=list(pots),
                max_energy_err_of_abs_sum=worst["energy"],
                max_force_row_err=worst["forces_row"], checks=checked,
                check_launches={k: v for k, v in counts.items() if v},
                seconds=time.perf_counter() - t_start)


def species_reference(pts: np.ndarray, spec: np.ndarray, box, cutoff: float):
    """Exact-f64 minimum-image mixed-LJ forces of points in [0, box) with
    species ids (0 or 1): numpy ghost images (every image within ``cutoff``
    of a face, with its parent's species) and the oracle's pair list, with
    the pair parameters (eps_ij, sigma_ij) as the f32 potential holds them.
    Returns (forces, each row's scale: the sum over its pairs of both LJ
    parts' magnitudes, 24 eps_ij t (2t + 1) / dsq |d|)."""
    from itertools import product

    from zelll_tpu_torch import oracle
    from zelll_tpu_torch.ops.potentials import lennard_jones_mixed, species_table

    n = len(pts)
    box = np.asarray(box, np.float64)
    low, high = pts < cutoff, pts >= box - cutoff
    shift = np.where(low, box, np.where(high, -box, 0.0))
    ext, parent = [pts], [np.arange(n)]
    for m in product((0, 1), repeat=3):
        if any(m):
            m = np.asarray(m, bool)
            sel = np.all((low | high)[:, m], axis=1)
            ext.append(pts[sel] + np.where(m, shift[sel], 0.0))
            parent.append(np.flatnonzero(sel))
    ext, parent = np.concatenate(ext), np.concatenate(parent)
    s = spec.astype(np.int64)[parent]
    # the pair parameters as the f32 potential holds them (species_table)
    S = len(MIXED_EPS)
    table = np.asarray(species_table(lennard_jones_mixed(MIXED_EPS, MIXED_SIGMA).gfn.table),
                       np.float64).reshape(S, S, 2)
    i, j = oracle.pairs(ext, cutoff)
    i, j = i.astype(np.int64), j.astype(np.int64)
    d = ext[i] - ext[j]
    dsq = (d * d).sum(1)
    e_ij = table[s[i], s[j], 0]
    s_ij = table[s[i], s[j], 1]
    t = (s_ij * s_ij / dsq) ** 3
    g = 24.0 * e_ij * t * (2.0 * t - 1.0) / dsq
    f = np.zeros((len(ext), 3))
    for a in range(3):
        f[:, a] = np.bincount(i, g * d[:, a], len(ext)) - np.bincount(j, g * d[:, a], len(ext))
    # both LJ parts' magnitudes, as `periodic_reference` scales a row: near
    # the minimum they cancel in g, and f32 keeps their rounding
    size = 24.0 * e_ij * t * (2.0 * t + 1.0) / dsq * np.sqrt(dsq)
    scale = np.bincount(i, size, len(ext)) + np.bincount(j, size, len(ext))
    return f[:n], scale[:n]


def species_pbc(dev, n: int) -> dict:
    """`pbc_lj_forces(species=)` with ``minimage=False`` (ghost images on
    every axis, K3's species factor) and ``"auto"`` (x and y folded, z
    ghosts, K3's species factor with the minimum image) at n (main: 5e5) on the
    thin box, split coordinates of f64 points, the uniform cloud and a
    jittered lattice, species 0 and 1 from default_rng(0), the mixed pair:
    each row of the entry point's forces against `species_reference` (to
    TOL_ROW of the row's scale there, both LJ parts' magnitudes), and K3
    against its plain version on the card on the sorted inputs the entry
    point builds (`_ghost_bins` / `_minimage_bins` with the species as
    their extra column; to TOL_TABLE of each row's sum of |g| |d|)."""
    from zelll_tpu_torch.ops.lag_pairs import (
        pair_lag_forces, pair_lag_forces_plain, split_f64,
    )
    from zelll_tpu_torch.ops.pbc import (
        _ghost_bins, _minimage_bins, minimage_axes, pbc_lj_forces, suggest_pbc_capacity,
    )
    from zelll_tpu_torch.ops.potentials import lennard_jones_mixed
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    mixed = lennard_jones_mixed(MIXED_EPS, MIXED_SIGMA)
    box = np.asarray(lj_box(n, CUTOFF))
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    out = {}
    for cloud, make in (("uniform", generate_points_random),
                        ("lattice", generate_points_lattice)):
        pts = np.mod(make(n, box), box)
        spec = np.random.default_rng(0).integers(0, 2, len(pts)).astype(np.float64)
        f_ref, scale = species_reference(pts, spec, box, CUTOFF)
        hi, lo = split_f64(torch.as_tensor(pts, device=dev))
        sp = torch.as_tensor(spec, dtype=torch.float32, device=dev)
        for mi in (False, "auto"):
            kw = dict(gfn=mixed.gfn, minimage=mi, positions_lo=lo, species=sp)
            L = probe_pbc_lag(lambda L: pbc_lj_forces(hi, [0.0] * 3, box, CUTOFF, L=L,
                                                      **kw)[1], L_MAIN)
            reset_launches()
            f, ok = pbc_lj_forces(hi, [0.0] * 3, box, CUTOFF, L=L, **kw)
            torch.cuda.synchronize()
            launches = read_launches()
            check(bool(ok) and launches["lag_forces"] == 1,
                  f"species_pbc flags or launches {launches} ({cloud} {mi})")
            vs_ref = row_check(f.double().cpu(), torch.as_tensor(f_ref), torch.as_tensor(scale),
                               f"species_pbc reference {cloud} {mi}", tol=TOL_ROW)
            # the kernel against its plain version on the entry point's inputs
            if mi:
                mask = minimage_axes(box, CUTOFF)
                B, G = suggest_pbc_capacity(n, box, CUTOFF, axes=~mask)
                bins, spos, slo, _, reach, mib, okb, spay = _minimage_bins(
                    hi, [0.0] * 3, box, CUTOFF, mask, B=B, G=G, positions_lo=lo,
                    need_perm=False, extra=sp)
                fk = dict(mi_box=mib, key_reach=reach)
            else:
                B, G, BE = suggest_pbc_capacity(n, box, CUTOFF, with_multi=True)
                bins, spos, slo, _, okb, spay = _ghost_bins(
                    hi, [0.0] * 3, box, CUTOFF, B=B, G=G, BE=BE, positions_lo=lo,
                    need_perm=False, signs=False, extra=sp)
                fk = {}
            check(bool(okb), f"species_pbc sorted inputs ({cloud} {mi})")
            args = (spos, bins.sorted_keys, bins.info.strides, csq, slo, spay)
            got = pair_lag_forces(*args, L=L, gfn=mixed.gfn, out_dtype=torch.float64, **fk)
            want = pair_lag_forces_plain(*args, L=L, gfn=mixed.gfn, out_dtype=torch.float64,
                                         **fk)
            rscale = force_row_scale(*args, L=L, gfn=mixed.gfn, **fk)
            vs_plain = row_check(got, want, rscale, f"species_pbc plain {cloud} {mi}")
            out[f"{cloud}_{'minimage' if mi else 'ghosts'}"] = dict(
                n=n, L=L, row_err_vs_plain=vs_plain, row_err_vs_reference=vs_ref,
                launches={k: v for k, v in launches.items() if v})
    return out


def species_main_path(dev, n: int) -> dict:
    """This slice's path at full size: the thin MD protocol's start state
    (`md_states` on lj_box(1e7): 8,617,716 lattice points, cutoff 10),
    species uniform in {0, 1} from default_rng(0), the mixed pair of
    tpu_parity.py. `md_step_species` for MD_STEPS steps (one warm-up) and
    `md_run_species` over 10 steps: step ms by CUDA events and host ms,
    the launches of each window (zeroed just before, read just after,
    exact: one K3 a step, one K1 a run), the device's busy share from the
    profiler, peak memory; then K3's and K1's species instances alone on
    the sorted species state (ms, bound, a plain call's ms at 1e6) and K3
    against its plain version there (f64 outputs, per row)."""
    from zelll_tpu_torch.core import key_window
    from zelll_tpu_torch.models import md_run_species, md_step_species
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count, count_term, pair_lag_forces, pair_lag_forces_plain, pair_lag_reduce,
        pair_lag_reduce_plain,
    )
    from zelll_tpu_torch.ops.potentials import lennard_jones_mixed
    from zelll_tpu_torch.utils.datagen import lj_box

    pot = lennard_jones_mixed(MIXED_EPS, MIXED_SIGMA)
    _, st, _ = md_states(n, lj_box(n, CUTOFF), dev)
    n = st.positions.shape[0]
    spec = torch.as_tensor(np.random.default_rng(0).integers(0, 2, n), dtype=torch.float32,
                           device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = [spec]

    def step(s):
        s, held[0], ok = md_step_species(s, held[0], CUTOFF, MD_DT, pot=pot, L=L_MAIN)
        return s, ok

    reset_launches()
    t, st2 = time_steps(step, st, MD_STEPS)
    spec2 = held[0]
    torch.cuda.synchronize()
    counts = read_launches()
    want = {k: (MD_STEPS + 1) * (k == "lag_forces") for k in counts}
    check(counts == want, f"md_step_species launches {counts} != {want}")
    t["launches"] = {k: v for k, v in counts.items() if v}
    reset_launches()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    st3, spec3, ok, energy = md_run_species(st, spec, CUTOFF, MD_DT, pot=pot, steps=10,
                                            L=L_MAIN)
    end.record()
    end.synchronize()
    run_host = (time.perf_counter() - t_host) * 1e3
    counts = read_launches()
    want = {k: {"lag_forces": 10, "lag_reduce": 1}.get(k, 0) for k in counts}
    check(counts == want, f"md_run_species launches {counts} != {want}")
    check(bool(ok) and np.isfinite(float(energy)), "md_run_species flag or energy")
    check(torch.equal(torch.sort(spec3)[0], torch.sort(spec)[0]),
          "the species column lost or changed rows")
    peak = torch.cuda.max_memory_allocated()
    run = dict(steps=10, run_ms=start.elapsed_time(end), host_ms=run_host,
               energy=float(energy), energy_per_atom=float(energy) / n,
               launches={k: v for k, v in counts.items() if v})
    ph = [st, spec]

    def profiled(i):
        ph[0], ph[1], _ = md_step_species(ph[0], ph[1], CUTOFF, MD_DT, pot=pot, L=L_MAIN)

    prof = profile_steps(profiled)
    del ph
    # K3's and K1's species instances alone on the sorted species state
    shi, _, keys, info, perm = sort_split(st2.positions.double().cpu().numpy(), dev)
    sp = spec2[perm][:, None]
    strides = info.strides
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    pairs = combine_count(pair_lag_reduce(shi, keys, strides, csq, L=L_MAIN, term=count_term,
                                          out_dtype=torch.int32))
    candidates = stencil_candidates(keys, info)
    first = torch.searchsorted(keys, keys - key_window(strides))
    window = int(torch.clamp(torch.arange(n, device=dev) - first, max=L_MAIN).sum())
    k3_ms = cuda_ms(lambda: pair_lag_forces(shi, keys, strides, csq, None, sp, L=L_MAIN,
                                            gfn=pot.gfn), 10)
    k1_ms = cuda_ms(lambda: pair_lag_reduce(shi, keys, strides, csq, None, sp, L=L_MAIN,
                                            term=pot.term), 10)
    got = pair_lag_forces(shi, keys, strides, csq, None, sp, L=L_MAIN, gfn=pot.gfn,
                          out_dtype=torch.float64)
    want = pair_lag_forces_plain(shi, keys, strides, csq, None, sp, L=L_MAIN, gfn=pot.gfn,
                                 out_dtype=torch.float64)
    scale = force_row_scale(shi, keys, strides, csq, None, sp, L=L_MAIN, gfn=pot.gfn)
    k3_row = row_check(got, want, scale, "K3 species on the MD state")
    k3_abs = float((got - want).abs().max())
    e_k = pair_lag_reduce(shi, keys, strides, csq, None, sp, L=L_MAIN, term=pot.term,
                          out_dtype=torch.float64)
    e_p = pair_lag_reduce_plain(shi, keys, strides, csq, None, sp, L=L_MAIN, term=pot.term,
                                out_dtype=torch.float64)
    e_s = pair_lag_reduce_plain(shi, keys, strides, csq, None, sp, L=L_MAIN,
                                term=abs_term(pot.term), out_dtype=torch.float64)
    k1_err = energy_check(e_k, e_p, e_s, "K1 species on the MD state")
    m = N_PARITY
    k3_plain_ms = once_ms(lambda: pair_lag_forces_plain(shi[:m], keys[:m], strides, csq, None,
                                                        sp[:m], L=L_MAIN, gfn=pot.gfn))[0]
    k1_plain_ms = once_ms(lambda: pair_lag_reduce_plain(shi[:m], keys[:m], strides, csq, None,
                                                        sp[:m], L=L_MAIN, term=pot.term))[0]
    # the species instances' work: the LJ instances' and one more plane
    k3_b = bound(n * 4 * (3 + 1 + 1 + 3),
                 candidates * INSTR_PER_CANDIDATE[False] + pairs * INSTR_PER_FORCE_PAIR)
    k1_b = bound(n * 4 * (3 + 1 + 1),
                 window * INSTR_PER_CANDIDATE[False] + pairs * INSTR_PER_PAIR)
    return dict(n=n, cutoff=CUTOFF, dt=MD_DT, species="uniform {0, 1}, default_rng(0)",
                eps=MIXED_EPS, sigma=MIXED_SIGMA, md_step_species=t, md_run_species=run,
                profile=prof, max_memory_allocated=peak, pairs=pairs,
                K3_species=dict(ms=k3_ms, plain_ms=k3_plain_ms, plain_n=m, **k3_b,
                                share_of_bound=k3_b["bound_ms"] / k3_ms, max_abs_err=k3_abs,
                                row_err=k3_row),
                K1_species=dict(ms=k1_ms, plain_ms=k1_plain_ms, plain_n=m, **k1_b,
                                share_of_bound=k1_b["bound_ms"] / k1_ms,
                                max_abs_err=abs(float(e_k) - float(e_p)),
                                err_of_abs_sum=k1_err))


def minimage_general_sum(pos, box, mimask, B, G, L, term=None, out_dtype=None):
    """`pbc_pair_sum(minimage="auto")`'s lag path with `_minimage_bins`'
    general path in place of the sorted-extremes one: (total, ok)."""
    from zelll_tpu_torch.ops.lag_pairs import (
        PbcKeepTerm, lag_coverage_ok, lj_term, pair_lag_reduce,
    )
    from zelll_tpu_torch.ops.pbc import _minimage_bins_general

    bins, sp, slo, pay, reach, mi_box, ok = _minimage_bins_general(
        pos, [0.0] * 3, box, CUTOFF, mimask, B=B, G=G, positions_lo=None, need_perm=False)
    total = pair_lag_reduce(sp, bins.sorted_keys, bins.info.strides,
                            torch.tensor(CUTOFF, dtype=pos.dtype) ** 2, slo, pay, L=L,
                            term=PbcKeepTerm(term or lj_term), out_dtype=out_dtype,
                            mi_box=mi_box, key_reach=reach)
    return total, ok & lag_coverage_ok(bins.sorted_keys, bins.info.strides, L, reach=reach)


def table_rows(spm, pmp) -> list:
    """The kernels line's rows of the term table's instances (from
    `potentials_main_path`: launches counted on its calls, ms, plain ms and
    bound on the sorted inputs its calls build) and of the species
    instances (timed on `species_main_path`'s sorted state; launches from
    its MD run)."""
    rows = []
    for name, src, replaces, key in (
            ("lag_reduce_table", "lag_reduce", "zelll_tpu/ops/pallas_pairs.py:230", "K1"),
            ("lag_forces_table", "lag_forces", "zelll_tpu/ops/pallas_pairs.py:583", "K3"),
            ("tile_reduce_table", "tile_reduce", "zelll_tpu/ops/tile_pairs.py:259", "K6"),
            ("tile_forces_table", "tile_forces", "zelll_tpu/ops/tile_pairs.py:1025", "K7")):
        row = pmp["kernels"][key]
        rows.append(dict(name=name, route="cuda", source=f"zelll_tpu_torch/csrc/{src}.cu",
                         replaces=replaces, instance=row["instance"],
                         launches=pmp["launches"][src], max_abs_err=row["max_abs_err"],
                         err_of_scale=row["err_of_scale"], ms=row["ms"],
                         lj_instance_ms=row["lj_ms"], plain_ms=row["plain_ms"],
                         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                         share_of_bound=row["share_of_bound"], n=row["rows"],
                         library_ms=None))
    for name, src, replaces, row, launches in (
            ("lag_reduce_species", "lag_reduce", "zelll_tpu/ops/pallas_pairs.py:230",
             spm["K1_species"], spm["md_run_species"]["launches"]["lag_reduce"]),
            ("lag_forces_species", "lag_forces", "zelll_tpu/ops/pallas_pairs.py:583",
             spm["K3_species"], spm["md_step_species"]["launches"]["lag_forces"]
             + spm["md_run_species"]["launches"]["lag_forces"])):
        rows.append(dict(name=name, route="cuda", source=f"zelll_tpu_torch/csrc/{src}.cu",
                         replaces=replaces, instance="species plane, lennard_jones_mixed, f32",
                         launches=launches, max_abs_err=row["max_abs_err"], ms=row["ms"],
                         plain_ms=row["plain_ms"], plain_n=row["plain_n"],
                         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                         share_of_bound=row["share_of_bound"], n=spm["n"], library_ms=None))
    return rows


def potentials_main_path(dev, n: int) -> dict:
    """The table instances through the entry points a user calls, at
    n = 1e7: `fused_lj_rebuild_energy` with the shifted LJ and
    `virial_rebuild` with the LJ gfn (K1 table, energy and virial modes,
    split, on the thin uniform cloud), `md_step_pbc` with the LJ gfn and
    ``minimage="auto"`` (K3 table with the minimum image, f32, thin box),
    `tile_lj_rebuild_energy` with the shifted LJ (K6 table) and
    `tile_pair_forces` with the LJ gfn (K7 table) on the cubic MD start
    state (9,938,375 lattice points). Each call's launches are zeroed just
    before it and read just after (exactly one of its kernel), and
    ``launches`` sums them by kernel. Then on the sorted inputs each call
    builds: the kernel against its plain version (K1 and K6 energies to
    TOL_TABLE of the sum of |term|, K3 rows to TOL_TABLE of each row's sum
    of |g| |d|, K7 to TOL_TABLE of the lattice's largest force: the cube's
    per-row scale would need a lag window of millions), the table
    instance's ms beside the LJ instance's (lennard_jones() is
    lennard_jones(1, 1), the LJ instance `lj_term` / `lj_force_factor`;
    K6 and K7 through their launch functions on the tile inputs), one
    plain call's ms, and the bound of that work."""
    from zelll_tpu_torch.core import GridInfo, aabb_from_positions, compute_keys
    from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count, count_term, lj_term, pair_lag_forces, pair_lag_forces_plain,
        pair_lag_reduce, pair_lag_reduce_plain, split_f64,
    )
    from zelll_tpu_torch.ops.lj import lj_force_factor
    from zelll_tpu_torch.ops.pbc import (
        _minimage_bins, md_step_pbc, minimage_axes, suggest_pbc_capacity,
    )
    from zelll_tpu_torch.ops.potentials import lennard_jones, shifted
    from zelll_tpu_torch.ops.tile_pairs import (
        forces_tiles, reduce_tiles, tile_inputs, tile_lj_rebuild_energy, tile_pair_forces,
        tile_pair_forces_plain, tile_pair_reduce, tile_pair_reduce_plain,
    )
    from zelll_tpu_torch.ops.virial import virial_rebuild, virial_term_from_gfn
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    lj, slj = lennard_jones(), shifted(lennard_jones(), CUTOFF)
    f64 = torch.float64
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    thin = np.asarray(lj_box(n, CUTOFF))
    pts = generate_points_random(n, thin)
    hi, lo = split_f64(torch.as_tensor(pts, device=dev))
    calls, kernels = {}, {}
    launches = dict.fromkeys(("lag_reduce", "lag_forces", "tile_reduce", "tile_forces"), 0)

    def call(name, fn, kernel):
        reset_launches()
        r = fn()
        torch.cuda.synchronize()
        counts = read_launches()
        others = sum(v for k, v in counts.items() if k != kernel)
        check(counts[kernel] == 1 and others == 0,
              f"{name}: expected one launch of {kernel} alone, counted {counts}")
        for k in launches:
            launches[k] += counts[k]
        flags = [x for x in (r if isinstance(r, tuple) else (r,)) if x.dtype == torch.bool]
        check(all(bool(f) for f in flags), f"a flag is False ({name})")
        ms, _ = once_ms(fn)
        calls[name] = dict(ms=ms, launches={k: v for k, v in counts.items() if v})
        return r

    def energy_vs_plain(kernel, fn, plain, abs_plain, what):
        """An energy kernel's f64 total against its plain version's."""
        plain_ms, want = once_ms(plain)
        got = fn()
        err = energy_check(got, want, abs_plain(), f"{kernel} {what} at the main path's inputs")
        return dict(plain_ms=plain_ms, max_abs_err=abs(float(got) - float(want)),
                    err_of_scale=err)

    def timed(row, table, checked, b, lj, **extra):
        """A kernel's row: the table instance's ms and the LJ instance's
        (``lj``) on the same inputs, the check's plain ms and errors, the
        bound of the work."""
        ms = cuda_ms(table, 10)
        row.update(ms=ms, lj_ms=cuda_ms(lj, 10), **checked, **b,
                   share_of_bound=b["bound_ms"] / ms, **extra)
        return row

    # K1: the fused rebuild and the virial, split, on the thin uniform cloud
    e = call("fused_lj_rebuild_energy_shifted",
             lambda: fused_lj_rebuild_energy(hi, CUTOFF, lo, L=L_MAIN, term=slj.term),
             "lag_reduce")
    w = call("virial_rebuild_lj", lambda: virial_rebuild(hi, CUTOFF, lo, gfn=lj.gfn, L=L_MAIN),
             "lag_reduce")
    check(np.isfinite(float(e[0])) and np.isfinite(float(w[0])), "non-finite K1 table sums")
    shi, slo, keys, info, _ = sort_split(pts, dev)
    lag = (shi, keys, info.strides, csq, slo)
    vterm = virial_term_from_gfn(lj.gfn)
    k1 = energy_vs_plain(
        "K1", lambda: pair_lag_reduce(*lag, L=L_MAIN, term=slj.term, out_dtype=f64),
        lambda: pair_lag_reduce_plain(*lag, L=L_MAIN, term=slj.term, out_dtype=f64),
        lambda: pair_lag_reduce_plain(*lag, L=L_MAIN, term=abs_term(slj.term), out_dtype=f64),
        "shifted LJ energy")
    k1v = energy_vs_plain(
        "K1", lambda: pair_lag_reduce(*lag, L=L_MAIN, term=vterm, out_dtype=f64),
        lambda: pair_lag_reduce_plain(*lag, L=L_MAIN, term=vterm, out_dtype=f64),
        lambda: pair_lag_reduce_plain(*lag, L=L_MAIN, term=abs_term(vterm), out_dtype=f64),
        "LJ virial")
    pairs = combine_count(pair_lag_reduce(*lag, L=L_MAIN, term=count_term,
                                          out_dtype=torch.int32))
    window = window_candidates(keys, info.strides, L_MAIN)
    kernels["K1"] = timed(
        dict(instance="term table, shifted(lennard_jones(), 10), energy mode, split",
             rows=n, virial=k1v),
        lambda: pair_lag_reduce(*lag, L=L_MAIN, term=slj.term), k1,
        bound(n * 4 * (6 + 1), window * INSTR_PER_CANDIDATE[True] + pairs * INSTR_PER_PAIR),
        lj=lambda: pair_lag_reduce(*lag, L=L_MAIN, term=lj_term), pairs=pairs,
        candidates=window)
    del shi, slo, keys, lag

    # K3: one MD step with the minimum image, f32, on the thin box
    mask = minimage_axes(thin, CUTOFF)
    Bm, Gm = suggest_pbc_capacity(n, thin, CUTOFF, axes=~mask)
    kwm = dict(B=Bm, G=Gm, minimage="auto", gfn=lj.gfn)
    Lm = probe_pbc_lag(lambda L: md_step_pbc(hi, torch.zeros_like(hi), [0.0] * 3, thin,
                                             CUTOFF, MD_DT, L=L, **kwm)[2], L_MAIN)
    r = call("md_step_pbc_minimage_lj", lambda: md_step_pbc(
        hi, torch.zeros_like(hi), [0.0] * 3, thin, CUTOFF, MD_DT, L=Lm, **kwm), "lag_forces")
    check(bool(torch.isfinite(r[0]).all()), "non-finite md_step_pbc positions")
    bins, sp, _, _, reach, mib, ok, *_ = _minimage_bins(
        hi, [0.0] * 3, thin, CUTOFF, mask, B=Bm, G=Gm, positions_lo=None, need_perm=False)
    check(bool(ok), "the minimum-image bins of the K3 call")
    margs = (sp, bins.sorted_keys, bins.info.strides, csq)
    fkw = dict(L=Lm, mi_box=mib, key_reach=reach)
    plain_ms, want = once_ms(lambda: pair_lag_forces_plain(*margs, gfn=lj.gfn, out_dtype=f64,
                                                           **fkw))
    got = pair_lag_forces(*margs, gfn=lj.gfn, out_dtype=f64, **fkw)
    row_err = row_check(got, want, force_row_scale(*margs, gfn=lj.gfn, **fkw),
                        "K3 table with the minimum image at the main path's inputs")
    rows = sp.shape[0]
    mpairs = combine_count(pair_lag_reduce(*margs, term=count_term, out_dtype=torch.int32,
                                           **fkw))
    mcand = window_candidates(bins.sorted_keys, bins.info.strides, Lm, reach)
    kernels["K3"] = timed(
        dict(instance="term table, lennard_jones(), minimum image, f32", rows=rows),
        lambda: pair_lag_forces(*margs, gfn=lj.gfn, **fkw),
        dict(plain_ms=plain_ms, max_abs_err=force_err(got, want)[0], err_of_scale=row_err),
        bound(rows * 4 * (3 + 1 + 3),
              mcand * (INSTR_PER_CANDIDATE[False] + 2 * INSTR_MI_FOLD[False])
              + mpairs * INSTR_PER_FORCE_PAIR),
        lj=lambda: pair_lag_forces(*margs, gfn=lj_force_factor, **fkw), pairs=mpairs,
        candidates=mcand)
    del hi, lo, bins, sp, margs, got, want

    # K6 and K7 on the cubic MD start state, f32: a lattice, whose forces
    # are all of one size, so the largest force scales every row's error
    side = (n / 0.01) ** (1 / 3)
    _, cst, _ = md_states(n, (side, side, side), dev)
    cpos = cst.positions
    m = cpos.shape[0]
    del cst
    cinfo = GridInfo.create(aabb_from_positions(cpos), CUTOFF, auto_order=True)
    ckeys, perm = torch.sort(compute_keys(cpos, cinfo))
    maxj = probe_maxj(ckeys, cinfo.strides)
    fmaxj = probe_maxj(ckeys, cinfo.strides, full=True)
    e = call("tile_lj_rebuild_energy_shifted",
             lambda: tile_lj_rebuild_energy(cpos, CUTOFF, MAXJ=maxj, term=slj.term),
             "tile_reduce")
    spos = cpos[perm]
    tile = (spos, ckeys, cinfo.strides, csq)
    f = call("tile_pair_forces_lj", lambda: tile_pair_forces(*tile, MAXJ=fmaxj, gfn=lj.gfn),
             "tile_forces")
    check(np.isfinite(float(e[0])) and bool(torch.isfinite(f[0]).all()),
          "non-finite K6 or K7 table results")
    del f
    kw = dict(MAXJ=maxj, bandmask=False)
    k6 = energy_vs_plain(
        "K6", lambda: tile_pair_reduce(*tile, term=slj.term, out_dtype=f64, **kw)[0],
        lambda: tile_pair_reduce_plain(*tile, term=slj.term, out_dtype=f64, **kw)[0],
        lambda: tile_pair_reduce_plain(*tile, term=abs_term(slj.term), out_dtype=f64,
                                       **kw)[0],
        "shifted LJ energy")
    cpairs = combine_count(tile_pair_reduce(*tile, term=count_term, out_dtype=torch.int32,
                                            **kw)[0])
    cand = stencil_candidates(ckeys, cinfo)
    # K6 and K7 timed through their launch functions on the inputs their
    # entry points build, as `tile_reduce_alone` and `tile_forces_alone` do
    inp = tile_inputs(spos.t().contiguous(), ckeys, cinfo.strides, CB=CB, **kw)
    check(bool(inp.coverage_ok), "K6 coverage on the cubic MD start state")
    kernels["K6"] = timed(
        dict(instance="term table, shifted(lennard_jones(), 10), energy mode, f32", rows=m),
        lambda: reduce_tiles(inp, csq, term=slj.term), k6,
        bound(m * 4 * (3 + 1) + inp.bounds.numel() * 4, cand * INSTR_PER_CANDIDATE[False]
              + cpairs * INSTR_PER_PAIR),
        lj=lambda: reduce_tiles(inp, csq, term=lj_term), pairs=cpairs, candidates=cand)
    del inp
    fkw = dict(MAXJ=fmaxj, bandmask=False)
    plain_ms, (want, _) = once_ms(lambda: tile_pair_forces_plain(*tile, gfn=lj.gfn,
                                                                 out_dtype=f64, **fkw))
    got, _ = tile_pair_forces(*tile, gfn=lj.gfn, out_dtype=f64, **fkw)
    err, scale = force_err(got, want)
    check(np.isfinite(err) and err <= TOL_TABLE * scale,
          f"K7 table at the main path's inputs: max |df| {err} of {scale}")
    finp = tile_inputs(spos.t().contiguous(), ckeys, cinfo.strides, CB=CB, full=True, **fkw)
    check(bool(finp.coverage_ok), "K7 coverage on the cubic MD start state")
    kernels["K7"] = timed(
        dict(instance="term table, lennard_jones(), f32", rows=m),
        lambda: forces_tiles(finp, csq, gfn=lj.gfn),
        dict(plain_ms=plain_ms, max_abs_err=err, err_of_scale=err / scale),
        bound(m * 4 * (3 + 1 + 3) + finp.bounds.numel() * 4, cand * INSTR_PER_CANDIDATE[False]
              + cpairs * INSTR_PER_FORCE_PAIR),
        lj=lambda: forces_tiles(finp, csq, gfn=lj_force_factor), pairs=cpairs,
        candidates=cand)
    return dict(n=n, L_minimage=Lm, MAXJ=maxj, full_MAXJ=fmaxj, calls=calls,
                launches=launches, kernels=kernels)


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


# -- periodic observables (ops/virial.py, ops/rdf.py: K4 and K5 with the keep
# mask and the minimum image, K8 and K9 with the keep mask) and the barostat
# (models/thermostats.py: md_run_npt) ------------------------------------------

NPT_STEPS = 10
# the barostat's settings on npt_main_path (tests/test_npt.py's form): a
# target below the start state's pressure, so the box grows a little
NPT_P_TARGET = 0.0
NPT_TAU_P = 0.01
# md_run_npt with beta = 0 against md_step_pbc: the same f32 operations on
# the same sorted inputs, held to two f32 ulp of the box side
NPT_BETA0_STEPS = 2


def ptxas_functions(log: str, key: str) -> dict:
    """Each kernel function of a build log whose mangled name holds ``key``:
    its registers line and its spill line (ptxas -v)."""
    out, func = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            func = ln.split("'")[1] if "'" in ln else ln.strip()
            func = func if key in func else None
        elif func is not None and ("registers" in ln or "spill" in ln):
            out.setdefault(func, []).append(ln.strip().removeprefix("ptxas info    : "))
    return out


def periodic_images(pts: np.ndarray, box, cutoff: float) -> np.ndarray:
    """The points of [0, box) and their ghost images (numpy f64): every
    image within ``cutoff`` of a face, up to 7 for a corner, after the n
    real rows."""
    from itertools import product

    box = np.asarray(box, np.float64)
    low, high = pts < cutoff, pts >= box - cutoff
    shift = np.where(low, box, np.where(high, -box, 0.0))
    ext = [pts]
    for m in product((0, 1), repeat=3):
        if any(m):
            m = np.asarray(m, bool)
            sel = np.all((low | high)[:, m], axis=1)
            ext.append(pts[sel] + np.where(m, shift[sel], 0.0))
    return np.concatenate(ext)


def periodic_observables(pts: np.ndarray, box, cutoff: float, edges) -> tuple:
    """Exact-f64 minimum-image stress, virial and cumulative pair counts
    below each edge of points in [0, box): the oracle's pairs on the points
    and their ghost images (`periodic_images`), a pair of two real rows
    weighing 1 and a real-ghost pair 1/2 (its mirror pairs the other end's
    real row), as `periodic_reference` counts them. Returns (sigma (3, 3),
    W, cumulative counts (K,))."""
    from zelll_tpu_torch import oracle

    n = len(pts)
    ext = periodic_images(pts, box, cutoff)
    i, j = oracle.pairs(ext, cutoff)
    i, j = i.astype(np.int64), j.astype(np.int64)
    real = (i < n).astype(np.int64) + (j < n)
    keep = real > 0
    i, j, w = i[keep], j[keep], np.where(real[keep] == 2, 1.0, 0.5)
    esq = np.asarray(edges, np.float64) ** 2
    sig, shells = np.zeros((3, 3)), np.zeros(len(esq) + 1)
    for s in range(0, len(i), 1 << 22):
        sl = slice(s, s + (1 << 22))
        d = ext[i[sl]] - ext[j[sl]]
        dsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        inv = 1.0 / dsq
        t = inv**3
        sig += np.einsum("p,pa,pb->ab", w[sl] * 24 * t * (2 * t - 1) * inv, d, d)
        shells += np.bincount(np.searchsorted(esq, dsq, side="right"), w[sl],
                              minlength=len(esq) + 1)
    cum = np.cumsum(shells[:len(esq)])
    check(np.all(cum == np.round(cum)), "the periodic observables' half pairs do not pair up")
    return sig, float(np.trace(sig)), cum


def pbc_obs_vs_plain(dev, n: int) -> dict:
    """The periodic observables' kernel instances against their plain
    versions on identical sorted inputs (n = 2e5), each alone: K4 and K5
    with the keep mask (thin box, ghost images on every axis), the minimum
    image alone (x and y folded, z open) and both (``minimage="auto"``),
    f32 and split, on the uniform cloud, a jittered lattice, the seam
    lattices of `pbc_vs_plain` (the rounding box among them, where split
    mode's fold carries the box's low part), the lattice drifted since its
    keys were built and the facing clusters of `cluster_gap` (`prune_cases`)
    on it; K4 with both force factors on the lattice; K5 also with a
    species mask over a second plane, composed with the keep mask where
    there is a keep plane (mask id 3); both with the keep mask in f64 on
    the lattice. K8 and K9 with the keep mask on the ghost-extended cube of
    `pbc_vs_plain`'s four inputs, maskless, f32 and split, and on the
    lattice also masked and f64. Stress on f64 outputs to TOL_KERNEL of the
    largest component (TOL_FAST_FORCES with the fast factor), counts
    exact at K = HIST_K. ``max_abs_err`` per instance and mode (e.g.
    ``K4_keep_minimage_f32``): the stress's max |d sigma| on the lattice
    (the exact factor), the histograms' largest count difference over every
    input."""
    from zelll_tpu_torch.ops.lag_pairs import (
        PbcSpeciesPairMask, SpeciesPairMask, combine_count_vec, pair_lag_hist,
        pair_lag_hist_plain, pair_lag_stress, pair_lag_stress_plain, pbc_keep, suggest_lag,
    )
    from zelll_tpu_torch.ops.lj import lj_force_factor, lj_force_factor_fast
    from zelll_tpu_torch.ops.pbc import suggest_pbc_capacity
    from zelll_tpu_torch.ops.tile_pairs import (
        tile_pair_hist, tile_pair_hist_plain, tile_pair_stress, tile_pair_stress_plain,
    )
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box, seam_cloud,
    )

    csq = CUTOFF**2
    f64 = torch.float64
    esq = hist_edges_sq(HIST_K).to(dev)
    rng = np.random.default_rng(4)
    spec_rng = np.random.default_rng(6)
    thin = np.asarray(lj_box(n, CUTOFF))
    round_box = np.array([ROUND_WIDTH, ROUND_WIDTH, thin[2]])
    data = {"uniform": (generate_points_random(n, thin), thin),
            "lattice": (generate_points_lattice(n, thin), thin),
            "seam": (seam_cloud(thin, 1.5, 2, (0, 1), rng), thin),
            "seam_round": (seam_cloud(round_box, 1.5, 2, (0, 1), rng), round_box)}
    errs = {}
    lag, tile = {}, {}
    inst = {"keep": "keep", "both": "keep_minimage", "mi": "minimage"}

    def note(key, err):
        errs[key] = max(errs.get(key, 0), err)
    B, G, BE = suggest_pbc_capacity(n, thin, CUTOFF, with_multi=True)
    caps = {"keep": dict(B=B, G=G, BE=BE), "both": {}, "mi": {}}
    seam_caps = {"keep": dict(ghosts_per_row=4), "both": {}, "mi": {}}

    def stress_case(got, want, tol, what):
        err, scale = stress_err(got, want)
        check(np.isfinite(err) and scale > 0 and err <= tol * scale,
              f"{what}: max |dsigma| {err} > {tol} x {scale}")
        return err, err / scale

    def hist_case(got, want, what, key):
        c, c_p = combine_count_vec(got), combine_count_vec(want)
        check(np.array_equal(c, c_p) and c[-1] > 0, f"{what}: counts {c} vs {c_p}")
        note(key, count_diff(c, c_p))
        return int(c[-1])

    for kind in ("keep", "mi", "both"):
        cases = {tag: pbc_sorted(pts, box, kind, dev,
                                 **(seam_caps if tag.startswith("seam") else caps)[kind])
                 for tag, (pts, box) in data.items()}
        cases["drifted"] = drifted(cases["lattice"])
        lat = cases["lattice"]
        cases["cluster_gap"] = (*prune_cases(lat[0], lat[1])["cluster_gap"], *lat[2:])
        for tag, (shi, slo, keys, strides, pay, mib, reach, ok) in cases.items():
            check(bool(ok), f"the periodic inputs' flag ({kind}, {tag})")
            L = suggest_lag(keys, strides, reach=reach)
            keep = None if pay is None else pbc_keep
            spec = torch.as_tensor(spec_rng.integers(0, 2, len(shi)), dtype=torch.float32,
                                   device=dev)
            rules = (("keep" if keep else "none", pay, keep),
                     ("species", spec, SpeciesPairMask(0, 1)) if pay is None else
                     ("keep_species", torch.stack([pay, spec], 1), PbcSpeciesPairMask(0, 1)))
            base = dict(L=L, mi_box=mib, key_reach=reach)
            for lo in (None, slo):
                mode = "split" if lo is not None else "f32"
                what = f"{kind} {tag} {mode}"
                row = {}
                factors = ((lj_force_factor, TOL_KERNEL), (lj_force_factor_fast, TOL_FAST_FORCES))
                for gfn, tol in factors[:2 if tag == "lattice" else 1]:
                    kw = dict(base, gfn=gfn, out_dtype=f64, pair_mask=keep)
                    err, rel_err = stress_case(
                        pair_lag_stress(shi, keys, strides, csq, lo, pay, **kw),
                        pair_lag_stress_plain(shi, keys, strides, csq, lo, pay, **kw), tol,
                        f"K4 {what} {gfn.__name__}")
                    row[f"stress_{gfn.__name__}_err_over_max"] = rel_err
                    if tag == "lattice" and gfn is lj_force_factor:
                        note(f"K4_{inst[kind]}_{mode}", err)
                for rule, p, mask in rules:
                    key = "K5_" + "_".join(
                        w for w in ("keep" if pay is not None else "",
                                    "species" if "species" in rule else "",
                                    "minimage" if mib is not None else "") if w)
                    row[f"hist_{rule}_pairs"] = hist_case(
                        pair_lag_hist(shi, keys, strides, esq, lo, p, pair_mask=mask, **base),
                        pair_lag_hist_plain(shi, keys, strides, esq, lo, p, pair_mask=mask,
                                            **base), f"K5 {what} {rule}", f"{key}_{mode}")
                lag[what] = row
            if kind == "keep" and tag == "lattice":
                pos64, p64 = shi.double() + slo.double(), pay.double()
                err, rel_err = stress_case(
                    pair_lag_stress(pos64, keys, strides, csq, None, p64, L=L, pair_mask=keep),
                    pair_lag_stress_plain(pos64, keys, strides, csq, None, p64, L=L,
                                          pair_mask=keep), TOL_KERNEL, "K4 keep f64")
                note("K4_keep_f64", err)
                pairs = {}
                for rule, p, mask in (("keep", p64, keep), ("keep_species",
                                                            torch.stack([p64, spec.double()], 1),
                                                            PbcSpeciesPairMask(1, 1))):
                    pairs[rule] = hist_case(
                        pair_lag_hist(pos64, keys, strides, esq.double(), None, p, L=L,
                                      pair_mask=mask),
                        pair_lag_hist_plain(pos64, keys, strides, esq.double(), None, p, L=L,
                                            pair_mask=mask), f"K5 {rule} f64", f"K5_{rule}_f64")
                lag["keep lattice f64"] = dict(stress_err_over_max=rel_err, **pairs)
    side = (n / 0.01) ** (1 / 3)
    cube = np.array([side] * 3)
    cdata = {"uniform": generate_points_random(n, cube),
             "lattice": generate_points_lattice(n, cube),
             "seam": seam_cloud(cube, 2.5, 2, (0,), rng)}
    Bc, Gc, BEc = suggest_pbc_capacity(n, cube, CUTOFF, with_multi=True)
    ccases = {tag: pbc_sorted(pts, cube, "keep", dev,
                              **(dict(ghosts_per_row=3) if tag == "seam" else
                                 dict(B=Bc, G=Gc, BE=BEc)))
              for tag, pts in cdata.items()}
    ccases["drifted"] = drifted(ccases["lattice"])
    for tag, (shi, slo, keys, strides, pay, _, _, ok) in ccases.items():
        check(bool(ok), f"the periodic cube's flag ({tag})")
        maxj = probe_maxj(keys, strides)
        runs = [(False, shi, None, pay), (False, shi, slo, pay)]
        if tag == "lattice":
            runs += [(True, shi, None, pay), (True, shi, slo, pay),
                     (False, shi.double() + slo.double(), None, pay.double())]
        for bandmask, pos, lo, p in runs:
            mode = "f64" if pos.dtype == f64 else "split" if lo is not None else "f32"
            what = f"{tag} {'masked' if bandmask else 'maskless'} {mode}"
            kw = dict(MAXJ=maxj, bandmask=bandmask, pair_mask=pbc_keep)
            got, ok_k = tile_pair_stress(pos, keys, strides, csq, lo, p, out_dtype=f64, **kw)
            want, ok_p = tile_pair_stress_plain(pos, keys, strides, csq, lo, p, out_dtype=f64,
                                                **kw)
            check(bool(ok_k) and bool(ok_p), f"K8 keep coverage ({what})")
            err, rel_err = stress_case(got, want, TOL_KERNEL, f"K8 keep {what}")
            e = esq.to(pos.dtype)
            got, ok_k = tile_pair_hist(pos, keys, strides, e, lo, p, **kw)
            want, ok_p = tile_pair_hist_plain(pos, keys, strides, e, lo, p, **kw)
            check(bool(ok_k) and bool(ok_p), f"K9 keep coverage ({what})")
            masked = "masked_" if bandmask else ""
            tile[what] = dict(stress_err_over_max=rel_err, hist_pairs=hist_case(
                got, want, f"K9 keep {what}", f"K9_keep_{masked}{mode}"))
            if tag == "lattice":
                note(f"K8_keep_{masked}{mode}", err)
    return dict(n=n, K=HIST_K, thin_box=thin.tolist(), cube_side=side, lag=lag, tile=tile,
                max_abs_err=errs)


def pbc_obs_main_path(dev, n: int) -> dict:
    """The periodic observables at n = 1e7 through the entry points, nothing
    cut. The thin box (lj_box, uniform: benchmarks/rdf_bench.py's fixture):
    `pbc_stress_fused` with ``minimage="auto"`` (K4 with the minimum image
    and the keep mask), f32 and split, and with ghost images on every axis
    (K4 with the keep mask), `rdf` with K = 32 edges linspace(0, 10, 32) and
    ``minimage="auto"`` (K5 with both rules) and its species partial
    (species uniform in {0, 1} from default_rng(0): K5 with the minimum
    image and the keep mask composed with the species mask), and
    `pbc_virial` with ``minimage="auto"`` (K1). The cube (side
    (n / 0.01)^(1/3), MAXJ 24: benchmarks/observables_bench.py's pbc cells):
    `pbc_virial(path="tile")` (K6 with the keep mask),
    `pbc_stress_fused(path="tile")` (K8) and `rdf(path="tile")` (K9). Each
    call's ms (CUDA events; the histograms read their counts back) and host
    ms, its ratio to `pbc_pair_sum`'s periodic energy call on the same box
    in the same mode (timed here, as `pbc_main_path` times it), and its
    launches over the timed calls and their warm-up, exact per call; every
    flag True, finite results, trace(sigma) against W, and g(r) near 1 past
    the first shells (an ideal gas at this density)."""
    from zelll_tpu_torch.ops.lag_pairs import split_f64
    from zelll_tpu_torch.ops.pbc import minimage_axes, pbc_pair_sum, suggest_pbc_capacity
    from zelll_tpu_torch.ops.rdf import rdf
    from zelll_tpu_torch.ops.virial import pbc_stress_fused, pbc_virial
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    o = [0.0] * 3
    out = {}
    edges = np.linspace(0.0, CUTOFF, HIST_K)
    thin = np.asarray(lj_box(n, CUTOFF))
    hi, lo = split_f64(torch.as_tensor(generate_points_random(n, thin), device=dev))
    species = torch.as_tensor(np.random.default_rng(0).integers(0, 2, n), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def cell(name, fn, expect, pos, base=None):
        t = timed_call(lambda i: fn(pos + (i % 2) * 1e-6), PBC_REPS, expect)
        row = dict(ms=t["ms"], host_ms=t["host_ms"], launches=t["launches"], calls=t["calls"])
        if base is not None:
            row.update(energy_call=base, x_over_energy_call=t["ms"] / out[base]["ms"])
        out[name] = row
        return t["out"]

    Bm, Gm = suggest_pbc_capacity(n, thin, CUTOFF, axes=~minimage_axes(thin, CUTOFF))
    B, G, BE = suggest_pbc_capacity(n, thin, CUTOFF, with_multi=True)
    kwm = dict(B=Bm, G=Gm, minimage="auto")
    kwg = dict(B=B, G=G, BE=BE)
    Lm = probe_pbc_lag(lambda L: pbc_pair_sum(hi, o, thin, CUTOFF, L=L, **kwm)[1], L_MAIN)
    Lg = probe_pbc_lag(lambda L: pbc_pair_sum(hi, o, thin, CUTOFF, L=L, **kwg)[1], L_MAIN)
    cell("thin_energy_minimage", lambda p: pbc_pair_sum(p, o, thin, CUTOFF, L=Lm, **kwm),
         {"lag_reduce": 1}, hi)
    cell("thin_energy_ghosts", lambda p: pbc_pair_sum(p, o, thin, CUTOFF, L=Lg, **kwg),
         {"lag_reduce": 1}, hi)
    sig = cell("thin_stress_minimage_f32",
               lambda p: pbc_stress_fused(p, o, thin, CUTOFF, L=Lm, **kwm),
               {"lag_stress": 1}, hi, "thin_energy_minimage")
    sig_s = cell("thin_stress_minimage_split",
                 lambda p: pbc_stress_fused(p, o, thin, CUTOFF, L=Lm, positions_lo=lo, **kwm),
                 {"lag_stress": 1}, hi, "thin_energy_minimage")
    sig_g = cell("thin_stress_ghosts_f32",
                 lambda p: pbc_stress_fused(p, o, thin, CUTOFF, L=Lg),
                 {"lag_stress": 1}, hi, "thin_energy_ghosts")
    g = cell("thin_rdf_minimage", lambda p: rdf(p, o, thin, edges, L=Lm, **kwm),
             {"lag_hist": 1}, hi, "thin_energy_minimage")
    gs = cell("thin_rdf_minimage_species",
              lambda p: rdf(p, o, thin, edges, L=Lm, species=species, pair=(0, 1), **kwm),
              {"lag_hist": 1}, hi, "thin_energy_minimage")
    w = cell("thin_virial_minimage", lambda p: pbc_virial(p, o, thin, CUTOFF, L=Lm, **kwm),
             {"lag_reduce": 1}, hi, "thin_energy_minimage")
    del hi, lo, species
    peak_thin = torch.cuda.max_memory_allocated()

    def shells_near_one(gv, what):
        tail = np.asarray(gv)[len(gv) // 2:]
        check(np.isfinite(gv).all() and 0.95 < float(tail.mean()) < 1.05,
              f"{what}: g(r) past the first shells {tail.tolist()}")
        return float(tail.mean())

    def stress_ok(s, what):
        s = s.double().cpu().numpy()
        check(np.isfinite(s).all() and np.allclose(s, s.T, rtol=0, atol=0),
              f"{what}: stress {s.tolist()}")
        return s

    s32, s_split, s_ghosts = (stress_ok(x[0], k) for x, k in (
        (sig, "thin minimage f32"), (sig_s, "thin minimage split"), (sig_g, "thin ghosts f32")))
    thin_check = dict(
        L_minimage=Lm, L_ghosts=Lg, B=B, G=G, BE=BE, B_minimage=Bm, G_minimage=Gm,
        virial=float(w[0]), stress_f32_trace=float(np.trace(s32)),
        stress_split_trace=float(np.trace(s_split)),
        stress_ghosts_trace=float(np.trace(s_ghosts)),
        trace_rel_err_vs_virial=rel(float(np.trace(s32)), float(w[0])),
        ghosts_rel_err_vs_minimage=float(np.abs(s_ghosts - s32).max() / np.abs(s32).max()),
        rdf_tail_mean=shells_near_one(g[1], "thin rdf"),
        rdf_species_tail_mean=shells_near_one(gs[1], "thin rdf species (0, 1)"))
    check(thin_check["trace_rel_err_vs_virial"] <= 1e-4,
          f"trace(stress) vs virial on the periodic thin box: {thin_check}")
    check(thin_check["ghosts_rel_err_vs_minimage"] <= 1e-4,
          f"ghost and minimum-image stress on the periodic thin box: {thin_check}")

    side = (n / 0.01) ** (1 / 3)
    cube = np.array([side] * 3)
    cpos = torch.as_tensor(cube_points(n)[0], dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Bc, Gc, BEc = suggest_pbc_capacity(n, cube, CUTOFF, with_multi=True)
    kwc = dict(B=Bc, G=Gc, BE=BEc, path="tile", MAXJ=PBC_MAXJ)
    cell("cube_energy", lambda p: pbc_pair_sum(p, o, cube, CUTOFF, bandmask=False, **kwc),
         {"tile_reduce": 1}, cpos)
    cw = cell("cube_virial", lambda p: pbc_virial(p, o, cube, CUTOFF, bandmask=False, **kwc),
              {"tile_reduce": 1}, cpos, "cube_energy")
    # the stress and the histogram take the same capacities by default
    cs = cell("cube_stress", lambda p: pbc_stress_fused(p, o, cube, CUTOFF, path="tile",
                                                        MAXJ=PBC_MAXJ),
              {"tile_stress": 1}, cpos, "cube_energy")
    cg = cell("cube_rdf", lambda p: rdf(p, o, cube, edges, path="tile", MAXJ=PBC_MAXJ),
              {"tile_hist": 1}, cpos, "cube_energy")
    del cpos
    cs32 = stress_ok(cs[0], "cube")
    cube_check = dict(B=Bc, G=Gc, BE=BEc, MAXJ=PBC_MAXJ, virial=float(cw[0]),
                      stress_trace=float(np.trace(cs32)),
                      trace_rel_err_vs_virial=rel(float(np.trace(cs32)), float(cw[0])),
                      rdf_tail_mean=shells_near_one(cg[1], "cube rdf"))
    check(cube_check["trace_rel_err_vs_virial"] <= 1e-4,
          f"trace(stress) vs virial on the periodic cube: {cube_check}")
    launches = {}
    for row in out.values():
        for k, v in row["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return dict(n=n, K=HIST_K, thin_box=thin.tolist(), cube_side=side, calls=out,
                launches=launches, thin=thin_check, cube=cube_check,
                max_memory_allocated=max(peak_thin, torch.cuda.max_memory_allocated()))


def npt_main_path(dev, n: int) -> dict:
    """`md_run_npt(path="tile")` on the cubic periodic MD state (the cube of
    side (n / 0.01)^(1/3) filled with the MD protocol's start state,
    `md_states`: a perturbed lattice, v ~ normal(0, 0.3); the uniform cloud
    of pbc_md_bench.py holds near-coincident pairs whose first kick
    overflows the f32 kinetic energy, so its pressure is inf), dt 1e-4,
    NPT_STEPS steps after a one-step warm-up, ``record=True``: ms per step
    (CUDA events) and host ms,
    the launches of the run (K7 and K6 with the keep mask, once each per
    step, exact), the flag, the box above 2 cutoff, the pressure, volume
    and temperature records (finite), the positions wrapped into the final
    box, and the box grown where the pressure starts above the target;
    one step's device time by kernel and busy share (`profile_steps`).
    Then ``beta=0`` against `md_step_pbc` on the same state and
    capacities for NPT_BETA0_STEPS steps: the same box, and positions
    within two f32 ulp of the box side."""
    from zelll_tpu_torch.models import md_run_npt
    from zelll_tpu_torch.ops.pbc import md_step_pbc, suggest_pbc_capacity

    o = [0.0] * 3
    side = (n / 0.01) ** (1 / 3)
    cube = np.array([side] * 3)
    _, st, _ = md_states(n, tuple(cube), dev)
    pos, vel = st.positions, st.velocities
    rows = pos.shape[0]
    # md_run_npt's own sizing, made explicit so md_step_pbc gets the same
    B, G = suggest_pbc_capacity(rows, cube / 1.5 ** (1 / 3), CUTOFF)
    kw = dict(path="tile", MAXJ=PBC_MAXJ, B=B, G=G)
    # a warm-up step: the first call of the process allocates and loads
    md_run_npt(pos, vel, o, cube, CUTOFF, MD_DT, steps=1, P_target=NPT_P_TARGET,
               tau_p=NPT_TAU_P, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    p, v, b, ok, rec = md_run_npt(pos, vel, o, cube, CUTOFF, MD_DT, steps=NPT_STEPS,
                                  P_target=NPT_P_TARGET, tau_p=NPT_TAU_P, beta=1.0,
                                  record=True, **kw)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / NPT_STEPS
    launches = window_launches({"tile_forces": 1, "tile_reduce": 1}, NPT_STEPS)
    rec = {k: x.double().cpu().numpy() for k, x in rec.items()}
    bx = b.double().cpu().numpy()
    pn = p.double().cpu().numpy()
    check(bool(ok) and bool((b > 2 * CUTOFF).all()), f"md_run_npt: ok {bool(ok)}, box {bx}")
    check(all(np.isfinite(x).all() for x in rec.values()) and np.isfinite(pn).all()
          and (pn >= 0).all() and (pn <= bx).all(),
          f"md_run_npt records {({k: x.tolist() for k, x in rec.items()})}")
    # a pressure above the target expands the box (tests/test_npt.py)
    check(rec["pressure"][0] <= NPT_P_TARGET or rec["volume"][-1] > rec["volume"][0],
          f"md_run_npt: pressure {rec['pressure'].tolist()}, volume {rec['volume'].tolist()}")
    # where one step's time goes: two one-step runs under the profiler
    prof = profile_steps(lambda i: md_run_npt(pos, vel, o, cube, CUTOFF, MD_DT, steps=1,
                                              P_target=NPT_P_TARGET, tau_p=NPT_TAU_P,
                                              **kw), 2)
    res = dict(n=rows, side=side, steps=NPT_STEPS, dt=MD_DT, P_target=NPT_P_TARGET,
               tau_p=NPT_TAU_P, B=B, G=G, MAXJ=PBC_MAXJ,
               step_ms=start.elapsed_time(end) / NPT_STEPS, host_step_ms=host_ms,
               launches=launches, launches_per_step={k: c / NPT_STEPS
                                                     for k, c in launches.items()},
               ok=True, box=bx.tolist(), pressure=rec["pressure"].tolist(),
               volume=rec["volume"].tolist(), temperature=rec["temperature"].tolist(),
               max_memory_allocated=torch.cuda.max_memory_allocated(), step_profile=prof)
    del p, v, b
    p1, _, b1, ok1 = md_run_npt(pos, vel, o, cube, CUTOFF, MD_DT, steps=NPT_BETA0_STEPS,
                                P_target=NPT_P_TARGET, tau_p=NPT_TAU_P, beta=0.0, **kw)
    p2, v2 = pos, vel
    for _ in range(NPT_BETA0_STEPS):
        p2, v2, ok2 = md_step_pbc(p2, v2, o, cube, CUTOFF, MD_DT, **kw)
        check(bool(ok2), "md_step_pbc's flag beside md_run_npt(beta=0)")
    err = float((p1.double() - p2.double()).abs().max())
    tol = 2.0**-22 * side
    check(bool(ok1) and np.array_equal(b1.double().cpu().numpy(), cube.astype(np.float32))
          and err <= tol, f"md_run_npt(beta=0) vs md_step_pbc: max |dx| {err} > {tol}, "
                          f"box {b1.tolist()}")
    res.update(beta0_steps=NPT_BETA0_STEPS, beta0_max_abs_dx=err, beta0_tol=tol)
    return res


def pbc_obs_parity(dev, n: int) -> dict:
    """The periodic observables in split mode against `periodic_observables`
    (the oracle on numpy ghost images) at n (main: 5e5), on the thin box's
    uniform cloud (``minimage="auto"`` and ghost images on every axis), a
    jittered lattice on the thin box whose folded x and y lengths round in
    f32 (ROUND_WIDTH; ``minimage="auto"``) and the cube's uniform cloud
    (tile path): `pbc_stress_fused` within TOL_SPLIT of the largest
    |sigma_ab|, `pbc_virial` within TOL_SPLIT of W, W = trace(sigma) of the
    same mode within TOL_REL, and `rdf`'s cumulative counts
    (`rdf._pbc_cum_hist`) within TOL_HIST of the total."""
    from zelll_tpu_torch.ops.lag_pairs import combine_count_vec, split_f64
    from zelll_tpu_torch.ops.rdf import _pbc_cum_hist
    from zelll_tpu_torch.ops.virial import pbc_stress_fused, pbc_virial
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    edges = np.linspace(0.0, CUTOFF, HIST_K)
    side = (n / 0.01) ** (1 / 3)
    thin = np.asarray(lj_box(n, CUTOFF))
    round_box = np.array([ROUND_WIDTH, ROUND_WIDTH, thin[2]])
    cells = (("thin_uniform", thin, generate_points_random,
              (("lag_minimage", dict(minimage="auto")), ("lag_ghosts", {}))),
             ("thin_round_lattice", round_box, generate_points_lattice,
              (("lag_minimage", dict(minimage="auto")),)),
             ("cubic_uniform", np.array([side] * 3), generate_points_random,
              (("tile", dict(path="tile", MAXJ=PBC_MAXJ)),)))
    out = {}
    o = [0.0] * 3
    for name, box, make, runs in cells:
        pts = np.mod(make(n, box), box)
        sig_ref, w_ref, cum_ref = periodic_observables(pts, box, CUTOFF, edges)
        scale = float(np.abs(sig_ref).max())
        hi, lo = split_f64(torch.as_tensor(pts, device=dev))
        res = {}
        for path, kw in runs:
            kw = dict(kw)
            if path.startswith("lag"):
                kw["L"] = probe_pbc_lag(lambda L: pbc_virial(
                    hi, o, box, CUTOFF, positions_lo=lo, **{**kw, "L": L})[1], L_MAIN)
            sig, ok_s = pbc_stress_fused(hi, o, box, CUTOFF, positions_lo=lo, **kw)
            w, ok_w = pbc_virial(hi, o, box, CUTOFF, positions_lo=lo, out_dtype=torch.float64,
                                 **kw)
            packed, ok_h = _pbc_cum_hist(hi, o, box, edges, positions_lo=lo, B=None, G=None,
                                         M=1024, **{"L": L_MAIN, **kw})
            check(bool(ok_s) and bool(ok_w) and bool(ok_h),
                  f"periodic observables' flags ({name} {path})")
            s = sig.double().cpu().numpy()
            cum = combine_count_vec(packed).astype(np.float64)
            errs = dict(stress_err_vs_reference=float(np.abs(s - sig_ref).max()) / scale,
                        virial_rel_err_vs_reference=rel(float(w), w_ref),
                        trace_rel_err_vs_virial=rel(float(np.trace(s)), float(w)),
                        hist_cum_dev_vs_reference=float(np.abs(cum - cum_ref).max())
                        / max(cum_ref[-1], 1.0))
            tols = dict(stress_err_vs_reference=TOL_SPLIT, virial_rel_err_vs_reference=TOL_SPLIT,
                        trace_rel_err_vs_virial=TOL_REL, hist_cum_dev_vs_reference=TOL_HIST)
            for what, err in errs.items():
                check(np.isfinite(err) and err <= tols[what],
                      f"periodic {what} {err} > {tols[what]} ({name} {path})")
            res[path] = dict(**errs, L=kw.get("L"))
        out[name] = dict(n=n, box=box.tolist(), reference_w=w_ref,
                         reference_pairs=float(cum_ref[-1]), paths=res)
    return out


def pbc_obs_alone(dev, n: int, which: str) -> dict:
    """The periodic observables' instances alone at the main path's shapes
    (n = 1e7, sorted as `pbc_obs_main_path` sorts them, split coordinates
    of the same points): ``which="stress"``: K4 with the keep mask and the
    minimum image (thin ``minimage="auto"``, f32 and split) and with the
    keep mask (thin, ghost images, f32), K8 with the keep mask (the
    ghost-extended cube, maskless, MAXJ 24, f32); ``which="hist"``: K5
    with both rules, f32 and split, and with the species mask composed
    (f32), K9 with the keep mask (the cube, f32). Each: ms and the launches
    counted in its timed runs, one plain call's ms (held to the kernel's
    result; at 1e6 where one at 1e7 would take over PLAIN_LIMIT_S), the work
    of the function (the half-stencil candidates of its keys, the folded
    axes wrapping, as the open rows charge them; the cutoff pairs, which
    the keep test is charged on, and the kept ones; the lag window's
    candidates beside them) and its bound, the share of it, the lane
    evaluations per candidate the cluster prune leaves
    (`ops/cluster_prune.py`), and the ptxas lines of the instance's kernel
    functions."""
    from zelll_tpu_torch.ops import lag_pairs, tile_pairs
    from zelll_tpu_torch.ops.cluster_prune import (
        CLUSTER, lag_cluster_entries, tile_cluster_entries,
    )
    from zelll_tpu_torch.ops.lag_pairs import (
        PbcKeepTerm, PbcSpeciesPairMask, combine_count, combine_count_vec, count_term,
        pair_lag_hist_plain, pair_lag_reduce, pair_lag_stress_plain, pbc_keep,
    )
    from zelll_tpu_torch.ops.pbc import minimage_axes, suggest_pbc_capacity
    from zelll_tpu_torch.ops.tile_pairs import (
        hist_tiles, hist_tiles_plain, reduce_tiles, stress_tiles, stress_tiles_plain,
        tile_inputs,
    )
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    stress = which == "stress"
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    esq = hist_edges_sq(HIST_K).to(dev)
    per_pair = INSTR_PER_STRESS_PAIR if stress else int(np.ceil(np.log2(HIST_K)))
    kernel = "K4" if stress else "K5"
    wrapper = lag_pairs.pair_lag_stress if stress else lag_pairs.pair_lag_hist
    out = {}

    box = np.asarray(lj_box(n, CUTOFF))

    def thin_sorted(m, kind):
        box = np.asarray(lj_box(m, CUTOFF))
        if kind == "both":
            caps = dict(zip(("B", "G"), suggest_pbc_capacity(
                m, box, CUTOFF, axes=~minimage_axes(box, CUTOFF))))
        else:
            caps = dict(zip(("B", "G", "BE"),
                            suggest_pbc_capacity(m, box, CUTOFF, with_multi=True)))
        return pbc_sorted(np.mod(generate_points_random(m, box), box), box, kind, dev, **caps)

    def run(shi, keys, strides, lo, pay, mib, reach, L, mask):
        strides = torch.as_tensor(strides, dtype=torch.int32, device=dev)
        if stress:
            return lag_pairs._lag_stress_cuda(
                shi, keys, strides, csq, lo, pay, L=L, gfn=lag_pairs.lj_force_factor,
                pair_mask=mask, mi_box=mib, key_reach=reach, out_dtype=torch.float64)
        return lag_pairs._lag_hist_cuda(shi, keys, strides, esq, lo, pay, L=L, pair_mask=mask,
                                        mi_box=mib, key_reach=reach)

    def plain(shi, keys, strides, lo, pay, mib, reach, L, mask):
        if stress:
            return pair_lag_stress_plain(shi, keys, strides, csq, lo, pay, L=L,
                                         pair_mask=mask, mi_box=mib, key_reach=reach,
                                         out_dtype=torch.float64)
        return pair_lag_hist_plain(shi, keys, strides, esq, lo, pay, L=L, pair_mask=mask,
                                   mi_box=mib, key_reach=reach)

    def agree(got, want, what):
        if stress:
            err, scale = stress_err(got, want)
            check(err <= TOL_KERNEL * scale, f"{what}: {err} > {TOL_KERNEL} x {scale}")
            return err / scale
        c, c_p = combine_count_vec(got), combine_count_vec(want)
        check(np.array_equal(c, c_p), f"{what}: counts")
        return count_diff(c, c_p)

    rows_of = (("keep_minimage", "both", (None, "lo"), False),
               ("keep", "keep", (None,), False))
    if not stress:
        rows_of = (("keep_minimage", "both", (None, "lo"), False),
                   ("keep_species_minimage", "both", (None,), True))
    spec = torch.as_tensor(np.random.default_rng(0).integers(0, 2, 2 * n), dtype=torch.float32,
                           device=dev)
    for name, kind, los, species in rows_of:
        shi, slo, keys, strides, pay, mib, reach, ok = thin_sorted(n, kind)
        check(bool(ok), f"{kernel}_{name}: the periodic inputs' flag")
        rows = shi.shape[0]
        L = probe_pbc_lag(lambda L: lag_pairs.lag_coverage_ok(keys, strides, L, reach=reach),
                          L_MAIN)
        p, mask = (pay, pbc_keep) if not species else \
            (torch.stack([pay, spec[:rows]], 1), PbcSpeciesPairMask(0, 1))
        # the work of the function: the half-stencil candidates of its keys,
        # the folded axes wrapping (the lag window, beside them, holds more
        # on the ghost-extended box)
        folds = tuple(int(np.ceil(box[a] / CUTOFF)) if mib is not None and float(mib[a]) > 0
                      else 0 for a in range(3))
        candidates = periodic_stencil_candidates(keys, strides, folds)
        kw = dict(L=L, mi_box=mib, key_reach=reach)
        cut_pairs = combine_count(pair_lag_reduce(shi, keys, strides, csq, None, None,
                                                  term=count_term, out_dtype=torch.int32, **kw))
        # the pairs the function evaluates: those kept (and, for the
        # histogram, its species' pairs: the last cumulative count)
        pairs = combine_count(pair_lag_reduce(shi, keys, strides, csq, None, pay,
                                              term=PbcKeepTerm(count_term),
                                              out_dtype=torch.int32, **kw)) if stress else \
            int(combine_count_vec(run(shi, keys, strides, None, p, mib, reach, L, mask))[-1])
        row = out.setdefault(f"{kernel}_{name}", dict(
            rows=rows, L=L, candidates=candidates,
            window_candidates=window_candidates(keys, strides, L, reach),
            cutoff_pairs=cut_pairs, pairs=pairs))
        for lo in (None if t is None else slo for t in los):
            mode = "split" if lo is not None else "f32"
            split = lo is not None
            ms, launches = timed_launches(
                lambda: run(shi, keys, strides, lo, p, mib, reach, L, mask), wrapper)
            planes = (6 if split else 3) + 1 + 1 + (1 if species else 0)
            per_candidate = INSTR_PER_CANDIDATE[split] + \
                (2 * INSTR_MI_FOLD[split] if mib is not None else 0)
            b = bound(rows * 4 * planes, candidates * per_candidate + cut_pairs * INSTR_KEEP
                      + (cut_pairs if species else 0) * INSTR_KEEP + pairs * per_pair)
            lanes = int(lag_cluster_entries(shi.t(), None if lo is None else lo.t(), keys,
                                            strides, csq, L, half=True, mi_box=mib,
                                            reach=reach).sum()) * CLUSTER
            row[mode] = dict(ms=ms, launches=launches, **b, share_of_bound=b["bound_ms"] / ms,
                             pruned_evaluations=lanes,
                             pruned_evaluations_per_candidate=lanes / candidates)
            if mode == "f32" or name == "keep_minimage":
                plain_ms, want = once_ms(lambda: plain(shi, keys, strides, lo, p, mib, reach,
                                                       L, mask))
                got = run(shi, keys, strides, lo, p, mib, reach, L, mask)
                row[mode].update(plain_ms=plain_ms, plain_n=n, err_over_max=agree(
                    got, want, f"{kernel}_{name} {mode} at n = {n}"))
                del want, got
        del shi, slo, keys, pay, p
    maxj = PBC_MAXJ

    def cube_inp(m):
        cb = np.array([(m / 0.01) ** (1 / 3)] * 3)
        Bc, Gc, BEc = suggest_pbc_capacity(m, cb, CUTOFF, with_multi=True)
        shi, _, keys, strides, pay, _, _, ok = pbc_sorted(
            np.random.default_rng(7).random((m, 3)) * cb, cb, "keep", dev, B=Bc, G=Gc, BE=BEc)
        check(bool(ok), "the periodic cube's flag")
        inp = tile_inputs(shi.t().contiguous(), keys, strides, CB=CB, MAXJ=maxj,
                          bandmask=False)
        check(bool(inp.coverage_ok), f"coverage on the periodic cube at MAXJ {maxj}")
        return shi, keys, strides, pay, inp

    tname = "K8_keep" if stress else "K9_keep"
    tile_run = (lambda inp, pay: stress_tiles(inp, csq, payload=pay, pair_mask=pbc_keep,
                                              out_dtype=torch.float64)) if stress else \
        (lambda inp, pay: hist_tiles(inp, esq, payload=pay, pair_mask=pbc_keep))
    tile_plain = (lambda inp, pay: stress_tiles_plain(inp, csq, payload=pay, pair_mask=pbc_keep,
                                                      out_dtype=torch.float64)) if stress else \
        (lambda inp, pay: hist_tiles_plain(inp, esq, payload=pay, pair_mask=pbc_keep))
    shi, keys, strides, pay, inp = cube_inp(n)
    rows = shi.shape[0]
    candidates = periodic_stencil_candidates(keys, strides)
    cut_pairs = combine_count(reduce_tiles(inp, csq, term=count_term, out_dtype=torch.int32))
    pairs = combine_count(reduce_tiles(inp, csq, term=PbcKeepTerm(count_term), payload=pay,
                                       out_dtype=torch.int32))
    ms, launches = timed_launches(lambda: tile_run(inp, pay),
                                  tile_pairs.tile_pair_stress if stress
                                  else tile_pairs.tile_pair_hist)
    b = bound(rows * 4 * (3 + 1 + 1) + inp.bounds.numel() * 4,
              candidates * INSTR_PER_CANDIDATE[False] + cut_pairs * INSTR_KEEP + pairs * per_pair)
    lanes = int(tile_cluster_entries(inp, csq, half=True).sum()) * CLUSTER
    out[tname] = dict(rows=rows, MAXJ=maxj, candidates=candidates, cutoff_pairs=cut_pairs,
                      pairs=pairs, f32=dict(ms=ms, launches=launches, **b,
                                            share_of_bound=b["bound_ms"] / ms,
                                            pruned_evaluations=lanes,
                                            pruned_evaluations_per_candidate=lanes / candidates))
    del shi, keys, pay, inp

    def tile_plain_ms(m):
        _, _, _, p, x = cube_inp(m)
        ms, want = once_ms(lambda: tile_plain(x, p))
        out[tname]["f32"][f"err_over_max_at_{m}"] = agree(tile_run(x, p), want,
                                                          f"{tname} at n = {m}")
        return ms

    out[tname]["f32"].update(plain_time(tile_plain_ms, n))
    log = (lag_pairs.load_stress_kernel if stress else lag_pairs.load_hist_kernel).log
    tlog = (tile_pairs.load_stress_kernel if stress else tile_pairs.load_hist_kernel).log
    out[f"{kernel}_periodic_ptxas"] = ptxas_functions(log, "_pbc_kernel")
    out[f"{'K8' if stress else 'K9'}_keep_ptxas"] = ptxas_functions(tlog, "_keep_kernel")
    return out


# -- differentiable potentials (slice 7) and the term table in K2, K4, K8 ------

# K2 per cutoff pair with a scalar term: the term (the LJ form's 10 FP32
# instructions: the IEEE division, t*t*t, t3 - 1, 4*t3, the product) and one
# f64 add at each end, each counted as 2. The table's forms are charged as
# the LJ form: lennard_jones() is the timed term.
INSTR_PER_TERM_PAIR = 5 + 5 + 2 * 2


def far_potentials() -> dict:
    """Factories whose pair terms reach the cutoff of 10 at the main path's
    density (tests/test_torch_kernels.py's periodic table cases): a shifted
    LJ of sigma 4 and a Morse well at 4.5, which stays bounded at small
    separations, so that no near pair carries a total."""
    from zelll_tpu_torch.ops import potentials as P

    return {"shifted_lj_4": P.shifted(P.lennard_jones(1.0, 4.0), CUTOFF),
            "morse_4_5": P.morse(1.3, 0.5, 4.5)}


def direct_energy_forces(x, path: str, split: bool, term, gfn, *, out_dtype, **kw):
    """The energy and the forces (input order) of the direct calls on the
    sorted inputs `ops.autodiff.make_pair_potential` builds: keys on an
    ``auto_order`` grid, one sort (the card's sort is deterministic, so the
    order is the potential's own)."""
    from zelll_tpu_torch.core import GridInfo, aabb_from_positions, compute_keys, sort_by_key
    from zelll_tpu_torch.ops.lag_pairs import pair_lag_forces, pair_lag_reduce, split_f64
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces, tile_pair_reduce

    hi, lo = split_f64(x) if split else (x, None)
    info = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
    cols = (hi, lo) if split else (hi,)
    skeys, perm, sh, *rest = sort_by_key(compute_keys(hi, info), *cols)
    sl = rest[0] if split else None
    csq = CUTOFF**2
    if path == "lag":
        e = pair_lag_reduce(sh, skeys, info.strides, csq, sl, L=kw["L"], term=term,
                            out_dtype=out_dtype)
        f = pair_lag_forces(sh, skeys, info.strides, csq, sl, L=kw["L"], gfn=gfn,
                            out_dtype=out_dtype)
    else:
        e, _ = tile_pair_reduce(sh, skeys, info.strides, csq, sl, MAXJ=kw["MAXJ"], term=term,
                                out_dtype=out_dtype)
        f, _ = tile_pair_forces(sh, skeys, info.strides, csq, sl, MAXJ=kw["MAXJ_F"], gfn=gfn,
                                out_dtype=out_dtype)
    return e, torch.empty_like(f).index_copy_(0, perm, f)


def value_and_grad_fn(pot, x):
    """``() -> (E, ok, dE/dx)`` of a potential on a leaf copy of ``x``."""
    def vg():
        xg = x.detach().requires_grad_(True)
        e, ok = pot(xg)
        (g,) = torch.autograd.grad(e, xg)
        return e.detach(), ok, g
    return vg


def autodiff_main_path(dev, n: int) -> dict:
    """`make_pair_potential`'s value and gradient through autograd at
    n = 1e7: the thin path (K1 forward, K3 backward) on the main path's
    uniform cloud, split and f32, and the cube path (K6, K7) on the cubic
    MD start state (f32), each with `lj_term` (the handwritten factor) and
    lennard_jones(0.7, 1.1) of `table_potentials` (its factory's gfn: the
    term table's instances). Each call's launches are zeroed just before it
    and read just after: exactly one energy and one forces launch. ms per
    call from CUDA events, and a profile of 3 calls (device operations and
    the busy share). The energy and the gradient are held to the direct
    calls on the same sorted inputs (`direct_energy_forces`): the energy to
    TOL_TABLE relative, the gradient to TOL_TABLE of the largest force (one
    sort, deterministic kernels: they should agree bitwise)."""
    from zelll_tpu_torch.core import GridInfo, aabb_from_positions, compute_keys
    from zelll_tpu_torch.ops.autodiff import make_pair_potential
    from zelll_tpu_torch.ops.lag_pairs import lj_term
    from zelll_tpu_torch.ops.lj import lj_force_factor
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    table = table_potentials()["lennard_jones"]
    terms = {"lj_term": (lj_term, lj_force_factor), "table": (table.term, table.gfn)}
    kernels = {"lag": ("lag_reduce", "lag_forces"), "tile": ("tile_reduce", "tile_forces")}
    pts = generate_points_random(n, lj_box(n, CUTOFF))
    thin64 = torch.as_tensor(pts, device=dev)
    del pts
    side = (n / 0.01) ** (1 / 3)
    _, cst, _ = md_states(n, (side, side, side), dev)
    cube = cst.positions
    del cst
    cinfo = GridInfo.create(aabb_from_positions(cube), CUTOFF, auto_order=True)
    ckeys = torch.sort(compute_keys(cube, cinfo))[0]
    tile_kw = dict(MAXJ=probe_maxj(ckeys, cinfo.strides),
                   MAXJ_F=probe_maxj(ckeys, cinfo.strides, full=True))
    del ckeys
    cells = (("thin_split", "lag", True, thin64, dict(L=L_MAIN)),
             ("thin_f32", "lag", False, thin64.float(), dict(L=L_MAIN)),
             ("cube_f32", "tile", False, cube, tile_kw))
    out, launches = {}, dict.fromkeys(("lag_reduce", "lag_forces", "tile_reduce",
                                       "tile_forces"), 0)
    for cell, path, split, x, kw in cells:
        for tname, (term, gfn) in terms.items():
            pot = make_pair_potential(CUTOFF, term=term, path=path, split=split, **kw)
            vg = value_and_grad_fn(pot, x)
            reset_launches()
            e, ok, g = vg()
            torch.cuda.synchronize()
            counts = read_launches()
            energy_k, forces_k = kernels[path]
            others = sum(v for k, v in counts.items() if k not in (energy_k, forces_k))
            check(counts[energy_k] == 1 and counts[forces_k] == 1 and others == 0,
                  f"value_and_grad {cell} {tname}: launches {counts}")
            check(bool(ok), f"value_and_grad {cell} {tname}: coverage")
            for k in launches:
                launches[k] += counts[k]
            e_d, f_d = direct_energy_forces(x, path, split, term, gfn, out_dtype=e.dtype, **kw)
            scale = float(f_d.abs().max())
            e_err = rel(float(e), float(e_d))
            g_err = float((g + f_d).abs().max()) / scale
            check(np.isfinite(float(e)) and e_err <= TOL_TABLE,
                  f"value_and_grad {cell} {tname}: energy {float(e)} vs {float(e_d)}")
            check(np.isfinite(g_err) and g_err <= TOL_TABLE,
                  f"value_and_grad {cell} {tname}: gradient off -forces by {g_err}")
            del e, g, e_d, f_d
            ms = cuda_ms(vg, 5)
            prof = profile_steps(lambda i: vg(), 3)
            out[f"{cell}_{tname}"] = dict(
                ms=ms, energy_rel_err_vs_direct=e_err, grad_err_vs_direct_forces=g_err,
                launches_per_call={energy_k: 1, forces_k: 1}, profile=prof,
                sorts_per_call=1, energy_dtype=str(x.dtype))
    return dict(n=n, cube_rows=cube.shape[0], tile=tile_kw, cells=out, launches=launches)


def autodiff_parity(dev, n: int) -> dict:
    """`make_pair_potential(split=True)` against the exact-f64 oracle at
    n = 1e6 on the thin box's uniform cloud, on both paths (K1 + K3, and
    K6 + K7 on the same points): the energy within TOL_REL of the oracle's
    and ||g + f_ref|| / ||f_ref|| within TOL_REL, as `forces_parity`
    measures it."""
    from zelll_tpu_torch import oracle
    from zelll_tpu_torch.core import GridInfo, aabb_from_positions, compute_keys
    from zelll_tpu_torch.ops.autodiff import make_pair_potential
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    pts = generate_points_random(n, lj_box(n, CUTOFF))
    with ThreadPoolExecutor(2) as pool:
        energy = pool.submit(oracle.lj_energy, pts, CUTOFF)
        forces = pool.submit(oracle.forces, pts, CUTOFF)
        x = torch.as_tensor(pts, device=dev)
        hi = x.float()
        info = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
        keys = torch.sort(compute_keys(hi, info))[0]
        runs = {"lag": dict(L=L_MAIN),
                "tile": dict(MAXJ=probe_maxj(keys, info.strides),
                             MAXJ_F=probe_maxj(keys, info.strides, full=True))}
        got = {}
        for path, kw in runs.items():
            e, ok, g = value_and_grad_fn(
                make_pair_potential(CUTOFF, path=path, split=True, **kw), x)()
            check(bool(ok), f"autodiff parity coverage ({path})")
            got[path] = (float(e), g.cpu().numpy())
        e_ref, n_ref = energy.result()
        f_ref = forces.result()
    out = {}
    for path, (e, g) in got.items():
        e_err = rel(e, e_ref)
        g_err = float(np.linalg.norm(g + f_ref) / np.linalg.norm(f_ref))
        check(e_err <= TOL_REL, f"autodiff energy_rel_err_vs_oracle {e_err} ({path})")
        check(g_err <= TOL_REL, f"autodiff grad_rel_err_vs_oracle {g_err} ({path})")
        out[path] = dict(energy_rel_err_vs_oracle=e_err, grad_rel_err_vs_oracle=g_err)
    return dict(n=n, oracle_pairs=n_ref, paths=out)


def stress_scale(plain, *args, gfn, **kw) -> float:
    """A bound of sum |g d_a d_b| over a stress call's pairs: the trace of
    the plain version's stress with |gfn| (|d_a d_b| <= (d_a^2 + d_b^2) / 2)."""
    def absg(dsq):
        return gfn(dsq).abs()

    out = plain(*args, gfn=absg, out_dtype=torch.float64, **kw)
    return float(torch.trace(out[0] if isinstance(out, tuple) else out))


def table_obs_vs_plain(dev, n: int) -> dict:
    """The term table's instances of K2, K4 and K8 against their plain
    versions on identical sorted inputs at n = 2e5, with the factories of
    `far_potentials` (taken in turns, so that each case runs one): K2 in
    energy and virial mode (f32: its rows are f32 roundings of f64 sums, so
    a row may differ by one f32 ulp where the two sums round apart, else by
    TOL_TABLE of the row's sum of |term|), K4 and K8 on f64 outputs to
    TOL_TABLE of sum |g d_a d_b| (`stress_scale`). Inputs: the thin box's
    uniform cloud and jittered lattice and the prune's hard inputs on the
    lattice (`prune_cases`: the facing clusters and the drifted lattice),
    f32 and split; K4 also under the keep mask (ghost images), the minimum
    image and both (`pbc_sorted`), f32 and split; K8 on the cube's uniform
    cloud, its lattice and the hard inputs on it, maskless and band-masked,
    and with the keep mask on the ghost-extended cube. The launches of the
    kernel calls are counted: one per call. K2's count term is held to the
    plain version exactly on each thin input."""
    from zelll_tpu_torch.ops.lag_pairs import (
        count_term, pair_lag_per_particle, pair_lag_per_particle_plain, pair_lag_stress,
        pair_lag_stress_plain, pbc_keep, suggest_lag,
    )
    from zelll_tpu_torch.ops.pbc import minimage_axes, suggest_pbc_capacity
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_stress, tile_pair_stress_plain
    from zelll_tpu_torch.ops.virial import virial_term_from_gfn
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    t_start = time.perf_counter()
    f64 = torch.float64
    csq = CUTOFF**2
    pots = list(far_potentials().items())
    turn = itertools.count()
    worst = {"K2": 0.0, "K4": 0.0, "K8": 0.0}
    lattice_abs = dict(worst)
    checked = dict.fromkeys(worst, 0)
    reset_launches()

    def note(kernel, abs_err, err, tag):
        worst[kernel] = max(worst[kernel], err)
        if tag == "lattice":
            lattice_abs[kernel] = max(lattice_abs[kernel], abs_err)
        checked[kernel] += 1

    def pots_of(tag):
        # on the uniform clouds only the bounded Morse well: the shifted LJ
        # of sigma 4 overflows f32 at their nearest pairs
        return pots[1:] if "uniform" in tag else pots

    def stress_case(kernel, fn, plain, args, kw, tag):
        choice = pots_of(tag)
        pname, pot = choice[next(turn) % len(choice)]
        got = fn(*args, gfn=pot.gfn, out_dtype=f64, **kw)
        want = plain(*args, gfn=pot.gfn, out_dtype=f64, **kw)
        got, want = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        scale = stress_scale(plain, *args, gfn=pot.gfn, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(np.isfinite(err) and err <= TOL_TABLE * scale,
              f"{kernel} table {pname} ({tag} {kw}): {err} of {scale}")
        note(kernel, err, err / scale, tag)

    thin = np.asarray(lj_box(n, CUTOFF))
    data = {"uniform": generate_points_random(n, thin),
            "lattice": generate_points_lattice(n, thin)}
    for tag, pts in data.items():
        shi, slo, keys, info, _ = sort_split(pts, dev)
        strides = info.strides
        L = suggest_lag(keys, strides)
        cases = {tag: (shi, slo)}
        if tag == "lattice":
            cases.update(prune_cases(shi, slo))
        for ctag, (h, lo) in cases.items():
            c_k = pair_lag_per_particle(h, keys, strides, csq, L=L, term=count_term)
            c_p = pair_lag_per_particle_plain(h, keys, strides, csq, L=L, term=count_term)
            check(bool(torch.equal(c_k, c_p)), f"K2 count ({ctag})")
            for pname, pot in pots_of(ctag):
                for term in (pot.term, virial_term_from_gfn(pot.gfn)):
                    got = pair_lag_per_particle(h, keys, strides, csq, L=L, term=term)
                    want = pair_lag_per_particle_plain(h, keys, strides, csq, L=L, term=term)
                    scale = pair_lag_per_particle_plain(h, keys, strides, csq, L=L,
                                                        term=abs_term(term)).double()
                    torch.cuda.synchronize()
                    ulp = (torch.nextafter(want, torch.full_like(want, float("inf")))
                           - want).double()
                    err = (got.double() - want.double()).abs()
                    check(bool((err <= torch.maximum(TOL_TABLE * scale, ulp)).all()),
                          f"K2 table {pname} ({ctag}): {float(err.max())}")
                    note("K2", float(err.max()), float((err / scale.clamp_min(1e-300)).max()),
                         ctag)
            for lo_ in (None, lo):
                stress_case("K4", pair_lag_stress, pair_lag_stress_plain,
                            (h, keys, strides, csq, lo_), dict(L=L), ctag)
        # the periodic rules on the same points folded into the box
        wrapped = np.mod(pts, thin)
        for kind in ("keep", "mi", "both"):
            if kind == "both":
                caps = dict(zip(("B", "G"), suggest_pbc_capacity(
                    n, thin, CUTOFF, axes=~minimage_axes(thin, CUTOFF))))
            elif kind == "keep":
                caps = dict(zip(("B", "G", "BE"),
                                suggest_pbc_capacity(n, thin, CUTOFF, with_multi=True)))
            else:
                caps = {}
            sh, sl, k, s, pay, mib, reach, ok = pbc_sorted(wrapped, thin, kind, dev, **caps)
            check(bool(ok), f"periodic inputs ({kind} {tag})")
            L = suggest_lag(k, s, reach=reach)
            for lo_ in (None, sl):
                stress_case("K4", pair_lag_stress, pair_lag_stress_plain,
                            (sh, k, s, csq, lo_, pay),
                            dict(L=L, pair_mask=None if pay is None else pbc_keep, mi_box=mib,
                                 key_reach=reach), f"{kind}_{tag}")
        del shi, slo, keys
    pts, side = cube_points(n)
    cube = np.array([side] * 3)
    cdata = {"uniform": pts, "lattice": generate_points_lattice(n, cube)}
    for tag, pts in cdata.items():
        shi, slo, keys, info, _ = sort_split(pts, dev)
        maxj = probe_maxj(keys, info.strides)
        cases = {tag: (shi, slo)}
        if tag == "lattice":
            cases.update(prune_cases(shi, slo))
        for ctag, (h, lo) in cases.items():
            combos = ((False, None), (True, lo)) if ctag != "lattice" else \
                itertools.product((False, True), (None, lo))
            for bandmask, lo_ in combos:
                stress_case("K8", tile_pair_stress, tile_pair_stress_plain,
                            (h, keys, info.strides, csq, lo_),
                            dict(MAXJ=maxj, bandmask=bandmask), ctag)
        Bc, Gc, BEc = suggest_pbc_capacity(n, cube, CUTOFF, with_multi=True)
        sh, sl, k, s, pay, _, _, ok = pbc_sorted(np.mod(pts, cube), cube, "keep", dev,
                                                 B=Bc, G=Gc, BE=BEc)
        check(bool(ok), f"the periodic cube's flag ({tag})")
        kmaxj = probe_maxj(k, s)
        for bandmask, lo_ in itertools.product((False, True), (None, sl)):
            stress_case("K8", tile_pair_stress, tile_pair_stress_plain,
                        (sh, k, s, csq, lo_, pay),
                        dict(MAXJ=kmaxj, bandmask=bandmask, pair_mask=pbc_keep),
                        f"keep_{tag}")
        del shi, slo, keys, sh, sl, k
    counts = read_launches()
    check(counts["lag_per_particle"] > 0 and counts["lag_stress"] > 0
          and counts["tile_stress"] > 0, f"table_obs_vs_plain launches {counts}")
    return dict(n=n, potentials=[p for p, _ in pots], checks=checked,
                max_err_of_scale=worst, lattice_max_abs_err=lattice_abs,
                check_launches={k: v for k, v in counts.items() if v},
                seconds=time.perf_counter() - t_start)


def factory_stress_reference(pts: np.ndarray, box, cutoff: float, gfn) -> np.ndarray:
    """The exact-f64 stress of ``gfn`` (an f64 torch function) over the
    oracle's pairs of the points, or, with ``box``, of the points in
    [0, box) and their numpy ghost images (`periodic_images`; a real-ghost
    pair weighs 1/2, as `periodic_observables` weighs it)."""
    from zelll_tpu_torch import oracle

    n = len(pts)
    ext = pts if box is None else periodic_images(pts, box, cutoff)
    i, j = oracle.pairs(ext, cutoff)
    i, j = i.astype(np.int64), j.astype(np.int64)
    real = (i < n).astype(np.int64) + (j < n)
    keep = real > 0
    i, j, w = i[keep], j[keep], np.where(real[keep] == 2, 1.0, 0.5)
    sig = np.zeros((3, 3))
    for s in range(0, len(i), 1 << 22):
        sl = slice(s, s + (1 << 22))
        d = ext[i[sl]] - ext[j[sl]]
        dsq = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        g = gfn(torch.as_tensor(dsq)).numpy()
        sig += np.einsum("p,pa,pb->ab", w[sl] * g, d, d)
    return sig


def factory_obs_main_path(dev, n: int) -> dict:
    """An ops.potentials factory through the entry points a user calls, at
    n = 1e6, split: `fused_stress_open(gfn=morse.gfn)` on the thin box's
    uniform cloud (K4's table instance) and the cube's (``path="tile"``,
    K8's), `pbc_stress_fused(gfn=...)` on the thin box with
    ``minimage="auto"`` (K4 keep and minimum image) and with ghost images
    (K4 keep), and on the cube (``path="tile"``, K8 keep); each within
    TOL_SPLIT of the largest |sigma_ab| of the exact-f64 stress of the same
    factory's f64 gfn over the oracle's pairs (`factory_stress_reference`,
    run on the host beside the card). Then `pair_lag_per_particle(term=...)`
    (K2's table instance, f32 coordinates) on the thin box's sorted points,
    whose rows sum to twice `pair_lag_reduce`'s total of the same term
    (K1's table instance) within 1e-6. Each call's launches are zeroed just
    before it and read just after: exactly one launch of its kernel (and,
    for the periodic calls, nothing else: their bins and ghosts are plain
    torch), so that a factory's gfn is shown to run K4 and K8 on the card,
    not ``core.pairs``."""
    from zelll_tpu_torch.ops.lag_pairs import (
        lag_coverage_ok, pair_lag_per_particle, pair_lag_reduce, split_f64,
    )
    from zelll_tpu_torch.ops.virial import fused_stress_open, pbc_stress_fused, pbc_virial
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    pot = far_potentials()["morse_4_5"]
    thin = np.asarray(lj_box(n, CUTOFF))
    side = (n / 0.01) ** (1 / 3)
    cube = np.array([side] * 3)
    tpts = np.mod(generate_points_random(n, thin), thin)
    cpts = np.mod(generate_points_random(n, cube), cube)
    o = [0.0] * 3
    thi, tlo = split_f64(torch.as_tensor(tpts, device=dev))
    chi, clo = split_f64(torch.as_tensor(cpts, device=dev))
    Lm = probe_pbc_lag(lambda L: pbc_virial(thi, o, thin, CUTOFF, positions_lo=tlo,
                                            minimage="auto", L=L)[1], L_MAIN)
    Lg = probe_pbc_lag(lambda L: pbc_virial(thi, o, thin, CUTOFF, positions_lo=tlo,
                                            L=L)[1], L_MAIN)
    calls = (("fused_stress_open_thin", "lag_stress", "open", thin,
              lambda: fused_stress_open(thi, CUTOFF, gfn=pot.gfn, L=L_MAIN, positions_lo=tlo)),
             ("fused_stress_open_cube", "tile_stress", "open", cube,
              lambda: fused_stress_open(chi, CUTOFF, gfn=pot.gfn, path="tile", MAXJ=OBS_MAXJ,
                                        positions_lo=clo)),
             ("pbc_stress_fused_thin_minimage", "lag_stress", "periodic", thin,
              lambda: pbc_stress_fused(thi, o, thin, CUTOFF, gfn=pot.gfn, L=Lm,
                                       minimage="auto", positions_lo=tlo)),
             ("pbc_stress_fused_thin_ghosts", "lag_stress", "periodic", thin,
              lambda: pbc_stress_fused(thi, o, thin, CUTOFF, gfn=pot.gfn, L=Lg,
                                       positions_lo=tlo)),
             ("pbc_stress_fused_cube_tile", "tile_stress", "periodic", cube,
              lambda: pbc_stress_fused(chi, o, cube, CUTOFF, gfn=pot.gfn, path="tile",
                                       MAXJ=PBC_MAXJ, positions_lo=clo)))
    out, launches = {}, {}
    with ThreadPoolExecutor(3) as pool:
        refs = {(name, kind): pool.submit(factory_stress_reference,
                                          tpts if box is thin else cpts,
                                          None if kind == "open" else box, CUTOFF, pot.gfn)
                for name, kind, box in (("thin", "open", thin), ("cube", "open", cube),
                                        ("thin", "periodic", thin),
                                        ("cube", "periodic", cube))}
        results = {}
        for name, kernel, kind, box, fn in calls:
            reset_launches()
            sig, ok = fn()
            torch.cuda.synchronize()
            counts = read_launches()
            others = sum(v for k, v in counts.items() if k != kernel)
            check(counts[kernel] == 1 and others == 0,
                  f"{name}: expected one launch of {kernel} alone, counted {counts}")
            check(bool(ok), f"{name}: flag")
            launches[kernel] = launches.get(kernel, 0) + 1
            ms, _ = once_ms(fn)
            results[name] = (sig.double().cpu().numpy(), kind, box, ms)
        for name, (s, kind, box, ms) in results.items():
            ref = refs[("thin" if box is thin else "cube", kind)].result()
            scale = float(np.abs(ref).max())
            err = float(np.abs(s - ref).max()) / scale
            check(np.isfinite(err) and err <= TOL_SPLIT,
                  f"{name}: stress off the f64 reference by {err} of its largest")
            out[name] = dict(ms=ms, launches=1, stress_err_vs_reference=err,
                             reference_scale=scale)
    # K2's table instance through its entry point, held to K1's total
    sp, _, keys, info, _ = sort_split(tpts, dev)
    rows = counted(lambda: pair_lag_per_particle(sp, keys, info.strides, CUTOFF**2, L=L_MAIN,
                                                 term=pot.term), "lag_per_particle")
    launches["lag_per_particle"] = 1
    total = pair_lag_reduce(sp, keys, info.strides, CUTOFF**2, L=L_MAIN, term=pot.term,
                            out_dtype=torch.float64)
    check(bool(lag_coverage_ok(keys, info.strides, L_MAIN)), "K2 coverage")
    k2_err = rel(float(rows.double().sum()), 2.0 * float(total))
    check(k2_err <= TOL_REL, f"K2 table rows vs K1 total: {k2_err}")
    out["pair_lag_per_particle_thin"] = dict(launches=1, rows_sum_rel_err_vs_k1=k2_err)
    return dict(n=n, potential="morse(1.3, 0.5, 4.5)", L_minimage=Lm, L_ghosts=Lg, calls=out,
                launches=launches)


def table_obs_alone(dev, n: int) -> dict:
    """The term table's instances of K2, K4 and K8 alone at n = 1e7, each
    beside its LJ instance on the same inputs (lennard_jones() through the
    table against `lj_term` / `lj_force_factor`): K2 (f32) and K4 open
    (f32 and split) on the main path's thin inputs, K4 with the keep mask
    and the minimum image (f32) on the thin ``minimage="auto"`` inputs, K8
    maskless (f32, MAXJ 24) on the cube, and K8 with the keep mask (f32) on
    the ghost-extended cube. Each: ms of both instances, one plain call's ms
    (at 1e6 where one at 1e7 would take over PLAIN_LIMIT_S), the work of
    the function (the half-stencil candidates, the folded axes wrapping;
    the cutoff pairs, LJ's per-pair count standing for the table's) and its
    bound, the share of it, and the new functions' ptxas lines."""
    from zelll_tpu_torch.ops import lag_pairs, tile_pairs
    from zelll_tpu_torch.ops.lag_pairs import (
        PbcKeepTerm, combine_count, count_term, lj_term, pair_lag_per_particle,
        pair_lag_per_particle_plain, pair_lag_reduce, pair_lag_stress, pair_lag_stress_plain,
        pbc_keep,
    )
    from zelll_tpu_torch.ops.lj import lj_force_factor
    from zelll_tpu_torch.ops.pbc import minimage_axes, suggest_pbc_capacity
    from zelll_tpu_torch.ops.potentials import lennard_jones
    from zelll_tpu_torch.ops.tile_pairs import (
        reduce_tiles, stress_tiles, stress_tiles_plain, tile_inputs,
    )
    from zelll_tpu_torch.utils.datagen import generate_points_random, lj_box

    lj = lennard_jones()
    csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
    f64 = torch.float64
    out = {}

    def row(name, table, ljfn, b, plain=None, **extra):
        ms, lj_ms = cuda_ms(table, 10), cuda_ms(ljfn, 10)
        out[name] = dict(ms=ms, lj_ms=lj_ms, table_over_lj=ms / lj_ms, **b,
                         share_of_bound=b["bound_ms"] / ms, **(plain or {}), **extra)

    thin = np.asarray(lj_box(n, CUTOFF))
    shi, slo, keys, info, _ = sort_split(generate_points_random(n, thin), dev)
    strides = info.strides
    cand = stencil_candidates(keys, info)
    pairs = combine_count(pair_lag_reduce(shi, keys, strides, csq, L=L_MAIN, term=count_term,
                                          out_dtype=torch.int32))
    plain_ms, _ = once_ms(lambda: pair_lag_per_particle_plain(shi, keys, strides, csq,
                                                              L=L_MAIN, term=lj.term))
    row("K2_table_f32", lambda: pair_lag_per_particle(shi, keys, strides, csq, L=L_MAIN,
                                                      term=lj.term),
        lambda: pair_lag_per_particle(shi, keys, strides, csq, L=L_MAIN, term=lj_term),
        bound(n * (4 * 4 + 4), cand * INSTR_PER_CANDIDATE[False] + pairs * INSTR_PER_TERM_PAIR),
        dict(plain_ms=plain_ms, plain_n=n), pairs=pairs, candidates=cand)
    for tag, lo in (("f32", None), ("split", slo)):
        plain = None
        if tag == "split":
            plain_ms, _ = once_ms(lambda: pair_lag_stress_plain(shi, keys, strides, csq, lo,
                                                                L=L_MAIN, gfn=lj.gfn))
            plain = dict(plain_ms=plain_ms, plain_n=n)
        row(f"K4_table_{tag}",
            lambda: pair_lag_stress(shi, keys, strides, csq, lo, L=L_MAIN, gfn=lj.gfn),
            lambda: pair_lag_stress(shi, keys, strides, csq, lo, L=L_MAIN, gfn=lj_force_factor),
            bound(n * 4 * ((6 if lo is not None else 3) + 1),
                  cand * INSTR_PER_CANDIDATE[lo is not None] + pairs * INSTR_PER_STRESS_PAIR),
            plain, pairs=pairs, candidates=cand)
    del shi, slo, keys
    # K4 keep + minimum image on the thin minimage="auto" inputs
    caps = dict(zip(("B", "G"), suggest_pbc_capacity(n, thin, CUTOFF,
                                                     axes=~minimage_axes(thin, CUTOFF))))
    sh, _, k, s, pay, mib, reach, ok = pbc_sorted(
        np.mod(generate_points_random(n, thin), thin), thin, "both", dev, **caps)
    check(bool(ok), "the minimum-image inputs' flag")
    s = torch.as_tensor(s, dtype=torch.int32, device=dev)
    L = probe_pbc_lag(lambda L: lag_pairs.lag_coverage_ok(k, s, L, reach=reach), L_MAIN)
    kw = dict(L=L, mi_box=mib, key_reach=reach)
    folds = tuple(int(np.ceil(thin[a] / CUTOFF)) if float(mib[a]) > 0 else 0 for a in range(3))
    mcand = periodic_stencil_candidates(k, s, folds)
    cut = combine_count(pair_lag_reduce(sh, k, s, csq, term=count_term,
                                        out_dtype=torch.int32, **kw))
    kept = combine_count(pair_lag_reduce(sh, k, s, csq, None, pay, term=PbcKeepTerm(count_term),
                                         out_dtype=torch.int32, **kw))
    plain_ms, _ = once_ms(lambda: pair_lag_stress_plain(sh, k, s, csq, None, pay, gfn=lj.gfn,
                                                        pair_mask=pbc_keep, **kw))
    row("K4_table_keep_minimage_f32",
        lambda: pair_lag_stress(sh, k, s, csq, None, pay, gfn=lj.gfn, pair_mask=pbc_keep, **kw),
        lambda: pair_lag_stress(sh, k, s, csq, None, pay, gfn=lj_force_factor,
                                pair_mask=pbc_keep, **kw),
        bound(sh.shape[0] * 4 * (3 + 1 + 1),
              mcand * (INSTR_PER_CANDIDATE[False] + 2 * INSTR_MI_FOLD[False])
              + cut * INSTR_KEEP + kept * INSTR_PER_STRESS_PAIR),
        dict(plain_ms=plain_ms, plain_n=n), rows=sh.shape[0], L=L, pairs=kept,
        cutoff_pairs=cut, candidates=mcand)
    del sh, k, pay
    # K8 maskless on the cube, and with the keep mask on the ghost-extended cube
    pts, side = cube_points(n)
    cube = np.array([side] * 3)
    shi, _, keys, info, _ = sort_split(pts, dev)
    inp = tile_inputs(shi.t().contiguous(), keys, info.strides, CB=CB, MAXJ=OBS_MAXJ,
                      bandmask=False)
    check(bool(inp.coverage_ok), "K8 table coverage on the cube")
    ccand = stencil_candidates(keys, info)
    cpairs = combine_count(reduce_tiles(inp, csq, term=count_term, out_dtype=torch.int32))

    def k8_plain(m):
        h, _, kk, inf, _ = sort_split(cube_points(m)[0], dev)
        x = tile_inputs(h.t().contiguous(), kk, inf.strides, CB=CB, MAXJ=OBS_MAXJ,
                        bandmask=False)
        return once_ms(lambda: stress_tiles_plain(x, csq, gfn=lj.gfn))[0]

    row("K8_table_f32", lambda: stress_tiles(inp, csq, gfn=lj.gfn),
        lambda: stress_tiles(inp, csq, gfn=lj_force_factor),
        bound(n * 4 * (3 + 1) + inp.bounds.numel() * 4,
              ccand * INSTR_PER_CANDIDATE[False] + cpairs * INSTR_PER_STRESS_PAIR),
        plain_time(k8_plain, n), pairs=cpairs, candidates=ccand, MAXJ=OBS_MAXJ)
    del shi, keys, inp
    Bc, Gc, BEc = suggest_pbc_capacity(n, cube, CUTOFF, with_multi=True)

    def keep_inp(m):
        cb = np.array([(m / 0.01) ** (1 / 3)] * 3)
        bc, gc, bec = suggest_pbc_capacity(m, cb, CUTOFF, with_multi=True)
        h, _, kk, ss, p, _, _, ok = pbc_sorted(
            np.random.default_rng(7).random((m, 3)) * cb, cb, "keep", dev, B=bc, G=gc, BE=bec)
        check(bool(ok), "the periodic cube's flag")
        x = tile_inputs(h.t().contiguous(), kk, ss, CB=CB, MAXJ=PBC_MAXJ, bandmask=False)
        check(bool(x.coverage_ok), f"coverage on the periodic cube at MAXJ {PBC_MAXJ}")
        return h, kk, ss, p, x

    sh, k, s, pay, kinp = keep_inp(n)
    kcand = periodic_stencil_candidates(k, s)
    kcut = combine_count(reduce_tiles(kinp, csq, term=count_term, out_dtype=torch.int32))
    kkept = combine_count(reduce_tiles(kinp, csq, term=PbcKeepTerm(count_term), payload=pay,
                                       out_dtype=torch.int32))

    def keep_plain(m):
        _, _, _, p, x = keep_inp(m)
        return once_ms(lambda: stress_tiles_plain(x, csq, gfn=lj.gfn, payload=p,
                                                  pair_mask=pbc_keep))[0]

    row("K8_table_keep_f32",
        lambda: stress_tiles(kinp, csq, gfn=lj.gfn, payload=pay, pair_mask=pbc_keep),
        lambda: stress_tiles(kinp, csq, gfn=lj_force_factor, payload=pay, pair_mask=pbc_keep),
        bound(sh.shape[0] * 4 * (3 + 1 + 1) + kinp.bounds.numel() * 4,
              kcand * INSTR_PER_CANDIDATE[False] + kcut * INSTR_KEEP
              + kkept * INSTR_PER_STRESS_PAIR),
        plain_time(keep_plain, n), rows=sh.shape[0], pairs=kkept, cutoff_pairs=kcut,
        candidates=kcand, MAXJ=PBC_MAXJ)
    del sh, k, pay, kinp
    out.update(K2_table_ptxas=ptxas_functions(lag_pairs.load_per_particle_kernel.log,
                                              "table_kernel"),
               K4_table_ptxas=ptxas_functions(lag_pairs.load_stress_kernel.log, "_table_"),
               K8_table_ptxas=ptxas_functions(tile_pairs.load_stress_kernel.log, "_table_"))
    return dict(n=n, instances=out)


def obs_table_rows(tov, foc, toa) -> list:
    """The kernels line's rows of the term table's instances of K2, K4 and
    K8 (from `table_obs_alone`: ms beside the LJ instance's, plain ms,
    bound; launches from `factory_obs_main_path`'s calls through the entry
    points; max_abs_err: the largest error of `table_obs_vs_plain` on the
    lattice, over its scale)."""
    rows = []
    for name, src, replaces, key, instance, launches, kernel in (
            ("lag_per_particle_table", "lag_per_particle", "zelll_tpu/ops/pallas_pairs.py:401",
             "K2_table_f32", "term table, lennard_jones(), f32",
             foc["calls"]["pair_lag_per_particle_thin"]["launches"], "K2"),
            ("lag_stress_table", "lag_stress", "zelll_tpu/ops/pallas_pairs.py:1018",
             "K4_table_split", "term table, lennard_jones(), open, split",
             foc["calls"]["fused_stress_open_thin"]["launches"], "K4"),
            ("lag_stress_table_keep_minimage", "lag_stress", "zelll_tpu/ops/pallas_pairs.py:1018",
             "K4_table_keep_minimage_f32", "term table, keep mask and minimum image, f32",
             foc["calls"]["pbc_stress_fused_thin_minimage"]["launches"], "K4"),
            ("tile_stress_table", "tile_stress", "zelll_tpu/ops/tile_pairs.py:735",
             "K8_table_f32", "term table, lennard_jones(), maskless, f32",
             foc["calls"]["fused_stress_open_cube"]["launches"], "K8"),
            ("tile_stress_table_keep", "tile_stress", "zelll_tpu/ops/tile_pairs.py:735",
             "K8_table_keep_f32", "term table, keep mask, maskless, f32",
             foc["calls"]["pbc_stress_fused_cube_tile"]["launches"], "K8")):
        r = toa["instances"][key]
        rows.append(dict(name=name, route="cuda", source=f"zelll_tpu_torch/csrc/{src}.cu",
                         replaces=replaces, instance=instance, launches=launches,
                         max_abs_err=tov["lattice_max_abs_err"][kernel],
                         max_err_of_scale=tov["max_err_of_scale"][kernel],
                         ms=r["ms"], lj_instance_ms=r["lj_ms"], plain_ms=r["plain_ms"],
                         plain_n=r["plain_n"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         share_of_bound=r["share_of_bound"], library_ms=None))
    return rows


# -- the slab decomposition on one card (parallel/domain.py, min_islot) --------

SLAB_SHARDS = 4
SLAB_STEPS = 5
SLAB_REPS = 5
SLAB_GAP_SITES = (128 * 8, 128 * 40)  # prune_cases' facing clusters
# A sharded f32 total against the single-device one, on the same sorted
# points: each shard's total and the single-device total are f64 sums of
# the same f32 terms, each rounded once to f32, and psum adds the D = 4 f32
# shard totals in f32, so they differ by at most D + 1 = 5 roundings of
# 2^-24 of a total without cancellation (the uniform clouds' LJ totals are
# carried by their near pairs); 8 x 2^-24 with slack.
TOL_SLAB = 8 * 2.0**-24
# The sharded gradient against the single-device forces, over the largest
# force: each row sums the same f32 pair forces, in the order of its own
# block's sweep.
TOL_SLAB_GRAD = 1e-5


def slab_halo(pos, cutoff: float, dev) -> tuple:
    """The rows each slab boundary needs from its neighbour, counted as the
    path's own halo check counts them (`domain._halo_needed` on each
    shard's sorted block of the points in `partition_by_slab` order, both
    sides), and the halo H the slab path takes: 1.25 times the largest,
    rounded up to 1024."""
    from zelll_tpu_torch.core import bin_and_sort
    from zelll_tpu_torch.parallel import domain, mesh

    def body(p):
        info = domain._global_grid_info(p, cutoff)
        bins, _ = bin_and_sort(p, cutoff, max_cells=1, info=info)
        return (torch.stack(domain._halo_needed(bins.sorted_keys, info.strides)),)

    run = mesh.shard_map(body, mesh.make_mesh(SLAB_SHARDS, devices=dev), (mesh.AXIS,),
                         (mesh.AXIS,))
    most = int(run(torch.as_tensor(pos, dtype=torch.float32, device=dev))[0].max())
    return most, -(-int(1.25 * most) // 1024) * 1024


def slab_blocks(parts, cutoff: float, H: int, dev, tile: bool = False,
                right: bool = False) -> dict:
    """Each shard's halo-extended [left ghosts | own] block of the slab path
    (with ``right``, [left ghosts | own | right ghosts], the forces' block,
    whose [left ghosts | own] prefix `slab_left` takes) on a
    SLAB_SHARDS-shard mesh of the card, built by the path's own helper
    (`domain.slab_block`: the global grid, the local sort, the halo
    exchange and, for the tile kernels, the key-safe ring-wraparound
    ghosts). Returns dict(blocks=[(ext, keys)], strides, H_eff)."""
    from zelll_tpu_torch.parallel import domain, mesh

    def body(pos):
        b = domain.slab_block(pos, cutoff, H, right=right, wrap_safe=tile)
        return b.ext, b.keys, b.info.strides, torch.tensor(b.H_eff)

    run = mesh.shard_map(body, mesh.make_mesh(SLAB_SHARDS, devices=dev), (mesh.AXIS,),
                         (mesh.AXIS, mesh.AXIS, None, None))
    ext, keys, strides, H_eff = run(torch.as_tensor(parts, dtype=torch.float32, device=dev))
    m = ext.shape[0] // SLAB_SHARDS
    blocks = [(ext[k * m:(k + 1) * m].contiguous(), keys[k * m:(k + 1) * m].contiguous())
              for k in range(SLAB_SHARDS)]
    return dict(blocks=blocks, strides=strides, H_eff=int(H_eff), right=right)


def slab_left(sb: dict, k: int) -> tuple:
    """Shard k's [left ghosts | own] block (ext, keys) of `slab_blocks`: a
    prefix of the ``right`` block."""
    ext, keys = sb["blocks"][k]
    m = ext.shape[0] - sb["H_eff"] if sb["right"] else ext.shape[0]
    return ext[:m], keys[:m]


def slab_maxj(sb: dict, full: bool) -> int:
    """The tile windows the slab path's blocks need, from a ``right`` build
    of `slab_blocks` (the key-safe wraparound ghosts in place):
    `probe_maxj` of each shard's [left ghosts | own] block (the energy's
    and the histogram's), or with ``full`` of its [left ghosts | own |
    right ghosts] block (the forces'); the largest band's over the shards,
    plus 1. With ``full`` the last shard's chunk that holds its last owned
    rows and its first right ghosts (whose keys lie above the box) reaches
    back over a whole cell layer in its backward bands, so this is far
    above the global probe; the kernels walk each chunk's own windows, so
    that costs the one chunk alone."""
    keys = [sb["blocks"][k][1] if full else slab_left(sb, k)[1] for k in range(SLAB_SHARDS)]
    return max(max(probe_maxj(k, sb["strides"], full=full)) for k in keys) + 1


def slab_inputs(pts: np.ndarray, cutoff: float, H: int, dev, tile: bool) -> tuple:
    """({name: (ext, keys, min_islot values)}, strides, H_eff): the blocks
    of `slab_blocks` (shard 0, with the wraparound ghosts, and shard 1),
    shard 1 also as the prune's hard inputs (`cluster_gap`'s facing
    clusters, and the rows moved by up to 2.5 % of a cutoff since their
    keys were built), each held at min_islot 0, 1, 31, 33, H_eff, n - 1
    and n, the facing clusters also at the later cluster of each gap site
    (32 and 40 past it)."""
    from zelll_tpu_torch.parallel import partition_by_slab
    from zelll_tpu_torch.utils.datagen import cluster_gap

    parts, _ = partition_by_slab(pts, cutoff, SLAB_SHARDS)
    sb = slab_blocks(parts, cutoff, H, dev, tile)
    (e0, k0), (e1, k1) = sb["blocks"][:2]
    out = {"shard0": (e0, k0), "shard1": (e1, k1)}
    p64 = e1.double()
    gap = cluster_gap(p64.cpu().numpy(), cutoff, SLAB_GAP_SITES)
    drift = p64 + torch.as_tensor(np.random.default_rng(5).uniform(
        -0.025 * cutoff, 0.025 * cutoff, tuple(p64.shape)), device=dev)
    out["cluster_gap"] = (torch.as_tensor(gap, dtype=torch.float32, device=dev), k1)
    out["drifted"] = (drift.float(), k1)
    n = e0.shape[0]
    islots = sorted({0, 1, 31, 33, sb["H_eff"], n - 1, n})
    gap = sorted({*islots, *(s + d for s in SLAB_GAP_SITES for d in (32, 40))})
    return ({name: (ext, keys, gap if name == "cluster_gap" else islots)
             for name, (ext, keys) in out.items()}, sb["strides"], sb["H_eff"])


def islot_launch(wrapper, islot: int, fn):
    """``fn()``, which must launch ``wrapper``'s kernel once, through its
    min_islot instance where ``islot`` != 0."""
    before = (wrapper.launches, wrapper.islot_launches)
    out = fn()
    check((wrapper.launches, wrapper.islot_launches) == (before[0] + 1,
                                                         before[1] + int(islot != 0)),
          f"expected one launch of {wrapper.__name__} (min_islot {islot})")
    return out


def slab_vs_plain(dev, n: int) -> dict:
    """Each min_islot instance of K1, K5, K6 and K9 against its plain
    version on the slab path's own halo-extended blocks (`slab_inputs`: 4
    shards of n points; the thin box for K1 and K5, the cube for K6 and
    K9; the uniform cloud, the jittered lattice, and on the lattice the
    prune's hard inputs), at every min_islot of `slab_inputs`: LJ f64
    totals to TOL_KERNEL, the histograms' bins exactly (f32 and f64
    coordinates); the term table (lennard_jones(0.7, 1.1)) and the species
    term (lennard_jones_mixed over a species plane) of K1 and K6 on a
    jittered lattice at POT_CUTOFF to TOL_TABLE of the sum of |term| over
    the block's pairs (islots from 0 up, so the first is the whole block).
    Returns the cases and each instance's largest error."""
    from zelll_tpu_torch.ops import potentials as P
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count_vec, pair_lag_hist, pair_lag_hist_plain, pair_lag_reduce,
        pair_lag_reduce_plain,
    )
    from zelll_tpu_torch.ops.tile_pairs import (
        tile_pair_hist, tile_pair_hist_plain, tile_pair_reduce, tile_pair_reduce_plain,
    )
    from zelll_tpu_torch.utils.datagen import (
        generate_points_lattice, generate_points_random, lj_box,
    )

    f64 = torch.float64
    csq = CUTOFF**2
    esq = hist_edges_sq(HIST_K)
    errs = dict.fromkeys(("K1", "K1_table", "K1_species", "K6", "K6_table", "K6_species"), 0.0)
    errs.update(dict.fromkeys(("K5_f32", "K5_f64", "K9_f32", "K9_f64"), 0))
    cases = {}
    side = (n / 0.01) ** (1 / 3)
    thin = {"uniform": generate_points_random(n, lj_box(n, CUTOFF)),
            "lattice": generate_points_lattice(n, lj_box(n, CUTOFF))}
    cube = {"uniform": cube_points(n)[0],
            "lattice": generate_points_lattice(n, (side, side, side))}
    for box, data, tile, H in (("thin", thin, False, 2048), ("cube", cube, True, n // 8)):
        for kind, pts in data.items():
            inputs, strides, H_eff = slab_inputs(pts, CUTOFF, H, dev, tile)
            for name, (ext, keys, islots) in inputs.items():
                if kind == "uniform" and name in ("cluster_gap", "drifted"):
                    continue
                maxj = probe_maxj(keys, strides) if tile else None
                pairs = 0
                for k in islots:
                    if tile:
                        kw = dict(MAXJ=maxj, min_islot=k, out_dtype=f64)
                        got, ok = islot_launch(tile_pair_reduce, k, lambda: tile_pair_reduce(
                            ext, keys, strides, csq, **kw))
                        want, ok_p = tile_pair_reduce_plain(ext, keys, strides, csq, **kw)
                        check(bool(ok) and bool(ok_p), f"K6 coverage ({box} {kind} {name})")
                    else:
                        kw = dict(L=L_MAIN, min_islot=k, out_dtype=f64)
                        got = islot_launch(pair_lag_reduce, k, lambda: pair_lag_reduce(
                            ext, keys, strides, csq, **kw))
                        want = pair_lag_reduce_plain(ext, keys, strides, csq, **kw)
                    kernel = "K6" if tile else "K1"
                    got, want = float(got), float(want)
                    check(np.isfinite(got) and rel(got, want) <= TOL_KERNEL,
                          f"{kernel} min_islot {k}: {got} vs plain {want} ({box} {kind} {name})")
                    if kind == "lattice":
                        errs[kernel] = max(errs[kernel], abs(got - want))
                    for pos in (ext, ext.double()):
                        tag = f"{'K9' if tile else 'K5'}_{'f64' if pos.dtype == f64 else 'f32'}"
                        if tile:
                            h, ok = islot_launch(tile_pair_hist, k, lambda: tile_pair_hist(
                                pos, keys, strides, esq, MAXJ=maxj, min_islot=k))
                            hp, _ = tile_pair_hist_plain(pos, keys, strides, esq.to(pos.dtype),
                                                         MAXJ=maxj, min_islot=k)
                            check(bool(ok), f"K9 coverage ({box} {kind} {name})")
                        else:
                            h = islot_launch(pair_lag_hist, k, lambda: pair_lag_hist(
                                pos, keys, strides, esq, L=L_MAIN, min_islot=k))
                            hp = pair_lag_hist_plain(pos, keys, strides, esq.to(pos.dtype),
                                                     L=L_MAIN, min_islot=k)
                        h, hp = combine_count_vec(h), combine_count_vec(hp)
                        diff = int(np.abs(h - hp).max())
                        check(diff == 0, f"{tag} min_islot {k}: bins off by {diff} "
                              f"({box} {kind} {name})")
                        errs[tag] = max(errs[tag], diff)
                        if k == H_eff:
                            pairs = int(hp[-1])
                cases[f"{box}_{kind}_{name}"] = dict(rows=ext.shape[0], H_eff=H_eff,
                                                    islots=islots, owned_pairs=pairs)
    # the term table and the species term at POT_CUTOFF
    rng = np.random.default_rng(17)
    table = table_potentials()["lennard_jones"]
    mixed = P.lennard_jones_mixed(MIXED_EPS, MIXED_SIGMA)
    m = max(round(n ** (1 / 3)), 16)
    cells = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pot_cube = (cells + 0.5) * POT_SPACING + rng.uniform(-0.2, 0.2, cells.shape)
    pcsq = POT_CUTOFF**2
    for box, pts, tile, H in (("thin", pot_lattice(n, rng), False, 1024),
                              ("cube", pot_cube, True, len(pot_cube) // 8)):
        inputs, strides, H_eff = slab_inputs(pts, POT_CUTOFF, H, dev, tile)
        for name, (ext, keys, islots) in inputs.items():
            sp = species_plane(ext.shape[0], rng, dev)
            maxj = probe_maxj(keys, strides) if tile else None
            for tname, term, pay in (("table", table.term, None), ("species", mixed.term, sp)):
                kernel = f"{'K6' if tile else 'K1'}_{tname}"
                scale = None  # the sum of |term| over every pair of the block
                for k in islots:
                    if tile:
                        kw = dict(MAXJ=maxj, min_islot=k, out_dtype=f64)
                        got, ok = islot_launch(tile_pair_reduce, k, lambda: tile_pair_reduce(
                            ext, keys, strides, pcsq, None, pay, term=term, **kw))
                        want, _ = tile_pair_reduce_plain(ext, keys, strides, pcsq, None, pay,
                                                         term=term, **kw)
                        if scale is None:
                            scale, _ = tile_pair_reduce_plain(ext, keys, strides, pcsq, None,
                                                              pay, term=abs_term(term), **kw)
                        check(bool(ok), f"K6 coverage ({box} {name})")
                    else:
                        p = None if pay is None else pay[:, None]
                        kw = dict(L=512, min_islot=k, out_dtype=f64)
                        got = islot_launch(pair_lag_reduce, k, lambda: pair_lag_reduce(
                            ext, keys, strides, pcsq, None, p, term=term, **kw))
                        want = pair_lag_reduce_plain(ext, keys, strides, pcsq, None, p,
                                                     term=term, **kw)
                        if scale is None:
                            scale = pair_lag_reduce_plain(ext, keys, strides, pcsq, None, p,
                                                          term=abs_term(term), **kw)
                    err = energy_check(got, want, scale, f"{kernel} min_islot {k} {box} {name}")
                    errs[kernel] = max(errs[kernel], err)
            cases[f"pot_{box}_{name}"] = dict(rows=ext.shape[0], H_eff=H_eff, islots=islots)
    return dict(n=n, shards=SLAB_SHARDS, cases=cases, max_err=errs)


def slab_alone(dev, sb: dict, cutoff: float, tile: bool, maxj, terms,
               plain_sb: dict | None = None) -> dict:
    """The min_islot instances alone on shard 1's halo-extended [left
    ghosts | own] block of the main path's points (``sb``, `slab_blocks`;
    no wraparound ghosts): ms over 10 runs (K1 through
    `pair_lag_reduce`, K5 through its launch function, K6 and K9 through
    `reduce_tiles` and `hist_tiles` on prepared window bounds, as the alone
    phases time them), one plain pass, the bound of the work the rule
    leaves (the candidates whose larger slot is owned: the lag-window
    candidates of the owned rows for K1 and K5, the half-stencil candidates
    of the block less those among its ghosts for K6 and K9; the owned
    cutoff pairs), the lane evaluations the cluster prune leaves in the
    owned clusters (each cluster at or above min_islot // 32, the boundary
    one with its whole box) per owned half-stencil candidate, as the open
    instances' rows count them, and the results against the plain version:
    LJ's f64 total to TOL_KERNEL, the term table's and the species term's
    to TOL_TABLE of the plain sum of |term| (`energy_check`), the
    histograms' bins exactly; a mismatch fails the phase.
    ``terms``: {instance: (term, whether it reads a species plane)}.
    ``plain_sb`` (the tile path): the blocks of a smaller partition, on
    whose shard 1 block the plain histograms are timed and checked
    (``plain_rows``), as `plain_time` does for passes that would take
    seconds."""
    from zelll_tpu_torch.core import key_window
    from zelll_tpu_torch.ops import lag_pairs
    from zelll_tpu_torch.ops.cluster_prune import (
        CLUSTER, lag_cluster_entries, tile_cluster_entries,
    )
    from zelll_tpu_torch.ops.lag_pairs import combine_count_vec, hist_edges
    from zelll_tpu_torch.ops.tile_pairs import (
        hist_tiles, hist_tiles_plain, reduce_tiles, reduce_tiles_plain, tile_inputs,
    )

    ext, keys = slab_left(sb, 1)
    strides, k = sb["strides"], sb["H_eff"]
    rows = ext.shape[0]
    csq = torch.tensor(cutoff, dtype=torch.float32) ** 2
    f64 = torch.float64
    per_pair = int(np.ceil(np.log2(HIST_K)))
    esq = hist_edges_sq(HIST_K).to(dev)
    stencil = (periodic_stencil_candidates(keys, strides)
               - periodic_stencil_candidates(keys[:k], strides))
    if tile:
        inp = tile_inputs(ext.t().contiguous(), keys, strides, CB=CB, MAXJ=maxj, bandmask=False)
        check(bool(inp.coverage_ok), "K6 coverage failed on the slab block")
        candidates = stencil
        owned = tile_cluster_entries(inp, csq, half=True)
        extra = inp.bounds.numel() * 4
    else:
        first = torch.searchsorted(keys, keys - key_window(strides))
        slots = torch.arange(rows, device=dev)
        candidates = int(torch.clamp(slots - first, max=L_MAIN)[k:].sum())
        owned = lag_cluster_entries(ext.t(), None, keys, strides, csq, L_MAIN, half=True)
        extra = 0
    lanes = int(owned[k // CLUSTER:].sum()) * CLUSTER
    pairs = int(combine_count_vec(
        hist_tiles(inp, esq, min_islot=k) if tile else
        lag_pairs._lag_hist_cuda(ext, keys, strides, esq, None, None, L=L_MAIN,
                                 pair_mask=None, min_islot=k))[-1])
    out = dict(rows=rows, H_eff=k, owned_candidates=candidates,
               owned_stencil_candidates=stencil, owned_pairs=pairs, pruned_evaluations=lanes,
               pruned_evaluations_per_candidate=lanes / stencil)
    for name, (term, species) in terms.items():
        plane = species_plane(rows, np.random.default_rng(4), dev, odd=False) if species else None
        if tile:
            def run(plain=False, term=term, plane=plane):
                fn = reduce_tiles_plain if plain else reduce_tiles
                return fn(inp, csq, term=term, payload=plane, min_islot=k, out_dtype=f64)
        else:
            def run(plain=False, term=term, plane=plane):
                fn = lag_pairs.pair_lag_reduce_plain if plain else lag_pairs.pair_lag_reduce
                return fn(ext, keys, strides, csq, None,
                          None if plane is None else plane[:, None], L=L_MAIN, term=term,
                          out_dtype=f64, min_islot=k)
        ms = cuda_ms(run, 10)
        plain_ms, want = once_ms(lambda: run(True))
        got, want = float(run()), float(want)
        what = f"{'K6' if tile else 'K1'} min_islot {name} alone"
        if name == "lj":
            check(np.isfinite(got) and rel(got, want) <= TOL_KERNEL,
                  f"{what}: {got} vs plain {want}")
            scale = err = None
        else:
            scale = float(run(True, term=abs_term(term)))
            err = energy_check(got, want, scale, what)
        per = INSTR_PER_PAIR if name == "lj" else INSTR_PER_TERM_PAIR
        b = bound(rows * 4 * (3 + 1 + (plane is not None)) + extra,
                  candidates * INSTR_PER_CANDIDATE[False] + pairs * per)
        out[name] = dict(ms=ms, plain_ms=plain_ms, **b, share_of_bound=b["bound_ms"] / ms,
                         energy=got, plain_energy=want, rel_err=rel(got, want),
                         abs_err=abs(got - want), abs_term_sum=scale, err_of_abs_sum=err)
    if tile and plain_sb is not None:
        pb = plain_sb
        p_ext, p_keys = slab_left(pb, 1)
    for tag, pos in (("f32", ext), ("f64", ext.double())):
        plain_rows = rows
        if tile:
            x = inp if tag == "f32" else tile_inputs(pos.t().contiguous(), keys, strides, CB=CB,
                                                     MAXJ=maxj, bandmask=False)
            px = x
            if plain_sb is not None:
                pp = p_ext if tag == "f32" else p_ext.double()
                px = tile_inputs(pp.t().contiguous(), p_keys, pb["strides"], CB=CB,
                                 MAXJ=maxj, bandmask=False)
                plain_rows = pp.shape[0]

            def run(plain=False, x=x, px=px, k=k, pk=pb["H_eff"] if plain_sb is not None else k):
                if plain:
                    return hist_tiles_plain(px, esq, min_islot=pk)
                return hist_tiles(x, esq, min_islot=k)
        else:
            edges = hist_edges(esq, pos.dtype, dev)

            def run(plain=False, pos=pos, edges=edges):
                if plain:
                    return lag_pairs.pair_lag_hist_plain(pos, keys, strides, edges, L=L_MAIN,
                                                         min_islot=k)
                return lag_pairs._lag_hist_cuda(pos, keys, strides, edges, None, None,
                                                L=L_MAIN, pair_mask=None, min_islot=k)
        ms = cuda_ms(run, 10)
        plain_ms, want = once_ms(lambda: run(True))
        got = run() if plain_rows == rows else hist_tiles(px, esq, min_islot=pb["H_eff"])
        diff = int(np.abs(combine_count_vec(got) - combine_count_vec(want)).max())
        check(diff == 0, f"{'K9' if tile else 'K5'} min_islot {tag} alone: bins off by {diff}")
        b = bound(rows * (pos.element_size() * 3 + 4) + extra + HIST_K * 8,
                  candidates * INSTR_PER_CANDIDATE[False] + pairs * per_pair)
        out[f"hist_{tag}"] = dict(ms=ms, plain_ms=plain_ms, plain_rows=plain_rows, **b,
                                  share_of_bound=b["bound_ms"] / ms, max_count_diff=diff)
    lib = (lag_pairs.load_kernel, lag_pairs.load_hist_kernel)
    if tile:
        from zelll_tpu_torch.ops import tile_pairs

        lib = (tile_pairs.load_kernel, tile_pairs.load_hist_kernel)
    out["ptxas"] = {**ptxas_functions(lib[0].log, "islot"), **ptxas_functions(lib[1].log, "islot")}
    return out


def slab_main_path(dev, n: int) -> dict:
    """The slab decomposition at n = 1e7 over SLAB_SHARDS shards of the one
    card, through its entry points (`zelll_tpu_torch.parallel`), on the
    bench protocol's thin box (30 x 30 x n/9, cutoff 10, uniform) with
    ``use_pallas`` (K1, K5, K3) and its cube (uniform, density 0.01) with
    ``use_tile`` (K6, K9, K7): `partition_by_slab` on the host (its time
    apart), `sharded_lj_energy`, `sharded_pair_hist` (f32 and f64
    coordinates), `make_sharded_potential`'s value and gradient with LJ and
    with lennard_jones(0.7, 1.1) (the term table), `sharded_lj_energy` with
    lennard_jones_mixed's species column (``n_payload=1``), and
    `sharded_md_step` (a warm-up and SLAB_STEPS steps) on the MD protocol's
    lattice start state of the same box. Each call's launches are zeroed
    just before it and read just after, and must be exact; ms per call
    from CUDA events and the busy share from a profile. It checks every
    coverage flag; the histograms' bins (the last one the pair count) equal
    to the single-device histogram of the same points; the energies equal
    to the single-device calls' to TOL_SLAB; the gradients equal to the
    single-device potential's to TOL_SLAB_GRAD of the largest; and one
    shard equal to the single-device call on the same sorted points,
    bitwise. Then each min_islot instance alone (`slab_alone`). Each box's
    halo-extended blocks are built once (`slab_blocks`), for the windows
    and for `slab_alone`; ``setup_s`` holds the host seconds of its set-up
    steps."""
    from zelll_tpu_torch.core import bin_and_sort
    from zelll_tpu_torch.ops import potentials as P
    from zelll_tpu_torch.ops.autodiff import make_pair_potential
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count_vec, lj_term, pair_lag_hist, pair_lag_reduce,
    )
    from zelll_tpu_torch.ops.tile_pairs import tile_pair_hist, tile_pair_reduce
    from zelll_tpu_torch.parallel import (
        make_mesh, make_sharded_potential, partition_by_slab, sharded_lj_energy,
        sharded_md_step, sharded_pair_hist,
    )
    from zelll_tpu_torch.utils.datagen import generate_points_random, lattice_cloud, lj_box

    D = SLAB_SHARDS
    mesh, one = make_mesh(D, devices=dev), make_mesh(1, devices=dev)
    table = table_potentials()["lennard_jones"]
    mixed = P.lennard_jones_mixed(MIXED_EPS, MIXED_SIGMA)
    edges = np.linspace(0.0, CUTOFF, HIST_K)
    # the sharded histogram's squared edges: squared in f64, then rounded to
    # f32 (as the JAX package's sharded_pair_hist does)
    esq = torch.as_tensor(edges**2, dtype=torch.float32, device=dev)
    side = (n / 0.01) ** (1 / 3)
    out, rows = {}, {}
    for box, use_tile in (("thin", False), ("cube", True)):
        setup_s, lap = {}, [time.perf_counter()]

        def done(step):
            torch.cuda.synchronize()
            now = time.perf_counter()
            setup_s[step] = setup_s.get(step, 0.0) + now - lap[0]
            lap[0] = now

        pts = (cube_points(n)[0] if use_tile else
               generate_points_random(n, lj_box(n, CUTOFF)))
        done("points")
        parts, n_local = partition_by_slab(pts, CUTOFF, D)
        done("partition_by_slab")
        host_s = setup_s["partition_by_slab"]
        del pts
        pos = torch.as_tensor(parts, dtype=torch.float32, device=dev)
        del parts
        needed, H = slab_halo(pos, CUTOFF, dev)
        bins, pos_s = bin_and_sort(pos, CUTOFF, auto_order=True)
        skeys, strides = bins.sorted_keys, bins.info.strides
        del bins
        slabs = slab_blocks(pos, CUTOFF, H, dev, tile=use_tile, right=True)
        maxj = slab_maxj(slabs, full=False) if use_tile else None
        maxj_f = slab_maxj(slabs, full=True) if use_tile else None
        done("halo_blocks_windows")
        path = dict(use_tile=True, MAXJ=maxj) if use_tile else dict(use_pallas=True, L=L_MAIN)
        kern = "tile" if use_tile else "lag"
        energy_k, hist_k, forces_k = f"{kern}_reduce", f"{kern}_hist", f"{kern}_forces"
        csq = torch.tensor(CUTOFF, dtype=torch.float32) ** 2
        cell = dict(n=n, shards=D, n_local=n_local, halo_needed=needed, H=H,
                    partition_host_s=host_s, MAXJ=maxj, MAXJ_F=maxj_f, setup_s=setup_s,
                    calls={})
        launches = {}

        def call(name, fn, expect, instance=None, reps=SLAB_REPS, profile=True):
            r = timed_call(fn, reps, expect)
            res = r.pop("out")
            if instance is not None:
                key = energy_k if instance.startswith(kern + "_reduce") else hist_k
                launches[instance] = launches.get(instance, 0) + r["launches"][key + "_islot"]
            if profile:
                prof = profile_steps(fn, 3)
                r.update(device_busy_share=prof["device_busy_share"],
                         device_ops_per_call=prof["device_ops_per_step"])
            cell["calls"][name] = r
            return res

        islot = {energy_k: D, energy_k + "_islot": D}
        # the energy, against the single-device call on the same points
        efn = sharded_lj_energy(mesh, cutoff=CUTOFF, H=H, **path)
        e, ok = call("sharded_lj_energy", lambda i: efn(pos), islot, f"{energy_k}_islot")
        if use_tile:
            e1, ok1 = tile_pair_reduce(pos_s, skeys, strides, csq, MAXJ=maxj)
        else:
            e1, ok1 = pair_lag_reduce(pos_s, skeys, strides, csq, L=L_MAIN), True
        check(bool(ok1), f"single-device coverage ({box})")
        e_err = rel(float(e), float(e1))
        check(np.isfinite(float(e)) and e_err <= TOL_SLAB,
              f"sharded energy {float(e)} vs single-device {float(e1)} ({box})")
        # one shard: the single-device call on the same (stable) sort
        e_one, ok = sharded_lj_energy(one, cutoff=CUTOFF, H=H, **path)(pos)
        check(bool(ok) and float(e_one) == float(e1),
              f"one shard {float(e_one)} vs single device {float(e1)} ({box})")
        cell.update(energy=float(e), single_device_energy=float(e1), energy_rel_err=e_err)
        # the histograms, against the single-device ones (f32 and f64)
        hkw = dict(MAXJ=maxj) if use_tile else dict(L=L_MAIN)
        hexp = {hist_k: D, hist_k + "_islot": D}
        for tag, x, xs in (("f32", pos, pos_s), ("f64", pos.double(), pos_s.double())):
            hfn = sharded_pair_hist(mesh, edges, H=H, use_tile=use_tile, **hkw)
            h, ok = call(f"sharded_pair_hist_{tag}", lambda i, x=x: hfn(x), hexp,
                         f"{hist_k}_islot_{tag}", profile=tag == "f32")
            if use_tile:
                h1, ok1 = tile_pair_hist(xs, skeys, strides, esq, MAXJ=maxj)
            else:
                h1, ok1 = pair_lag_hist(xs, skeys, strides, esq, L=L_MAIN), True
            h, h1 = combine_count_vec(h), combine_count_vec(h1)
            check(bool(ok1) and np.array_equal(h, h1),
                  f"sharded histogram != single device ({box} {tag}): "
                  f"{int(np.abs(h - h1).max())}")
            cell[f"pairs_{tag}"] = int(h[-1])
        check(cell["pairs_f32"] > 0, f"no pair counted ({box})")
        # the species column (lennard_jones_mixed) as the payload
        spec = species_plane(pos.shape[0], np.random.default_rng(3), dev, odd=False)
        with_spec = torch.cat([pos, spec[:, None]], 1)
        sfn = sharded_lj_energy(mesh, cutoff=CUTOFF, H=H, n_payload=1, term=mixed.term, **path)
        es, ok = call("sharded_lj_energy_species", lambda i: sfn(with_spec), islot,
                      f"{energy_k}_islot_species", profile=False)
        sb, ss = bin_and_sort(with_spec, CUTOFF, auto_order=True)
        sp = ss[:, 3].contiguous()
        if use_tile:
            es1, _ = tile_pair_reduce(ss[:, :3].contiguous(), sb.sorted_keys, strides, csq,
                                      None, sp, MAXJ=maxj, term=mixed.term)
        else:
            es1 = pair_lag_reduce(ss[:, :3].contiguous(), sb.sorted_keys, strides, csq, None,
                                  sp[:, None], L=L_MAIN, term=mixed.term)
        del with_spec, sb, ss
        check(rel(float(es), float(es1)) <= TOL_SLAB,
              f"sharded species energy {float(es)} vs {float(es1)} ({box})")
        cell["species_energy_rel_err"] = rel(float(es), float(es1))
        # the potential's value and gradient, against the single-device one
        grad_exp = {energy_k: D, energy_k + "_islot": D, forces_k: D}
        tkw = dict(path="tile", MAXJ=maxj, MAXJ_F=max(probe_maxj(skeys, strides, full=True)) + 1
                   ) if use_tile else dict(L=L_MAIN)
        for tname, term in (("lj", None), ("table", table.term)):
            pot = make_sharded_potential(mesh, cutoff=CUTOFF, H=H, term=term,
                                         MAXJ_F=maxj_f, **path)
            vg = value_and_grad_fn(pot, pos)
            e, g, ok = call(f"make_sharded_potential_{tname}",
                            lambda i, vg=vg: (lambda r: (r[0], r[2], r[1]))(vg()), grad_exp,
                            f"{energy_k}_islot" + ("" if tname == "lj" else "_table"))
            single = make_pair_potential(CUTOFF, term=term or lj_term, **tkw)
            e1, ok1, g1 = value_and_grad_fn(single, pos)()
            check(bool(ok1), f"single-device potential coverage ({box} {tname})")
            g_err = float((g - g1).abs().max()) / float(g1.abs().max())
            check(rel(float(e), float(e1)) <= TOL_SLAB and g_err <= TOL_SLAB_GRAD,
                  f"sharded potential {tname} ({box}): energy {float(e)} vs {float(e1)}, "
                  f"gradient off by {g_err}")
            cell[f"potential_{tname}"] = dict(energy_rel_err=rel(float(e), float(e1)),
                                              grad_err_of_max=g_err)
            del g, g1
        done("calls")
        # the MD step on the protocol's lattice start state of this box
        rng = np.random.default_rng(0)
        mbox = (side, side, side) if use_tile else lj_box(n, CUTOFF)
        mparts, _ = partition_by_slab(lattice_cloud(n, mbox, rng), CUTOFF, D)
        mpos = torch.as_tensor(mparts, dtype=torch.float32, device=dev)
        mvel = torch.as_tensor(rng.normal(0, 0.3, mparts.shape), dtype=torch.float32,
                               device=dev)
        del mparts
        mneeded, mH = slab_halo(mpos, CUTOFF, dev)
        if use_tile:
            msb = slab_blocks(mpos, CUTOFF, mH, dev, tile=True, right=True)
            mkw = dict(use_tile=True, MAXJ=slab_maxj(msb, full=True))
            del msb
        else:
            mkw = dict(use_pallas=True, L=L_MAIN)
        done("md_setup")
        step = sharded_md_step(mesh, cutoff=CUTOFF, H=mH, dt=MD_DT, **mkw)
        reset_launches()
        mpos, mvel, e, ok = step(mpos, mvel)
        check(bool(ok), f"sharded MD warm-up coverage ({box})")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flags, t_host = [], time.perf_counter()
        start.record()
        for _ in range(SLAB_STEPS):
            mpos, mvel, e, ok = step(mpos, mvel)
            flags.append(ok)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / SLAB_STEPS
        check(all(bool(f) for f in flags) and np.isfinite(float(e)),
              f"sharded MD coverage or energy ({box})")
        per_step = {forces_k: D, energy_k: D, energy_k + "_islot": D}
        md_launches = window_launches(per_step, SLAB_STEPS + 1)
        launches[f"{energy_k}_islot"] += md_launches[energy_k + "_islot"]
        prof = profile_steps(lambda i: step(mpos, mvel), 3)
        cell["calls"]["sharded_md_step"] = dict(
            step_ms=start.elapsed_time(end) / SLAB_STEPS, host_step_ms=host_ms,
            steps=SLAB_STEPS, halo_needed=mneeded, H=mH, launches=md_launches,
            energy=float(e), device_busy_share=prof["device_busy_share"],
            device_ops_per_step=prof["device_ops_per_step"], MAXJ=mkw.get("MAXJ"))
        del mpos, mvel, step
        done("md")
        # each min_islot instance alone on shard 1's block
        terms = {"lj": (lj_term, False), "table": (table.term, False),
                 "species": (mixed.term, True)}
        plain_sb = slab_blocks(partition_by_slab(cube_points(N_PARITY)[0], CUTOFF, D)[0],
                               CUTOFF, H, dev, tile=True) if use_tile else None
        cell["alone"] = slab_alone(dev, slabs, CUTOFF, use_tile, maxj, terms, plain_sb)
        done("alone")
        cell["launches"] = launches
        rows[box] = (cell["alone"], launches)
        out[box] = cell
        del pos, pos_s, skeys, slabs, plain_sb
    return dict(n=n, shards=D, cells=out, rows=rows)


def slab_rows(svp, smp) -> list:
    """The kernels line's rows of the min_islot instances of K1, K5, K6 and
    K9: ms, plain ms and bound alone on a shard's block at n = 1e7
    (`slab_alone`), launches on the slab main path (`slab_main_path`'s
    calls), max_abs_err from `slab_vs_plain` (the lattice's absolute
    error, or the table and species terms' error over the sum of |term|;
    the histograms' largest count difference)."""
    out = []
    for box, src, kernel, replaces in (
            ("thin", "lag_reduce", "K1", "zelll_tpu/ops/pallas_pairs.py:1001 (min_islot, :925)"),
            ("cube", "tile_reduce", "K6", "zelll_tpu/ops/tile_pairs.py:1451 (min_islot)")):
        alone, launches = smp["rows"][box]
        for inst, tag, what in (("lj", "", "LJ"), ("table", "_table", "term table"),
                                ("species", "_species", "species term")):
            r = alone[inst]
            out.append(dict(
                name=f"{src}_islot{tag}", route="cuda",
                source=f"zelll_tpu_torch/csrc/{src}.cu", replaces=replaces,
                instance=f"min_islot (slab ownership), {what}, open f32",
                launches=launches.get(f"{src}_islot{tag}", 0),
                max_abs_err=svp["max_err"][f"{kernel}{tag}"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                share_of_bound=r["share_of_bound"],
                pruned_evaluations_per_candidate=alone["pruned_evaluations_per_candidate"],
                library_ms=None))
    for box, src, kernel, replaces in (
            ("thin", "lag_hist", "K5", "zelll_tpu/ops/pallas_pairs.py:1529 (min_islot)"),
            ("cube", "tile_hist", "K9", "zelll_tpu/ops/tile_pairs.py:654 (min_islot)")):
        alone, launches = smp["rows"][box]
        for tag in ("f32", "f64"):
            r = alone[f"hist_{tag}"]
            out.append(dict(
                name=f"{src}_islot" + ("" if tag == "f32" else "_f64"), route="cuda",
                source=f"zelll_tpu_torch/csrc/{src}.cu", replaces=replaces,
                instance=f"min_islot (slab ownership), no mask, open {tag}, K = {HIST_K}",
                launches=launches.get(f"{src}_islot_{tag}", 0),
                max_abs_err=svp["max_err"][f"{kernel}_{tag}"], ms=r["ms"],
                plain_ms=r["plain_ms"], plain_rows=r["plain_rows"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"],
                share_of_bound=r["share_of_bound"],
                pruned_evaluations_per_candidate=alone["pruned_evaluations_per_candidate"],
                library_ms=None))
    for row in out:
        check(row["launches"] > 0, f"the slab main path never launched {row['name']}")
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
    # the parity phases at half N_PARITY (5e5), every check kept, for the
    # script's time
    emit("obs_parity", **obs_parity(dev, N_PARITY // 2))
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
    emit("pbc_parity", **pbc_parity(dev, N_PARITY // 2))
    pa = pbc_alone(dev, N_MAIN)
    emit("pbc_alone", **pa)

    # -- 20. pair potentials and species (the term table in K1, K3, K6, K7) -----
    spm = species_main_path(dev, N_MAIN)
    emit("species_main_path", **spm)
    pmp = potentials_main_path(dev, N_MAIN)
    emit("potentials_main_path", **pmp)
    # at N_CHECK (2e5) rather than 1e6, for the script's time
    pvp = potentials_vs_plain(dev, N_CHECK)
    emit("potentials_vs_plain", **pvp)
    emit("species_pbc", **species_pbc(dev, N_PARITY // 2))

    # -- 21. periodic observables (K4 and K5 keep mask and minimum image, K8 and
    # K9 keep mask) and the barostat ------------------------------------------
    pov = pbc_obs_vs_plain(dev, N_CHECK)
    emit("pbc_obs_vs_plain", **pov)
    pom = pbc_obs_main_path(dev, N_MAIN)
    emit("pbc_obs_main_path", **pom)
    emit("npt_main_path", **npt_main_path(dev, N_MAIN))
    emit("pbc_obs_parity", **pbc_obs_parity(dev, N_PARITY // 2))

    # -- 22. differentiable potentials (K1 + K3, K6 + K7) and the term table in
    # K2, K4 and K8 -----------------------------------------------------------
    emit("autodiff_main_path", **autodiff_main_path(dev, N_MAIN))
    emit("autodiff_parity", **autodiff_parity(dev, N_PARITY))
    tov = table_obs_vs_plain(dev, N_CHECK)
    emit("table_obs_vs_plain", **tov)
    foc = factory_obs_main_path(dev, N_PARITY)
    emit("factory_obs_main_path", **foc)
    toa = table_obs_alone(dev, N_MAIN)
    emit("table_obs_alone", **toa)

    # -- 23. the slab decomposition on SLAB_SHARDS shards of the card, with the
    # min_islot instances of K1, K5, K6 and K9 -----------------------------------
    svp = slab_vs_plain(dev, N_CHECK // 8)
    emit("slab_vs_plain", **svp)
    smp = slab_main_path(dev, N_MAIN)
    emit("slab_main_path", **{k: v for k, v in smp.items() if k != "rows"})

    # -- 24. every ported kernel ---------------------------------------------------
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
        ("lag_hist", "zelll_tpu/ops/pallas_pairs.py:1314", ha["K5_f32"],
         ov["max_count_diff"]["K5"]),
        ("tile_stress", "zelll_tpu/ops/tile_pairs.py:735", sa["K8_f32"],
         ov["lattice_max_abs_err"]["K8"]),
        ("tile_hist", "zelll_tpu/ops/tile_pairs.py:453", ha["K9_f32"],
         ov["max_count_diff"]["K9"]),
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
    )), *({
        "name": name,
        "route": "cuda",
        "source": f"zelll_tpu_torch/csrc/{src}.cu",
        "replaces": replaces,
        "instance": instance,
        "launches": sum(pom["calls"][c]["launches"].get(src, 0) for c in cells),
        "max_abs_err": pov["max_abs_err"][f"{row}_f32"],
        "ms": (sa if src.endswith("stress") else ha)[row]["f32"]["ms"],
        "plain_ms": (sa if src.endswith("stress") else ha)[row]["f32"]["plain_ms"],
        "plain_n": (sa if src.endswith("stress") else ha)[row]["f32"]["plain_n"],
        "bound_ms": (sa if src.endswith("stress") else ha)[row]["f32"]["bound_ms"],
        "bound_by": (sa if src.endswith("stress") else ha)[row]["f32"]["bound_by"],
        "share_of_bound": (sa if src.endswith("stress") else ha)[row]["f32"]["share_of_bound"],
        "library_ms": None,
    } for name, src, kernel, row, cells, replaces, instance in (
        ("lag_stress_keep_minimage", "lag_stress", "K4", "K4_keep_minimage",
         ("thin_stress_minimage_f32", "thin_stress_minimage_split"),
         "zelll_tpu/ops/pallas_pairs.py:1018 (sorted_payload, pair_mask; mi_box, key_reach)",
         "keep mask and minimum image, thin box minimage='auto', f32"),
        ("lag_stress_keep", "lag_stress", "K4", "K4_keep", ("thin_stress_ghosts_f32",),
         "zelll_tpu/ops/pallas_pairs.py:1018 (sorted_payload, pair_mask)",
         "periodic keep mask, thin box with ghost images, f32"),
        ("lag_hist_keep_minimage", "lag_hist", "K5", "K5_keep_minimage",
         ("thin_rdf_minimage",),
         "zelll_tpu/ops/pallas_pairs.py:1314 (sorted_payload, pair_mask; mi_box, key_reach)",
         "keep mask and minimum image, thin box minimage='auto', K = 32, f32"),
        ("lag_hist_keep_species_minimage", "lag_hist", "K5", "K5_keep_species_minimage",
         ("thin_rdf_minimage_species",),
         "zelll_tpu/ops/pallas_pairs.py:1314 (two payload planes; mi_box, key_reach)",
         "keep mask composed with the species mask (mask id 3), minimum image, f32"),
        ("tile_stress_keep", "tile_stress", "K8", "K8_keep", ("cube_stress",),
         "zelll_tpu/ops/tile_pairs.py:735 (payload row, pair_mask)",
         "periodic keep mask over the payload row, cube with ghost images, f32"),
        ("tile_hist_keep", "tile_hist", "K9", "K9_keep", ("cube_rdf",),
         "zelll_tpu/ops/tile_pairs.py:453 (payload row, pair_mask)",
         "periodic keep mask over the payload row, cube with ghost images, K = 32, f32"),
    )), *table_rows(spm, pmp), *obs_table_rows(tov, foc, toa),
        *slab_rows(svp, smp)]}), flush=True)

    # -- 25. the card, then the contract line -----------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
