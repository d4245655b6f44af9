#!/usr/bin/env python3
"""Drive the zelll_tpu_torch port on one CUDA card, and check it.

Run from the root of a checkout, on a machine with one CUDA card, ``nvcc``
(on PATH, under CUDA_HOME, or in /usr/local/cuda) and ``g++``:

    python3 chip_smoke.py

It builds every kernel from the sources in the checkout, holds each against
its plain PyTorch version on the card, drives the benchmark's main path at
n = 1e7 (a full rebuild per step: keys -> sort -> fused LJ energy), checks
the f64-grade energy and the pair count against the exact-f64 oracle at
n = 1e6, and prints one JSON line per phase. Any failed phase exits
non-zero. The last line is the contract line
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit as nvidia-smi reports them.

Bounds (``bound_ms``) are taken against the published H100 SXM peaks:
3.35 TB/s of device memory and 67 TFLOP/s f32 outside the tensor cores.
That rate counts an FMA as two operations, so the operations bound counts
the FP32 instructions the function needs (with FMA contraction, which K1
itself gives up) at half of it.

K1 is held to its plain version on the benchmark's uniform cloud, whose LJ
total is carried by a few nearly coincident pairs, and on a jittered
lattice with a minimum separation, whose pair terms are all of similar
size, so that a wrong term or a lost partial shows. Both sides sum the same
f32 terms in f64 and differ only in the order of the sums: their f64
totals (``out_dtype=torch.float64``) must agree to 1e-10, and the pair
counts exactly.
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
STEPS = 10
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
TOL_REL = 1e-6  # against the exact-f64 oracle
TOL_KERNEL = 1e-10  # K1 against its plain version, f64 totals


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


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    sys.path.insert(0, ROOT)
    from zelll_tpu_torch import oracle
    from zelll_tpu_torch.core import (
        GridInfo, aabb_from_positions, compute_keys, key_window, sort_by_key,
    )
    from zelll_tpu_torch.ops import lag_pairs
    from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
    from zelll_tpu_torch.ops.lag_pairs import (
        combine_count, count_term, lag_coverage_ok, pair_lag_reduce,
        pair_lag_reduce_plain, split_f64,
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
    with ThreadPoolExecutor(2) as pool:
        kernel = pool.submit(lag_pairs.load_kernel)
        have_oracle = pool.submit(oracle.available)
        kernel.result()
        check(have_oracle.result(), "the oracle did not build")
    ptxas = [ln.strip() for ln in lag_pairs.load_kernel.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, lag_reduce_ptxas=ptxas)

    def sorted_inputs(pts64: np.ndarray):
        """The main path's own keys, sort and gather, on the card."""
        hi, lo = split_f64(torch.as_tensor(pts64, device=dev))
        info = GridInfo.create(aabb_from_positions(hi), CUTOFF, auto_order=True)
        keys, _, shi, slo = sort_by_key(compute_keys(hi, info), hi, lo)
        return hi, lo, shi, slo, keys, info.strides

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
    _, _, shi, slo, keys, strides = sorted_inputs(pts)
    cases = {f"L{L}": kernel_vs_plain(shi, slo, keys, strides, L)
             for L in (L_MAIN, 32)}
    check(cases[f"L{L_MAIN}"]["ok"] and not cases["L32"]["ok"],
          "expected coverage at L=256 and none at L=32")
    padded = keys.clone()
    padded[-1000:] = 2**31 - 1  # SENTINEL_KEY rows
    cases["sentinel_tail"] = kernel_vs_plain(shi, slo, padded, strides, L_MAIN)
    _, _, shi, slo, keys, strides = sorted_inputs(
        generate_points_lattice(N_CHECK, lj_box(N_CHECK, CUTOFF)))
    cases["lattice"] = kernel_vs_plain(shi, slo, keys, strides, L_MAIN)
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
         lag_reduce_launches=launches, max_memory_allocated=peak_bytes)

    # where a split step's device time goes, by kernel, and the busy share
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for i in range(3):
            fused_lj_rebuild_energy(hi + (i % 2) * 1e-6, CUTOFF, lo, L=L_MAIN)
        end.record()
        end.synchronize()
    by_kernel = sorted(((e.self_device_time_total / 3e3, e.key[:90])
                        for e in prof.key_averages() if e.self_device_time_total > 0),
                       reverse=True)
    busy_ms = sum(ms for ms, _ in by_kernel)
    wall_ms = start.elapsed_time(end) / 3
    emit("profile", mode="split", step_ms=wall_ms,
         device_busy_share=busy_ms / wall_ms if busy_ms else "not measured",
         ms_per_step_by_kernel=[[round(ms, 4), k] for ms, k in by_kernel[:12]])

    # K1 alone at the main path's shapes, its bound, the sort, the plain version
    hi_s, lo_s, shi, slo, keys, strides = sorted_inputs(pts)
    del hi_s, lo_s
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
        npairs = main[tag]["pairs"]
        n_bytes = N_MAIN * 4 * ((6 if split else 3) + 1)
        ops = candidates * INSTR_PER_CANDIDATE[split] + npairs * INSTR_PER_PAIR
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_INSTR_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        k1[tag] = dict(ms=ms, plain_ms=plain_ms, keys_sort_ms=keys_sort_ms, bound_ms=bound,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=n_bytes, fp32_instructions=ops, share_of_bound=bound / ms,
                       step_ms=main[tag]["step_ms"])
    compare = {"uniform": kernel_vs_plain(shi, slo, keys, strides, L_MAIN)}
    del shi, slo, keys
    _, _, shi, slo, keys, strides = sorted_inputs(
        generate_points_lattice(N_MAIN, lj_box(N_MAIN, CUTOFF)))
    compare["lattice"] = kernel_vs_plain(shi, slo, keys, strides, L_MAIN)
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

    # -- 6. every ported kernel -------------------------------------------------
    split_k1 = k1["split"]
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
    }]}), flush=True)

    # -- 7. the card, then the contract line ------------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
