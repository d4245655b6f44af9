#!/usr/bin/env python3
"""Checks of the port's kernels on one CUDA card.

Run from the root of a checkout, on the machine with the card:

    python3 chip_compare.py sass TREE
        K1, K3, K6 and K7 built to cubins from this checkout and from TREE
        (an earlier commit unpacked by `git archive <commit> | tar -x -C
        archive/parent` into the git-ignored archive/) with ops/_build.py's
        flags: per kernel function, its registers in both and whether the
        SASS is the same (addresses, encodings and branch labels set
        aside). A change to the shared header cluster_sweep.cuh must leave
        them as they are.
    python3 chip_compare.py mutations
        each mutation of MUTATIONS applied to a copy of the package and the
        tests under $TMPDIR/mut/<name>, and its kernel's card test run
        there; the unbroken copy first. A mutation must fail its test.

It prints one JSON line per result and exits non-zero if a check fails.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "zelll_tpu_torch" / "csrc"

# name: (kernel test -k expression, [(file in csrc/, text, replacement)])
MUTATIONS = {
    "k9_split_margin": ("tile_hist", [
        ("cluster_sweep.cuh", "constexpr float kSplitMargin = 1.0f + 0x1p-19f;",
         "constexpr float kSplitMargin = 1.0f;"),
        ("cluster_sweep.cuh", "  if (SPLIT) g = fmaxf(g - (lomax + fabsf(bl)), 0.0f);\n", "")]),
    "k9_skip_cluster": ("tile_hist", [
        ("tile_hist.cu", "keep[k] = keep[k] && prune.near(b[k], b_lo[k]);",
         "keep[k] = keep[k] && k < kClusters - 1 && prune.near(b[k], b_lo[k]);")]),
    "k9_triangle_le": ("tile_hist", [
        ("tile_hist.cu", "o.span = real ? static_cast<unsigned>(i) + 1u : 0u;",
         "o.span = real ? static_cast<unsigned>(i) + 2u : 0u;")]),
    "k9_bin_le": ("tile_hist", [
        ("tile_hist.cu", "if (dsq < edges[mid])", "if (dsq <= edges[mid])")]),
    "k9_species_dropped": ("tile_hist", [
        ("tile_hist.cu", "if (MASK) m = m && species_pair(o.w, bp[q], sa.ma, sa.mb);", "")]),
    "k12_prune_lt": ("join", [
        ("join_reduce.cu", "near_box_of<true>(box, b.x, b.y, b.z, csq)",
         "near_box_of<false>(box, b.x, b.y, b.z, csq)")]),
    "k12_last_band_short": ("join", [
        ("join_reduce.cu", "const int je = __shfl_sync(kAll, end, 2 * s + 1);",
         "const int je = __shfl_sync(kAll, end, 2 * s + 1) - (s == a.S - 1);")]),
    "k12_box_last_lane": ("join", [
        ("join_reduce.cu", "cluster_box_of(o.x, o.y, o.z, o.real)",
         "cluster_box_of(o.x, o.y, o.z, o.real && lane != kWarp - 1)")]),
    "k12_band_dropped": ("join", [
        ("join_reduce.cu", "o.real && diff >= band_lo && diff <= band_hi && dsq <= csq",
         "o.real && dsq <= csq")]),
}


def emit(kind: str, **fields) -> None:
    print(json.dumps({"result": kind, **fields}, default=str), flush=True)


def edited_copy(files: list, dest: Path) -> None:
    """csrc/ copied to ``dest`` with each (file, text, replacement) of a
    mutation applied once; raises if a text is not found exactly once."""
    shutil.copytree(CSRC, dest, dirs_exist_ok=True)
    for name, old, new in files:
        path = dest / name
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: the text to replace occurs {text.count(old)} times")
        path.write_text(text.replace(old, new))


_SASS_NOISE = (re.compile(r"/\*[0-9a-f]{4,}\*/"), re.compile(r"/\* 0x[0-9a-f]+ \*/"),
               re.compile(r"\.L_x_\d+"), re.compile(r"0x[0-9a-f]+"))
# an anonymous namespace's mangled name carries hashes of the file's path
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def _unhashed(name: str) -> str:
    return _ANON.sub("_GLOBAL__N_", name)


def _sass_by_function(cubin: Path) -> dict:
    out = subprocess.run(["cuobjdump", "-sass", str(cubin)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _unhashed(m.group(1))
            funcs[name] = []
            continue
        if name is not None and line.strip():
            line = _unhashed(line)
            for pat in _SASS_NOISE:
                line = pat.sub("", line)
            funcs[name].append(" ".join(line.split()))
    return funcs


def _registers(cubin: Path) -> dict:
    out = subprocess.run(["cuobjdump", "-res-usage", str(cubin)], capture_output=True,
                         text=True, check=True).stdout
    regs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = _unhashed(m.group(1))
        m = re.search(r"REG:(\d+)", line)
        if m and name is not None:
            regs[name] = int(m.group(1))
    return regs


def sass(tree: str) -> None:
    from zelll_tpu_torch.ops._build import NVCC_FLAGS, nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    other = Path(tree).resolve() / "zelll_tpu_torch" / "csrc"
    tmp = Path(tempfile.mkdtemp(prefix="sass-", dir=ROOT / "build"))
    jobs = {}
    with ThreadPoolExecutor(8) as pool:
        for kernel in ("lag_reduce", "lag_forces", "tile_reduce", "tile_forces"):
            for side, csrc in (("this", CSRC), ("other", other)):
                out = tmp / f"{kernel}-{side}.cubin"
                jobs[kernel, side] = (out, pool.submit(subprocess.run, [
                    nvcc(), *flags, "-cubin", "-o", str(out), str(csrc / f"{kernel}.cu")],
                    capture_output=True, text=True, check=True))
        for _, fut in jobs.values():
            fut.result()
    ok = True
    for kernel in ("lag_reduce", "lag_forces", "tile_reduce", "tile_forces"):
        mine, theirs = jobs[kernel, "this"][0], jobs[kernel, "other"][0]
        fa, fb = _sass_by_function(mine), _sass_by_function(theirs)
        ra, rb = _registers(mine), _registers(theirs)
        same_regs = ra == rb
        ok = ok and same_regs and set(fa) == set(fb)
        emit("sass", kernel=kernel, functions=len(fa), registers_equal=same_regs,
             sass_equal=sum(fa[f] == fb.get(f) for f in fa),
             registers={f: [ra.get(f), rb.get(f)] for f in sorted(set(ra) | set(rb))})
    if not ok:
        raise SystemExit("registers or functions differ")


def mutations() -> None:
    base = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / "mut"
    shutil.rmtree(base, ignore_errors=True)
    names = ["unbroken", *MUTATIONS]

    def prepare(name):
        dest = base / name
        shutil.copytree(ROOT / "zelll_tpu_torch", dest / "zelll_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copytree(ROOT / "tests", dest / "tests",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "pyproject.toml", dest)
        if name != "unbroken":
            edited_copy(MUTATIONS[name][1], dest / "zelll_tpu_torch" / "csrc")
        # build the copy's kernels before the card is needed
        return subprocess.run(
            [sys.executable, "-c", "from zelll_tpu_torch.ops import join, tile_pairs; "
             "tile_pairs.load_hist_kernel(); join.load_kernel()"],
            cwd=dest, capture_output=True, text=True).returncode

    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(names, pool.map(prepare, names)))
    ok = True
    for name in names:
        select = "tile_hist or join" if name == "unbroken" else MUTATIONS[name][0]
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/test_torch_kernels.py", "--noconftest",
             "-o", "addopts=", "-q", "-p", "no:cacheprovider", "-k", select],
            cwd=base / name, capture_output=True, text=True)
        summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        want_pass = name == "unbroken"
        good = (proc.returncode == 0) == want_pass
        ok = ok and good and built[name] == 0
        emit("mutation", name=name, tests=select, built=built[name] == 0,
             returncode=proc.returncode, summary=summary, as_expected=good)
    if not ok:
        raise SystemExit("a mutation passed its card test, or the unbroken copy failed")


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in ("sass", "mutations"):
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    if sys.argv[1] == "sass":
        sass(sys.argv[2])
    else:
        mutations()


if __name__ == "__main__":
    main()
