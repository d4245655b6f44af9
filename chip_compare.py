#!/usr/bin/env python3
"""Checks of the port's kernels on one CUDA card.

Run from the root of a checkout, on the machine with the card:

    python3 chip_compare.py sass TREE [ALLOW]
        K1-K9 and K12 built to cubins from this checkout and from TREE
        (an earlier commit unpacked by `git archive <commit> | tar -x -C
        archive/parent` into the git-ignored archive/) with ops/_build.py's
        flags: per kernel function the two trees share, its registers in
        both and whether the SASS is the same (addresses, encodings and
        branch labels set aside), and the functions only this tree has (new
        instances). A change to the shared header cluster_sweep.cuh must
        leave the shared functions' SASS and registers as they are and lose
        none; ALLOW (optional, a regular expression over the mangled
        names) names the functions a change may move or replace (a
        redesigned kernel's old instances), which are listed.
    python3 chip_compare.py mutations
        each mutation of MUTATIONS applied to a copy of the package and the
        tests under $TMPDIR/mut/<name>, and its kernel's card test run
        there; the unbroken copy first, with every test. A mutation must
        fail its test.
    python3 chip_compare.py timing TREE [PHASE ...]
        this checkout's chip_smoke.stress_alone, hist_alone and
        per_particle_alone (K4, K8, K5, K9 and K2 alone at its N_MAIN), or
        the chip_smoke phases named (api_* at N_PARITY, the rest at
        N_MAIN; e.g. observables_main_path api_main_path), run on TREE's
        package and on this one's, in the order TREE, this, this, TREE,
        each in a process of its own: one timing code for both packages, so
        two versions of a kernel compare through the same function in one
        call.

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
        ("cluster_sweep.cuh", "  float g = fmaxf(fmaxf(mn - b, b - mx), 0.0f);\n"
         "  if (SPLIT) g = fmaxf(g - (lomax + fabsf(bl)), 0.0f);\n",
         "  float g = fmaxf(fmaxf(mn - b, b - mx), 0.0f);\n")]),
    "k9_skip_cluster": ("tile_hist", [
        ("cluster_sweep.cuh", "keep[k] = keep[k] && prune.near(b[k], b_lo[k]);",
         "keep[k] = keep[k] && k < CLUSTERS - 1 && prune.near(b[k], b_lo[k]);")]),
    "k9_triangle_le": ("tile_hist", [
        ("tile_hist.cu", "o.span = own ? static_cast<unsigned>(i) + 1u : 0u;",
         "o.span = own ? static_cast<unsigned>(i) + 2u : 0u;")]),
    "k9_bin_le": ("tile_hist", [
        ("cluster_sweep.cuh", "if (dsq < edges[mid])", "if (dsq <= edges[mid])")]),
    "k9_species_dropped": ("tile_hist", [
        ("tile_hist.cu",
         "if (RULE == kMaskSpecies) m = m && species_pair(o.w, bp[q], sa.ma, sa.mb);", "")]),
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
    # the periodic instances: K1 and K3's minimum image, K1 and K6's keep mask
    "mi_prune_images_dropped": ("pbc_lag_reduce or pbc_lag_forces", [
        ("cluster_sweep.cuh",
         "    g = fminf(g, fmaxf(fmaxf(mn - up, up - mx), 0.0f));\n"
         "    g = fminf(g, fmaxf(fmaxf(mn - dn, dn - mx), 0.0f));\n", "")]),
    "mi_fold_sign_inverted": ("pbc_lag_reduce or pbc_lag_forces", [
        ("cluster_sweep.cuh", "shift = s > half ? bx : (s < -half ? -bx : 0.0f);",
         "shift = s > half ? -bx : (s < -half ? bx : 0.0f);")]),
    "mi_split_carry_dropped": ("pbc_lag_reduce or pbc_lag_forces", [
        ("cluster_sweep.cuh", "d = d + ((e + (li - lj)) - shift_lo);",
         "d = d + ((li - lj) - shift_lo);")]),
    # split mode's fold by the f32 box alone (the JAX package's)
    "mi_fold_box_lo_dropped": ("pbc_lag_reduce or pbc_lag_forces", [
        ("cluster_sweep.cuh", "d = d + ((e + (li - lj)) - shift_lo);",
         "d = d + (e + (li - lj));")]),
    "keep_sum_gt": ("pbc_lag_reduce or pbc_tile_reduce", [
        ("cluster_sweep.cuh", "return wi * wj == 0.0f && wi + wj >= 0.0f;",
         "return wi * wj == 0.0f && wi + wj > 0.0f;")]),
    "k6_payload_own_slot": ("pbc_tile_reduce", [
        ("tile_reduce.cu", "wj[k] = PLANE && keep[k] ? a.w[j] : 0.0f;",
         "wj[k] = PLANE && keep[k] ? o.pw : 0.0f;")]),
    # the lag histogram K5: the lag bound one short, an edge counted in its
    # own bin, the species mask dropped, the walk's last step skipped
    "k5_jlo_off_by_one": ("lag_hist", [
        ("lag_hist.cu", "    jlo = l;\n", "    jlo = l + 1;\n")]),
    "k5_bin_le": ("lag_hist", [
        ("cluster_sweep.cuh", "if (dsq < edges[mid])", "if (dsq <= edges[mid])")]),
    "k5_species_dropped": ("lag_hist", [
        ("lag_hist.cu", "if (MASK) m = m && species_pair(o.w, bp[q], sa.ma, sa.mb);", "")]),
    "k5_skip_cluster": ("lag_hist", [
        ("cluster_sweep.cuh", "const bool keep = valid && prune.near(b, b_lo);",
         "const bool keep = valid && j0 + kWarp <= last && prune.near(b, b_lo);")]),
    # the tile stress K8: coincident pairs kept, the triangle as j <= i + 1
    # (j == i alone is dsq = 0, which K8 excludes), the last cluster of each
    # j-chunk skipped
    "k8_dsq_positive_dropped": ("tile_stress", [
        ("stress_sweep.cuh", "dsq < csq &&\n             dsq > T(0);", "dsq < csq;")]),
    "k8_triangle_le": ("tile_stress", [
        ("tile_stress.cu", "o.span = real ? static_cast<unsigned>(i) + 1u : 0u;",
         "o.span = real ? static_cast<unsigned>(i) + 3u : 0u;")]),
    "k8_skip_cluster": ("tile_stress", [
        ("cluster_sweep.cuh", "keep[k] = keep[k] && prune.near(b[k], b_lo[k]);",
         "keep[k] = keep[k] && k < CLUSTERS - 1 && prune.near(b[k], b_lo[k]);")]),
    # the lag stress K4: coincident pairs kept (the shared sweep's test), the
    # range past the own slot (as j <= i alone it adds only the self pair,
    # which 0 < dsq excludes, so the mutation takes j <= i + 1), the first
    # partner of each lane dropped
    "k4_dsq_positive_dropped": ("lag_stress", [
        ("stress_sweep.cuh", "dsq < csq &&\n             dsq > T(0);", "dsq < csq;")]),
    "k4_range_past_own": ("lag_stress", [
        ("lag_stress.cu", "o.span = real ? static_cast<unsigned>(i - jlo) : 0u;",
         "o.span = real ? static_cast<unsigned>(i - jlo) + 2u : 0u;")]),
    "k4_jlo_off_by_one": ("lag_stress", [
        ("lag_stress.cu", "    jlo = l;\n", "    jlo = l + 1;\n")]),
    # the per-particle sum K2: the range ahead one short, the box without its
    # last lane, the own slot counted (dsq > 0 dropped)
    "k2_jhi_short": ("per_particle", [
        ("lag_per_particle.cu", "    jhi = l;\n", "    jhi = l - 1;\n")]),
    "k2_box_last_lane": ("per_particle", [
        ("lag_per_particle.cu", "prune(o.h, zero, real, a.csq);",
         "prune(o.h, zero, real && lane != kWarp - 1, a.csq);")]),
    "k2_dsq_positive_dropped": ("per_particle", [
        ("lag_per_particle.cu", "dsq < csq &&\n                   dsq > T(0);",
         "dsq < csq;")]),
    # the term table (pair_table.cuh) in K1, K3, K6 and K7: shifted's
    # constant dropped, the virial mode's dsq dropped, WCA's cut dropped,
    # soft_sphere's power one multiply short, K7's table factor replaced by
    # its LJ form
    "table_shift_dropped": ("table_kernels", [
        ("pair_table.cuh", "return table_energy(dsq, t) - t.shift;",
         "return table_energy(dsq, t);")]),
    "table_virial_dsq_dropped": ("table_kernels", [
        ("pair_table.cuh", "return table_gfn(dsq, t) * dsq;", "return table_gfn(dsq, t);")]),
    "table_wca_select_dropped": ("table_kernels", [
        ("pair_table.cuh", "return dsq < p[3] ? v : 0.0f;", "return v;")]),
    "table_soft_sphere_short": ("table_kernels", [
        ("pair_table.cuh", "for (int k = 1; k < static_cast<int>(p[3]); ++k) w = w * x;\n"
         "      return p[1] * w;",
         "for (int k = 2; k < static_cast<int>(p[3]); ++k) w = w * x;\n"
         "      return p[1] * w;")]),
    "k7_table_factor_lj": ("table_kernels", [
        ("tile_forces.cu", "GFN == kGfnTable ? table_gfn(dsq, tab) : force_factor<GFN>(dsq)",
         "force_factor<GFN>(dsq)")]),
    # the table's f32 operations differ from the torch function's by an
    # ulp: Morse's exp through the __expf intrinsic, Yukawa's r-factor
    # contracted into an FMA (the build's --fmad=false forbids that)
    "table_expf_intrinsic": ("table_kernels", [
        ("pair_table.cuh", "const float y = 1.0f - expf(p[1] * (sqrtf(dsq) - p[2]));",
         "const float y = 1.0f - __expf(p[1] * (sqrtf(dsq) - p[2]));")]),
    "table_fma_contracted": ("table_kernels", [
        ("pair_table.cuh", "(p[2] * r + 1.0f)", "fmaf(p[2], r, 1.0f)")]),
    # the species instances: the entry's species read from the neighbouring
    # slot (K3), the lane's own from the slot before (K1, K6), species S - 1
    # decoded as 0
    "k3_species_neighbour_slot": ("species_kernels", [
        ("lag_forces.cu", "const float b_s = SPEC && valid ? sp[j] : 0.0f;",
         "const float b_s = SPEC && valid ? sp[j + 1 < a.n ? j + 1 : j] : 0.0f;")]),
    "k1_species_own_slot": ("species_kernels", [
        ("lag_reduce.cu", "o.pw = PLANE && real ? a.w[i] : 0.0f;",
         "o.pw = PLANE && real ? a.w[i > 0 ? i - 1 : i] : 0.0f;")]),
    "k6_species_own_slot": ("species_kernels", [
        ("tile_reduce.cu", "o.pw = PLANE && real ? a.w[i] : 0.0f;",
         "o.pw = PLANE && real ? a.w[i > 0 ? i - 1 : i] : 0.0f;")]),
    "species_last_dropped": ("species_kernels", [
        ("pair_table.cuh", "s < static_cast<float>(ns))",
         "s < static_cast<float>(ns) - 1.0f)")]),
    # the periodic observables: the keep test dropped in each of K4, K5, K8
    # and K9; split K4's minimum-image fold without the box's low part (the
    # rounding seam box shows it); the species plane ignored in K5's
    # composed mask; the minimum-image walk's prune without the periodic
    # images (the seam lattices' pairs cross the seam only)
    "k4_keep_dropped": ("pbc_stress", [
        ("lag_stress.cu", "stress_sweep<T, SPLIT, GFN, false, FULL, KEEP, MI>(",
         "stress_sweep<T, SPLIT, GFN, false, FULL, false, MI>(")]),
    "k8_keep_dropped": ("pbc_stress", [
        ("tile_stress.cu", "stress_sweep<T, SPLIT, GFN, BANDMASK, FULL, KEEP>(",
         "stress_sweep<T, SPLIT, GFN, BANDMASK, FULL, false>(")]),
    "k5_keep_dropped": ("pbc_hist", [
        ("lag_hist.cu", "hist_sweep<T, SPLIT, MASK, FULL, KEEP, MI>(",
         "hist_sweep<T, SPLIT, MASK, FULL, false, MI>(")]),
    "k9_keep_dropped": ("pbc_hist", [
        ("tile_hist.cu", "if (RULE == kMaskKeep) m = m && keep_pair_of(o.w, bp[q]);", "")]),
    "k4_mi_fold_box_lo_dropped": ("pbc_stress", [
        ("cluster_sweep.cuh", "d = d + ((e + (li - lj)) - shift_lo);",
         "d = d + (e + (li - lj));")]),
    "k5_composed_species_dropped": ("pbc_hist", [
        ("lag_hist.cu", "    if (MASK) m = m && species_pair(o.w, bp[q], sa.ma, sa.mb);",
         "    if (MASK && !KEEP) m = m && species_pair(o.w, bp[q], sa.ma, sa.mb);")]),
    "mi_walk_prune_open": ("pbc_stress or pbc_hist", [
        ("cluster_sweep.cuh", "return near_box_mi<SPLIT>(box, b, bl, thr, mib);",
         "return near_box<SPLIT>(box, b, bl, thr);")]),
    # the term table in K2, K4 and K8: K2's term without the table's mode
    # and shift (the energy form alone), the stress sweep's force factor read
    # in the energy form (in K4 and in K8, each against its own test), and
    # one constant of the table dropped in each kernel's C interface
    "k2_table_mode_dropped": ("table_per_particle", [
        ("lag_per_particle.cu", "o.acc += static_cast<double>(table_term(",
         "o.acc += static_cast<double>(table_energy(")]),
    "k2_table_constant_dropped": ("table_per_particle", [
        ("lag_per_particle.cu",
         "const TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);",
         "TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);\n  t.p[1] = 0.0f;")]),
    "k4_table_gfn_as_energy": ("table_lag_stress", [
        ("stress_sweep.cuh", "g = table_gfn(dsq, *tab);", "g = table_energy(dsq, *tab);")]),
    "k4_table_constant_dropped": ("table_lag_stress", [
        ("lag_stress.cu",
         "const TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);",
         "TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);\n  t.p[2] = 0.0f;")]),
    "k8_table_gfn_as_energy": ("table_tile_stress", [
        ("stress_sweep.cuh", "g = table_gfn(dsq, *tab);", "g = table_energy(dsq, *tab);")]),
    "k8_table_constant_dropped": ("table_tile_stress", [
        ("tile_stress.cu",
         "const TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);",
         "TermTable t = make_term_table(tkind, tmode, tvals, nullptr, 0);\n  t.p[2] = 0.0f;")]),
    # the ownership rule (min_islot) of K1, K5, K6 and K9: the rule dropped,
    # `>` for `>=`, and the rule applied to the pair's smaller slot (j >=
    # min_islot) instead of its larger one, the lane's own i
    "k1_islot_dropped": ("islot_lag_reduce", [
        ("lag_reduce.cu", "  if constexpr (ISLOT) own = own && i >= min_islot;\n", "")]),
    "k1_islot_gt": ("islot_lag_reduce", [
        ("lag_reduce.cu", "own = own && i >= min_islot;", "own = own && i > min_islot;")]),
    "k1_islot_smaller_slot": ("islot_lag_reduce", [
        ("lag_reduce.cu", "  if constexpr (ISLOT) own = own && i >= min_islot;\n", ""),
        ("lag_reduce.cu", "  o.jlo = jlo;\n  o.span = own ? static_cast<unsigned>(i - jlo) : 0u;",
         "  o.jlo = ISLOT ? max(jlo, min_islot) : jlo;\n"
         "  o.span = own && i > o.jlo ? static_cast<unsigned>(i - o.jlo) : 0u;")]),
    "k5_islot_dropped": ("islot_lag_hist", [
        ("lag_hist.cu", "  const bool own = real && i >= min_islot;\n", "  const bool own = real;\n")]),
    "k5_islot_gt": ("islot_lag_hist", [
        ("lag_hist.cu", "const bool own = real && i >= min_islot;",
         "const bool own = real && i > min_islot;")]),
    "k5_islot_smaller_slot": ("islot_lag_hist", [
        ("lag_hist.cu", "  const bool own = real && i >= min_islot;\n", "  const bool own = real;\n"),
        ("lag_hist.cu", "  o.jlo = jlo;\n  o.span = own ? static_cast<unsigned>(i - jlo) : 0u;",
         "  o.jlo = max(jlo, min_islot);\n"
         "  o.span = own && i > o.jlo ? static_cast<unsigned>(i - o.jlo) : 0u;")]),
    # K6 and K9: every entry carries its slot, and the lane's range starts
    # at min_islot
    "k6_islot_dropped": ("islot_tile_reduce", [
        ("tile_reduce.cu", "  if constexpr (ISLOT) own = own && i >= min_islot;\n", "")]),
    "k6_islot_gt": ("islot_tile_reduce", [
        ("tile_reduce.cu", "own = own && i >= min_islot;", "own = own && i > min_islot;")]),
    "k6_islot_smaller_slot": ("islot_tile_reduce", [
        ("tile_reduce.cu", "  if constexpr (ISLOT) own = own && i >= min_islot;\n", ""),
        ("tile_reduce.cu",
         "  o.jlo = -1;         // band 0 pairs with w < i, the other bands always\n"
         "  o.span = own ? static_cast<unsigned>(i) + 1u : 0u;",
         "  o.jlo = ISLOT ? min_islot : -1;\n"
         "  o.span = own && i > o.jlo ? static_cast<unsigned>(i - o.jlo) : 0u;"),
        ("tile_reduce.cu", "load_slot(a.pos, a.n, a.dim, j, s == 0 ? j : -1)",
         "load_slot(a.pos, a.n, a.dim, j, ISLOT || s == 0 ? j : -1)")]),
    "k9_islot_dropped": ("islot_tile_hist", [
        ("tile_hist.cu", "  if constexpr (ISLOT) own = own && i >= min_islot;\n", "")]),
    "k9_islot_gt": ("islot_tile_hist", [
        ("tile_hist.cu", "own = own && i >= min_islot;", "own = own && i > min_islot;")]),
    "k9_islot_smaller_slot": ("islot_tile_hist", [
        ("tile_hist.cu", "  if constexpr (ISLOT) own = own && i >= min_islot;\n", ""),
        ("tile_hist.cu", "  unsigned span;\n  T w;\n};", "  unsigned span;\n  T w;\n  int lo;\n};"),
        ("tile_hist.cu", "  o.w = RULE != kMaskNone && real ? a.pay[i] : T(0);\n",
         "  o.w = RULE != kMaskNone && real ? a.pay[i] : T(0);\n"
         "  o.lo = ISLOT ? min_islot : -1;\n"),
        ("tile_hist.cu",
         "bool m = static_cast<unsigned>(tag_from(b.w) + 1) < o.span && dsq < sa.csq;",
         "bool m = static_cast<unsigned>(tag_from(b.w) + 1) < o.span && tag_from(b.w) >= o.lo "
         "&& dsq < sa.csq;"),
        ("cluster_sweep.cuh", "load_point(a.pos, a.n, a.dim, j, s == 0 ? j : -1)",
         "load_point(a.pos, a.n, a.dim, j, j)")]),
}

# the kernels whose SASS `sass` compares: every sweep on cluster_sweep.cuh
SASS_KERNELS = ("lag_reduce", "lag_per_particle", "lag_forces", "lag_stress", "lag_hist",
                "tile_reduce", "tile_forces", "tile_stress", "tile_hist", "join_reduce")

# the kernels each test selection needs, built before the card is needed
_LOADERS = {"tile_hist": "tile_pairs.load_hist_kernel()", "join": "join.load_kernel()",
            "lag_hist": "lag_pairs.load_hist_kernel()",
            "tile_stress": "tile_pairs.load_stress_kernel()",
            "lag_stress": "lag_pairs.load_stress_kernel()",
            "per_particle": "lag_pairs.load_per_particle_kernel()",
            "pbc_lag_reduce": "lag_pairs.load_kernel()",
            "pbc_lag_forces": "lag_pairs.load_forces_kernel()",
            "pbc_tile_reduce": "tile_pairs.load_kernel()",
            "pbc_stress": "lag_pairs.load_stress_kernel(); tile_pairs.load_stress_kernel()",
            "pbc_hist": "lag_pairs.load_hist_kernel(); tile_pairs.load_hist_kernel()",
            "table_kernels": "lag_pairs.load_kernel(); lag_pairs.load_forces_kernel(); "
                             "tile_pairs.load_kernel(); tile_pairs.load_forces_kernel()",
            "species_kernels": "lag_pairs.load_kernel(); lag_pairs.load_forces_kernel(); "
                               "tile_pairs.load_kernel()",
            "table_per_particle": "lag_pairs.load_per_particle_kernel()",
            "table_lag_stress": "lag_pairs.load_stress_kernel()",
            "table_tile_stress": "tile_pairs.load_stress_kernel()",
            "islot_lag_reduce": "lag_pairs.load_kernel()",
            "islot_tile_reduce": "tile_pairs.load_kernel()",
            "islot_lag_hist": "lag_pairs.load_hist_kernel()",
            "islot_tile_hist": "tile_pairs.load_hist_kernel()"}


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


def sass(tree: str, allow: str = "") -> None:
    from zelll_tpu_torch.ops._build import NVCC_FLAGS, nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    other = Path(tree).resolve() / "zelll_tpu_torch" / "csrc"
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="sass-", dir=ROOT / "build"))
    jobs = {}
    with ThreadPoolExecutor(8) as pool:
        for kernel in SASS_KERNELS:
            for side, csrc in (("this", CSRC), ("other", other)):
                out = tmp / f"{kernel}-{side}.cubin"
                jobs[kernel, side] = (out, pool.submit(subprocess.run, [
                    nvcc(), *flags, "-cubin", "-o", str(out), str(csrc / f"{kernel}.cu")],
                    capture_output=True, text=True, check=True))
        for _, fut in jobs.values():
            fut.result()
    ok = True
    allowed = re.compile(allow) if allow else None
    for kernel in SASS_KERNELS:
        mine, theirs = jobs[kernel, "this"][0], jobs[kernel, "other"][0]
        fa, fb = _sass_by_function(mine), _sass_by_function(theirs)
        ra, rb = _registers(mine), _registers(theirs)
        shared = set(fa) & set(fb)
        moved = sorted(f for f in shared if fa[f] != fb[f] or ra.get(f) != rb.get(f))
        lost = sorted(set(fb) - set(fa))
        unexplained = [f for f in moved + lost if allowed is None or not allowed.search(f)]
        same_regs = all(ra.get(f) == rb.get(f) for f in shared)
        ok = ok and not unexplained
        emit("sass", kernel=kernel, functions=len(fb), shared=len(shared),
             registers_equal=same_regs, sass_equal=sum(fa[f] == fb[f] for f in shared),
             new_functions=len(set(fa) - set(fb)), lost_functions=len(lost),
             moved=moved, lost=lost, not_allowed=unexplained,
             registers={f: [ra.get(f), rb.get(f)] for f in sorted(set(ra) | set(rb))})
    if not ok:
        raise SystemExit("a function's SASS or registers moved, or one was lost, "
                         "outside ALLOW")


def mutations() -> None:
    base = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / "mut"
    shutil.rmtree(base, ignore_errors=True)
    names = ["unbroken", *MUTATIONS]
    every = " or ".join(dict.fromkeys(
        part for sel, _ in MUTATIONS.values() for part in sel.split(" or ")))
    selects = {"unbroken": every, **{k: v[0] for k, v in MUTATIONS.items()}}

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
        loads = "; ".join(_LOADERS[part] for part in selects[name].split(" or "))
        return subprocess.run(
            [sys.executable, "-c",
             f"from zelll_tpu_torch.ops import join, lag_pairs, tile_pairs; {loads}"],
            cwd=dest, capture_output=True, text=True).returncode

    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(names, pool.map(prepare, names)))
    ok = True
    for name in names:
        select = selects[name]
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


# one timing run, started in the root of the tree whose package it times;
# argv[1] is this checkout's chip_smoke.py, argv[2:] the phases to run. A
# phase's rows are its entries that hold an "ms", those of its "calls"
# (observables_main_path) and its "ms" table (api_main_path); the rows of
# per_particle_alone carry a K2_ prefix.
_TIMING = """
import importlib.util, json, sys
import torch
spec = importlib.util.spec_from_file_location("smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
dev = torch.device("cuda")

def rows(d, prefix):
    for k, v in d.items():
        if isinstance(v, dict) and isinstance(v.get("ms"), (int, float)):
            yield prefix + k, v
        elif k == "calls" and isinstance(v, dict):
            yield from rows(v, prefix)
        elif k == "ms" and isinstance(v, dict):
            yield from ((prefix + c, {"ms": t}) for c, t in v.items())

out = {}
for phase in sys.argv[2:]:
    n = smoke.N_PARITY if phase.startswith("api_") else smoke.N_MAIN
    prefix = "K2_" if phase == "per_particle_alone" else ""
    out.update(rows(getattr(smoke, phase)(dev, n), prefix))
print(json.dumps(out, default=str))
"""
TIMING_PHASES = ("stress_alone", "hist_alone", "per_particle_alone")


def timing(tree: str, phases=TIMING_PHASES) -> None:
    other = Path(tree).resolve()
    for side, root in (("tree", other), ("this", ROOT), ("this", ROOT), ("tree", other)):
        proc = subprocess.run([sys.executable, "-c", _TIMING, str(ROOT / "chip_smoke.py"),
                               *phases], cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"timing in {root} failed:\n{proc.stderr[-3000:]}")
        emit("timing", side=side, root=str(root), phases=list(phases),
             kernels=json.loads(proc.stdout.strip().splitlines()[-1]))


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in ("sass", "mutations", "timing"):
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA device")
    if sys.argv[1] == "sass":
        sass(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "")
    elif sys.argv[1] == "timing":
        timing(sys.argv[2], tuple(sys.argv[3:]) or TIMING_PHASES)
    else:
        mutations()


if __name__ == "__main__":
    main()
