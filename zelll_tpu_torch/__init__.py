"""zelll_tpu_torch: cell lists in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA port of ``zelll_tpu``, which stays the reference. The
entry points take the JAX package's arguments (without ``interpret``) plus
``device``: inputs that are not tensors go to CUDA unless ``device`` says
otherwise, a tensor keeps its device, and CPU tensors run the plain
PyTorch versions of the kernels.

The benchmark step, n points, cutoff 10, a full rebuild per call:

    from zelll_tpu_torch import fused_lj_rebuild_energy, split_f64
    hi, lo = split_f64(torch.as_tensor(points_f64, device="cuda"))
    energy, coverage_ok = fused_lj_rebuild_energy(hi, 10.0, lo, L=256)

The cubic-box step, through the segment-tile kernel (K6), with per-band
window capacities probed from the data:

    from zelll_tpu_torch import tile_lj_rebuild_energy
    energy, coverage_ok = tile_lj_rebuild_energy(pos_f32, 10.0, MAXJ=maxj)

`auto_lj_energy` picks between the two steps by itself.

Molecular dynamics, a full rebuild per step, the forces through the lag
forces kernel (K3) for thin boxes or the tile forces kernel (K7) for cubic
ones; the skin loops reuse the grid while no particle has moved more than
half the skin:

    from zelll_tpu_torch import MDState, md_run_skin, md_step_cubic_tile
    state = MDState.create(pos_f32, vel_f32)           # on the card
    state, ok, energy, rebuilds = md_run_skin(state, 10.0, 1e-4, steps=50)
    state, ok = md_step_cubic_tile(cube_state, 10.0, 1e-4, MAXJ=maxj9)
"""

from .core import (
    SENTINEL_KEY,
    Aabb,
    Bins,
    CellGridData,
    GridInfo,
    aabb_from_positions,
    bin_and_sort,
    build,
    build_bins,
)
from .models import (
    MDState,
    MDStateSplit,
    md_run,
    md_run_skin,
    md_run_skin_tile,
    md_run_vv,
    md_step,
    md_step_cubic_tile,
    md_step_split,
)
from .ops import (
    auto_lj_energy,
    combine_count,
    count_term,
    fused_count_pairs,
    fused_lj_energy,
    fused_lj_rebuild_energy,
    fused_pair_sum,
    lag_coverage_ok,
    lj_term,
    lj_force_factor,
    lj_force_factor_fast,
    lj_term_fast,
    pair_lag_forces,
    pair_lag_reduce,
    split_f64,
    suggest_lag,
    tile_count_pairs,
    tile_lj_energy,
    tile_lj_rebuild_energy,
    tile_pair_forces,
    tile_pair_reduce,
)

__all__ = [
    "SENTINEL_KEY",
    "Aabb",
    "Bins",
    "CellGridData",
    "GridInfo",
    "aabb_from_positions",
    "bin_and_sort",
    "build",
    "build_bins",
    "MDState",
    "MDStateSplit",
    "md_run",
    "md_run_skin",
    "md_run_skin_tile",
    "md_run_vv",
    "md_step",
    "md_step_cubic_tile",
    "md_step_split",
    "auto_lj_energy",
    "combine_count",
    "count_term",
    "fused_count_pairs",
    "fused_lj_energy",
    "fused_lj_rebuild_energy",
    "fused_pair_sum",
    "lag_coverage_ok",
    "lj_term",
    "lj_force_factor",
    "lj_force_factor_fast",
    "lj_term_fast",
    "pair_lag_forces",
    "pair_lag_reduce",
    "split_f64",
    "suggest_lag",
    "tile_count_pairs",
    "tile_lj_energy",
    "tile_lj_rebuild_energy",
    "tile_pair_forces",
    "tile_pair_reduce",
]
