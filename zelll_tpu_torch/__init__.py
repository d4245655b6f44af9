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
    lj_term_fast,
    pair_lag_reduce,
    split_f64,
    suggest_lag,
    tile_count_pairs,
    tile_lj_energy,
    tile_lj_rebuild_energy,
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
    "auto_lj_energy",
    "combine_count",
    "count_term",
    "fused_count_pairs",
    "fused_lj_energy",
    "fused_lj_rebuild_energy",
    "fused_pair_sum",
    "lag_coverage_ok",
    "lj_term",
    "lj_term_fast",
    "pair_lag_reduce",
    "split_f64",
    "suggest_lag",
    "tile_count_pairs",
    "tile_lj_energy",
    "tile_lj_rebuild_energy",
    "tile_pair_reduce",
]
