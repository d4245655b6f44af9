"""Pair reductions: kernels K1 (lag window) and K6 (segment tiles), and
the fused steps built on them."""

from .fused import (
    auto_lj_energy,
    fused_count_pairs,
    fused_lj_energy,
    fused_lj_rebuild_energy,
    fused_pair_sum,
)
from .lag_pairs import (
    combine_count,
    count_term,
    lag_coverage_ok,
    lj_term,
    lj_term_fast,
    pair_lag_reduce,
    pair_lag_reduce_plain,
    split_f64,
    suggest_lag,
)
from .segments import chunk_bounds, segment_bands, suggest_maxj
from .tile_pairs import (
    tile_count_pairs,
    tile_lj_energy,
    tile_lj_rebuild_energy,
    tile_pair_reduce,
    tile_pair_reduce_plain,
)

__all__ = [
    "auto_lj_energy",
    "fused_count_pairs",
    "fused_lj_energy",
    "fused_lj_rebuild_energy",
    "fused_pair_sum",
    "combine_count",
    "count_term",
    "lag_coverage_ok",
    "lj_term",
    "lj_term_fast",
    "pair_lag_reduce",
    "pair_lag_reduce_plain",
    "split_f64",
    "suggest_lag",
    "chunk_bounds",
    "segment_bands",
    "suggest_maxj",
    "tile_count_pairs",
    "tile_lj_energy",
    "tile_lj_rebuild_energy",
    "tile_pair_reduce",
    "tile_pair_reduce_plain",
]
