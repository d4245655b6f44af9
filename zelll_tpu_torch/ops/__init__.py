"""Pair reductions and pair forces: kernels K1 and K3 (lag window), K6 and
K7 (segment tiles), the fused steps built on them, and the LJ pair
functions."""

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
    pair_lag_forces,
    pair_lag_forces_plain,
    pair_lag_reduce,
    pair_lag_reduce_plain,
    split_f64,
    suggest_lag,
)
from .lj import lj, lj_force_factor, lj_force_factor_fast
from .segments import chunk_bounds, segment_bands, suggest_maxj
from .tile_pairs import (
    tile_count_pairs,
    tile_forces_core,
    tile_lj_energy,
    tile_lj_rebuild_energy,
    tile_pair_forces,
    tile_pair_forces_plain,
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
    "pair_lag_forces",
    "pair_lag_forces_plain",
    "pair_lag_reduce",
    "pair_lag_reduce_plain",
    "split_f64",
    "suggest_lag",
    "lj",
    "lj_force_factor",
    "lj_force_factor_fast",
    "chunk_bounds",
    "segment_bands",
    "suggest_maxj",
    "tile_count_pairs",
    "tile_lj_energy",
    "tile_forces_core",
    "tile_lj_rebuild_energy",
    "tile_pair_forces",
    "tile_pair_forces_plain",
    "tile_pair_reduce",
    "tile_pair_reduce_plain",
]
