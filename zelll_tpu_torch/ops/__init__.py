"""Pair reductions: kernel K1 and the fused steps built on it."""

from .fused import (
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
    pair_lag_reduce,
    pair_lag_reduce_plain,
    split_f64,
    suggest_lag,
)

__all__ = [
    "fused_count_pairs",
    "fused_lj_energy",
    "fused_lj_rebuild_energy",
    "fused_pair_sum",
    "combine_count",
    "count_term",
    "lag_coverage_ok",
    "lj_term",
    "pair_lag_reduce",
    "pair_lag_reduce_plain",
    "split_f64",
    "suggest_lag",
]
