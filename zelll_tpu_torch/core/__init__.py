"""Functional core: geometry, binning, grid state, pair enumeration."""

from .binning import Bins, bin_and_sort, build_bins, compute_keys, sort_by_key
from .geometry import (
    SENTINEL_KEY,
    Aabb,
    GridInfo,
    aabb_from_positions,
    full_stencil,
    generate_pointcloud,
    half_stencil,
    key_window,
    rel_offsets,
)
from .dense import DenseTable, build_dense_table, dense_rows_for_keys
from .grid import CellGridData, build, rebuild
from .pairs import (
    PairBlock,
    QueryResult,
    count_pairs,
    materialize_pairs,
    pair_energy_per_particle,
    pair_forces,
    pair_stress,
    pair_sum,
    query_neighbors,
    scan_cell_chunks,
)

__all__ = [
    "SENTINEL_KEY",
    "Aabb",
    "GridInfo",
    "aabb_from_positions",
    "full_stencil",
    "half_stencil",
    "generate_pointcloud",
    "key_window",
    "rel_offsets",
    "Bins",
    "bin_and_sort",
    "build_bins",
    "compute_keys",
    "sort_by_key",
    "DenseTable",
    "build_dense_table",
    "dense_rows_for_keys",
    "CellGridData",
    "build",
    "rebuild",
    "PairBlock",
    "QueryResult",
    "scan_cell_chunks",
    "pair_sum",
    "pair_forces",
    "pair_stress",
    "pair_energy_per_particle",
    "count_pairs",
    "materialize_pairs",
    "query_neighbors",
]
