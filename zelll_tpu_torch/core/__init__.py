"""Geometry, binning and the cell-grid state."""

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
from .grid import CellGridData, build

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
    "CellGridData",
    "build",
]
