"""End-to-end workloads built on the port's kernels: LJ molecular dynamics."""

from .lj_md import (
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

__all__ = [
    "MDState",
    "MDStateSplit",
    "md_run",
    "md_run_skin",
    "md_run_skin_tile",
    "md_run_vv",
    "md_step",
    "md_step_cubic_tile",
    "md_step_split",
]
