"""End-to-end workloads built on the port's kernels: LJ molecular dynamics
and its Langevin thermostat, the smooth distance field and its samplers (psssh; the CLI is
``python -m zelll_tpu_torch.models.psssh``)."""

from .lj_md import (
    MDState,
    MDStateSplit,
    md_run,
    md_run_skin,
    md_run_skin_pbc,
    md_run_skin_tile,
    md_run_skin_tile_pbc,
    md_run_vv,
    md_run_vv_pbc,
    md_step,
    md_step_cubic_tile,
    md_step_split,
)
from .nuts import hmc_sample_batched, nuts_sample, nuts_sample_batched
from .sdf import ELEMENT_RADII, SmoothDistanceField, element_radius
from .thermostats import (
    berendsen_rescale,
    kinetic_temperature,
    md_run_langevin,
    ou_step,
)

__all__ = [
    "MDState",
    "MDStateSplit",
    "md_run",
    "md_run_skin",
    "md_run_skin_pbc",
    "md_run_skin_tile",
    "md_run_skin_tile_pbc",
    "md_run_vv",
    "md_run_vv_pbc",
    "md_step",
    "md_step_cubic_tile",
    "md_step_split",
    "hmc_sample_batched",
    "nuts_sample",
    "nuts_sample_batched",
    "ELEMENT_RADII",
    "SmoothDistanceField",
    "element_radius",
    "berendsen_rescale",
    "kinetic_temperature",
    "md_run_langevin",
    "ou_step",
]
