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

The reference-parity `CellGrid` (the Rust library's Python binding), on
the card or, with ``device="cpu"``, on the plain path:

    from zelll_tpu_torch import CellGrid
    cg = CellGrid(points, cutoff=10.0)                 # f64, on the card
    i, j = cg.pairs(within_cutoff=True)
    coordination = cg.coordination_numbers()           # kernel K2
    counts, valid = cg.count_neighbors_batch(queries)  # kernel K12

The psssh surface-sampling workload: the smooth distance field of a
structure, evaluated in batches through the query join (K12), and sampled
near its iso-surface by lockstep HMC or NUTS chains:

    from zelll_tpu_torch import SmoothDistanceField
    from zelll_tpu_torch.models.psssh import eval_grid, sample_surface
    sdf = SmoothDistanceField(atoms, radii, cutoff=10.0)
    values, grads, valid = sdf.evaluate(queries)
    points = sample_surface(sdf, chains=1024, burnin=200, draws=50)

The observables, open boundaries: the stress tensor in one fused pass
(K4 on thin boxes, K8 with ``path="tile"``), pair-distance histograms (K5,
K9) and a Langevin NVT trajectory over `md_step`:

    from zelll_tpu_torch import fused_stress_open, pair_distance_histogram
    sigma, ok = fused_stress_open(pos_f32, 10.0, positions_lo=lo)
    shells, ok = pair_distance_histogram(pos_f32, np.linspace(0, 10, 32))
    state, ok, temps = md_run_langevin(state, 10.0, 1e-4, kT=1.0, gamma=1.0,
                                       generator=gen, steps=10,
                                       record_temperature=True)

Periodic (orthorhombic) boxes: ghost images of the boundary particles
(energies through K1 or K6 with the periodic keep mask, forces through K3
or K7), or the minimum image folded in K1 and K3 on narrow axes:

    from zelll_tpu_torch import md_run_skin_tile_pbc, pbc_lj_energy, pbc_lj_forces
    e, ok = pbc_lj_energy(pos, origin, box, 10.0, minimage="auto")
    f, ok = pbc_lj_forces(pos, origin, box, 10.0, path="tile", MAXJ=maxj9)
    state, ok, energy, rebuilds = md_run_skin_tile_pbc(
        state, origin, box, 10.0, 1e-4, steps=50, B=B, G=G, MAXJ=maxj9)
"""

from .api import CellGrid, GridCell
from .config import ZelllConfig
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
    count_pairs,
    generate_pointcloud,
    materialize_pairs,
    pair_forces,
    pair_sum,
    query_neighbors,
    rebuild,
)
from .models import (
    ELEMENT_RADII,
    MDState,
    MDStateSplit,
    SmoothDistanceField,
    hmc_sample_batched,
    md_run,
    md_run_skin,
    md_run_skin_pbc,
    md_run_skin_tile,
    md_run_skin_tile_pbc,
    md_run_vv,
    md_run_vv_pbc,
    md_step,
    md_step_cubic_tile,
    md_run_langevin,
    md_step_split,
    nuts_sample,
    nuts_sample_batched,
)
from .ops import (
    auto_lj_energy,
    combine_count,
    count_neighbors,
    count_term,
    fused_count_pairs,
    fused_lj_energy,
    fused_lj_rebuild_energy,
    fused_pair_sum,
    fused_stress_open,
    fused_virial,
    grid_join_reduce,
    join_reduce,
    lag_coverage_ok,
    lj_term,
    lj_force_factor,
    lj_force_factor_fast,
    lj_term_fast,
    md_step_pbc,
    minimage_axes,
    nearest_dsq,
    pair_distance_histogram,
    pair_lag_forces,
    pair_lag_hist,
    pair_lag_per_particle,
    pair_lag_reduce,
    pair_lag_stress,
    pbc_count_pairs,
    pbc_extend,
    pbc_lj_energy,
    pbc_lj_forces,
    pbc_pair_sum,
    split_f64,
    suggest_lag,
    suggest_pbc_capacity,
    tile_count_pairs,
    tile_lj_energy,
    tile_lj_rebuild_energy,
    tile_pair_forces,
    tile_pair_hist,
    tile_pair_reduce,
    tile_pair_stress,
    virial_rebuild,
    wrap_positions,
)

__all__ = [
    "CellGrid",
    "GridCell",
    "ZelllConfig",
    "SENTINEL_KEY",
    "Aabb",
    "Bins",
    "CellGridData",
    "GridInfo",
    "aabb_from_positions",
    "bin_and_sort",
    "build",
    "build_bins",
    "count_pairs",
    "generate_pointcloud",
    "materialize_pairs",
    "pair_forces",
    "pair_sum",
    "query_neighbors",
    "rebuild",
    "ELEMENT_RADII",
    "MDState",
    "MDStateSplit",
    "SmoothDistanceField",
    "hmc_sample_batched",
    "md_run",
    "md_run_skin",
    "md_run_skin_pbc",
    "md_run_skin_tile",
    "md_run_skin_tile_pbc",
    "md_run_vv",
    "md_run_vv_pbc",
    "md_step",
    "md_step_cubic_tile",
    "md_run_langevin",
    "md_step_split",
    "nuts_sample",
    "nuts_sample_batched",
    "auto_lj_energy",
    "combine_count",
    "count_neighbors",
    "count_term",
    "fused_count_pairs",
    "fused_lj_energy",
    "fused_lj_rebuild_energy",
    "fused_pair_sum",
    "fused_stress_open",
    "fused_virial",
    "grid_join_reduce",
    "join_reduce",
    "lag_coverage_ok",
    "lj_term",
    "lj_force_factor",
    "lj_force_factor_fast",
    "lj_term_fast",
    "md_step_pbc",
    "minimage_axes",
    "nearest_dsq",
    "pair_distance_histogram",
    "pair_lag_forces",
    "pair_lag_hist",
    "pair_lag_per_particle",
    "pair_lag_reduce",
    "pair_lag_stress",
    "pbc_count_pairs",
    "pbc_extend",
    "pbc_lj_energy",
    "pbc_lj_forces",
    "pbc_pair_sum",
    "split_f64",
    "suggest_lag",
    "suggest_pbc_capacity",
    "tile_count_pairs",
    "tile_lj_energy",
    "tile_lj_rebuild_energy",
    "tile_pair_forces",
    "tile_pair_hist",
    "tile_pair_reduce",
    "tile_pair_stress",
    "virial_rebuild",
    "wrap_positions",
]
