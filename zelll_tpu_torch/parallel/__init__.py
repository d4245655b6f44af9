"""Multi-shard spatial sharding: slab domain decomposition with halo exchange.

PyTorch counterpart of ``zelll_tpu/parallel``, so far its slab
decomposition (``domain.py``, without ``sharded_stress``) on a mesh of
shards in one process (`mesh`). A slab MD step on four shards of one card:

    from zelll_tpu_torch.parallel import make_mesh, partition_by_slab, sharded_md_step
    mesh = make_mesh(4)                        # 4 shards over the visible cards
    parts, n_local = partition_by_slab(points, cutoff, 4)
    pos = torch.as_tensor(parts, dtype=torch.float32, device="cuda")
    step = sharded_md_step(mesh, cutoff=cutoff, H=4096, use_pallas=True, dt=1e-4)
    pos, vel, energy, coverage_ok = step(pos, torch.zeros_like(pos))

``make_mesh(8, devices="cpu")`` runs the same on the CPU, through the
kernels' plain versions.
"""

from .domain import (
    make_mesh,
    make_sharded_potential,
    partition_by_slab,
    repartition,
    repartition_exchange,
    sharded_lj_energy,
    sharded_md_step,
    sharded_pair_hist,
)

__all__ = [
    "make_mesh",
    "make_sharded_potential",
    "partition_by_slab",
    "repartition",
    "repartition_exchange",
    "sharded_md_step",
    "sharded_lj_energy",
    "sharded_pair_hist",
]
