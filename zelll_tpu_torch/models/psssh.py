"""psssh: Protein Structure Surface Sampling using HMC, end to end.

PyTorch counterpart of ``zelll_tpu/models/psssh.py``, after the reference
case study (surface-sampling/examples/cli.rs): sample points on a protein
iso-surface defined by the smooth distance field, driven by cell-list
neighbour queries. Two subcommands, mirroring the reference CLI:

* sample: burn-in and draws on the harmonic iso-surface log density,
  written out as a PDB point cloud (cli.rs:63-143). Many chains run at once
  (``--chains``): ``--sampler hmc`` (jittered-length HMC) or
  ``nuts-batched`` (lockstep NUTS), each one K12 launch per leapfrog step
  on the card; ``nuts`` is the single-chain NUTS of the reference's
  nuts-rs usage.
* eval: the field's value and gradient over an l^3 query grid around the
  structure, with its time (cli.rs:150-195), in one batched pass instead
  of the reference's per-point loop.

Run as ``python -m zelll_tpu_torch.models.psssh sample|eval ...``; it runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..utils.pdb import read_pdb, write_points_pdb
from .nuts import hmc_sample_batched, nuts_sample, nuts_sample_batched
from .sdf import SmoothDistanceField

__all__ = ["sample_surface", "eval_grid", "main"]


def sample_surface(sdf: SmoothDistanceField, *, chains: int = 256,
                   burnin: int = 300, draws: int = 20, seed: int = 0,
                   sampler: str = "hmc", nuts_depth: int = 7) -> np.ndarray:
    """Sample points near the iso-surface. Returns (draws * chains, 3).

    Chains start at randomly jittered atom positions (inside the grid, so
    logp is finite), as the reference seeds near the structure.
    ``nuts_depth`` caps the NUTS tree depth (cli.rs:42-46, maxdepth). The
    chains run on the field's device; ``sampler="nuts"`` too (one field
    evaluation per leapfrog step: build the field with ``device="cpu"`` to
    run it on the host).
    """
    atoms = sdf.data.grid.sorted_pos.cpu().numpy()
    rng = np.random.default_rng(seed)

    if sampler == "nuts":
        def vg(q):
            v, g, ok = sdf.hmc_gradient(q[None, :])
            if not ok[0]:
                return -np.inf, np.zeros(3)
            return float(v[0]), g[0]

        q0 = atoms[rng.integers(len(atoms))] + rng.normal(0, 0.1, 3)
        samples, _ = nuts_sample(vg, q0, num_warmup=burnin,
                                 num_samples=draws * chains,
                                 max_treedepth=nuts_depth, seed=seed)
        return samples

    if sampler not in ("hmc", "nuts-batched"):
        raise ValueError(f"unknown sampler {sampler!r}")
    starts = atoms[rng.integers(0, len(atoms), chains)] + rng.normal(
        0, 0.1, (chains, 3))
    # batched chains: the join's analytic gradients (one K12 launch per
    # leapfrog step for all chains); autograd through the gather path
    # otherwise
    vgrad = sdf.hmc_vgrad_fn() if sdf._use_join() else None
    kw = {}
    if sampler == "nuts-batched":
        sample_fn = nuts_sample_batched
        kw["max_treedepth"] = nuts_depth
    else:
        sample_fn = hmc_sample_batched
    device = sdf.device
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    samples, _ = sample_fn(
        sdf.logdensity_fn(),
        torch.as_tensor(starts, dtype=sdf.data.grid.sorted_pos.dtype,
                        device=device),
        generator, num_warmup=burnin, num_samples=draws,
        value_and_grad_fn=vgrad, **kw)
    return samples.cpu().numpy().reshape(-1, 3)


def eval_grid(sdf: SmoothDistanceField, l: int = 64, margin: float = 0.0):
    """The field's value and gradient over an l^3 grid spanning the
    structure's bounding box (plus an optional margin; the reference's grid
    spans exactly the box, cli.rs:160-176). Returns (points, values, grads,
    elapsed_seconds): the reference's ``eval`` benchmark (cli.rs:150-195),
    timed on the host clock from the numpy grid to the numpy results."""
    pos = sdf.data.grid.sorted_pos.cpu().numpy()
    lo = pos.min(axis=0) - margin
    hi = pos.max(axis=0) + margin
    axes = [np.linspace(lo[a], hi[a], l) for a in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)

    t0 = time.perf_counter()
    vals, grads, _ = sdf.evaluate(grid)
    elapsed = time.perf_counter() - t0
    return grid, vals, grads, elapsed


def main(argv=None):
    ap = argparse.ArgumentParser(prog="psssh", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    # flag names and defaults mirror the reference CLI (cli.rs:19-61);
    # --chains/--seed/--sampler are batching extensions, --device the port's
    sp = sub.add_parser("sample", help="sample iso-surface points")
    sp.add_argument("pdb")
    sp.add_argument("out", nargs="?", default=None,
                    help="output PDB (default: input + .psssh.pdb)")
    sp.add_argument("-c", "--cutoff", type=float, default=10.0)
    sp.add_argument("-n", "--samples", type=int, default=2000,
                    help="total samples across all chains")
    sp.add_argument("-b", "--burn-in", "--burnin", dest="burnin",
                    type=int, default=1000)
    sp.add_argument("-l", "--surface-level", "--surface-radius",
                    dest="surface_level", type=float, default=1.05)
    sp.add_argument("-f", "--force-constant", "--k-force",
                    dest="force_constant", type=float, default=10.0)
    sp.add_argument("-d", "--nuts-depth", type=int, default=7)
    sp.add_argument("--chains", type=int, default=256)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--sampler", choices=["hmc", "nuts", "nuts-batched"],
                    default="hmc")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda)")

    ep = sub.add_parser("eval", help="evaluate SDF over an l^3 grid")
    ep.add_argument("pdb")
    ep.add_argument("-l", "--axis-length", "--grid-size",
                    dest="grid_size", type=int, default=64,
                    help="query grid axis length (reference default 256)")
    ep.add_argument("-c", "--cutoff", type=float, action="append",
                    default=None)
    ep.add_argument("--device", default=None,
                    help="torch device (default: cuda)")

    args = ap.parse_args(argv)
    pos, radii, _ = read_pdb(args.pdb)
    if args.cmd == "sample":
        out = args.out or os.path.splitext(args.pdb)[0] + ".psssh.pdb"
        sdf = SmoothDistanceField(
            pos, radii, cutoff=args.cutoff, surface_radius=args.surface_level,
            k_force=args.force_constant, device=args.device)
        chains = 1 if args.sampler == "nuts" else args.chains
        draws = -(-args.samples // chains)
        pts = sample_surface(sdf, chains=chains, burnin=args.burnin,
                             draws=draws, seed=args.seed, sampler=args.sampler,
                             nuts_depth=args.nuts_depth)[: args.samples]
        write_points_pdb(out, pts)
        print(f"wrote {len(pts)} surface samples to {out}")
    else:
        cutoffs = args.cutoff or [10.0]
        name = os.path.splitext(os.path.basename(args.pdb))[0]
        vol = float(np.prod(pos.max(axis=0) - pos.min(axis=0)))
        print("name,atoms,vol,cutoff,queries,ns_total")  # cli.rs:183-195
        for c in cutoffs:
            sdf = SmoothDistanceField(pos, radii, cutoff=c, device=args.device)
            eval_grid(sdf, args.grid_size)  # warm-up: builds the kernel
            _, _, _, dt = eval_grid(sdf, args.grid_size)
            q = args.grid_size**3
            print(f"{name},{len(pos)},{vol},{c},{q},{dt * 1e9:.0f}")


if __name__ == "__main__":
    main()
