"""The psssh surface-sampling workload in the port (`zelll_tpu_torch.models.
psssh`, `nuts`, `utils.pdb`) on the CPU: PDB I/O and `eval_grid` against the
JAX package's, the CLI on synthetic PDB files, and the samplers held to the
statistics that tests/test_psssh.py and tests/test_nuts_batched.py hold the
JAX samplers to (torch cannot reproduce JAX's random streams, so draws are
compared in distribution, with the JAX tests' sizes and bounds).

The Gaussian targets pass their analytic (logp, grad) as
``value_and_grad_fn``, as the SDF passes `hmc_vgrad_fn`; one test takes the
autograd path through a batched ``logdensity_fn``.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.models.psssh import eval_grid as jax_eval_grid
from zelll_tpu.models.sdf import SmoothDistanceField as JaxField
from zelll_tpu.utils.pdb import read_pdb as jax_read_pdb
from zelll_tpu_torch.convert import sdf_from_numpy
from zelll_tpu_torch.models.nuts import (
    hmc_sample_batched, nuts_sample, nuts_sample_batched,
)
from zelll_tpu_torch.models.psssh import eval_grid, main, sample_surface
from zelll_tpu_torch.models.sdf import SmoothDistanceField
from zelll_tpu_torch.utils.pdb import read_pdb, write_points_pdb

from test_psssh import PDB_SNIPPET

F64 = torch.float64


def _gaussian(stds):
    """Batched (logp, grad) of independent normals with ``stds``."""
    s = torch.as_tensor(stds, dtype=F64)

    def vg(x):
        z = x / s
        return -0.5 * (z * z).sum(-1), -z / s

    return vg


def _toy_sdf(method="auto"):
    atoms = np.random.default_rng(0).normal(0, 1.0, (20, 3))
    return SmoothDistanceField(atoms, cutoff=4.0, surface_radius=1.05,
                               method=method, device="cpu")


def test_pdb_roundtrip_matches_jax(tmp_path):
    p = tmp_path / "t.pdb"
    p.write_text(PDB_SNIPPET)
    pos, radii, elems = read_pdb(p)
    want = jax_read_pdb(p)
    np.testing.assert_array_equal(pos, want[0])
    np.testing.assert_array_equal(radii, want[1])
    assert elems == want[2] == ["N", "C", "C", "O", "C", "H"]  # FE skipped
    out = tmp_path / "o.pdb"
    write_points_pdb(out, pos)
    np.testing.assert_allclose(read_pdb(out)[0], pos, atol=1e-3)


def test_cli_sample_and_eval(tmp_path, capsys):
    """The CLI surface (cli.rs:19-61), as tests/test_psssh.py drives the JAX
    package's, with ``--device cpu``: the default output path, -n as the
    total across chains, the reference's flag names, the single-chain NUTS,
    and the eval CSV columns (cli.rs:183-195)."""
    p = tmp_path / "toy.pdb"
    p.write_text(PDB_SNIPPET)
    main(["sample", str(p), "-n", "48", "-b", "10", "--chains", "16",
          "--sampler", "hmc", "-c", "10.0", "-l", "1.05", "-f", "10.0",
          "--device", "cpu"])
    out = tmp_path / "toy.psssh.pdb"
    assert len(read_pdb(out)[0]) == 48
    main(["sample", str(p), str(tmp_path / "n.pdb"), "-n", "12", "-b", "5",
          "--sampler", "nuts", "-d", "3", "--device", "cpu"])
    assert len(read_pdb(tmp_path / "n.pdb")[0]) == 12
    main(["eval", str(p), "-l", "4", "-c", "5.0", "-c", "2.0", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-3] == "name,atoms,vol,cutoff,queries,ns_total"
    for row, cutoff in zip(lines[-2:], ("5.0", "2.0")):
        row = row.split(",")
        assert row[:2] == ["toy", "6"] and row[3] == cutoff and row[4] == "64"
        assert int(row[5]) > 0


def test_eval_grid_matches_jax():
    """`eval_grid` at l = 8 on the toy structure: the same query grid, and
    values and gradients within 1e-12 / 1e-10 of the JAX package's where
    the field is defined."""
    atoms = np.random.default_rng(0).normal(0, 1.0, (20, 3))
    a = JaxField(atoms, cutoff=4.0)
    b = sdf_from_numpy(np.array(a.data.grid.sorted_pos),
                       np.array(a.data.radii_sorted[:-1]), 4.0, device="cpu")
    ga, va, da, _ = jax_eval_grid(a, l=8)
    gb, vb, db, dt = eval_grid(b, l=8)
    np.testing.assert_array_equal(gb, ga)
    assert gb.shape == (512, 3) and dt > 0
    defined = np.isfinite(va)
    assert defined.sum() > 100
    np.testing.assert_array_equal(np.isfinite(vb), defined)
    np.testing.assert_allclose(vb[defined], va[defined], rtol=1e-12)
    np.testing.assert_allclose(db[defined], da[defined], rtol=1e-10, atol=1e-12)


def test_sample_surface_near_isosurface():
    """Draws of each sampler concentrate near the iso-surface sdf = 1.05
    (tests/test_psssh.py and test_nuts_batched.py): at least 95 % valid,
    median |sdf - 1.05| below 0.5, on the join's gradients (the batched
    samplers make one join call per leapfrog step for all chains)."""
    sdf = _toy_sdf()
    # the single chain makes one field evaluation per leapfrog step
    for sampler, chains, burnin, draws in (("hmc", 16, 100, 10),
                                           ("nuts-batched", 16, 100, 10),
                                           ("nuts", 1, 50, 40)):
        pts = sample_surface(sdf, chains=chains, burnin=burnin, draws=draws,
                             seed=1, sampler=sampler, nuts_depth=4)
        assert pts.shape == (chains * draws, 3) and np.isfinite(pts).all()
        vals, _, ok = sdf.evaluate(pts)
        assert ok.mean() > 0.95, sampler
        assert np.median(np.abs(vals[ok] - 1.05)) < 0.5, sampler


def test_hmc_gaussian_statistics_and_mass_matrix():
    """Batched HMC on a unit normal (64 chains, 300 draws) and on scales
    spanning 100x, where only the adapted diagonal mass matrix lets a shared
    step size traverse the wide axis (tests/test_psssh.py)."""
    q0 = torch.full((64, 3), 2.0, dtype=F64)
    s, acc = hmc_sample_batched(None, q0, 0, num_warmup=200, num_samples=300,
                                num_leapfrog=8, value_and_grad_fn=_gaussian([1.0] * 3))
    assert s.shape == (300, 64, 3) and acc.shape == (300, 64)
    s = s.reshape(-1, 3).numpy()
    assert float(acc.mean()) > 0.5
    assert abs(s.mean()) < 0.15 and abs(s.std() - 1.0) < 0.15

    scales = [10.0, 1.0, 0.1]
    s, acc = hmc_sample_batched(None, torch.zeros((64, 3), dtype=F64), 3,
                                num_warmup=500, num_samples=500, num_leapfrog=16,
                                value_and_grad_fn=_gaussian(scales))
    assert float(acc.mean()) > 0.5
    np.testing.assert_allclose(s.reshape(-1, 3).numpy().std(0), scales, rtol=0.25)


def test_nuts_single_chain_gaussian():
    """The host-recursion NUTS on a 2-D unit normal (tests/test_psssh.py)."""
    def vg(q):
        return -0.5 * float(q @ q), -q

    samples, acc = nuts_sample(vg, np.array([3.0, -3.0]), num_warmup=150,
                               num_samples=400, seed=2)
    assert abs(samples.mean()) < 0.25 and abs(samples.std() - 1.0) < 0.25
    assert acc.mean() > 0.4


def test_nuts_batched_recovers_gaussians():
    """Lockstep NUTS (64 chains) on an anisotropic normal (stds 0.2 to 3)
    and on a correlated one (rho = 0.9): an error in the U-turn or
    multinomial logic shows as biased variances (test_nuts_batched.py)."""
    stds = [0.2, 0.5, 1.0, 2.0, 3.0]
    g = torch.Generator().manual_seed(1)
    q0 = torch.randn((64, 5), generator=g, dtype=F64) * 0.1
    s, acc = nuts_sample_batched(None, q0, 0, num_warmup=300, num_samples=400,
                                 value_and_grad_fn=_gaussian(stds))
    assert s.shape == (400, 64, 5)
    s = s.reshape(-1, 5).numpy()
    np.testing.assert_allclose(s.std(0), stds, rtol=0.05)
    assert np.abs(s.mean(0) / np.asarray(stds)).max() < 0.05
    assert 0.5 < float(acc.mean()) <= 1.0

    prec = torch.linalg.inv(torch.tensor([[1.0, 0.9], [0.9, 1.0]], dtype=F64))

    def vg(x):
        px = x @ prec
        return -0.5 * (x * px).sum(-1), -px

    q0 = torch.randn((64, 2), generator=g, dtype=F64) * 0.1
    s, _ = nuts_sample_batched(None, q0, 2, num_warmup=300, num_samples=500,
                               value_and_grad_fn=vg)
    np.testing.assert_allclose(np.cov(s.reshape(-1, 2).numpy().T),
                               [[1.0, 0.9], [0.9, 1.0]], atol=0.08)


def test_nuts_batched_matches_hmc_on_donut():
    """Both batched samplers target the same donut density (radius 3, width
    0.25); their radial moments agree (test_nuts_batched.py). HMC takes
    the autograd path through the batched log density, NUTS its analytic
    gradient."""
    def logp(x):
        r = torch.sqrt((x * x).sum(-1))
        return -0.5 * ((r - 3.0) / 0.25) ** 2

    def vg(x):
        r = torch.sqrt((x * x).sum(-1, keepdim=True))
        return logp(x), -(r - 3.0) / 0.0625 * x / r

    g = torch.Generator().manual_seed(5)
    q0 = 3.0 + torch.randn((64, 3), generator=g, dtype=F64) * 0.05
    kw = dict(num_warmup=300, num_samples=300)
    sn, _ = nuts_sample_batched(None, q0, 4, value_and_grad_fn=vg, **kw)
    sh, _ = hmc_sample_batched(logp, q0, 4, **kw)
    rn = np.linalg.norm(sn.reshape(-1, 3).numpy(), axis=1)
    rh = np.linalg.norm(sh.reshape(-1, 3).numpy(), axis=1)
    assert abs(rn.mean() - rh.mean()) < 0.05
    assert abs(rn.std() - rh.std()) < 0.05
    assert abs(rn.mean() - 3.0) < 0.1


def test_nuts_batched_edges():
    """A chain at logp = -inf (outside the grid, surface.rs:10-14) stays
    put without NaNs while a live one moves; the same seed gives the same
    draws; on a flat density every draw stops at max_treedepth."""
    def vg(x):
        inside = x[:, 0] > 0
        lp = torch.where(inside, -0.5 * (x * x).sum(-1),
                         torch.full_like(x[:, 0], float("-inf")))
        return lp, torch.where(inside[:, None], -x, torch.zeros_like(x))

    q0 = torch.tensor([[1.0, 0.0], [-5.0, 2.0]], dtype=F64)
    s, _ = nuts_sample_batched(None, q0, 0, num_warmup=50, num_samples=50,
                               value_and_grad_fn=vg)
    s = s.numpy()
    assert np.isfinite(s).all()
    np.testing.assert_array_equal(s[:, 1, :], np.broadcast_to([-5.0, 2.0], (50, 2)))
    assert (s[:, 0, 0] > 0).all() and np.std(s[:, 0, 0]) > 0.1

    q0 = torch.zeros((4, 3), dtype=F64)
    a, _ = nuts_sample_batched(None, q0, 7, num_warmup=20, num_samples=20,
                               value_and_grad_fn=_gaussian([1.0] * 3))
    b, _ = nuts_sample_batched(None, q0, 7, num_warmup=20, num_samples=20,
                               value_and_grad_fn=_gaussian([1.0] * 3))
    assert torch.equal(a, b)

    def flat(x):
        return torch.zeros(x.shape[0], dtype=F64), torch.zeros_like(x)

    s, _ = nuts_sample_batched(None, torch.zeros((4, 2), dtype=F64), 0,
                               num_warmup=10, num_samples=10, max_treedepth=4,
                               value_and_grad_fn=flat)
    assert np.isfinite(s.numpy()).all() and s.abs().max() > 0.1
