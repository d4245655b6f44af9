"""The port's own copies (datagen, oracle), its isolation from JAX, and its
device rule."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_slab
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

import zelll_tpu.oracle as jax_oracle
from zelll_tpu.utils import datagen as jax_datagen
from zelll_tpu_torch import CellGrid, auto_lj_energy, fused_lj_rebuild_energy, oracle
from zelll_tpu_torch import tile_lj_rebuild_energy, tile_pair_forces, tile_pair_reduce
from zelll_tpu_torch.models import MDState, MDStateSplit
from zelll_tpu_torch.ops.lag_pairs import (
    pair_lag_forces,
    pair_lag_per_particle,
    pair_lag_reduce,
)
from zelll_tpu_torch.utils import datagen

ROOT = Path(__file__).resolve().parents[1]


def test_datagen_bitwise_equal_to_reference():
    n = 3000
    vol = datagen.lj_box(n)
    assert vol == jax_datagen.lj_box(n)
    np.testing.assert_array_equal(
        datagen.generate_points_random(n, vol),
        jax_datagen.generate_points_random(n, vol),
    )


def test_datagen_numpy_stream_equals_native():
    native = datagen.StdRng(datagen.DEFAULT_SEED).next_u64(1000)
    rng = datagen.StdRng(datagen.DEFAULT_SEED)
    key = rng.key
    words = datagen._chacha_blocks(key, np.arange(0, 125, dtype=np.uint64), 12).reshape(-1)
    numpy_stream = words[0::2].astype(np.uint64) | (words[1::2].astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(native, numpy_stream)


def test_oracle_matches_reference_oracle():
    pts = np.random.default_rng(0).uniform(0, 1, (5000, 3)) * [20.0, 20.0, 60.0]
    assert oracle.lj_energy(pts, 1.5) == jax_oracle.lj_energy(pts, 1.5)
    i, j = oracle.pairs(pts, 1.5, cap=10)  # past its first cap, it retries
    ji, jj = jax_oracle.pairs(pts, 1.5)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(j, jj)
    assert len(i) == oracle.lj_energy(pts, 1.5)[1]
    for q in (pts[0], [10.0, 10.0, 30.0], [99.0, 99.0, 999.0]):
        got, want = oracle.query_neighbors(pts, 1.5, q), jax_oracle.query_neighbors(pts, 1.5, q)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)


def test_oracle_forces_match_reference_oracle():
    """The same source; the two libraries are built with other compiler
    flags, which may contract a multiply and an add differently."""
    pts = np.random.default_rng(1).uniform(0, 1, (4000, 3)) * [15.0, 15.0, 50.0]
    want = jax_oracle.forces(pts, 1.5)
    np.testing.assert_allclose(oracle.forces(pts, 1.5), want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_lattice_cloud_equals_the_benchmark_copy():
    """`datagen.lattice_cloud` is the port's copy of the MD protocol's start
    state (benchmarks/steady_state.py): the same points from the same
    generator state, and the generator left in the same state."""
    spec = importlib.util.spec_from_file_location(
        "steady_state", ROOT / "benchmarks" / "steady_state.py")
    steady_state = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(steady_state)
    for box in ((30.0, 30.0, 900.0), (60.0, 60.0, 60.0)):
        rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
        a = datagen.lattice_cloud(2000, box, rng_a)
        b = steady_state.lattice_cloud(2000, box, rng_b)
        np.testing.assert_array_equal(a, b)
        assert rng_a.normal() == rng_b.normal()


def test_oracle_builds_outside_the_package():
    oracle.available()
    lib_dir = Path(oracle._load.lib._name).parent
    assert lib_dir.name == "build" and lib_dir.parent == ROOT
    assert not list((ROOT / "zelll_tpu_torch").rglob("*.so"))


def test_import_without_jax_and_compute_on_cpu():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['zelll_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import zelll_tpu_torch as z\n"
        "pts = np.random.default_rng(0).uniform(0, 4, (300, 3))\n"
        "e, ok = z.fused_lj_rebuild_energy(pts, 1.0, device='cpu')\n"
        "assert bool(ok) and np.isfinite(float(e))\n"
        "e, ok = z.tile_lj_rebuild_energy(pts, 1.0, device='cpu')\n"
        "assert bool(ok) and np.isfinite(float(e))\n"
        "e, path = z.auto_lj_energy(pts, 1.0, max_thin_lag=0, device='cpu')\n"
        "assert path.startswith('tile') and np.isfinite(e)\n"
        "g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing='ij'), -1)\n"
        "st = z.MDState.create(g.reshape(-1, 3) * 1.1, device='cpu')\n"
        "st, ok, e, n = z.md_run_skin(st, 1.6, 1e-4, steps=2)\n"
        "assert bool(ok) and float(e) < 0\n"
        "st, ok = z.md_step_cubic_tile(st, 1.6, 1e-4)\n"
        "assert bool(ok) and st.positions.shape == (216, 3)\n"
        "cg = z.CellGrid(pts, 1.0, device='cpu')\n"
        "assert len(cg.pairs(True)[0]) == cg.coordination_numbers().sum() // 2\n"
        "assert np.isfinite(cg.lj_energy()) and cg.stress().shape == (3, 3)\n"
        "h = cg.distance_histogram(np.linspace(0, 1, 5))\n"
        "assert h.sum() == len(cg.pairs(True)[0])\n"
        "s, ok = z.fused_stress_open(pts, 1.0, path='tile', device='cpu')\n"
        "w, _ = z.virial_rebuild(pts, 1.0, device='cpu')\n"
        "assert bool(ok) and abs(float(s.trace()) - float(w)) <= 1e-9 * abs(float(w))\n"
        "c, ok = z.pair_distance_histogram(pts, [0, 0.5, 1.0], device='cpu')\n"
        "assert ok and c.sum() == h.sum()\n"
        "st, ok = z.md_run_langevin(st, 1.6, 1e-4, 0.1, 1.0, 0, steps=2)\n"
        "assert bool(ok) and st.positions.shape == (216, 3)\n"
        "from zelll_tpu_torch.ops import make_pair_potential\n"
        "x = torch.tensor(pts, requires_grad=True)\n"
        "e, ok = make_pair_potential(1.0, path='tile', device='cpu')(x)\n"
        "e.backward()\n"
        "assert bool(ok) and bool(torch.isfinite(x.grad).all())\n"
        "from zelll_tpu_torch.parallel import make_mesh, partition_by_slab, sharded_md_step\n"
        "parts, _ = partition_by_slab(pts, 1.0, 2)\n"
        "x = torch.as_tensor(parts)\n"
        "_, _, e, ok = sharded_md_step(make_mesh(2, devices='cpu'), cutoff=1.0, H=150,\n"
        "                              use_pallas=True)(x, torch.zeros_like(x))\n"
        "assert bool(ok) and np.isfinite(float(e))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'zelll_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_never_import_jax():
    files = sorted((ROOT / "zelll_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "chip_compare.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "zelll_tpu"), f"{f}: imports {mod}"


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.random.default_rng(0).uniform(0, 4, (100, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_lj_rebuild_energy(pts, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_lag_reduce(pts, np.zeros(100, np.int32), np.ones(3, np.int32), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tile_lj_rebuild_energy(pts, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        auto_lj_energy(pts, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tile_pair_reduce(pts, np.zeros(100, np.int32), np.ones(3, np.int32), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_lag_forces(pts, np.zeros(100, np.int32), np.ones(3, np.int32), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tile_pair_forces(pts, np.zeros(100, np.int32), np.ones(3, np.int32), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MDState.create(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MDStateSplit.from_f64(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CellGrid(pts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pair_lag_per_particle(pts, np.zeros(100, np.int32), np.ones(3, np.int32), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_slab.make_mesh(4)
    # the slab decomposition's mesh of shards and its collectives, on the CPU
    torch_slab.mesh_semantics()
    # a CPU tensor selects the plain path
    e, _ = fused_lj_rebuild_energy(torch.as_tensor(pts), 1.0)
    assert e.device.type == "cpu"
    e, _ = tile_lj_rebuild_energy(torch.as_tensor(pts), 1.0)
    assert e.device.type == "cpu"
    assert CellGrid(torch.as_tensor(pts), 1.0).grid_data.device.type == "cpu"
