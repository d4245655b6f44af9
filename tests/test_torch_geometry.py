"""Port geometry (zelll_tpu_torch.core.geometry) against the reference
goldens and against the JAX package on the same numpy inputs."""

import doctest
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.core import geometry as jgeo
from zelll_tpu_torch.core import build_bins
from zelll_tpu_torch.core import geometry as tgeo


@functools.partial(jax.jit, static_argnames=("auto_order",))
def _jax_grid(pts, cutoff, auto_order):
    info = jgeo.GridInfo.create(jgeo.aabb_from_positions(pts), cutoff,
                                auto_order=auto_order)
    return info.shape, info.strides, info.flat_cell_index(pts)


def _port_grid(pts, cutoff, auto_order):
    p = torch.as_tensor(pts)
    info = tgeo.GridInfo.create(tgeo.aabb_from_positions(p), cutoff,
                                auto_order=auto_order)
    return info.shape, info.strides, info.flat_cell_index(p)


def test_docstring_examples():
    # strides [1, 7, 49] for shape [3, 3, 3]; flat key 99
    res = doctest.testmod(tgeo)
    assert res.attempted > 0 and res.failed == 0


def test_grid_info_golden():
    points = tgeo.generate_pointcloud([3, 3, 3], 1.0, [0.2, 0.25, 0.3])
    aabb = tgeo.aabb_from_positions(points, device="cpu")
    np.testing.assert_allclose(aabb.inf.numpy(), [0.2, 0.25, 0.3])
    np.testing.assert_allclose(aabb.sup.numpy(), [2.7, 2.75, 2.8])
    info = tgeo.GridInfo.create(aabb, 1.0)
    assert info.shape.tolist() == [3, 3, 3]
    assert info.strides.tolist() == [1, 7, 49]
    # 2.3 - 0.3 = 1.9999999999999998 lands in cell 1
    idx, ok = info.try_cell_index(torch.tensor([2.7, 2.75, 2.3], dtype=torch.float64))
    assert bool(ok) and idx.tolist() == [2, 2, 1]
    assert int(info.flat_cell_index(torch.tensor([2.7, 2.75, 2.3], dtype=torch.float64))) == 65
    assert int(info.flat_cell_index(torch.tensor([2.7, 2.75, 2.8], dtype=torch.float64))) == 114


def test_try_cell_index_bounds():
    data = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.1, 0.2]])
    info = tgeo.GridInfo.create(tgeo.aabb_from_positions(data, device="cpu"), 1.0)
    _, ok = info.try_cell_index(torch.full((3,), -1.0, dtype=torch.float64))
    assert bool(ok)
    _, ok = info.try_cell_index(torch.full((3,), -2.0, dtype=torch.float64))
    assert not bool(ok)


def test_generate_pointcloud_matches_reference():
    for shape, origin in [([3, 3, 3], [0.0, 0.0, 0.0]), ([4, 2, 3], [0.2, -1.0, 5.0])]:
        np.testing.assert_array_equal(
            tgeo.generate_pointcloud(shape, 1.5, origin),
            jgeo.generate_pointcloud(shape, 1.5, origin),
        )
    pts = tgeo.generate_pointcloud([3, 3, 3], 1.0, [0.0, 0.0, 0.0])
    assert pts.shape == (28, 3)
    np.testing.assert_array_equal(pts[:4], [[0, 0, 0], [0.5, 0.5, 0.5],
                                            [0, 0, 2], [0.5, 0.5, 2.5]])


def test_chessboard_occupancy():
    points = tgeo.generate_pointcloud([3, 3, 3], 1.0, [0.0, 0.0, 0.0])
    bins = build_bins(points, 1.0, device="cpu")
    assert int(bins.num_cells) == 14
    counts = bins.cell_counts.numpy()
    assert counts.sum() == 28 and (counts[:14] == 2).all() and (counts[14:] == 0).all()
    assert not bool(bins.overflow)


# (box, cutoff, auto_order, dtype): random, elongated along x and along z,
# tied shapes under auto_order, and the benchmark's centred thin box
GRID_CASES = [
    ((10.0, 10.0, 10.0), 1.3, False, np.float64),
    ((10.0, 10.0, 10.0), 1.3, False, np.float32),
    ((50.0, 3.0, 3.0), 1.0, True, np.float32),
    ((3.0, 4.0, 60.0), 1.1, True, np.float64),
    ((10.0, 10.0, 4.0), 1.0, True, np.float32),
    ((30.0, 30.0, 333.3), 10.0, True, np.float32),
]


@pytest.mark.parametrize("box,cutoff,auto_order,dtype", GRID_CASES)
def test_grid_and_keys_match_jax(box, cutoff, auto_order, dtype):
    rng = np.random.default_rng(int(box[2] * 10) + auto_order)
    pts = ((rng.uniform(0, 1, (500, 3)) - 0.5) * np.asarray(box)).astype(dtype)
    want = [np.asarray(x) for x in _jax_grid(jnp.asarray(pts), cutoff, auto_order)]
    got = [x.numpy() for x in _port_grid(pts, cutoff, auto_order)]
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_auto_order_puts_the_long_axis_last():
    pts = np.array([[0.0, 0.0, 0.0], [50.0, 3.0, 3.0]])
    info = tgeo.GridInfo.create(tgeo.aabb_from_positions(pts, device="cpu"), 1.0,
                                auto_order=True)
    # shape [51, 4, 4]: the tied short axes keep axis order
    assert info.shape.tolist() == [51, 4, 4]
    assert info.strides.tolist() == [64, 1, 8]
    assert int(tgeo.key_window(info.strides)) == 73


def test_stencils_match_jax():
    # 2-particle 2D grid -> 8x8 padded board
    pts2 = np.array([[0.0, 0.0], [3.0, 3.0]])
    info2 = tgeo.GridInfo.create(tgeo.aabb_from_positions(pts2, device="cpu"), 1.0)
    assert tgeo.full_stencil(info2).tolist() == [-9, -1, 7, -8, 8, -7, 1, 9]
    assert tgeo.half_stencil(info2).tolist() == [-9, -1, 7, -8]

    pts3 = np.random.default_rng(5).uniform(0, 7, (50, 3))
    info3 = tgeo.GridInfo.create(tgeo.aabb_from_positions(pts3, device="cpu"), 1.0)
    jinfo = jgeo.GridInfo.create(jgeo.aabb_from_positions(jnp.asarray(pts3)), 1.0)
    np.testing.assert_array_equal(tgeo.rel_offsets(3), jgeo.rel_offsets(3))
    full = tgeo.full_stencil(info3).numpy()
    np.testing.assert_array_equal(full, np.asarray(jgeo.full_stencil(jinfo)))
    np.testing.assert_array_equal(tgeo.half_stencil(info3).numpy(),
                                  np.asarray(jgeo.half_stencil(jinfo)))
    np.testing.assert_array_equal(full, -full[::-1])


def test_aabb_ignores_invalid_rows():
    real = np.random.default_rng(3).uniform(0, 5, (20, 3))
    pts = np.vstack([real, np.full((4, 3), 1e9)])
    valid = np.arange(24) < 20
    aabb = tgeo.aabb_from_positions(pts, valid, device="cpu")
    np.testing.assert_array_equal(aabb.inf.numpy(), real.min(0))
    np.testing.assert_array_equal(aabb.sup.numpy(), real.max(0))
    empty = tgeo.aabb_from_positions(pts, np.zeros(24, bool), device="cpu")
    assert empty.inf.tolist() == [0.0, 0.0, 0.0] == empty.sup.tolist()
