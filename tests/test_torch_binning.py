"""Port binning (zelll_tpu_torch.core.binning) against the JAX package's
`bin_and_sort` on the same numpy inputs: sorted keys, the cell table and,
for a stable sort, the permutation, all equal exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from zelll_tpu.core.binning import bin_and_sort as jax_bin_and_sort
from zelll_tpu_torch.core import SENTINEL_KEY, bin_and_sort, build, build_bins

TABLE = ("keys", "sorted_keys", "cell_keys", "cell_counts", "cell_starts",
         "num_cells", "num_valid", "overflow")


@functools.partial(jax.jit, static_argnames=("max_cells", "need_perm", "auto_order"))
def _jax_bins(pts, valid, cutoff, max_cells, need_perm, auto_order):
    return jax_bin_and_sort(pts, cutoff, max_cells=max_cells, valid=valid,
                            need_perm=need_perm, auto_order=auto_order)


def _both(pts, cutoff, *, valid=None, max_cells=None, need_perm=True,
          auto_order=False):
    jvalid = None if valid is None else jnp.asarray(valid)
    jb, jpos = _jax_bins(jnp.asarray(pts), jvalid, cutoff, max_cells, need_perm,
                         auto_order)
    tb, tpos = bin_and_sort(pts, cutoff, valid=valid, max_cells=max_cells,
                            need_perm=need_perm, auto_order=auto_order,
                            device="cpu")
    return jb, np.asarray(jpos), tb, tpos.numpy()


def _assert_table_equal(jb, tb):
    for name in TABLE:
        want, got = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tb.info.strides.numpy(), np.asarray(jb.info.strides))


def test_stable_sort_matches_jax_exactly():
    pts = np.random.default_rng(7).uniform(0, 10, (500, 3))
    jb, jpos, tb, tpos = _both(pts, 1.3)
    _assert_table_equal(jb, tb)
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    np.testing.assert_array_equal(tpos, jpos)


def test_valid_padding_matches_jax():
    rng = np.random.default_rng(3)
    pts = np.vstack([rng.uniform(0, 5, (100, 3)), np.full((28, 3), 1e9)])
    valid = np.arange(128) < 100
    jb, jpos, tb, tpos = _both(pts, 1.0, valid=valid)
    _assert_table_equal(jb, tb)
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    assert int(tb.num_valid) == 100
    assert (tb.sorted_keys.numpy()[100:] == SENTINEL_KEY).all()


def test_overflowing_table_matches_jax():
    pts = np.random.default_rng(11).uniform(0, 6, (300, 3)).astype(np.float32)
    jb, _, tb, _ = _both(pts, 1.0, max_cells=10)
    _assert_table_equal(jb, tb)
    assert bool(tb.overflow) and int(tb.num_cells) > 10


def _cell_members(keys, sorted_pos):
    """{cell key: sorted rows of that cell's coordinates}"""
    out = {}
    for k in np.unique(keys):
        rows = sorted_pos[keys == k]
        out[int(k)] = rows[np.lexsort(rows.T[::-1])]
    return out


def test_unstable_sort_keeps_cell_membership():
    # the benchmark's thin box, f32, auto_order strides, no permutation
    rng = np.random.default_rng(2)
    pts = ((rng.uniform(0, 1, (900, 3)) - 0.5) * [30.0, 30.0, 100.0]).astype(np.float32)
    jb, jpos, tb, tpos = _both(pts, 10.0, max_cells=1, need_perm=False,
                               auto_order=True)
    np.testing.assert_array_equal(tb.sorted_keys.numpy(), np.asarray(jb.sorted_keys))
    np.testing.assert_array_equal(tb.perm.numpy(), np.arange(900))
    want = _cell_members(np.asarray(jb.sorted_keys), jpos)
    got = _cell_members(tb.sorted_keys.numpy(), tpos)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_cell_table_is_consistent_csr():
    pts = np.random.default_rng(7).uniform(0, 10, (500, 3))
    bins = build_bins(pts, 1.3, device="cpu")
    nc = int(bins.num_cells)
    keys, starts = bins.cell_keys.numpy(), bins.cell_starts.numpy()
    counts, sk = bins.cell_counts.numpy(), bins.sorted_keys.numpy()
    assert (np.diff(keys[:nc]) > 0).all() and (keys[nc:] == SENTINEL_KEY).all()
    np.testing.assert_array_equal(starts[:nc], np.cumsum(counts[:nc]) - counts[:nc])
    for c in range(nc):
        assert (sk[starts[c]:starts[c] + counts[c]] == keys[c]).all()


def test_stable_order_within_cells_and_unsort():
    pts = np.random.default_rng(4).uniform(0, 3, (200, 3))
    grid = build(pts, 1.0, device="cpu")
    perm, keys = grid.bins.perm.numpy(), grid.bins.keys.numpy()
    for c in np.unique(keys):
        assert (np.diff(perm[keys[perm] == c]) > 0).all()
    np.testing.assert_array_equal(grid.unsort(grid.sorted_pos).numpy(), pts)


@pytest.mark.parametrize("n", [0, 1])
def test_zero_and_one_particle(n):
    pts = np.arange(3 * n, dtype=np.float64).reshape(n, 3)
    bins = build_bins(pts, 1.0, device="cpu")
    assert int(bins.num_cells) == n
    assert bins.cell_counts.tolist()[0] == n

