"""The smooth distance field (`zelll_tpu_torch.models.sdf`, on the CPU: the
join's plain version and the gather path with torch autograd) against the
reference's 10-point goldens (tests/test_sdf.py, numdual.rs:107-192), the
JAX package's `SmoothDistanceField` (both methods, n = 300), and the 12 SDF
sums straight from the math.

Tolerances: the goldens' own (1e-12 on values, 1e-10 on gradients); the
JAX field to 1e-12 relative on values and 1e-10 on gradients where the
field is defined (the same terms in another order); the sums to 1e-12 of
each column's largest.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.models.sdf import SmoothDistanceField as JaxField
from zelll_tpu_torch.models import sdf as port_sdf
from zelll_tpu_torch.models.sdf import ELEMENT_RADII, SmoothDistanceField
from zelll_tpu_torch.ops import join
from zelll_tpu_torch.ops.sdf_join import NACC, sdf_join_sums
from zelll_tpu_torch.ops.join import sort_queries
from zelll_tpu_torch.utils.datagen import synthetic_protein

from test_sdf import POINTS, REF_GRADS, REF_VALUES


def _field(pos, radii=None, cutoff=1.0, **kw):
    return SmoothDistanceField(pos, radii, cutoff=cutoff, device="cpu", **kw)


@pytest.mark.parametrize("method", ["join", "xla"])
def test_goldens_and_harmonic_potential(method):
    """The reference's 10-point cube (queries at the atoms: d == 0) through
    both paths, and `hmc_gradient` = -k (sdf - iso)^2 with its gradient."""
    sdf = _field(POINTS, np.full(10, ELEMENT_RADII["C"]), method=method)
    vals, grads, ok = sdf.evaluate(POINTS)
    assert ok.all()
    np.testing.assert_allclose(vals, REF_VALUES, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(grads, REF_GRADS, rtol=1e-10, atol=1e-12)
    pot, gpot, ok = sdf.hmc_gradient(POINTS)
    sv, sg = np.asarray(REF_VALUES), np.asarray(REF_GRADS)
    np.testing.assert_allclose(pot, -10.0 * (sv - 1.05) ** 2, rtol=1e-10)
    np.testing.assert_allclose(gpot, -20.0 * (sv - 1.05)[:, None] * sg,
                               rtol=1e-8, atol=1e-12)
    assert ok.all()


@pytest.mark.parametrize("method", ["join", "xla"])
def test_matches_jax_field(method):
    """A 300-atom structure, cutoff 2, queries inside, around and far from
    it and at atoms: the port's field against the JAX package's with the
    same method, and the port's two methods against each other."""
    pos, radii = synthetic_protein(300, 8.0, seed=2)
    rng = np.random.default_rng(3)
    queries = np.concatenate([rng.uniform(-9, 9, (80, 3)),
                              rng.uniform(-30, 30, (10, 3)), pos[:3],
                              [[1e9, -1e9, 1e9]]])
    a = JaxField(pos, radii, cutoff=2.0, method=method)
    b = _field(np.array(a.data.grid.sorted_pos), np.array(a.data.radii_sorted[:-1]),
               2.0, method=method)
    va, ga, oka = a.evaluate(queries)
    vb, gb, okb = b.evaluate(queries)
    np.testing.assert_array_equal(oka, okb)
    defined = oka & ~np.isnan(va)
    np.testing.assert_array_equal(defined, okb & ~np.isnan(vb))
    assert defined.sum() > 40 and not okb[-1]
    np.testing.assert_allclose(vb[defined], va[defined], rtol=1e-12)
    np.testing.assert_allclose(gb[defined], ga[defined], rtol=1e-10, atol=1e-13)
    pa, gpa, _ = a.hmc_gradient(queries)
    pb, gpb, _ = b.hmc_gradient(queries)
    np.testing.assert_allclose(pb[defined], pa[defined], rtol=1e-12)
    np.testing.assert_allclose(gpb[defined], gpa[defined], rtol=1e-10, atol=1e-12)
    other = _field(pos, radii, 2.0, method="xla" if method == "join" else "join")
    vo, go, _ = other.evaluate(queries)
    np.testing.assert_allclose(vo[defined], vb[defined], rtol=1e-12)
    np.testing.assert_allclose(go[defined], gb[defined], rtol=1e-9, atol=1e-13)


def _brute_sums(queries, pos, radii, cutoff):
    """The 12 sums straight from the math (numdual.rs:11-61)."""
    out = np.zeros((len(queries), NACC))
    for qi, x in enumerate(queries):
        d_vec = x[None, :] - pos
        dsq = (d_vec**2).sum(-1)
        within = dsq <= cutoff**2
        live = within & (dsq > 0)
        d = np.sqrt(np.where(live, dsq, 1.0))
        e1 = np.where(live, np.exp(-d / radii), 0.0)
        e3 = np.where(live, np.exp(-d), 0.0)
        z = (within & (dsq == 0)).astype(float)
        u = d_vec / d[:, None]
        out[qi, 0] = (e1 + z).sum()
        out[qi, 1] = ((e3 + z) * radii).sum()
        out[qi, 2] = (e3 + z).sum()
        out[qi, 3:6] = ((e1 / radii)[:, None] * u).sum(0)
        out[qi, 6:9] = ((e3 * radii)[:, None] * u).sum(0)
        out[qi, 9:12] = (e3[:, None] * u).sum(0)
    return out


def test_sdf_join_sums_match_bruteforce():
    """`sdf_join_sums` on sorted CPU tensors against the 12 sums of the
    math, with queries at atoms (d == 0) and exactly at the cutoff."""
    pos, radii = synthetic_protein(500, 9.0, seed=4)
    pos = np.round(pos * 1024) / 1024
    cutoff = 3.0
    rng = np.random.default_rng(5)
    queries = np.concatenate([rng.uniform(-10, 10, (150, 3)), pos[:5],
                              pos[5:10] + [0.0, 0.0, cutoff]])
    sdf = _field(pos, radii, cutoff)
    jd = sdf._join
    qpl, qk, perm, valid = sort_queries(torch.as_tensor(queries), jd.origin,
                                        jd.shape, jd.strides, cutoff,
                                        torch.float64, torch.device("cpu"))
    sums, ok = sdf_join_sums(qpl, qk, jd.pplanes, jd.pkeys, jd.strides, cutoff**2)
    assert bool(ok)
    ref = _brute_sums(queries[perm.numpy()], pos, radii, cutoff)
    scale = np.abs(ref).max(0) + 1e-300
    np.testing.assert_allclose(sums.numpy() / scale, ref / scale, rtol=0, atol=1e-12)


def test_far_queries_radii_and_fallback(monkeypatch):
    """Queries at +-1e9 are invalid and see no atom (the cell index is
    clipped before the integer conversion); a hydrogen changes the field;
    a failed join flag falls back to the gather path, which answers, and
    is counted."""
    sdf = _field(POINTS, method="join")
    v, g, ok = sdf.evaluate(np.array([[1e9, 1e9, 1e9], [0.5, 0.5, 0.5],
                                      [-1e9, 1e9, -1e9]]))
    assert ok.tolist() == [False, True, False] and np.isfinite(v[1])
    r = np.full(10, 1.70)
    r[0] = 1.09
    va, _, _ = _field(POINTS, r).evaluate(POINTS[:1])
    vb, _, _ = _field(POINTS).evaluate(POINTS[:1])
    assert abs(float(va[0]) - float(vb[0])) > 1e-6

    sdf = _field(POINTS, np.full(10, 1.70))
    real = port_sdf._sdf_join_batch

    def flagged(*args, **kw):
        v, g, valid, ok = real(*args, **kw)
        return v, g, valid, torch.zeros_like(ok)

    monkeypatch.setattr(port_sdf, "_sdf_join_batch", flagged)
    before = join.join_reduce.fallbacks
    vals, grads, ok = sdf.evaluate(POINTS)
    assert join.join_reduce.fallbacks == before + 1 and ok.all()
    np.testing.assert_allclose(vals, REF_VALUES, rtol=1e-12)
    np.testing.assert_allclose(grads, REF_GRADS, rtol=1e-10, atol=1e-12)


def test_hmc_vgrad_fn_matches_hmc_gradient():
    """The samplers' batched (logp, grad) equals `hmc_gradient` where the
    field is defined and is (-inf, 0) elsewhere; it refuses structures
    above the JAX kernel's 131072-atom ceiling, as the JAX package does."""
    pos, radii = synthetic_protein(400, 9.0, seed=6)
    sdf = _field(pos, radii, 4.0)
    rng = np.random.default_rng(7)
    q = np.concatenate([rng.uniform(-12, 12, (100, 3)), [[1e9, 0.0, 0.0]]])
    logp, grad = sdf.hmc_vgrad_fn()(torch.as_tensor(q))
    pot, gpot, ok = sdf.hmc_gradient(q)
    defined = ok & np.isfinite(pot)
    assert 20 < defined.sum() < len(q)
    np.testing.assert_array_equal(logp.numpy()[defined], pot[defined])
    np.testing.assert_array_equal(grad.numpy()[defined], gpot[defined])
    assert np.isneginf(logp.numpy()[~defined]).all()
    assert not grad.numpy()[~defined].any()
    big = _field(np.random.default_rng(8).uniform(0, 110, (join.JOIN_MAX_PARTICLES + 1, 3)),
                 cutoff=4.0)
    with pytest.raises(ValueError, match="131072"):
        big.hmc_vgrad_fn()


def test_windowed_large_structure():
    """Above 131072 atoms the plain join runs the JAX package's windowed
    form (capacity ladder on its flag); key-local queries match the sums of
    the math."""
    n = join.JOIN_MAX_PARTICLES + 5000
    side = (n / 0.1) ** (1 / 3)
    pos = np.random.default_rng(9).uniform(0, side, (n, 3))
    radii = np.random.default_rng(10).uniform(1.0, 2.0, n)
    sdf = _field(pos, radii, 3.0)
    queries = np.asarray([40.0, 40.5, 40.5]) + np.random.default_rng(11).uniform(
        0, 1, (40, 3)) * [12.0, 1.5, 1.5]
    vals, grads, ok = sdf.evaluate(queries)
    assert ok.all() and sdf._join_maxj is not None
    ref = _brute_sums(queries, pos, radii, 3.0)
    sigma = ref[:, 1] / ref[:, 2]
    lns1 = np.log(ref[:, 0])
    np.testing.assert_allclose(vals, -sigma * lns1, rtol=1e-12)
    g = (lns1[:, None] * (ref[:, 6:9] * ref[:, 2:3] - ref[:, 1:2] * ref[:, 9:12])
         / (ref[:, 2:3] ** 2) + (sigma / ref[:, 0])[:, None] * ref[:, 3:6])
    np.testing.assert_allclose(grads, g, rtol=1e-9, atol=1e-12)
