"""Pair potentials and species in the port (zelll_tpu_torch.ops.potentials,
models.lj_md's species MD, ops.pbc's species forces and its sorted-extremes
fast path; plain versions of the kernels on CPU tensors), against the JAX
package (f64, Pallas in interpret mode) and an f64 brute force.

Tolerances: each factory's term and force factor to 1e-12 of its largest
value against the JAX package's (the same formulas, operations in another
order); the force factor to 1e-9 of its scale against autograd's
-2 dV/d(dsq); fused energies and forces through the lag and tile plain
paths to 1e-9 of the sum of |term| (or of the largest force) against an
f64 brute force, as the JAX package's own test holds its kernels; species
MD, species PBC forces and the sorted-extremes path to 1e-9 relative
against the JAX package (sums in another order through unstable sorts);
pair counts, flags and the species rule exact. JAX runs under jax.jit,
one executable per call (ROADMAP Tier-1 budget).

The differentiable potentials (`ops.autodiff.make_pair_potential`) mirror
tests/test_autodiff.py: energies to 1e-9 and gradients to 1e-8 against an
f64 brute force (relative, as there), split gradients to 2e-6 of the
largest force, `gfn_from_term` and a factory's default gfn to 1e-12 of the
largest factor, `torch.func.grad` against `torch.autograd.grad` to 1e-12,
and one jitted call of the JAX package's `make_pair_potential` to 1e-9."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_slab
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

import zelll_tpu.ops.pbc as jpbc
import zelll_tpu.ops.potentials as JP
from zelll_tpu.ops.autodiff import make_pair_potential as jax_make_pair_potential
from zelll_tpu.models import lj_md as jax_md
from zelll_tpu_torch.convert import md_state_from_numpy
from zelll_tpu_torch.core.binning import bin_and_sort
from zelll_tpu_torch.models import lj_md
from zelll_tpu_torch.ops import gfn_from_term, lj_force_factor, make_pair_potential, pbc
from zelll_tpu_torch.ops import potentials as P
from zelll_tpu_torch.ops.lag_pairs import (
    PbcKeepTerm,
    combine_count,
    count_term,
    lag_coverage_ok,
    lj_term,
    pair_lag_forces,
    pair_lag_reduce,
    suggest_lag,
    term_spec,
)
from zelll_tpu_torch.ops.tile_pairs import tile_pair_forces, tile_pair_reduce
from zelll_tpu_torch.ops.virial import virial_term_from_gfn

F64 = torch.float64
# the JAX package's test parameters (tests/test_potentials.py)
ALL = [
    ("lennard_jones", (0.7, 1.1), {}),
    ("wca", (0.7, 1.1), {}),
    ("soft_sphere", (0.5, 1.2), {"n": 8}),
    ("gaussian", (2.0, 0.8), {}),
    ("morse", (1.3, 2.0, 1.1), {}),
    ("yukawa", (1.5, 0.7), {}),
    ("buckingham", (1000.0, 0.3, 1.0), {}),
    ("harmonic", (3.0, 1.0), {}),
]
MIXED = ((1.0, 0.5, 0.8), (1.0, 1.2, 0.9))


def jittered_lattice(shape, seed=5):
    """The JAX package's potential lattice: spacing 1.25, +-0.2."""
    cells = np.stack(np.meshgrid(*[np.arange(k) for k in shape], indexing="ij"), -1)
    pts = (cells.reshape(-1, 3) + 0.5) * 1.25
    return pts + np.random.default_rng(seed).uniform(-0.2, 0.2, pts.shape)


def sorted_rows(*cols):
    a = np.concatenate([np.asarray(c, np.float64).reshape(len(c), -1) for c in cols], 1)
    return a[np.lexsort(a.T[::-1])]


def lj_np(dsq):
    inv = 1.0 / dsq
    i6 = inv * inv * inv
    return 4.0 * (i6 * i6 - i6)


def dlj_np(dsq):
    # dV/d(dsq) with V = 4 (t^2 - t), t = dsq^-3: -12 t (2t - 1) / dsq
    inv = 1.0 / dsq
    i6 = inv * inv * inv
    return -12.0 * i6 * (2.0 * i6 - 1.0) * inv


def brute_energy_forces(pts, cutoff, term, dterm):
    """tests/test_autodiff.py's O(n^2) f64 oracle: E = sum term(dsq),
    f_i = -dE/dp_i."""
    n = len(pts)
    d = pts[:, None, :] - pts[None, :, :]
    dsq = (d * d).sum(-1)
    mask = (dsq < cutoff**2) & ~np.eye(n, dtype=bool)
    e = 0.5 * (np.where(mask, term(np.where(mask, dsq, 1.0)), 0.0)).sum()
    w = np.where(mask, dterm(np.where(mask, dsq, 1.0)), 0.0)
    return e, -2.0 * (w[:, :, None] * d).sum(axis=1)


def value_and_grad(pot, pts, **kw):
    """((E, ok), dE/dp) of a port potential on f64 CPU positions."""
    x = torch.as_tensor(pts, **kw).requires_grad_(True)
    e, ok = pot(x)
    (g,) = torch.autograd.grad(e, x)
    return (e.detach(), ok), g


def check_autodiff():
    """tests/test_autodiff.py's seven checks on the port's potential (CPU
    tensors: the plain versions of K1, K3, K6 and K7), a factory's default
    gfn, and one case against the JAX package's potential."""
    # the LJ gradient is minus the brute-force forces, on both paths
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 1, (500, 3)) * np.array([4.0, 4.0, 6.0])
    e_ref, f_ref = brute_energy_forces(pts, 1.0, lj_np, dlj_np)
    for path in ("lag", "tile"):
        pot = make_pair_potential(1.0, path=path, M=512, L=512, MAXJ=8)
        (e, ok), g = value_and_grad(pot, pts)
        assert bool(ok) and e.dtype == F64 and g.dtype == F64
        np.testing.assert_allclose(float(e), e_ref, rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), -f_ref, rtol=1e-8, atol=1e-10)
        # torch.func.grad composes with the autograd.Function
        gf, ok_f = torch.func.grad(pot, has_aux=True)(torch.as_tensor(pts))
        assert bool(ok_f)
        np.testing.assert_allclose(gf.numpy(), g.numpy(), rtol=1e-12, atol=0)

    # a custom term with the force factor derived by autodiff
    def soft(dsq):
        return (1.0 - dsq) ** 2

    def dsoft(dsq):
        return -2.0 * (1.0 - dsq)

    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 1, (300, 3)) * 4.0
    e_ref, f_ref = brute_energy_forces(pts, 1.0, soft, dsoft)
    (e, ok), g = value_and_grad(make_pair_potential(1.0, term=soft, path="tile", MAXJ=8), pts)
    assert bool(ok)
    np.testing.assert_allclose(float(e), e_ref, rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), -f_ref, rtol=1e-8, atol=1e-12)

    # gfn_from_term matches the handwritten LJ factor
    dsq = torch.as_tensor(np.linspace(0.3, 2.0, 64))
    np.testing.assert_allclose(gfn_from_term(lj_term)(dsq).numpy(),
                               lj_force_factor(dsq).numpy(), rtol=1e-12)

    # the 2-D tile path
    rng = np.random.default_rng(13)
    pts = rng.uniform(0, 1, (250, 2)) * 5.0
    _, f_ref = brute_energy_forces(pts, 1.0, lj_np, dlj_np)
    (_, ok), g = value_and_grad(make_pair_potential(1.0, path="tile", MAXJ=8), pts)
    assert bool(ok)
    np.testing.assert_allclose(g.numpy(), -f_ref, rtol=1e-8, atol=1e-10)

    # an undersized forces capacity poisons the whole gradient with NaN
    rng = np.random.default_rng(17)
    pts = rng.uniform(0, 1, (1500, 3)) * 5.0
    (_, ok), g = value_and_grad(make_pair_potential(1.0, path="tile", MAXJ=8, MAXJ_F=1), pts)
    assert bool(ok) and bool(torch.isnan(g).all())

    # split gradients in a box 1e4 from the origin, f64-grade
    rng = np.random.default_rng(23)
    pts = rng.uniform(0, 1, (400, 3)) * np.array([3.0, 3.0, 40.0])
    pts[:, 2] += 1e4
    e_ref, f_ref = brute_energy_forces(pts, 1.0, lj_np, dlj_np)
    scale = np.abs(f_ref).max()
    for path in ("lag", "tile"):
        pot = make_pair_potential(1.0, path=path, M=256, L=128, MAXJ=8, split=True)
        (e, ok), g = value_and_grad(pot, pts)
        assert bool(ok)
        np.testing.assert_allclose(float(e), e_ref, rtol=1e-6)
        np.testing.assert_allclose(g.numpy() / scale, -f_ref / scale, atol=2e-6)

    # a factory's term (and a shifted one) takes the factory's own gfn,
    # which equals the one autodiff derives; through the potential, the
    # gradient is minus the brute-force forces of that gfn
    dsq = np.linspace(0.6, 4.0, 61) ** 2
    for name, args, kw in ALL + [("shifted", (), {})]:
        pt = (P.shifted(P.lennard_jones(), 2.5) if name == "shifted"
              else getattr(P, name)(*args, **kw))
        assert P.factory_gfn(pt.term) is pt.gfn
        want = pt.gfn(torch.as_tensor(dsq)).numpy()
        got = gfn_from_term(pt.term)(torch.as_tensor(dsq)).numpy()
        keep = np.abs(dsq - 2.0 ** (1 / 3) * 1.1**2) > 1e-2 if name == "wca" else slice(None)
        np.testing.assert_allclose(got[keep], want[keep], rtol=0,
                                   atol=1e-12 * np.abs(want).max(), err_msg=name)
    assert P.factory_gfn(lj_term) is None and P.factory_gfn(P.morse().gfn) is None
    pot = P.morse(1.3, 2.0, 1.1)
    pts = jittered_lattice((3, 3, 8), seed=9)
    e_ref, f_ref = brute_energy_forces(
        pts, 2.5, lambda d: pot.term(torch.as_tensor(d)).numpy(),
        lambda d: -0.5 * pot.gfn(torch.as_tensor(d)).numpy())
    (e, ok), g = value_and_grad(make_pair_potential(2.5, term=pot.term, L=512), pts)
    assert bool(ok)
    assert abs(float(e) - e_ref) <= 1e-9 * abs(e_ref)
    np.testing.assert_allclose(g.numpy(), -f_ref, rtol=0, atol=1e-9 * np.abs(f_ref).max())
    with pytest.raises(ValueError, match="species plane"):
        make_pair_potential(2.5, term=P.lennard_jones_mixed(*MIXED).term)

    # the JAX package's own potential, jitted (Pallas in interpret mode)
    rng = np.random.default_rng(19)
    pts = rng.uniform(0, 1, (200, 3)) * 4.0
    jpot = jax_make_pair_potential(1.0, path="lag", M=256, L=128, interpret=True)
    (e_j, ok_j), g_j = jax.jit(jax.value_and_grad(jpot, has_aux=True))(jnp.asarray(pts))
    (e, ok), g = value_and_grad(make_pair_potential(1.0, path="lag", L=128), pts)
    assert bool(ok) and bool(ok_j)
    assert abs(float(e) - float(e_j)) <= 1e-9 * abs(float(e_j))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=0, atol=1e-9 * np.abs(g_j).max())


def test_potentials_match_jax():
    """Every factory's term and gfn against the JAX package's (to 1e-12),
    gfn = -2 dV/d(dsq) by autograd, the cache identity, the device spec
    each function carries (the virial mode of `virial_term_from_gfn`),
    `shifted`'s continuity at the cutoff, its constant computed in f64 and
    its ValueError on a payload potential, `lennard_jones_mixed`'s species
    rule on 0, 1, S - 1, S, -1 and 0.5 against the JAX package's, and the
    fused energy and forces of every factory (and the mixed pair over a
    species column) through the lag and tile plain paths against an f64
    brute force (the JAX package's test_fused_energy_and_forces_all_paths);
    then the differentiable potentials (`check_autodiff`) and their
    sharded form with the species energy of the slab decomposition
    (`torch_slab.potentials`)."""
    dsq = np.linspace(0.6, 4.0, 61) ** 2
    pots = {}
    for name, args, kw in ALL:
        pj, pt = getattr(JP, name)(*args, **kw), getattr(P, name)(*args, **kw)
        assert pt is getattr(P, name)(*args, **kw)
        pots[name] = pt
        for f in ("term", "gfn"):
            want = np.asarray(jax.jit(getattr(pj, f))(jnp.asarray(dsq)))
            got = getattr(pt, f)(torch.as_tensor(dsq)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max(),
                                       err_msg=f"{name}.{f}")
        # gfn = -2 dV/d(dsq) (the WCA cut point itself is one-sided)
        x = torch.as_tensor(dsq).requires_grad_(True)
        (dv,) = torch.autograd.grad(pt.term(x).sum(), x)
        want, got = (-2.0 * dv).numpy(), pt.gfn(torch.as_tensor(dsq)).numpy()
        keep = np.abs(dsq - 2.0 ** (1 / 3) * 1.1**2) > 1e-2 if name == "wca" else slice(None)
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max(), err_msg=name)
        spec = term_spec(pt.gfn)
        assert term_spec(pt.term).mode == P.MODE_ENERGY and spec.mode == P.MODE_GFN
        assert term_spec(virial_term_from_gfn(pt.gfn)) == spec._replace(mode=P.MODE_VIRIAL)
    # shifted: V(cutoff) - V(cutoff) = 0 at the cut, forces unchanged
    for cut in (1.8, 2.5):
        sj, st = JP.shifted(JP.lennard_jones(), cut), P.shifted(P.lennard_jones(), cut)
        assert st is P.shifted(P.lennard_jones(), cut) and st.gfn is P.lennard_jones().gfn
        c2 = torch.tensor([cut**2], dtype=F64)
        assert abs(float(st.term(c2))) <= 1e-15
        np.testing.assert_allclose(st.term(torch.as_tensor(dsq)).numpy(),
                                   np.asarray(jax.jit(sj.term)(jnp.asarray(dsq))), rtol=0,
                                   atol=1e-12)
        assert term_spec(st.term).shift == float(P.lennard_jones().term(c2))
    mixed_t, mixed_j = P.lennard_jones_mixed(*MIXED), JP.lennard_jones_mixed(*MIXED)
    with pytest.raises(ValueError, match="scalar-dsq"):
        P.shifted(mixed_t, 2.5)
    # the species rule: 0, 1, S - 1 = 2, S = 3, -1 and 0.5 (the last three
    # take species 0's parameters, as in the JAX package)
    vals = np.array([0.0, 1.0, 2.0, 3.0, -1.0, 0.5])
    si, sj = (v.ravel() for v in np.meshgrid(vals, vals))
    d = np.full(si.shape, 1.3)
    for f in ("term", "gfn"):
        want = np.asarray(jax.jit(getattr(mixed_j, f))(jnp.asarray(d), jnp.asarray(si),
                                                         jnp.asarray(sj)))
        got = getattr(mixed_t, f)(*(torch.as_tensor(v) for v in (d, si, sj))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0, err_msg=f)
    odd = np.array([3.0, -1.0, 0.5])
    zero = mixed_t.term(torch.full((3,), 1.3, dtype=F64), torch.as_tensor(odd),
                        torch.zeros(3, dtype=F64))
    assert torch.equal(zero, mixed_t.term(torch.full((3,), 1.3, dtype=F64),
                                          torch.zeros(3, dtype=F64), torch.zeros(3, dtype=F64)))
    table = np.asarray(P.species_table(term_spec(mixed_t.term)), np.float32).reshape(3, 3, 2)
    assert table[1, 2, 0] == np.sqrt(np.float32(0.5) * np.float32(0.8))
    assert table[1, 2, 1] == np.float32(0.5) * (np.float32(1.2) + np.float32(0.9))
    with pytest.raises(ValueError, match="at most 16"):
        P.species_table(term_spec(P.lennard_jones_mixed((1.0,) * 17, (1.0,) * 17).term))

    # fused energy and forces against an f64 brute force
    cutoff = 2.5
    pts = jittered_lattice((4, 4, 18))
    spec = np.random.default_rng(6).integers(0, 3, len(pts)).astype(np.float64)
    bins, cols = bin_and_sort(torch.as_tensor(np.concatenate([pts, spec[:, None]], 1)),
                              cutoff, max_cells=1, need_perm=False)
    sp, ss = cols[:, :3].contiguous(), cols[:, 3:]
    keys, strides = bins.sorted_keys, bins.info.strides
    assert bool(lag_coverage_ok(keys, strides, 512))
    spn, ssn = sp.numpy(), ss[:, 0].numpy()
    dd = spn[:, None] - spn[None]
    dsq2 = (dd * dd).sum(-1)
    np.fill_diagonal(dsq2, np.inf)
    within = dsq2 < cutoff**2
    upper = np.triu(within)
    safe = torch.as_tensor(np.where(within, dsq2, 1.0))
    si_, sj_ = (torch.as_tensor(v) for v in np.broadcast_arrays(ssn[:, None], ssn[None]))
    cases = [(name, pot.term, pot.gfn, None, (safe,)) for name, pot in pots.items()]
    cases.append(("shifted", P.shifted(P.lennard_jones(), cutoff).term,
                  P.lennard_jones().gfn, None, (safe,)))
    cases.append(("mixed", mixed_t.term, mixed_t.gfn, ss, (safe, si_, sj_)))
    for name, term, gfn, pay, ref_args in cases:
        vd = term(*ref_args).numpy()
        e_ref = float(np.where(upper, vd, 0.0).sum())
        scale = np.abs(np.where(upper, vd, 0.0)).sum()
        g = np.where(within, gfn(*ref_args).numpy(), 0.0)
        f_ref = (g[..., None] * dd).sum(1)
        fscale = np.abs(f_ref).max()
        e_lag = pair_lag_reduce(sp, keys, strides, cutoff**2, None, pay, L=512, term=term)
        e_tile, ok = tile_pair_reduce(sp, keys, strides, cutoff**2, None,
                                      None if pay is None else pay[:, 0], MAXJ=16, term=term)
        assert bool(ok)
        for e in (e_lag, e_tile):
            assert abs(float(e) - e_ref) <= 1e-9 * scale, name
        f_lag = pair_lag_forces(sp, keys, strides, cutoff**2, None, pay, L=512, gfn=gfn)
        assert np.abs(f_lag.numpy() - f_ref).max() <= 1e-9 * fscale, name
        if pay is None:
            f_tile, ok = tile_pair_forces(sp, keys, strides, cutoff**2, MAXJ=16, gfn=gfn)
            assert bool(ok) and np.abs(f_tile.numpy() - f_ref).max() <= 1e-9 * fscale, name
        if pay is None:
            w = pair_lag_reduce(sp, keys, strides, cutoff**2, L=512,
                                term=virial_term_from_gfn(gfn))
            w_ref = float(np.where(upper, gfn(safe).numpy() * np.where(within, dsq2, 0.0),
                                   0.0).sum())
            assert abs(float(w) - w_ref) <= 1e-9 * max(abs(w_ref), fscale), name
    check_autodiff()
    torch_slab.potentials()


@functools.partial(jax.jit, static_argnames=("box", "mi", "pot"))
def _jax_pbc_species(pts, spec, *, box, mi, pot):
    return jpbc.pbc_lj_forces(pts, [0.0] * 3, np.array(box), 2.5, gfn=pot.gfn, species=spec,
                              minimage=mi, L=512, interpret=True)


@functools.partial(jax.jit, static_argnames=("box", "B"))
def _jax_sorted_extremes(pts, *, box, B):
    bins, sp, _, w, _, _, ok = jpbc._minimage_bins_sorted_extremes(
        pts, [0.0] * 3, np.array(box), 1.0, np.array([True, True, False]), B=B,
        positions_lo=None, need_perm=False)
    return bins.sorted_keys, sp, w, ok


def test_species_md_pbc_and_sorted_extremes_match_jax():
    """`md_step_species` / `md_run_species` over 3 steps from the same
    sorted state and species column (`convert.md_state_from_numpy`), and
    `pbc_lj_forces(species=)` with ``minimage`` False and "auto", against
    the JAX package (to 1e-9; states as sets of rows); ``path="tile"``
    with species raises as there. The sorted-extremes path of
    `_minimage_bins` (one ghost axis, the longest, n >= 512) against the
    JAX package's `_minimage_bins_sorted_extremes` (keys and flag exact,
    rows as sets) and against the port's general path (pair count exact,
    energy to 1e-12), its flags where B or the merge region B2 overflow
    (a top cell too full for B2 while every face fits B), and its refusal
    of B = 2^18 rows, which the dispatch sends to the general path."""
    # species MD, 3 steps
    pts = jittered_lattice((4, 4, 12), seed=0)
    rng = np.random.default_rng(0)
    vel = rng.normal(0, 0.1, pts.shape)
    spec = rng.integers(0, 2, len(pts)).astype(np.float64)
    pj, pt = JP.lennard_jones_mixed(*MIXED), P.lennard_jones_mixed(*MIXED)
    st_j, sp_j, ok_j, e_j = jax_md.md_run_species(
        jax_md.MDState(jnp.asarray(pts), jnp.asarray(vel)), jnp.asarray(spec), 2.5, 1e-3,
        pot=pj, steps=3, M=512, L=512, interpret=True)
    st0, sp0 = md_state_from_numpy(pts, vel, species=spec, device="cpu")
    st_t, sp_t, ok_t, e_t = lj_md.md_run_species(st0, sp0, 2.5, 1e-3, pot=pt, steps=3, L=512)
    assert bool(ok_j) and bool(ok_t)
    np.testing.assert_allclose(sorted_rows(st_t.positions, st_t.velocities, sp_t),
                               sorted_rows(st_j.positions, st_j.velocities, sp_j),
                               rtol=1e-9, atol=1e-12)
    assert abs(float(e_t) - float(e_j)) <= 1e-9 * abs(float(e_j))
    # one step on its own returns the species in the new sorted order
    st1, sp1, ok1 = lj_md.md_step_species(st0, sp0, 2.5, 1e-3, pot=pt, L=512)
    assert bool(ok1) and sorted(sp1.tolist()) == sorted(spec.tolist())
    bins, cols = bin_and_sort(torch.cat([st0.positions, st0.velocities, sp0[:, None]], 1),
                              2.5, max_cells=1, need_perm=False)
    assert torch.equal(sp1, cols[:, 6])

    # species PBC forces: ghost images on every axis, and the minimum image
    box = np.array([6.25, 6.25, 15.0])
    for mi in (False, "auto"):
        fj, okj = _jax_pbc_species(jnp.asarray(np.mod(pts, box)), jnp.asarray(spec),
                                   box=tuple(box), mi=mi, pot=pj)
        ft, okt = pbc.pbc_lj_forces(torch.as_tensor(np.mod(pts, box)), [0.0] * 3, box, 2.5,
                                    gfn=pt.gfn, species=torch.as_tensor(spec), minimage=mi,
                                    L=512)
        assert bool(okj) and bool(okt), mi
        fj = np.asarray(fj)
        assert np.abs(ft.numpy() - fj).max() <= 1e-9 * np.abs(fj).max(), mi
    with pytest.raises(ValueError, match="run on the lag path"):
        pbc.pbc_lj_forces(torch.as_tensor(pts), [0.0] * 3, box, 2.5, gfn=pt.gfn,
                          species=torch.as_tensor(spec), path="tile")

    # the sorted-extremes path: the thin box, one ghost axis (z, the longest)
    box = np.array([3.0, 3.2, 14.5])
    rng = np.random.default_rng(3)
    uni = rng.uniform(0, 1, (1500, 3)) * box
    mask = np.array([True, True, False])
    P_ = torch.as_tensor(uni)
    # B = 30 overflows the faces: both flags go False
    out = pbc._minimage_bins(P_, [0.0] * 3, box, 1.0, mask, B=30, G=None,
                             positions_lo=None, need_perm=False)
    assert not bool(out[6]) and not bool(_jax_sorted_extremes(jnp.asarray(uni),
                                                             box=tuple(box), B=30)[3])
    fast = pbc._minimage_bins(P_, [0.0] * 3, box, 1.0, mask, B=None, G=None,
                              positions_lo=None, need_perm=True)
    gen = pbc._minimage_bins_general(P_, [0.0] * 3, box, 1.0, mask, B=None, G=None,
                                     positions_lo=None, need_perm=True)
    Bj = pbc.suggest_pbc_capacity(1500, box, 1.0, axes=~mask)[0]
    kj, spj, wj, okj = _jax_sorted_extremes(jnp.asarray(uni), box=tuple(box), B=Bj)
    assert bool(fast[6]) and bool(okj) and bool(gen[6])
    # the real rows and the images equal, keys and all; the padding rows
    # (far-spread, keys of their own families) follow the order among equal
    # keys of each package's unstable sort, so they are left out
    live_t = (fast[1][:, 0] < 1e12).numpy()
    live_j = np.asarray(spj)[:, 0] < 1e12
    np.testing.assert_array_equal(
        sorted_rows(fast[0].sorted_keys[live_t], fast[1][live_t], fast[3][live_t]),
        sorted_rows(np.asarray(kj)[live_j], np.asarray(spj)[live_j], np.asarray(wj)[live_j]))
    assert np.all(np.diff(fast[0].sorted_keys.numpy()) >= 0)
    # real rows un-sort to the input, ghosts carry perm >= n
    perm = fast[0].perm
    real = perm < 1500
    assert torch.equal(torch.sort(perm[real])[0], torch.arange(1500))
    assert torch.equal(fast[1][real], pbc.wrap_positions(P_, [0.0] * 3, box)[perm[real]])
    res = []
    for bins, sp, _, pay, reach, mib, ok in (fast, gen):
        L = suggest_lag(bins.sorted_keys, bins.info.strides, reach=reach)
        args = (sp, bins.sorted_keys, bins.info.strides, 1.0, None, pay)
        kw = dict(L=L, mi_box=mib, key_reach=reach)
        c = pair_lag_reduce(*args, term=PbcKeepTerm(count_term), out_dtype=torch.int32, **kw)
        e = pair_lag_reduce(*args, term=PbcKeepTerm(lj_term), **kw)
        res.append((combine_count(c), float(e)))
    assert res[0][0] == res[1][0] > 0
    assert abs(res[0][1] - res[1][1]) <= 1e-12 * abs(res[1][1])
    # B2 overflows alone: 600 rows in the top cell [14, 14.5) and B = 1000
    # hold every face, but the merge region (B2 = min(2 B, n) = n rows)
    # cannot take the top cell with the appended block
    top = uni.copy()
    top[:600, 2] = rng.uniform(14.0, 14.5, 600)
    out = pbc._minimage_bins(torch.as_tensor(top), [0.0] * 3, box, 1.0, mask, B=1000,
                             G=None, positions_lo=None, need_perm=False)
    *_, okj = _jax_sorted_extremes(jnp.asarray(top), box=tuple(box), B=1000)
    assert not bool(out[6]) and not bool(okj)
    zg = torch.as_tensor(top[:, 2])
    assert int((zg < 1.0).sum()) <= 1000 and int((zg >= 13.0).sum()) <= 1000
    # B of 2^18 rows: the prepend block's padding keys would reach the real
    # keys, so the sorted-extremes path refuses it and the dispatch takes
    # the general path
    big = torch.as_tensor(rng.uniform(0, 1, (2**18, 3)) * box)
    with pytest.raises(ValueError, match="sorted-extremes path takes B"):
        pbc._minimage_bins_sorted_extremes(big, [0.0] * 3, box, 1.0, mask, B=2**18,
                                           positions_lo=None, need_perm=False)
    via = pbc._minimage_bins(big, [0.0] * 3, box, 1.0, mask, B=2**18, G=None,
                             positions_lo=None, need_perm=False)
    ref = pbc._minimage_bins_general(big, [0.0] * 3, box, 1.0, mask, B=2**18, G=None,
                                     positions_lo=None, need_perm=False)
    assert torch.equal(via[0].sorted_keys, ref[0].sorted_keys)
    assert bool(via[6]) == bool(ref[6])
