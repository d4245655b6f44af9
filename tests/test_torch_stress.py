"""The port's stress and virial tools (the plain versions of K4 in
ops.lag_pairs and K8 in ops.tile_pairs, ops.virial) against the JAX
package's `pair_lag_stress` and `tile_pair_stress` (Pallas, interpret mode)
on identical sorted inputs, and against f64 brute force. The CUDA kernels
themselves are held to the plain versions on the card by
tests/test_torch_kernels.py and chip_smoke.py.

Each JAX kernel runs once per configuration under one `jax.jit` (one
executable per call); the tile ones with CB=1, which the TPU kernel allows
in interpret mode and which keeps its unrolled body small. The port takes
the same CB. Tolerances, relative to the largest |sigma_ab|: against JAX,
1e-6 in f32 (JAX sums Kahan-compensated f32 per lane and then the lanes in
f32; the port sums the same f32 products in f64 in another order);
against brute force over the same f32 products, 1e-9 of the sum of |terms|
(the order of f64 sums); f64 coordinates 1e-10; split coordinates 2e-6
(the JAX package's parity bar, benchmarks/tpu_parity.py), against the
exact f64 stress of the f64 points.

Periodic boxes (`pbc_virial`, `pbc_stress`, `pbc_stress_fused` with ghost
images and the minimum image): in f64 against a numpy minimum-image brute
force to 1e-9 of the largest component (tests/test_virial.py's bar) and
against the JAX package's functions to 1e-10 of it (the same f64 terms in
another order); split minimum image to 2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401
from xla_release import release_xla_executables  # noqa: F401

from zelll_tpu.ops import virial as jax_virial
from zelll_tpu.ops.pbc import minimage_axes as jax_minimage_axes
from zelll_tpu.ops.pallas_pairs import pair_lag_stress as jax_lag_stress
from zelll_tpu.ops.tile_pairs import tile_pair_stress as jax_tile_stress
from zelll_tpu_torch.core import build
from zelll_tpu_torch.ops.lag_pairs import (
    SpeciesPairMask,
    pair_lag_stress,
    pbc_keep,
    split_f64,
    suggest_lag,
)
from zelll_tpu_torch.ops.lj import lj_force_factor_fast, lj_virial_term
from zelll_tpu_torch.ops.tile_pairs import tile_lj_rebuild_energy, tile_pair_stress
from zelll_tpu_torch.ops.pbc import minimage_axes, pbc_extend, suggest_pbc_capacity
from zelll_tpu_torch.ops.virial import (
    fused_stress_open,
    fused_virial,
    kinetic_energy,
    kinetic_stress,
    pair_stress_open,
    pbc_stress,
    pbc_stress_fused,
    pbc_virial,
    pressure,
    pressure_tensor,
    virial_rebuild,
    virial_term_from_gfn,
)


def brute_stress(pts, cutoff, *, f32=False):
    """Stress over unique pairs with 0 < dsq < cutoff^2. f64 throughout,
    or (``f32``) the port's f32 arithmetic per pair (d, dsq, g and the
    products rounded to f32) summed in f64. Returns (sigma, sum |terms|)."""
    t = np.float32 if f32 else np.float64
    p = np.asarray(pts, t)
    i, j = np.triu_indices(len(p), 1)
    d = p[j] - p[i]
    dsq = d[:, 0] * d[:, 0]
    for a in range(1, p.shape[1]):
        dsq = dsq + d[:, a] * d[:, a]
    m = (dsq < t(cutoff) ** 2) & (dsq > 0)
    d, dsq = d[m], dsq[m]
    inv = t(1) / dsq
    tt = inv * inv * inv
    g = t(24) * tt * (t(2) * tt - t(1)) * inv
    dim = p.shape[1]
    sig = np.zeros((dim, dim))
    mag = np.zeros((dim, dim))
    for a in range(dim):
        for b in range(a, dim):
            v = ((g * d[:, a]) * d[:, b]).astype(np.float64)
            sig[a, b] = sig[b, a] = v.sum()
            mag[a, b] = mag[b, a] = np.abs(v).sum()
    return sig, mag


def _sorted(pts, cutoff, dtype=np.float32):
    """The port's sorted (positions, keys, strides) on a fresh grid, as
    numpy arrays (bitwise the JAX package's sort up to intra-cell order)."""
    g = build(np.asarray(pts, dtype), cutoff, device="cpu")
    return (g.sorted_pos.numpy(), g.bins.sorted_keys.numpy(),
            g.info.strides.numpy())


def brute_stress_pbc(pts, box, cutoff):
    """Minimum-image virial W and stress over unique pairs (f64 numpy,
    tests/test_virial.py's oracle_pbc). Returns (W, sigma)."""
    pts, box = np.asarray(pts, np.float64), np.asarray(box, np.float64)
    d = pts[:, None, :] - pts[None, :, :]
    d -= box * np.round(d / box)
    dsq = (d * d).sum(-1)
    np.fill_diagonal(dsq, np.inf)
    within = np.triu(dsq < cutoff * cutoff)
    t = 1.0 / np.where(within, dsq, 1.0)
    t3 = t * t * t
    g = np.where(within, 24.0 * t3 * (2.0 * t3 - 1.0) * t, 0.0)
    return float((g * np.where(within, dsq, 0.0)).sum()), np.einsum("ij,ija,ijb->ab", g, d, d)


def pbc_points(n=256, box=(4.3, 5.1, 6.7), seed=0):
    """tests/test_virial.py's make_pbc: uniform points in [0, box), f64."""
    box = np.asarray(box, np.float64)
    return np.random.default_rng(seed).uniform(0, 1, (n, 3)) * box, box


def edge_cluster(seed=0):
    """2000 uniform points in a 16^3 box and 200 within 0.9 of the x and
    y faces' shared edge (z in [4, 12)), f64: more rows near two faces
    than `suggest_pbc_capacity`'s BE, fewer near one than its B."""
    rng = np.random.default_rng(seed)
    box = np.full(3, 16.0)
    edge = np.column_stack([rng.uniform(0, 0.9, (200, 2)), rng.uniform(4, 12, 200)])
    return np.concatenate([rng.uniform(0, 1, (2000, 3)) * box, edge]), box


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


LAG_CASES = [  # (n, box, cutoff): thin boxes, an odd n (the JAX tail padding)
    (900, (4.0, 4.0, 30.0), 1.0),
    (257, (2.0, 2.0, 40.0), 1.5),
]


@pytest.mark.parametrize("n,box,cutoff", LAG_CASES, ids=["thin", "odd_n"])
def test_lag_stress_matches_jax(n, box, cutoff):
    pts = np.random.default_rng(n).uniform(0, 1, (n, 3)) * np.asarray(box)
    sp, keys, strides = _sorted(pts, cutoff)
    L = suggest_lag(keys, strides)
    want = np.asarray(jax.jit(lambda p, k, s: jax_lag_stress(
        p, k, s, cutoff**2, M=max(256, L), L=L, interpret=True))(sp, keys, strides))
    got = pair_lag_stress(torch.as_tensor(sp), torch.as_tensor(keys),
                          torch.as_tensor(strides), cutoff**2, L=L)
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    assert _rel(got, want) <= 1e-6
    ref, mag = brute_stress(sp, cutoff, f32=True)
    assert np.all(np.abs(got.double().numpy() - ref) <= 1e-6 * np.abs(ref).max())
    g64 = pair_lag_stress(torch.as_tensor(sp), torch.as_tensor(keys),
                          torch.as_tensor(strides), cutoff**2, L=L,
                          out_dtype=torch.float64).numpy()
    assert np.all(np.abs(g64 - ref) <= 1e-9 * mag)
    if n != 900:
        return
    # periodic: `pbc_stress_fused` on the lag path with ghost images (the
    # keep mask), an explicit fold of x (y and z ghosts) and "auto" on a box
    # whose axes are all narrow (x and y fold, the largest keeps ghosts), in
    # f64, against the JAX package's (one jitted call) and the
    # minimum-image brute force
    cases = {"ghosts": (pbc_points(seed=10), 1.0, False),
             "fold_x": (pbc_points(256, (2.5, 2.5, 40.0), 42), 1.0, (True, False, False)),
             "auto": (pbc_points(200, (3.1, 3.3, 3.7), 41), 1.2, "auto")}
    auto = minimage_axes(cases["auto"][0][1], 1.2)
    assert auto.tolist() == jax_minimage_axes(cases["auto"][0][1], 1.2).tolist() == [
        True, True, False]

    @jax.jit
    def ref_pbc(p):
        return {k: jax_virial.pbc_stress_fused(p[k], np.zeros(3), box, c, M=512, L=512,
                                               interpret=True, minimage=mi)
                for k, ((_, box), c, mi) in cases.items()}

    want = jax.tree_util.tree_map(np.asarray, ref_pbc({k: v[0][0] for k, v in cases.items()}))
    for k, ((pts, box), c, mi) in cases.items():
        sig, ok = pbc_stress_fused(torch.as_tensor(pts), np.zeros(3), box, c, L=512,
                                   minimage=mi)
        w_ref, s_ref = brute_stress_pbc(pts, box, c)
        assert bool(ok) and bool(want[k][1]), k
        scale = np.abs(s_ref).max()
        assert np.abs(sig.numpy() - s_ref).max() <= 1e-9 * scale, k
        assert np.abs(sig.numpy() - want[k][0]).max() <= 1e-10 * scale, k
        assert abs(float(torch.trace(sig)) - w_ref) <= 1e-9 * abs(w_ref), k


def test_lag_stress_split_matches_jax():
    """Split planes far from the origin: JAX's kernel and the port agree,
    and both are f64-grade against the f64 stress of the f64 points."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 1, (600, 3)) * [3.0, 3.0, 40.0] + [0.0, 0.0, 5000.0]
    g = build(pts, 1.2, device="cpu")
    hi, lo = split_f64(g.sorted_pos)
    keys, strides = g.bins.sorted_keys, g.info.strides
    L = suggest_lag(keys, strides)
    want = np.asarray(jax.jit(lambda p, k, s, q: jax_lag_stress(
        p, k, s, 1.2**2, q, M=max(256, L), L=L, interpret=True))(
            hi.numpy(), keys.numpy(), strides.numpy(), lo.numpy()))
    got = pair_lag_stress(hi, keys, strides, 1.2**2, lo, L=L)
    assert _rel(got, want) <= 1e-6
    ref, _ = brute_stress(g.sorted_pos.numpy(), 1.2)
    assert _rel(got, ref) <= 2e-6
    # periodic split: a box 4096 from the origin (tests/test_virial.py), the
    # minimum image (split mode's fold carries the two-diff residual), and
    # ghost images on the lag and tile paths (split ghosts), f64-grade
    # against the brute force; the minimum image also against the JAX
    # package's (the box is exact in f32, where the two fold alike)
    (pts, box), o = pbc_points(256, (2.5, 2.5, 40.0), 43), np.full(3, 4096.0)
    phi, plo = split_f64(torch.as_tensor(pts + 4096.0))
    _, s_ref = brute_stress_pbc(pts, box, 1.0)
    want = np.asarray(jax.jit(lambda p, q: jax_virial.pbc_stress_fused(
        p, o, box, 1.0, M=512, L=512, interpret=True, minimage="auto",
        positions_lo=q))(phi.numpy(), plo.numpy())[0], np.float64)
    for kw in (dict(L=512, minimage="auto"), dict(L=512), dict(path="tile", MAXJ=16)):
        sig, ok = pbc_stress_fused(phi, o, box, 1.0, positions_lo=plo, **kw)
        assert bool(ok) and sig.dtype == torch.float32
        assert _rel(sig, s_ref) <= 2e-6, kw
    sig, _ = pbc_stress_fused(phi, o, box, 1.0, positions_lo=plo, L=512, minimage="auto")
    assert _rel(sig, want) <= 1e-6


@pytest.mark.parametrize("bandmask", [False, True], ids=["maskless", "masked"])
def test_tile_stress_matches_jax(bandmask):
    pts = np.random.default_rng(8).uniform(0, 8.0, (800, 3))
    sp, keys, strides = _sorted(pts, 1.5)
    want, ok_j = jax.jit(lambda p, k, s: jax_tile_stress(
        p, k, s, 1.5**2, MAXJ=4, CB=1, bandmask=bandmask, interpret=True))(
            sp, keys, strides)
    got, ok = tile_pair_stress(torch.as_tensor(sp), torch.as_tensor(keys),
                               torch.as_tensor(strides), 1.5**2, MAXJ=4, CB=1,
                               bandmask=bandmask)
    assert bool(ok) == bool(ok_j) is True
    assert _rel(got, np.asarray(want)) <= 1e-6
    ref, mag = brute_stress(sp, 1.5, f32=True)
    g64, _ = tile_pair_stress(torch.as_tensor(sp), torch.as_tensor(keys),
                              torch.as_tensor(strides), 1.5**2, MAXJ=4, CB=1,
                              bandmask=bandmask, out_dtype=torch.float64)
    assert np.all(np.abs(g64.numpy() - ref) <= 1e-9 * mag)
    # an undersized capacity drops the flag (tests/test_torch_hist.py holds
    # the flag to the JAX package's)
    _, ok = tile_pair_stress(torch.as_tensor(sp), torch.as_tensor(keys),
                             torch.as_tensor(strides), 1.5**2, MAXJ=1, CB=1,
                             bandmask=bandmask)
    assert not bool(ok)
    if bandmask:
        return
    # periodic: `pbc_stress_fused(path="tile")` (K8's keep rule over the
    # payload row) against the JAX package's and the brute force, f64
    (pts, box), c = pbc_points(seed=11), 1.0
    want, ok_j = jax.jit(lambda p: jax_virial.pbc_stress_fused(
        p, np.zeros(3), box, c, path="tile", MAXJ=16, CB=1, interpret=True))(pts)
    sig, ok = pbc_stress_fused(torch.as_tensor(pts), np.zeros(3), box, c, path="tile",
                               MAXJ=16, CB=1)
    _, s_ref = brute_stress_pbc(pts, box, c)
    assert bool(ok) and bool(ok_j)
    scale = np.abs(s_ref).max()
    assert np.abs(sig.numpy() - s_ref).max() <= 1e-9 * scale
    assert np.abs(sig.numpy() - np.asarray(want)).max() <= 1e-10 * scale


STRESS_BOXES = {"thin": ((3.0, 3.0, 60.0), "lag"), "cubic": ((9.0, 9.0, 9.0), "tile")}


@pytest.mark.parametrize("mode", ["f32", "split", "f64"])
@pytest.mark.parametrize("box", list(STRESS_BOXES))
def test_fused_stress_open_vs_oracle(box, mode):
    extent, path = STRESS_BOXES[box]
    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 1, (700, 3)) * np.asarray(extent) + 300.0
    kw = dict(path=path, L=1024, MAXJ=8)
    if mode == "split":
        hi, lo = split_f64(torch.as_tensor(pts))
        sig, ok = fused_stress_open(hi, 1.3, positions_lo=lo, **kw)
        ref, _ = brute_stress(pts, 1.3)
        tol = 2e-6
    elif mode == "f32":
        sig, ok = fused_stress_open(torch.as_tensor(pts, dtype=torch.float32), 1.3, **kw)
        ref, _ = brute_stress(pts.astype(np.float32), 1.3, f32=True)
        tol = 1e-6
    else:
        sig, ok = fused_stress_open(torch.as_tensor(pts), 1.3, **kw)
        ref, _ = brute_stress(pts, 1.3)
        tol = 1e-10
    assert bool(ok)
    assert sig.dtype == (torch.float64 if mode == "f64" else torch.float32)
    assert torch.equal(sig, sig.t())
    assert _rel(sig, ref) <= tol


def test_trace_equals_virial():
    """trace(sigma) is the scalar virial: the port's lag and tile virials
    (K1 and K6 with lj_virial_term) and `fused_virial` against the traces
    of both stress paths, and `virial_rebuild` against the JAX package's."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 1, (600, 3)) * [3.0, 3.0, 50.0]
    x = torch.as_tensor(pts)
    w_lag, ok1 = virial_rebuild(x, 1.4, L=1024)
    w_tile, ok2 = tile_lj_rebuild_energy(x, 1.4, term=lj_virial_term, MAXJ=16)
    w_grid, ok3 = fused_virial(build(x, 1.4), L=1024)
    s_lag, ok4 = fused_stress_open(x, 1.4, L=1024)
    s_tile, ok5 = fused_stress_open(x, 1.4, path="tile", MAXJ=16)
    assert all(bool(o) for o in (ok1, ok2, ok3, ok4, ok5))
    for w in (w_tile, w_grid, torch.trace(s_lag), torch.trace(s_tile)):
        assert abs(float(w) - float(w_lag)) <= 1e-10 * abs(float(w_lag))
    w_j, ok_j = jax.jit(lambda p: jax_virial.virial_rebuild(
        p, 1.4, M=1024, L=1024, interpret=True))(pts)
    assert bool(ok_j)
    assert abs(float(w_j) - float(w_lag)) <= 1e-10 * abs(float(w_lag))
    # a derived virial term runs the same pairs (on CPU tensors)
    w_gfn, _ = virial_rebuild(x, 1.4, L=1024, gfn=lj_force_factor_fast)
    assert virial_term_from_gfn(lj_force_factor_fast) is virial_term_from_gfn(
        lj_force_factor_fast)
    assert abs(float(w_gfn) - float(w_lag)) <= 1e-9 * abs(float(w_lag))


def test_stress_2d_falls_back_and_split_2d_raises():
    rng = np.random.default_rng(12)
    pts = rng.uniform(0, 6.0, (300, 2))
    sig, ok = fused_stress_open(torch.as_tensor(pts), 1.1)
    assert bool(ok) and sig.shape == (2, 2)
    ref, _ = brute_stress(pts, 1.1)
    assert _rel(sig, ref) <= 1e-10
    s2, ok2 = pair_stress_open(torch.as_tensor(pts), 1.1)
    assert bool(ok2) and torch.allclose(s2, sig, rtol=0, atol=1e-10 * np.abs(ref).max())
    hi, lo = split_f64(torch.as_tensor(pts))
    with pytest.raises(ValueError, match="only fused for dim == 3"):
        fused_stress_open(hi, 1.1, positions_lo=lo)
    with pytest.raises(ValueError, match="only fused for dim == 3"):
        jax_virial.fused_stress_open(jnp.asarray(hi.numpy()), 1.1,
                                     positions_lo=jnp.asarray(lo.numpy()))


@pytest.mark.parametrize("path", ["lag", "tile"])
def test_coincident_points_are_excluded(path):
    """dsq = 0 pairs would give inf * 0 = NaN: both stress paths drop them,
    in f32 and f64."""
    rng = np.random.default_rng(30)
    pts = rng.uniform(0, 1, (400, 3)) * [4.0, 4.0, 20.0]
    pts[200:240] = pts[:40]  # 40 coincident pairs
    for dtype in (torch.float32, torch.float64):
        sig, ok = fused_stress_open(torch.as_tensor(pts, dtype=dtype), 1.2,
                                    path=path, L=1024, MAXJ=16)
        assert bool(ok) and torch.isfinite(sig).all()
        ref, _ = brute_stress(pts.astype(np.float32) if dtype == torch.float32
                              else pts, 1.2, f32=dtype == torch.float32)
        assert _rel(sig, ref) <= 1e-6


def test_payload_rules_on_cpu():
    """The plain versions take the JAX kernels' payload rules: a pair mask,
    a multiplicative pair weight and min_islot, against brute force; and
    the term table's functions (an ops.potentials factory's gfn and term, a
    shifted term, a virial term) on the plain versions of K2, K4 and K8
    against the JAX kernels on the same sorted inputs (one jitted call, f64,
    to 1e-10 of the largest value)."""
    rng = np.random.default_rng(14)
    pts = rng.uniform(0, 1, (500, 3)) * [3.0, 3.0, 30.0]
    sp, keys, strides = _sorted(pts, 1.3, np.float64)
    w = rng.integers(0, 3, len(sp)).astype(np.float64)
    args = (torch.as_tensor(sp), torch.as_tensor(keys), torch.as_tensor(strides), 1.3**2)
    i, j = np.triu_indices(len(sp), 1)
    d = sp[j] - sp[i]
    dsq = (d * d).sum(1)
    g = np.where(dsq > 0, 24 / dsq**3 * (2 / dsq**3 - 1) / dsq, 0.0)

    def ref(keep, weight):
        m = (dsq < 1.3**2) & keep
        return np.einsum("p,pa,pb->ab", (g * weight)[m], d[m], d[m])

    mask = SpeciesPairMask(0, 2)
    pay = torch.as_tensor(w)
    keep = ((w[i] == 0) & (w[j] == 2)) | ((w[i] == 2) & (w[j] == 0))
    weight = 0.5 * (w[i] + w[j])
    for kernel, kw in ((pair_lag_stress, dict(L=1024)), (tile_pair_stress, dict(MAXJ=16))):
        got = kernel(*args, None, pay, pair_mask=mask, **kw)
        got = got[0] if isinstance(got, tuple) else got
        assert _rel(got, ref(keep, 1.0)) <= 1e-10
        got = kernel(*args, None, pay, pair_weight=lambda a, b: 0.5 * (a + b), **kw)
        got = got[0] if isinstance(got, tuple) else got
        assert _rel(got, ref(np.ones_like(keep), weight)) <= 1e-10
        got = kernel(*args, min_islot=250, **kw)
        got = got[0] if isinstance(got, tuple) else got
        assert _rel(got, ref(j >= 250, 1.0)) <= 1e-10
    # the periodic rules (plain versions, f64): the keep mask over the
    # shift-sign plane on every path of `pbc_stress_fused`, the minimum
    # image (`mi_box`/`key_reach`) alone and with the keep mask, the
    # bucketed `pbc_stress` (half-weights) and the virial's three paths,
    # each against the minimum-image brute force; trace(sigma) = W
    for (pts, box), c in ((pbc_points(seed=3), 1.0),
                          (pbc_points(200, (3.0, 3.0, 3.0), 4), 1.2)):
        w_ref, s_ref = brute_stress_pbc(pts, box, c)
        x, o = torch.as_tensor(pts), np.zeros(3)
        scale = np.abs(s_ref).max()
        for sig, ok in (pbc_stress(x, o, box, c),
                        pbc_stress_fused(x, o, box, c, L=512),
                        pbc_stress_fused(x, o, box, c, path="tile", MAXJ=16),
                        pbc_stress_fused(x, o, box, c, L=512, minimage=(True, True, False)),
                        pbc_stress_fused(x, o, box, c, L=512, minimage=(True, True, True))):
            assert bool(ok)
            assert np.abs(sig.numpy() - s_ref).max() <= 1e-9 * scale
            assert abs(float(torch.trace(sig)) - w_ref) <= 1e-9 * abs(w_ref)
        for path, kw in (("lag", dict(L=512)), ("tile", dict(MAXJ=16)), ("xla", dict(K=32))):
            w, ok = pbc_virial(x, o, box, c, path=path, **kw)
            assert bool(ok) and abs(float(w) - w_ref) <= 1e-9 * abs(w_ref), path
    # default capacities as the JAX package sizes them (BE = B): a cluster
    # at an edge of the box holds more rows near two faces than
    # `suggest_pbc_capacity(with_multi=True)`'s BE, which would drop the flag
    (pts, box), o = edge_cluster(), np.zeros(3)
    x = torch.as_tensor(pts)
    B, G, BE = suggest_pbc_capacity(len(pts), box, 1.0, with_multi=True)
    assert not bool(pbc_extend(x, o, box, 1.0, B=B, G=G, BE=BE)[-1])
    assert bool(pbc_extend(x, o, box, 1.0, B=B, G=G)[-1])
    w_ref, s_ref = brute_stress_pbc(pts, box, 1.0)
    for sig, ok in (pbc_stress_fused(x, o, box, 1.0, L=512),
                    pbc_stress_fused(x, o, box, 1.0, path="tile", MAXJ=16)):
        assert bool(ok)
        assert np.abs(sig.numpy() - s_ref).max() <= 1e-9 * np.abs(s_ref).max()
    # the term table's functions on the plain versions of K2, K4 and K8
    # against the JAX kernels: the JAX potentials' lattice (spacing 1.25 at
    # cutoff 2.5), sorted in f64
    import zelll_tpu.ops.potentials as JP
    from zelll_tpu.ops.pallas_pairs import pair_lag_per_particle as jax_k2
    from zelll_tpu_torch.ops import potentials as P
    from zelll_tpu_torch.ops.lag_pairs import pair_lag_per_particle

    cells = np.stack(np.meshgrid(*[np.arange(k) for k in (4, 4, 16)], indexing="ij"), -1)
    pts = (cells.reshape(-1, 3) + 0.5) * 1.25
    pts = pts + np.random.default_rng(15).uniform(-0.2, 0.2, pts.shape)
    sp, keys, strides = _sorted(pts, 2.5, np.float64)
    L = suggest_lag(keys, strides)
    jm, tm = JP.morse(1.3, 2.0, 1.1), P.morse(1.3, 2.0, 1.1)
    js, ts = JP.shifted(JP.lennard_jones(), 2.5), P.shifted(P.lennard_jones(), 2.5)

    @jax.jit
    def ref_table(p, k, s):
        k2 = dict(M=1024, L=L, interpret=True)
        return (jax_k2(p, k, s, 2.5**2, term=js.term, **k2),
                jax_k2(p, k, s, 2.5**2, term=jm.term, **k2),
                jax_k2(p, k, s, 2.5**2, term=jax_virial.virial_term_from_gfn(jm.gfn), **k2),
                jax_lag_stress(p, k, s, 2.5**2, gfn=jm.gfn, M=max(256, L), L=L,
                               interpret=True),
                jax_tile_stress(p, k, s, 2.5**2, gfn=jm.gfn, MAXJ=16, CB=1,
                                interpret=True)[0])

    want = [np.asarray(x) for x in ref_table(sp, keys, strides)]
    targs = (torch.as_tensor(sp), torch.as_tensor(keys), torch.as_tensor(strides), 2.5**2)
    got = [pair_lag_per_particle(*targs, L=L, term=t)
           for t in (ts.term, tm.term, virial_term_from_gfn(tm.gfn))]
    got += [pair_lag_stress(*targs, L=L, gfn=tm.gfn),
            tile_pair_stress(*targs, MAXJ=16, CB=1, gfn=tm.gfn)[0]]
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float64
        assert np.abs(g.numpy() - w).max() <= 1e-10 * np.abs(w).max(), k
    # the keep mask is the JAX package's `_pbc_keep_mask` and symmetric
    wv = torch.tensor([0.0, 1.0, -1.0])
    np.testing.assert_array_equal(
        pbc_keep(wv[:, None], wv[None, :]).numpy(),
        np.asarray(jax_virial._pbc_keep_mask(jnp.asarray(wv.numpy())[:, None],
                                             jnp.asarray(wv.numpy())[None, :])))


def test_refusals():
    pts = torch.as_tensor(np.random.default_rng(0).uniform(0, 3, (50, 3)))
    sp, keys, strides = _sorted(pts.numpy(), 1.0, np.float64)
    args = (torch.as_tensor(sp), torch.as_tensor(keys), torch.as_tensor(strides), 1.0)
    # the minimum image is a lag-path feature, and split coordinates fuse in
    # 3-D only, in both packages (tests/test_virial.py)
    (p3, box), o = pbc_points(64, (2.5, 2.5, 40.0), 44), np.zeros(3)
    with pytest.raises(ValueError, match="lag-path"):
        pbc_stress_fused(torch.as_tensor(p3), o, box, 1.0, path="tile", minimage="auto")
    with pytest.raises(ValueError, match="lag-path"):
        jax_virial.pbc_stress_fused(jnp.asarray(p3), o, box, 1.0, path="tile",
                                    minimage="auto")
    hi2, lo2 = split_f64(torch.as_tensor(p3[:, :2]))
    with pytest.raises(ValueError, match="only fused for dim == 3"):
        pbc_stress_fused(hi2, o[:2], box[:2], 1.0, positions_lo=lo2)
    with pytest.raises(ValueError, match="only fused for dim == 3"):
        jax_virial.pbc_stress_fused(jnp.asarray(hi2.numpy()), o[:2], box[:2], 1.0,
                                    positions_lo=jnp.asarray(lo2.numpy()))
    with pytest.raises(ValueError, match="go together"):
        pair_lag_stress(*args, pair_mask=SpeciesPairMask(0, 1))
    with pytest.raises(ValueError, match="go together"):
        tile_pair_stress(*args, sorted_payload=torch.zeros(50))
    with pytest.raises(ValueError, match="unknown path"):
        fused_stress_open(pts, 1.0, path="xla")
    # K4 and K8 take a factory's gfn through the term table with f32 (or
    # split) coordinates; a derived factor (no spec), an energy term and f64
    # coordinates raise before anything launches
    from zelll_tpu_torch.ops import gfn_from_term, lj_term
    from zelll_tpu_torch.ops import potentials as P
    from zelll_tpu_torch.ops.lag_pairs import _lag_stress_cuda
    from zelll_tpu_torch.ops.tile_pairs import stress_tiles, tile_inputs

    k4 = dict(L=8, pair_mask=None, mi_box=None, key_reach=None, out_dtype=torch.float64)
    inp = tile_inputs(args[0].t().contiguous(), args[1], args[2], MAXJ=4)
    for gfn, what in ((gfn_from_term(lj_term), "but lennard_jones_mixed"),
                      (P.morse().term, "but lennard_jones_mixed"),
                      (P.morse().gfn, "float32 coordinates only")):
        with pytest.raises(ValueError, match=what):
            _lag_stress_cuda(*args, None, None, gfn=gfn, **k4)
        with pytest.raises(ValueError, match=what):
            stress_tiles(inp, 1.0, gfn=gfn)


def test_kinetic_terms_and_pressure_goldens():
    v = np.array([[1.0, 2.0, 0.0], [0.5, -1.0, 3.0], [0.0, 0.0, -2.0]])
    want_ks = np.array([[1.25, 1.5, 1.5], [1.5, 5.0, -3.0], [1.5, -3.0, 13.0]])
    ks = kinetic_stress(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(ks, want_ks)
    np.testing.assert_array_equal(ks, np.asarray(jax_virial.kinetic_stress(jnp.asarray(v))))
    ke = float(kinetic_energy(torch.as_tensor(v)))
    assert ke == 9.625 == float(jax_virial.kinetic_energy(jnp.asarray(v)))
    assert ke == 0.5 * np.trace(want_ks)
    sig = np.diag([3.0, -1.0, 4.0])
    p = pressure(float(np.trace(sig)), ke, 8.0)
    assert p == (2 * 9.625 + 6.0) / 24.0 == jax_virial.pressure(6.0, ke, 8.0)
    pt = pressure_tensor(torch.as_tensor(sig), torch.as_tensor(ks), 8.0)
    np.testing.assert_array_equal(pt.numpy(), (sig + want_ks) / 8.0)
    assert abs(float(torch.trace(pt)) / 3 - p) <= 1e-15
