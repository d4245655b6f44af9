"""The slice end to end: the port's `fused_lj_rebuild_energy` (keys -> sort
-> K1's plain version) against the JAX package on the benchmark's thin box,
and against the port's own exact-f64 oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zelll_tpu.ops.fused import fused_lj_rebuild_energy as jax_rebuild
from zelll_tpu.ops.pallas_pairs import combine_count as jax_combine_count
from zelll_tpu.ops.pallas_pairs import count_term as jax_count_term
from zelll_tpu_torch import oracle
from zelll_tpu_torch.ops.fused import fused_lj_rebuild_energy
from zelll_tpu_torch.ops.lag_pairs import combine_count, count_term, split_f64
from zelll_tpu_torch.utils.datagen import (
    generate_points_lattice,
    generate_points_random,
    lj_box,
)

CUTOFF = 10.0  # the benchmark protocol: 30 x 30 x (n/9) box, ~10 per cell


@pytest.fixture(scope="module")
def bench_box():
    n = 3000
    return generate_points_random(n, lj_box(n, CUTOFF))


@pytest.mark.parametrize("split", [False, True], ids=["f64", "split_f32"])
def test_rebuild_matches_jax(bench_box, split):
    if split:
        hi, lo = split_f64(torch.as_tensor(bench_box))
        jhi, jlo = jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy())
        rtol = 1e-6  # f32 terms summed in other orders
    else:
        hi, lo = torch.as_tensor(bench_box), None
        jhi, jlo = jnp.asarray(bench_box), None
        rtol = 1e-10  # f64, intra-cell order differs (unstable sorts)
    want_e, want_ok = jax_rebuild(jhi, CUTOFF, jlo, M=512, L=256, interpret=True)
    want_c, _ = jax_rebuild(jhi, CUTOFF, jlo, M=512, L=256, term=jax_count_term,
                            out_dtype=jnp.int32, interpret=True)
    e, ok = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=256)
    c, _ = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=256, term=count_term,
                                   out_dtype=torch.int32)
    assert bool(ok) and bool(want_ok)
    assert e.dtype == (torch.float32 if split else torch.float64)
    assert combine_count(c) == jax_combine_count(np.asarray(want_c))
    np.testing.assert_allclose(float(e), float(want_e), rtol=rtol)


@pytest.mark.parametrize("split", [False, True], ids=["f64", "split_f32"])
def test_rebuild_matches_oracle(split):
    """The parity bar of the benchmark (1e-6 vs exact f64), at n = 2e4."""
    n = 20_000
    pts = generate_points_random(n, lj_box(n, CUTOFF))
    e_ref, n_ref = oracle.lj_energy(pts, CUTOFF)
    hi, lo = split_f64(torch.as_tensor(pts)) if split else (torch.as_tensor(pts), None)
    e, ok = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=256)
    c, _ = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=256, term=count_term,
                                   out_dtype=torch.int32)
    assert bool(ok)
    assert abs(combine_count(c) - n_ref) / n_ref <= 1e-6
    assert abs(float(e) - e_ref) / abs(e_ref) <= (1e-6 if split else 1e-9)


@pytest.mark.parametrize("split", [False, True], ids=["f64", "split_f32"])
def test_rebuild_on_lattice_matches_jax_and_oracle(split):
    """A jittered lattice at the benchmark's density: every pair term is of
    one size (no nearly coincident pair carries the total), so a wrong term
    or a lost pair shows at these tolerances."""
    n = 2000
    pts = generate_points_lattice(n, lj_box(n, CUTOFF))
    e_ref, n_ref = oracle.lj_energy(pts, CUTOFF)
    if split:
        hi, lo = split_f64(torch.as_tensor(pts))
        jhi, jlo = jnp.asarray(hi.numpy()), jnp.asarray(lo.numpy())
        rtol = 1e-6
    else:
        hi, lo = torch.as_tensor(pts), None
        jhi, jlo = jnp.asarray(pts), None
        rtol = 1e-10
    want_e, _ = jax_rebuild(jhi, CUTOFF, jlo, M=512, L=256, interpret=True)
    e, ok = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=256)
    c, _ = fused_lj_rebuild_energy(hi, CUTOFF, lo, L=256, term=count_term,
                                   out_dtype=torch.int32)
    assert bool(ok) and combine_count(c) == n_ref
    np.testing.assert_allclose(float(e), float(want_e), rtol=rtol)
    np.testing.assert_allclose(float(e), e_ref, rtol=rtol)


def test_rebuild_flags_undersized_lag(bench_box):
    _, ok = fused_lj_rebuild_energy(torch.as_tensor(bench_box), CUTOFF, L=16)
    assert not bool(ok)


def test_rebuild_of_numpy_input_on_cpu(bench_box):
    e, ok = fused_lj_rebuild_energy(bench_box, CUTOFF, device="cpu")
    e2, _ = fused_lj_rebuild_energy(torch.as_tensor(bench_box), CUTOFF)
    assert e.device.type == "cpu" and bool(ok)
    np.testing.assert_allclose(float(e), float(e2), rtol=1e-12)
