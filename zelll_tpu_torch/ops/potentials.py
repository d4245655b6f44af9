"""Standard pair potentials as term/force-factor factories.

PyTorch counterpart of ``zelll_tpu/ops/potentials.py``. Each factory returns
a `PairPotential` of two plain torch functions of the squared distance, in
the library's conventions:

* ``term(dsq)``: the pair energy; feeds any ``term=`` keyword
  (`pair_lag_reduce`, `tile_pair_reduce`, `pbc_pair_sum`, ...).
* ``gfn(dsq)``: the force factor f with ``F_i = f * (p_i - p_j)``, that is
  ``f = -2 dV/d(dsq)``; feeds any ``gfn=`` keyword and
  `ops.virial.virial_term_from_gfn`.

Every factory is cached on its parameters, so the same parameters give the
same function objects, as in the JAX package.

On the card the energy and forces kernels K1, K3, K6 and K7 evaluate these
functions through one term table (``csrc/pair_table.cuh``): each function
carries a `TermSpec` in its ``table`` attribute (its kind, the constants it
reads, the shift of `shifted` and its mode), and the wrappers hand that to
the kernel. The kernel repeats the torch function's operations in the same
order on the same f32 constants, so the functions are written with no
Python scalar divided by a tensor (torch computes that as a reciprocal and
a product) and no tensor divided by a Python scalar (a product with the
scalar's reciprocal): they take ``reciprocal()`` and precomputed
reciprocals, as the kernel does. A function without a spec (any other
callable) runs on CPU tensors only.

`lennard_jones_mixed` is a payload term ``(dsq, s_i, s_j)`` over a species
plane; the kernels read its pair parameters from an S x S table that the
host computes as the f32 function does (`species_table`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

__all__ = [
    "PairPotential",
    "TermSpec",
    "buckingham",
    "factory_gfn",
    "gaussian",
    "harmonic",
    "lennard_jones",
    "lennard_jones_mixed",
    "morse",
    "shifted",
    "soft_sphere",
    "species_table",
    "wca",
    "yukawa",
]

# The table's kinds and modes (csrc/pair_table.cuh: kTable*, kTableMode*).
KIND_LJ = 0
KIND_WCA = 1
KIND_SOFT_SPHERE = 2
KIND_GAUSSIAN = 3
KIND_MORSE = 4
KIND_YUKAWA = 5
KIND_BUCKINGHAM = 6
KIND_HARMONIC = 7
KIND_MIXED_LJ = 8
MODE_ENERGY = 0
MODE_GFN = 1
MODE_VIRIAL = 2

# The largest species count the kernels' table takes.
MAX_SPECIES = 16


class TermSpec(NamedTuple):
    """What a kernel needs to evaluate a factory's function: its kind, up
    to five constants (f64 values the kernel rounds to f32, as torch rounds
    them for f32 tensors), the constant that `shifted` subtracts (energy
    mode only) and the mode (energy, force factor or virial). A species
    term's constants are its per-species (eps, sigma) in ``species``."""

    kind: int
    params: tuple
    shift: float = 0.0
    mode: int = MODE_ENERGY
    species: tuple = ()


class PairPotential(NamedTuple):
    """A pair interaction: ``term(dsq)`` sums to the potential energy,
    ``gfn(dsq)`` is the force factor (``F_i = gfn * (p_i - p_j)``)."""

    term: Callable
    gfn: Callable


def _tag(fn: Callable, kind: int, params, mode: int, shift: float = 0.0,
         species: tuple = ()) -> Callable:
    fn.table = TermSpec(kind, tuple(float(p) for p in params), float(shift), mode,
                        species)
    return fn


# Each factory's gfn by its spec (gfn mode, no shift): `factory_gfn`.
_GFNS: dict = {}


def _pair(kind: int, params, term: Callable, gfn: Callable) -> PairPotential:
    pot = PairPotential(_tag(term, kind, params, MODE_ENERGY),
                        _tag(gfn, kind, params, MODE_GFN))
    _GFNS[gfn.table] = gfn
    return pot


def factory_gfn(term: Callable) -> Callable | None:
    """The gfn of the factory whose energy ``term`` is (a factory's term or
    a `shifted` one: the same kind and constants in gfn mode, no shift), or
    None for any other callable. The gfn carries its spec, so the forces
    and stress kernels run it on the card."""
    spec = getattr(term, "table", None)
    if not isinstance(spec, TermSpec) or spec.mode != MODE_ENERGY:
        return None
    return _GFNS.get(spec._replace(shift=0.0, mode=MODE_GFN))


def _cube(x):
    return x * x * x


@functools.lru_cache(maxsize=None)
def lennard_jones(epsilon: float = 1.0, sigma: float = 1.0) -> PairPotential:
    """4 eps ((sigma/r)^12 - (sigma/r)^6)."""
    s2, e4 = float(sigma) ** 2, 4.0 * float(epsilon)
    e24 = 6.0 * e4

    def term(dsq):
        t = _cube(s2 * dsq.reciprocal())
        return e4 * t * (t - 1.0)

    def gfn(dsq):
        t = _cube(s2 * dsq.reciprocal())
        return e24 * t * (2.0 * t - 1.0) / dsq

    return _pair(KIND_LJ, (s2, e4, e24), term, gfn)


@functools.lru_cache(maxsize=None)
def wca(epsilon: float = 1.0, sigma: float = 1.0) -> PairPotential:
    """Weeks-Chandler-Andersen: LJ cut at its minimum r_c = 2^(1/6) sigma and
    shifted up by eps. The cut is a select inside the potential, so any
    cutoff >= r_c enumerates a superset whose extra pairs add exactly 0."""
    s2, e4, eps = float(sigma) ** 2, 4.0 * float(epsilon), float(epsilon)
    e24 = 6.0 * e4
    rc2 = 2.0 ** (1.0 / 3.0) * s2

    def term(dsq):
        t = _cube(s2 * dsq.reciprocal())
        v = e4 * t * (t - 1.0) + eps
        return torch.where(dsq < rc2, v, torch.zeros_like(v))

    def gfn(dsq):
        t = _cube(s2 * dsq.reciprocal())
        g = e24 * t * (2.0 * t - 1.0) / dsq
        return torch.where(dsq < rc2, g, torch.zeros_like(g))

    return _pair(KIND_WCA, (s2, e4, e24, rc2, eps), term, gfn)


def _power(x, h: int):
    """x^h as h - 1 multiplies, left to right (the kernel's loop)."""
    p = x
    for _ in range(h - 1):
        p = p * x
    return p


@functools.lru_cache(maxsize=None)
def soft_sphere(epsilon: float = 1.0, sigma: float = 1.0, n: int = 12) -> PairPotential:
    """eps (sigma/r)^n, even n (pure repulsion; n = 12 is the LJ core)."""
    if n % 2 or n <= 0:
        raise ValueError(f"soft_sphere needs a positive even n; got {n}")
    s2, eps, h = float(sigma) ** 2, float(epsilon), n // 2
    en = float(n) * eps

    def term(dsq):
        return eps * _power(s2 * dsq.reciprocal(), h)

    def gfn(dsq):
        return en * _power(s2 * dsq.reciprocal(), h) / dsq

    return _pair(KIND_SOFT_SPHERE, (s2, eps, en, h), term, gfn)


@functools.lru_cache(maxsize=None)
def gaussian(epsilon: float = 1.0, sigma: float = 1.0) -> PairPotential:
    """eps exp(-dsq / (2 sigma^2)) (the Gaussian-core model)."""
    eps, inv2s2 = float(epsilon), 1.0 / (2.0 * float(sigma) ** 2)
    c = 2.0 * inv2s2 * eps

    def term(dsq):
        return eps * torch.exp(-dsq * inv2s2)

    def gfn(dsq):
        return c * torch.exp(-dsq * inv2s2)

    return _pair(KIND_GAUSSIAN, (inv2s2, eps, c), term, gfn)


@functools.lru_cache(maxsize=None)
def morse(D: float = 1.0, a: float = 1.0, r0: float = 1.0) -> PairPotential:
    """D (1 - exp(-a (r - r0)))^2 - D (zero at the well minimum r0)."""
    D, a, r0 = float(D), float(a), float(r0)
    na, c = -a, -2.0 * D * a

    def term(dsq):
        y = 1.0 - torch.exp(na * (torch.sqrt(dsq) - r0))
        return D * (y * y) - D

    def gfn(dsq):
        # f = -(1/r) dV/dr; dV/dr = 2 D a x (1 - x), x = exp(-a (r - r0))
        r = torch.sqrt(dsq)
        x = torch.exp(na * (r - r0))
        return c * x * (1.0 - x) / r

    return _pair(KIND_MORSE, (D, na, r0, c), term, gfn)


@functools.lru_cache(maxsize=None)
def yukawa(A: float = 1.0, kappa: float = 1.0) -> PairPotential:
    """A exp(-kappa r) / r (screened Coulomb, Debye-Hueckel)."""
    A, k = float(A), float(kappa)
    nk = -k

    def term(dsq):
        r = torch.sqrt(dsq)
        return A * torch.exp(nk * r) / r

    def gfn(dsq):
        # f = -(1/r) dV/dr = A e^{-kr} (k r + 1) / r^3
        r = torch.sqrt(dsq)
        return A * torch.exp(nk * r) * (k * r + 1.0) / (dsq * r)

    return _pair(KIND_YUKAWA, (A, nk, k), term, gfn)


@functools.lru_cache(maxsize=None)
def buckingham(A: float = 1.0, rho: float = 1.0, C: float = 1.0) -> PairPotential:
    """A exp(-r/rho) - C / r^6 (exp-6)."""
    A, rho, C = float(A), float(rho), float(C)
    inv_rho, a_rho, c6 = 1.0 / rho, A / rho, 6.0 * C

    def term(dsq):
        r = torch.sqrt(dsq)
        return A * torch.exp(-r * inv_rho) - C * _cube(dsq).reciprocal()

    def gfn(dsq):
        # dV/dr = -(A/rho) e^{-r/rho} + 6 C / r^7; f = -(1/r) dV/dr
        r = torch.sqrt(dsq)
        d2 = dsq * dsq
        return a_rho * torch.exp(-r * inv_rho) / r - c6 * (d2 * d2).reciprocal()

    return _pair(KIND_BUCKINGHAM, (A, inv_rho, C, a_rho, c6), term, gfn)


@functools.lru_cache(maxsize=None)
def harmonic(k: float = 1.0, r0: float = 1.0) -> PairPotential:
    """0.5 k (r - r0)^2 for every cutoff pair (a soft restoring shell, not a
    bonded spring)."""
    k, r0 = float(k), float(r0)
    hk, nk = 0.5 * k, -k

    def term(dsq):
        y = torch.sqrt(dsq) - r0
        return hk * (y * y)

    def gfn(dsq):
        r = torch.sqrt(dsq)
        return nk * (r - r0) / r

    return _pair(KIND_HARMONIC, (hk, nk, r0), term, gfn)


@functools.lru_cache(maxsize=None)
def lennard_jones_mixed(eps: tuple, sigma: tuple) -> PairPotential:
    """Multi-species LJ with Lorentz-Berthelot mixing, as payload terms: both
    functions take ``(dsq, s_i, s_j)``, the s planes holding species ids
    0..S-1 (as floats). Per endpoint eps and sigma are selected one species
    at a time, starting from species 0 and overwritten where ``s == a`` for
    a in 1..S-1, so any other value (negative, fractional, >= S) takes
    species 0's; ``eps_ij = sqrt(eps_i eps_j)``, ``sigma_ij = (sigma_i +
    sigma_j) / 2``. Symmetric in (i, j).

    Feed it through the payload convention: ``pair_lag_reduce(
    sorted_payload=species[:, None], term=pot.term)``, ``pair_lag_forces(
    sorted_payload=..., gfn=pot.gfn)``, with the species column carried
    through the sort.
    """
    eps = tuple(float(e) for e in eps)
    sigma = tuple(float(s) for s in sigma)
    S = len(eps)
    if len(sigma) != S or S < 1:
        raise ValueError("lennard_jones_mixed needs one sigma per eps, at least one")

    def _mix(dsq, si, sj):
        ei = si * 0.0 + eps[0]
        sgi = si * 0.0 + sigma[0]
        ej = sj * 0.0 + eps[0]
        sgj = sj * 0.0 + sigma[0]
        for a in range(1, S):
            ia, ja = si == a, sj == a
            ei = torch.where(ia, eps[a], ei)
            sgi = torch.where(ia, sigma[a], sgi)
            ej = torch.where(ja, eps[a], ej)
            sgj = torch.where(ja, sigma[a], sgj)
        e_ij = torch.sqrt(ei * ej)
        s_ij = 0.5 * (sgi + sgj)
        return e_ij, s_ij * s_ij / dsq

    def term(dsq, si, sj):
        e_ij, x = _mix(dsq, si, sj)
        t = _cube(x)
        return 4.0 * e_ij * t * (t - 1.0)

    def gfn(dsq, si, sj):
        e_ij, x = _mix(dsq, si, sj)
        t = _cube(x)
        return 24.0 * e_ij * t * (2.0 * t - 1.0) / dsq

    spec = (eps, sigma)
    return PairPotential(_tag(term, KIND_MIXED_LJ, (), MODE_ENERGY, species=spec),
                         _tag(gfn, KIND_MIXED_LJ, (), MODE_GFN, species=spec))


def species_table(spec: TermSpec) -> list:
    """The S x S pair parameters of a species term, row-major (s_i, s_j):
    (eps_ij, sigma_ij) as the torch function computes them for f32
    tensors, in f32 arithmetic (the product of the two eps rounded, its
    square root rounded, the sum of the two sigma rounded and halved), so
    that a kernel reading them, squaring sigma_ij and dividing by dsq as the
    function does, evaluates the function's own f32 values. Raises above
    `MAX_SPECIES` species."""
    import numpy as np

    eps, sigma = spec.species
    S = len(eps)
    if S > MAX_SPECIES:
        raise ValueError(f"the kernels' species table takes at most {MAX_SPECIES} "
                         f"species; got {S}")
    e32, s32 = np.float32(eps), np.float32(sigma)
    out = []
    for i in range(S):
        for j in range(S):
            out += [float(np.sqrt(e32[i] * e32[j])), float(np.float32(0.5) * (s32[i] + s32[j]))]
    return out


@functools.lru_cache(maxsize=None)
def shifted(pot: PairPotential, cutoff: float) -> PairPotential:
    """Energy-shifted variant: V(r) - V(cutoff), forces unchanged, so pairs
    crossing the cutoff no longer jump the total energy. V(cutoff) is
    computed on the host in f64. Cached on (pot, cutoff)."""
    import inspect

    if len(inspect.signature(pot.term).parameters) != 1:
        raise ValueError(
            "shifted() supports scalar-dsq potentials only; a payload-"
            "parameterized potential (term(dsq, s_i, s_j)) needs a "
            "per-pair shift — subtract term(cutoff**2, s_i, s_j) inside "
            "a custom term instead"
        )
    vc = float(pot.term(torch.tensor(float(cutoff) ** 2, dtype=torch.float64)))
    inner = pot.term

    def term(dsq):
        return inner(dsq) - vc

    # one shift on the card: a shifted potential shifted again (two f32
    # subtractions) runs on CPU tensors only
    spec = getattr(inner, "table", None)
    if spec is not None and spec.shift == 0.0:
        _tag(term, spec.kind, spec.params, MODE_ENERGY, vc)
    return PairPotential(term, pot.gfn)
