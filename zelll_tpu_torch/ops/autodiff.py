"""Differentiable cutoff-pair potentials: `torch.autograd` and `torch.func`
through the fused pair kernels.

PyTorch counterpart of ``zelll_tpu/ops/autodiff.py``. The gradient of a
pair potential

    E(p) = sum over unique cutoff pairs (i, j) of term(dsq_ij)
    dE/dp_i = sum_j term'(dsq_ij) * 2 (p_i - p_j) = -f_i

is one of the forces kernels, with the factor convention ``f_i = sum_j
gfn(dsq) * (p_i - p_j)``, i.e. ``gfn(dsq) = -2 * term'(dsq)``. So
`make_pair_potential` returns a `torch.autograd.Function` whose forward pass
is the fused energy kernel (K1 on the lag path, K6 on the tile path) and
whose backward pass is the fused forces kernel (K3 or K7): analytic pair
forces in one launch, never differentiating through the sort or the kernels.

The forward pass sorts once and keeps what the backward pass needs (the
sorted coordinates, their keys and the permutation): the backward pass
scatters the sorted-slot forces back to the input order by the permutation.
The JAX package bins a second time in its backward pass and un-sorts by a
second sort, because a TPU kernel program avoids gathers; a CUDA card does
not need to, so a call with its gradient sorts once.

The returned callable maps (n, dim) positions to ``(energy, coverage_ok)``
and composes with ``torch.autograd.grad``, ``.backward()`` and
``torch.func.grad(..., has_aux=True)`` (the function is written in the
``setup_context`` form). The never-silently-drop invariant holds through
differentiation: the forward flag covers the energy, and a backward forces
kernel under its capacity poisons the gradient with NaN.

Cutoff-boundary caveat: E is almost-everywhere differentiable; a pair
sitting exactly at dsq == cutoff^2 contributes a jump if term(cutoff^2)
!= 0 (true for LJ), as in every MD code's convention.
"""

from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device
from ..core.binning import compute_keys, sort_by_key
from ..core.geometry import GridInfo, aabb_from_positions
from .lag_pairs import (
    is_species_term,
    lag_coverage_ok,
    lj_term,
    pair_lag_forces,
    pair_lag_reduce,
    split_f64,
)
from .lj import lj_force_factor
from .potentials import factory_gfn
from .tile_pairs import tile_pair_forces, tile_pair_reduce

__all__ = ["make_pair_potential", "gfn_from_term"]


def gfn_from_term(term: Callable) -> Callable:
    """Force factor ``gfn(dsq) = -2 * term'(dsq)`` derived from an
    elementwise energy term by autodiff (``torch.func.grad`` of the term
    under ``torch.func.vmap``, element by element, in the input's dtype).

    The derived function carries no term-table spec: the forces and stress
    kernels run it on CPU tensors only and raise on CUDA tensors. For a
    factory's term, `ops.potentials.factory_gfn` gives the factory's own
    gfn, which runs on the card."""
    dterm = torch.func.vmap(torch.func.grad(term))

    def gfn(dsq):
        flat = dsq.reshape(-1)
        if flat.numel() == 0:
            return torch.zeros_like(dsq)
        return (-2.0 * dterm(flat)).reshape(dsq.shape)

    return gfn


def _default_gfn(term: Callable) -> Callable:
    """The force factor of ``term`` when the caller gives none: the
    handwritten LJ factor for `lj_term`, a factory's own gfn for a
    factory's (or `shifted`) term, else `gfn_from_term`."""
    if term is lj_term:
        return lj_force_factor
    gfn = factory_gfn(term)
    return gfn if gfn is not None else gfn_from_term(term)


class _PairPotential(torch.autograd.Function):
    """E(positions) with the forces kernel as its backward pass. ``run`` is
    the potential's pair of closures (`make_pair_potential`): ``energy(p)``
    returns the energy, the flag and the sorted state the backward pass
    reads; ``grad(ct, state)`` the gradient in input order."""

    @staticmethod
    def forward(positions, run):
        return run[0](positions)

    @staticmethod
    def setup_context(ctx, inputs, output):
        positions, run = inputs
        ctx.grad, ctx.dtype = run[1], positions.dtype
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(*output[1:])

    @staticmethod
    def backward(ctx, ct_e, *_):
        return ctx.grad(ct_e, ctx.saved_tensors).to(ctx.dtype), None


def make_pair_potential(
    cutoff,
    *,
    term: Callable = lj_term,
    gfn: Callable | None = None,
    path: str = "lag",
    M: int = 8192,
    L: int = 256,
    CB: int = 8,
    MAXJ: int | tuple = 8,
    MAXJ_F: int | tuple | None = None,
    kahan: bool = True,
    split: bool = False,
    device=None,
) -> Callable:
    """Build a differentiable potential ``pot(positions) -> (E, ok)``.

    ``path='lag'`` uses the lag-window kernels (3-D, thin and benchmark
    boxes): K1 forward, K3 backward; ``path='tile'`` the segment-tile
    kernels (any box shape, 2-D or 3-D): K6 forward, K7 backward. Capacity
    classes as everywhere in the port: L for the lag path (M is accepted
    and has no effect), CB/MAXJ (energy, the half bands) and MAXJ_F
    (forces, the full bands; defaults to MAXJ's widest entry) for the tile
    path. ``kahan`` is passed to `tile_pair_reduce`.

    ``gfn`` overrides the force factor. Without it, `lj_term` takes the
    handwritten `lj_force_factor`, the term of an `ops.potentials` factory
    (or a `shifted` one) that factory's own gfn (`factory_gfn`), and any
    other term the factor `gfn_from_term` derives by autodiff.

    ``split=True`` splits the positions (cast to float64) into (hi, lo) f32
    planes carried through the sort (`lag_pairs.split_f64`), for
    f64-grade energies and gradients at f32 kernel speed; the energy then
    comes in float64 (the JAX package returns its kernels' f32 total).

    On a CUDA device the positions are float32, or float64 with
    ``split=True`` (the kernels take no f64 coordinates), and the term and
    force factor are ones the kernels take: `lj_term` with
    `lj_force_factor`, or an `ops.potentials` factory's functions (the
    device term table). A derived `gfn_from_term` factor raises there, and
    `ops.potentials.lennard_jones_mixed` raises everywhere: its species
    plane is a payload that this potential does not carry. CPU tensors (or
    ``device="cpu"``) run the plain versions, which take any term.

    Example::

        pot = make_pair_potential(cutoff, path="tile")
        g, (e, ok) = torch.func.grad_and_value(pot, has_aux=True)(positions)
        forces = -g
    """
    if path not in ("lag", "tile"):
        raise ValueError(f"path must be 'lag' or 'tile', got {path!r}")
    if is_species_term(term) or is_species_term(gfn):
        raise ValueError(
            "make_pair_potential carries no payload, and "
            "ops.potentials.lennard_jones_mixed reads a species plane: run it "
            "through pair_lag_reduce / pair_lag_forces with sorted_payload")
    if gfn is None:
        gfn = _default_gfn(term)
    if MAXJ_F is None:
        MAXJ_F = MAXJ if isinstance(MAXJ, int) else max(MAXJ)

    def energy(pos):
        """(E, ok, sorted hi, sorted lo (empty without split), sorted keys,
        strides, perm): one key computation and one sort."""
        dtype = pos.dtype
        if split:
            hi, lo = split_f64(pos.to(torch.float64))
        else:
            hi, lo = pos, None
        info = GridInfo.create(aabb_from_positions(hi), cutoff, auto_order=True)
        keys = compute_keys(hi, info)
        if lo is None:
            skeys, perm, shi = sort_by_key(keys, hi)
            slo = None
        else:
            skeys, perm, shi, slo = sort_by_key(keys, hi, lo)
        csq = torch.as_tensor(cutoff, dtype=shi.dtype) ** 2
        if path == "lag":
            e = pair_lag_reduce(shi, skeys, info.strides, csq, slo, M=M, L=L, term=term,
                                out_dtype=dtype)
            ok = lag_coverage_ok(skeys, info.strides, L)
        else:
            e, ok = tile_pair_reduce(shi, skeys, info.strides, csq, slo, CB=CB, MAXJ=MAXJ,
                                     term=term, kahan=kahan, out_dtype=dtype)
        empty = shi.new_empty((0,))
        return e, ok, shi, empty if slo is None else slo, skeys, info.strides, perm

    def grad(ct, state):
        """ct * -f in input order ((n, dim), a view of (dim, n) planes); NaN
        everywhere when the forces kernel's (or the lag path's) coverage
        flag is False."""
        ok, shi, slo, skeys, strides, perm = state
        slo = slo if slo.numel() else None
        csq = torch.as_tensor(cutoff, dtype=shi.dtype) ** 2
        if path == "lag":
            f = pair_lag_forces(shi, skeys, strides, csq, slo, M=M, L=L, gfn=gfn,
                                out_dtype=ct.dtype)
        else:
            f, ok = tile_pair_forces(shi, skeys, strides, csq, slo, CB=CB, MAXJ=MAXJ_F,
                                     gfn=gfn, out_dtype=ct.dtype)
        # the backward pass has no channel for a coverage flag, so an
        # under-capacity forces kernel poisons the gradient with NaN
        # instead of silently dropping pairs
        scale = torch.where(ok, -ct, torch.full_like(ct, float("nan")))
        # the kernels write (dim, n) planes: scatter them plane by plane
        planes = f.t()
        unsorted = torch.empty_like(planes).index_copy_(1, perm, planes)
        return (unsorted * scale).t()

    def pot(positions):
        positions = torch.as_tensor(positions, device=resolve_device(device, positions))
        if positions.device.type == "cuda" and not split and \
                positions.dtype != torch.float32:
            raise ValueError(
                "the kernels take float32 coordinates (or float64 split into f32 "
                f"planes): pass float32 positions or split=True, not {positions.dtype}")
        e, ok, *_ = _PairPotential.apply(positions, (energy, grad))
        return e, ok

    return pot
