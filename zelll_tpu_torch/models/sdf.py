"""Smooth distance field over a point cloud: the psssh case study.

PyTorch counterpart of ``zelll_tpu/models/sdf.py``, after the reference's
``surface-sampling`` crate (``sdf.rs``, ``sdf/numdual.rs``): a smooth
signed-distance-like field over protein atoms, queried through the cell
grid, with exact gradients.

Math (numdual.rs:11-61): over the atoms within the cutoff of a query x,
    S1 = sum exp(-d_i / r_i),  S2 = sum exp(-d_i) r_i,  S3 = sum exp(-d_i)
    sigma = S2 / S3           (exp-weighted mean vdW radius)
    sdf(x) = -sigma * ln(S1)
where an atom at d == 0 adds the constants (1, r_i, 1) with zero gradient
(numdual.rs:34-42). Element vdW radii follow atom.rs:14-28.

Two evaluation paths. The join path (``method="join"``, and ``"auto"`` on
3-D structures) sorts the queries by cell key and accumulates the 12 sums
of the field and its analytic gradient per query (`ops.sdf_join`): kernel
K12 on the card, its plain version on the CPU. The gather path
(``method="xla"``, the JAX package's name for it) gathers each query's
candidate atoms with `core.pairs.query_neighbors` and differentiates the
field with torch autograd. The field lives on ``device`` (CUDA unless the
caller passes ``device="cpu"``) in f64; the batch methods return numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..core.grid import CellGridData, build
from ..core.pairs import query_neighbors
from ..ops.join import JOIN_MAX_PARTICLES as _JOIN_MAX_ATOMS
from ..ops.join import join_reduce, maxj_ladder, query_join_reduce
from ..ops.sdf_join import NACC, sdf_term

__all__ = ["ELEMENT_RADII", "SmoothDistanceField", "element_radius"]

# van-der-Waals radii in Angstrom (reference atom.rs:17-27)
ELEMENT_RADII = {
    "C": 1.70,
    "H": 1.09,
    "O": 1.52,
    "N": 1.55,
    "S": 1.80,
    "SE": 1.90,
}
DEFAULT_ELEMENT = "C"

# queries per gather-path batch: each query gathers a padded 3^3 * K
# candidate window, so ~1e5 unchunked queries at a large K would take GBs
_QCHUNK = 4096


def element_radius(symbol: str) -> float:
    return ELEMENT_RADII[symbol.upper()]


def _sdf_from_neighbors(x, nb_pos, nb_radii, nb_mask, cutoff):
    """The field at (B, 3) queries ``x`` from their padded (B, S, 3)
    candidate atoms; differentiable in ``x``."""
    diff = x[:, None, :] - nb_pos
    dsq = (diff * diff).sum(-1)
    within = nb_mask & (dsq <= cutoff * cutoff)
    is_zero = dsq == 0.0
    live = within & ~is_zero

    # gradient-safe distance: the sqrt argument is 1 wherever masked out
    d = torch.sqrt(torch.where(live, dsq, torch.ones_like(dsq)))
    zero = torch.zeros_like(d)
    e1 = torch.where(live, torch.exp(-d / nb_radii), zero)
    e3 = torch.where(live, torch.exp(-d), zero)
    zero_term = (within & is_zero).to(d.dtype)

    s1 = (e1 + zero_term).sum(-1)
    s2 = (e3 * nb_radii + zero_term * nb_radii).sum(-1)
    s3 = (e3 + zero_term).sum(-1)
    sigma = s2 / s3
    return -sigma * torch.log(s1)


@dataclasses.dataclass(frozen=True)
class SdfData:
    """Device-side field state."""

    grid: CellGridData
    radii_sorted: torch.Tensor  # (n + 1,) vdW radius per sorted slot, 1 for slot n
    cutoff: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _JoinData:
    """The atom side prepared for the join."""

    pplanes: tuple  # 5 sorted (n,) planes: x, y, z, r, 1/r
    pkeys: torch.Tensor  # (n,) int32 ascending cell keys
    shape: torch.Tensor  # grid shape (3,) int32
    strides: torch.Tensor  # grid strides (3,) int32
    origin: torch.Tensor  # grid origin (3,)
    cutoff: torch.Tensor  # scalar, the grid's dtype


class SmoothDistanceField:
    """Smooth distance field with cell-grid queries.

    Mirrors `SmoothDistanceField` (sdf.rs:13-45): fields `surface_radius`
    (default 1.05) and `k_force` (default 10.0), the chainable setters
    `with_surface_radius`/`with_k_force`, and the batched `evaluate` and
    `hmc_gradient` (numdual.rs:67-86).
    """

    def __init__(self, positions, radii=None, cutoff: float = 4.0,
                 surface_radius: float = 1.05, k_force: float = 10.0,
                 method: str = "auto", *, device=None):
        positions = np.asarray(positions, np.float64)
        n = positions.shape[0]
        if radii is None:
            radii = np.full(n, ELEMENT_RADII[DEFAULT_ELEMENT])
        radii = np.asarray(radii, np.float64)
        self.surface_radius = float(surface_radius)
        self.k_force = float(k_force)
        self._cutoff = float(cutoff)
        if method not in ("auto", "join", "xla"):
            raise ValueError("method must be 'auto', 'join' or 'xla'")
        self._method = method
        self._device = resolve_device(device)

        grid = build(torch.as_tensor(positions, device=self._device), cutoff)
        perm = grid.bins.perm.long()
        radii_t = torch.as_tensor(radii, device=self._device)
        # radii in sorted-slot order so neighbour slots index directly; one
        # extra entry for the padding slot n
        radii_sorted = torch.cat([radii_t[perm],
                                  torch.ones((1,), dtype=radii_t.dtype,
                                             device=self._device)])
        dtype = grid.sorted_pos.dtype
        cut = torch.full((), float(cutoff), dtype=dtype, device=self._device)
        self.data = SdfData(grid=grid, radii_sorted=radii_sorted, cutoff=cut)
        self._K = int(grid.bins.max_cell_count()) if n else 0

        sp = grid.sorted_pos
        r_sorted = radii_sorted[:n].to(dtype)
        self._join = _JoinData(
            pplanes=(sp[:, 0], sp[:, 1], sp[:, 2], r_sorted, 1.0 / r_sorted),
            pkeys=grid.bins.sorted_keys,
            shape=grid.info.shape,
            strides=grid.info.strides,
            origin=grid.info.origin,
            cutoff=cut,
        )
        # structures above the TPU kernel's ceiling take the plain join's
        # windows; the capacity class is learned by flag retry and kept
        self._join_maxj = 8 if n > _JOIN_MAX_ATOMS else None

    @property
    def device(self) -> torch.device:
        return self._device

    def _use_join(self) -> bool:
        if self._method == "xla":
            return False
        if self._method == "join":
            return True
        # auto: every 3-D structure with atoms takes the join, on the card
        # through K12 and on the CPU through its plain version (where the
        # JAX package would run the Pallas kernel in interpret mode and so
        # takes its gather path instead)
        return self.data.grid.dim == 3 and self.data.grid.n > 0

    def _join_batch_auto(self, points):
        """`_sdf_join_batch` with the window capacity of
        `ops.join.maxj_ladder`, kept across calls. Returns (vals, grads,
        valid, ok)."""
        res, maxj = maxj_ladder(
            lambda M: _sdf_join_batch(self._join, points, MAXJ=M),
            self.data.grid.n, maxj0=self._join_maxj or 8)
        if maxj is not None:
            self._join_maxj = maxj
        return res

    def with_surface_radius(self, r: float) -> "SmoothDistanceField":
        self.surface_radius = float(r)
        return self

    def with_k_force(self, k: float) -> "SmoothDistanceField":
        self.k_force = float(k)
        return self

    def _field(self, points):
        """(values, grads, valid) tensors at (Q, 3) ``points``: the join
        path unless ``method="xla"``. Where the plain join's flag fails on
        the CPU, the gather path answers and `ops.join.join_reduce.fallbacks`
        counts it; on the card K12 answers or this raises."""
        points = torch.as_tensor(points, device=self._device).to(
            self.data.grid.sorted_pos.dtype)
        points = points[None, :] if points.ndim == 1 else points
        if self._use_join():
            v, g, valid, ok = self._join_batch_auto(points)
            if bool(ok):
                return v, g, valid
            if points.is_cuda:
                raise RuntimeError("the join's flag failed on the card")
            join_reduce.fallbacks += 1
        return _evaluate_batch(self.data, points, self._K)

    # -- batched field evaluation -------------------------------------------

    def evaluate(self, points):
        """(Q, 3) queries -> (values (Q,), grads (Q, 3), valid (Q,)), numpy.

        The batched `evaluate` (numdual.rs:67-70); ``valid`` False is the
        reference's None for a query more than one cell layer outside the
        grid.
        """
        return tuple(x.cpu().numpy() for x in self._field(points))

    def hmc_gradient(self, points, isoradius: float | None = None):
        """(value, grad, valid) of the harmonic iso-surface log-density
        -k (sdf(x) - isoradius)^2 (numdual.rs:72-86, 98-104), numpy."""
        iso = self.surface_radius if isoradius is None else float(isoradius)
        v, g, valid = self._field(points)
        pot = -self.k_force * (v - iso) ** 2
        gpot = (-2.0 * self.k_force) * (v - iso)[:, None] * g
        return pot.cpu().numpy(), gpot.cpu().numpy(), valid.cpu().numpy()

    def logdensity_fn(self, isoradius: float | None = None):
        """Batched log density through the gather path: ``f(points (C, 3))
        -> logp (C,)``, differentiable by torch autograd (for samplers
        without ``value_and_grad_fn``); -inf outside the grid."""
        iso = self.surface_radius if isoradius is None else float(isoradius)
        data, K, k_force = self.data, self._K, self.k_force

        def logp(x):
            val, ok = _sdf_points(data, x, K)
            pot = -k_force * (val - iso) ** 2
            return torch.where(ok, pot, torch.full_like(pot, float("-inf")))

        return logp

    def hmc_vgrad_fn(self, isoradius: float | None = None):
        """Batched (logp, grad) of the iso-surface density through the join:
        ``f(points (C, 3)) -> (logp (C,), grad (C, 3))``, tensors on the
        field's device, one K12 launch per call on the card and no
        read-back. This is the samplers' hot path (one call per leapfrog
        step for all chains). Out-of-grid or neighbourless points get
        logp = -inf and zero gradient (the reference's recoverable
        SurfaceSdfError, surface.rs:10-14).

        The join's flag depends only on the grid's keys and on the range
        of the clipped query keys, not on the query values, so it is
        checked once here, on the two extreme grid corners, and the
        returned function is flag-free. As in the JAX package, structures
        above `ops.join.JOIN_MAX_PARTICLES` atoms raise ValueError (its
        windowed kernel's flag depends on the query values); K12 itself
        has no such ceiling.
        """
        iso = self.surface_radius if isoradius is None else float(isoradius)
        jd, k_force = self._join, self.k_force
        if self.data.grid.n > _JOIN_MAX_ATOMS:
            raise ValueError(
                f"hmc_vgrad_fn needs a structure of at most {_JOIN_MAX_ATOMS} "
                "atoms; use logdensity_fn or evaluate/hmc_gradient (per-call "
                "flags) for larger structures")
        dtype = self.data.grid.sorted_pos.dtype
        corner_hi = (jd.origin + (jd.shape + 2) * jd.cutoff).to(dtype)
        corner_lo = (jd.origin - 2.0 * jd.cutoff).to(dtype)
        probe = torch.cat([corner_hi.expand(4, 3), corner_lo.expand(4, 3)])
        _, _, _, ok = _sdf_join_batch(jd, probe)
        if not bool(ok):
            raise RuntimeError(
                "the join's key preconditions fail for this grid; use "
                "logdensity_fn instead")

        def vgrad(q):
            v, g, valid, _ = _sdf_join_batch(jd, q)
            defined = valid & torch.isfinite(v)
            pot = -k_force * (v - iso) ** 2
            logp = torch.where(defined, pot, torch.full_like(pot, float("-inf")))
            gpot = torch.where(defined[:, None],
                               (-2.0 * k_force) * (v - iso)[:, None] * g,
                               torch.zeros_like(g))
            return logp, gpot

        return vgrad


def _sdf_points(data: SdfData, x, K: int):
    """The field at (B, 3) points through the gather path. Returns
    (values, valid). The candidate set is selected on the detached
    coordinates, as the reference selects the neighbourhood by the real
    part of its dual numbers (numdual.rs:16-21); gradients flow through the
    distance terms."""
    res = query_neighbors(data.grid, x.detach(), K=K)
    radii = data.radii_sorted[res.slots.long()]
    val = _sdf_from_neighbors(x, res.pos, radii, res.mask, data.cutoff)
    return val, res.valid


def _evaluate_batch(data: SdfData, points, K: int):
    """Values, gradients (torch autograd) and valid flags of the gather
    path, in batches of `_QCHUNK` queries."""
    vals, grads, oks = [], [], []
    for c0 in range(0, points.shape[0], _QCHUNK):
        with torch.enable_grad():
            x = points[c0:c0 + _QCHUNK].detach().requires_grad_(True)
            val, ok = _sdf_points(data, x, K)
            (g,) = torch.autograd.grad(val.sum(), x)
        vals.append(val.detach())
        grads.append(g)
        oks.append(ok)
    if not vals:
        z = points.new_zeros((0,))
        return z, points.new_zeros((0, 3)), torch.zeros((0,), dtype=torch.bool,
                                                         device=points.device)
    return torch.cat(vals), torch.cat(grads), torch.cat(oks)


def _sdf_join_batch(jd: _JoinData, points, CB: int = 8, MAXJ: int | None = None):
    """The field's values and analytic gradients through the join.

    Returns (vals (Q,), grads (Q, 3), valid (Q,), ok). The queries go
    through `ops.join.query_join_reduce` (keys, sort, K12 or its plain
    version, un-sort) with the SDF term, and the 12 sums close over value
    and gradient:
        sigma = S2/S3, val = -sigma*ln(S1)
        grad  = ln(S1)*(A2*S3 - S2*A3)/S3^2 + sigma*A1/S1
    (the derivative of `_sdf_from_neighbors` with grad S1 = -A1 etc.).
    """
    sums, valid, ok = query_join_reduce(
        points, jd.origin, jd.shape, jd.strides, jd.cutoff, jd.pplanes,
        jd.pkeys, term=sdf_term, n_out=NACC, CB=CB, MAXJ=MAXJ, keys_sorted=True)
    S1, S2, S3 = sums[:, 0], sums[:, 1], sums[:, 2]
    A1, A2, A3 = sums[:, 3:6], sums[:, 6:9], sums[:, 9:12]
    sigma = S2 / S3
    lnS1 = torch.log(S1)
    vals = -sigma * lnS1
    grads = (lnS1[:, None] * (A2 * S3[:, None] - S2[:, None] * A3)
             / (S3 * S3)[:, None] + (sigma / S1)[:, None] * A1)
    return vals, grads, valid, ok
