"""Geometry primitives: axis-aligned bounding boxes, grid geometry, stencils.

PyTorch counterpart of ``zelll_tpu/core/geometry.py``. Same semantics, so
flat cell keys, strides and stencils are bitwise equal to the JAX package's
for the same input dtype:

* cell edge length == cutoff; ``shape = floor((sup - inf)/cutoff) + 1``
* strides are the exclusive cumulative product of ``shape + 4`` (two
  implicit padding layers per axis), so the 3^N - 1 relative neighbour
  offsets are unique integers
* flat cell key == ``floor((p - origin)/cutoff) . strides``, no bounds check
* the relative stencil is the lexicographic product of ``(-1, 0, 1)^N``
  with the centre removed; the half-space stencil is its first half.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .._device import resolve_device

__all__ = [
    "SENTINEL_KEY",
    "Aabb",
    "GridInfo",
    "aabb_from_positions",
    "rel_offsets",
    "full_stencil",
    "half_stencil",
    "generate_pointcloud",
    "key_window",
]

# Flat key of padded / invalid particles: sorts after every real key.
SENTINEL_KEY = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class Aabb:
    """Axis-aligned bounding box: componentwise infimum and supremum."""

    inf: torch.Tensor  # (N,)
    sup: torch.Tensor  # (N,)

    @property
    def dim(self) -> int:
        return self.inf.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.inf.device


def aabb_from_positions(positions, valid=None, *, device=None) -> Aabb:
    """Componentwise min/max over (n, N) ``positions``.

    ``valid`` optionally masks out padding rows. With no (valid) particle
    the box degenerates to the origin.
    """
    device = resolve_device(device, positions)
    positions = torch.as_tensor(positions, device=device)
    n, dim = positions.shape
    if n == 0:
        z = torch.zeros((dim,), dtype=positions.dtype, device=device)
        return Aabb(inf=z, sup=z)
    if valid is None:
        return Aabb(inf=positions.amin(0), sup=positions.amax(0))
    valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    big = torch.finfo(positions.dtype).max
    v = valid[:, None]
    inf = torch.where(v, positions, big).amin(0)
    sup = torch.where(v, positions, -big).amax(0)
    zero = torch.zeros_like(inf)
    any_valid = valid.any()
    return Aabb(inf=torch.where(any_valid, inf, zero),
                sup=torch.where(any_valid, sup, zero))


@dataclasses.dataclass(frozen=True)
class GridInfo:
    """Grid geometry: origin, cutoff, integer shape and padded strides.

    >>> import torch
    >>> aabb = Aabb(torch.zeros(3), torch.tensor([2.5, 2.5, 2.5]))
    >>> info = GridInfo.create(aabb, 1.0)
    >>> info.shape.tolist(), info.strides.tolist()
    ([3, 3, 3], [1, 7, 49])
    >>> int(info.flat_cell_index(torch.tensor([1.2, 0.1, 2.3])))
    99
    """

    aabb: Aabb
    cutoff: torch.Tensor  # scalar, in the box's dtype
    shape: torch.Tensor  # (N,) int32
    strides: torch.Tensor  # (N,) int32

    @property
    def dim(self) -> int:
        return self.shape.shape[-1]

    @property
    def origin(self) -> torch.Tensor:
        return self.aabb.inf

    @property
    def device(self) -> torch.device:
        return self.shape.device

    @classmethod
    def create(cls, aabb: Aabb, cutoff, auto_order: bool = False) -> "GridInfo":
        """Grid geometry from a bounding box and a cutoff.

        ``shape[i] = floor((sup - inf)/cutoff) + 1``; strides are the
        exclusive cumulative product of ``shape + 4``, axis 0 fastest.
        ``auto_order=True`` gives the smallest stride to the axis with the
        fewest cells (a stable sort: ties keep axis order), so the key window
        depends on the two smallest extents whatever the box's orientation.
        """
        if isinstance(cutoff, torch.Tensor) and cutoff.device == aabb.device:
            cutoff = cutoff.to(aabb.inf.dtype)
        else:
            # a fill, not a copy from host memory: a copy would wait for
            # the device's queue
            cutoff = torch.full((), float(cutoff), dtype=aabb.inf.dtype,
                                device=aabb.device)
        extent = (aabb.sup - aabb.inf) / cutoff
        shape = torch.floor(extent).to(torch.int32) + 1
        if auto_order:
            perm = torch.argsort(shape, stable=True)
            padded = shape[perm] + 4
        else:
            padded = shape + 4
        one = torch.ones((1,), dtype=torch.int32, device=aabb.device)
        strides = torch.cat([one, torch.cumprod(padded[:-1], 0, dtype=torch.int32)])
        if auto_order:
            strides = torch.empty_like(strides).scatter_(0, perm, strides)
        return cls(aabb=aabb, cutoff=cutoff, shape=shape, strides=strides)

    def cell_index(self, coords: torch.Tensor) -> torch.Tensor:
        """Integer cell coordinates of (.., N) points, no bounds check."""
        return torch.floor((coords - self.origin) / self.cutoff).to(torch.int32)

    def try_cell_index(self, coords: torch.Tensor):
        """Cell coordinates plus a mask: valid iff every component lies in
        ``[-1, shape]`` (one implicit padding layer may be queried)."""
        idx = self.cell_index(coords)
        ok = ((idx >= -1) & (idx <= self.shape)).all(-1)
        return idx, ok

    def flatten_index(self, idx: torch.Tensor) -> torch.Tensor:
        """Dot with strides: (.., N) int -> (..,) flat key."""
        total = idx[..., 0] * self.strides[0]
        for a in range(1, self.dim):
            total = total + idx[..., a] * self.strides[a]
        return total

    def flat_cell_index(self, coords: torch.Tensor) -> torch.Tensor:
        """Coordinates -> flat key, no bounds check."""
        return self.flatten_index(self.cell_index(coords))


def key_window(strides, reach=None) -> torch.Tensor:
    """Max |flat key difference| over the rank-1 stencil: ``sum(strides)``.

    Holds for any per-axis stride assignment, ``auto_order`` included.
    ``reach`` (per-axis int, default 1) widens the per-axis cell distance:
    a minimum-image periodic axis treats every cell along it as adjacent,
    so its reach is the occupied cell span (``ceil(box/cutoff) - 1``) and
    the window becomes ``sum(strides * reach)``.
    """
    strides = torch.as_tensor(strides)
    if reach is None:
        return strides.sum(dtype=torch.int32)
    reach = torch.as_tensor(reach, dtype=strides.dtype, device=strides.device)
    return (strides * reach).sum(dtype=torch.int32)


def rel_offsets(dim: int) -> np.ndarray:
    """(3^N - 1, N) int32 relative neighbour cell coordinates, lexicographic,
    centre removed. Negation-symmetric: entry k == -entry[-1-k]."""
    offs = [o for o in itertools.product((-1, 0, 1), repeat=dim) if any(o)]
    return np.asarray(offs, dtype=np.int32)


def full_stencil(info: GridInfo) -> torch.Tensor:
    """(3^N - 1,) flat relative neighbour keys."""
    rel = torch.as_tensor(rel_offsets(info.dim), device=info.device)
    return (rel * info.strides).sum(-1, dtype=torch.int32)


def half_stencil(info: GridInfo) -> torch.Tensor:
    """First half of the full stencil: one of each +/- offset pair."""
    full = full_stencil(info)
    return full[: full.shape[0] // 2]


def generate_pointcloud(shape, cutoff: float, origin) -> np.ndarray:
    """Deterministic chessboard point cloud: cells with x+y+z even hold two
    points, one at the cell origin and one at its centre. (n, 3) float64."""
    pts = []
    for x in range(shape[0]):
        for y in range(shape[1]):
            for z in range(shape[2]):
                if (x + y + z) % 2 == 0:
                    pts.append([cutoff * x + origin[0],
                                cutoff * y + origin[1],
                                cutoff * z + origin[2]])
                    pts.append([cutoff * x + (cutoff * 0.5 + origin[0]),
                                cutoff * y + (cutoff * 0.5 + origin[1]),
                                cutoff * z + (cutoff * 0.5 + origin[2])])
    return np.asarray(pts, dtype=np.float64).reshape(-1, 3)
