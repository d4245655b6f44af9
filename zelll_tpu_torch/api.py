"""User-facing `CellGrid` class mirroring the reference Python bindings.

PyTorch counterpart of ``zelll_tpu/api.py``. API parity with the PyO3
module `zelll` (reference `python/zelll.pyi:1-22`, `python/src/lib.rs`):

* ``CellGrid(particles=None, cutoff=1.0)`` — build from an iterable of 3D
  coordinates (or any (n, dim) array-like)          (lib.rs:111-131)
* ``rebuild(particles, cutoff=None)``               (lib.rs:155-166)
* ``__iter__`` — iterator over unique *candidate* particle pairs
  ``((i, [x,y,z]), (j, [x,y,z]))``                  (lib.rs:168-170, 262-345)
* ``aabb() -> (inf, sup)``                          (lib.rs:174-180)
* ``cutoff() -> float``                             (lib.rs:183-185)
* ``query_neighbors(coords)`` — lazy iterator of (i, coords) in the full
  27-cell neighborhood, or None if too far outside  (lib.rs:204-210)
* ``neighbors(coords)`` — eager, distance-filtered list (lib.rs:228-241)
* pickle support via ``__getstate__``/``__setstate__`` (lib.rs:243-259) —
  state is (positions, cutoff, dense, device); the grid is rebuilt on
  unpickle

Deviations (documented):
* Iteration never does per-pair host transfers: pairs are materialised
  on the device in one fused pass and transferred once.
* Like the reference's input adapter (lib.rs:40-58), items of a generic
  iterable that don't convert to 3 floats are silently skipped; array
  inputs are validated strictly.
* ``rebuild()`` while iterators are alive is safe here (the grid is an
  immutable snapshot) — the reference raises RuntimeError; existing
  iterators keep iterating the old snapshot.

Per-cell surface (reference `src/cellgrid/iters.rs:121-291`):
``query(coords) -> GridCell | None`` (empty-cell tolerant handle),
``cells()`` iterating occupied cells, and `GridCell` with ``index``,
``__len__``, ``__iter__``/``particles()``, ``neighbors(space)`` and
``particle_pairs()`` — host-side views over the CSR cell table (one
device-to-host pull of the table, cached per build).

Extensions: ``query_neighbors_batch``, ``count_neighbors_batch`` and
``nearest_neighbor_distances`` (kernel K12 on the card), ``pairs``,
``coordination_numbers`` (kernel K2 on the card), ``distance_histogram``
(kernels K5 and K9 on the card), ``lj_energy``,
``virial``, ``stress``, ``positions``, ``grid_data``.

The grid lives on ``device`` (CUDA unless the caller passes
``device="cpu"``) and holds f64 coordinates. Every method returns numpy
arrays or Python numbers, so each reads its result back to the host.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from ._device import resolve_device

__all__ = ["CellGrid", "GridCell"]


class GridCell:
    """Copyable handle to one grid cell — the analogue of the reference's
    `GridCell` (src/cellgrid/iters.rs:121-242): a (grid, flat index) pair
    that tolerates empty cells (iters.rs:154-168 returns an empty iterator
    for a vacant key).

    Host-side view: cell membership reads the CSR table snapshot the
    handle was created from; `CellGrid.rebuild` leaves existing handles
    iterating the old snapshot (same contract as `__iter__`).
    """

    __slots__ = ("_snap", "_index")

    def __init__(self, snap: dict, index: int):
        self._snap = snap
        self._index = int(index)

    @property
    def index(self) -> int:
        """Flat cell key (reference iters.rs:137)."""
        return self._index

    def _row(self) -> int:
        """Row in the occupied-cell table, or -1 if the cell is empty."""
        s = self._snap
        r = int(np.searchsorted(s["cell_keys"], self._index))
        if r < s["num_cells"] and int(s["cell_keys"][r]) == self._index:
            return r
        return -1

    def __len__(self) -> int:
        r = self._row()
        return 0 if r < 0 else int(self._snap["cell_counts"][r])

    def __iter__(self):
        """(index, [x, y, z]) per particle in this cell (iters.rs:154-168)."""
        r = self._row()
        if r < 0:
            return iter(())
        s = self._snap
        lo = int(s["cell_starts"][r])
        hi = lo + int(s["cell_counts"][r])
        pts = s["pts"]
        return iter(
            [(int(k), pts[int(k)].tolist()) for k in s["sorted_ids"][lo:hi]]
        )

    def particles(self):
        """Alias of ``__iter__`` (reference GridCell::iter)."""
        return iter(self)

    def neighbors(self, space: str = "full"):
        """Occupied neighbor cells as GridCell handles
        (iters.rs:197-214). ``space="full"`` gives all 3^N - 1 stencil
        cells, ``"half"`` the negation-symmetric half (the half-space
        trick, iters.rs:58-63)."""
        s = self._snap
        offs = s["half_offsets"] if space == "half" else s["full_offsets"]
        if space not in ("full", "half"):
            raise ValueError(f"space must be 'full' or 'half', got {space!r}")
        out = []
        for off in offs:
            c = GridCell(s, self._index + int(off))
            if c._row() >= 0:
                out.append(c)
        return out

    def particle_pairs(self):
        """Unique candidate pairs ((i, p), (j, q)) touching this cell:
        the triangular intra-cell pairs plus the cartesian products with
        the half-stencil neighbor cells (iters.rs:218-241). Summed over
        all occupied cells this enumerates every unique candidate pair
        exactly once (the grid-level ``__iter__`` contract)."""
        own = list(self)
        out = [
            (own[a], own[b])
            for a in range(len(own))
            for b in range(a + 1, len(own))
        ]
        for cell in self.neighbors("half"):
            theirs = list(cell)
            out.extend((p, q) for p in own for q in theirs)
        return out

    def __repr__(self):
        return f"GridCell(index={self._index}, len={len(self)})"


def _coerce_particles(particles, dim: int = 3) -> np.ndarray:
    """Array inputs: strict, any dimension >= 2 (the reference CellGrid
    is const-generic over N, lib.rs:132-135; its PyO3 bindings pin
    N = 3, python/src/lib.rs:98-100 — this class accepts both). Generic
    iterables: silently skip items that don't convert to ``dim`` floats
    (reference lib.rs:40-58 behavior)."""
    if particles is None:
        return np.zeros((0, dim), np.float64)
    if isinstance(particles, np.ndarray):
        arr = np.asarray(particles, np.float64)
        if arr.ndim != 2 or arr.shape[1] < 2:
            raise TypeError(f"expected an (n, dim>=2) array, got {arr.shape}")
        return arr
    try:
        arr = np.asarray(particles, np.float64)
        if arr.ndim == 2 and arr.shape[1] >= 2:
            return arr
    except (TypeError, ValueError):
        pass
    rows = []
    for item in particles:
        try:
            row = [float(c) for c in item]
        except (TypeError, ValueError):
            continue
        if len(row) == dim:
            rows.append(row)
    return np.asarray(rows, np.float64).reshape(-1, dim)


def _pad_far(pts: np.ndarray, n_pad: int) -> np.ndarray:
    """Pad to n_pad rows with far-away, mutually spread coordinates so
    padding rows can never appear as spurious neighbors of real particles
    (they are also key-sentineled via the valid mask, but fused kernels
    filter purely by distance)."""
    n, dim = pts.shape
    padded = np.empty((n_pad, dim), pts.dtype)
    padded[:n] = pts
    if n_pad > n:
        # 2D spread grid: spacing 2^17 is an exact multiple of the f32 ulp
        # at 1e12 (2^16), so rows stay >= 2^17 apart after f32 rounding
        # (1e5 spacing quantizes to as little as 3.4e4), and the grid keeps
        # the family's extent ~sqrt(n_pad)*2^17 — far below the kernels'
        # 7e12 tail-padding family even at n_pad = 1e8 (a linear 1D spread
        # would cross it at ~6e7 rows).
        k = np.arange(1, n_pad - n + 1, dtype=np.float64)
        side = int(np.ceil(np.sqrt(n_pad - n))) + 1
        s = 2.0**17
        padded[n:, 0] = 1e12 + (k % side) * s
        padded[n:, 1] = 1e12 + (k // side + 1) * s
        padded[n:, 2:] = 1e12
    return padded


def _round_capacity(n: int) -> int:
    """Pad particle counts to capacity classes to bound recompilation."""
    if n <= 128:
        return max(n, 1)
    return 1 << (n - 1).bit_length()




class CellGrid:
    """A grid of cells providing the cell-lists algorithm on the card.

    See the module docstring for the API contract. The functional core
    (`zelll_tpu_torch.core`) does the work; this class does the host-side
    orchestration: capacity classes, padding, and iterator
    materialisation. ``device`` is where the grid lives (CUDA unless
    given).

    Runnable contract (the reference's doc-tests, e.g. util.rs:268-286):

    >>> import numpy as np
    >>> pts = np.array([[0.1, 0.1, 0.1], [0.4, 0.2, 0.1], [2.5, 2.5, 2.5]])
    >>> cg = CellGrid(pts, cutoff=1.0, device="cpu")
    >>> cg.cutoff()
    1.0
    >>> sorted((i, j) for (i, _), (j, _) in cg)  # one candidate pair
    [(0, 1)]
    >>> sorted(i for i, _ in cg.neighbors([0.0, 0.0, 0.0]))
    [0, 1]
    >>> cg.query_neighbors([99.0, 99.0, 99.0]) is None  # > 1 layer outside
    True
    >>> cell = cg.query(pts[0])          # per-cell handle (iters.rs:121)
    >>> len(cell), sorted(i for i, _ in cell)
    (2, [0, 1])
    >>> len(cg.query([1.5, 1.5, 1.5]))   # empty cell: live, empty handle
    0
    >>> [len(c) for c in cg.cells()]     # occupied cells, ascending key
    [2, 1]
    >>> cg.coordination_numbers().tolist()
    [1, 1, 0]
    >>> import pickle
    >>> cg2 = pickle.loads(pickle.dumps(cg))
    >>> np.allclose(cg2.positions, pts) and cg2.cutoff() == 1.0
    True
    >>> inputs = [(0.0, 0.0, 0.0), "bad", (1.0, 1.0)]  # silent-skip
    >>> len(CellGrid(inputs, cutoff=1.0, device="cpu").positions)
    1
    >>> CellGrid(np.zeros((2, 1)), device="cpu")  # dim >= 2 required
    Traceback (most recent call last):
        ...
    TypeError: expected an (n, dim>=2) array, got (2, 1)
    """

    def __init__(self, particles=None, /, cutoff: float = 1.0,
                 dense: bool = False, *, device=None):
        self._use_dense = bool(dense)
        self._device = resolve_device(device, particles)
        if isinstance(particles, torch.Tensor):
            particles = particles.detach().cpu().numpy()
        self._build(_coerce_particles(particles), float(cutoff))

    # -- construction ------------------------------------------------------

    def _padded(self, pts: np.ndarray, n_pad: int):
        """Far-padded f64 coordinates and the valid mask, on the device."""
        valid = np.arange(n_pad) < pts.shape[0]
        return (torch.as_tensor(_pad_far(pts, n_pad), device=self._device),
                torch.as_tensor(valid, device=self._device))

    def _build(self, pts: np.ndarray, cutoff: float):
        from .core import build

        self._pts = pts
        self._cutoff = cutoff
        self._snap = None  # lazy host cell-table snapshot (per-cell API)
        n = pts.shape[0]
        if n == 0:
            self._grid = None
            self._K = 0
            self._dense = None
            return
        padded, valid = self._padded(pts, _round_capacity(n))
        self._grid = build(padded, cutoff, valid=valid)
        self._K = int(self._grid.bins.max_cell_count())
        self._refresh_dense()

    # dense key->cell lookup table: the wired sparse-vs-dense GridStorage
    # axis (reference storage.rs:172-302 sketches it but never wires it).
    # Opt-in, compact boxes only: O(prod(padded_shape)) memory.
    _DENSE_MAX = 1 << 22

    def _refresh_dense(self):
        self._dense = None
        if not self._use_dense or self._grid is None:
            return
        from .core import build_dense_table

        cap = int(torch.prod(self._grid.info.shape.long() + 4))
        if cap > self._DENSE_MAX:
            return  # fall back to binary search; sparse boxes stay O(n)
        t = build_dense_table(self._grid.bins, cap)
        if bool(t.fits):
            self._dense = t

    def rebuild(self, particles, /, cutoff: float | None = None) -> None:
        """Rebuild from new data (reference lib.rs:155-166). Goes through
        the functional `core.rebuild` (its no-key-changed fast path) when
        the particle capacity class is unchanged."""
        from .core import rebuild as core_rebuild

        if isinstance(particles, torch.Tensor):
            particles = particles.detach().cpu().numpy()
        pts = _coerce_particles(particles)
        cut = self._cutoff if cutoff is None else float(cutoff)
        n = pts.shape[0]
        if (self._grid is not None and _round_capacity(n) == self._grid.n
                and pts.shape[1] == self._pts.shape[1]):
            padded, valid = self._padded(pts, self._grid.n)
            self._grid = core_rebuild(self._grid, padded, cut, valid=valid)
            self._pts = pts
            self._cutoff = cut
            self._K = int(self._grid.bins.max_cell_count())
            self._refresh_dense()
            self._snap = None
        else:
            self._build(pts, cut)

    # -- reference API surface ---------------------------------------------

    def aabb(self) -> tuple[list[float], list[float]]:
        """Bounding box as (inf, sup) dim-lists (reference lib.rs:174-180)."""
        if len(self._pts) == 0:
            z = [0.0] * self._pts.shape[1]
            return (list(z), list(z))
        return (self._pts.min(axis=0).tolist(), self._pts.max(axis=0).tolist())

    def cutoff(self) -> float:
        return self._cutoff

    def __iter__(self) -> Iterator:
        """Iterate unique candidate pairs ((i, p), (j, q)).

        Pair order is unspecified (reference iters.rs:251). Materialised on
        the device in one pass, transferred once.
        """
        i, j = self._pair_arrays()
        pts = self._pts
        for a, b in zip(i.tolist(), j.tolist()):
            yield ((a, pts[a].tolist()), (b, pts[b].tolist()))

    def _chunk(self) -> int:
        return min(256, self._grid.bins.max_cells)

    def _pair_arrays(self, cutoff_sq=None) -> tuple[np.ndarray, np.ndarray]:
        """Unique pairs (candidates, or within ``cutoff_sq``) as int64 id
        arrays: one counting pass, then one materialising pass into a
        buffer of the counted size's capacity class."""
        empty = np.zeros(0, np.int64), np.zeros(0, np.int64)
        if self._grid is None or len(self._pts) < 2:
            return empty
        from .core import count_pairs, materialize_pairs

        g = self._grid
        kw = dict(K=self._K, chunk=self._chunk(), cutoff_sq=cutoff_sq,
                  dense=self._dense)
        total = int(count_pairs(g, **kw))
        if total == 0:
            return empty
        i, j, cnt, overflow = materialize_pairs(g, max_pairs=_round_capacity(total), **kw)
        cnt = int(cnt)
        if bool(overflow) or cnt != total:
            raise RuntimeError(f"materialised {cnt} pairs after counting {total}")
        return (i[:cnt].cpu().numpy().astype(np.int64),
                j[:cnt].cpu().numpy().astype(np.int64))

    # -- per-cell surface (reference iters.rs:121-291) ---------------------

    def _cell_snapshot(self) -> dict | None:
        """One host pull of the CSR cell table + stencil offsets, cached
        per build; `GridCell` handles hold a reference, so they keep
        iterating their snapshot across rebuilds (documented contract)."""
        if self._grid is None:
            return None
        if self._snap is None:
            from .core.geometry import half_stencil, rel_offsets

            g = self._grid
            nc = int(g.bins.num_cells)
            strides = g.info.strides.cpu().numpy()
            # the grid bins on min(dim, 3) leading axes (higher-N inputs
            # keep exact N-D distance filtering on top of 3D cells)
            full = rel_offsets(len(strides)) @ strides
            self._snap = {
                "cell_keys": g.bins.cell_keys[:nc].cpu().numpy(),
                "cell_starts": g.bins.cell_starts[:nc].cpu().numpy(),
                "cell_counts": g.bins.cell_counts[:nc].cpu().numpy(),
                "num_cells": nc,
                "sorted_ids": g.sorted_ids.cpu().numpy(),
                "pts": self._pts,
                "full_offsets": full,
                "half_offsets": half_stencil(g.info).cpu().numpy(),
                "origin": g.info.origin.cpu().numpy(),
                "shape": g.info.shape.cpu().numpy(),
                "strides": strides,
            }
        return self._snap

    def query(self, coordinates: Sequence[float]):
        """`GridCell` handle for the cell containing ``coordinates``, or
        None when the location is more than one cell layer outside the
        grid (reference cellgrid.rs:360-365 via util.rs:245-256). The
        handle tolerates empty cells — ``len(cell) == 0``, iteration
        yields nothing (iters.rs:154-168)."""
        snap = self._cell_snapshot()
        if snap is None:
            return None
        q = np.asarray(coordinates, np.float64).reshape(-1)
        q = q[: len(snap["strides"])]  # grid axes (min(dim, 3))
        c = np.floor((q - snap["origin"]) / self._cutoff).astype(np.int64)
        if np.any(c < -1) or np.any(c > snap["shape"]):
            return None
        return GridCell(snap, int(c @ snap["strides"]))

    def cells(self):
        """Iterator of `GridCell` handles over the OCCUPIED cells
        (reference CellGrid::iter, iters.rs:261-291; order unspecified
        there, ascending flat key here)."""
        snap = self._cell_snapshot()
        if snap is None:
            return iter(())
        return iter([GridCell(snap, int(k)) for k in snap["cell_keys"]])

    def query_neighbors(self, coordinates: Sequence[float]):
        """Iterator of (index, [x, y, z]) over the full-space neighborhood
        of the query location, or None if the location is farther than one
        cell layer outside the grid (reference lib.rs:204-210). Items may
        be farther than cutoff (candidate semantics)."""
        ids_list, ok = self.query_neighbors_batch(
            np.asarray(coordinates, np.float64)[None, :])
        if not ok[0]:
            return None
        pts = self._pts
        return iter([(int(k), pts[int(k)].tolist()) for k in ids_list[0]])

    def neighbors(self, coordinates: Sequence[float]):
        """Eager distance-filtered neighbor list [(i, [x,y,z]), ...] or None
        (reference lib.rs:228-241; filter is <= cutoff on the euclidean
        distance, lib.rs:234-238)."""
        q = np.asarray(coordinates, np.float64)
        ids_list, ok = self.query_neighbors_batch(q[None, :])
        if not ok[0]:
            return None
        pts = self._pts
        out = []
        csq = self._cutoff * self._cutoff
        for k in ids_list[0]:
            d = pts[int(k)] - q
            if float(d @ d) <= csq:
                out.append((int(k), pts[int(k)].tolist()))
        return out

    # -- extensions ----------------------------------------------------------

    def query_neighbors_batch(self, points: np.ndarray):
        """Batched point queries: (Q, dim) -> (list of id arrays, valid mask).

        The vectorised analogue of query_neighbors for many points at once
        (one device pass).
        """
        points = np.asarray(points, np.float64)
        if self._grid is None:
            return [np.zeros(0, np.int64)] * len(points), np.zeros(len(points), bool)
        from .core import query_neighbors

        # the grid bins on min(dim, 3) leading axes; candidate retrieval
        # projects queries onto the grid axes (distance filters downstream
        # use the full-dimensional coordinates)
        gdim = self._grid.info.dim
        res = query_neighbors(self._grid, points[:, :gdim], K=self._K,
                              dense=self._dense)
        ids = res.ids.cpu().numpy()
        mask = res.mask.cpu().numpy()
        ok = res.valid.cpu().numpy()
        n = len(self._pts)
        out = []
        for qi in range(len(points)):
            sel = ids[qi][mask[qi]].astype(np.int64)
            out.append(sel[sel < n])
        return out, ok

    def count_neighbors_batch(self, points: np.ndarray):
        """Within-cutoff (<=) neighbour count per query point.

        The batched ``len(self.neighbors(p))``: on 3-D grids one join pass
        (`ops.join.count_neighbors`, kernel K12 on the card); other
        dimensions, and a plain join whose flag fails on the CPU (counted
        in `ops.join.join_reduce.fallbacks`), take the query path; on the
        card K12 answers or this raises. Returns (counts (Q,) int64,
        valid (Q,)).
        """
        points = np.asarray(points, np.float64).reshape(-1, self._pts.shape[1])
        if self._grid is None:
            return (np.zeros(len(points), np.int64),
                    np.zeros(len(points), bool))
        if self._pts.shape[1] == 3:
            from .ops.join import count_neighbors, join_reduce

            c, valid, ok = count_neighbors(
                self._grid, torch.as_tensor(points, device=self._device))
            if bool(ok):
                return c.cpu().numpy().astype(np.int64), valid.cpu().numpy()
            if c.is_cuda:
                raise RuntimeError("the join's flag failed on the card")
            join_reduce.fallbacks += 1
        dsq, ok = self._candidate_dsq(points)
        csq = self._cutoff * self._cutoff
        counts = np.array([int((d <= csq).sum()) for d in dsq], np.int64)
        return counts, ok

    def nearest_neighbor_distances(self, points: np.ndarray):
        """Distance to the nearest particle within the cutoff per query
        point (np.inf where none is).

        One min-join pass on 3-D grids (`ops.join.nearest_dsq`, kernel K12
        on the card); other dimensions, and a plain join whose flag fails
        on the CPU (counted in `ops.join.join_reduce.fallbacks`), take the
        query path; on the card K12 answers or this raises. Returns
        (dist (Q,), valid (Q,))."""
        points = np.asarray(points, np.float64).reshape(-1, self._pts.shape[1])
        if self._grid is None:
            return (np.full(len(points), np.inf),
                    np.zeros(len(points), bool))
        if self._pts.shape[1] == 3:
            from .ops.join import join_reduce, nearest_dsq

            nd, valid, ok = nearest_dsq(
                self._grid, torch.as_tensor(points, device=self._device))
            if bool(ok):
                return np.sqrt(nd.cpu().numpy()), valid.cpu().numpy()
            if nd.is_cuda:
                raise RuntimeError("the join's flag failed on the card")
            join_reduce.fallbacks += 1
        dsq, ok = self._candidate_dsq(points)
        csq = self._cutoff * self._cutoff
        dist = np.full(len(points), np.inf)
        for qi, d in enumerate(dsq):
            d = d[d <= csq]
            if len(d):
                dist[qi] = float(np.sqrt(d.min()))
        return dist, ok

    def _candidate_dsq(self, points: np.ndarray):
        """Squared distances (full dimension) from each query point to its
        query-path candidates, and the valid mask."""
        ids_list, ok = self.query_neighbors_batch(points)
        return ([((self._pts[ids] - points[qi]) ** 2).sum(-1)
                 for qi, ids in enumerate(ids_list)], ok)

    def pairs(self, within_cutoff: bool = False):
        """Unique pairs as (i, j) numpy index arrays (one device pass).

        ``within_cutoff=True`` filters by distance < cutoff on the device —
        the array-native equivalent of iterating + filtering.
        """
        return self._pair_arrays(self._cutoff**2 if within_cutoff else None)

    def coordination_numbers(self) -> np.ndarray:
        """Number of neighbors within cutoff per particle (input order): a
        fused per-particle reduction, kernel K2 on the card, with the lag
        bound probed from the keys (3-D, like the reference's Python
        binding; N-dim per-particle sums live in
        `core.pairs.pair_energy_per_particle`)."""
        if self._grid is None or len(self._pts) < 2:
            return np.zeros(len(self._pts), np.int64)
        from .ops.lag_pairs import count_term, pair_lag_per_particle, suggest_lag

        g = self._grid
        L = suggest_lag(g.bins.sorted_keys, g.info.strides)
        out = pair_lag_per_particle(
            g.sorted_pos, g.bins.sorted_keys, g.info.strides, self._cutoff**2,
            M=max(1024, L), L=L, term=count_term)
        return g.unsort(out).cpu().numpy().astype(np.int64)[: len(self._pts)]

    def distance_histogram(self, edges) -> np.ndarray:
        """Histogram of unique pair distances over shells
        ``edges[k] <= r < edges[k+1]``: one fused pass, no pair list (see
        `ops.rdf`). ``edges[-1]`` may exceed the grid cutoff: the histogram
        bins at its own range. It probes the lag bound there and takes the
        lag kernel (K5) for L <= 2048, else the tile kernel (K9), growing
        MAXJ from 8 until the flag holds, as the JAX method does (each
        growth counts in ``CellGrid.distance_histogram.retries``). Returns
        (K-1,) int64."""
        edges = np.asarray(edges, np.float64).reshape(-1)
        if self._grid is None or len(self._pts) < 2:
            return np.zeros(max(len(edges) - 1, 0), np.int64)
        if self._pts.shape[1] != 3:
            raise ValueError(
                "distance_histogram runs on the fused 3D kernels; for "
                f"dim={self._pts.shape[1]} use core.pairs' bucketed tools")
        from .core.binning import bin_and_sort
        from .ops.lag_pairs import suggest_lag
        from .ops.rdf import pair_distance_histogram

        pos = torch.as_tensor(self._pts, dtype=self._grid.sorted_pos.dtype,
                              device=self._device)
        bins, _ = bin_and_sort(pos, float(edges[-1]), max_cells=1, need_perm=False,
                               auto_order=True)
        L = suggest_lag(bins.sorted_keys, bins.info.strides)
        if L <= 2048:
            counts, ok = pair_distance_histogram(pos, edges, M=max(1024, L), L=L)
            if not ok:
                raise RuntimeError(f"lag coverage failed at the suggested L={L}")
            return np.asarray(counts, np.int64)
        MAXJ = 8
        while True:
            counts, ok = pair_distance_histogram(pos, edges, path="tile", MAXJ=MAXJ)
            if ok or MAXJ >= _round_capacity(len(self._pts)) // 128:
                break
            MAXJ *= 2
            CellGrid.distance_histogram.retries += 1
        return np.asarray(counts, np.int64)

    def lj_energy(self) -> float:
        """Total LJ potential over cutoff-filtered pairs (fused on device)."""
        if self._grid is None or len(self._pts) < 2:
            return 0.0
        from .ops.lj import lj_energy

        return float(lj_energy(self._grid, K=self._K, chunk=self._chunk()))

    def virial(self) -> float:
        """Scalar pair virial W = sum f_ij . r_ij over cutoff pairs
        (fused on device; the trace of `stress`)."""
        if self._grid is None or len(self._pts) < 2:
            return 0.0
        from .core.pairs import pair_sum
        from .ops.virial import lj_virial_term

        return float(pair_sum(self._grid, lj_virial_term, K=self._K,
                              chunk=self._chunk(), cutoff_sq=self._cutoff**2))

    def stress(self) -> np.ndarray:
        """Configurational stress tensor sum g(dsq) dx (x) dx over cutoff
        pairs (open boundaries, N-dimensional). Returns (dim, dim);
        divide by volume (+ kinetic term) for the pressure tensor."""
        dim = self._pts.shape[1] if self._pts.ndim == 2 else 3
        if self._grid is None or len(self._pts) < 2:
            return np.zeros((dim, dim))
        from .core.pairs import pair_stress
        from .ops.lj import lj_force_factor

        return pair_stress(self._grid, lj_force_factor, K=self._K,
                           chunk=self._chunk(), cutoff_sq=self._cutoff**2
                           ).cpu().numpy()

    @property
    def positions(self) -> np.ndarray:
        return self._pts

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def grid_data(self):
        """The underlying functional `CellGridData` (tensors on the device)."""
        return self._grid

    # -- pickle --------------------------------------------------------------

    def __getstate__(self):
        return {
            "positions": self._pts,
            "cutoff": self._cutoff,
            "dense": self._use_dense,
            "device": str(self._device),
        }

    def __setstate__(self, state):
        self._use_dense = bool(state.get("dense", False))
        self._device = resolve_device(state.get("device"))
        self._build(np.asarray(state["positions"], np.float64), state["cutoff"])

    def __repr__(self):
        cells = int(self._grid.num_cells) if self._grid is not None else 0
        return f"CellGrid(n={len(self._pts)}, cutoff={self._cutoff}, cells={cells})"


# Times the tile MAXJ ladder of `CellGrid.distance_histogram` grew since the
# last reset.
CellGrid.distance_histogram.retries = 0
