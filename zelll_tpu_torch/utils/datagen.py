"""Benchmark data generation, bit-compatible with the reference protocol.

The port's own copy of ``zelll_tpu/utils/datagen.py`` (numpy only); its
native fast path calls the port's own oracle library.

The reference benchmarks (zelll `benches/cellgrid.rs:16-35`, `benches/lj.rs`,
`examples/lammps_data.rs`) generate uniformly random points with Rust's
``rand 0.8`` ``StdRng`` (= ChaCha12) seeded via ``seed_from_u64`` with the
fixed seed 3079380797442975911. To make our benchmark inputs *identical* to
the reference/LAMMPS/CellListMap comparison data, this module reimplements
that exact RNG stack in vectorized numpy:

* ``seed_from_u64``: rand_core 0.6 fills the 32-byte ChaCha seed with PCG32
  (XSH-RR) outputs, 4 bytes at a time (little-endian).
* ``StdRng`` core: ChaCha with 12 rounds, 64-bit block counter in state
  words 12-13, stream id (0) in words 14-15; u32 output stream is the
  sequence of output blocks' words; ``next_u64`` = two consecutive u32
  (lo, hi).
* ``Standard`` distribution for f64: ``(next_u64 >> 11) * 2^-53``.
* point = ``(u3 - 0.5 + origin) * vol`` componentwise
  (benches/cellgrid.rs:25-30).

This is a clean-room reimplementation from the published algorithm
definitions (RFC 8439 ChaCha core; PCG32 output function), not a port of
any reference code.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "StdRng", "generate_points_random", "generate_points_lattice", "DEFAULT_SEED",
    "lj_box",
    "lattice_cloud",
    "synthetic_protein",
]

DEFAULT_SEED = 3079380797442975911

_CHACHA_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def _pcg32_seed_fill(state: int, nwords: int) -> np.ndarray:
    """rand_core 0.6 `seed_from_u64`: PCG32 XSH-RR fills the seed words."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    mask = (1 << 64) - 1
    out = np.empty(nwords, dtype=np.uint32)
    for i in range(nwords):
        state = (state * MUL + INC) & mask
        xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
        rot = state >> 59
        out[i] = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & 0xFFFFFFFF
    return out


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return (x << np.uint32(k)) | (x >> np.uint32(32 - k))


def _chacha_core(state: np.ndarray, rounds: int) -> np.ndarray:
    """ChaCha core over (B, 16) uint32 initial states -> output words."""
    x = state.copy()

    def qr(a, b, c, d):
        x[:, a] += x[:, b]
        x[:, d] = _rotl(x[:, d] ^ x[:, a], 16)
        x[:, c] += x[:, d]
        x[:, b] = _rotl(x[:, b] ^ x[:, c], 12)
        x[:, a] += x[:, b]
        x[:, d] = _rotl(x[:, d] ^ x[:, a], 8)
        x[:, c] += x[:, d]
        x[:, b] = _rotl(x[:, b] ^ x[:, c], 7)

    with np.errstate(over="ignore"):
        for _ in range(rounds // 2):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        return x + state


def _chacha_blocks(key: np.ndarray, counters: np.ndarray, rounds: int) -> np.ndarray:
    """rand_chacha state layout: 64-bit block counter in words 12-13,
    stream id (0) in words 14-15. Returns (B, 16) uint32 output words."""
    B = counters.shape[0]
    state = np.empty((B, 16), dtype=np.uint32)
    state[:, 0:4] = _CHACHA_CONSTANTS
    state[:, 4:12] = key
    state[:, 12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[:, 13] = (counters >> np.uint64(32)).astype(np.uint32)
    state[:, 14] = 0
    state[:, 15] = 0
    return _chacha_core(state, rounds)


class StdRng:
    """rand 0.8 `StdRng` (ChaCha12) u64/f64 stream, vectorized."""

    ROUNDS = 12

    def __init__(self, seed: int):
        self.key = _pcg32_seed_fill(seed, 8)
        self._consumed_u32 = 0

    def next_u64(self, n: int) -> np.ndarray:
        """The next n outputs of `next_u64` as a (n,) uint64 array.

        Uses the native C++ stream when available (~10x numpy) with the
        vectorized numpy implementation as fallback; both are bit-identical.
        """
        from .. import oracle

        start = self._consumed_u32
        if oracle.available():
            out = oracle.chacha12_u64(self.key, start, n)
            self._consumed_u32 = start + 2 * n
            return out
        end = start + 2 * n
        b0, b1 = start // 16, (end + 15) // 16
        # chunk the block generation: cache-sized working sets are ~10x
        # faster than one giant pass at 1e8-point scale
        CHUNK = 1 << 20
        parts = []
        for cb in range(b0, b1, CHUNK):
            counters = np.arange(cb, min(cb + CHUNK, b1), dtype=np.uint64)
            parts.append(
                _chacha_blocks(self.key, counters, self.ROUNDS).reshape(-1)
            )
        words = np.concatenate(parts) if len(parts) > 1 else parts[0]
        words = words[start - b0 * 16 : end - b0 * 16]
        self._consumed_u32 = end
        lo = words[0::2].astype(np.uint64)
        hi = words[1::2].astype(np.uint64)
        return lo | (hi << np.uint64(32))

    def uniform_f64(self, n: int) -> np.ndarray:
        """n samples of rand's `Standard` for f64: 53 high bits / 2^53."""
        u = self.next_u64(n) >> np.uint64(11)
        return u.astype(np.float64) * (1.0 / (1 << 53))


def generate_points_random(
    n: int,
    vol,
    origin=(0.0, 0.0, 0.0),
    seed: int | None = None,
) -> np.ndarray:
    """Uniform random cloud identical to benches/cellgrid.rs:16-35.

    Each point consumes 3 consecutive f64 samples (x, y, z);
    ``p = (u - 0.5 + origin) * vol`` componentwise.
    """
    rng = StdRng(DEFAULT_SEED if seed is None else seed)
    u = rng.uniform_f64(3 * n).reshape(n, 3)
    return (u - 0.5 + np.asarray(origin, np.float64)) * np.asarray(vol, np.float64)


def generate_points_lattice(n: int, vol, seed: int = 0) -> np.ndarray:
    """n points of a jittered lattice filling the box ``vol`` (centred on
    the origin, as `generate_points_random`) at the same mean density.

    Each axis of the lattice gets about the box's mean spacing; each point
    moves by up to a quarter of the smallest spacing per axis (numpy, from
    ``seed``). So no two points come closer than half that spacing, and no
    pair term dominates a sum the way a nearly coincident pair of a uniform
    cloud does. This is not part of the reference protocol; it exists to
    check reductions.
    """
    vol = np.asarray(vol, np.float64)
    step = np.cbrt(np.prod(vol) / n)
    m = np.maximum(np.round(vol[:2] / step), 1).astype(np.int64)
    m = np.append(m, -(-n // int(m.prod())))
    spacing = vol / m
    idx = np.stack(np.unravel_index(np.arange(n), m[::-1])[::-1], axis=1)
    shift = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3))
    return (idx + 0.5) * spacing - vol / 2 + shift * (0.25 * spacing.min())


def lj_box(n: int, cutoff: float = 10.0) -> tuple[float, float, float]:
    """Benchmark cuboid for n particles (benches/lj.rs:60-64):
    30 x 30 x (n / (10/cutoff^3) / 900), i.e. mean ~10 particles/cell."""
    conc = 10.0 / cutoff**3
    a = 3.0 * cutoff
    b = 3.0 * cutoff
    c = (n / conc) / a / b
    return (a, b, c)


def lattice_cloud(n: int, box, rng: np.random.Generator) -> np.ndarray:
    """A perturbed lattice filling ``box`` (from the origin) with about n
    points: spacing a = (volume / n)^(1/3), floor(box / a) points per axis,
    each moved by up to 0.05 a per axis from ``rng``, so no two points
    overlap. The start state of the MD protocol (the JAX package's
    ``benchmarks/steady_state.py``)."""
    vol = float(np.prod(box))
    a = (vol / n) ** (1 / 3)
    dims = [max(int(np.floor(b / a)), 1) for b in box]
    g = np.stack(
        np.meshgrid(*(np.arange(d) for d in dims), indexing="ij"), -1
    ).reshape(-1, 3) * a
    g = g + rng.uniform(-0.05 * a, 0.05 * a, g.shape)
    return g.astype(np.float64)


def synthetic_protein(n: int = 2000, radius: float = 15.0, seed: int = 0):
    """A synthetic globular structure: n atoms uniform in a ball of
    ``radius`` around the origin, with the vdW radii of C, N, O and H drawn
    at 50/15/20/15 %. Returns (positions (n, 3), radii (n,)). The JAX
    package's SDF benchmarks' default structure (its
    ``benchmarks/sdf_queries.py``); 2000 atoms in 15 A is about 0.14 atoms
    per cubic Angstrom, and ``radius = 15 (n / 2000)^(1/3)`` keeps that
    density at other sizes."""
    rng = np.random.default_rng(seed)
    r = radius * rng.random(n) ** (1 / 3)
    theta = np.arccos(2 * rng.random(n) - 1)
    phi = 2 * np.pi * rng.random(n)
    pos = np.stack(
        [
            r * np.sin(theta) * np.cos(phi),
            r * np.sin(theta) * np.sin(phi),
            r * np.cos(theta),
        ],
        -1,
    )
    radii = rng.choice([1.7, 1.55, 1.52, 1.09], n, p=[0.5, 0.15, 0.2, 0.15])
    return pos, radii


def cluster_gap(sorted_pts: np.ndarray, cutoff: float, starts) -> np.ndarray:
    """A copy of sorted (n, 3) f64 points in which, at each start slot s of
    ``starts`` (at most two), the clusters of 32 slots [s, s + 32) and
    [s + 32, s + 64) become two 4 x 4 x 2 grids of spacing 2 whose boxes
    face each other across exactly one cutoff along x, below every point in
    y and z. The facing sides pair up across the gap at separations
    cutoff (1 - 2^-23), cutoff (1 + 2^-23), cutoff (1 - 2^-25),
    cutoff (1 + 2^-25) and exactly cutoff; facing points sit at most 15
    slots apart. At the first site the facing points lie at |x| < 16,
    where f32 coordinates resolve most of those separations; at the second
    near |x| = 100, where f32 rounds them all to one cutoff and only the
    low parts of split coordinates keep them. A prune of cluster pairs by their boxes that is
    not conservative to the last bit then drops a pair that the cutoff
    keeps. The keys are the caller's: they are not recomputed."""
    pts = np.array(sorted_pts, dtype=np.float64)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(2),
                                indexing="ij"), -1).reshape(-1, 3) * 2.0
    # the offsets along x of the facing pairs, by their (y, z) index
    # (8 facing points per side, ascending (iy, iz); the rest at one cutoff)
    nudge = np.zeros(len(grid))
    nudge[:5] = cutoff * np.array([-(2.0**-23), 2.0**-23, -(2.0**-25), 2.0**-25, 0.0])
    y0 = pts[:, 1].min() - 3 * cutoff - 6
    z0 = pts[:, 2].min() - 3 * cutoff
    for s, x0 in zip(starts, (-(cutoff + 3.0), -100.0)):
        a = np.stack([x0 - grid[:, 0], y0 + grid[:, 1], z0 + grid[:, 2]], -1)
        b = np.stack([x0 + cutoff + grid[:, 0] + nudge, y0 + grid[:, 1],
                      z0 + grid[:, 2]], -1)
        pts[s:s + 32] = a[::-1]  # the facing points last, (0, 0, 0) at s + 31
        pts[s + 32:s + 64] = b   # and first, (0, 0, 0) at s + 32
    return pts
