"""Unified configuration object (the port's own copy of
``zelll_tpu/config.py``; SURVEY.md §5).

The reference configures itself through cargo features (`rayon`, `serde`,
`quick_bench`) and a hardcoded neighborhood rank (zelll Cargo.toml:45-50,
src/cellgrid/flatindex.rs:44-57). The framework has genuinely tunable
static capacities instead — kernel block sizes, lag bounds, bucket
capacities, precision tiers — which `ZelllConfig` gathers in one
serializable dataclass with environment-variable overrides (`ZELLL_*`).

Every entry point keeps plain keyword arguments; the config is the
recommended way to carry one coherent set of knobs through an
application (and into checkpoints: it round-trips via `to_dict`).
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["ZelllConfig"]

_PRECISIONS = ("f32", "split", "f64")


@dataclasses.dataclass(frozen=True)
class ZelllConfig:
    """One coherent set of framework knobs.

    cutoff      : cell edge == interaction cutoff (reference semantics).
    precision   : 'f32' (fastest), 'split' (f32x2 coordinate planes,
                  f64-grade pair distances), or 'f64' (parity work).
    M, L        : lag-kernel block slots / lag bound (ops.lag_pairs; M
                  is kept for the JAX package's signatures).
    CB, MAXJ    : tile-kernel chunks per block / window chunks
                  (ops.tile_pairs; MAXJ bounds the worst chunk's partner
                  window — coverage flags report when it is too small).
    K, chunk    : bucketed-path cell capacity / cell-block chunk
                  (core.pairs).
    T           : column-decomposition width (the JAX package's
                  ops.columns; kept so that configs round-trip).
    skin        : Verlet skin for MD loops (0 = rebuild every step).
    capacity_growth : multiplier applied when a coverage/overflow flag
                  demands a larger capacity class.
    """

    cutoff: float = 1.0
    precision: str = "f32"
    M: int = 4096
    L: int = 256
    CB: int = 8
    MAXJ: int = 12
    K: int = 32
    chunk: int = 64
    T: int = 3
    skin: float = 0.0
    capacity_growth: float = 2.0

    def __post_init__(self):
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be one of {_PRECISIONS}, got {self.precision!r}"
            )
        if self.L % 128 or self.M % 1024 or self.L > self.M:
            raise ValueError(
                "lag kernel needs L % 128 == 0, M % 1024 == 0, L <= M "
                f"(got M={self.M}, L={self.L})"
            )
        for name in ("CB", "MAXJ", "K", "chunk", "T"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @classmethod
    def from_env(cls, **overrides) -> "ZelllConfig":
        """Build from ZELLL_* environment variables, then overrides.
        Recognized: ZELLL_CUTOFF, ZELLL_PRECISION, ZELLL_M, ZELLL_L,
        ZELLL_CB, ZELLL_MAXJ, ZELLL_K, ZELLL_CHUNK, ZELLL_T, ZELLL_SKIN."""
        kw = {}
        for f in dataclasses.fields(cls):
            env = os.environ.get(f"ZELLL_{f.name.upper()}")
            if env is not None:
                kw[f.name] = env if isinstance(f.default, str) else type(f.default)(env)
        kw.update(overrides)
        return cls(**kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ZelllConfig":
        return cls(**d)

    def grown(self) -> "ZelllConfig":
        """Next capacity class up: what to rerun with after a coverage or
        overflow flag comes back False (the coverage-flags invariant:
        never silently drop pairs, rerun with larger capacities instead)."""
        g = self.capacity_growth

        def up(v, granule):
            return int(-(-int(v * g) // granule) * granule)

        return dataclasses.replace(
            self,
            L=up(self.L, 128),
            M=max(up(self.M, 1024), up(self.L, 128)),
            MAXJ=up(self.MAXJ, 1),
            K=up(self.K, 1),
        )
