"""Configuration of the batched adaptive priority queue (PyTorch port).

The same fields, properties and checks as the JAX package's
``core/config.py``; the constants mirror the paper where it gives them:

* ``detach_min=8``, ``detach_max=65536`` — the adaptive ``moveHead()`` size
  bounds (paper §2.1: "adaptively varies between 8 and 65,536").
* ``halve_threshold=1000`` (paper's N), ``double_threshold=100`` (paper's M).

Capacities (``a_max``, ``r_max``, ``seq_cap``, ``n_buckets``, ``bucket_cap``)
are static, so every tick runs on fixed shapes.

``backend`` picks how the tick's hot pipeline runs, resolved once here:

* ``"cuda"`` (default) — the hand-written Hopper kernel
  ``kernels/csrc/lane_tick.cu`` runs head through moveHead; the rare
  repairs run in plain PyTorch around it.
* ``"torch"`` — every pass in plain PyTorch (the twin of the JAX
  package's ``backend="jnp"``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Sentinel returned for a removeMin() on an empty queue. The paper returns
# MaxInt (Alg. 3 line 2); we return an +inf key and EMPTY_VAL payload.
EMPTY_VAL = -1

#: backend spellings PQConfig accepts
BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Static configuration of the combined queue (frozen, hashable)."""

    # --- batch geometry (the "elimination array" width) -------------------
    a_max: int = 256           # max add() ops per tick
    r_max: int = 256           # max removeMin() ops per tick

    # --- how the hot pipeline runs: "cuda" | "torch" ------------------------
    backend: str = "cuda"

    # --- sequential part ---------------------------------------------------
    seq_cap: int = 4096        # capacity of the sequential (head) part

    # --- parallel part (the bucketed "skiplist" suffix) ---------------------
    n_buckets: int = 64        # key-range buckets (the skiplist "top level")
    bucket_cap: int = 64       # slots per bucket

    # --- adaptive moveHead policy (paper constants) -------------------------
    detach_min: int = 8
    detach_max: int = 65536
    halve_threshold: int = 1000   # paper's N
    double_threshold: int = 100   # paper's M
    detach_init: int = 64

    # --- chopHead policy: quiet ticks before the head folds back ----------
    chop_patience: int = 64

    @property
    def spill_threshold(self) -> int:
        """Sequential-part size past which the largest keys spill back to
        the parallel part, so the next tick can never overflow."""
        return self.seq_cap - self.a_max - self.r_max

    @property
    def par_cap(self) -> int:
        return self.n_buckets * self.bucket_cap

    @property
    def move_k_max(self) -> int:
        """Static output width of the moveHead extraction:
        min(par_cap, max(r_max, detach_max)) rounded up to a power of two."""
        bound = min(self.par_cap, max(self.r_max, self.detach_max))
        return 1 << (bound - 1).bit_length()

    @property
    def total_cap(self) -> int:
        return self.par_cap + self.seq_cap

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown kernel backend {self.backend!r} (have {BACKENDS})")
        if self.a_max <= 0 or self.r_max <= 0:
            raise ValueError("a_max and r_max must be positive")
        if self.seq_cap < self.a_max + self.r_max + 2:
            raise ValueError(
                f"seq_cap={self.seq_cap} too small; needs headroom of "
                f"a_max+r_max={self.a_max + self.r_max}"
            )
        if self.detach_min < 1 or self.detach_max < self.detach_min:
            raise ValueError("bad detach bounds")
        if self.detach_init < self.detach_min or self.detach_init > self.detach_max:
            raise ValueError("detach_init out of bounds")
        if self.n_buckets < 1 or self.bucket_cap < 1:
            raise ValueError("bad bucket geometry")


# A paper-faithful production configuration: full detach range, generous
# structure capacity. Used by the dry-run and the serving engine.
PRODUCTION = PQConfig(
    a_max=1024,
    r_max=1024,
    seq_cap=1 << 17,          # 131072 >= detach_max + a_max + r_max
    n_buckets=1024,
    bucket_cap=1024,
    detach_min=8,
    detach_max=65536,
    halve_threshold=1000,
    double_threshold=100,
    detach_init=1024,
)

# A small configuration for CPU tests.
SMALL = PQConfig(
    a_max=64,
    r_max=64,
    seq_cap=512,
    n_buckets=16,
    bucket_cap=32,
    detach_min=8,
    detach_max=256,
    detach_init=32,
    halve_threshold=1000,
    double_threshold=100,
    chop_patience=16,
)


def tick_shapes(cfg: PQConfig) -> Tuple[Tuple[int], Tuple[int]]:
    """(add batch shape, remove result shape) for one tick."""
    return (cfg.a_max,), (cfg.r_max,)
