"""Engine factory of the PyTorch port: one spec resolves an engine.

The same surface as the JAX package's ``core/factory.py``::

    from repro_torch.core.factory import EngineSpec, make_engine

    eng = make_engine(EngineSpec(engine="pqe", width=4096))   # on cuda
    state = eng.init(seed=0)
    state, res = eng.tick(state, keys, vals, mask, rm_count)

Every single-device kind of the reference is registered: the paper's
combined queue (``"pqe"``), the L-lane relaxed queue (``"sharded"``), the
workload controller that switches between them (``"adaptive"``) and the
paper's two baselines (``"fcskiplist"``, ``"lfskiplist"``); any other
kind (the mesh's ``"dist"`` and ``"elastic"``) raises ``ValueError``
naming the registered kinds.  Engines run on ``device="cuda"`` unless
the caller passes ``device="cpu"``; the ``"cuda"`` kernel backend on a
CPU device raises at construction (the baselines read no backend).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core import pqueue
from repro_torch.core import sharded as shq
from repro_torch.core.config import PQConfig


@runtime_checkable
class QueueEngine(Protocol):
    """What every queue engine exposes (structural, checked at runtime)."""

    def init(self, *, seed: int = 0) -> Any: ...

    def tick(self, state, add_keys, add_vals, add_mask, rm_count): ...

    def tick_n(self, state, add_keys, add_vals, add_mask, rm_counts): ...

    def stats(self, state) -> Any: ...

    def resident(self, state): ...

    def relax_bound(self, rm_count: int) -> int: ...


#: PQConfig knobs of the paper's §2.1 adaptive moveHead policy
_DETACH_KNOBS = (
    "detach_min",
    "detach_max",
    "detach_init",
    "halve_threshold",
    "double_threshold",
)


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """The spec fields the ported engines read."""

    engine: str = "pqe"
    width: int = 256  # op-batch width W per tick
    base: Optional[PQConfig] = None  # None -> default_base(width)

    # "cuda" | "torch"; None keeps the base config's backend
    backend: Optional[str] = None

    # lane geometry (sharded / adaptive); min_lanes is fold headroom:
    # quotas sized so the queue can fold down to it
    lanes: int = 4
    min_lanes: Optional[int] = None
    slack: float = 1.0
    preroute: str = "adaptive"

    # paper §2.1 adaptive-detach knobs; None keeps the base config value
    detach_min: Optional[int] = None
    detach_max: Optional[int] = None
    detach_init: Optional[int] = None
    halve_threshold: Optional[int] = None
    double_threshold: Optional[int] = None

    # workload controller (adaptive): a
    # repro_torch.core.adaptive.ControllerConfig or None for defaults
    controller: Any = None

    # rank-error budget (sharded / adaptive): clamp lanes so the analytic
    # envelope relax_bound(W) - W fits it (None = unbudgeted)
    quality_budget: Optional[float] = None


def default_base(width: int) -> PQConfig:
    """A width-`width` single-queue base config (the bench geometry)."""
    return PQConfig(
        a_max=width,
        r_max=width,
        seq_cap=max(4096, 4 * width),
        n_buckets=64,
        bucket_cap=max(64, width // 32),
        detach_min=8,
        detach_max=65536,
        detach_init=256,
        halve_threshold=1000,
        double_threshold=100,
    )


def resolved_base(spec: EngineSpec) -> PQConfig:
    """The spec's base config with its detach knobs and backend applied
    (PQConfig validates the backend spelling)."""
    base = spec.base if spec.base is not None else default_base(spec.width)
    over = {
        k: getattr(spec, k) for k in _DETACH_KNOBS if getattr(spec, k) is not None
    }
    if spec.backend is not None:
        over["backend"] = spec.backend
    return dataclasses.replace(base, **over) if over else base


def lanes_within_budget(spec: EngineSpec, lanes: int) -> int:
    """Widest lane count <= ``lanes`` whose envelope ``relax_bound(cfg_L,
    W) - W`` fits ``spec.quality_budget`` (``lanes`` when unbudgeted;
    L = 1 is exact, so the walk ends)."""
    if spec.quality_budget is None:
        return lanes
    budget = float(spec.quality_budget)
    base = resolved_base(spec)
    for ln in range(lanes, 0, -1):
        cfg = _sharded_cfg_of(spec, ln, base)
        if shq.relax_bound(cfg, spec.width) - spec.width <= budget:
            return ln
    return 1


def _sharded_cfg_of(spec: EngineSpec, lanes: int,
                    base: PQConfig) -> shq.ShardedPQConfig:
    ml = spec.min_lanes
    return shq._sharded_cfg(spec.width, lanes, base=base, slack=spec.slack,
                            min_lanes=None if ml is None else min(ml, lanes),
                            preroute=spec.preroute)


_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    """Register an engine builder ``(spec, *, device) -> QueueEngine``."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def engine_kinds():
    return sorted(_REGISTRY)


def make_engine(spec: EngineSpec, *, device="cuda") -> QueueEngine:
    """Resolve ``spec.engine`` through the registry and build the engine
    on ``device``."""
    try:
        build = _REGISTRY[spec.engine]
    except KeyError:
        raise ValueError(
            f"unknown or not yet ported engine {spec.engine!r} "
            f"(have {engine_kinds()})"
        ) from None
    return build(spec, device=torch.device(device))


def _check_device(backend: str, device: torch.device) -> None:
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"the cuda kernel backend needs a cuda device, got {device}; "
            "pass backend='torch' to run on the CPU")


class PQEngine:
    """The paper's combined queue (repro_torch.core.pqueue) as an engine."""

    kind = "pqe"

    def __init__(self, cfg: PQConfig, device: torch.device):
        _check_device(cfg.backend, device)
        self.cfg = cfg
        self.device = device

    @property
    def width(self) -> int:
        return self.cfg.a_max

    def init(self, *, seed: int = 0):
        del seed  # deterministic structure, no router PRNG
        return pqueue.init(self.cfg, self.device)

    def tick(self, state, add_keys, add_vals, add_mask, rm_count):
        return pqueue.tick(self.cfg, state, add_keys, add_vals, add_mask, rm_count)

    def tick_n(self, state, add_keys, add_vals, add_mask, rm_counts):
        return pqueue.tick_n(self.cfg, state, add_keys, add_vals, add_mask, rm_counts)

    def stats(self, state):
        return state.stats

    def resident(self, state):
        return pqueue.resident(self.cfg, state)

    def relax_bound(self, rm_count: int) -> int:
        return int(rm_count)  # exact queue: removes are true minima

    def size(self, state):
        return pqueue.size(state)


@register("pqe")
def _build_pqe(spec: EngineSpec, *, device: torch.device) -> PQEngine:
    return PQEngine(resolved_base(spec), device)


class ShardedEngine:
    """The L-lane relaxed queue (repro_torch.core.sharded) as an engine."""

    kind = "sharded"

    def __init__(self, cfg: shq.ShardedPQConfig, device: torch.device):
        _check_device(cfg.lane.backend, device)
        self.cfg = cfg
        self.device = device

    @property
    def width(self) -> int:
        return self.cfg.a_total

    def init(self, *, seed: int = 0):
        return shq.init(self.cfg, seed=seed, device=self.device)

    def tick(self, state, add_keys, add_vals, add_mask, rm_count):
        return shq.tick(self.cfg, state, add_keys, add_vals, add_mask,
                        rm_count)

    def tick_n(self, state, add_keys, add_vals, add_mask, rm_counts):
        return shq.tick_n(self.cfg, state, add_keys, add_vals, add_mask,
                          rm_counts)

    def stats(self, state):
        return shq.stats(state)

    def resident(self, state):
        return shq.resident(self.cfg, state.lanes)

    def relax_bound(self, rm_count: int) -> int:
        return shq.relax_bound(self.cfg, rm_count)

    def size(self, state):
        return shq.size(state)


@register("sharded")
def _build_sharded(spec: EngineSpec, *, device: torch.device) -> ShardedEngine:
    lanes = lanes_within_budget(spec, spec.lanes)
    return ShardedEngine(_sharded_cfg_of(spec, lanes, resolved_base(spec)),
                         device)


class BaselineEngine:
    """The paper's §4 baselines (FCPQ / ParallelPQ) behind the same
    surface: enough protocol for a bench driver (no drain surface: they
    exist to be measured, not managed)."""

    def __init__(self, kind: str, cfg: PQConfig, impl, device: torch.device):
        self.kind = kind
        self.cfg = cfg
        self.device = device
        self._impl = impl

    @property
    def width(self) -> int:
        return self.cfg.a_max

    def init(self, *, seed: int = 0):
        del seed
        return self._impl.init(self.cfg, self.device)

    def tick(self, state, add_keys, add_vals, add_mask, rm_count):
        return self._impl.tick(self.cfg, state, add_keys, add_vals, add_mask,
                               rm_count)

    def tick_n(self, state, add_keys, add_vals, add_mask, rm_counts):
        results = []
        for t in range(add_keys.shape[0]):
            state, res = self.tick(state, add_keys[t], add_vals[t],
                                   add_mask[t], rm_counts[t])
            results.append(res)
        if not results:
            return state, None
        return state, pqueue.TickResult(
            *(torch.stack(xs) for xs in zip(*(r[:3] for r in results))))

    def stats(self, state):
        return None

    def resident(self, state):
        raise NotImplementedError(f"{self.kind} keeps no drain surface")

    def relax_bound(self, rm_count: int) -> int:
        return int(rm_count)

    def size(self, state):
        return self._impl.size(state)


@register("fcskiplist")
def _build_fc(spec: EngineSpec, *, device: torch.device) -> BaselineEngine:
    from repro_torch.core.baselines import FCPQ

    return BaselineEngine("fcskiplist", resolved_base(spec), FCPQ, device)


@register("lfskiplist")
def _build_lf(spec: EngineSpec, *, device: torch.device) -> BaselineEngine:
    from repro_torch.core.baselines import ParallelPQ

    return BaselineEngine("lfskiplist", resolved_base(spec), ParallelPQ,
                          device)


@register("adaptive")
def _build_adaptive(spec: EngineSpec, *, device: torch.device):
    from repro_torch.core import adaptive   # deferred: adaptive imports us

    return adaptive.AdaptiveEngine(spec, device)
