"""SLA harness: every request to exactly one outcome, quantiles per budget
(PyTorch port of the JAX package's ``serving/sla.py``).

The metric that matters under load is the latency DISTRIBUTION served,
not raw throughput (arXiv:1509.07053): a queue that "keeps up" by
letting p99 diverge has failed its users.  :func:`run_sla` drives a
:class:`~repro_torch.serving.engine.RequestEngine` for a fixed number of
ticks, drains the backlog, flushes the retry buffer, and returns a
record in which

    arrivals == served + shed + expired        (exact, asserted)

— the outcome partition of DESIGN.md §8 — together with time-to-serve
p50 / p99 / p99.9 of the SERVED class, measured on the simulated clock
(ticks, not wall time: deterministic given the seed, so the numbers are
machine-independent and benchmark cells built on them are gateable).

:func:`build_engine` assembles the standard stack for benchmarks and
tests: DistShardedQueue -> ElasticDistQueue (optionally chaos-scheduled)
-> RequestEngine, with arrival rate expressed as utilization
``rho = rate / serve_rate`` (rho 0.7 = steady state, 1.5 = overload the
admission layer must shed ~1/3 of).  The queue runs on ``device``'s
default mesh (the first ``n_devices`` cards, or all positions on the CPU)
or on an explicit ``mesh=``, which may repeat a card::

    eng = build_engine(n_devices=2, lanes_per_device=4, width=1024,
                       n_slots=128, mesh=["cuda:0", "cuda:0"])
    rep = run_sla(eng, 300)
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.config import PQConfig
from repro_torch.core.factory import EngineSpec, make_engine
from repro_torch.ft.inject import FaultSchedule
from repro_torch.serving.arrivals import (
    BurstyArrivals, DiurnalArrivals, PoissonArrivals)
from repro_torch.serving.engine import RequestEngine
from repro_torch.serving.scheduler import SHED, OverloadPolicy, QualityPolicy

_PATTERNS = {"poisson": PoissonArrivals, "bursty": BurstyArrivals,
             "diurnal": DiurnalArrivals}


def build_engine(*, n_devices: int = 1, lanes_per_device: int = 4,
                 width: int = 64, rho: float = 0.7, n_slots: int = 8,
                 pattern: str = "poisson", seed: int = 0,
                 schedule: Optional[FaultSchedule] = None,
                 spare_devices: int = 0, depth_cap: Optional[int] = None,
                 tick_dt: float = 1.0, slack: float = 1.0,
                 sla_mean: float = 50.0, sla_min: float = 20.0,
                 p_urgent: float = 0.0, max_retries: int = 2,
                 preroute: str = "adaptive",
                 quality: Optional[dict] = None,
                 device="cuda", mesh=None, backend: Optional[str] = None,
                 **arrival_kw) -> RequestEngine:
    """Assemble queue -> elastic controller -> engine at utilization
    ``rho`` (arrival rate = rho * n_slots / tick_dt).

    ``depth_cap`` defaults to half the queue's structural floor
    (n_lanes * seq_cap), far below where the router could drop —
    admission is meant to bind FIRST.  Pass ``schedule`` (or build one
    from ``PQ_CHAOS`` via :func:`repro_torch.ft.inject.parse_chaos`) for
    chaos runs; ``spare_devices`` must then cover the kills.  ``quality``
    (a :class:`~repro_torch.serving.scheduler.QualityPolicy` or its kwargs
    dict, e.g. ``dict(max_defer=3, defer_frac=0.5)``) enables the
    quality-relaxed serving mode: deadline slack is spent on deferred,
    coalesced serve rounds (DESIGN.md §12).  ``device`` / ``mesh`` place
    the queue; ``backend`` picks the lanes' kernel backend (None keeps
    "cuda"; a CPU mesh needs "torch").
    """
    if pattern not in _PATTERNS:
        raise ValueError(f"unknown arrival pattern {pattern!r} "
                         f"(have {sorted(_PATTERNS)})")
    base = PQConfig(a_max=width, r_max=width, seq_cap=4 * width + 2,
                    n_buckets=8, bucket_cap=width, detach_min=8,
                    detach_max=256, detach_init=8, chop_patience=64)
    ctl = make_engine(
        EngineSpec(engine="elastic", width=width, base=base,
                   lanes=n_devices * lanes_per_device,
                   n_devices=n_devices, lanes_per_device=lanes_per_device,
                   spare_devices=spare_devices, preroute=preroute,
                   backend=backend),
        device=device, mesh=mesh, schedule=schedule, seed=seed,
        tick_dt=tick_dt)
    if depth_cap is None:
        shard = ctl.queue.cfg.shard
        depth_cap = (shard.n_lanes * shard.lane.seq_cap) // 2
    policy = OverloadPolicy(depth_cap=depth_cap, serve_rate=float(n_slots),
                            tick_dt=tick_dt, slack=slack,
                            max_retries=max_retries)
    arrivals = _PATTERNS[pattern](
        rho * n_slots / tick_dt, clock=ctl.clock, tick_dt=tick_dt,
        seed=seed, sla_mean=sla_mean, sla_min=sla_min, p_urgent=p_urgent,
        **arrival_kw)
    if quality is not None and not isinstance(quality, QualityPolicy):
        quality = QualityPolicy(**quality)
    return RequestEngine(ctl, policy, arrivals=arrivals, n_slots=n_slots,
                         quality=quality)


def run_sla(engine: RequestEngine, n_ticks: int, *,
            drain: bool = True, max_drain_ticks: int = 10_000) -> dict:
    """Drive ``n_ticks`` arrival rounds, then (by default) drain the
    backlog and flush the retry buffer so the partition is exact.

    Returns the engine report plus the run shape; asserts the
    conservation contract ``arrivals == served + shed + expired`` when
    drained (with the residual classes when not).
    """
    for _ in range(n_ticks):
        engine.tick()
    drain_ticks = 0
    if drain:
        # drain feeds empty waves, so the attached arrival process is
        # not consulted; parked retries re-offer as they come due and
        # either serve or shed.  flush() terminates any stragglers so
        # the partition is exact.
        drain_ticks = engine.drain(max_ticks=max_drain_ticks)
        for _ev in engine.admission.flush(engine.clock.now):
            engine.outcomes[SHED] += 1
    rep = engine.report()
    rep["n_ticks"] = n_ticks
    rep["drain_ticks"] = drain_ticks
    total = rep["served"] + rep["shed"] + rep["expired"]
    if drain:
        assert total == rep["arrivals"], (
            f"outcome partition broken: {total} != {rep['arrivals']}")
    else:
        assert total + rep["in_flight"] + rep["retry_pending"] == \
            rep["arrivals"]
    return rep
