"""Overload-robust request engine on the elastic distributed queue
(PyTorch port of the JAX package's ``serving/engine.py``).

A cluster-scale request dispatcher whose shared structure is the
lanes-over-devices :class:`~repro_torch.core.distributed.
DistShardedQueue`, wrapped by the fault-tolerance controller
:class:`~repro_torch.ft.elastic.ElasticDistQueue` (detect -> degrade ->
resize), with the overload policy layer
(:mod:`repro_torch.serving.scheduler`) in front.  Per :meth:`tick`:

1. **arrivals** — an open-loop wave (:mod:`repro_torch.serving.arrivals`),
   stamped on the SAME injected clock the fault schedule runs on;
2. **admission** — depth cap + EDF deadline-feasibility shedding +
   bounded retry (reject-don't-wedge: every non-admitted request gets
   an explicit terminal outcome, or a bounded backoff slot);
3. **the queue round** — one fault-tolerant synchronized tick
   (:meth:`ElasticDistQueue.step`): key = deadline, value = request id,
   ``rm_count`` = free worker slots.  Urgent deadlines dispatch via
   pre-route elimination without touching routing; device death mid-
   tick drain-and-remaps lanes with the backlog conserved;
4. **outcome accounting** — every served value is matched against the
   in-flight table (a served rid that is not in flight is a duplicate
   or a phantom — hard failure); service past the deadline is recorded
   EXPIRED, in time SERVED.  ``served + shed + expired + in_flight +
   retry_pending == arrivals`` holds after every tick (the conservation
   contract; DESIGN.md §8).

The op batch is built on the host and moved to the queue's control
device in one copy per tensor; the served request ids come back in one
host read per tick.  Depth is tracked host-side (the in-flight table) —
exact by the same conservation the queue proves — so admission never
pays a device sync;
``queue_stats()`` cross-checks it against the device state on demand
(tests do).

Degraded mode: the controller's ``lane_scale`` throttle both caps the
straggler's grants (inside the tick) and lowers the admission
controller's effective serve rate (``set_capacity_scale``), so a slow
device inflates p99 and sheds a little earlier instead of collapsing
the engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.config import EMPTY_VAL
from repro_torch.ft.elastic import ElasticDistQueue
from repro_torch.serving.arrivals import ArrivalProcess, Request
from repro_torch.serving.scheduler import (
    EXPIRED, SERVED, SHED, AdmissionController, OverloadPolicy,
    QualityPolicy, ServeDeferrer, ShedEvent)

_EPS = 1e-9


class RequestEngine:
    """The serving loop: arrivals -> admission -> elastic queue round.

    ``queue`` is the fault-tolerant controller (its injected clock is
    the engine's single time source); ``policy`` the overload knobs;
    ``arrivals`` an optional attached process (ticks may also be fed
    explicit waves — tests do).  ``n_slots`` defaults to
    ``policy.serve_rate`` per tick.
    """

    def __init__(self, queue: ElasticDistQueue, policy: OverloadPolicy,
                 arrivals: Optional[ArrivalProcess] = None,
                 n_slots: Optional[int] = None,
                 quality: Optional[QualityPolicy] = None):
        self.queue = queue
        self.policy = policy
        self.arrivals = arrivals
        self.n_slots = int(n_slots if n_slots is not None
                           else round(policy.serve_rate))
        self.admission = AdmissionController(policy)
        # quality-relaxed mode: deadline slack -> deferred serve rounds
        # (None = strict: serve every tick; repro_torch.serving.scheduler)
        self.deferrer = ServeDeferrer(quality) if quality is not None \
            else None
        self.clock = queue.clock
        if arrivals is not None and arrivals.clock is not self.clock:
            raise ValueError(
                "arrivals must share the elastic queue's injected clock "
                "(faults and traffic live on one timeline)")
        # in-flight table: rid -> Request, plus the sorted deadline view
        # the admission controller ranks against
        self.in_flight: Dict[int, Request] = {}
        self._deadlines: List[float] = []   # sorted, same multiset
        # outcome accounting
        self.outcomes = {SERVED: 0, SHED: 0, EXPIRED: 0}
        self.latencies: List[float] = []    # time-to-serve of SERVED
        self.n_arrivals = 0
        self.n_admitted = 0
        self.n_ticks = 0
        self.max_depth = 0

    # -- introspection -----------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.in_flight)

    @property
    def width(self) -> int:
        """Op-batch width W of the underlying queue (survives resizes:
        the batch geometry is mesh-size independent)."""
        return self.queue.width

    def queue_stats(self):
        """Device-side stats (incl. the new depth / min_head fields) —
        a sync; tests use it to cross-check the host-tracked depth."""
        return self.queue.stats()

    def accounted(self) -> int:
        """Everything the engine knows about: must equal n_arrivals at
        all times (the conservation invariant, asserted every tick)."""
        return (self.outcomes[SERVED] + self.outcomes[SHED]
                + self.outcomes[EXPIRED] + self.depth
                + self.admission.pending)

    # -- the serving round -------------------------------------------------

    def _record_shed(self, events: List[ShedEvent]) -> None:
        self.outcomes[SHED] += len(events)

    def _insert_inflight(self, req: Request) -> None:
        self.in_flight[req.rid] = req
        # bisect into the sorted deadline view
        lo, hi = 0, len(self._deadlines)
        d = req.deadline
        while lo < hi:
            mid = (lo + hi) // 2
            if self._deadlines[mid] < d:
                lo = mid + 1
            else:
                hi = mid
        self._deadlines.insert(lo, d)

    def _remove_deadline(self, d: float) -> None:
        lo, hi = 0, len(self._deadlines)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._deadlines[mid] < d:
                lo = mid + 1
            else:
                hi = mid
        # lo is the leftmost slot holding d (same multiset as in_flight)
        del self._deadlines[lo]

    def tick(self, wave: Optional[List[Request]] = None) -> dict:
        """One serving round; returns the tick's observability record."""
        if wave is None:
            wave = self.arrivals.wave() if self.arrivals is not None else []
        now = self.clock.now
        self.n_arrivals += sum(1 for r in wave if r.retries == 0)

        # degraded-mode coupling: last-known grant throttle -> capacity
        self.admission.set_capacity_scale(self.queue.capacity_scale())

        admitted, shed_events = self.admission.admit(
            wave, np.asarray(self._deadlines, np.float64), self.depth, now,
            max_admit=self.width)
        self._record_shed(shed_events)
        for req in admitted:
            self._insert_inflight(req)
        self.n_admitted += len(admitted)
        self.max_depth = max(self.max_depth, self.depth)
        if self.depth > self.policy.depth_cap:
            raise AssertionError(
                f"admission cap violated: depth {self.depth} > "
                f"{self.policy.depth_cap}")

        # one fault-tolerant synchronized round (key = deadline)
        w = self.width
        ak = np.full((w,), np.inf, np.float32)
        av = np.full((w,), EMPTY_VAL, np.int32)
        mask = np.zeros((w,), bool)
        for i, req in enumerate(admitted):
            ak[i] = req.deadline
            av[i] = req.rid
            mask[i] = True
        if self.deferrer is not None:
            rm_now = min(self.deferrer.quota(
                np.asarray(self._deadlines, np.float64), now,
                self.admission.effective_rate, self.policy.tick_dt,
                self.n_slots, self.depth), w)
        else:
            rm_now = min(self.n_slots, self.depth)
        dev = self.queue.queue.device
        res, info = self.queue.step(
            torch.from_numpy(ak).to(dev), torch.from_numpy(av).to(dev),
            torch.from_numpy(mask).to(dev), rm_now)
        self.n_ticks += 1
        now_served = self.clock.now   # post-tick (includes retry burns)

        served_rids = []
        # the tick's one host read of what it served
        for rid in res.rm_vals[res.rm_served].tolist():
            if rid == EMPTY_VAL:
                continue
            req = self.in_flight.pop(rid, None)
            if req is None:
                raise AssertionError(
                    f"queue served rid {rid} that is not in flight — "
                    "duplicated or phantom request")
            self._remove_deadline(req.deadline)
            served_rids.append(rid)
            if now_served <= req.deadline + _EPS:
                self.outcomes[SERVED] += 1
                self.latencies.append(now_served - req.arrival)
            else:
                # admitted but late: the deadline passed while queued
                # (or while a fault burned the clock) — dropped at
                # dispatch, accounted, never billed as a serve
                self.outcomes[EXPIRED] += 1

        if self.accounted() != self.n_arrivals:
            raise AssertionError(
                f"conservation violated: accounted {self.accounted()} != "
                f"arrivals {self.n_arrivals}")
        return {
            "now": now_served,
            "depth": self.depth,
            "admitted": len(admitted),
            "shed": len(shed_events),
            "served_rids": served_rids,
            "removed": info["removed"],
            "suspected": info["suspected"],
            "live": info["live"],
        }

    # -- end-of-run --------------------------------------------------------

    def drain(self, max_ticks: int = 10_000) -> int:
        """Serve the backlog to empty (no new arrivals; parked retries
        still re-offer and terminate).  Returns ticks used; raises if
        the backlog fails to drain — a wedged engine is a bug, not a
        report line."""
        t = 0
        while self.depth > 0 or self.admission.pending > 0:
            if t >= max_ticks:
                raise AssertionError(
                    f"drain wedged: depth {self.depth}, "
                    f"{self.admission.pending} retries pending "
                    f"after {max_ticks} ticks")
            self.tick(wave=[])
            t += 1
        return t

    def report(self) -> dict:
        """SLA accounting snapshot (see repro_torch.serving.sla for the
        quantile harness built on it)."""
        lat = np.asarray(self.latencies, np.float64)
        q = (lambda p: float(np.percentile(lat, p))) if len(lat) else \
            (lambda p: float("nan"))
        quality = (self.deferrer.report() if self.deferrer is not None
                   else {})
        return {
            **quality,
            "arrivals": self.n_arrivals,
            "admitted": self.n_admitted,
            "served": self.outcomes[SERVED],
            "shed": self.outcomes[SHED],
            "expired": self.outcomes[EXPIRED],
            "in_flight": self.depth,
            "retry_pending": self.admission.pending,
            "shed_reasons": dict(self.admission.shed_reasons),
            "n_retried": self.admission.n_retried,
            "max_depth": self.max_depth,
            "depth_cap": self.policy.depth_cap,
            "p50": q(50.0), "p99": q(99.0), "p999": q(99.9),
            "ticks": self.n_ticks,
            "live_devices": list(self.queue.live),
        }
