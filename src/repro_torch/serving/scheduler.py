"""Overload policy: deadline admission control, load shedding, backpressure.

Copied from the JAX package's ``serving/scheduler.py`` (numpy only).

The queue itself (repro_torch.core.distributed / repro_torch.ft.elastic) never
wedges — every tick serves up to ``rm_count`` near-minimal deadlines
whatever the backlog.  What overload CAN destroy is the latency
distribution served: an unbounded backlog turns every admitted request
into a late one.  This module is the client-facing policy that keeps
the distribution bounded, with one hard rule — **reject, don't wedge,
and never silently**: every arrival the engine cannot serve gets an
explicit SHED outcome at admission time, instead of rotting in a queue
it will never leave.

Three mechanisms, applied per arrival in deadline (EDF) order:

* **depth admission control** — queue depth is capped at
  ``depth_cap``; arrivals beyond the cap are shed with reason
  ``depth``.  Depth-shed requests are the RETRYABLE class (capacity
  may free up): they back off ``retry_backoff`` ticks and re-offer, at
  most ``max_retries`` times (bounded backpressure), then shed finally
  with reason ``retry``.
* **deadline-infeasibility shedding** — the queue serves earliest
  deadline first, so an arrival's expected wait is its deadline's RANK
  among outstanding deadlines divided by the serve rate.  If ``now +
  ceil((rank + 1) / serve_rate) * tick_dt * slack > deadline`` the
  deadline cannot be met even if everything goes right; the request is
  shed with reason ``infeasible`` immediately (no retry: feasibility
  only decays with time).  An urgent request (deadline at the queue
  frontier) has rank 0 and is always feasible — it dispatches via
  pre-route elimination the same tick, which this estimate prices as
  one tick.
* **degraded-mode coupling** — ``serve_rate`` is the HEALTHY capacity;
  when the fault layer throttles grants (``lane_scale``), the engine
  lowers the controller's effective rate via ``set_capacity_scale`` so
  feasibility estimates track what the mesh can actually serve.

The controller is pure host-side policy (numpy over the engine's
in-flight deadline set) — it never touches the device queue, so it is
unit-testable without a mesh and costs O(wave * log depth) per tick.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serving.arrivals import Request

#: terminal outcomes — every request ends in exactly one (DESIGN.md §8:
#: served/shed/expired is a partition of the arrival stream)
SERVED = "served"
SHED = "shed"
EXPIRED = "expired"

#: shed reasons (observability: a shed is never silent)
SHED_DEPTH = "depth"          # admission cap hit (retryable)
SHED_INFEASIBLE = "infeasible"  # deadline unmeetable at admission
SHED_RETRY = "retry"          # retry budget exhausted


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Static knobs of the admission controller.

    ``serve_rate`` is requests served per tick at full health (the
    engine's ``n_slots``); ``depth_cap`` bounds outstanding admitted
    requests (must stay under the queue's structural capacity so the
    router never drops); ``slack`` > 1 sheds earlier (conservative
    feasibility), < 1 later (optimistic).
    """

    depth_cap: int
    serve_rate: float
    tick_dt: float = 1.0
    slack: float = 1.0
    max_retries: int = 2
    retry_backoff: float = 2.0   # ticks a depth-shed request backs off

    def __post_init__(self) -> None:
        if self.depth_cap < 1:
            raise ValueError("depth_cap must be >= 1")
        if self.serve_rate <= 0:
            raise ValueError("serve_rate must be > 0")
        if self.tick_dt <= 0:
            raise ValueError("tick_dt must be > 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")


@dataclasses.dataclass
class ShedEvent:
    """A terminal shed: the explicit outcome record (never silent)."""

    request: Request
    reason: str
    time: float


@dataclasses.dataclass(frozen=True)
class QualityPolicy:
    """Quality-relaxed serving: measured deadline slack becomes a
    staleness budget spent on SKIPPED serve rounds (DESIGN.md §12).

    A serve round costs a full device tick whatever its batch size, so
    when every in-flight deadline has slack, deferring the round and
    serving a coalesced batch later buys the same outcomes with fewer
    queue rounds — the serving-side spend of the relaxation-quality
    axis: each deferred round adds exactly one tick of staleness to the
    frontier request, which is rank error priced in ticks (up to one
    arrival wave's worth of later-deadline requests may now be served
    ahead of it in the coalesced batch).

    ``defer_frac`` converts measured slack into budget (a round may be
    deferred only while the current defer streak stays under
    ``defer_frac * min_slack_ticks``); ``max_defer`` hard-caps the
    streak regardless of slack, bounding worst-case added staleness.
    Slack is measured pessimistically — per in-flight request, deadline
    distance minus the full-rate backlog-clearing time ahead of it — so
    a deferral never makes an admitted deadline infeasible by its own
    estimate; what it can still do is widen the EDF inversion window
    (the honest caveat in DESIGN.md §12).
    """

    max_defer: int = 4
    defer_frac: float = 0.5

    def __post_init__(self) -> None:
        if self.max_defer < 0:
            raise ValueError("max_defer must be >= 0")
        if not (0.0 <= self.defer_frac <= 1.0):
            raise ValueError("defer_frac must be in [0, 1]")


class ServeDeferrer:
    """Stateful defer/coalesce decision for :class:`QualityPolicy`.

    ``quota(...)`` returns this tick's remove quota: 0 while deferring,
    or a coalesced batch (up to ``n_slots * (streak + 1)``) when the
    budget is spent or absent.  Pure host math over the engine's sorted
    in-flight deadlines; the engine owns ground truth.
    """

    def __init__(self, policy: QualityPolicy):
        self.policy = policy
        self.streak = 0           # consecutive deferred rounds
        self.n_deferred = 0       # total deferred serve rounds
        self.n_coalesced = 0      # serves dispatched in coalesced batches
        self.max_streak = 0       # worst defer run (budget-held witness)

    def quota(self, deadlines: np.ndarray, now: float, rate: float,
              tick_dt: float, n_slots: int, depth: int) -> int:
        """Decide this round.  ``deadlines`` sorted ascending (the
        engine's in-flight view); ``rate`` the effective serve rate."""
        if depth == 0:
            self.streak = 0
            return 0
        ranks = np.arange(len(deadlines), dtype=np.float64)
        # per-request slack in ticks if serving resumed at full rate now
        slack = (deadlines - now) / tick_dt - np.ceil((ranks + 1.0) / rate)
        budget = min(self.policy.max_defer,
                     int(self.policy.defer_frac * float(slack.min())))
        if self.streak < budget:
            self.streak += 1
            self.n_deferred += 1
            self.max_streak = max(self.max_streak, self.streak)
            return 0
        q = min(n_slots * (self.streak + 1), depth)
        if self.streak:
            self.n_coalesced += q
        self.streak = 0
        return q

    def report(self) -> Dict[str, int]:
        return {
            "deferred_ticks": self.n_deferred,
            "max_defer_run": self.max_streak,
            "coalesced_serves": self.n_coalesced,
        }


class AdmissionController:
    """Stateful admission: depth cap + EDF feasibility + bounded retry.

    The caller (engine) owns ground truth on depth and in-flight
    deadlines; the controller owns the retry buffer and the decision
    rule.  ``admit`` processes one tick's offered wave and returns
    ``(admitted, shed_events)`` — requests not in either are parked in
    the retry buffer and will re-offer themselves on a later tick
    (``pending`` counts them; conservation accounting must include
    them until they terminate).
    """

    def __init__(self, policy: OverloadPolicy):
        self.policy = policy
        self._retry: List[Tuple[float, int, Request]] = []  # (due, rid, req)
        self._capacity_scale = 1.0
        self.n_offered = 0
        self.n_retried = 0
        self.shed_reasons: Dict[str, int] = {
            SHED_DEPTH: 0, SHED_INFEASIBLE: 0, SHED_RETRY: 0}

    # -- degraded-mode coupling -------------------------------------------

    def set_capacity_scale(self, scale: float) -> None:
        """Feed the fault layer's grant-throttle fraction (mean
        ``lane_scale``) into feasibility estimates: a degraded mesh
        serves fewer requests per tick, so deadlines that were feasible
        at full health may now need shedding."""
        self._capacity_scale = float(np.clip(scale, 0.05, 1.0))

    @property
    def effective_rate(self) -> float:
        return self.policy.serve_rate * self._capacity_scale

    # -- retry buffer ------------------------------------------------------

    @property
    def pending(self) -> int:
        """Requests parked for retry (neither admitted nor terminal)."""
        return len(self._retry)

    def _due_retries(self, now: float) -> List[Request]:
        due = [r for (t, _, r) in self._retry if t <= now]
        self._retry = [e for e in self._retry if e[0] > now]
        return due

    def _park_or_shed(self, req: Request, now: float,
                      shed: List[ShedEvent]) -> None:
        pol = self.policy
        if req.retries >= pol.max_retries:
            # terminal: never retried -> plain depth shed; budget burned
            # -> retry-exhausted shed (both explicit, never silent)
            reason = SHED_RETRY if req.retries > 0 else SHED_DEPTH
            self.shed_reasons[reason] += 1
            shed.append(ShedEvent(req, reason, now))
            return
        retry = dataclasses.replace(req, retries=req.retries + 1)
        due = now + pol.retry_backoff * pol.tick_dt
        bisect.insort(self._retry, (due, retry.rid, retry))
        self.n_retried += 1

    # -- the decision rule -------------------------------------------------

    def admit(self, wave: List[Request], inflight_deadlines: np.ndarray,
              depth: int, now: float, max_admit: int,
              ) -> Tuple[List[Request], List[ShedEvent]]:
        """One tick's admission decision.

        ``inflight_deadlines`` must be SORTED ascending (the engine
        keeps it); ``depth`` is its length; ``max_admit`` caps this
        tick's admissions at the op-batch width W.  Due retries join
        the offered wave automatically.  Returns the admitted requests
        (deadline order) and the terminal shed events; depth-shed
        retryables are parked internally.
        """
        pol = self.policy
        offered = self._due_retries(now) + list(wave)
        self.n_offered += sum(1 for r in offered if r.retries == 0)
        offered.sort(key=lambda r: (r.deadline, r.rid))
        admitted: List[Request] = []
        shed: List[ShedEvent] = []
        rate = self.effective_rate
        for req in offered:
            if len(admitted) >= max_admit or depth + len(admitted) >= \
                    pol.depth_cap:
                self._park_or_shed(req, now, shed)
                continue
            # EDF rank: in-flight deadlines ahead of this one, plus the
            # earlier-deadline admissions of this same wave (the list is
            # processed in deadline order, so that is all of `admitted`)
            rank = int(np.searchsorted(inflight_deadlines, req.deadline))
            rank += len(admitted)
            est_ticks = math.ceil((rank + 1) / rate)
            est_serve = now + est_ticks * pol.tick_dt * pol.slack
            if est_serve > req.deadline + 1e-9:
                self.shed_reasons[SHED_INFEASIBLE] += 1
                shed.append(ShedEvent(req, SHED_INFEASIBLE, now))
                continue
            admitted.append(req)
        return admitted, shed

    def flush(self, now: float) -> List[ShedEvent]:
        """Terminate every parked retry (end-of-run accounting: the
        served/shed/expired partition must cover the retry buffer)."""
        out = [ShedEvent(r, SHED_RETRY, now) for (_, _, r) in self._retry]
        self.shed_reasons[SHED_RETRY] += len(out)
        self._retry = []
        return out
