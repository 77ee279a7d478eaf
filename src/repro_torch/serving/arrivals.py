"""Open-loop arrival processes for the request engine (deadline = priority).

Copied from the JAX package's ``serving/arrivals.py`` (numpy only).

The serving harness is open-loop: traffic arrives at a rate the engine
does not control (the "millions of users" regime), so overload is a
real state the policy layer must survive, not an artifact a closed-loop
driver would hide by waiting.  Every process here is

* **seeded** — a (seed, pattern) pair fully determines the request
  stream, so every SLA number and every chaos run is replayable;
* **clock-driven** — arrival stamps and deadlines read the SAME
  injected :class:`repro_torch.ft.inject.SimClock` the fault-injection layer
  advances, so traffic and faults share one timeline: a partition that
  burns ``collective_timeout`` on the clock ages every queued deadline
  by exactly that much.

Three patterns (ROADMAP "open-loop arrival processes"):

* :class:`PoissonArrivals` — homogeneous Poisson at ``rate`` requests
  per clock unit; the memoryless baseline.
* :class:`BurstyArrivals` — Markov-modulated Poisson: an ON/OFF state
  with geometric dwell times; ON multiplies the rate by
  ``burst_factor``.  Mean rate exceeds ``rate`` — bursts are EXTRA
  traffic, which is the point: admission control has to shed them.
* :class:`DiurnalArrivals` — sinusoidal rate modulation with period
  ``period`` (the day/night cycle compressed to simulation scale).

Deadlines: each request draws a service-level budget
``sla ~ max(sla_min, Exp(sla_mean))`` and gets ``deadline = arrival +
sla``; a seeded ``p_urgent`` fraction instead gets ``sla = urgent_sla``
(default: one tick — the SLA-0 class that must dispatch via pre-route
elimination, never through the queue).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.ft.inject import SimClock


@dataclasses.dataclass
class Request:
    """One serving request.  ``deadline`` is ABSOLUTE clock time; the
    queue key is the deadline (earliest-deadline-first), so "priority =
    deadline" is literal.  ``retries`` counts admission re-offers after
    a retryable shed (bounded by the overload policy)."""

    rid: int
    arrival: float
    deadline: float
    retries: int = 0

    @property
    def sla(self) -> float:
        return self.deadline - self.arrival


class ArrivalProcess:
    """Base: per-tick wave generation with seeded deadlines.

    ``wave()`` returns the requests arriving in the tick interval
    ``[clock.now, clock.now + tick_dt)``, stamped at ``clock.now`` (the
    engine offers them to admission at the START of the tick that
    serves them — the batch-world analogue of "arrived since the last
    round").  Request ids are globally increasing per process.
    """

    def __init__(self, rate: float, *, clock: Optional[SimClock] = None,
                 tick_dt: float = 1.0, seed: int = 0,
                 sla_mean: float = 50.0, sla_min: float = 20.0,
                 p_urgent: float = 0.0, urgent_sla: Optional[float] = None):
        if rate < 0:
            raise ValueError("rate must be >= 0")
        self.rate = float(rate)
        self.clock = clock if clock is not None else SimClock()
        self.tick_dt = float(tick_dt)
        self.rng = np.random.default_rng(seed)
        self.sla_mean = float(sla_mean)
        self.sla_min = float(sla_min)
        self.p_urgent = float(p_urgent)
        self.urgent_sla = (float(urgent_sla) if urgent_sla is not None
                           else self.tick_dt)
        self.next_rid = 0
        self.n_generated = 0

    # -- subclass hook -----------------------------------------------------

    def _rate_now(self, now: float) -> float:
        return self.rate

    # -- wave generation ---------------------------------------------------

    def _n_arrivals(self, now: float) -> int:
        lam = max(self._rate_now(now), 0.0) * self.tick_dt
        return int(self.rng.poisson(lam))

    def wave(self) -> List[Request]:
        now = self.clock.now
        n = self._n_arrivals(now)
        if n == 0:
            return []
        slas = np.maximum(self.rng.exponential(self.sla_mean, n),
                          self.sla_min)
        if self.p_urgent > 0:
            urgent = self.rng.random(n) < self.p_urgent
            slas = np.where(urgent, self.urgent_sla, slas)
        out = [Request(rid=self.next_rid + i, arrival=now,
                       deadline=now + float(s))
               for i, s in enumerate(slas)]
        self.next_rid += n
        self.n_generated += n
        return out


class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate`` requests / clock unit."""


class BurstyArrivals(ArrivalProcess):
    """Markov-modulated Poisson: OFF at ``rate``, ON at ``rate *
    burst_factor``; dwell times are geometric with means ``mean_off`` /
    ``mean_on`` ticks.  Long-run mean rate = rate * (1 + (burst_factor
    - 1) * mean_on / (mean_on + mean_off))."""

    def __init__(self, rate: float, *, burst_factor: float = 4.0,
                 mean_on: float = 5.0, mean_off: float = 20.0, **kw):
        super().__init__(rate, **kw)
        if burst_factor < 1.0:
            raise ValueError("burst_factor must be >= 1")
        if mean_on < 1.0 or mean_off < 1.0:
            raise ValueError("dwell means must be >= 1 tick")
        self.burst_factor = float(burst_factor)
        self.p_exit_on = 1.0 / float(mean_on)
        self.p_exit_off = 1.0 / float(mean_off)
        self.on = False

    def _rate_now(self, now: float) -> float:
        # state transition once per wave (per tick), seeded
        p = self.p_exit_on if self.on else self.p_exit_off
        if self.rng.random() < p:
            self.on = not self.on
        return self.rate * (self.burst_factor if self.on else 1.0)


class DiurnalArrivals(ArrivalProcess):
    """Sinusoidal rate: rate(t) = rate * (1 + amplitude * sin(2 pi t /
    period)) — the day/night cycle at simulation scale."""

    def __init__(self, rate: float, *, period: float = 200.0,
                 amplitude: float = 0.8, **kw):
        super().__init__(rate, **kw)
        if not (0.0 <= amplitude <= 1.0):
            raise ValueError("amplitude must be in [0, 1]")
        if period <= 0:
            raise ValueError("period must be > 0")
        self.period = float(period)
        self.amplitude = float(amplitude)

    def _rate_now(self, now: float) -> float:
        return self.rate * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * now / self.period))
