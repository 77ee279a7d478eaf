"""Deterministic fault injection for the elastic mesh queue.

Copied from the JAX package's ``ft/inject.py`` (numpy only).

The fault-tolerance loop (DESIGN.md §"Failure model") is only testable
if failures are *reproducible*: a CI chaos leg that kills a random
device at a random wall-clock instant proves nothing when it cannot be
replayed.  Everything here is therefore pure and seeded:

* :class:`SimClock` — the injected clock.  No component of the FT stack
  reads wall time; the controller advances this clock by a fixed
  ``tick_dt`` per queue round (plus ``collective_timeout`` per bounded
  retry), so a schedule + a seed fully determine every detection,
  throttle, and resize the run performs.
* :class:`FaultSchedule` — a static list of :class:`FaultEvent` windows
  (``kill`` forever-after, ``slow``/``partition`` over ``[t0, t1)``),
  built either explicitly, from a PRNG seed (:meth:`FaultSchedule.seeded`
  — the CI chaos leg's generator), or from a compact env-var spec
  (:func:`parse_chaos`, e.g. ``PQ_CHAOS="kill:3@8,slow:1x4@5-20"``).
* :class:`FaultInjector` — drives one detection step: devices beat the
  :class:`~repro_torch.ft.heartbeat.FailureDetector` unless the schedule has
  them killed or partitioned (silence is how BOTH reach the detector —
  a slow device still beats; it is throttled via its *cost*, not
  suspected), and per-device tick costs (``base_cost * slow_factor``)
  feed the straggler EMA (:class:`repro_torch.ft.straggler.CostEma`).

The harness models three fault kinds and their distinct failure paths:

=========  ======================  ===================================
kind       detector signal          controller response
=========  ======================  ===================================
kill       silent forever           suspected -> dead -> lane re-shard
                                    (drain-and-remap; distributed.resize)
slow       beats, high cost         grant throttling (CostEma weights ->
                                    _alloc_removes_arrays caps)
partition  silent over a window     bounded retry on the collective
                                    (clock burns collective_timeout per
                                    attempt); heal -> resume, persist ->
                                    declared dead -> re-shard
=========  ======================  ===================================
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.ft.heartbeat import FailureDetector

_INF = float("inf")


class SimClock:
    """Injected monotonic clock: the single time source of the FT stack."""

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clock cannot run backwards")
        self.now += float(dt)
        return self.now


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault window: ``kind`` in {kill, slow, partition}, active on
    ``[t0, t1)`` (kill ignores ``t1``; it is forever).  ``factor`` is the
    slowdown multiple of a ``slow`` event (observed tick cost scales by
    it)."""

    kind: str
    device: int
    t0: float
    t1: float = _INF
    factor: float = 4.0

    def __post_init__(self) -> None:
        if self.kind not in ("kill", "slow", "partition"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.t1 < self.t0:
            raise ValueError("fault window ends before it starts")
        if self.kind == "slow" and self.factor <= 1.0:
            raise ValueError("slow factor must be > 1")

    def active(self, now: float) -> bool:
        if self.kind == "kill":
            return now >= self.t0
        return self.t0 <= now < self.t1


class FaultSchedule:
    """A static, replayable set of fault windows over original device ids.

    Query methods take the ORIGINAL device id (the id a device had in
    the full mesh) — the elastic controller keeps that mapping as lanes
    re-shard, so a schedule stays meaningful across resizes.
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.t0, e.device, e.kind)))

    @classmethod
    def none(cls) -> "FaultSchedule":
        return cls(())

    @classmethod
    def seeded(cls, seed: int, n_devices: int, *, horizon: float = 24.0,
               n_kill: int = 1, n_slow: int = 0, n_partition: int = 0,
               slow_factor: float = 4.0,
               window: float = 6.0) -> "FaultSchedule":
        """Deterministic random schedule (the CI chaos leg's generator):
        fault instants are drawn uniformly over ``[1, horizon)`` and
        target devices without replacement (a device suffers at most one
        event, so a run's ground truth stays unambiguous)."""
        n_events = n_kill + n_slow + n_partition
        if n_events > n_devices:
            raise ValueError("more fault events than devices")
        rng = np.random.default_rng(seed)
        devices = rng.permutation(n_devices)[:n_events]
        kinds = (["kill"] * n_kill + ["slow"] * n_slow
                 + ["partition"] * n_partition)
        events = []
        for kind, dev in zip(kinds, devices):
            t0 = float(np.round(rng.uniform(1.0, max(horizon, 2.0)), 1))
            events.append(FaultEvent(
                kind=kind, device=int(dev), t0=t0,
                t1=_INF if kind == "kill" else t0 + window,
                factor=slow_factor))
        return cls(events)

    # -- point queries (original device ids) ------------------------------

    def killed(self, device: int, now: float) -> bool:
        return any(e.kind == "kill" and e.device == device and e.active(now)
                   for e in self.events)

    def partitioned(self, device: int, now: float) -> bool:
        return any(e.kind == "partition" and e.device == device
                   and e.active(now) for e in self.events)

    def slow_factor(self, device: int, now: float) -> float:
        f = 1.0
        for e in self.events:
            if e.kind == "slow" and e.device == device and e.active(now):
                f = max(f, e.factor)
        return f

    def silent(self, device: int, now: float) -> bool:
        """True when the device cannot beat (killed or partitioned)."""
        return self.killed(device, now) or self.partitioned(device, now)

    def faulty(self, device: int, now: float) -> bool:
        """True when a collective including this device cannot complete
        right now (kill = fails fast, partition = would hang past the
        timeout).  Slow devices DO complete — they are the degraded-mode
        case, not the retry case."""
        return self.silent(device, now)


_EVENT_RE = re.compile(
    r"^(?P<kind>kill|slow|part(?:ition)?):(?P<dev>\d+)"
    r"(?:x(?P<factor>[0-9.]+))?"
    r"@(?P<t0>[0-9.]+)(?:-(?P<t1>[0-9.]+))?$")


def parse_chaos(spec: Optional[str] = None, *,
                n_devices: Optional[int] = None,
                env: str = "PQ_CHAOS") -> Optional[FaultSchedule]:
    """Parse a compact chaos spec (CLI/CI surface of the harness).

    ``spec`` defaults to ``$PQ_CHAOS``.  Grammar (comma-separated):

    * ``kill:<dev>@<t>`` — device dies at t (stays dead);
    * ``slow:<dev>x<factor>@<t0>-<t1>`` — runs ``factor``x slower on
      [t0, t1) (default factor 4, default window t0+6);
    * ``part:<dev>@<t0>-<t1>`` — partitioned (silent) on [t0, t1);
    * ``seed:<n>[:<kills>]`` — a seeded schedule over ``n_devices``
      (requires it) with ``kills`` kill events (default 1).

    Returns None when the spec is empty/unset so callers can write
    ``schedule = parse_chaos() or FaultSchedule.none()`` and keep the
    fault-free path schedule-free.
    """
    if spec is None:
        spec = os.environ.get(env, "")
    spec = spec.strip()
    if not spec:
        return None
    events: List[FaultEvent] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("seed:"):
            bits = part.split(":")
            if n_devices is None:
                raise ValueError("seed: chaos spec needs n_devices")
            n_kill = int(bits[2]) if len(bits) > 2 else 1
            sched = FaultSchedule.seeded(int(bits[1]), n_devices,
                                         n_kill=n_kill)
            events.extend(sched.events)
            continue
        m = _EVENT_RE.match(part)
        if not m:
            raise ValueError(f"bad chaos event {part!r}")
        kind = {"part": "partition"}.get(m.group("kind"), m.group("kind"))
        t0 = float(m.group("t0"))
        t1 = float(m.group("t1")) if m.group("t1") else (
            _INF if kind == "kill" else t0 + 6.0)
        events.append(FaultEvent(
            kind=kind, device=int(m.group("dev")), t0=t0, t1=t1,
            factor=float(m.group("factor") or 4.0)))
    return FaultSchedule(events)


class FaultInjector:
    """One detection step per queue round: schedule -> beats -> verdicts.

    Wires the schedule into a :class:`FailureDetector` through the
    injected clock, and reports the per-device observed tick cost the
    straggler EMA consumes.  ``base_cost`` is the healthy per-tick cost
    in clock units (the EMA only ever uses ratios, so its absolute value
    is irrelevant)."""

    def __init__(self, schedule: FaultSchedule, detector: FailureDetector,
                 clock: SimClock, *, base_cost: float = 1.0):
        self.schedule = schedule
        self.detector = detector
        self.clock = clock
        self.base_cost = float(base_cost)

    def beat_alive(self) -> None:
        """Heartbeats from every device the schedule lets speak."""
        now = self.clock.now
        for dev in sorted(self.detector.alive()):
            if not self.schedule.silent(dev, now):
                self.detector.beat(dev, now)

    def step(self) -> Dict[str, object]:
        """Beats + detector check + cost observation at ``clock.now``.

        Returns ``{"suspected": set, "dead": set, "costs": {dev: cost}}``
        — ``dead`` holds devices NEWLY declared dead this step (the
        controller's resize trigger); costs cover currently-live devices
        (suspected ones report no cost: silence carries no timing)."""
        now = self.clock.now
        self.beat_alive()
        verdict = self.detector.check(now)
        costs = {}
        for dev in sorted(self.detector.alive()):
            if dev in verdict["suspected"] or self.schedule.silent(dev, now):
                continue
            costs[dev] = self.base_cost * self.schedule.slow_factor(dev, now)
        return {"suspected": verdict["suspected"], "dead": verdict["dead"],
                "costs": costs}


def lane_weights(device_weights: Sequence[float],
                 lanes_per_device: int) -> np.ndarray:
    """Expand per-device grant weights to the [L] per-lane vector the
    distributed tick consumes (a device's lanes share its health)."""
    w = np.asarray(device_weights, np.float32)
    return np.repeat(w, lanes_per_device)
