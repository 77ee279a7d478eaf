"""Coordinator-side failure detection (simulated clock for tests).

Copied from the JAX package's ``ft/heartbeat.py`` (pure Python).

At 1000+ nodes, failures are routine: the coordinator keeps a heartbeat
table; a worker missing ``suspect_after`` seconds is *suspected* and
missing ``dead_after`` is *dead*, triggering the elastic path
(repro_torch.ft.elastic): shrink the mesh by the failed lanes, re-shard them
over the survivors (repro_torch.core.distributed.resize), resume.  The
detector is pure (injected clock, see repro_torch.ft.inject.SimClock) so
tests drive it deterministically.

Registration grace: constructing the detector REGISTERS every worker at
``now`` (and :meth:`beat` late-registers unknown workers), so a worker
that has not beaten yet is treated as "last seen at registration", not
as silent-forever — the seed-era table returned ``silent_for == +inf``
for never-beaten workers, which declared a whole fresh fleet dead at
the first ``check()`` (the cold-start bug pinned by tests/test_ft.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Set


@dataclasses.dataclass
class HeartbeatTable:
    last_seen: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: float) -> None:
        self.last_seen[worker] = now

    def silent_for(self, worker: int, now: float) -> float:
        return now - self.last_seen.get(worker, -float("inf"))


class FailureDetector:
    def __init__(self, workers: Iterable[int], *,
                 suspect_after: float = 10.0, dead_after: float = 30.0,
                 now: float = 0.0):
        if dead_after < suspect_after:
            raise ValueError("dead_after must be >= suspect_after")
        self.table = HeartbeatTable()
        self.workers = set(workers)
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self.dead: Set[int] = set()
        self.suspected: Set[int] = set()
        # registration grace: a fresh worker's silence clock starts at
        # registration, not at -inf (cold-start fix; see module docstring)
        self.start(now)

    def start(self, now: float) -> None:
        """(Re)register every live worker at ``now`` — the cold-start /
        restart grace: nothing is suspected before ``now +
        suspect_after`` without an actual missed heartbeat window."""
        for w in self.workers - self.dead:
            self.table.beat(w, now)

    def beat(self, worker: int, now: float) -> None:
        if worker not in self.workers:
            # late registration (elastic scale-out): joining IS a beat
            self.workers.add(worker)
        if worker not in self.dead:
            self.table.beat(worker, now)

    def declare_dead(self, worker: int) -> None:
        """Out-of-band death verdict — the bounded-retry collective path
        (repro_torch.ft.elastic) gives up on a partitioned device before its
        heartbeat silence reaches ``dead_after``."""
        if worker in self.workers:
            self.dead.add(worker)
            self.suspected.discard(worker)

    def check(self, now: float) -> Dict[str, Set[int]]:
        """Returns the CURRENT suspected set and the NEWLY dead set."""
        suspected, dead = set(), set()
        for w in self.workers - self.dead:
            silent = self.table.silent_for(w, now)
            if silent >= self.dead_after:
                dead.add(w)
            elif silent >= self.suspect_after:
                suspected.add(w)
        self.dead |= dead
        self.suspected = suspected
        return {"suspected": suspected, "dead": dead}

    def alive(self) -> Set[int]:
        return self.workers - self.dead
