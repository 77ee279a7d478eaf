"""Reference oracle for the batched priority queue.

A plain Python ``heapq`` executes the batch-sequential specification
(DESIGN.md §2): a tick with add multiset ``X`` and ``r`` removes returns the
``r`` smallest keys of ``PQ ∪ X`` and leaves the rest.  Hypothesis tests
drive :func:`repro.core.pqueue.tick` against this oracle.

This is the analogue of the paper's linearizability argument: every batch
tick corresponds to the linearization "eligible adds first, then removes in
ascending service order, then remaining adds", which respects the paper's
elimination rule (an add eliminates only when its key is <= the minimum at
its linearization point).
"""

from __future__ import annotations

import heapq
from typing import List, Sequence, Tuple


class RefPQ:
    """Sequential specification of the priority queue."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int]] = []

    def __len__(self) -> int:
        return len(self._heap)

    def add(self, key: float, val: int) -> None:
        heapq.heappush(self._heap, (float(key), int(val)))

    def remove_min(self) -> Tuple[float, int]:
        """Returns (key, val); (inf, -1) when empty (paper returns MaxInt)."""
        if not self._heap:
            return (float("inf"), -1)
        return heapq.heappop(self._heap)

    def tick(self, add_keys: Sequence[float], add_vals: Sequence[int],
             rm_count: int):
        """Batch-sequential tick: adds first, then rm_count removals.

        Returns (removed list of (key, val)).
        """
        for k, v in zip(add_keys, add_vals):
            self.add(k, v)
        return [self.remove_min() for _ in range(rm_count)]

    def keys(self) -> List[float]:
        return sorted(k for k, _ in self._heap)

    def items(self) -> List[Tuple[float, int]]:
        return sorted(self._heap)
