"""Straggler mitigation via the adaptive priority queue (PyTorch port of
the JAX package's ``ft/straggler.py``).

Two mechanisms, both fed by the same signal (observed per-worker tick
cost):

* **work stealing through the queue**: microbatches are work items keyed
  by *predicted cost*; workers pull from a shared :class:`StragglerQueue`
  (the L-lane sharded engine, :mod:`repro_torch.core.sharded`): fast
  workers drain cheap items first and steal more, a straggler's excess
  items stay queued for others;
* **grant throttling in the mesh queue**: :class:`CostEma` keeps a
  per-device EMA of observed tick cost and converts it to grant
  *weights*; the distributed queue's allocation (``grant_cap`` of
  ``sharded._alloc_removes_arrays``) then grants a slow device's lanes
  fewer removes per round (:mod:`repro_torch.ft.elastic` wires this into
  the distributed tick's ``lane_scale``).

The simulation below is deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import sharded as shq
from repro_torch.core.config import EMPTY_VAL, PQConfig
from repro_torch.core.sharded import ShardedPQConfig


@dataclasses.dataclass
class WorkItem:
    wid: int
    cost: float          # predicted seconds
    done_by: Optional[int] = None


class StragglerQueue:
    """Cost-prioritized work queue with stealing, backed by the L-lane
    sharded engine on ``device`` (one synchronized round per ``pull``).
    ``backend`` picks the lanes' kernel backend when ``cfg`` is None
    (None keeps the default, "cuda")."""

    def __init__(self, items: List[WorkItem],
                 cfg: Optional[ShardedPQConfig] = None, *,
                 n_lanes: int = 4, seed: int = 0, device="cuda",
                 backend: Optional[str] = None):
        if cfg is None:
            width = max(8, len(items))
            base = PQConfig(
                a_max=width, r_max=width, seq_cap=4 * width + 2,
                n_buckets=8, bucket_cap=max(8, width),
                detach_min=8, detach_max=256, detach_init=8,
                chop_patience=64)
            from repro_torch.core.factory import EngineSpec, make_engine

            cfg = make_engine(EngineSpec(
                engine="sharded", width=width, base=base, lanes=n_lanes,
                backend=backend), device=device).cfg
        self.cfg = cfg
        self.state = shq.init(cfg, seed=seed, device=device)
        self.items = {it.wid: it for it in items}
        # enqueue everything up front (add-only rounds, chunked to the
        # op-batch width)
        w = cfg.a_total
        todo = list(items)
        while todo:
            chunk, todo = todo[:w], todo[w:]
            ak = np.full((w,), np.inf, np.float32)
            av = np.full((w,), EMPTY_VAL, np.int32)
            mask = np.zeros((w,), bool)
            for i, it in enumerate(chunk):
                ak[i] = it.cost
                av[i] = it.wid
                mask[i] = True
            self.state, _ = shq.tick(cfg, self.state, ak, av, mask, 0)

    def pull(self, k: int) -> List[WorkItem]:
        """One remove-only round: up to k near-cheapest items (exact min
        for k=1: the grant goes to the lane with the smallest head)."""
        w = self.cfg.a_total
        self.state, res = shq.tick(
            self.cfg, self.state, np.full((w,), np.inf, np.float32),
            np.full((w,), EMPTY_VAL, np.int32), np.zeros((w,), bool), k)
        vals = res.rm_vals[res.rm_served].tolist()
        return [self.items[v] for v in vals if v != EMPTY_VAL]

    def remaining(self) -> int:
        return int(shq.size(self.state))


class CostEma:
    """Per-device EMA of observed tick cost -> grant weights in (0, 1].

    ``update`` folds one round's observed costs (missing devices keep
    their EMA: silence carries no timing); ``weights`` maps the EMA to a
    weight relative to the fleet median (median-healthy devices get 1.0;
    a device running f times slower gets ~1/f, floored), which
    :mod:`repro_torch.ft.elastic` expands per lane into the distributed
    tick's ``lane_scale``.  The floor keeps a throttled lane draining."""

    def __init__(self, n_devices: int, *, decay: float = 0.5,
                 floor: float = 0.25):
        if not (0.0 < decay <= 1.0):
            raise ValueError("decay must be in (0, 1]")
        if not (0.0 < floor <= 1.0):
            raise ValueError("floor must be in (0, 1]")
        self.n_devices = n_devices
        self.decay = decay
        self.floor = floor
        self.ema = np.ones((n_devices,), np.float64)
        self._seen = np.zeros((n_devices,), bool)

    def update(self, costs: Dict[int, float]) -> None:
        for dev, c in costs.items():
            if not (0 <= dev < self.n_devices):
                raise ValueError(f"device {dev} out of range")
            if self._seen[dev]:
                self.ema[dev] = ((1 - self.decay) * self.ema[dev]
                                 + self.decay * float(c))
            else:               # the first observation seeds the EMA
                self.ema[dev] = float(c)
                self._seen[dev] = True

    def weights(self, devices: Optional[List[int]] = None) -> np.ndarray:
        """[len(devices)] weights (default: all devices, id order)."""
        devices = list(range(self.n_devices)) if devices is None else devices
        seen = [d for d in devices if self._seen[d]]
        med = float(np.median(self.ema[seen])) if seen else 1.0
        w = np.clip(med / self.ema[devices], self.floor, 1.0)
        return w.astype(np.float32)


def simulate(n_items: int = 64, n_workers: int = 8, straggler: int = 0,
             slow_factor: float = 4.0, seed: int = 0, *, device="cuda",
             backend: Optional[str] = None) -> Dict[str, float]:
    """Run the work-stealing simulation; returns makespan stats.

    Baseline: static round-robin assignment; PQ: cost-priority stealing
    through the sharded engine on ``device``.  The PQ's makespan should
    approach the ideal (total / sum of speeds) while the static baseline
    is dominated by the straggler."""
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.5, 1.5, n_items)
    speed = np.ones(n_workers)
    speed[straggler] = 1.0 / slow_factor

    # --- static round robin ---
    static_t = np.zeros(n_workers)
    for i, c in enumerate(costs):
        w = i % n_workers
        static_t[w] += c / speed[w]
    static_makespan = float(static_t.max())

    # --- PQ work stealing: workers pull when free ---
    q = StragglerQueue([WorkItem(i, float(c)) for i, c in enumerate(costs)],
                       device=device, backend=backend)
    t = np.zeros(n_workers)
    while q.remaining() > 0:
        w = int(np.argmin(t))
        got = q.pull(1)
        if not got:
            break
        t[w] += got[0].cost / speed[w]
    pq_makespan = float(t.max())

    ideal = float(costs.sum() / speed.sum())
    return {"static": static_makespan, "pq": pq_makespan, "ideal": ideal,
            "speedup": static_makespan / pq_makespan}
