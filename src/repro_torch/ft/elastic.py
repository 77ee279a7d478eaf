"""Elastic recovery of the serving path and of training (PyTorch port of
the JAX package's ``ft/elastic.py``).

:class:`ElasticDistQueue` wraps a
:class:`repro_torch.core.distributed.DistShardedQueue` with the full
detect -> degrade -> resize loop: a :class:`repro_torch.ft.inject.
FaultInjector` (schedule + injected clock) drives the
:class:`repro_torch.ft.heartbeat.FailureDetector`; straggler costs feed a
:class:`repro_torch.ft.straggler.CostEma` whose weights throttle grants
through the tick's ``lane_scale``; a death verdict (heartbeat silence
past ``dead_after``, or bounded-retry exhaustion on a faulted collective)
triggers :meth:`~repro_torch.core.distributed.DistShardedQueue.
remove_device`: drain-and-remap over the survivors, multiset-conserving.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core.adaptive import LaneScaleController
from repro_torch.ft.heartbeat import FailureDetector
from repro_torch.ft.inject import (FaultInjector, FaultSchedule, SimClock,
                                   lane_weights)
from repro_torch.ft.straggler import CostEma


class ElasticDistQueue:
    """Fault-tolerant wrapper of a DistShardedQueue: detect -> degrade ->
    resize, all deterministic under the injected clock.

    The controller owns the queue, its state and the FT stack, and maps
    ORIGINAL device ids (what the schedule and detector speak) to current
    mesh positions through ``self.live`` (original ids in position
    order).  Per :meth:`step`:

    1. one :class:`FaultInjector` detection round: heartbeats from every
       device the schedule lets speak, then verdicts;
    2. NEWLY dead devices -> drain-and-remap resize;
    3. grant weights: :class:`CostEma` of observed tick costs for
       healthy-but-slow devices, the EMA floor for suspected ones,
       expanded per lane into the tick's ``lane_scale``;
    4. bounded retry on the collective: while any live device is faulted
       (killed or partitioned but not yet declared), each attempt burns
       ``collective_timeout`` on the clock; after ``max_retries`` the
       faulted devices are declared dead and re-sharded away;
    5. the real tick on the healthy mesh (``tick_dt`` clock cost).
    """

    kind = "elastic"

    def __init__(self, queue, *, schedule: Optional[FaultSchedule] = None,
                 seed: int = 0, tick_dt: float = 1.0,
                 suspect_after: float = 3.0, dead_after: float = 6.0,
                 collective_timeout: float = 2.0, max_retries: int = 3,
                 ema_decay: float = 0.5, weight_floor: float = 0.25,
                 controller=None):
        self.queue = queue
        self.state = queue.init(seed=seed)
        self.clock = SimClock()
        self.schedule = (schedule if schedule is not None
                         else FaultSchedule.none())
        n = queue.cfg.n_devices
        self.live: List[int] = list(range(n))
        self.detector = FailureDetector(
            range(n), suspect_after=suspect_after, dead_after=dead_after,
            now=self.clock.now)
        self.injector = FaultInjector(self.schedule, self.detector,
                                      self.clock, base_cost=tick_dt)
        self.cost_ema = CostEma(n, decay=ema_decay, floor=weight_floor)
        self.tick_dt = float(tick_dt)
        self.collective_timeout = float(collective_timeout)
        self.max_retries = int(max_retries)
        self._last_scale: Optional[np.ndarray] = None
        # optional workload controller: an engine switch is unavailable on
        # a mesh, so its fold decision arrives as lane_scale caps; the FT
        # throttle always wins (elementwise min)
        self.controller = None
        if controller is not None:
            self.controller = LaneScaleController(
                controller, queue.cfg.shard.n_lanes,
                min_lanes=queue.cfg.lanes_per_device, floor=weight_floor)

    # -- introspection -----------------------------------------------------

    def size(self) -> int:
        return int(self.queue.size(self.state))

    def stats(self, state=None):
        """ShardedStats of the current state (depth and min_head too)."""
        return self.queue.stats(self.state if state is None else state)

    # -- QueueEngine protocol: the wrapper is stateful, so callers pass the
    # state they last got back, or None for the current one --

    @property
    def width(self) -> int:
        return self.queue.width

    def init(self, *, seed: int = 0):
        self.state = self.queue.init(seed=seed)
        return self.state

    def tick(self, state, add_keys, add_vals, add_mask, rm_count):
        if state is not None:
            self.state = state
        res, _ = self.step(add_keys, add_vals, add_mask, rm_count)
        return self.state, res

    def tick_n(self, state, add_keys, add_vals, add_mask, rm_counts):
        if state is not None:
            self.state = state
        results = []
        for t in range(len(rm_counts)):
            res, _ = self.step(add_keys[t], add_vals[t], add_mask[t],
                               rm_counts[t])
            results.append(res)
        stacked = type(results[0])(*(torch.stack(f) for f in
                                     zip(*results))) if results else None
        return self.state, stacked

    def resident(self, state=None):
        return self.queue.resident(self.state if state is None else state)

    def capacity_scale(self) -> float:
        """Mean grant-throttle fraction over live lanes from the LAST tick
        (1.0 before the first): the degraded-mode signal the serving layer
        feeds into admission feasibility."""
        if self._last_scale is None:
            return 1.0
        return float(np.mean(self._last_scale))

    def relax_bound(self, rm_count: int) -> int:
        """Current-mesh rank bound (L shrinks with the mesh)."""
        return self.queue.relax_bound(rm_count)

    # -- recovery internals ------------------------------------------------

    def _remove(self, device: int) -> None:
        """Re-shard ORIGINAL device id ``device`` away."""
        if device not in self.live or len(self.live) < 2:
            return
        pos = self.live.index(device)
        self.queue, self.state = self.queue.remove_device(self.state, pos)
        self.live.remove(device)

    def _lane_scale(self, suspected) -> np.ndarray:
        w = self.cost_ema.weights(self.live)
        for i, dev in enumerate(self.live):
            if dev in suspected:
                # silent but not dead: no timing signal, assume the worst
                # the floor allows (keeps the lanes draining)
                w[i] = self.cost_ema.floor
        return lane_weights(w, self.queue.cfg.lanes_per_device)

    def _await_collective(self):
        """Bounded retry until no live device is faulted; returns the
        devices declared dead out of band (retry exhaustion)."""
        declared = []
        for _ in range(self.max_retries):
            if not any(self.schedule.faulty(d, self.clock.now)
                       for d in self.live):
                return declared
            self.clock.advance(self.collective_timeout)
        for d in list(self.live):
            if self.schedule.faulty(d, self.clock.now) and len(self.live) > 1:
                self.detector.declare_dead(d)
                self._remove(d)
                declared.append(d)
        return declared

    # -- the fault-tolerant tick -------------------------------------------

    def step(self, add_keys, add_vals, add_mask, rm_count):
        """One fault-tolerant synchronized round.  Returns ``(result,
        info)``: the tick's ShardedTickResult and ``{"removed",
        "suspected", "weights", "live"}``."""
        verdict = self.injector.step()
        self.cost_ema.update(verdict["costs"])
        removed = []
        for d in sorted(verdict["dead"]):
            if d in self.live and len(self.live) > 1:
                self._remove(d)
                removed.append(d)
        removed += self._await_collective()
        suspected = {d for d in verdict["suspected"] if d in self.live}
        scale = self._lane_scale(suspected)
        if self.controller is not None:
            self.controller.observe(add_keys, add_mask, rm_count)
            # a regime decision can cap a healthy lane but never raise a
            # degraded device's FT throttle
            scale = np.minimum(scale,
                               self.controller.lane_scale()[:len(scale)])
        self._last_scale = np.asarray(scale)
        self.state, res = self.queue.tick(
            self.state, add_keys, add_vals, add_mask, rm_count,
            torch.from_numpy(self._last_scale).to(self.queue.device))
        self.clock.advance(self.tick_dt)
        return res, {"removed": removed, "suspected": suspected,
                     "weights": scale, "live": list(self.live)}


class ElasticTrainer:
    """Checkpoint/restart around a training step: saves every
    ``save_every`` steps and at the end (``CheckpointManager``, newest
    ``keep``), and resumes from the newest checkpoint after a crash."""

    def __init__(self, ckpt_dir, *, save_every: int = 50, keep: int = 3):
        self.mgr = CheckpointManager(ckpt_dir, keep=keep)
        self.save_every = save_every

    def run(self, state, step_fn: Callable, data_fn: Callable,
            n_steps: int, *, start_step: int = 0,
            fail_at: Optional[int] = None, shardings=None):
        """Drive training; optionally simulate a crash at ``fail_at``.

        Returns (state, last_step, metrics_history).  After a simulated
        failure the caller restarts via :meth:`resume`, possibly on
        another mesh (pass the new shardings there).  ``shardings`` is
        taken for the reference's signature and unused, as there: a
        placed state is saved whole, whatever its mesh."""
        history = []
        step = start_step
        while step < n_steps:
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = data_fn(step)
            state, metrics = step_fn(state, batch)
            step += 1
            history.append({k: float(v) for k, v in metrics.items()})
            if step % self.save_every == 0 or step == n_steps:
                self.mgr.save(step, state)
        return state, step, history

    def resume(self, state_like, device=None, *, shardings=None):
        """Restore the newest checkpoint into ``state_like``'s structure:
        placed by ``shardings`` (a tree of ``NamedSharding``, the current
        mesh's), else onto ``device`` (default: where ``state_like``'s
        leaves lie).  Returns (state, step)."""
        return self.mgr.restore(state_like, device, shardings=shardings)
