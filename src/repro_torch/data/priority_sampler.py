"""Loss-prioritized curriculum sampling on the adaptive priority queue
(PyTorch port of the JAX package's ``data/priority_sampler.py``).

The second framework integration of the paper's structure (after the
serving engine): example *groups* (shards of the stream) carry a
priority key = -EMA(loss) + staleness bonus.  Each training step:

* ``removeMin() × k`` selects the next groups to train on (highest loss
  first — the min-key convention stores negated priorities);
* after the step, groups are re-``add()``-ed with their refreshed key —
  an add whose key beats the current minimum can *eliminate* against the
  next step's removal without touching the queue (the hot-example fast
  path);
* the staleness bonus guarantees every group is revisited (no
  starvation), mirroring the paper's aging-based upcoming elimination.

The queue is the port's pqe tick (:func:`repro_torch.core.pqueue.tick`)
on ``device`` (default the card) under the config's backend (default
``"cuda"``: the lane-tick kernel runs every tick).  Each tick's batch is
built in numpy float32, as the reference builds it, so a Python float
key rounds the same way in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import pqueue
from repro_torch.core.config import EMPTY_VAL, PQConfig


@dataclasses.dataclass
class GroupStat:
    gid: int
    ema_loss: float = 10.0
    last_step: int = 0


#: the queue the sampler runs on unless given another
DEFAULT_CFG = PQConfig(a_max=64, r_max=64, seq_cap=1024, n_buckets=32,
                       bucket_cap=64, detach_min=8, detach_max=512,
                       detach_init=32)


class _HostPQ:
    """Host loop over the single-queue device tick (submit arrivals,
    acquire up to k minima per step).  The sampler is a single-host
    curriculum structure, so it stays on the plain pqe queue rather than
    the distributed serving engine."""

    def __init__(self, cfg: Optional[PQConfig] = None, device="cuda"):
        self.cfg = cfg or DEFAULT_CFG
        self.state = pqueue.init(self.cfg, torch.device(device))
        self.pending = 0

    def submit_and_acquire(self, arrivals: List[tuple],
                           free_slots: int) -> List[int]:
        """One tick: enqueue ``(gid, key)`` pairs, dequeue up to
        ``free_slots`` gids in key order.  Elimination / combining
        happen inside the device tick; the Fig. 7/8-style breakdown is
        available via :meth:`stats`."""
        cap = self.cfg.par_cap - self.pending
        if len(arrivals) > min(cap, self.cfg.a_max):
            raise ValueError(
                f"admission overflow: {len(arrivals)} arrivals, capacity "
                f"{min(cap, self.cfg.a_max)} — backpressure upstream")
        ak = np.full((self.cfg.a_max,), np.inf, np.float32)
        av = np.full((self.cfg.a_max,), EMPTY_VAL, np.int32)
        mask = np.zeros((self.cfg.a_max,), bool)
        for i, (gid, key) in enumerate(arrivals):
            ak[i] = key
            av[i] = gid
            mask[i] = True
        self.pending += len(arrivals)
        n_rm = min(free_slots, self.cfg.r_max)
        self.state, res = pqueue.tick(self.cfg, self.state, ak, av, mask,
                                      n_rm)
        got = res.rm_vals[res.rm_served].cpu().numpy()
        out = [int(g) for g in got.tolist() if g != EMPTY_VAL]
        self.pending -= len(out)
        return out

    def stats(self) -> Dict[str, int]:
        s = self.state.stats
        return {k: int(getattr(s, k)) for k in s._fields}


class PrioritySampler:
    def __init__(self, n_groups: int, *, ema: float = 0.9,
                 staleness_weight: float = 0.01,
                 cfg: Optional[PQConfig] = None, seed: int = 0,
                 device="cuda"):
        self.groups = {g: GroupStat(g) for g in range(n_groups)}
        self.ema = ema
        self.staleness_weight = staleness_weight
        self.sched = _HostPQ(cfg, device)
        self.step = 0
        # enqueue everything initially with random tie-break
        rng = np.random.default_rng(seed)
        arrivals = [(g, float(-10.0 + 1e-3 * rng.random()))
                    for g in self.groups]
        self.sched.submit_and_acquire(arrivals, 0)

    def _key(self, g: GroupStat) -> float:
        stale = (self.step - g.last_step) * self.staleness_weight
        return float(-(g.ema_loss + stale))

    def next_groups(self, k: int) -> List[int]:
        return self.sched.submit_and_acquire([], k)

    def report(self, gid: int, loss: float) -> None:
        g = self.groups[gid]
        g.ema_loss = self.ema * g.ema_loss + (1 - self.ema) * float(loss)
        g.last_step = self.step

    def requeue(self, gids: List[int]) -> None:
        self.step += 1
        arrivals = [(g, self._key(self.groups[g])) for g in gids]
        self.sched.submit_and_acquire(arrivals, 0)

    def breakdown(self) -> Dict[str, int]:
        return self.sched.stats()
