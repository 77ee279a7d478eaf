"""Adaptive policies (PyTorch port of the JAX package's
``core/adaptive.py``): the paper's moveHead sizing (§2.1) and the
workload controller that picks the ENGINE (§3 scaled up).

The paper's claim is that the winning structure depends on the
workload: elimination + combining when add() and removeMin() arrive
balanced with keys near the minimum, a single combined queue for
balanced but dispersed mixes, relaxed lanes (MultiQueues) for skewed
drain/fill phases.  :class:`AdaptiveEngine` closes the loop: per-window
EMAs of three signals drive three decisions with hysteresis.

* **add/remove balance** ``min(n_add, n_rm) / max(n_add, n_rm)``;
* **key dispersion** ``(mean - min) / (max - min)`` of each tick's live
  add batch (near-frontier exponential keys give ~0.13 at bench widths,
  uniform keys ~0.5);
* **elimination hit rate**, the sharded queue's own pre-route EMA.

Decisions: (1) the engine, pqe or sharded (drain the live structure
through ``resident``, re-insert into the other through zero-remove
ticks); (2) the live lane count (``fold_lanes`` / ``unfold_lanes``);
(3) the pre-route mode ("off" while the hit EMA is low, re-probed every
``reprobe`` windows).  Hysteresis: two-threshold latches per signal,
``confirm`` consecutive windows, ``cooldown`` windows between switches.

The controller is host logic, copied from the reference: for the same
signals :func:`decide` returns the same ``ControllerState`` and ``Plan``.
The bands are the reference's, placed from its own measurements; they
are not retuned for this port.  Usage, through the factory::

    from repro_torch.core.factory import EngineSpec, make_engine
    from repro_torch.core.adaptive import ControllerConfig

    eng = make_engine(EngineSpec(
        engine="adaptive", width=4096, lanes=8,
        controller=ControllerConfig(window=20)))       # on cuda
    state = eng.init(seed=0)
    state, res = eng.tick(state, keys, vals, mask, rm_count)
    print(eng.controller_stats(state))   # EMAs, latches, switch count

``ControllerConfig(quality_budget=...)`` (or ``EngineSpec(quality_budget=
...)``; the tighter wins) caps the lane ceiling through the envelope of
:func:`repro_torch.core.factory.lanes_within_budget`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pqueue
from repro_torch.core import sharded as shq
from repro_torch.core.config import EMPTY_VAL, PQConfig

_I32 = torch.int32
_F32 = torch.float32
INF = float("inf")


def update_detach(cfg: PQConfig, detach_n, ins_since_move):
    """New detach size after a moveHead event (paper §2.1).

    "If more than N insertions (e.g. N = 1000) occurred in the
    sequential part since the last SL::moveHead(), we halve the number
    of elements moved; otherwise, if less than M insertions (e.g.
    M = 100) were made, we double this number."  Between the thresholds
    the size holds (dead band); results clamp to
    [detach_min, detach_max].  Elementwise over int32 tensors.
    """
    detach_n = torch.as_tensor(detach_n, dtype=torch.int32)
    ins_since_move = torch.as_tensor(ins_since_move, dtype=torch.int32,
                                     device=detach_n.device)
    halved = (detach_n // 2).clamp(min=cfg.detach_min)
    doubled = (detach_n * 2).clamp(max=cfg.detach_max)
    return torch.where(
        ins_since_move > cfg.halve_threshold,
        halved,
        torch.where(ins_since_move < cfg.double_threshold, doubled,
                    detach_n),
    )


# ---------------------------------------------------------------------------
# controller configuration and state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Workload-controller policy knobs (all host-side).

    The balance and dispersion thresholds are two-sided hysteresis
    bands: the latch flips high past ``*_hi``, low past ``*_lo``, and
    holds in between.  The reference placed them from its measured
    workload signatures: the bench's p30/p70 mixes sit at balance 0.43,
    p50 at 1.0 (band [0.5, 0.7] splits them); DES dispersion ~0.13,
    uniform ~0.5 (band [0.22, 0.32]).
    """

    window: int = 8  # ticks per decision window
    decay: float = 0.25  # per-window EMA step (seeded on first obs)
    balance_lo: float = 0.5
    balance_hi: float = 0.7
    disp_lo: float = 0.22
    disp_hi: float = 0.32
    hit_lo: float = 0.05  # below: force preroute off (reprobe later)
    confirm: int = 2  # consecutive windows before a switch
    cooldown: int = 4  # windows of enforced quiet after a switch
    reprobe: int = 16  # windows between forced preroute re-probes
    freeze: bool = False  # forced-static: never switch anything
    engines: Tuple[str, ...] = ("pqe", "sharded")
    # rank-error budget: caps the lane ceiling the controller may unfold
    # to (factory.lanes_within_budget envelope; None = unbudgeted)
    quality_budget: Optional[float] = None

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.quality_budget is not None and self.quality_budget < 0:
            raise ValueError("quality_budget must be >= 0")
        if not (0.0 < self.decay <= 1.0):
            raise ValueError("decay must be in (0, 1]")
        if self.confirm < 1 or self.cooldown < 0:
            raise ValueError("confirm >= 1, cooldown >= 0")
        if not self.engines or any(e not in ("pqe", "sharded")
                                   for e in self.engines):
            raise ValueError(
                "engines must be a nonempty subset of ('pqe', 'sharded')")
        if not (self.balance_lo <= self.balance_hi
                and self.disp_lo <= self.disp_hi):
            raise ValueError("hysteresis bands must have lo <= hi")


class Plan(NamedTuple):
    """One engine decision: which structure, how many live lanes, and
    the pre-route gate mode."""

    kind: str  # "pqe" | "sharded"
    lanes: int  # live L (pqe ignores it)
    preroute: str  # "adaptive" | "on" | "off"


@dataclasses.dataclass(frozen=True)
class ControllerState:
    """Host-side controller memory (updates return new instances, so
    engine states stay copy/branch-safe)."""

    balance_ema: float = 0.0
    disp_ema: float = 0.0
    hit_ema: float = 1.0
    seeded_balance: bool = False  # EMA seeds on first informative window
    seeded_disp: bool = False
    balanced: bool = False  # hysteresis latches
    dispersed: bool = False
    low_hit: bool = False
    pending: Optional[Plan] = None
    pending_n: int = 0
    cooldown: int = 0
    n_windows: int = 0
    n_switches: int = 0
    # partial-window accumulators (weighted sums over informative ticks)
    acc_bal: float = 0.0
    acc_bal_n: float = 0.0
    acc_disp: float = 0.0
    acc_disp_n: float = 0.0


def _window_signals(add_keys, add_mask, rm_counts) -> torch.Tensor:
    """Per-chunk signal sums over [T, W] op batches, stacked into one [4]
    f32 tensor so the caller reads them with one host pull: weighted
    balance and dispersion sums and their informative-tick counts.  An
    idle tick says nothing about the mix; a tick with < 2 distinct live
    keys says nothing about dispersion.  The counts are exact; the float
    sums may round in another order than the reference's."""
    m = add_mask
    n_add = m.sum(-1, dtype=_I32)  # [T]
    rm = rm_counts.to(_I32)
    opp = torch.minimum(n_add, rm)
    peak = torch.maximum(n_add, rm)
    bal = opp.to(_F32) / peak.clamp(min=1).to(_F32)
    k = add_keys.to(_F32)
    kmin = torch.where(m, k, INF).amin(-1)
    kmax = torch.where(m, k, -INF).amax(-1)
    mean = torch.where(m, k, 0.0).sum(-1) / n_add.clamp(min=1).to(_F32)
    spread = kmax - kmin
    disp = (mean - kmin) / torch.where(spread > 0, spread, 1.0)
    disp_ok = (n_add >= 2) & (spread > 0)
    # the reference multiplies by the 0/1 weight, which its compiler
    # turns into a select: an idle tick's -inf dispersion adds 0, not NaN
    return torch.stack([torch.where(peak > 0, bal, 0.0).sum(),
                        (peak > 0).to(_F32).sum(),
                        torch.where(disp_ok, disp, 0.0).sum(),
                        disp_ok.to(_F32).sum()])


def _ema(old: float, obs: float, seeded: bool, decay: float):
    """Seed-on-first-observation EMA: the first informative window sets
    the level outright, so cold-start bias cannot hold the controller in
    the wrong regime for 1/decay windows."""
    if not seeded:
        return obs, True
    return (1.0 - decay) * old + decay * obs, True


def decide(
    cfg: ControllerConfig,
    ctl: ControllerState,
    current: Plan,
    *,
    max_lanes: int,
    min_lanes: int,
    base_preroute: str,
) -> Tuple[ControllerState, Plan]:
    """One window-boundary decision step: fold the accumulated signals
    into the EMAs, advance the hysteresis latches, and return the
    (possibly unchanged) plan.  Pure host logic."""
    balance, seeded_b = ctl.balance_ema, ctl.seeded_balance
    if ctl.acc_bal_n > 0:
        balance, seeded_b = _ema(
            balance, ctl.acc_bal / ctl.acc_bal_n, seeded_b, cfg.decay
        )
    disp, seeded_d = ctl.disp_ema, ctl.seeded_disp
    if ctl.acc_disp_n > 0:
        disp, seeded_d = _ema(disp, ctl.acc_disp / ctl.acc_disp_n, seeded_d,
                              cfg.decay)

    balanced = ctl.balanced
    if balance >= cfg.balance_hi:
        balanced = True
    elif balance < cfg.balance_lo:
        balanced = False
    dispersed = ctl.dispersed
    if disp >= cfg.disp_hi:
        dispersed = True
    elif disp < cfg.disp_lo:
        dispersed = False
    low_hit = ctl.low_hit
    if ctl.hit_ema < cfg.hit_lo:
        low_hit = True
    elif ctl.hit_ema >= 2.0 * cfg.hit_lo:
        low_hit = False
    n_windows = ctl.n_windows + 1
    if low_hit and cfg.reprobe > 0 and n_windows % cfg.reprobe == 0:
        low_hit = False  # reopen the pass so a shifted workload re-measures

    can_pqe = "pqe" in cfg.engines
    can_sharded = "sharded" in cfg.engines
    pr = "off" if low_hit else base_preroute
    if balanced and dispersed:
        # the combined queue's regime; without it, fold lanes toward the
        # combined limit (tightens the c-relaxed bound immediately)
        target = (
            Plan("pqe", max_lanes, pr) if can_pqe
            else Plan("sharded", min_lanes, pr)
        )
    elif can_sharded:
        target = Plan("sharded", max_lanes, pr)
    else:
        target = Plan("pqe", max_lanes, pr)

    new = dataclasses.replace(
        ctl,
        balance_ema=balance,
        disp_ema=disp,
        seeded_balance=seeded_b,
        seeded_disp=seeded_d,
        balanced=balanced,
        dispersed=dispersed,
        low_hit=low_hit,
        n_windows=n_windows,
        cooldown=max(0, ctl.cooldown - 1),
        acc_bal=0.0,
        acc_bal_n=0.0,
        acc_disp=0.0,
        acc_disp_n=0.0,
    )

    if cfg.freeze or target == current:
        return dataclasses.replace(new, pending=None, pending_n=0), current
    if new.cooldown > 0:
        return dataclasses.replace(new, pending=None, pending_n=0), current
    if new.pending == target:
        pending_n = new.pending_n + 1
    else:
        pending_n = 1
    if pending_n >= cfg.confirm:
        new = dataclasses.replace(
            new,
            pending=None,
            pending_n=0,
            cooldown=cfg.cooldown,
            n_switches=new.n_switches + 1,
        )
        return new, target
    return dataclasses.replace(new, pending=target, pending_n=pending_n), \
        current


# ---------------------------------------------------------------------------
# the adaptive engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdaptiveState:
    """Engine state: the live structure's state (``inner``, a tree of
    NamedTuples of tensors) plus the host-side plan and controller
    memory.  ``dataclasses.replace(state, inner=pqueue.tree_map(
    torch.clone, state.inner))`` is an independent copy that replays
    the same decisions."""

    inner: Any
    kind: str
    lanes: int
    preroute: str
    tick_count: int
    seed: int
    ctl: ControllerState


class AdaptiveEngine:
    """The paper-style adaptive queue: a workload controller over the
    combined queue (pqe) and the sharded relaxed lanes, satisfying the
    :class:`repro_torch.core.factory.QueueEngine` protocol.

    ``spec.lanes`` is the sharded candidate's full L; ``spec.min_lanes``
    (when set below ``lanes``) also sizes per-lane quotas with fold
    headroom and enables the live lane-count decision.  Left at None,
    the sharded candidate's config is the fixed ``sharded`` engine's.

    Ticks run in window-aligned chunks through the candidates' own
    ``tick_n``; decisions happen at window boundaries on the host.  An
    engine switch drains the live structure's resident set and
    re-inserts it through zero-remove ticks, which serve nothing, so the
    switch conserves the multiset exactly.  Every candidate runs on the
    engine's device with the spec's kernel backend: under ``"cuda"``,
    K3 (and K2, the router's sort, in sharded windows).
    """

    kind = "adaptive"

    def __init__(self, spec, device: torch.device):
        from repro_torch.core import factory  # deferred: factory imports us

        self.spec = spec
        self.device = device
        self.ctl_cfg: ControllerConfig = spec.controller or ControllerConfig()
        self.base = factory.resolved_base(spec)
        factory._check_device(self.base.backend, device)
        self.max_lanes = spec.lanes
        budgets = [
            b
            for b in (spec.quality_budget, self.ctl_cfg.quality_budget)
            if b is not None
        ]
        if budgets:
            # the tighter budget wins; the cap is the envelope inversion,
            # so every plan the controller may pick (lanes <= max_lanes)
            # already fits it
            qspec = dataclasses.replace(spec, quality_budget=min(budgets))
            self.max_lanes = factory.lanes_within_budget(qspec, spec.lanes)
        self.min_lanes = (spec.min_lanes if spec.min_lanes is not None
                          else spec.lanes)
        self.min_lanes = min(self.min_lanes, self.max_lanes)
        self.base_preroute = spec.preroute
        self._scfg_cache = {}
        self._chunk_cache = {}
        scfg = self._sharded_cfg(self.max_lanes, self.base_preroute)
        self.out_w = max(spec.width, self.max_lanes * scfg.lane.r_max,
                         self.base.r_max)
        start = "sharded" if "sharded" in self.ctl_cfg.engines else "pqe"
        self._start_plan = Plan(start, self.max_lanes, self.base_preroute)

    # -- candidate configs ------------------------------------------------

    @property
    def width(self) -> int:
        return self.spec.width

    @property
    def cfg(self):
        """The sharded candidate's full-L config (duck-typed geometry
        for drivers that read ``cfg.a_max``)."""
        return self._sharded_cfg(self.max_lanes, self.base_preroute)

    def _sharded_cfg(self, lanes: int, preroute: str):
        key = (lanes, preroute)
        if key not in self._scfg_cache:
            if lanes == self.max_lanes:
                # min_lanes re-clamped: a quality_budget cap may have
                # lowered max_lanes below the spec's fold floor
                ml = self.spec.min_lanes
                cfg = shq._sharded_cfg(
                    self.spec.width,
                    self.max_lanes,
                    base=self.base,
                    slack=self.spec.slack,
                    min_lanes=None if ml is None else min(ml, self.max_lanes),
                    preroute=preroute,
                )
            else:
                # folded configs must match fold_lanes output exactly:
                # same lane geometry, only n_lanes changes
                cfg = dataclasses.replace(
                    self._sharded_cfg(self.max_lanes, preroute),
                    n_lanes=lanes)
            self._scfg_cache[key] = cfg
        return self._scfg_cache[key]

    # -- protocol surface -------------------------------------------------

    def init(self, *, seed: int = 0) -> AdaptiveState:
        plan = self._start_plan
        if plan.kind == "sharded":
            inner = shq.init(self._sharded_cfg(plan.lanes, plan.preroute),
                             seed=seed, device=self.device)
        else:
            inner = pqueue.init(self.base, self.device)
        return AdaptiveState(
            inner=inner,
            kind=plan.kind,
            lanes=plan.lanes,
            preroute=plan.preroute,
            tick_count=0,
            seed=seed,
            ctl=ControllerState(),
        )

    def tick(self, state: AdaptiveState, add_keys, add_vals, add_mask,
             rm_count):
        batch = pqueue._as_batch(self.device, add_keys, add_vals, add_mask,
                                 rm_count)
        st, res = self.tick_n(state, *(x[None] for x in batch))
        return st, shq.ShardedTickResult(res.rm_keys[0], res.rm_vals[0],
                                         res.rm_served[0])

    def tick_n(self, state: AdaptiveState, add_keys, add_vals, add_mask,
               rm_counts):
        """T ticks over [T, ...]-stacked batches (tensors, numpy arrays
        or Python values; they move to the engine's device), in chunks
        that end on window boundaries.  Returns (state, the results
        stacked [T, out_w], padded with INF / EMPTY_VAL / False)."""
        add_keys, add_vals, add_mask, rm_counts = pqueue._as_batch(
            self.device, add_keys, add_vals, add_mask, rm_counts)
        T = add_keys.shape[0]
        win = self.ctl_cfg.window
        out = []
        t0 = 0
        while t0 < T:
            chunk = min(T - t0, win - state.tick_count % win)
            sl = slice(t0, t0 + chunk)
            fn = self._chunk_fn(state.kind, state.lanes, state.preroute)
            inner, res, sig = fn(state.inner, add_keys[sl], add_vals[sl],
                                 add_mask[sl], rm_counts[sl])
            out.append(self._pad(res))
            bal, bal_n, disp, disp_n = sig.tolist()  # one host pull a chunk
            ctl = dataclasses.replace(
                state.ctl,
                acc_bal=state.ctl.acc_bal + bal,
                acc_bal_n=state.ctl.acc_bal_n + bal_n,
                acc_disp=state.ctl.acc_disp + disp,
                acc_disp_n=state.ctl.acc_disp_n + disp_n,
            )
            state = dataclasses.replace(
                state,
                inner=inner,
                ctl=ctl,
                tick_count=state.tick_count + chunk,
            )
            if state.tick_count % win == 0:
                state = self._window_boundary(state)
            t0 += chunk
        if len(out) == 1:
            k, v, s = out[0]
        else:
            k, v, s = (torch.cat(xs) for xs in zip(*out))
        return state, shq.ShardedTickResult(k, v, s)

    def stats(self, state: AdaptiveState):
        if state.kind == "pqe":
            return state.inner.stats
        return shq.stats(state.inner)

    def controller_stats(self, state: AdaptiveState) -> dict:
        c = state.ctl
        return {
            "engine": state.kind,
            "lanes": state.lanes,
            "preroute": state.preroute,
            "n_switches": c.n_switches,
            "n_windows": c.n_windows,
            "balance_ema": c.balance_ema,
            "disp_ema": c.disp_ema,
            "hit_ema": c.hit_ema,
        }

    def resident(self, state: AdaptiveState):
        if state.kind == "pqe":
            return pqueue.resident(self.base, state.inner)
        cfg = self._sharded_cfg(state.lanes, state.preroute)
        return shq.resident(cfg, state.inner.lanes)

    def size(self, state: AdaptiveState):
        if state.kind == "pqe":
            return pqueue.size(state.inner)
        return shq.size(state.inner)

    def relax_bound(self, rm_count: int) -> int:
        """Worst case over the candidates: the full-L sharded bound (the
        combined queue is exact; a caller holding the engine across
        switches must assume the loosest)."""
        return shq.relax_bound(
            self._sharded_cfg(self.max_lanes, self.base_preroute), rm_count)

    # -- chunk execution --------------------------------------------------

    def _chunk_fn(self, kind: str, lanes: int, preroute: str):
        """The callable for one chunk under a plan: the candidate's
        ``tick_n`` plus the controller's window signals, cached by
        (kind, lanes, preroute) as the reference caches its compiled
        programs."""
        key = (kind, lanes, preroute)
        if key not in self._chunk_cache:
            if kind == "pqe":
                cfg, drv = self.base, pqueue.tick_n
            else:
                cfg = self._sharded_cfg(lanes, preroute)
                drv = shq.tick_n

            def run(inner, ak, av, am, rm):
                inner, res = drv(cfg, inner, ak, av, am, rm)
                return inner, res, _window_signals(ak, am, rm)

            self._chunk_cache[key] = run
        return self._chunk_cache[key]

    def _pad(self, res):
        """[T, width] results widened to [T, out_w]: INF keys,
        EMPTY_VAL vals, unserved."""
        k, v, s = res.rm_keys, res.rm_vals, res.rm_served
        padw = self.out_w - k.shape[-1]
        if padw:
            def pad(x, fill):
                return torch.cat([x, torch.full(
                    x.shape[:-1] + (padw,), fill, dtype=x.dtype,
                    device=x.device)], -1)
            k, v, s = pad(k, INF), pad(v, EMPTY_VAL), pad(s, False)
        return k, v, s

    def prewarm(self, state: AdaptiveState, ticks: int) -> None:
        """Run every (candidate, chunk-length) pair that a ``ticks``-long
        ``tick_n`` from the current position may dispatch once, on empty
        batches and fresh states: nothing is compiled here, but this
        loads the kernel libraries and warms the caching allocator
        before a timed run."""
        win = self.ctl_cfg.window
        lens = set()
        c, left = state.tick_count % win, ticks
        while left > 0:
            chunk = min(left, win - c % win)
            lens.add(chunk)
            left -= chunk
            c += chunk
        w = self.width
        # pqe states carry lanes = max_lanes (the Plan convention), so
        # the chunk cache keys here match what tick_n asks for
        kinds = [("pqe", self.max_lanes)]
        for ln in sorted({self.max_lanes, self.min_lanes}):
            kinds.append(("sharded", ln))
        for kind, ln in kinds:
            if kind not in self.ctl_cfg.engines:
                continue
            if kind == "pqe":
                inner = pqueue.init(self.base, self.device)
            else:
                inner = shq.init(self._sharded_cfg(ln, self.base_preroute),
                                 device=self.device)
            fn = self._chunk_fn(kind, ln, self.base_preroute)
            for T in sorted(lens):
                ak = torch.full((T, w), INF, dtype=_F32, device=self.device)
                av = torch.full((T, w), EMPTY_VAL, dtype=_I32,
                                device=self.device)
                am = torch.zeros((T, w), dtype=torch.bool,
                                 device=self.device)
                rms = torch.zeros((T,), dtype=_I32, device=self.device)
                inner, _, _ = fn(inner, ak, av, am, rms)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- switches (host-side, window-boundary only) -----------------------

    def _window_boundary(self, state: AdaptiveState) -> AdaptiveState:
        ctl = state.ctl
        if state.kind == "sharded":
            ctl = dataclasses.replace(ctl,
                                      hit_ema=float(state.inner.elim_ema))
        current = Plan(state.kind, state.lanes, state.preroute)
        ctl, plan = decide(
            self.ctl_cfg,
            ctl,
            current,
            max_lanes=self.max_lanes,
            min_lanes=self.min_lanes,
            base_preroute=self.base_preroute,
        )
        state = dataclasses.replace(state, ctl=ctl)
        if plan == current:
            return state
        return self._apply_plan(state, plan)

    def _apply_plan(self, state: AdaptiveState, plan: Plan) -> AdaptiveState:
        cur = Plan(state.kind, state.lanes, state.preroute)
        inner = state.inner
        if plan.kind != cur.kind:
            inner = self._switch_engine(state, plan)
        elif plan.kind == "sharded" and plan.lanes != cur.lanes:
            inner = self._refold(state, plan)
        # preroute-only changes are a pure cfg swap: ShardedState is
        # shape-identical across gate modes, so the state carries as-is
        return dataclasses.replace(
            state,
            inner=inner,
            kind=plan.kind,
            lanes=plan.lanes,
            preroute=plan.preroute,
        )

    def _live_resident(self, state: AdaptiveState):
        keys, vals, live = (x.reshape(-1).cpu().numpy()
                            for x in self.resident(state))
        return keys[live], vals[live]

    def _switch_engine(self, state: AdaptiveState, plan: Plan):
        keys, vals = self._live_resident(state)
        if plan.kind == "pqe":
            inner = pqueue.init(self.base, self.device)
            return self._reinsert_pqe(inner, keys, vals)
        cfg = self._sharded_cfg(plan.lanes, plan.preroute)
        inner = shq.init(cfg, seed=state.seed + state.ctl.n_switches,
                         device=self.device)
        return self._reinsert_sharded(cfg, inner, keys, vals)

    def _refold(self, state: AdaptiveState, plan: Plan):
        cur_cfg = self._sharded_cfg(state.lanes, state.preroute)
        if plan.lanes > state.lanes:
            _, inner = shq.unfold_lanes(cur_cfg, state.inner, plan.lanes)
            return inner
        # fold_lanes drains only the dropped lanes to the host
        new_cfg, inner, dk, dv = shq.fold_lanes(cur_cfg, state.inner,
                                                list(range(plan.lanes)))
        assert new_cfg == self._sharded_cfg(plan.lanes, state.preroute)
        return self._reinsert_sharded(new_cfg, inner, dk, dv)

    @staticmethod
    def _chunks(keys, vals, w: int):
        """Width-``w`` zero-remove batches (numpy) holding the keys."""
        for i in range(0, len(keys), w):
            ak = np.full((w,), np.inf, np.float32)
            av = np.full((w,), EMPTY_VAL, np.int32)
            m = np.zeros((w,), bool)
            ck = keys[i: i + w]
            ak[: len(ck)] = ck
            av[: len(ck)] = vals[i: i + w]
            m[: len(ck)] = True
            yield ak, av, m, 0

    def _reinsert_pqe(self, inner, keys, vals):
        for batch in self._chunks(keys, vals, self.base.a_max):
            inner, _ = pqueue.tick(self.base, inner, *batch)
        return inner

    def _reinsert_sharded(self, cfg, inner, keys, vals):
        # full-width chunks are drop-free: the permuted round-robin puts
        # at most ceil(W/L) slots on a lane, and lane.a_max was sized
        # for ceil(W/min_lanes) >= that
        dropped_pre = int(inner.n_router_dropped)
        for batch in self._chunks(keys, vals, cfg.a_total):
            inner, _ = shq.tick(cfg, inner, *batch)
        dropped = int(inner.n_router_dropped) - dropped_pre
        if dropped:
            raise AssertionError(
                f"engine switch dropped {dropped} keys on re-insertion — "
                "lane quotas under-sized for the fold target"
            )
        return inner
