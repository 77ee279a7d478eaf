"""Multi-lane sharded priority queue (PyTorch port of the JAX package's
``core/sharded.py``): L lanes of the combined queue ticked together in
one synchronized round, with relaxed (MultiQueues-style) removal order.

Each tick:

* **pre-route elimination** matches the tick's adds against its removeMin
  allocation under the min-of-lane-heads bound, behind an adaptive gate
  (EMAs of hit rate and add/remove balance carried in the state);
* the **stick-random router** assigns batch slots to lanes by a permuted
  round-robin pattern ``slot % L``, held for ``stick`` ticks, and sorts
  each lane's adds (one row co-sort of [L, W/L]: K2 under the "cuda"
  backend);
* **removes** are granted to lanes by the c-relaxed min-of-lane-heads
  allocation;
* the lanes tick lane-major: under ``"cuda"`` the hot pipeline is one
  launch of the lane-tick kernel K3 over all L lanes, under ``"torch"``
  the ported passes over [L, ...] lanes;
* per-lane serves fold into one compacted result stream.

Every pass keeps the reference's dtypes and arithmetic, so a tick is
bit-identical to the reference's on the same state and route.  Each
``lax.cond`` of the reference is a host-side branch here (a device sync;
the predicates a branch point needs are read in one ``tolist``), and
``tick_n`` is a Python loop.

The router's random draws cannot match the reference's threefry bits:
``rng`` is the port's own generator state, an int64 pair (seed, resample
count) that seeds a ``torch.Generator`` on the state's device at each
resample.  The module's ``tick``, ``fold_lanes`` and ``unfold_lanes`` take a
``route=`` that replaces the draw (it must permute the balanced pattern
``arange(W) % L``), so another generator's routes can be replayed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import elimination, pqueue
from repro_torch.core.config import EMPTY_VAL, PQConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import arange_i32

INF = float("inf")
_I32 = torch.int32
_I64 = torch.int64
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ShardedPQConfig:
    """Static config: ``lane`` is the per-lane PQConfig, ``n_lanes`` = L.

    ``lane.a_max`` / ``lane.r_max`` bound the per-lane batch shares; the
    permuted round-robin router is balanced by construction, so
    ceil(width / L) quotas never overflow; adds past an under-sized quota
    are dropped and counted (``n_router_dropped``)."""

    lane: PQConfig
    n_lanes: int = 4
    stick: int = 8          # ticks a routing permutation stays pinned
    a_total: int = 256      # un-sharded op-batch width fed to the router

    # pre-route elimination gate: "adaptive" (EMA controller with a probe
    # tick every elim_probe ticks), or static "on" / "off"
    preroute: str = "adaptive"
    elim_probe: int = 16
    elim_ema_decay: float = 0.25
    elim_gate: float = 0.25       # min EMA hit rate to keep the pass on
    balance_gate: float = 0.25    # min EMA min/max(add, rm) balance

    def __post_init__(self) -> None:
        if self.n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        if self.stick < 1:
            raise ValueError("stick must be >= 1")
        if self.a_total < 1:
            raise ValueError("a_total must be >= 1")
        if self.preroute not in ("adaptive", "on", "off"):
            raise ValueError("preroute must be adaptive|on|off")
        if self.elim_probe < 1:
            raise ValueError("elim_probe must be >= 1")
        if not (0.0 < self.elim_ema_decay <= 1.0):
            raise ValueError("elim_ema_decay must be in (0, 1]")

    # batch geometry as PQConfig spells it, so code written against
    # PQConfig can treat the sharded queue as one wide queue
    @property
    def a_max(self) -> int:
        return self.a_total

    @property
    def r_max(self) -> int:
        return self.a_total


def _sharded_cfg(width: int, n_lanes: int, *, base: PQConfig,
                 slack: float = 1.0, min_lanes: Optional[int] = None,
                 preroute: str = "adaptive") -> ShardedPQConfig:
    """Scale a width-``width`` single-queue config down to L lanes:
    per-lane batch ceil(slack * width / L) (at least ceil(width /
    min_lanes), clamped to [8, width]), sequential part 2 * per + 2,
    bucket_cap / L.  ``min_lanes`` sizes the quotas for a queue that may
    fold down to that many lanes."""
    eff = n_lanes if min_lanes is None else min_lanes
    if not (1 <= eff <= n_lanes):
        raise ValueError("min_lanes must be in [1, n_lanes]")
    per = max(8, min(width, max(int(-(-slack * width // n_lanes)),
                                -(-width // eff))))
    lane = dataclasses.replace(
        base,
        a_max=per, r_max=per,
        seq_cap=2 * per + 2,
        bucket_cap=max(base.bucket_cap // n_lanes, 8),
    )
    return ShardedPQConfig(lane=lane, n_lanes=n_lanes, a_total=width,
                           preroute=preroute)


class ShardedState(NamedTuple):
    lanes: pqueue.PQState      # every leaf has lead dim L
    rng: torch.Tensor          # [2] i64 (seed, resample count): the router's
                               # generator state
    route: torch.Tensor        # [a_total] i32 current lane of each slot
    route_inv: torch.Tensor    # [a_total] i32 stable argsort of route: the
                               # slots grouped by lane, refreshed with route
    tick_idx: torch.Tensor     # i32 (drives re-sticking and probes)
    n_router_dropped: torch.Tensor  # i32 adds dropped on lane-quota overflow
    elim_ema: torch.Tensor     # f32 EMA of the pre-route pass's hit rate
    balance_ema: torch.Tensor  # f32 EMA of min/max(n_adds, rm)
    disp_ema: torch.Tensor     # f32 EMA of add-batch key dispersion
    n_preroute_elim: torch.Tensor   # i32 pairs eliminated before routing
    n_preroute_ticks: torch.Tensor  # i32 ticks where the pass ran


class ShardedTickResult(NamedTuple):
    """Compacted removal stream of width max(a_total, L * lane.r_max)."""

    rm_keys: torch.Tensor      # [out_w] f32, INF where unserved
    rm_vals: torch.Tensor      # [out_w] i32
    rm_served: torch.Tensor    # [out_w] bool


def _stack_init(cfg: ShardedPQConfig, device) -> pqueue.PQState:
    one = pqueue.init(cfg.lane, device)
    return pqueue.tree_map(
        lambda x: x.expand((cfg.n_lanes,) + x.shape).clone(), one)


def init(cfg: ShardedPQConfig, *, seed: int = 0,
         device="cuda") -> ShardedState:
    """An empty queue.  The route is a placeholder: tick 0 always
    resamples before routing anything."""
    def full(value, dtype):
        return torch.full((), value, dtype=dtype, device=device)

    return ShardedState(
        lanes=_stack_init(cfg, device),
        rng=torch.tensor([seed, 0], dtype=_I64, device=device),
        route=torch.zeros((cfg.a_total,), dtype=_I32, device=device),
        route_inv=torch.arange(cfg.a_total, dtype=_I32, device=device),
        tick_idx=full(0, _I32),
        n_router_dropped=full(0, _I32),
        # the pass runs until measured useless (tick 0 is a probe tick)
        elim_ema=full(1.0, _F32),
        balance_ema=full(0.0, _F32),
        # neutral start inside the workload controller's dead band
        disp_ema=full(0.27, _F32),
        n_preroute_elim=full(0, _I32),
        n_preroute_ticks=full(0, _I32),
    )


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _fresh_route(seed: int, count: int, w: int, n_lanes: int,
                 device) -> torch.Tensor:
    """Permuted round-robin lane map, drawn from the generator state
    (seed, count): balanced by construction (a lane holds at most
    ceil(w / L) slots)."""
    mixed = np.random.SeedSequence([seed % (1 << 63), count]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed) >> 1)
    perm = torch.randperm(w, generator=gen, device=device)
    return (torch.arange(w, dtype=_I32, device=device) % n_lanes)[perm]


def _with_route(route, device):
    """(route, route_inv) on ``device`` from a tensor, numpy array or
    list of lane ids; route_inv is the stable argsort of route."""
    route = pqueue._as_tensor(route, _I32, device)
    return route, torch.argsort(route, stable=True).to(_I32)


def _injected_route(route, w: int, n_lanes: int, device) -> torch.Tensor:
    """A caller's route on ``device``, checked to permute the balanced
    pattern ``arange(w) % n_lanes``: the router's static lane windows
    and quotas hold only for such a route."""
    route = pqueue._as_tensor(route, _I32, device)
    balanced = torch.arange(w, dtype=_I32, device=device) % n_lanes
    if route.shape != balanced.shape or not torch.equal(
            torch.sort(route).values, balanced.sort().values):
        raise ValueError(f"route must permute arange({w}) % {n_lanes}")
    return route


def _route_adds(cfg: ShardedPQConfig, route, add_keys, add_vals, add_mask):
    """The reference router: distribute the add batch to per-lane
    [L, a_lane] arrays in slot order by one stable argsort on lane id.
    Adds past a lane's a_max quota are dropped and counted.  Returns
    (keys, vals, taken, n_dropped)."""
    L, al = cfg.n_lanes, cfg.lane.a_max
    w = add_keys.shape[0]
    lane_of = torch.where(add_mask, route, L)      # masked -> past the end
    order = torch.argsort(lane_of, stable=True)
    sl = lane_of[order]
    sk = add_keys[order]
    sv = add_vals[order]
    lanes = arange_i32(L, add_keys)
    seg_start = kops.searchsorted_last(sl, lanes, side="left")
    seg_len = kops.searchsorted_last(sl, lanes, side="right") - seg_start
    slot = arange_i32(al, add_keys)[None, :]
    taken = slot < seg_len.clamp(max=al)[:, None]
    src = (seg_start[:, None] + slot).clamp(0, w - 1).long()
    lk = torch.where(taken, sk[src], INF)
    lv = torch.where(taken, sv[src], EMPTY_VAL)
    n_in = add_mask.sum(dtype=_I32)
    return lk, lv, taken, n_in - taken.sum(dtype=_I32)


def _route_geometry(w: int, n_lanes: int, device):
    """Static segment geometry of the balanced pattern ``arange(w) % L``
    (lane l holds q + (l < r) slots, q, r = divmod(w, L)): per-lane
    window indices into ``route_inv`` ([L, smax]) and the mask of slots
    past each lane's segment length.  Built on the device, with no copy
    from the host."""
    q, r = divmod(w, n_lanes)
    lane = torch.arange(n_lanes, dtype=_I32, device=device)[:, None]
    col = torch.arange(q + (r > 0), dtype=_I32, device=device)[None, :]
    idx = lane * q + lane.clamp(max=r) + col
    pad = col >= q + (lane < r).to(_I32)
    return idx, pad


def _route_counts(cfg: ShardedPQConfig, route_inv, add_mask):
    """[L] live adds per lane under the current route."""
    w = add_mask.shape[0]
    idx, pad = _route_geometry(w, cfg.n_lanes, add_mask.device)
    src = route_inv[idx.clamp(0, w - 1).long()]
    live = ~pad & add_mask[src.long()]
    return live.sum(-1, dtype=_I32)


def _route_adds_sorted(cfg: ShardedPQConfig, route_inv, add_keys,
                       add_vals, add_mask, rows=None):
    """Router and per-lane sort: each lane's slots sit contiguously in
    ``route_inv`` in static windows (the route permutes the balanced
    pattern), so routing is one gather; one stable row co-sort of the
    [L, smax] windows (``kops.sort_kvf`` under the lane config's backend:
    K2 for "cuda") then key-sorts every lane, ties in slot order.  The
    sort orders keys by the u32 map and returns their f32 bits, as the
    reference's ``lax.sort`` on ``_to_sortable_u32`` does.  Returns
    per-lane [L, a_lane] (keys, vals, taken prefix, n_dropped).

    ``rows=(lane_lo, n_rows)`` routes and sorts only the window of
    ``n_rows`` lanes from ``lane_lo`` (one mesh position's lanes of the
    distributed queue); each row equals the full call's row."""
    L, al = cfg.n_lanes, cfg.lane.a_max
    w = add_keys.shape[0]
    idx, pad = _route_geometry(w, L, add_keys.device)        # [L, smax]
    if rows is not None:
        lane_lo, n_rows = rows
        idx = idx[lane_lo:lane_lo + n_rows]
        pad = pad[lane_lo:lane_lo + n_rows]
    smax = idx.shape[1]
    src = route_inv[idx.clamp(0, w - 1).long()].long()
    live = ~pad & add_mask[src]
    ck = torch.where(live, add_keys[src].to(_F32), INF)
    cv = torch.where(live, add_vals[src].to(_I32), EMPTY_VAL)
    sk, sv, _ = kops.sort_kvf(ck, cv, torch.zeros_like(cv),
                              backend=kops.resolve_backend(cfg.lane.backend))
    n_lane = live.sum(-1, dtype=_I32)
    if al >= smax:
        lk = torch.nn.functional.pad(sk, (0, al - smax), value=INF)
        lv = torch.nn.functional.pad(sv, (0, al - smax), value=EMPTY_VAL)
        n_drop = torch.zeros((), dtype=_I32, device=add_keys.device)
    else:
        lk, lv = sk[:, :al].contiguous(), sv[:, :al].contiguous()
        n_drop = (n_lane - al).clamp(min=0).sum(dtype=_I32)
    taken = (arange_i32(al, add_keys)[None, :]
             < n_lane.clamp(max=al)[:, None])
    return lk, lv, taken, n_drop


def _alloc_removes(cfg: ShardedPQConfig, lanes: pqueue.PQState, rm_count,
                   incoming=0):
    """c-relaxed min-of-lane-heads allocation of r removes to L lanes
    (see :func:`_alloc_removes_arrays`); ``incoming`` is each lane's
    share of this tick's routed adds, which the tick can serve too."""
    return _alloc_removes_arrays(
        cfg, lanes.seq_len + lanes.par_count, lanes.min_value, rm_count,
        incoming)


def _alloc_removes_arrays(cfg: ShardedPQConfig, sizes_pre, min_value,
                          rm_count, incoming=0, grant_cap=None):
    """Base share r // L per lane, the r % L remainder to the lanes with
    the smallest heads (ties by lane id), each grant clamped to the
    lane's size and ``grant_cap`` ([L], default r_max); the shortfall is
    re-granted once, water-filling lanes in head order."""
    L = sizes_pre.shape[0]
    rl = cfg.lane.r_max
    dev = sizes_pre.device
    if grant_cap is None:
        cap = torch.full((L,), rl, dtype=_I32, device=dev)
    else:
        cap = torch.as_tensor(grant_cap, dtype=_I32, device=dev).clamp(0, rl)
    sizes = (sizes_pre + incoming).to(_I32)
    heads = torch.where(sizes > 0, min_value, INF)
    r = torch.as_tensor(rm_count, dtype=_I32, device=dev)
    base = r // L
    rem = r % L
    # rank by (head, lane id) with one [L, L] compare-all
    i = arange_i32(L, sizes)
    ahead = ((heads[None, :] < heads[:, None])
             | ((heads[None, :] == heads[:, None])
                & (i[None, :] < i[:, None])))
    head_rank = ahead.sum(-1, dtype=_I32)
    want = base + (head_rank < rem).to(_I32)
    grant = torch.minimum(torch.minimum(want, sizes), cap)
    shortfall = r - grant.sum(dtype=_I32)
    # a lane's fill = the shortfall left after all lanes ranked ahead of
    # it took their leftover capacity
    cap_left = torch.minimum(sizes, cap) - grant
    before = torch.where(head_rank[None, :] < head_rank[:, None],
                         cap_left[None, :], 0).sum(-1, dtype=_I32)
    extra = torch.minimum(cap_left, shortfall - before).clamp(min=0)
    return (grant + extra).to(_I32)


# ---------------------------------------------------------------------------
# pre-route elimination and the controller
# ---------------------------------------------------------------------------

def _union_min(lanes: pqueue.PQState) -> torch.Tensor:
    """min-of-lane-heads: the exact minimum of the pre-tick union (-0.0
    below 0.0, as the reference's min)."""
    return kops.amin_f32(lanes.min_value, -1)


def _gate_open(cfg: ShardedPQConfig, state: ShardedState, add_mask,
               rm_count) -> torch.Tensor:
    """The adaptive gate's predicate: the tick can pair, and it is a
    probe tick or both EMAs clear their gates."""
    opportunity = torch.minimum(add_mask.sum(dtype=_I32), rm_count)
    probe = (state.tick_idx % cfg.elim_probe) == 0
    gate = ((state.balance_ema >= cfg.balance_gate)
            & (state.elim_ema >= cfg.elim_gate))
    return (opportunity > 0) & (probe | gate)


def _preroute_eliminate(state: ShardedState, add_keys, add_vals, add_mask,
                        rm_count, run: bool, union_min=None):
    """Queue-level elimination before routing (paper §2.2 scaled to
    lanes), when ``run`` (the gate, decided by the caller): adds with
    ``key <=`` the min-of-lane-heads pair with removes and are served
    directly.  ``union_min`` overrides the bound taken from
    ``state.lanes`` (the distributed queue passes its gathered one).

    Returns (residual (keys, vals, mask) in slot order, residual
    rm_count, matched_keys, matched_vals, n_matched, ran)."""
    w = add_keys.shape[0]
    dev = add_keys.device
    if run:
        if union_min is None:
            union_min = _union_min(state.lanes)
        er = elimination.eliminate_batch_unsorted(
            add_keys, add_vals, add_mask, rm_count, union_min)
        return (add_keys.to(_F32), add_vals.to(_I32), er.residual_mask,
                er.residual_rm, er.matched_keys, er.matched_vals,
                er.n_matched, torch.ones((), dtype=torch.bool, device=dev))
    return (add_keys.to(_F32), add_vals.to(_I32), add_mask,
            torch.as_tensor(rm_count, dtype=_I32, device=dev),
            torch.full((w,), INF, dtype=_F32, device=dev),
            torch.full((w,), EMPTY_VAL, dtype=_I32, device=dev),
            torch.zeros((), dtype=_I32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))


def _dispersion(add_keys, add_mask):
    """``(mean - min) / (max - min)`` of the live add keys, and whether
    the batch is informative (at least two distinct live keys).  The
    mean is a float sum whose order may differ from the reference's."""
    m = add_mask
    n = m.sum(dtype=_I32)
    k = add_keys.to(_F32)
    kmin = kops.amin_f32(torch.where(m, k, INF), -1)
    kmax = torch.where(m, k, -INF).amax()
    mean = torch.where(m, k, 0.0).sum() / n.clamp(min=1).to(_F32)
    spread = kmax - kmin
    disp = (mean - kmin) / torch.where(spread > 0, spread, 1.0)
    return disp, (n >= 2) & (spread > 0)


def _ema(old, x, d: torch.Tensor):
    """``(1 - d) * old + d * x`` in f32 with the sum rounded once: the
    reference's compiled update contracts ``(1 - d) * old`` into a fused
    multiply-add onto ``d * x``.  The float64 sum is exact here (old and
    x lie in [0, 1], d * x is 0 or at least 2**-18 of it), so its one
    rounding to f32 is the multiply-add's."""
    return ((1 - d).double() * old.double() + (d * x).double()).to(_F32)


def _controller_update(cfg: ShardedPQConfig, state: ShardedState,
                       add_keys, add_mask, n_adds, rm_count, n_matched,
                       ran):
    """EMA bookkeeping of the adaptive gate and the workload controller.
    The hit-rate EMA moves when the pass ran and could pair, the balance
    EMA on any tick with ops, the dispersion EMA on informative
    batches."""
    d = torch.full((), cfg.elim_ema_decay, dtype=_F32,
                   device=add_keys.device)
    opportunity = torch.minimum(n_adds, rm_count)
    hit = n_matched.to(_F32) / opportunity.clamp(min=1).to(_F32)
    elim_ema = torch.where(ran & (opportunity > 0),
                           _ema(state.elim_ema, hit, d), state.elim_ema)
    peak = torch.maximum(n_adds, rm_count)
    balance = opportunity.to(_F32) / peak.clamp(min=1).to(_F32)
    balance_ema = torch.where(peak > 0, _ema(state.balance_ema, balance, d),
                              state.balance_ema)
    disp, disp_ok = _dispersion(add_keys, add_mask)
    disp_ema = torch.where(disp_ok, _ema(state.disp_ema, disp, d),
                           state.disp_ema)
    return elim_ema, balance_ema, disp_ema


# ---------------------------------------------------------------------------
# the sharded tick
# ---------------------------------------------------------------------------

def _run_repairs(lane_cfg, mid, repairs):
    """Run each (pred, repair) whose [L] predicate holds in any lane;
    every predicate is read in one host sync.  A repair selects its lanes
    itself, so the others keep their state bit for bit."""
    fire = torch.stack([pred.any() for pred, _ in repairs]).tolist()
    for on, (_, repair) in zip(fire, repairs):
        if on:
            mid = repair(lane_cfg, mid)
    return mid


def _lanes_tick(lane_cfg: PQConfig, lanes: pqueue.PQState, lk, lv, lm,
                grants):
    """Lane-major tick of L stacked lanes on the router's output (each
    lane's adds key-sorted with a prefix mask): returns (lanes,
    TickResult, [L] serves per lane).

    "torch": the head over [L, ...] lanes, then combine and scatter each
    behind an any-lane host branch, nested under one outer "anything to
    do?" branch, then the predicates and the four repairs behind
    any-lane branches — the reference's hoisted ``lax.cond`` chain.
    "cuda": :func:`_lanes_tick_fused`."""
    if lane_cfg.backend == "cuda":
        return _lanes_tick_fused(lane_cfg, lanes, lk, lv, lm, grants)
    mid = pqueue._tick_head(lane_cfg, lanes, lk, lv, lm, grants,
                            adds_sorted=True)
    p = mid.pending
    # a sound superset of every pass: chopHead needs new_len > 0 (so a
    # combine), a rebalance a scatter, a moveHead removes past the
    # eliminated prefix and a nonempty parallel part
    may_move = ((mid.rm_count - mid.n_imm > 0)
                & (mid.par.par_count + mid.n_par_adds > 0))
    active, combine = torch.stack(
        [(p.need_combine | p.need_scatter | may_move).any(),
         p.need_combine.any()]).tolist()
    if active:
        if combine:
            mid = pqueue._pass_combine(lane_cfg, mid)
        # the combine may raise need_scatter (a spill): read it after
        if bool(mid.pending.need_scatter.any()):
            mid = pqueue._pass_scatter(lane_cfg, mid)
        mid = pqueue._tick_preds(lane_cfg, mid)
        p = mid.pending
        mid = _run_repairs(lane_cfg, mid, (
            (p.need_rebal & p.need_move, pqueue._repair_rebal_move),
            (p.need_rebal & ~p.need_move, pqueue._repair_rebalance),
            (p.need_move & ~p.need_rebal, pqueue._repair_move),
            (p.need_chop, pqueue._repair_chop),
        ))
    else:
        mid = pqueue._tick_preds(lane_cfg, mid)
    state, res = pqueue._tick_finish(lane_cfg, mid)
    # the removed stream is a dense prefix per lane
    return state, res, mid.pending.move_off + mid.n_rm_par


def _lanes_tick_fused(lane_cfg, lanes, lk, lv, lm, grants):
    """The "cuda" form of :func:`_lanes_tick`: the hot pipeline of every
    lane (head through the moveHead repair) is one launch of the
    lane-tick kernel, then the three rare repairs behind any-lane host
    branches and the finish."""
    from repro_torch.kernels import lane_tick   # lazy: import cycle
    lanes = pqueue.tree_map(lambda x: x.contiguous(), lanes)
    mid = lane_tick.fused_tick_mid(lane_cfg, lanes, lk, lv, lm, grants,
                                   adds_sorted=True)
    p = mid.pending
    mid = _run_repairs(lane_cfg, mid, (
        (p.need_rebal & p.need_move, pqueue._repair_rebal_move),
        (p.need_rebal & ~p.need_move, pqueue._repair_rebalance),
        (p.need_chop, pqueue._repair_chop),
    ))
    state, res = pqueue._tick_finish(lane_cfg, mid)
    return state, res, mid.pending.move_off + mid.n_rm_par


def _tick_impl(cfg: ShardedPQConfig, state: ShardedState, add_keys,
               add_vals, add_mask, rm_count, route=None
               ) -> Tuple[ShardedState, ShardedTickResult]:
    L = cfg.n_lanes
    w = add_keys.shape[0]
    rl = cfg.lane.r_max
    dev = add_keys.device
    out_w = max(w, L * rl)
    # pre-route matches can serve on top of the lanes' L * r_max grants,
    # so the request is clamped to the stream width up front
    rm_count = rm_count.clamp(max=out_w)
    n_adds_in = add_mask.sum(dtype=_I32)

    # one host read: the tick index (resample), the generator state and,
    # under the adaptive gate, whether the pre-route pass runs
    host = [state.tick_idx.reshape(1), state.rng]
    if cfg.preroute == "adaptive":
        host.append(_gate_open(cfg, state, add_mask, rm_count).reshape(1))
    tick_idx, seed, count, *gate = torch.cat(
        [x.to(_I64) for x in host]).tolist()
    run = bool(gate[0]) if gate else cfg.preroute == "on"
    resample = tick_idx % cfg.stick == 0

    # -- pre-route elimination; the controller reads the raw batch --
    raw_keys, raw_mask = add_keys, add_mask
    (add_keys, add_vals, add_mask, rm_residual, matched_k, matched_v,
     n_matched, elim_ran) = _preroute_eliminate(
        state, add_keys, add_vals, add_mask, rm_count, run)
    elim_ema, balance_ema, disp_ema = _controller_update(
        cfg, state, raw_keys, raw_mask, n_adds_in, rm_count, n_matched,
        elim_ran)

    # -- stick-random router refresh: the generator advances only on a
    # resample tick --
    rng, route_now, route_inv = state.rng, state.route, state.route_inv
    if resample:
        if route is None:
            route = _fresh_route(seed, count, w, L, dev)
        else:
            route = _injected_route(route, w, L, dev)
        route_now, route_inv = _with_route(route, dev)
        rng = torch.stack([state.rng[0], state.rng[1] + 1])

    # -- lane work: a tick with no residual adds, no grants and no lane
    # due for chopHead skips routing, grants and the lane ticks (bit-exact:
    # such a lane tick only counts a quiet tick) --
    lc = cfg.lane
    grants0 = _alloc_removes(cfg, state.lanes, rm_residual, incoming=0)
    quiet1 = state.lanes.quiet_ticks + 1
    any_chop = ((quiet1 >= lc.chop_patience)
                & (state.lanes.seq_len > 0)).any()
    lane_work = ((add_mask.sum(dtype=_I32) > 0)
                 | (grants0.sum(dtype=_I32) > 0) | any_chop)
    if bool(lane_work):
        lk, lv, lm, n_drop = _route_adds_sorted(cfg, route_inv, add_keys,
                                                add_vals, add_mask)
        grants = _alloc_removes(cfg, state.lanes, rm_residual,
                                incoming=lm.sum(-1, dtype=_I32))
        lanes, res, n_lane = _lanes_tick(lc, state.lanes, lk, lv, lm,
                                         grants)
        res_k, res_v = res.rm_keys, res.rm_vals
    else:
        st = state.lanes.stats
        lanes = state.lanes._replace(
            quiet_ticks=quiet1, stats=st._replace(n_ticks=st.n_ticks + 1))
        res_k = torch.full((L, rl), INF, dtype=_F32, device=dev)
        res_v = torch.full((L, rl), EMPTY_VAL, dtype=_I32, device=dev)
        n_lane = torch.zeros((L,), dtype=_I32, device=dev)
        n_drop = torch.zeros((), dtype=_I32, device=dev)

    result = _fold_results(n_matched, matched_k, matched_v, res_k, res_v,
                           n_lane)
    new_state = ShardedState(
        lanes=lanes,
        rng=rng,
        route=route_now,
        route_inv=route_inv,
        tick_idx=state.tick_idx + 1,
        n_router_dropped=state.n_router_dropped + n_drop,
        elim_ema=elim_ema,
        balance_ema=balance_ema,
        disp_ema=disp_ema,
        n_preroute_elim=state.n_preroute_elim + n_matched,
        n_preroute_ticks=state.n_preroute_ticks + elim_ran.to(_I32),
    )
    return new_state, result


def _fold_results(n_matched, matched_k, matched_v, res_k, res_v,
                  n_lane) -> ShardedTickResult:
    """Fold per-lane serves into one compacted stream [pre-route matched
    | lane serves] (a near-min set, not an order).  Every lane serves a
    prefix of its result row, so compaction is ragged-segment arithmetic
    over the [L] lane counts."""
    L, rl = res_k.shape
    w = matched_k.shape[0]
    out_w = max(w, L * rl)
    cum = torch.cumsum(n_lane, 0, dtype=_I32)
    offs = cum - n_lane
    n_served = cum[L - 1]
    j = arange_i32(out_w, res_k)
    jl = j - n_matched                     # rank within the lane segment
    row = kops.searchsorted_last(cum, jl.clamp(min=0),
                                 side="right").clamp(0, L - 1).long()
    col = (jl - offs[row]).clamp(0, rl - 1)
    got_lane = (jl >= 0) & (jl < n_served)
    in_matched = j < n_matched
    flat = (row * rl + col).long()
    src = j.clamp(0, w - 1).long()
    rm_keys = torch.where(
        in_matched, matched_k[src],
        torch.where(got_lane, res_k.reshape(-1)[flat], INF))
    rm_vals = torch.where(
        in_matched, matched_v[src],
        torch.where(got_lane, res_v.reshape(-1)[flat], EMPTY_VAL))
    return ShardedTickResult(rm_keys, rm_vals, in_matched | got_lane)


def _device(state: ShardedState) -> torch.device:
    return state.route.device


def tick(cfg: ShardedPQConfig, state: ShardedState, add_keys, add_vals,
         add_mask, rm_count, *, route=None
         ) -> Tuple[ShardedState, ShardedTickResult]:
    """One synchronized round over all lanes (route -> lane-major tick ->
    fold).

    add_keys / add_vals / add_mask: [a_total] un-sharded op batch;
    rm_count: scalar.  The batch may be tensors, numpy arrays or Python
    values; it moves to the state's device.  ``state`` is left unchanged.
    ``route`` ([a_total] lane ids, a permutation of ``arange(a_total) %
    L``) replaces the generator's draw if this tick resamples.  Returns
    up to rm_count near-minimal (key, val) pairs in a
    [max(a_total, L * lane.r_max)]-wide result."""
    batch = pqueue._as_batch(_device(state), add_keys, add_vals, add_mask,
                             rm_count)
    return _tick_impl(cfg, state, *batch, route=route)


def tick_n(cfg: ShardedPQConfig, state: ShardedState, add_keys, add_vals,
           add_mask, rm_counts) -> Tuple[ShardedState, ShardedTickResult]:
    """T ticks in a row over [T, ...]-stacked batches.  Returns (final
    state, ShardedTickResult stacked [T, ...])."""
    aks, avs, ams, rms = pqueue._as_batch(_device(state), add_keys,
                                          add_vals, add_mask, rm_counts)
    results = []
    for t in range(aks.shape[0]):
        state, res = _tick_impl(cfg, state, aks[t], avs[t], ams[t], rms[t])
        results.append(res)
    return state, ShardedTickResult(*(torch.stack(xs)
                                      for xs in zip(*results)))


# ---------------------------------------------------------------------------
# introspection helpers
# ---------------------------------------------------------------------------

class ShardedStats(NamedTuple):
    """The queue's counters: the per-lane PQStats summed over lanes, and
    what no lane sees (the pre-route pass, the router, the controller's
    signals, depth and the union head)."""

    lane: pqueue.PQStats            # per-lane counters summed over L
    n_preroute_elim: torch.Tensor   # pairs matched before routing
    n_preroute_ticks: torch.Tensor  # ticks where the pre-route pass ran
    n_router_dropped: torch.Tensor
    n_ticks: torch.Tensor           # sharded ticks (== tick_idx)
    elim_ema: torch.Tensor          # controller signals, as of now
    balance_ema: torch.Tensor
    disp_ema: torch.Tensor          # add-batch key-dispersion EMA
    depth: torch.Tensor             # total resident elements (== size())
    min_head: torch.Tensor          # union min of lane heads (INF if empty)


def stats(state: ShardedState) -> ShardedStats:
    """Aggregate the queue's counters (lane reduction + queue level)."""
    return ShardedStats(
        lane=pqueue.tree_map(lambda x: x.sum(0, dtype=_I32),
                             state.lanes.stats),
        n_preroute_elim=state.n_preroute_elim,
        n_preroute_ticks=state.n_preroute_ticks,
        n_router_dropped=state.n_router_dropped,
        n_ticks=state.tick_idx,
        elim_ema=state.elim_ema,
        balance_ema=state.balance_ema,
        disp_ema=state.disp_ema,
        depth=size(state),
        min_head=_union_min(state.lanes),
    )


def size(state: ShardedState) -> torch.Tensor:
    return lane_sizes(state).sum(dtype=_I32)


def lane_sizes(state: ShardedState) -> torch.Tensor:
    return state.lanes.seq_len + state.lanes.par_count


def lane_work_marks(state: ShardedState) -> int:
    """The sum of the lane counters that only a tick with lane work
    moves: adds reaching a lane, removes granted to one, chopHeads.  A
    tick without lane work only counts a quiet tick in each lane, so the
    sum grows exactly on the ticks that run the lane pipeline (a host
    read)."""
    st = state.lanes.stats
    return int((st.add_imm_elim + st.add_upc_elim + st.add_seq + st.add_par
                + st.n_removes + st.n_chophead).sum())


def relax_bound(cfg: ShardedPQConfig, rm_count: int) -> int:
    """The c of the c-relaxed contract: every key removed by a tick of r
    removes lies within the c smallest of the union (pre-tick contents +
    that tick's adds), c = r + L * ceil(r / L) + 2 * L * lane.a_max; the
    even-split displacement by the other lanes' prefixes plus a lane's
    local elimination against a head that trails the union minimum.
    L = 1 is exact (c = r)."""
    r = int(rm_count)
    if cfg.n_lanes == 1:
        return r
    return (r + cfg.n_lanes * (-(-r // cfg.n_lanes))
            + 2 * cfg.n_lanes * cfg.lane.a_max)


# ---------------------------------------------------------------------------
# elastic lane count (fold / unfold, host-level)
# ---------------------------------------------------------------------------

def resident(cfg: ShardedPQConfig, lanes: pqueue.PQState):
    """Every resident element of the stacked lanes: ``(keys [L, cap],
    vals [L, cap], live [L, cap])`` with cap = seq_cap + par_cap (the
    sequential part's dense prefix, then every finite bucket slot)."""
    lc = cfg.lane
    n = lanes.buckets.shape[0]
    live_seq = (arange_i32(lc.seq_cap, lanes.seq_keys)[None, :]
                < lanes.seq_len[:, None])
    bk = lanes.buckets.reshape(n, -1)
    bv = lanes.bvals.reshape(n, -1)
    keys = torch.cat([lanes.seq_keys, bk], dim=-1)
    vals = torch.cat([lanes.seq_vals, bv], dim=-1)
    live = torch.cat([live_seq, torch.isfinite(bk)], dim=-1)
    return keys, vals, live


def _redraw(cfg: ShardedPQConfig, state: ShardedState, n_lanes: int,
            route):
    """The control plane re-derived for ``n_lanes`` lanes as a resample
    tick would: one generator step and a fresh route (or ``route``) with
    its inverse.  Returns (rng, route, route_inv)."""
    dev = _device(state)
    seed, count = state.rng.tolist()
    if route is None:
        route = _fresh_route(seed, count, cfg.a_total, n_lanes, dev)
    else:
        route = _injected_route(route, cfg.a_total, n_lanes, dev)
    route, route_inv = _with_route(route, dev)
    return (torch.tensor([seed, count + 1], dtype=_I64, device=dev), route,
            route_inv)


def fold_lanes(cfg: ShardedPQConfig, state: ShardedState, keep, *,
               route=None):
    """Shrink the queue to the ``keep`` lanes (an ordered list of lane
    indices).  Surviving lanes' rows carry over bit for bit; the dropped
    lanes' resident elements are drained into flat (keys, vals) numpy
    arrays for the caller to re-add through ordinary ticks; the control
    plane is re-derived for the new L (``route`` replaces the draw);
    counters and EMAs carry over.  Returns (new_cfg, new_state,
    drained_keys, drained_vals)."""
    keep = [int(i) for i in keep]
    L = cfg.n_lanes
    if sorted(set(keep)) != sorted(keep) or not keep:
        raise ValueError("keep must be a nonempty list of distinct lanes")
    if any(i < 0 or i >= L for i in keep):
        raise ValueError(f"keep out of range for L={L}")
    drop = [i for i in range(L) if i not in keep]
    new_cfg = dataclasses.replace(cfg, n_lanes=len(keep))

    keys, vals, live = (x.cpu().numpy() for x in resident(cfg, state.lanes))
    dmask = live[drop]
    drained_keys = keys[drop][dmask].astype(np.float32)
    drained_vals = vals[drop][dmask].astype(np.int32)
    sizes = lane_sizes(state).cpu().numpy()
    want = int(sizes[drop].sum())
    assert len(drained_keys) == want, (
        f"drain miscount: enumerated {len(drained_keys)}, lanes report "
        f"{want} — bucket invariant violated")

    idx = torch.tensor(keep, dtype=_I64, device=_device(state))
    rng, route, route_inv = _redraw(cfg, state, len(keep), route)
    new_state = state._replace(
        lanes=pqueue.tree_map(lambda x: x[idx], state.lanes),
        rng=rng, route=route, route_inv=route_inv)
    return new_cfg, new_state, drained_keys, drained_vals


def unfold_lanes(cfg: ShardedPQConfig, state: ShardedState, n_lanes: int,
                 *, route=None):
    """Grow the queue to ``n_lanes`` by appending empty lanes; existing
    lanes carry bit for bit and the control plane is re-derived as in
    :func:`fold_lanes`.  Returns (new_cfg, new_state)."""
    L = cfg.n_lanes
    if n_lanes < L:
        raise ValueError("unfold_lanes cannot shrink; use fold_lanes")
    new_cfg = dataclasses.replace(cfg, n_lanes=n_lanes)
    if n_lanes == L:
        return new_cfg, state
    fresh = _stack_init(dataclasses.replace(cfg, n_lanes=n_lanes - L),
                        _device(state))
    n = len(pqueue.PQState._fields) - 1
    cat = [torch.cat([a, b]) for a, b in zip(
        pqueue.tree_leaves(state.lanes), pqueue.tree_leaves(fresh))]
    lanes = pqueue.PQState(*cat[:n], stats=pqueue.PQStats(*cat[n:]))
    rng, route, route_inv = _redraw(cfg, state, n_lanes, route)
    return new_cfg, state._replace(lanes=lanes, rng=rng, route=route,
                                   route_inv=route_inv)
