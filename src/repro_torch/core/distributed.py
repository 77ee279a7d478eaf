"""Lanes-over-devices sharded priority queue (PyTorch port of the JAX
package's ``core/distributed.py``).

The L lanes of one :class:`~repro_torch.core.sharded.ShardedPQConfig`
are placed over a mesh of D positions, l = L / D lanes each, and one
tick runs the synchronized round of the single-device queue split into
two planes:

* **the control plane** (the router's generator state, route and stable
  inverse, the pre-route elimination pass and its EMAs, the grant
  allocation, the counters) is O(W) / O(L) math computed once, on the
  control device (the first position's);
* **the data plane** is each position's own [l]-stacked ``PQState`` on
  its own device, and the per-lane work on it: routing and sorting the
  position's windows of the batch (K2 under the "cuda" backend) and the
  lanes' tick (K3 with grid l).

The mesh is an ordered list of ``torch.device`` s, driven by one process,
as the reference's one program drives its devices through ``shard_map``;
a device may appear more than once (two positions on one card).  The
tick's only cross-position traffic is :func:`_all_gather`: every
position's [l] heads and sizes, concatenated on the control device (the
reference's two ``all_gather`` s).  The batch, the route's inverse and a
position's grants are copied to a position on another device; its
served rows come back.

Because every per-lane computation equals the single-device queue's, a
dist queue of D positions of l lanes serves the same stream as
``sharded`` with L = D * l lanes on the same ops, bit for bit, when both
draw the same routes: the route is drawn by ``sharded._fresh_route`` from
the same generator state, on the control device.  Each position skips
its lanes' pipeline on its own predicate (adds routed to its lanes,
grants, a lane due for chopHead); a skipped lane only counts a quiet
tick, which is what running it would have done.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pqueue
from repro_torch.core import sharded as shq
from repro_torch.core.config import EMPTY_VAL, PQConfig
from repro_torch.core.factory import _check_device
from repro_torch.core.sharded import ShardedPQConfig, ShardedState
from repro_torch.kernels import ops as kops

INF = float("inf")
_I32 = torch.int32
_I64 = torch.int64
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DistShardedPQConfig:
    """Static config of the lanes-over-devices queue.  ``shard`` is the
    single-device-equivalent config: its ``n_lanes`` is the total L =
    n_devices * lanes_per_device, and its ``a_total`` the un-sharded
    op-batch width."""

    shard: ShardedPQConfig
    n_devices: int

    def __post_init__(self) -> None:
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if self.shard.n_lanes % self.n_devices:
            raise ValueError(
                f"n_lanes ({self.shard.n_lanes}) must divide evenly "
                f"across n_devices ({self.n_devices})")

    @property
    def lanes_per_device(self) -> int:
        return self.shard.n_lanes // self.n_devices

    # batch geometry, as ShardedPQConfig spells it
    @property
    def a_max(self) -> int:
        return self.shard.a_total

    @property
    def r_max(self) -> int:
        return self.shard.a_total


def _dist_cfg(width: int, n_devices: int, lanes_per_device: int, *,
              base: PQConfig, slack: float = 1.0, spare_devices: int = 0,
              preroute: str = "adaptive") -> DistShardedPQConfig:
    """Scale a width-``width`` single-queue config onto D positions: the
    per-lane geometry of ``sharded._sharded_cfg`` at L = D * l, with lane
    quotas sized as if only ``n_devices - spare_devices`` positions
    carried the batch, so the queue can lose that many positions and
    still route a full batch without a drop."""
    if not 0 <= spare_devices < n_devices:
        raise ValueError("spare_devices must be in [0, n_devices)")
    scfg = shq._sharded_cfg(
        width, n_devices * lanes_per_device, base=base, slack=slack,
        min_lanes=(n_devices - spare_devices) * lanes_per_device,
        preroute=preroute)
    return DistShardedPQConfig(shard=scfg, n_devices=n_devices)


class DistState(NamedTuple):
    """The queue on a mesh: the fields of ``ShardedState``, with ``lanes``
    split into one [l]-stacked ``PQState`` per position, each on its
    position's device; every other field lives on the control device."""

    lanes: Tuple[pqueue.PQState, ...]
    rng: torch.Tensor
    route: torch.Tensor
    route_inv: torch.Tensor
    tick_idx: torch.Tensor
    n_router_dropped: torch.Tensor
    elim_ema: torch.Tensor
    balance_ema: torch.Tensor
    disp_ema: torch.Tensor
    n_preroute_elim: torch.Tensor
    n_preroute_ticks: torch.Tensor


def default_mesh(cfg: DistShardedPQConfig, device="cuda") -> List[torch.device]:
    """D positions: all on the CPU for a CPU ``device``; else the first D
    cards from ``device``'s index."""
    device = torch.device(device)
    n = cfg.n_devices
    if device.type == "cpu":
        return [device] * n
    if device.type != "cuda":
        raise ValueError(f"no default mesh on {device}")
    first = device.index or 0
    have = torch.cuda.device_count()
    if first + n > have:
        raise ValueError(
            f"need {n} cuda devices from cuda:{first}, have {have}; pass "
            "mesh=[...] to place the positions (a device may repeat)")
    return [torch.device("cuda", first + i) for i in range(n)]


def _cat_lanes(parts: Sequence[pqueue.PQState], device) -> pqueue.PQState:
    n = len(pqueue.PQState._fields) - 1
    cat = [torch.cat([x.to(device) for x in xs])
           for xs in zip(*(pqueue.tree_leaves(p) for p in parts))]
    return pqueue.PQState(*cat[:n], stats=pqueue.PQStats(*cat[n:]))


def scatter(cfg: DistShardedPQConfig, mesh: Sequence[torch.device],
            state: ShardedState) -> DistState:
    """Place a single-device state on ``mesh``: position p takes lanes
    [p * l, (p + 1) * l) on ``mesh[p]``; the control plane goes to
    ``mesh[0]``."""
    l = cfg.lanes_per_device
    parts = tuple(
        pqueue.tree_map(lambda x, p=p, d=d: x[p * l:(p + 1) * l].to(
            d, copy=True), state.lanes)
        for p, d in enumerate(mesh))
    rest = {f: getattr(state, f).to(mesh[0]) for f in ShardedState._fields
            if f != "lanes"}
    return DistState(lanes=parts, **rest)


def gather(state: DistState) -> ShardedState:
    """The single-device state on the control device: the positions'
    lanes concatenated in position order."""
    ctl = state.route.device
    return ShardedState(lanes=_cat_lanes(state.lanes, ctl),
                        **{f: getattr(state, f) for f in DistState._fields
                           if f != "lanes"})


def init(cfg: DistShardedPQConfig, mesh: Sequence[torch.device], *,
         seed: int = 0) -> DistState:
    """An empty queue on ``mesh``: ``sharded.init(cfg.shard, seed=seed)``,
    placed."""
    return scatter(cfg, mesh, shq.init(cfg.shard, seed=seed,
                                       device=mesh[0]))


# ---------------------------------------------------------------------------
# the tick
# ---------------------------------------------------------------------------

def _all_gather(parts: Sequence[pqueue.PQState], device):
    """The tick's only cross-position traffic: every position's [l] lane
    heads and sizes, concatenated in position order on ``device`` (the
    replicated [L] vectors behind the union bound and the grants)."""
    min_v = torch.cat([p.min_value.to(device) for p in parts])
    sizes = torch.cat([(p.seq_len + p.par_count).to(device) for p in parts])
    return min_v, sizes


def _position_tick(scfg: ShardedPQConfig, part: pqueue.PQState, route_inv,
                   add_keys, add_vals, add_mask, grants, lane_lo: int,
                   n_local: int):
    """One position's lane work on its own device: route and sort its
    lanes' windows of the batch (K2 under "cuda"), then tick its lanes
    (K3 with grid l).  Returns (lanes, served keys [l, r], served vals,
    [l] serves per lane)."""
    dev = part.seq_len.device
    lk, lv, lm, _ = shq._route_adds_sorted(
        scfg, route_inv.to(dev), add_keys.to(dev), add_vals.to(dev),
        add_mask.to(dev), rows=(lane_lo, n_local))
    lanes, res, n_lane = shq._lanes_tick(scfg.lane, part, lk, lv, lm,
                                         grants.to(dev))
    return lanes, res.rm_keys, res.rm_vals, n_lane


def _position_skip(lc: PQConfig, part: pqueue.PQState):
    """A position without lane work: each lane counts a quiet tick."""
    n, dev = part.seq_len.shape[0], part.seq_len.device
    st = part.stats
    lanes = part._replace(quiet_ticks=part.quiet_ticks + 1,
                          stats=st._replace(n_ticks=st.n_ticks + 1))
    return (lanes,
            torch.full((n, lc.r_max), INF, dtype=_F32, device=dev),
            torch.full((n, lc.r_max), EMPTY_VAL, dtype=_I32, device=dev),
            torch.zeros((n,), dtype=_I32, device=dev))


def _tick_impl(cfg: DistShardedPQConfig, state: DistState, add_keys,
               add_vals, add_mask, rm_count, lane_scale, route=None):
    """One round; the batch, ``rm_count`` and ``lane_scale`` lie on the
    control device.  Returns (state, ShardedTickResult, [D] whether each
    position ran its lanes' pipeline).  Mirrors ``sharded._tick_impl``
    stage by stage."""
    scfg, n_local = cfg.shard, cfg.lanes_per_device
    L, lc = scfg.n_lanes, scfg.lane
    rl = lc.r_max
    w = add_keys.shape[0]
    dev = add_keys.device
    rm_count = rm_count.clamp(max=max(w, L * rl))
    # the degraded-mode throttle: each lane's grant cap ceil(scale * r_max)
    # in f32 (all ones is the unthrottled allocation)
    grant_cap = torch.ceil(lane_scale * rl).to(_I32)
    min_v, sizes_pre = _all_gather(state.lanes, dev)
    union_min = kops.amin_f32(min_v, -1)
    n_adds_in = add_mask.sum(dtype=_I32)

    # one host read: the tick index (resample), the generator state and,
    # under the adaptive gate, whether the pre-route pass runs
    host = [state.tick_idx.reshape(1), state.rng]
    if scfg.preroute == "adaptive":
        host.append(shq._gate_open(scfg, state, add_mask,
                                   rm_count).reshape(1))
    tick_idx, seed, count, *gate = torch.cat(
        [x.to(_I64) for x in host]).tolist()
    run = bool(gate[0]) if gate else scfg.preroute == "on"

    # -- pre-route elimination against the gathered union bound --
    raw_keys, raw_mask = add_keys, add_mask
    (add_keys, add_vals, add_mask, rm_residual, matched_k, matched_v,
     n_matched, elim_ran) = shq._preroute_eliminate(
        state, add_keys, add_vals, add_mask, rm_count, run,
        union_min=union_min)
    elim_ema, balance_ema, disp_ema = shq._controller_update(
        scfg, state, raw_keys, raw_mask, n_adds_in, rm_count, n_matched,
        elim_ran)

    # -- stick-random router refresh, drawn as the single-device queue
    # draws it --
    rng, route_now, route_inv = state.rng, state.route, state.route_inv
    if tick_idx % scfg.stick == 0:
        if route is None:
            route = shq._fresh_route(seed, count, w, L, dev)
        else:
            route = shq._injected_route(route, w, L, dev)
        route_now, route_inv = shq._with_route(route, dev)
        rng = torch.stack([state.rng[0], state.rng[1] + 1])

    # -- the routing summary: live adds per lane feed the grants'
    # ``incoming`` and the drop counter --
    counts = shq._route_counts(scfg, route_inv, add_mask)
    incoming = counts.clamp(max=lc.a_max)
    n_drop = (counts - lc.a_max).clamp(min=0).sum(dtype=_I32)
    grants0 = shq._alloc_removes_arrays(scfg, sizes_pre, min_v, rm_residual,
                                        incoming=0, grant_cap=grant_cap)

    # -- each position's lane-work predicate, all read in one host sync:
    # adds routed to its lanes, grants, or a lane due for chopHead --
    n_pos = len(state.lanes)
    chop = torch.stack([
        ((p.quiet_ticks + 1 >= lc.chop_patience) & (p.seq_len > 0)).any()
        .to(dev) for p in state.lanes])
    work = ((counts.view(n_pos, n_local).sum(-1) > 0)
            | (grants0.view(n_pos, n_local).sum(-1) > 0) | chop).tolist()
    if any(work):
        grants = shq._alloc_removes_arrays(
            scfg, sizes_pre, min_v, rm_residual, incoming=incoming,
            grant_cap=grant_cap)
    outs = []
    for p, part in enumerate(state.lanes):
        lo = p * n_local
        if work[p]:
            outs.append(_position_tick(scfg, part, route_inv, add_keys,
                                       add_vals, add_mask,
                                       grants[lo:lo + n_local], lo,
                                       n_local))
        else:
            outs.append(_position_skip(lc, part))
    lanes, res_k, res_v, n_lane = zip(*outs)

    result = shq._fold_results(
        n_matched, matched_k, matched_v,
        *(torch.cat([x.to(dev) for x in xs]) for xs in (res_k, res_v,
                                                        n_lane)))
    new_state = DistState(
        lanes=tuple(lanes),
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
    return new_state, result, work


def _scale(cfg: DistShardedPQConfig, lane_scale, device) -> torch.Tensor:
    if lane_scale is None:      # all ones: the unthrottled allocation
        return torch.ones((cfg.shard.n_lanes,), dtype=_F32, device=device)
    return pqueue._as_tensor(lane_scale, _F32, device)


def _tick(cfg, state, add_keys, add_vals, add_mask, rm_count, lane_scale,
          route):
    """:func:`_tick_impl` on a batch moved to the control device."""
    dev = state.route.device
    batch = pqueue._as_batch(dev, add_keys, add_vals, add_mask, rm_count)
    return _tick_impl(cfg, state, *batch, _scale(cfg, lane_scale, dev),
                      route=route)


def tick(cfg: DistShardedPQConfig, state: DistState, add_keys, add_vals,
         add_mask, rm_count, lane_scale=None, *, route=None
         ) -> Tuple[DistState, shq.ShardedTickResult]:
    """One synchronized round over the mesh; the signature and result of
    ``sharded.tick`` plus ``lane_scale`` ([L] f32 grant-cap multipliers,
    default all ones).  The batch may be tensors, numpy arrays or Python
    values.  ``state`` is left unchanged; ``route`` replaces the
    generator's draw if this tick resamples."""
    state, res, _ = _tick(cfg, state, add_keys, add_vals, add_mask,
                          rm_count, lane_scale, route)
    return state, res


# ---------------------------------------------------------------------------
# elastic resize (drain a dead position's lanes, remap them over survivors)
# ---------------------------------------------------------------------------

def resize(cfg: DistShardedPQConfig, mesh: Sequence[torch.device],
           state: DistState, drop_device: int):
    """Shrink the mesh by position ``drop_device``: D * l lanes become
    (D - 1) * l.  The dropped position's lanes are drained through
    ``sharded.fold_lanes`` on the control device (the single controller
    reads every position); survivors carry bit for bit and the control
    plane is re-derived for the new L.  Returns (new_cfg, new_mesh,
    new_state, drained_keys, drained_vals); the caller re-adds the
    drained elements (:func:`reinsert`)."""
    if cfg.n_devices < 2:
        raise ValueError("cannot drop the last device")
    if not 0 <= drop_device < cfg.n_devices:
        raise ValueError(f"drop_device {drop_device} out of range")
    lpd = cfg.lanes_per_device
    lo = drop_device * lpd
    keep = [i for i in range(cfg.shard.n_lanes) if not lo <= i < lo + lpd]
    new_scfg, folded, drained_keys, drained_vals = shq.fold_lanes(
        cfg.shard, gather(state), keep)
    new_cfg = DistShardedPQConfig(shard=new_scfg, n_devices=cfg.n_devices - 1)
    new_mesh = [d for p, d in enumerate(mesh) if p != drop_device]
    return (new_cfg, new_mesh, scatter(new_cfg, new_mesh, folded),
            drained_keys, drained_vals)


def reinsert(q: "DistShardedQueue", state: DistState, keys: np.ndarray,
             vals: np.ndarray) -> DistState:
    """Re-add a drained batch through zero-remove ticks, which serve
    nothing: full batch width when the survivors' quotas cover it
    (``spare_devices`` sizing), else ``lane.a_max`` per tick, a chunk no
    lane can overflow on.  Raises if the router dropped any key."""
    scfg = q.cfg.shard
    w = scfg.a_total
    chunk = w if -(-w // scfg.n_lanes) <= scfg.lane.a_max else scfg.lane.a_max
    dropped_pre = int(state.n_router_dropped)
    for i in range(0, len(keys), chunk):
        ck = np.asarray(keys[i:i + chunk], np.float32)
        ak = np.full((w,), np.inf, np.float32)
        av = np.full((w,), EMPTY_VAL, np.int32)
        m = np.zeros((w,), bool)
        ak[:len(ck)] = ck
        av[:len(ck)] = np.asarray(vals[i:i + chunk], np.int32)
        m[:len(ck)] = True
        state, _ = q.tick(state, ak, av, m, 0)
    dropped = int(state.n_router_dropped) - dropped_pre
    if dropped:
        raise AssertionError(
            f"re-insertion dropped {dropped} keys: survivor lane quotas "
            "under-sized (EngineSpec spare_devices) and chunking failed")
    return state


class DistShardedQueue:
    """Lanes-over-devices sharded queue: a config and a mesh; the state
    stays explicit and flows through ``tick``::

        q = make_engine(EngineSpec(engine="dist", width=256, lanes=8,
                                   n_devices=2, lanes_per_device=4),
                        mesh=["cuda:0", "cuda:0"])
        state = q.init(seed=0)
        state, res = q.tick(state, keys, vals, mask, rm_count)

    Results are near-minimal key sets under ``q.relax_bound(rm_count)``
    with L = D * l, as single-device ``sharded``.  ``work_ticks[p]``
    counts the ticks on which position p ran its lanes' pipeline."""

    kind = "dist"

    def __init__(self, cfg: DistShardedPQConfig,
                 mesh: Optional[Sequence] = None, *, device="cuda"):
        mesh = (default_mesh(cfg, device) if mesh is None
                else [torch.device(d) for d in mesh])
        if len(mesh) != cfg.n_devices:
            raise ValueError(f"mesh has {len(mesh)} devices, config wants "
                             f"{cfg.n_devices}")
        for d in mesh:
            _check_device(cfg.shard.lane.backend, d)
        self.cfg = cfg
        self.mesh = mesh
        self.work_ticks = [0] * cfg.n_devices

    @property
    def device(self) -> torch.device:
        """The control device: the first position's."""
        return self.mesh[0]

    @property
    def width(self) -> int:
        return self.cfg.shard.a_total

    def init(self, *, seed: int = 0) -> DistState:
        return init(self.cfg, self.mesh, seed=seed)

    def tick(self, state: DistState, add_keys, add_vals, add_mask, rm_count,
             lane_scale=None, *, route=None):
        state, res, work = _tick(self.cfg, state, add_keys, add_vals,
                                 add_mask, rm_count, lane_scale, route)
        for p, ran in enumerate(work):
            self.work_ticks[p] += ran
        return state, res

    def tick_n(self, state: DistState, add_keys, add_vals, add_mask,
               rm_counts, lane_scale=None):
        """T ticks in a row over [T, ...]-stacked batches.  Returns (final
        state, ShardedTickResult stacked [T, ...])."""
        results = []
        for t in range(len(rm_counts)):
            state, res = self.tick(state, add_keys[t], add_vals[t],
                                   add_mask[t], rm_counts[t], lane_scale)
            results.append(res)
        return state, shq.ShardedTickResult(*(torch.stack(xs)
                                              for xs in zip(*results)))

    def remove_device(self, state: DistState, device: int, *,
                      reinsert_drained: bool = True):
        """Drain-and-remap position ``device``'s lanes over the survivors.
        Returns (a queue over the (D - 1)-position mesh, its state), the
        drained elements re-inserted unless ``reinsert_drained=False``."""
        new_cfg, new_mesh, new_state, dk, dv = resize(self.cfg, self.mesh,
                                                      state, device)
        q2 = DistShardedQueue(new_cfg, new_mesh)
        if reinsert_drained:
            new_state = reinsert(q2, new_state, dk, dv)
        return q2, new_state

    def stats(self, state: DistState) -> shq.ShardedStats:
        return shq.stats(gather(state))

    def resident(self, state: DistState):
        """(keys, vals, live) of every resident element, [L, cap] on the
        control device."""
        return shq.resident(self.cfg.shard, gather(state).lanes)

    def size(self, state: DistState) -> torch.Tensor:
        return self.lane_sizes(state).sum(dtype=_I32)

    def lane_sizes(self, state: DistState) -> torch.Tensor:
        return _all_gather(state.lanes, self.device)[1]

    def relax_bound(self, rm_count: int) -> int:
        return shq.relax_bound(self.cfg.shard, rm_count)
