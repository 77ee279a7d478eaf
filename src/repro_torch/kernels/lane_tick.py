"""The lane-tick kernel: every lane's hot tick in hand-written CUDA.

Per lane, one tick's hot pipeline

    ``_tick_head`` (sanitize / immediate elimination / small-large split)
    -> ``_pass_combine`` (rank merge + consume + spill)
    -> ``_pass_scatter`` (bucket segment-append)
    -> ``_tick_preds``  (moveHead / chopHead predicates)
    -> ``_repair_move`` (the moveHead repair, per-lane selected)

runs in ``csrc/lane_tick.cu`` on the card; it replaces the JAX package's
Pallas megakernel ``kernels/lane_tick.py::fused_tick_mid``.  The three
rare repairs and ``_tick_finish`` stay outside, in plain PyTorch.

* :func:`fused_tick_mid` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch the kernel on the current stream (never a
  fallback) and add one to ``fused_tick_mid.launches``.
* :func:`launch_plan` — the one launch's CTA roles (control, head
  tiles, rows, move tiles, in the kernel's ticket order), their counts,
  threads and shared memory, passed to the kernel as dimensions.
* :func:`fused_tick_mid_plain` — the same function as the chain of
  ported passes over [L, ...] lanes.

Both return the fused output form of the reference wrapper: ``small_*``
and ``large_*`` alias ``pend_*`` (dead past the combine pass), ``stats0``
is the lanes' input stats, predicates are bool.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import pqueue
from repro_torch.core.config import EMPTY_VAL
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops

INF = float("inf")
_I32 = torch.int32
_F32 = torch.float32

#: int32 slots per lane of the kernel's scalar workspace (kLaneWs in
#: csrc/lane_tick.cu; the input/output/workspace pointer orders below are
#: the ones lane_tick_launch unpacks)
_LANE_WS = 16

#: output slots of [consumed prefix | new sequential part] per head tile
#: CTA (TW in csrc/lane_tick.cu): seq_cap 131072 spreads over 65 tiles
HEAD_TILE = 2048

#: slots of [fresh sequential part | removal stream] per move tile CTA (MW)
MOVE_TILE = 4096

#: bucket_cap up to which a warp takes a whole row (kWarpRowMax); past
#: it the rows CTA takes a row, and a warp sorts it if it holds at most
#: kWarpSortMax (256) live slots
WARP_ROW_MAX = 128

#: warps of a rows CTA
ROW_WARPS = 8

#: rows CTAs a launch aims at, across its lanes, for warp rows and for CTA
#: rows: few enough that all are resident at once beside the other roles
#: (132 SMs x 4), each taking its rows' live prefixes before it waits
#: (the two measured best on the H100 at sharded and pqe PRODUCTION)
WARP_ROW_CTAS = 512
CTA_ROW_CTAS = 384

#: int64 per CTA of the optional trace (kTraceWords)
TRACE_WORDS = 8

#: the most threads any role asks for (kMaxThreads, the launch bound)
MAX_THREADS = 256

#: CTAs the card holds at once at two an SM (132 SMs): a launch within it
#: takes the kernel's build for two CTAs an SM (up to 128 registers, no
#: spills), a larger one the build for four (64 registers)
RESIDENT_AT_TWO = 264

#: seq_cap up to which control and head CTAs stage the sequential part's
#: keys in shared memory (kSeqStage)
SEQ_STAGE = 4096

#: the CTA roles in ticket order
ROLES = ("control", "head", "rows", "move")


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _threads(work: float) -> int:
    """A role's threads: the power of two nearest above ``work``, within
    one warp and :data:`MAX_THREADS`."""
    return min(MAX_THREADS, max(32, _pow2(int(-(-work // 1)))))


@dataclasses.dataclass(frozen=True)
class Role:
    """One CTA role of the launch: its CTAs per lane, the threads it runs
    (the block's others leave at once), its dynamic shared memory and its
    width (head / move: output slots a CTA; rows: bucket rows a CTA;
    control: one lane)."""

    name: str
    ctas_per_lane: int
    threads: int
    smem_bytes: int
    width: int


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The one launch of a tick: ``lanes`` x the roles' CTAs, in ticket
    order (control, head, rows, move), each CTA ``block_threads`` wide
    with ``smem_bytes`` of dynamic shared memory (the most any role
    asks).  The cover maps below are the kernel's."""

    lanes: int
    roles: tuple
    block_threads: int
    smem_bytes: int

    def role(self, name: str) -> Role:
        return self.roles[ROLES.index(name)]

    @property
    def min_blocks(self) -> int:
        """CTAs an SM the kernel's build is for (its register bound)."""
        return 2 if self.grid <= RESIDENT_AT_TWO else 4

    @property
    def grid(self) -> int:
        return self.lanes * sum(r.ctas_per_lane for r in self.roles)

    def cover(self, name: str, n: int) -> list:
        """Per CTA of role ``name`` in a lane, the part of [0, ``n``) it
        owns: head, the output slots of [0, r_max + seq_cap); rows, its
        bucket rows of [0, n_buckets); move, the slots of [0, seq_cap +
        r_max)."""
        w = self.role(name).width
        return [range(min(c * w, n), min((c + 1) * w, n))
                for c in range(self.role(name).ctas_per_lane)]

    def dims(self) -> list:
        """The plan as lane_tick_launch reads it after the config: TW, T,
        RPC, RC, MW, MT, threads of the four roles, their shared bytes,
        the block's threads, CTAs an SM."""
        h, r, m = self.role("head"), self.role("rows"), self.role("move")
        return ([h.width, h.ctas_per_lane, r.width, r.ctas_per_lane,
                 m.width, m.ctas_per_lane]
                + [x.threads for x in self.roles]
                + [x.smem_bytes for x in self.roles]
                + [self.block_threads, self.min_blocks])


def launch_plan(cfg, lanes: int, head_tile: int = HEAD_TILE,
                rows_per_cta: int | None = None) -> LaunchPlan:
    """The launch's CTA roles for ``lanes`` lanes of config ``cfg``: each
    role's threads follow its work (control: max(a_max, n_buckets) / 4;
    a head tile: its slots / 4; a move tile: its slots / 8).  Rows CTAs
    have :data:`ROW_WARPS` warps (fewer if the lane has fewer rows) and
    ``rows_per_cta`` rows each, by default enough for about
    :data:`WARP_ROW_CTAS` (:data:`CTA_ROW_CTAS` past a warp's rows) rows
    CTAs in the launch, all resident at once."""
    A, R, SC = cfg.a_max, cfg.r_max, cfg.seq_cap
    NB, BC = cfg.n_buckets, cfg.bucket_cap
    head_n = R + SC
    seq = SC if SC <= SEQ_STAGE else 0      # staged keys, words
    hw = min(head_tile, head_n)             # a head tile's window
    if BC <= WARP_ROW_MAX:                  # a warp a row
        rpc = rows_per_cta or min(NB, max(ROW_WARPS,
                                          -(-lanes * NB // WARP_ROW_CTAS)))
        rows = Role("rows", -(-NB // rpc), 32 * min(rpc, ROW_WARPS), 0, rpc)
    else:                                   # the CTA a row, or a warp
        rpc = rows_per_cta or min(NB, -(-lanes * NB // CTA_ROW_CTAS))
        rows = Role("rows", -(-NB // rpc), 32 * ROW_WARPS, 8 * _pow2(BC),
                    rpc)
    roles = (
        Role("control", 1, _threads(max(A, NB) / 4),
             4 * (5 * A + 3 * NB + seq), 1),
        Role("head", -(-head_n // head_tile), _threads(hw / 4),
             4 * (2 * A + 2 * hw + seq), head_tile),
        rows,
        Role("move", -(-head_n // MOVE_TILE),
             _threads(min(MOVE_TILE, head_n) / 8), 0, MOVE_TILE),
    )
    return LaunchPlan(lanes, roles, max(r.threads for r in roles),
                      max(r.smem_bytes for r in roles))


def _presort(lk, lv, lm, adds_sorted=False):
    """The head's sanitize + stable a_max-wide sort, done outside the
    kernel: the kernel then runs the adds_sorted head on the same bits.
    ``adds_sorted=True`` promises each row is already stably key-sorted
    with a prefix mask (the router's output) and passes the batch through:
    the head (and the kernel) sanitize it themselves."""
    if adds_sorted:
        return lk, lv, lm
    sk = torch.where(lm, lk.to(_F32), INF)
    sv = torch.where(lm, lv.to(_I32), EMPTY_VAL)
    ak, av, _ = kops.sort_kvf(sk, sv, torch.zeros_like(sv),
                              backend=kops.TORCH)
    am = (kops.arange_i32(lk.shape[-1], lk)
          < lm.sum(-1, dtype=_I32)[..., None])
    return ak, av, am


def _fused_form(mid: pqueue.TickMid, stats0) -> pqueue.TickMid:
    p = mid.pending
    return mid._replace(
        pending=p._replace(small_k=p.pend_k, small_v=p.pend_v,
                           large_k=p.pend_k, large_v=p.pend_v),
        stats0=stats0)


def fused_tick_mid_plain(cfg, lanes: pqueue.PQState, lk, lv, lm,
                         grants, *, adds_sorted=False) -> pqueue.TickMid:
    """The kernel's plain version: the ported pass chain over [L, ...]
    lanes, with the lanes' stats zeroed inside (they ride to finish)."""
    ak, av, am = _presort(lk, lv, lm, adds_sorted)
    state = lanes._replace(
        stats=pqueue.tree_map(torch.zeros_like, lanes.stats))
    mid = pqueue._tick_head(cfg, state, ak, av, am, grants,
                            adds_sorted=True)
    mid = pqueue._pass_combine(cfg, mid)
    mid = pqueue._pass_scatter(cfg, mid)
    mid = pqueue._tick_preds(cfg, mid)
    mid = pqueue._repair_move(cfg, mid)
    return _fused_form(mid, lanes.stats)


def _out_layout(cfg):
    """Ordered (per-lane shape, dtype) of every kernel output — the
    TickMid fields the outside repairs and finish consume; predicates
    ride as i32."""
    sc, a, r = cfg.seq_cap, cfg.a_max, cfg.r_max
    nb, bc = cfg.n_buckets, cfg.bucket_cap
    f, i = _F32, _I32
    return ([((sc,), f), ((sc,), i), ((), i),              # nsk nsv new_len
             ((nb, bc), f), ((nb, bc), i), ((nb,), i),     # par store
             ((nb,), f), ((), f), ((), i),                 # splitters/min/count
             ((r,), f), ((r,), i), ((), i),                # rm stream + count
             ((a,), f), ((a,), i)]                         # pend_k pend_v
            + [((), i)] * 19)                              # preds + counters


def _check_inputs(cfg, inputs):
    """Device, dtype, shape and contiguity of the 18 kernel inputs."""
    L = inputs[0].shape[0]
    sc, a = cfg.seq_cap, cfg.a_max
    nb, bc = cfg.n_buckets, cfg.bucket_cap
    f, i = _F32, _I32
    want = [((sc,), f), ((sc,), i), ((), i),
            ((nb, bc), f), ((nb, bc), i), ((nb,), i), ((nb,), f),
            ((), f), ((), i), ((), f), ((), f), ((), i), ((), i), ((), i),
            ((a,), f), ((a,), i), ((a,), i), ((), i)]
    dev = inputs[0].device
    for n, (x, (shape, dtype)) in enumerate(zip(inputs, want)):
        if x.device != dev:
            raise ValueError(f"input {n} on {x.device}, expected {dev}")
        if x.dtype != dtype or tuple(x.shape) != (L,) + shape:
            raise ValueError(
                f"input {n}: got {x.dtype} {tuple(x.shape)}, expected "
                f"{dtype} {(L,) + shape}")
        if not x.is_contiguous():
            raise ValueError(f"input {n} is not contiguous")


def kernel_inputs(cfg, lanes: pqueue.PQState, lk, lv, lm, grants,
                  adds_sorted=False):
    """The kernel's 18 [L, ...] inputs: the lane state, the presorted
    add batch and the grants, checked for device, dtype, shape and
    contiguity."""
    ak, av, am = _presort(lk, lv, lm, adds_sorted)
    inputs = [
        lanes.seq_keys, lanes.seq_vals, lanes.seq_len,
        lanes.buckets, lanes.bvals, lanes.bcounts, lanes.splitters,
        lanes.par_min, lanes.par_count, lanes.min_value, lanes.last_seq,
        lanes.detach_n, lanes.ins_since_move, lanes.quiet_ticks,
        ak.to(_F32).contiguous(), av.to(_I32).contiguous(),
        am.to(_I32).contiguous(), grants.to(_I32).contiguous(),
    ]
    _check_inputs(cfg, inputs)
    return inputs


def kernel_buffers(cfg, lanes: int, device):
    """Fresh (outputs, scratch) for one launch over ``lanes`` lanes; the
    kernel writes every scratch word it reads, so none needs a value."""
    outs = [torch.empty((lanes,) + s, dtype=d, device=device)
            for s, d in _out_layout(cfg)]
    nb, k = cfg.n_buckets, cfg.move_k_max

    def empty(width, dtype):
        return torch.empty((lanes, width), dtype=dtype, device=device)

    ws = [empty(nb, _I32), empty(nb, _I32),         # seg_start, new_counts
          empty(nb, _I32), empty(nb, _I32),         # run offsets, nsel
          empty(nb, _F32),                          # survivor row minima
          empty(k, _F32), empty(k, _I32),           # extracted keys/vals
          empty(_LANE_WS, _I32)]                    # per-lane scalars
    return outs, ws


#: the counter workspace of each (device, stream, lanes): tickets, the
#: lanes' control flags and done counts, zero between launches
_COUNTERS: dict = {}


def counter_workspace(device, stream: int, lanes: int) -> torch.Tensor:
    """The zeroed int32 [2 + 2 lanes] counters of launches over ``lanes``
    lanes on ``stream``: made (zeroed) on first use, and each launch
    leaves them zero again.  One stream runs its launches one after
    another, so launches sharing it (two mesh positions on one card)
    never race; another stream gets its own.  Its size depends only on
    the lanes, so the key holds no config."""
    key = (torch.device(device), stream, lanes)
    ctr = _COUNTERS.get(key)
    if ctr is None:
        ctr = torch.zeros(2 + 2 * lanes, dtype=_I32, device=device)
        _COUNTERS[key] = ctr
    return ctr


def launch(cfg, inputs, outs, ws, head_tile=HEAD_TILE,
           rows_per_cta=None, trace=None) -> None:
    """Launch the kernel on the current stream and raise if the launch
    was refused.  Does not count: :func:`fused_tick_mid` does.
    ``head_tile`` is the head's output slots per tile CTA and
    ``rows_per_cta`` the bucket rows a rows CTA takes
    (:func:`launch_plan`);
    only the kernel's own checks pass other values than the defaults, so
    that short sequential parts cross tile edges and a grid outgrows the
    card's resident CTAs.  ``trace``, an int64 [grid, :data:`TRACE_WORDS`]
    tensor on the device, gets each CTA's row by ticket: role << 32 |
    lane, then the card's clock in ns at its start, when its wait ended
    and at its end, then control's milestones (:func:`role_spans` reads
    it)."""
    lanes = inputs[0].shape[0]
    plan = launch_plan(cfg, lanes, head_tile, rows_per_cta)
    dims = (ctypes.c_longlong * 29)(
        lanes, cfg.a_max, cfg.r_max, cfg.seq_cap,
        cfg.n_buckets, cfg.bucket_cap, cfg.move_k_max, cfg.spill_threshold,
        cfg.chop_patience, cfg.detach_min, cfg.detach_max,
        cfg.halve_threshold, cfg.double_threshold, *plan.dims())

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(
            *(None if t is None else t.data_ptr() for t in ts))

    lib = build.load("lane_tick")
    dev = inputs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ctr = counter_workspace(dev, stream, lanes)
        err = lib.lane_tick_launch(dims, ptrs(inputs), ptrs(outs),
                                   ptrs(list(ws) + [ctr, trace]),
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("lane_tick kernel launch failed: "
                           + lib.lane_tick_error_string(err).decode())


def role_spans(trace: torch.Tensor) -> dict:
    """Per role of one traced launch (:func:`launch`'s ``trace``): its
    CTAs, the span from the first CTA's start to the last one's end, and
    from the first CTA's end of waiting to the last one's end (its work
    once its inputs were there), in µs on the card's clock; the launch's
    own span under ``"launch"``."""
    t = trace.cpu().numpy()
    roles = t[:, 0] >> 32
    spans = {"launch": float(t[:, 3].max() - t[:, 1].min()) / 1e3}
    for i, name in enumerate(ROLES):
        r = t[roles == i]
        if len(r):
            spans[name] = dict(
                ctas=len(r), span_us=float(r[:, 3].max() - r[:, 1].min())
                / 1e3, work_us=float(r[:, 3].max() - r[:, 2].min()) / 1e3)
    r = t[roles == 0]
    # control, from its start: scalars counted, combine merged, scatter
    # decided, done (means over the lanes)
    spans["control"]["milestones_us"] = [
        float((r[:, j] - r[:, 1]).mean()) / 1e3 for j in (4, 5, 6, 3)]
    return spans


def fused_tick_mid(cfg, lanes: pqueue.PQState, lk, lv, lm, grants, *,
                   adds_sorted=False) -> pqueue.TickMid:
    """Run the hot tick of every lane and return the lane-batched
    :class:`pqueue.TickMid` (rare repairs still pending — the caller
    runs them behind its branches, then ``_tick_finish``).

    ``lanes`` is a [L, ...]-stacked PQState, ``lk/lv/lm`` the [L, a_max]
    add batches (any order, or key-sorted with a prefix mask under
    ``adds_sorted=True``, which skips the presort), ``grants`` the [L]
    removeMin counts.  CPU
    tensors run :func:`fused_tick_mid_plain`; CUDA tensors launch the
    kernel, and anything else raises."""
    dev = lk.device
    if dev.type == "cpu":
        return fused_tick_mid_plain(cfg, lanes, lk, lv, lm, grants,
                                    adds_sorted=adds_sorted)
    if dev.type != "cuda":
        raise ValueError(f"fused_tick_mid runs on cuda or cpu, got {dev}")
    inputs = kernel_inputs(cfg, lanes, lk, lv, lm, grants, adds_sorted)
    outs, ws = kernel_buffers(cfg, lk.shape[0], dev)
    launch(cfg, inputs, outs, ws)
    fused_tick_mid.launches += 1
    return mid_from_outputs(outs, lanes.stats)


def mid_from_outputs(outs, stats0) -> pqueue.TickMid:
    """The lane-batched TickMid (fused form) from the kernel's outputs."""
    (nsk, nsv, new_len, pbk, pbv, pbc, psp, pmin, pcnt, rmk, rmv, rmc,
     pendk, pendv, nc, ns, nr, nm, r2, mo, da, nchop, n_imm, n_upc,
     n_rm_seq, n_addseq, n_par_adds, spilled, n_rm_par, n_drop_rep,
     detach_n, ins_since_move, quiet) = outs
    pending = pqueue.RepairPending(
        need_combine=nc != 0, small_k=pendk, small_v=pendv,
        large_k=pendk, large_v=pendv,
        need_scatter=ns != 0, pend_k=pendk, pend_v=pendv,
        need_rebal=nr != 0, need_move=nm != 0, r2=r2, move_off=mo,
        detach_arg=da, need_chop=nchop != 0)
    return pqueue.TickMid(
        nsk=nsk, nsv=nsv, new_len=new_len,
        par=pqueue.ParPart(pbk, pbv, pbc, psp, pmin, pcnt),
        rm_keys=rmk, rm_vals=rmv, rm_count=rmc, pending=pending,
        n_imm=n_imm, n_upc=n_upc, n_rm_seq=n_rm_seq, n_addseq=n_addseq,
        n_par_adds=n_par_adds, spilled=spilled, n_rm_par=n_rm_par,
        n_drop_rep=n_drop_rep, detach_n=detach_n,
        ins_since_move=ins_since_move, quiet=quiet, stats0=stats0)


#: kernel launches made by :func:`fused_tick_mid` (one per call: one tick
#: of every lane, one launch of the CUDA side)
fused_tick_mid.launches = 0
