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
* :func:`fused_tick_mid_plain` — the same function as the chain of
  ported passes over [L, ...] lanes.

Both return the fused output form of the reference wrapper: ``small_*``
and ``large_*`` alias ``pend_*`` (dead past the combine pass), ``stats0``
is the lanes' input stats, predicates are bool.
"""

from __future__ import annotations

import ctypes

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
    """Fresh (outputs, workspace) for one launch over ``lanes`` lanes."""
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


def launch(cfg, inputs, outs, ws, head_tile=HEAD_TILE) -> None:
    """Launch the kernel on the current stream and raise if the launch
    was refused.  Does not count: :func:`fused_tick_mid` does.
    ``head_tile`` is the head's output slots per tile CTA; only the
    kernel's own checks pass another width than :data:`HEAD_TILE`, so
    that short sequential parts cross tile edges."""
    dims = (ctypes.c_longlong * 14)(
        inputs[0].shape[0], cfg.a_max, cfg.r_max, cfg.seq_cap,
        cfg.n_buckets, cfg.bucket_cap, cfg.move_k_max, cfg.spill_threshold,
        cfg.chop_patience, cfg.detach_min, cfg.detach_max,
        cfg.halve_threshold, cfg.double_threshold, head_tile)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))

    lib = build.load("lane_tick")
    dev = inputs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lane_tick_launch(dims, ptrs(inputs), ptrs(outs), ptrs(ws),
                                   ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("lane_tick kernel launch failed: "
                           + lib.lane_tick_error_string(err).decode())


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
#: of every lane, which is three launches of the CUDA side)
fused_tick_mid.launches = 0
