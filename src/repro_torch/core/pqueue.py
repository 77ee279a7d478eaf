"""Batched adaptive priority queue with elimination and combining
(PyTorch port of the JAX package's ``core/pqueue.py``).

Calciu, Mendes & Herlihy 2014 as a batch tick: the elimination array is a
vectorised elimination pass over the tick's add batch, the server
thread's combining is one merge of the sequential part with the small
adds, the sequential skiplist part is a sorted array head, and the
parallel part is a key-range bucketed store that large adds
segment-append into.  ``moveHead``/``chopHead`` and the adaptive detach
policy transfer verbatim.

Every pass is a plain function on tensors with the reference's field
names, dtypes and arithmetic, so a tick here is bit-identical to the JAX
package's tick on the same state.  Passes work on any leading dims: the
lane-major form is the kernel's plain version (``kernels/lane_tick.py``).
The JAX package's ``lax.cond`` around each repair is a host-side branch
here (it synchronises with the device), and ``tick_n`` is a Python loop.
Nothing mutates the state it is given.

With ``cfg.backend == "cuda"`` the hot pipeline (head through moveHead)
runs as the L=1 case of the hand-written lane-tick kernel, and only the
three rare repairs and the finish run in plain PyTorch around it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.adaptive import update_detach
from repro_torch.core.config import EMPTY_VAL, PQConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ops import arange_i32, take_last

INF = float("inf")
_I32 = torch.int32
_F32 = torch.float32


class PQStats(NamedTuple):
    """Cumulative per-path counters (the paper's Figs. 7–8 and Table 1
    accounting); every field an int32 tensor."""

    add_imm_elim: torch.Tensor  # adds eliminated immediately (v <= minValue)
    add_upc_elim: torch.Tensor  # adds eliminated after "aging" in the batch
    add_seq: torch.Tensor       # adds combined into the sequential part
    add_par: torch.Tensor       # adds inserted in parallel (SL::addPar)
    rm_seq: torch.Tensor        # removes served from the sequential part
    rm_par: torch.Tensor        # removes served via emergency moveHead
    rm_empty: torch.Tensor      # removes that found an empty queue
    n_movehead: torch.Tensor    # SL::moveHead() events
    n_chophead: torch.Tensor    # SL::chopHead() events
    n_rebalance: torch.Tensor   # parallel-part rebalances (bucket overflow)
    n_spill: torch.Tensor       # sequential->parallel spills (partial chop)
    n_dropped: torch.Tensor     # items dropped at total-capacity
    n_ticks: torch.Tensor
    n_removes: torch.Tensor     # total removeMin requests
    local_elim: torch.Tensor    # kept so the stats layout matches the reference

    @staticmethod
    def zeros(device="cuda") -> "PQStats":
        return PQStats(*(torch.zeros((), dtype=_I32, device=device)
                         for _ in range(15)))


class PQState(NamedTuple):
    """State of the dual-structure priority queue."""

    # sequential part: sorted ascending, INF-padded beyond seq_len
    seq_keys: torch.Tensor      # [seq_cap] f32
    seq_vals: torch.Tensor      # [seq_cap] i32
    seq_len: torch.Tensor       # scalar i32

    # parallel part: key-range buckets (2-level radix "skiplist")
    buckets: torch.Tensor       # [NB, BCAP] f32 (INF = empty slot)
    bvals: torch.Tensor         # [NB, BCAP] i32
    bcounts: torch.Tensor       # [NB] i32
    splitters: torch.Tensor     # [NB] f32, splitters[0] = -INF, nondecreasing
    par_min: torch.Tensor       # scalar f32 (INF if parallel part empty)
    par_count: torch.Tensor     # scalar i32

    # paper state
    min_value: torch.Tensor     # scalar f32 (paper's minValue; INF if empty)
    last_seq: torch.Tensor      # scalar f32 (paper's lastSeq.key; -INF if none)
    detach_n: torch.Tensor      # scalar i32 (adaptive moveHead size)
    ins_since_move: torch.Tensor  # scalar i32
    quiet_ticks: torch.Tensor   # scalar i32 (ticks without removes)

    stats: PQStats


class TickResult(NamedTuple):
    rm_keys: torch.Tensor       # [r_max] f32; INF where unserved/masked
    rm_vals: torch.Tensor       # [r_max] i32; EMPTY_VAL where unserved
    rm_served: torch.Tensor     # [r_max] bool
    # which passes this tick needed: [5] i32 (combine, scatter,
    # rebalance, moveHead, chopHead); empty for the baselines' ticks
    repairs: torch.Tensor = ()


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of nested NamedTuples."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    return fn(tree)


def tree_leaves(tree):
    """Tensor leaves of nested NamedTuples, in field order (the order of
    ``jax.tree.leaves`` on the reference's pytrees)."""
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def init(cfg: PQConfig, device="cuda") -> PQState:
    nb, bc, sc = cfg.n_buckets, cfg.bucket_cap, cfg.seq_cap

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    splitters = full((nb,), INF, _F32)
    splitters[0] = -INF
    return PQState(
        seq_keys=full((sc,), INF, _F32),
        seq_vals=full((sc,), EMPTY_VAL, _I32),
        seq_len=full((), 0, _I32),
        buckets=full((nb, bc), INF, _F32),
        bvals=full((nb, bc), EMPTY_VAL, _I32),
        bcounts=full((nb,), 0, _I32),
        splitters=splitters,
        par_min=full((), INF, _F32),
        par_count=full((), 0, _I32),
        min_value=full((), INF, _F32),
        last_seq=full((), -INF, _F32),
        detach_n=full((), cfg.detach_init, _I32),
        ins_since_move=full((), 0, _I32),
        quiet_ticks=full((), 0, _I32),
        stats=PQStats.zeros(device),
    )


# ---------------------------------------------------------------------------
# small vectorized helpers
# ---------------------------------------------------------------------------

def _sort_kv(keys, vals):
    """Co-sort an [n] batch by key as the reference's ``jnp.argsort``
    does: a stable float sort in which -0.0 ties with 0.0 (slot order).
    The zeros are made one before sorting, so no device's sort can order
    them apart."""
    order = torch.sort(torch.where(keys == 0, 0.0, keys), stable=True).indices
    return keys[order], vals[order]


def _shift_left(arr, n, fill):
    """arr shifted left by n along the last axis, `fill` on the right;
    `n` may carry leading dims matching arr's."""
    size = arr.shape[-1]
    idx = n[..., None] + arange_i32(size, arr)
    out = take_last(arr, idx.clamp(0, size - 1))
    return torch.where(idx < size, out, fill)


def _take_window(arr, start, out_len, fill):
    """arr[..., start : start+out_len], `fill` past the end; `start` may
    carry leading dims matching arr's."""
    size = arr.shape[-1]
    idx = start[..., None] + arange_i32(out_len, arr)
    out = take_last(arr, idx.clamp(0, size - 1))
    return torch.where(idx < size, out, fill)


def _where_lead(pred, a, b):
    """torch.where with `pred` broadcast against extra trailing axes."""
    extra = a.ndim - pred.ndim
    return torch.where(pred.reshape(pred.shape + (1,) * extra), a, b)


def _select_tree(pred, t_true, t_false):
    """Per-lane select over a flat NamedTuple."""
    return type(t_true)(*(_where_lead(pred, x, y)
                          for x, y in zip(t_true, t_false)))


def _lead_arange(n, like, lead):
    return arange_i32(n, like).expand(lead + (n,))


def rank_merge_kv(ak, av, bk, bv):
    """Rank-merge two sorted (key, val) streams (INF-padded), ties a-first."""
    ok, ov, _ = kops._merge_sorted_corank(
        ak, av, torch.zeros_like(av), bk, bv, torch.zeros_like(bv))
    return ok, ov


# ---------------------------------------------------------------------------
# parallel part primitives (the bucketed "skiplist" suffix)
# ---------------------------------------------------------------------------

class ParPart(NamedTuple):
    buckets: torch.Tensor
    bvals: torch.Tensor
    bcounts: torch.Tensor
    splitters: torch.Tensor
    par_min: torch.Tensor
    par_count: torch.Tensor


def _par_of(state: PQState) -> ParPart:
    return ParPart(state.buckets, state.bvals, state.bcounts,
                   state.splitters, state.par_min, state.par_count)


def flatten_parallel(cfg: PQConfig, par: ParPart):
    """All parallel items as a sorted flat (keys, vals) pair of size
    par_cap: the per-bucket sorted runs concatenated by bucket rank."""
    fk, fv, _, _ = kops.sorted_runs_gather(par.buckets, par.bvals,
                                           par.bcounts, cfg.par_cap)
    return fk, fv


def _redistribute(cfg: PQConfig, flat_k, flat_v, total):
    """Evenly refill the buckets from a sorted flat stream: bucket i
    takes ranks [i*per, (i+1)*per) and splitters are the bucket minima.
    Accepts leading lane dims on every argument."""
    nb, bc = cfg.n_buckets, cfg.bucket_cap
    size = flat_k.shape[-1]
    lead = flat_k.shape[:-1]
    total = torch.as_tensor(total, dtype=_I32, device=flat_k.device)
    per = ((total + nb - 1) // nb).clamp(1, bc)
    capacity = nb * per
    kept = torch.minimum(total, capacity)
    dropped = total - kept

    rows = arange_i32(nb, flat_k)[:, None]
    slot = arange_i32(bc, flat_k)[None, :]
    per_b = per[..., None, None]
    idx = rows * per_b + slot                       # [..., nb, bc]
    take = (slot < per_b) & (idx < kept[..., None, None])
    src = idx.clamp(0, size - 1).reshape(lead + (nb * bc,))
    gk = take_last(flat_k, src).reshape(lead + (nb, bc))
    gv = take_last(flat_v, src).reshape(lead + (nb, bc))
    buckets = torch.where(take, gk, INF)
    bvals = torch.where(take, gv, EMPTY_VAL)
    bcounts = torch.minimum(
        (kept[..., None] - arange_i32(nb, flat_k) * per[..., None])
        .clamp(min=0), per[..., None]).to(_I32)

    sp_idx = arange_i32(nb, flat_k) * per[..., None]        # [..., nb]
    sp = take_last(flat_k, sp_idx.clamp(0, size - 1))
    splitters = torch.where(sp_idx < kept[..., None], sp, INF)
    splitters[..., 0] = -INF

    par_min = torch.where(kept > 0, flat_k[..., 0], INF)
    return ParPart(buckets, bvals, bcounts, splitters, par_min,
                   kept.to(_I32)), dropped.to(_I32)


def scatter_parallel(cfg: PQConfig, par: ParPart, keys, vals):
    """SL::addPar(): disjoint-access parallel insert of an unsorted [n]
    key batch (the parallel baseline's add path).

    Fast path: group the batch by bucket with a stable sort of the
    splitter routes' bucket ids, then :func:`_scatter_fast`'s
    segment-append (its splitter bounds cut any bucket-grouped order
    where the bucket ids do).  On bucket overflow, a host branch takes
    the rebalance instead: the per-bucket sorted runs rank-merged with
    the sorted batch, then redistributed.  Invalid entries are INF keys;
    they are dropped.  Returns (new_par, n_rebalance, n_dropped)."""
    nb = cfg.n_buckets
    dev = keys.device
    valid = keys < INF

    bidx = (kops.searchsorted_last(par.splitters, keys, side="right") - 1
            ).clamp(0, nb - 1)
    bidx = torch.where(valid, bidx, nb)      # invalid -> past the last bucket
    order = torch.sort(bidx, stable=True).indices
    appended, overflow = _scatter_fast(cfg, par, keys[order], vals[order])
    if not bool(overflow):
        zero = torch.zeros((), dtype=_I32, device=dev)
        return appended, zero, zero

    fk, fv = flatten_parallel(cfg, par)
    ck, cv = _sort_kv(torch.where(valid, keys, INF),
                      torch.where(valid, vals, EMPTY_VAL))
    allk, allv = rank_merge_kv(fk, fv, ck, cv)
    total = par.par_count + valid.sum(dtype=_I32)
    newpar, dropped = _redistribute(cfg, allk, allv, total)
    return newpar, torch.ones((), dtype=_I32, device=dev), dropped


# ---------------------------------------------------------------------------
# the tick: elimination -> combining -> parallel adds -> moveHead/chopHead
# (an unconditional head plus separable passes whose predicates ride the
# mid-tick carry; see the reference module for the full design notes)
# ---------------------------------------------------------------------------

class RepairPending(NamedTuple):
    """Pass predicates + operands exposed by :func:`_tick_head`."""

    need_combine: torch.Tensor  # bool — seq nonempty or small adds exist
    small_k: torch.Tensor       # [a_max] f32 sorted small adds (INF-padded)
    small_v: torch.Tensor       # [a_max] i32
    large_k: torch.Tensor       # [a_max] f32 sorted large adds (INF-padded)
    large_v: torch.Tensor       # [a_max] i32
    need_scatter: torch.Tensor  # bool — pend batch nonempty: SL::addPar()
    pend_k: torch.Tensor        # [a_max] f32 sorted par-bound batch
    pend_v: torch.Tensor        # [a_max] i32
    need_rebal: torch.Tensor    # bool — bucket overflow (set by scatter)
    need_move: torch.Tensor     # bool — remove shortfall: SL::moveHead()
    r2: torch.Tensor            # i32 removes left for the parallel part
    move_off: torch.Tensor      # i32 offset of moveHead keys in rm_keys
    detach_arg: torch.Tensor    # i32 pre-update detach_n (sizes the extract)
    need_chop: torch.Tensor     # bool — quiet stream: SL::chopHead()


class TickMid(NamedTuple):
    """Mid-tick carry between the head, the passes, and finish."""

    nsk: torch.Tensor         # [seq_cap] f32 tentative sequential part
    nsv: torch.Tensor         # [seq_cap] i32
    new_len: torch.Tensor     # i32
    par: ParPart
    rm_keys: torch.Tensor     # [r_max] f32
    rm_vals: torch.Tensor     # [r_max] i32
    rm_count: torch.Tensor    # i32
    pending: RepairPending
    n_imm: torch.Tensor
    n_upc: torch.Tensor
    n_rm_seq: torch.Tensor
    n_addseq: torch.Tensor
    n_par_adds: torch.Tensor
    spilled: torch.Tensor     # i32 0/1
    n_rm_par: torch.Tensor    # filled by the moveHead repairs
    n_drop_rep: torch.Tensor  # filled by rebalance/chop repairs
    detach_n: torch.Tensor    # finalized by _tick_preds
    ins_since_move: torch.Tensor
    quiet: torch.Tensor
    stats0: PQStats           # pre-tick stats (base for finish)


def _scatter_fast(cfg: PQConfig, par: ParPart, keys, vals):
    """SL::addPar() fast path: segment-append a batch along the splitter
    routes.  The batch must be grouped by bucket: sorted (the tick's
    pend batch) or stably ordered by bucket id (:func:`scatter_parallel`),
    with its INF keys last.  Returns (appended_par, overflow); when
    `overflow` the append is wrong and the caller discards it."""
    nb, bc = cfg.n_buckets, cfg.bucket_cap
    size = keys.shape[-1]
    lead = keys.shape[:-1]
    valid = keys < INF
    bounds = torch.cat(
        [par.splitters[..., 1:],
         torch.full(lead + (1,), INF, dtype=_F32, device=keys.device)],
        dim=-1)
    ends = kops.searchsorted_last(keys, bounds, side="left")  # [..., nb]
    seg_start = torch.cat(
        [torch.zeros(lead + (1,), dtype=_I32, device=keys.device),
         ends[..., :-1]], dim=-1)
    seg_len = ends - seg_start
    new_counts = par.bcounts + seg_len
    overflow = (new_counts > bc).any(-1)

    slot = arange_i32(bc, keys)
    old = slot < par.bcounts[..., None]
    appended = ~old & (slot < new_counts[..., None])
    src = (seg_start[..., None] + (slot - par.bcounts[..., None])).clamp(
        0, size - 1).reshape(lead + (nb * bc,))
    gk = take_last(keys, src).reshape(lead + (nb, bc))
    gv = take_last(vals, src).reshape(lead + (nb, bc))
    buckets = torch.where(appended, gk, torch.where(old, par.buckets, INF))
    bvals = torch.where(appended, gv,
                        torch.where(old, par.bvals, EMPTY_VAL))
    kmin = kops.amin_f32(torch.where(valid, keys, INF), -1)
    par_min = kops.minimum_f32(par.par_min, kmin)
    par_count = par.par_count + valid.sum(-1, dtype=_I32)
    return ParPart(buckets, bvals, new_counts.clamp(max=bc),
                   par.splitters, par_min, par_count), overflow


def _tick_head(cfg: PQConfig, state: PQState, add_keys, add_vals,
               add_mask, rm_count, *, adds_sorted: bool = False) -> TickMid:
    """Steps 0–2: batch sort, immediate elimination, small/large split.

    ``adds_sorted=True`` promises add_keys is already stably key-sorted
    with an INF suffix and add_mask a matching prefix."""
    A, R = cfg.a_max, cfg.r_max
    dev = state.seq_keys.device
    rm_count = torch.as_tensor(rm_count, dtype=_I32, device=dev).clamp(max=R)

    # -- 0. sanitize + sort the add batch (the elimination array) --
    ak = torch.where(add_mask, add_keys.to(_F32), INF)
    av = torch.where(add_mask, add_vals.to(_I32), EMPTY_VAL)
    if not adds_sorted:
        ak, av, _ = kops.sort_kvf(ak, av, torch.zeros_like(av),
                                  backend=kops.TORCH)
    n_adds = add_mask.sum(-1, dtype=_I32)
    a_valid = arange_i32(A, ak) < n_adds[..., None]

    # -- 1. immediate elimination: add(v <= minValue) pairs a remove --
    m0 = state.min_value
    n_elig = ((ak <= m0[..., None]) & a_valid).sum(-1, dtype=_I32)
    n_imm = torch.minimum(n_elig, rm_count)
    rem_k = _shift_left(ak, n_imm, INF)
    rem_v = _shift_left(av, n_imm, EMPTY_VAL)

    # -- 2. split small (<= lastSeq: SL::addPar would refuse) / large --
    small_mask = rem_k <= state.last_seq[..., None]
    n_small = small_mask.sum(-1, dtype=_I32)
    small_k = torch.where(small_mask, rem_k, INF)
    small_v = torch.where(small_mask, rem_v, EMPTY_VAL)
    large_k = _shift_left(rem_k, n_small, INF)
    large_v = _shift_left(rem_v, n_small, EMPTY_VAL)
    n_par_adds = (large_k < INF).sum(-1, dtype=_I32)

    # -- removal stream segment 1 (the eliminated prefix) --
    ridx = arange_i32(R, ak)
    requested = ridx < rm_count[..., None]
    in1 = requested & (ridx < n_imm[..., None])
    src1 = ridx.clamp(0, A - 1).long()
    rm_keys = torch.where(in1, ak[..., src1], INF)
    rm_vals = torch.where(in1, av[..., src1], EMPTY_VAL)

    z = torch.zeros_like(n_imm)
    no = torch.zeros_like(n_imm, dtype=torch.bool)
    pending = RepairPending(
        need_combine=(state.seq_len > 0) | (n_small > 0),
        small_k=small_k, small_v=small_v,
        large_k=large_k, large_v=large_v,
        need_scatter=n_par_adds > 0,
        pend_k=large_k, pend_v=large_v,     # combine may fold a spill in
        need_rebal=no, need_move=no, r2=z, move_off=n_imm,
        detach_arg=state.detach_n, need_chop=no)
    return TickMid(
        nsk=state.seq_keys, nsv=state.seq_vals,
        new_len=state.seq_len, par=_par_of(state),
        rm_keys=rm_keys, rm_vals=rm_vals, rm_count=rm_count,
        pending=pending,
        n_imm=n_imm, n_upc=z, n_rm_seq=z, n_addseq=z,
        n_par_adds=n_par_adds, spilled=z, n_rm_par=z, n_drop_rep=z,
        detach_n=state.detach_n, ins_since_move=state.ins_since_move,
        quiet=state.quiet_ticks, stats0=state.stats)


def _pass_combine(cfg: PQConfig, mid: TickMid) -> TickMid:
    """Steps 3–4: rank-merge the sequential part with the small adds,
    consume the remove prefix, spill past the threshold, and fold the
    spill into the par-bound batch.  Lanes with `need_combine` False keep
    the head's state bit-for-bit."""
    A, R, SC = cfg.a_max, cfg.r_max, cfg.seq_cap
    M = SC + A
    p = mid.pending
    lead = mid.rm_keys.shape[:-1]
    sel = p.need_combine
    like = mid.rm_keys

    small_flag = (p.small_k < INF).to(_I32)
    mk, mv, mf = kops.merge_sorted(
        mid.nsk, mid.nsv, torch.zeros(mid.nsk.shape, dtype=_I32,
                                      device=like.device),
        p.small_k, p.small_v, small_flag, backend=kops.TORCH)

    n_small = small_flag.sum(-1, dtype=_I32)
    r1 = mid.rm_count - mid.n_imm
    avail = mid.new_len + n_small       # new_len still == state.seq_len
    s = torch.minimum(r1, avail)
    consumed = _lead_arange(M, like, lead) < s[..., None]
    n_upc = (consumed & mf.bool()).sum(-1, dtype=_I32)
    n_rm_seq = s - n_upc
    n_addseq = n_small - n_upc

    new_len = avail - s
    nsk = _take_window(mk, s, SC, INF)
    nsv = _take_window(mv, s, SC, EMPTY_VAL)
    in_new = _lead_arange(SC, like, lead) < new_len[..., None]
    nsk = torch.where(in_new, nsk, INF)
    nsv = torch.where(in_new, nsv, EMPTY_VAL)

    # spill (partial chopHead) if the sequential part grew too large
    spill_cnt = (new_len - cfg.spill_threshold).clamp(min=0)
    sp_start = new_len - spill_cnt
    sp_k = _take_window(nsk, sp_start, A, INF)
    sp_v = _take_window(nsv, sp_start, A, EMPTY_VAL)
    in_sp = _lead_arange(A, like, lead) < spill_cnt[..., None]
    sp_k = torch.where(in_sp, sp_k, INF)
    sp_v = torch.where(in_sp, sp_v, EMPTY_VAL)
    keep = _lead_arange(SC, like, lead) < sp_start[..., None]
    nsk = torch.where(keep, nsk, INF)
    nsv = torch.where(keep, nsv, EMPTY_VAL)
    new_len = new_len - spill_cnt

    # par-bound batch: the sorted union is literally [spill | large]
    idx2 = _lead_arange(A, like, lead)
    j_lg = idx2 - spill_cnt[..., None]
    take_sp = idx2 < spill_cnt[..., None]
    in_lg = ~take_sp & (j_lg < A)
    sp_idx = idx2.clamp(0, A - 1)
    lg_idx = j_lg.clamp(0, A - 1)
    pk = torch.where(take_sp, take_last(sp_k, sp_idx),
                     torch.where(in_lg, take_last(p.large_k, lg_idx), INF))
    pv = torch.where(take_sp, take_last(sp_v, sp_idx),
                     torch.where(in_lg, take_last(p.large_v, lg_idx),
                                 EMPTY_VAL))

    # removal stream segment 2: the consumed merge prefix
    ridx = _lead_arange(R, like, lead)
    rel = ridx - mid.n_imm[..., None]
    in2 = (rel >= 0) & (rel < s[..., None]) & sel[..., None]
    src2 = rel.clamp(0, M - 1)
    rm_keys = torch.where(in2, take_last(mk, src2), mid.rm_keys)
    rm_vals = torch.where(in2, take_last(mv, src2), mid.rm_vals)

    z = torch.zeros_like(s)
    spilled = sel & (spill_cnt > 0)
    return mid._replace(
        nsk=_where_lead(sel, nsk, mid.nsk),
        nsv=_where_lead(sel, nsv, mid.nsv),
        new_len=torch.where(sel, new_len, mid.new_len).to(_I32),
        rm_keys=rm_keys, rm_vals=rm_vals,
        n_upc=torch.where(sel, n_upc, z),
        n_rm_seq=torch.where(sel, n_rm_seq, z),
        n_addseq=torch.where(sel, n_addseq, z),
        spilled=spilled.to(_I32),
        pending=p._replace(
            pend_k=_where_lead(sel, pk, p.pend_k),
            pend_v=_where_lead(sel, pv, p.pend_v),
            need_scatter=p.need_scatter | spilled,
            move_off=(mid.n_imm + torch.where(sel, s, z)).to(_I32)))


def _pass_scatter(cfg: PQConfig, mid: TickMid) -> TickMid:
    """Step 5: SL::addPar() segment-append of the par-bound batch,
    resolving the rebalance predicate."""
    p = mid.pending
    par_app, overflow = _scatter_fast(cfg, mid.par, p.pend_k, p.pend_v)
    sel = p.need_scatter
    return mid._replace(
        par=_select_tree(sel & ~overflow, par_app, mid.par),
        pending=p._replace(need_rebal=sel & overflow))


def _tick_preds(cfg: PQConfig, mid: TickMid) -> TickMid:
    """Steps 6–8 predicates: moveHead shortfall, adaptive detach policy,
    chopHead quiet counter.  Elementwise bookkeeping."""
    p = mid.pending
    r2 = mid.rm_count - p.move_off      # removes that drained the merge
    n_pend = (p.pend_k < INF).sum(-1, dtype=_I32)
    count_eff = mid.par.par_count + torch.where(p.need_rebal, n_pend, 0)
    need_move = (r2 > 0) & (count_eff > 0)

    ins = mid.ins_since_move + mid.n_addseq
    new_detach = update_detach(cfg, p.detach_arg, ins)
    detach_n = torch.where(need_move, new_detach, p.detach_arg)
    ins_since_move = torch.where(need_move, 0, ins).to(_I32)

    quiet = torch.where(mid.rm_count > 0, 0, mid.quiet + 1).to(_I32)
    need_chop = (quiet >= cfg.chop_patience) & (mid.new_len > 0)
    quiet = torch.where(need_chop, 0, quiet)
    return mid._replace(
        detach_n=detach_n, ins_since_move=ins_since_move, quiet=quiet,
        pending=p._replace(need_move=need_move, r2=r2,
                           need_chop=need_chop))


def _repair_rebalance(cfg: PQConfig, mid: TickMid) -> TickMid:
    """Bucket-overflow repair: flatten + rank-merge the pending batch +
    redistribute, for lanes that need a rebalance but not a moveHead."""
    par, p = mid.par, mid.pending
    fk, fv = flatten_parallel(cfg, par)
    allk, allv = rank_merge_kv(fk, fv, p.pend_k, p.pend_v)
    n_pend = (p.pend_k < INF).sum(-1, dtype=_I32)
    newpar, dropped = _redistribute(cfg, allk, allv,
                                    par.par_count + n_pend)
    sel = p.need_rebal & ~p.need_move
    return mid._replace(
        par=_select_tree(sel, newpar, par),
        n_drop_rep=mid.n_drop_rep + torch.where(sel, dropped, 0))


def _repair_move(cfg: PQConfig, mid: TickMid) -> TickMid:
    """SL::moveHead() repair: extraction of the max(detach_n, r2)
    smallest parallel keys — serves the shortfall prefix into the
    removed stream and detaches the rest as a fresh sequential part —
    for lanes that need a moveHead but not a rebalance."""
    par, p = mid.par, mid.pending
    R, SC, K = cfg.r_max, cfg.seq_cap, cfg.move_k_max
    served = torch.minimum(p.r2, par.par_count)
    k_extract = torch.minimum(torch.maximum(p.detach_arg, p.r2),
                              par.par_count)
    # the fresh head must fit the sequential part with next-tick slack
    k_extract = torch.minimum(k_extract, served + cfg.spill_threshold)
    sel_k, sel_v, nbk, nbv, nbc = kops.extract_k_bucketed(
        par.buckets, par.bvals, par.bcounts, k_extract, K,
        backend=kops.TORCH)

    lead = sel_k.shape[:-1]
    ridx = _lead_arange(R, sel_k, lead)
    rel = ridx - p.move_off[..., None]
    sel = p.need_move & ~p.need_rebal
    in3 = (rel >= 0) & (rel < served[..., None]) & sel[..., None]
    src3 = rel.clamp(0, K - 1)
    rm_keys = torch.where(in3, take_last(sel_k, src3), mid.rm_keys)
    rm_vals = torch.where(in3, take_last(sel_v, src3), mid.rm_vals)

    # fresh sequential part = extracted window beyond the served prefix
    nlen = k_extract - served
    nsk2 = _take_window(sel_k, served, SC, INF)
    nsv2 = _take_window(sel_v, served, SC, EMPTY_VAL)
    in_new = _lead_arange(SC, sel_k, lead) < nlen[..., None]
    nsk2 = torch.where(in_new, nsk2, INF)
    nsv2 = torch.where(in_new, nsv2, EMPTY_VAL)
    # ranges and splitters survive an in-place extraction
    slotg = arange_i32(cfg.bucket_cap, sel_k)
    npar_min = kops.amin_f32(torch.where(slotg < nbc[..., None], nbk, INF),
                             (-2, -1))
    newpar = ParPart(nbk, nbv, nbc, par.splitters, npar_min,
                     par.par_count - k_extract)
    return mid._replace(
        par=_select_tree(sel, newpar, par),
        nsk=_where_lead(sel, nsk2, mid.nsk),
        nsv=_where_lead(sel, nsv2, mid.nsv),
        new_len=torch.where(sel, nlen, mid.new_len).to(_I32),
        rm_keys=rm_keys, rm_vals=rm_vals,
        n_rm_par=torch.where(sel, served, mid.n_rm_par).to(_I32))


def _repair_rebal_move(cfg: PQConfig, mid: TickMid) -> TickMid:
    """Fused rebalance + moveHead for lanes that need both: one flatten
    + rank-merge, then the extraction in closed form on the merged
    stream (bit-identical to rebalance followed by moveHead)."""
    par, p = mid.par, mid.pending
    R, SC = cfg.r_max, cfg.seq_cap
    nb, bc = cfg.n_buckets, cfg.bucket_cap
    fk, fv = flatten_parallel(cfg, par)
    allk, allv = rank_merge_kv(fk, fv, p.pend_k, p.pend_v)
    size = allk.shape[-1]
    lead = allk.shape[:-1]
    n_pend = (p.pend_k < INF).sum(-1, dtype=_I32)
    total = par.par_count + n_pend

    # _redistribute's geometry, without materializing the store
    per = ((total + nb - 1) // nb).clamp(1, bc)
    kept = torch.minimum(total, nb * per)
    dropped = total - kept

    served = torch.minimum(p.r2, kept)
    k_extract = torch.minimum(torch.maximum(p.detach_arg, p.r2), kept)
    k_extract = torch.minimum(k_extract, served + cfg.spill_threshold)

    ridx = _lead_arange(R, allk, lead)
    rel = ridx - p.move_off[..., None]
    sel = p.need_rebal & p.need_move
    in3 = (rel >= 0) & (rel < served[..., None]) & sel[..., None]
    src3 = rel.clamp(0, size - 1)
    rm_keys = torch.where(in3, take_last(allk, src3), mid.rm_keys)
    rm_vals = torch.where(in3, take_last(allv, src3), mid.rm_vals)

    # fresh sequential part: stream window [served, k_extract)
    nlen = k_extract - served
    nsk2 = _take_window(allk, served, SC, INF)
    nsv2 = _take_window(allv, served, SC, EMPTY_VAL)
    in_new = _lead_arange(SC, allk, lead) < nlen[..., None]
    nsk2 = torch.where(in_new, nsk2, INF)
    nsv2 = torch.where(in_new, nsv2, EMPTY_VAL)

    # surviving store: bucket i keeps the shifted tail of its window
    rows = arange_i32(nb, allk)[:, None]
    slot = arange_i32(bc, allk)[None, :]
    per_b = per[..., None, None]
    start = torch.maximum(rows * per_b, k_extract[..., None, None])
    end = torch.minimum((rows + 1) * per_b, kept[..., None, None])
    cnt2 = torch.minimum((end - start).clamp(min=0), per_b)
    live = slot < cnt2
    src = (start + slot).clamp(0, size - 1).reshape(lead + (nb * bc,))
    gk = take_last(allk, src).reshape(lead + (nb, bc))
    gv = take_last(allv, src).reshape(lead + (nb, bc))
    nbk = torch.where(live, gk, INF)
    nbv = torch.where(live, gv, EMPTY_VAL)
    nbc = cnt2[..., 0].to(_I32)

    # splitters are the redistribute's (pre-extraction) bucket minima
    sp_idx = arange_i32(nb, allk) * per[..., None]
    sp = take_last(allk, sp_idx.clamp(0, size - 1))
    splitters = torch.where(sp_idx < kept[..., None], sp, INF)
    splitters[..., 0] = -INF
    head_idx = k_extract.clamp(0, size - 1)[..., None]
    par_min = torch.where(kept > k_extract,
                          take_last(allk, head_idx)[..., 0], INF)
    newpar = ParPart(nbk, nbv, nbc, splitters, par_min,
                     (kept - k_extract).to(_I32))
    return mid._replace(
        par=_select_tree(sel, newpar, par),
        nsk=_where_lead(sel, nsk2, mid.nsk),
        nsv=_where_lead(sel, nsv2, mid.nsv),
        new_len=torch.where(sel, nlen, mid.new_len).to(_I32),
        rm_keys=rm_keys, rm_vals=rm_vals,
        n_rm_par=torch.where(sel, served, mid.n_rm_par).to(_I32),
        n_drop_rep=mid.n_drop_rep + torch.where(sel, dropped, 0))


def _repair_chop(cfg: PQConfig, mid: TickMid) -> TickMid:
    """SL::chopHead() repair: rank-merge the sequential head back into
    the bucket store and redistribute."""
    par, p = mid.par, mid.pending
    fk, fv = flatten_parallel(cfg, par)
    allk, allv = rank_merge_kv(fk, fv, mid.nsk, mid.nsv)
    newpar, dropped = _redistribute(cfg, allk, allv,
                                    par.par_count + mid.new_len)
    sel = p.need_chop
    return mid._replace(
        par=_select_tree(sel, newpar, par),
        nsk=_where_lead(sel, torch.full_like(mid.nsk, INF), mid.nsk),
        nsv=_where_lead(sel, torch.full_like(mid.nsv, EMPTY_VAL), mid.nsv),
        new_len=torch.where(sel, 0, mid.new_len).to(_I32),
        n_drop_rep=mid.n_drop_rep + torch.where(sel, dropped, 0))


def _tick_finish(cfg: PQConfig, mid: TickMid) -> Tuple[PQState,
                                                       TickResult]:
    """Steps 9b–10: serve accounting, minValue/lastSeq, state assembly."""
    R, SC = cfg.r_max, cfg.seq_cap
    lead = mid.rm_keys.shape[:-1]
    ridx = _lead_arange(R, mid.rm_keys, lead)
    requested = ridx < mid.rm_count[..., None]
    rm_served = requested & (mid.rm_keys < INF)
    n_empty = mid.rm_count - rm_served.sum(-1, dtype=_I32)

    nsk, par = mid.nsk, mid.par
    seq_head = nsk[..., 0]
    tail_idx = (mid.new_len - 1).clamp(0, SC - 1)[..., None]
    seq_tail = take_last(nsk, tail_idx)[..., 0]
    last_seq = torch.where(mid.new_len > 0, seq_tail, -INF)
    min_value = torch.where(mid.new_len > 0, seq_head, par.par_min)

    st = mid.stats0
    p = mid.pending
    stats = PQStats(
        add_imm_elim=st.add_imm_elim + mid.n_imm,
        add_upc_elim=st.add_upc_elim + mid.n_upc,
        add_seq=st.add_seq + mid.n_addseq,
        add_par=st.add_par + mid.n_par_adds,
        rm_seq=st.rm_seq + mid.n_rm_seq,
        rm_par=st.rm_par + mid.n_rm_par,
        rm_empty=st.rm_empty + n_empty,
        n_movehead=st.n_movehead + p.need_move.to(_I32),
        n_chophead=st.n_chophead + p.need_chop.to(_I32),
        n_rebalance=st.n_rebalance + p.need_rebal.to(_I32),
        n_spill=st.n_spill + mid.spilled,
        n_dropped=st.n_dropped + mid.n_drop_rep,
        n_ticks=st.n_ticks + 1,
        n_removes=st.n_removes + mid.rm_count,
        local_elim=st.local_elim,
    )

    new_state = PQState(
        seq_keys=nsk, seq_vals=mid.nsv, seq_len=mid.new_len.to(_I32),
        buckets=par.buckets, bvals=par.bvals, bcounts=par.bcounts,
        splitters=par.splitters, par_min=par.par_min,
        par_count=par.par_count,
        min_value=min_value, last_seq=last_seq,
        detach_n=mid.detach_n, ins_since_move=mid.ins_since_move,
        quiet_ticks=mid.quiet, stats=stats,
    )
    repairs = torch.stack(
        [p.need_combine, p.need_scatter, p.need_rebal, p.need_move,
         p.need_chop], dim=-1).to(_I32)
    return new_state, TickResult(mid.rm_keys, mid.rm_vals, rm_served,
                                 repairs)


def _tick_impl(cfg: PQConfig, state: PQState, add_keys, add_vals,
               add_mask, rm_count) -> Tuple[PQState, TickResult]:
    """head -> combine -> scatter -> predicates -> conditional repairs
    -> finish.  Each repair runs behind a host-side branch, so a tick
    pays only the rare paths it needs.  Under the "cuda" backend the hot
    pipeline (head through the moveHead repair) is the L=1 launch of the
    lane-tick kernel and only the rare repairs stay here."""
    if cfg.backend == "cuda":
        from repro_torch.kernels import lane_tick  # lazy: import cycle
        mid = lane_tick.fused_tick_mid(
            cfg, tree_map(lambda x: x[None].contiguous(), state),
            add_keys[None], add_vals[None], add_mask[None],
            rm_count.reshape(1))
        mid = tree_map(lambda x: x[0], mid)
        p = mid.pending
        repairs = (
            (p.need_rebal & p.need_move, _repair_rebal_move),
            (p.need_rebal & ~p.need_move, _repair_rebalance),
            (p.need_chop, _repair_chop),
        )
    else:
        mid = _tick_head(cfg, state, add_keys, add_vals, add_mask,
                         rm_count)
        mid = _pass_combine(cfg, mid)
        mid = _pass_scatter(cfg, mid)
        mid = _tick_preds(cfg, mid)
        p = mid.pending
        repairs = (
            (p.need_rebal & p.need_move, _repair_rebal_move),
            (p.need_rebal & ~p.need_move, _repair_rebalance),
            (p.need_move & ~p.need_rebal, _repair_move),
            (p.need_chop, _repair_chop),
        )
    for pred, repair in repairs:
        if bool(pred):
            mid = repair(cfg, mid)
    return _tick_finish(cfg, mid)


def _as_tensor(x, dtype, device):
    """A tensor of ``dtype`` on ``device`` from a tensor, numpy array or
    Python value (numpy input is copied, so read-only arrays are fine)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.array(x), dtype=dtype, device=device)


def _as_batch(device, add_keys, add_vals, add_mask, rm_count):
    return (_as_tensor(add_keys, _F32, device),
            _as_tensor(add_vals, _I32, device),
            _as_tensor(add_mask, torch.bool, device),
            _as_tensor(rm_count, _I32, device))


def tick(cfg: PQConfig, state: PQState, add_keys, add_vals, add_mask,
         rm_count) -> Tuple[PQState, TickResult]:
    """One combined round over an operation batch.

    Args:
      cfg: PQConfig.
      state: current PQState (left unchanged; a new state is returned).
      add_keys: [a_max] f32 — keys of PQ::add() requests (finite).
      add_vals: [a_max] i32 — payloads.
      add_mask: [a_max] bool — which slots hold real adds.
      rm_count: scalar i32 — number of PQ::removeMin() requests (<= r_max).

    The batch may be tensors, numpy arrays or Python values; it moves to
    the state's device.  Returns (new_state, TickResult).
    """
    batch = _as_batch(state.seq_keys.device, add_keys, add_vals,
                      add_mask, rm_count)
    return _tick_impl(cfg, state, *batch)


def tick_n(cfg: PQConfig, state: PQState, add_keys, add_vals, add_mask,
           rm_counts) -> Tuple[PQState, TickResult]:
    """T ticks in a row over [T, ...]-stacked batches.  Returns (final
    state, TickResult stacked [T, ...])."""
    aks, avs, ams, rms = _as_batch(state.seq_keys.device, add_keys,
                                   add_vals, add_mask, rm_counts)
    results = []
    for t in range(aks.shape[0]):
        state, res = _tick_impl(cfg, state, aks[t], avs[t], ams[t], rms[t])
        results.append(res)
    return state, TickResult(*(torch.stack(xs) for xs in zip(*results)))


# ---------------------------------------------------------------------------
# convenience wrappers
# ---------------------------------------------------------------------------

def size(state: PQState) -> torch.Tensor:
    return state.seq_len + state.par_count


def peek_min(state: PQState) -> torch.Tensor:
    return state.min_value


def resident(cfg: PQConfig, state: PQState):
    """Every resident element: ``(keys [cap], vals [cap], live [cap])``
    with cap = seq_cap + n_buckets * bucket_cap (the sequential part's
    dense prefix, then every finite bucket slot)."""
    live_seq = arange_i32(cfg.seq_cap, state.seq_keys) < state.seq_len
    bk = state.buckets.reshape(-1)
    bv = state.bvals.reshape(-1)
    keys = torch.cat([state.seq_keys, bk])
    vals = torch.cat([state.seq_vals, bv])
    live = torch.cat([live_seq, torch.isfinite(bk)])
    return keys, vals, live


def add_batch(cfg: PQConfig, state: PQState, keys, vals=None):
    """Insert-only tick (pads/masks to a_max)."""
    dev = state.seq_keys.device
    keys = torch.as_tensor(keys, dtype=_F32, device=dev)
    n = keys.shape[0]
    if n > cfg.a_max:
        raise ValueError(f"batch of {n} adds > a_max={cfg.a_max}")
    if vals is None:
        vals = torch.arange(n, dtype=_I32, device=dev)
    ak = torch.zeros((cfg.a_max,), dtype=_F32, device=dev)
    ak[:n] = keys
    av = torch.full((cfg.a_max,), EMPTY_VAL, dtype=_I32, device=dev)
    av[:n] = torch.as_tensor(vals, dtype=_I32, device=dev)
    mask = torch.zeros((cfg.a_max,), dtype=torch.bool, device=dev)
    mask[:n] = True
    new_state, _ = tick(cfg, state, ak, av, mask, 0)
    return new_state


def remove_batch(cfg: PQConfig, state: PQState, count):
    """Remove-only tick."""
    dev = state.seq_keys.device
    ak = torch.full((cfg.a_max,), INF, dtype=_F32, device=dev)
    av = torch.full((cfg.a_max,), EMPTY_VAL, dtype=_I32, device=dev)
    mask = torch.zeros((cfg.a_max,), dtype=torch.bool, device=dev)
    return tick(cfg, state, ak, av, mask, count)
