"""Baseline priority queues the paper compares against (§4), same tick API
(PyTorch port of the JAX package's ``core/baselines.py``).

* :class:`FCPQ` — flat-combining analogue (``fcskiplist``): every
  operation goes through the single combine stage; removals are a cheap
  batched prefix pop, but *all* adds are merged into one sorted
  structure, the paper's "sequential bottleneck" for adds.
* :class:`ParallelPQ` — lock-free skiplist analogue (``lfskiplist``):
  adds scatter in parallel into the bucketed store, but every removal
  batch pays a global min-extraction over the whole structure.

Both meet the pqe queue's batch-sequential specification (the k
smallest of the union).  The reference computes them outside any Pallas
kernel, so here they are plain PyTorch on the state's device and read no
kernel backend; each keeps the reference's dtypes and arithmetic, so a
tick is bit-identical to the reference's.  The reference's
``lax.cond(rm_count > 0)`` is a host branch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.config import EMPTY_VAL, PQConfig
from repro_torch.core.pqueue import (INF, ParPart, TickResult, _as_batch,
                                     _redistribute, _sort_kv, _take_window,
                                     flatten_parallel, rank_merge_kv,
                                     scatter_parallel)
from repro_torch.kernels.ops import arange_i32

_I32 = torch.int32
_F32 = torch.float32

# Rank-merge of two sorted INF-padded streams (ties a-first)
merge_sorted = rank_merge_kv


def _zero(device):
    return torch.zeros((), dtype=_I32, device=device)


# ---------------------------------------------------------------------------
# Flat-combining baseline
# ---------------------------------------------------------------------------

class FCState(NamedTuple):
    keys: torch.Tensor      # [cap] sorted ascending, INF padded
    vals: torch.Tensor      # [cap]
    length: torch.Tensor    # scalar i32
    add_seq: torch.Tensor   # stats
    rm_seq: torch.Tensor
    rm_empty: torch.Tensor
    n_ticks: torch.Tensor


class FCPQ:
    """Flat combining: one sorted structure, all ops combined sequentially."""

    @staticmethod
    def init(cfg: PQConfig, device="cuda") -> FCState:
        cap = cfg.total_cap
        return FCState(
            torch.full((cap,), INF, dtype=_F32, device=device),
            torch.full((cap,), EMPTY_VAL, dtype=_I32, device=device),
            *(_zero(device) for _ in range(5)))

    @staticmethod
    def tick(cfg: PQConfig, state: FCState, add_keys, add_vals, add_mask,
             rm_count) -> Tuple[FCState, TickResult]:
        """One combined round; the batch moves to the state's device.
        Admission silently drops the largest keys beyond ``total_cap``."""
        add_keys, add_vals, add_mask, rm_count = _as_batch(
            state.keys.device, add_keys, add_vals, add_mask, rm_count)
        cap = cfg.total_cap
        R = cfg.r_max
        rm_count = rm_count.clamp(max=R)

        ak = torch.where(add_mask, add_keys, INF)
        av = torch.where(add_mask, add_vals, EMPTY_VAL)
        ak, av = _sort_kv(ak, av)
        n_adds = add_mask.sum(dtype=_I32)

        # admission: drop largest beyond capacity
        mk, mv = merge_sorted(state.keys, state.vals, ak, av)
        total = (state.length + n_adds).clamp(max=cap)

        served = torch.minimum(rm_count, total)
        ridx = arange_i32(R, mk)
        src = ridx.clamp(0, cap - 1).long()
        rm_served = ridx < served
        rm_keys = torch.where(rm_served, mk[src], INF)
        rm_vals = torch.where(rm_served, mv[src], EMPTY_VAL)

        new_len = total - served
        nk = _take_window(mk, served, cap, INF)
        nv = _take_window(mv, served, cap, EMPTY_VAL)
        in_new = arange_i32(cap, mk) < new_len
        new_state = FCState(
            keys=torch.where(in_new, nk, INF),
            vals=torch.where(in_new, nv, EMPTY_VAL),
            length=new_len,
            add_seq=state.add_seq + n_adds,
            rm_seq=state.rm_seq + served,
            rm_empty=state.rm_empty + (rm_count - served),
            n_ticks=state.n_ticks + 1)
        return new_state, TickResult(rm_keys, rm_vals, rm_served)

    @staticmethod
    def size(state: FCState):
        return state.length


# ---------------------------------------------------------------------------
# Parallel-only baseline
# ---------------------------------------------------------------------------

class ParState(NamedTuple):
    par: ParPart
    add_par: torch.Tensor
    rm_par: torch.Tensor
    rm_empty: torch.Tensor
    n_ticks: torch.Tensor


class ParallelPQ:
    """Parallel adds, but each removal batch pays a global extraction."""

    @staticmethod
    def init(cfg: PQConfig, device="cuda") -> ParState:
        nb, bc = cfg.n_buckets, cfg.bucket_cap
        splitters = torch.full((nb,), INF, dtype=_F32, device=device)
        splitters[0] = -INF
        par = ParPart(torch.full((nb, bc), INF, dtype=_F32, device=device),
                      torch.full((nb, bc), EMPTY_VAL, dtype=_I32,
                                 device=device),
                      torch.zeros((nb,), dtype=_I32, device=device),
                      splitters,
                      torch.full((), INF, dtype=_F32, device=device),
                      _zero(device))
        return ParState(par, *(_zero(device) for _ in range(4)))

    @staticmethod
    def tick(cfg: PQConfig, state: ParState, add_keys, add_vals, add_mask,
             rm_count) -> Tuple[ParState, TickResult]:
        """Scatter the adds, then (a host branch) extract the removes by
        a global flatten of the store and redistribute the rest."""
        dev = state.par.buckets.device
        add_keys, add_vals, add_mask, rm_count = _as_batch(
            dev, add_keys, add_vals, add_mask, rm_count)
        R = cfg.r_max
        rm_count = rm_count.clamp(max=R)
        ak = torch.where(add_mask, add_keys, INF)
        av = torch.where(add_mask, add_vals, EMPTY_VAL)
        n_adds = add_mask.sum(dtype=_I32)

        par, _, _ = scatter_parallel(cfg, state.par, ak, av)

        ridx = arange_i32(R, ak)
        if bool(rm_count > 0):
            fk, fv = flatten_parallel(cfg, par)
            served = torch.minimum(rm_count, par.par_count)
            src = ridx.clamp(0, cfg.par_cap - 1).long()
            rm_keys = torch.where(ridx < served, fk[src], INF)
            rm_vals = torch.where(ridx < served, fv[src], EMPTY_VAL)
            rk = _take_window(fk, served, cfg.par_cap, INF)
            rv = _take_window(fv, served, cfg.par_cap, EMPTY_VAL)
            par, _ = _redistribute(cfg, rk, rv, par.par_count - served)
        else:
            served = _zero(dev)
            rm_keys = torch.full((R,), INF, dtype=_F32, device=dev)
            rm_vals = torch.full((R,), EMPTY_VAL, dtype=_I32, device=dev)

        new_state = ParState(
            par=par,
            add_par=state.add_par + n_adds,
            rm_par=state.rm_par + served,
            rm_empty=state.rm_empty + (rm_count - served),
            n_ticks=state.n_ticks + 1)
        return new_state, TickResult(rm_keys, rm_vals, ridx < served)

    @staticmethod
    def size(state: ParState):
        return state.par.par_count
