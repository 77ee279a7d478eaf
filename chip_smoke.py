#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. device — the card's name and power limit (nvidia-smi);
2. build  — nvcc builds every kernel in src/repro_torch/kernels/csrc into
   build/ (one nvcc per source, all at once);
3. kernel vs plain version — the lane-tick kernel against its plain
   PyTorch version on the card, bit for bit, on states driven through
   real ticks, at thirty-one geometry/lane settings (the
   repair-forcing geometry also at a head tile width of 64 slots, so
   merge windows cross tile edges, and on a stream whose keys tie; the
   lane geometries of the two sharded cells of phase 7 at L=8 and, for
   phase 9's positions, L=4; the adaptive engine's fold-headroom lane
   geometry of phase 8c at L=8 and L=1; phase 9's kill lane geometry and
   its serving cells' lane geometries, with and without a spare
   position; phase 10's queues: the sampler's default, its PRODUCTION
   queue on 10a's own ticks, the examples' queues and lanes, the dev
   check's two configs; phase 12's dev_check_dist lanes at grid 2 and
   16); both timed on the device clock, with the
   host-clocked call time beside it, and bounded by what the timed
   input's work must move (``repro_torch.roofline.traffic``), on the last
   checked tick and again on the last where a lane took moveHead and the
   last where none did, each with one traced launch's span per CTA role
   of the kernel's one launch (control, head tiles, rows, move tiles);
4. main path at w4096 — ``make_engine(EngineSpec(engine="pqe",
   width=4096))`` (the "cuda" kernel backend) beside a "torch" twin: warm
   2000 keys, 200 ticks at p_add 0.5 with DES keys, quiet ticks until
   chopHead fires.  Every result and state bit-equal between the two,
   served keys equal to the heapq oracle's, nothing dropped, all five
   passes fired, one kernel call per tick;
5. main path at PRODUCTION — filled to 262,144 residents, then 100 mixed
   ticks of uniform keys; the same checks, moveHead fired.  After it, the
   K1, K2 and K4 launch counts are still 0: the pqe path runs none of
   them, as in the reference;
6. the kernel-ops path — ``sort_kvf`` (K2), ``merge_sorted`` (K1),
   ``select_threshold`` (K4), ``select_k_smallest`` and
   ``extract_k_bucketed`` (K4 then K2) under the "cuda" backend, at the
   shapes of the w4096 and PRODUCTION cells on data from the states
   phases 4-5 leave, and K2 also at row lengths around its one-CTA limit
   (1 to 100000 keys) and at phase 9's, 10's and 12's router shapes,
   each held bit for bit against the same op under the "torch" backend
   and timed on the device clock beside it and one PyTorch library call
   (for K2, ``torch.sort``, listed beside it).  K2 and K1 run at six key
   mixes (K1's streams sorted again after the mix); K4 on the PRODUCTION
   and w4096 stores flattened and two w4096 add batches (k from 0 past
   the stream) and on the PRODUCTION bucket rows as 1024 streams, each also at the other digit
   width (held and timed beside it).  Under the profiler one K1 call and
   one K4 call must each be one kernel on the card, no memset;
7. the sharded main path — ``make_engine(EngineSpec(engine="sharded",
   lanes=8, ...))`` beside a "torch" twin drawing the same routes on the
   card, at two cells: w4096 (2000 keys warm, 200 ticks at p_add 0.5
   with DES keys, quiet ticks until chopHead fires) and PRODUCTION
   (filled to 262,144 residents, then 100 ticks at p_add 0.5 with
   uniform keys).  Every tick: results and states bit-equal between the
   two, the exact multiset conserved (residents = adds - served),
   nothing dropped by a lane or the router, every served key within
   ``relax_bound`` smallest of the pre-tick contents and the tick's
   adds.  The lane-tick kernel (K3, grid L=8) and the router's row sort
   (K2) launch once on each tick that does lane work; K1 and K4 never;
8. the rest of the single-device engines —
   a. ``fcskiplist`` and ``lfskiplist`` at w4096 on phase 4's stream,
      every tick bit-equal to the same engine on the CPU and served keys
      equal to the heapq oracle's; no kernel launches;
   b. ``adaptive`` (w4096, L=8, window 8) beside its "torch" twin over
      2000 keys warm and four 64-tick phases (p_add 0.5 uniform, 0.5
      DES, 0.3 DES, 0.5 uniform): every tick the results, state, plan and
      controller state bit-equal, the exact multiset conserved across
      engine switches, no drops, the ``relax_bound`` envelope held; at
      least two switches; the plan trace per window, µs per tick by plan
      and for the switching ticks, and what the fixed pqe and sharded
      engines cost in each phase;
   c. the same engine with ``min_lanes=1`` and the sharded candidate
      only, which must fold to L=1 in the uniform phases and unfold to
      L=8 in the DES phases; the same checks, except that keys the
      folded lane sheds (the reference's geometry does, and so must the
      port) are allowed when the lanes' own counters count them exactly;
   d. ``repro_torch.quality``: ``measure_engine`` of pqe (exact) and of
      sharded L=8 (within the envelope) at w4096, and a ``tune_lanes``
      walk with its trace.
   K3 and K2 launch in 8b and 8c exactly as the plan trace predicts
   (pqe ticks, re-insertion ticks, sharded lane-work ticks); K1 and K4
   never;
9. the serving path —
   a. ``make_engine(EngineSpec(engine="dist", ...))`` on phase 7's two
      cells at D=2 x l=4 (both positions on the card) and D=1 x l=8,
      each beside its "torch" twin and the sharded engine: every fill,
      mix and quiet tick bit-equal to both (the state gathered), the
      multiset conserved, the envelope held, nothing dropped; K3 (grid l)
      and K2 (the position's [l, W/L] router sort) launch once per
      position on each of its lane-work ticks; µs per tick beside
      sharded L=8;
   b. at w4096, D=2 with ``spare_devices=1``: position 1 removed at tick
      10 (``remove_device``), the multiset conserved across the resize,
      nothing dropped, the envelope held at L=4 from the next tick;
   c. ``repro_torch.serving.build_engine`` on two positions of the card
      for the five cells of benchmarks/serve_bench.py at their own kwargs
      and a width-1024 cell with its chaos twin: every tick the exact
      outcome partition, no phantom or duplicate rid, the depth under
      its cap; each drains to empty; quantiles printed beside
      BENCH_pq.json's, µs per serving tick and the device busy share;
10. the queue's other users and the roofline —
   a. ``repro_torch.data.PrioritySampler(n_groups=1024, cfg=PRODUCTION)``
      on the card beside its "torch" twin on the card: 200 steps of
      ``next_groups(256)``, ``report`` (losses from the seed) and
      ``requeue``; every step the same gids, every tick the heapq
      oracle's smallest keys served, equal breakdowns; µs per step in
      turns, the device busy share, K3 on every tick and its device ms
      per launch on this path;
   b. every module of ``repro_torch.examples`` on the card: event_sim,
      quickstart and serve_requests.main beside their "torch" twins
      (every number equal), serve_requests.main_mesh on two positions of
      the card with position 1 killed at t=8 (the example's own asserts:
      exact partition, the kill fired, urgent requests within one tick),
      dev_check_pq printing ALL OK;
   c. a ``repro_torch.roofline`` record per engine cell of phases 4, 5
      and 7 and for the sampler (``record_from_traffic``), and each
      phase-3 and phase-6 setting's traffic bound beside its buffers'
      count; no measured time may fall under its bound;
11. the model stack's serving path (``repro_torch.models``,
    ``repro_torch.launch.serve``; plain PyTorch, no TPU kernel behind it),
    TF32 off —
   a. gemma-2b at its published configuration (2.51 B parameters, bf16)
      from a seeded generator on the card: four prompts of 512 tokens,
      ``make_prefill_step``, 32 greedy ``make_decode_step``s; every
      generated position's logits against ``forward`` over prompt and
      fed tokens (teacher forcing) within 5e-2 of the logits' scale, the
      greedy tokens equal where the margin allows; the same tokens
      through a float32 copy of the weights within 1e-3; the prefill's
      and a decode step's device time under the profiler beside their
      bounds (``traffic.model_prefill`` / ``model_decode`` bytes against
      ``model_step_flops``; none may fall under its bound), the prefill's
      2·N·D (``model_flops``) as a share of the bf16 peak, the decode
      loop's host-clocked tokens/s, the peak device memory;
   b. every other arch at full width, one pattern group deep
      (xlstm-350m and whisper-tiny whole; MoE at a capacity factor that
      drops nothing): two prompts of 512 tokens, 8 greedy steps, the same
      teacher forcing (xlstm-350m: its float32 copy, its bf16 drift
      recorded), chunked prefill at chunk_len=256 against one shot where
      the reference runs it; every cut printed;
   c. the ten archs at ``reduced_config`` in float32, the same weights on
      the CPU and the card: forward, prefill caches and two decode steps
      (rows at different positions) within 1e-4;
   K1-K4 never launch in the phase;
12. training on one device (``repro_torch.launch.train``,
    ``repro_torch.optim``, ``repro_torch.ckpt``; plain PyTorch but the
    sampler's and the dev check's queues), TF32 still off —
   a. gemma-2b as published (bf16, remat "full", random weights from the
      seed): 3 AdamW steps on one fixed batch of 4 x 512 tokens in 4
      microbatches (warmup 0), the loss falling and the gradient norm
      finite, then one AdamW8 step from the same weights; each step's ms
      on the card's clock (host included), tokens/s, peak memory, one
      more AdamW step under the profiler (device time, busy share, top
      kernels)
      beside the step's bound (``traffic.model_train``: bytes over 3.35
      TB/s or FLOPs over 989 TFLOP/s); a step under it fails the run;
   b. gemma-2b at full width, 2 layers, float32: every gradient leaf
      under remat "full" within 1e-6 of its scale of remat "none"'s;
   c. the ten archs at ``reduced_config`` in float32, the same weights
      and batch on the CPU and the card: the loss and every gradient
      leaf, then one AdamW and one AdamW8 step, within 1e-4; and
      ``examples.dev_check_models.check`` on the card for each;
   d. ``examples.train_lm`` at its default size (~100M, 16 x 256
      tokens) for 100 steps, its ``PrioritySampler`` on the card under
      "cuda": the loss falls, K3 launches once per sampler tick; an
      async checkpoint taken while a further step updates the state in
      place restores bit for bit;
   e. ``examples.dev_check_dist`` at D=8 x l=2 on ``["cuda:0"] * 8``:
      its three checks; K3 (grid 2) and K2 ([2, 4]) once per position's
      lane-work tick, and (grid 16, [16, 4]) per lane-work tick of the
      single-device sharded queue it is held to;
13. the model stack on a mesh (``repro_torch.dist``, the layouts and mesh
    steps of ``launch.train`` / ``launch.serve``; plain PyTorch), a
    (data 2, model 4) mesh of eight positions on ``["cuda:0"] * 8``,
    TF32 still off —
   a. gemma-2b as published, 12a's batch in 4 microbatches: 2 AdamW
      steps on one device, freed, then on the mesh from the same seeded
      weights (FSDP, ZeRO-1): loss and gradient norm within 1e-2 of one
      device's, ms a step, tokens/s, peak memory, each position's bytes
      held (parameters, moments, the gradient buffer's layout; a ZeRO-1
      share over 1.05 of an eighth fails);
   b. gemma-2b served on the mesh (caches with S over ``model``; each
      position computes its own column, row, vocab blocks and heads,
      reading its block of one group's weights at a time: a read of a
      ``model``-split leaf that is not one position's block fails):
      11a's prompts and 32 greedy steps against the one-device port on
      the same weights: every greedy token equal, or a row parted at a
      tie of one device's top two; an f32 copy fed the same tokens
      within 1e-3 of the logits' scale; prefill and decode device ms
      beside one device's and the gathered step's (``GATHERED_MS``);
   c. moonshot-v1-16b-a3b at full width, one pattern group, f32 (one-hot
      lookups, ``moe_apply_dist``): one AdamW step on the mesh against
      the one-device step on the same groups (loss and gradient norm
      within 1e-5, parameters by the first-step rule, moments within
      1e-4); ``moe_apply_dist`` against ``_moe_local`` (rtol 2e-4, atol
      2e-5; aux rtol 1e-2); the one-hot lookup bit-equal to the gather;
   d. ``compressed_psum`` over ``pod`` of a (2, 2, 2) mesh on 13c's
      gradients (a prompt a pod): every reduced element the int32 sum of
      the codes times the shared scale over n, bit for bit, and the
      error buffers holding what quantization left;
   e. 13c's state (14.9 GB) saved asynchronously from the mesh, restored
      onto (1, 8) and onto one device bit for bit;
   K1-K4 never launch in the phase.
14. the dry run (``repro_torch.launch.dryrun``, ``roofline.trace_stats``)
    held to the card —
   a. 12a's gemma-2b train step (4 x 512 tokens, 4 microbatches, remat),
      on one device and on 13a's (2, 4) mesh, then 11a's prefill of four
      512-token prompts and one decode step, on one device and on 13b's
      (2, 4) mesh (each position its own blocks): each placed on the card,
      timed, run again under ``FlopCounterMode``, and counted by the dry
      run with every position on one fake device (as on the one card),
      its counts fitted over the loops' trip counts (``TripCounts``):
      argument bytes equal the bytes placed (``dist.held_bytes``) and
      ``memory_allocated``'s growth within the allocator's rounding (512
      bytes a tensor, 1 MiB one of 1 MiB or more), FLOPs equal, the
      traced temporaries within 5 % + 64 MiB of the card's
      (``max_memory_allocated`` above the step's start), no time under
      the compute term or the ``traffic`` bound; the time over the
      traced bytes' ``memory_s`` printed;
   b. three production cells on the 16 x 16 mesh counted on the card's
      host (fake devices, no card memory, fitted over trip counts; a
      step's data rows but the first, the last and one more predicted
      from those and held to the trace of every row at caps of 1), each
      by ``python -m repro_torch.launch.dryrun`` in a process
      started after phase 1 that runs beside the card's phases at the
      lowest priority (``nice -n 19``): gemma-2b ``decode_32k``,
      qwen3-moe-235b-a22b ``train_4k`` and xlstm-350m ``train_4k`` (four
      loops fitted; the train cells' traces in four forked workers
      each), each OK within its budget from its start, the busiest
      position's peak, ``fits`` and the trace seconds printed, then the
      report's rows;
   K1-K4 never launch in the phase.

The last lines are a JSON record of the kernels and the run's status
line.  Phase 9's, 10's and 12's rows in it are one per kernel setting
(K3's lane geometry and grid, K2's router shape), each with the launches
made at that setting and the error and times phase 3 or 6 measured
there (the sampler's K3 row on 10a's own ticks, with the path's own
profiled ms per launch beside them as ``path_ms``); a launch at a
setting neither phase held fails the run.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KEY_HI = 100_000.0
WARM_ELEMENTS = 2000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def leaves_equal(pq, a, b, label, t):
    """Every tensor leaf of ``a`` bit-equal to ``b``'s (``b`` may lie on
    another device)."""
    la, lb = pq.tree_leaves(a), pq.tree_leaves(b)
    if len(la) != len(lb):
        fail(f"{label} tick {t}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if not same_bits(x.to(y.device), y):
            fail(f"{label} tick {t}: leaf {i} differs between the twins")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.dtype.is_floating_point:
        return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    both = (a == b)                      # equal infinities count as 0
    diff = torch.where(both, 0.0, (a.double() - b.double()).abs())
    return float(diff.max()) if a.numel() else 0.0


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the device (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int):
    """Mean device milliseconds per call of ``fn``: the timed calls queue
    behind a device-side sleep long enough for the host to enqueue them
    all, so the CUDA events bracket the device's work back to back and
    the host's launch cost stays out.  A call of many small launches can
    fill the device's launch queue and block the host, so fewer calls are
    queued on a retry.  Returns (ms, True); if even one call could not be
    queued ahead (it waits for the device), its events' time and False."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int(4 * (time.perf_counter() - t0) * 2e9) + 1_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for n in (reps, max(1, reps // 4), 1):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        ahead = not start.query()      # the sleep still runs: all queued
        torch.cuda.synchronize()
        if ahead:
            break
    return start.elapsed_time(end) / n, ahead


# ---------------------------------------------------------------------------
# traffic, made from the seed with numpy and moved to the card in bulk
# ---------------------------------------------------------------------------

def batch_rows(width, keys_per_tick, rm_counts):
    """[T, W] keys/vals/mask + [T] removes from a list of key arrays."""
    t = len(keys_per_tick)
    ak = np.full((t, width), np.inf, np.float32)
    av = np.tile(np.arange(width, dtype=np.int32), (t, 1))
    mask = np.zeros((t, width), bool)
    for i, k in enumerate(keys_per_tick):
        ak[i, :len(k)] = k
        mask[i, :len(k)] = True
    return ak, av, mask, np.asarray(rm_counts, np.int32)


def mix_keys(rng, width, p_add, ticks, key_dist, lo=0.0):
    """The bench's p-coin mix: DES keys cluster above a virtual clock that
    advances with the removal rate; uniform keys span the key space."""
    n_add = int(round(width * p_add))
    n_rm = width - n_add
    keys = []
    for _ in range(ticks):
        if key_dist == "des":
            lo += n_rm * KEY_HI / WARM_ELEMENTS
            keys.append((lo + rng.exponential(KEY_HI / WARM_ELEMENTS * 8,
                                              n_add)).astype(np.float32))
        else:
            keys.append(rng.uniform(0, KEY_HI, n_add).astype(np.float32))
    return keys, [n_rm] * ticks, lo


#: keys of the duplicate-heavy stream: adds tie with the sequential part
TIE_POOL = np.array([0.0, -0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0, 34.0],
                    np.float32)


def repair_stream(rng, width, ticks, ties=False):
    """Phased traffic that fires every pass at a tiny store: adds pile up
    (scatter, rebalance), then a big or a tiny drain (moveHead), then
    quiet ticks (chopHead).  With ``ties`` the keys come from a few
    values."""
    keys, rms = [], []
    for t in range(ticks):
        cycle, phase = t // 12, t % 12
        n_add, n_rm = 0, 0
        if phase < 4:
            n_add = int(rng.integers(width // 2, width + 1))
        elif phase == 4:
            n_rm = width if cycle % 2 else int(rng.integers(1, 5))
        keys.append(rng.choice(TIE_POOL, n_add) if ties else
                    np.round(rng.uniform(0, 1000, n_add), 3)
                    .astype(np.float32))
        rms.append(n_rm)
    return keys, rms


def to_device(rows):
    return tuple(torch.from_numpy(x).cuda() for x in rows)


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def stack_lanes(pq, states):
    n = len(pq.PQState._fields) - 1
    leaves = [pq.tree_leaves(s) for s in states]
    stacked = [torch.stack(xs) for xs in zip(*leaves)]
    return pq.PQState(*stacked[:n], stats=pq.PQStats(*stacked[n:]))


def k3_traffic(traffic, cfg, lanes, batch, got):
    """What one K3 input's data needs: the adds stored, the removals
    taken from the store (an add that an immediate or upcoming
    elimination serves is neither), the slots the kernel's moveHeads
    detach."""
    n_elim = int(got.n_imm.sum() + got.n_upc.sum())
    moved = got.pending.need_move & ~got.pending.need_rebal
    return traffic.k3_launch(
        cfg, lanes, adds=int(batch[2].sum()) - n_elim,
        removals=int(torch.isfinite(got.rm_keys).sum()) - n_elim,
        detached=int(got.new_len[moved].sum()))


def kernel_vs_plain(name, cfg, streams, check_from, lt, pq, traffic,
                    head_tile=None):
    """Drive every lane through its stream with the plain tick; from tick
    ``check_from`` on, hold the kernel against its plain version on the
    stacked lanes, at the head tile width ``head_tile`` (default: the
    wrapper's).  Returns a record with the last input's timings and its
    bound from ``traffic.k3_launch`` on that input's data (the launch's
    own buffers beside it, ``buffer_bytes``: the yardstick before the
    traffic count), and under ``by_tick`` the same device times and bound
    on the last checked tick where a lane took moveHead (``move``) and the
    last where none did (``no_move``), where the stream has it."""
    head_tile = head_tile or lt.HEAD_TILE
    lanes = len(streams)
    states = [pq.init(cfg, "cuda") for _ in streams]
    ticks = streams[0][0].shape[0]
    err, checked, fired = 0.0, 0, np.zeros(5, np.int64)
    kinds = {}
    for t in range(ticks):
        batch = [torch.stack([s[f][t] for s in streams]) for f in range(4)]
        if t >= check_from:
            stacked = stack_lanes(pq, states)
            inputs = lt.kernel_inputs(cfg, stacked, *batch)
            outs, ws = lt.kernel_buffers(cfg, lanes, batch[0].device)
            lt.launch(cfg, inputs, outs, ws, head_tile=head_tile)
            got = lt.mid_from_outputs(outs, stacked.stats)
            want = lt.fused_tick_mid_plain(cfg, stacked, *batch)
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(pq.tree_leaves(got),
                                           pq.tree_leaves(want))):
                if not same_bits(g, w):
                    fail(f"{name}: kernel != plain at tick {t}, output "
                         f"leaf {i}: max |diff| {max_abs_err(g, w)}")
                err = max(err, max_abs_err(g, w))
            p = got.pending
            fired += [int(x.any()) for x in (p.need_combine, p.need_scatter,
                                             p.need_rebal, p.need_move,
                                             p.need_chop)]
            checked += 1
            moved = bool((p.need_move & ~p.need_rebal).any())
            kinds["move" if moved else "no_move"] = (stacked, batch, inputs,
                                                     outs, ws, got)
        states = [pq.tick(cfg, s, *(b[i] for b in batch))[0]
                  for i, s in enumerate(states)]

    # timings: device time per call (the host's launch cost out), and on
    # the last checked input the host-clocked call time beside it
    def timed(stacked, batch, inputs, outs, ws, got):
        def kernel():
            lt.launch(cfg, inputs, outs, ws, head_tile=head_tile)

        def plain():
            lt.fused_tick_mid_plain(cfg, stacked, *batch)

        ms, ms_device_only = device_ms(kernel, 20)
        # one traced launch, warm: each role's span on the card's clock
        trace = torch.zeros((lt.launch_plan(cfg, lanes, head_tile).grid,
                             lt.TRACE_WORDS), dtype=torch.int64,
                            device=batch[0].device)
        lt.launch(cfg, inputs, outs, ws, head_tile=head_tile, trace=trace)
        plain_ms, plain_device_only = device_ms(plain, 5)
        count = k3_traffic(traffic, cfg, lanes, batch, got)
        return kernel, plain, dict(
            ms=ms, ms_device_only=ms_device_only, plain_ms=plain_ms,
            plain_ms_device_only=plain_device_only, bytes=count.hbm_bytes,
            bound_ms=count.bound_s() * 1e3, roles=lt.role_spans(trace))

    kernel, plain, last = timed(stacked, batch, inputs, outs, ws, got)
    by_tick = {kind: timed(*held)[2] for kind, held in sorted(kinds.items())}
    rec = dict(setting=name, lanes=lanes, head_tile=head_tile,
               geometry=lane_geometry(cfg), checked_ticks=checked,
               fired=fired.tolist(), max_abs_err=err, **last,
               call_ms=cuda_ms(kernel, 20), plain_call_ms=cuda_ms(plain, 5),
               bound_by="bytes", buffer_bytes=nbytes(*inputs, *outs),
               by_tick=by_tick)
    print(f"kernel_vs_plain {json.dumps(rec)}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phases 4-5: the main path through the engine API
# ---------------------------------------------------------------------------

def drive(label, engines, states, rows, ref, pq, stop=None):
    """Tick the cuda engine and its torch twin over device rows (keys,
    vals, mask, rm), checking each tick: results and states bit-equal,
    served keys equal to the heapq oracle's, nothing dropped.  Returns
    (states, fired repairs, ticks run)."""
    eng_c, eng_t = engines
    s_c, s_t = states
    ak, av, mask, rm = rows
    host_keys, host_mask = ak.cpu().numpy(), mask.cpu().numpy()
    host_rm = rm.cpu().numpy()
    fired = np.zeros(5, np.int64)
    ran = 0
    for t in range(ak.shape[0]):
        s_c, r_c = eng_c.tick(s_c, ak[t], av[t], mask[t], rm[t])
        s_t, r_t = eng_t.tick(s_t, ak[t], av[t], mask[t], rm[t])
        for i, (a, b) in enumerate(zip(r_c, r_t)):
            if not same_bits(a, b):
                fail(f"{label} tick {t}: result field {i} differs between "
                     "the cuda and torch backends")
        for i, (a, b) in enumerate(zip(pq.tree_leaves(s_c),
                                       pq.tree_leaves(s_t))):
            if not same_bits(a, b):
                fail(f"{label} tick {t}: state leaf {i} differs between "
                     "the cuda and torch backends")
        keys = host_keys[t][host_mask[t]]
        exp = np.sort(np.array([k for k, _ in ref.tick(
            keys.tolist(), range(len(keys)), int(host_rm[t]))
            if k != np.inf], np.float32))
        got = np.sort(r_c.rm_keys[r_c.rm_served].cpu().numpy())
        if int(s_c.stats.n_dropped) != 0:
            fail(f"{label} tick {t}: the queue dropped keys")
        if not np.array_equal(got, exp):
            fail(f"{label} tick {t}: served keys differ from the oracle")
        fired += r_c.repairs.cpu().numpy()
        ran += 1
        if stop is not None and stop(fired):
            break
    return (s_c, s_t), fired, ran


def time_ticks(eng, state, rows):
    """Host-clock microseconds per tick over device rows (synchronised)."""
    ak, av, mask, rm = rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(ak.shape[0]):
        state, _ = eng.tick(state, ak[t], av[t], mask[t], rm[t])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ak.shape[0] * 1e6


#: kernels of the port by profiler name: (group, kernel names)
KERNEL_GROUPS = (("lane_tick", ("lane_tick_kernel",)),
                 ("router_sort", ("row_sort_kernel", "sweep_kernel")))


def kernel_share(eng, state, rows):
    """:func:`device_profile` over the ticks of ``rows``."""
    ak, av, mask, rm = rows
    n = ak.shape[0]
    box = [state, 0]

    def step():     # a window profiled again starts again from ``state``
        t = box[1] % n
        if t == 0:
            box[0] = state
        box[0], _ = eng.tick(box[0], ak[t], av[t], mask[t], rm[t])
        box[1] += 1
    return device_profile(step, n)


#: profiled windows a count may take, and the quiet kept before and after
#: each window inside the profile.  The profiler can lose a kernel's record
#: (a full run once showed 39 lane-tick launches for 40 calls of the
#: sampler's step), never invent one, so a window that
#: shows fewer lane-tick launches than calls is profiled again, and one
#: that shows more fails at once.  The quiet keeps the window's first and
#: last kernels clear of the profile's own start and stop.
PROFILE_WINDOWS, PROFILE_EDGE_S = 3, 0.02
#: device sleeps opening each profiled window, not counted
PROFILE_MARKERS = 4


def device_profile(step, n):
    """Device time over ``n`` calls of ``step`` (a tick) under the
    profiler: the port's kernels by name (the lane tick's one kernel, and
    K2's, the sharded router's sort), every device event (kernels,
    copies, fills) in all, and both as shares of the window's wall time;
    None when the profiler records no device time.  Only device events
    are summed: a CPU op's self device time repeats the kernels it
    launched.  The lane tick's kernel must show one device launch per
    ``fused_tick_mid`` call in the window: a window short of that is
    profiled again (``step`` is called ``n`` more times), up to
    :data:`PROFILE_WINDOWS` windows, each one's (launches, calls) kept
    under ``windows``; the numbers are the exact window's."""
    from repro_torch.kernels import lane_tick
    windows = []
    for _ in range(PROFILE_WINDOWS):
        calls0 = lane_tick.fused_tick_mid.launches
        rec = _profile_window(step, n)
        calls = lane_tick.fused_tick_mid.launches - calls0
        if rec is None:
            return None
        k3_events = rec["lane_tick_launches"]
        windows.append([k3_events, calls])
        if k3_events > calls:
            fail(f"profile: {k3_events} lane-tick kernel launches on the "
                 f"device for {calls} fused_tick_mid calls")
        if k3_events == calls:
            rec.update(fused_tick_mid_calls=calls, windows=windows)
            return rec
    fail(f"profile: lane-tick kernel launches on the device against "
         f"fused_tick_mid calls, window by window: {windows}")


def _profile_window(step, n):
    """One profiled window of :func:`device_profile`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler can lose a window's first device records: the
        # window opens with device sleeps that are not counted (as
        # one_kernel_per_call's)
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_EDGE_S)
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_EDGE_S)
    ours = {group: {} for group, _ in KERNEL_GROUPS}
    counts = {group: {} for group, _ in KERNEL_GROUPS}
    others = {}
    total = launches = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or "sleep" in ev.key \
                or "spin" in ev.key:
            continue
        total += ev.self_device_time_total
        launches += ev.count
        hit = next(((g, k) for g, names in KERNEL_GROUPS for k in names
                    if k in ev.key), None)
        if hit:
            g, k = hit
            ours[g][k] = ours[g].get(k, 0.0) + ev.self_device_time_total / n
            counts[g][k] = counts[g].get(k, 0) + ev.count
        else:
            key = ev.key[:60]
            others[key] = others.get(key, 0.0) + ev.self_device_time_total / n
    if total <= 0:
        return None
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    kernel_us = sum(sum(g.values()) for g in ours.values())
    return dict(ticks=n, wall_us_per_tick=wall_us / n,
                kernel_us_per_tick=kernel_us,
                lane_tick_us_per_tick=ours["lane_tick"],
                lane_tick_launches=sum(counts["lane_tick"].values()),
                router_sort_us_per_tick=ours["router_sort"],
                device_us_per_tick=total / n,
                device_events_per_tick=launches / n,
                kernel_share_of_wall=kernel_us * n / wall_us,
                device_busy_share=total / wall_us,
                top_other_device_us_per_tick=top)


#: tick stages timed by stage_split: (module name, function name)
STAGES = (("pq", "_tick_head"), ("pq", "_pass_combine"),
          ("pq", "_pass_scatter"), ("pq", "_tick_preds"),
          ("lt", "kernel_inputs"), ("lt", "launch"),
          ("pq", "_repair_rebal_move"), ("pq", "_repair_rebalance"),
          ("pq", "_repair_move"), ("pq", "_repair_chop"),
          ("pq", "_tick_finish"))


#: stages of the sharded tick, timed beside STAGES
SHARDED_STAGES = STAGES + (("sh", "_preroute_eliminate"),
                           ("sh", "_controller_update"),
                           ("sh", "_route_adds_sorted"),
                           ("sh", "_alloc_removes"),
                           ("sh", "_fold_results"))


def stage_split(eng, state, rows, mods, stages=STAGES):
    """Wall time per tick of each stage the tick calls, synchronising
    the device before and after every stage, over a window of ticks
    (a separate run: the syncs inflate its total).  The stages are
    module functions the tick looks up at call time, so each is swapped
    for a timed wrapper for the window and restored after."""
    spent = {name: 0.0 for _, name in stages}
    calls = {name: 0 for _, name in stages}
    saved = {name: getattr(mods[m], name) for m, name in stages}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return run

    ak, av, mask, rm = rows
    n = ak.shape[0]
    try:
        for m, name in stages:
            setattr(mods[m], name, timed(name, saved[name]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n):
            state, _ = eng.tick(state, ak[t], av[t], mask[t], rm[t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for m, name in stages:
            setattr(mods[m], name, saved[name])
    us = {k: v / n * 1e6 for k, v in spent.items() if calls[k]}
    return dict(ticks=n, wall_us_per_tick=wall / n * 1e6,
                stage_us_per_tick=us,
                stage_calls={k: v for k, v in calls.items() if v},
                rest_us_per_tick=(wall - sum(spent.values())) / n * 1e6)


def timings(cell, engines, start_states, rows, window, mods,
            stages=STAGES):
    """us/tick of each backend from the same start state, in turns
    (cuda, torch, torch, cuda); then, over the first ``window`` ticks, a
    profiled run of the cuda engine and a stage split of each.  Returns
    the record."""
    (eng_c, eng_t), (s_c, s_t) = engines, start_states
    us_c = [time_ticks(eng_c, s_c, rows)]
    us_t = [time_ticks(eng_t, s_t, rows), time_ticks(eng_t, s_t, rows)]
    us_c.append(time_ticks(eng_c, s_c, rows))
    part = tuple(x[:window] for x in rows)
    rec = dict(cell=cell, device=card(), ticks=int(rows[0].shape[0]),
               us_per_tick_cuda=us_c, us_per_tick_torch=us_t,
               profile_cuda=kernel_share(eng_c, s_c, part),
               stages_cuda=stage_split(eng_c, s_c, part, mods, stages),
               stages_torch=stage_split(eng_t, s_t, part, mods, stages))
    print(f"main_path {json.dumps(rec)}", flush=True)
    return rec


def make_pair(factory, **spec):
    eng_c = factory.make_engine(factory.EngineSpec(engine="pqe", **spec))
    eng_t = factory.make_engine(factory.EngineSpec(engine="pqe",
                                                   backend="torch", **spec))
    if eng_c.cfg.backend != "cuda" or eng_c.device.type != "cuda":
        fail("the default engine is not the cuda backend on the card")
    return (eng_c, eng_t), (eng_c.init(seed=0), eng_t.init(seed=0))


def main_path_w4096(args, factory, pq, lt, RefPQ):
    engines, states = make_pair(factory, width=4096)
    rng = np.random.default_rng(args.seed)
    warm = rng.uniform(0, KEY_HI, WARM_ELEMENTS).astype(np.float32)
    warm_rows = to_device(batch_rows(4096, [warm], [0]))
    mix, rms, lo = mix_keys(rng, 4096, 0.5, 200, "des")
    mix_rows = to_device(batch_rows(4096, mix, rms))
    quiet = [(lo + rng.exponential(KEY_HI / WARM_ELEMENTS * 8, 64))
             .astype(np.float32) for _ in range(200)]
    quiet_rows = to_device(batch_rows(4096, quiet, [0] * 200))

    ref = RefPQ()
    lt.fused_tick_mid.launches = 0
    states, fired, ticks = drive("w4096 warm", engines, states, warm_rows,
                                 ref, pq)
    warm_states = states
    states, f, n = drive("w4096 mix", engines, states, mix_rows, ref, pq)
    fired, ticks = fired + f, ticks + n
    mix_states = states
    states, f, n = drive("w4096 quiet", engines, states, quiet_rows, ref, pq,
                         stop=lambda fr: fr[4] > 0)
    fired, ticks = fired + f, ticks + n
    launches = lt.fused_tick_mid.launches
    print(f"w4096 main path: ticks {ticks}, kernel calls {launches}, fired "
          f"(combine, scatter, rebalance, moveHead, chopHead) "
          f"{fired.tolist()}, resident {int(pq.size(states[0]))}",
          flush=True)
    if launches != ticks:
        fail(f"w4096: {launches} kernel calls for {ticks} cuda ticks")
    if not (fired > 0).all():
        fail(f"w4096: not every pass fired: {fired.tolist()}")
    rec = timings("w4096_p50_des", engines, warm_states, mix_rows, 50,
                  {"pq": pq, "lt": lt})
    return dict(launches=launches, cfg=engines[0].cfg, state=mix_states[0],
                rows=mix_rows, timing=rec)


def main_path_production(args, factory, pq, lt, RefPQ, config):
    engines, states = make_pair(factory, width=1024, base=config.PRODUCTION)
    rng = np.random.default_rng(args.seed + 1)
    n_fill = 262_144 // 1024
    fill = [rng.uniform(0, KEY_HI, 1024).astype(np.float32)
            for _ in range(n_fill)]
    fill_rows = to_device(batch_rows(1024, fill, [0] * n_fill))
    mix, rms, _ = mix_keys(rng, 1024, 0.5, 100, "uniform")
    mix_rows = to_device(batch_rows(1024, mix, rms))

    ref = RefPQ()
    lt.fused_tick_mid.launches = 0
    states, f1, n1 = drive("PRODUCTION fill", engines, states, fill_rows,
                           ref, pq)
    filled = states
    resident = int(pq.size(states[0]))
    states, f2, n2 = drive("PRODUCTION mix", engines, states, mix_rows, ref,
                           pq)
    launches = lt.fused_tick_mid.launches
    print(f"PRODUCTION main path: ticks {n1 + n2}, kernel calls {launches}, "
          f"resident after fill {resident}, fired {(f1 + f2).tolist()}",
          flush=True)
    if resident != 262_144:
        fail(f"PRODUCTION: {resident} resident after the fill, not 262144")
    if launches != n1 + n2:
        fail(f"PRODUCTION: {launches} kernel calls for {n1 + n2} cuda ticks")
    if f2[3] == 0:
        fail("PRODUCTION: moveHead never fired")
    rec = timings("production_p50_uniform", engines, filled, mix_rows, 30,
                  {"pq": pq, "lt": lt})
    return dict(launches=launches, cfg=engines[0].cfg, state=states[0],
                rows=mix_rows, timing=rec)


# ---------------------------------------------------------------------------
# phase 6: the kernel-ops path (K1, K2, K4 and their compositions)
# ---------------------------------------------------------------------------

class OpCase:
    """One op at one shape: its "cuda" and "torch" calls, a library call
    that computes the same function (timed only), the bytes it must move
    (``count``, from ``repro_torch.roofline.traffic``; ``buffer_bytes``,
    the operands' and results' own sizes, the yardstick before it), and
    how its outputs compare (default: every output bit for bit)."""

    def __init__(self, kernel, label, cuda, plain, library, count,
                 buffer_bytes, canon=None, also=None, timed=True,
                 setting=None):
        self.kernel, self.label = kernel, label
        self.cuda, self.plain, self.library = cuda, plain, library
        self.count, self.buffer_bytes = count, buffer_bytes
        self.canon, self.also = canon, also
        self.timed = timed
        self.setting = setting   # the kernel's shape, for the final line


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def key_mixes(keys, gen):
    """Variants of real keys for the sort: duplicates, more INF padding,
    negative keys, and both zeros (INF padding stays INF)."""
    fin = torch.isfinite(keys)
    coin = torch.rand(keys.shape, generator=gen, device=keys.device)
    zeros = torch.where(coin < 0.5, 0.0, -0.0)
    return {"uniform": keys,
            "duplicates": torch.where(fin, torch.floor(keys / 997.0) * 997.0,
                                      keys),
            "inf_padding": torch.where(coin < 0.3, float("inf"), keys),
            "negative": torch.where(fin, -keys, keys),
            "signed_zeros": torch.where(fin & (coin < 0.4), zeros, keys),
            "all_equal": torch.full_like(keys, 7.0)}


def kernel_ops_cases(args, w4096, prod, ops, pq, radix_select, traffic):
    """The op calls of phase 6 on data from the states phases 4-5 leave:
    the stores, sequential parts and add batches of w4096 and PRODUCTION."""
    cuda, plain = ops.resolve_backend("cuda"), ops.resolve_backend("torch")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 6)
    inf = float("inf")

    def store(cell):
        s = cell["state"]
        live = torch.arange(s.buckets.shape[-1], device="cuda") \
            < s.bcounts[:, None]
        return (torch.where(live, s.buckets, inf),
                torch.where(live, s.bvals, -1), s.bcounts, s.splitters)

    def sorted_batch(cell, t):
        ak, av, mask, _ = cell["rows"]
        k = torch.where(mask[t], ak[t], inf)
        order = torch.sort(k, stable=True).indices
        return k[order][None], av[t][order][None]

    def flags_like(v):
        return torch.randint(0, 2, v.shape, generator=gen, device="cuda",
                             dtype=torch.int32)

    cases = []

    # K2: sort_kvf
    wk_add, wv_add = (x[:1].clone() for x in w4096["rows"][:2])
    pk, pv, pc, psp = store(prod)
    sort_shapes = {
        "w4096 add batch [1, 4096]": (wk_add, wv_add),
        "PRODUCTION bucket rows [1024, 1024]": (pk, pv),
        "sharded L=8 lane batch [8, 512]": (wk_add.reshape(8, 512),
                                            wv_add.reshape(8, 512)),
        "w4096 add batches [8, 4096]": tuple(
            x[:8].clone() for x in w4096["rows"][:2]),
        "sharded L=8 lane batch [8, 128]": (
            prod["rows"][0][:1].reshape(8, 128).clone(),
            prod["rows"][1][:1].reshape(8, 128).clone()),
        "PRODUCTION k_max row [1, 65536]": (pk.reshape(1, -1)[:, :65536],
                                            pv.reshape(1, -1)[:, :65536]),
        # phase 9: a D=2 position's router, the kill cell's survivors, the
        # serving cells' positions
        "dist D=2 lane batch [4, 512]": (wk_add[:, :2048].reshape(4, 512),
                                         wv_add[:, :2048].reshape(4, 512)),
        "dist D=2 lane batch [4, 128]": (
            prod["rows"][0][:1, :512].reshape(4, 128).clone(),
            prod["rows"][1][:1, :512].reshape(4, 128).clone()),
        "dist kill survivors [4, 1024]": (wk_add.reshape(4, 1024),
                                          wv_add.reshape(4, 1024)),
        "serving W64 lane batch [2, 16]": (wk_add[:, :32].reshape(2, 16),
                                           wv_add[:, :32].reshape(2, 16)),
        # the chaos cells' survivors: width 64 and 1024 over half the lanes
        "serving W64 survivors [2, 32]": (wk_add[:, :64].reshape(2, 32),
                                          wv_add[:, :64].reshape(2, 32)),
        "serving W1024 survivors [4, 256]": (
            wk_add[:, :1024].reshape(4, 256),
            wv_add[:, :1024].reshape(4, 256)),
        # phase 10: quickstart's sharded L=4 and serve_requests at one
        # position (width 64), the mesh example's survivor (width 128)
        "examples W64 L=4 lane batch [4, 16]": (
            wk_add[:, :64].reshape(4, 16), wv_add[:, :64].reshape(4, 16)),
        "mesh example survivors [2, 64]": (
            wk_add[:, :128].reshape(2, 64), wv_add[:, :128].reshape(2, 64)),
        # phase 12: dev_check_dist's positions (l=2 lanes of width 64 / 16)
        # and the single-device sharded queue it is held to (L=16)
        "dev check dist position [2, 4]": (
            wk_add[:, :8].reshape(2, 4), wv_add[:, :8].reshape(2, 4)),
        "dev check dist sharded L=16 [16, 4]": (
            wk_add[:, :64].reshape(16, 4), wv_add[:, :64].reshape(16, 4)),
    }
    # row lengths around the one-CTA limit (4096 keys) and past it
    for n in (1, 31, 32, 4095, 4097, 65537, 100000):
        sort_shapes[f"PRODUCTION store row [1, {n}]"] = (
            pk.reshape(1, -1)[:, :n], pv.reshape(1, -1)[:, :n])
    for shape, (k0, v) in sort_shapes.items():
        v = v.contiguous()
        f = flags_like(v)
        for mix, k in key_mixes(k0.contiguous(), gen).items():
            cases.append(OpCase(
                "K2", f"sort_kvf {shape} {mix}",
                lambda k=k, v=v, f=f: ops.sort_kvf(k, v, f, backend=cuda),
                lambda k=k, v=v, f=f: ops.sort_kvf(k, v, f, backend=plain),
                lambda k=k: torch.sort(k, dim=-1, stable=True),
                traffic.k2_sort(*k.shape), 2 * nbytes(k, v, f),
                timed=mix == "uniform", setting=str(list(k.shape))))

    # K1: merge_sorted, each stream sorted again after its key mix
    sk_p, sv_p = sorted_batch(prod, 0)
    sk_w, sv_w = sorted_batch(w4096, 0)
    sp, sw = prod["state"], w4096["state"]
    fk, fv = pq.flatten_parallel(prod["cfg"], pq._par_of(sp))

    def resorted(k, v):
        k, order = torch.sort(k, dim=-1, stable=True)
        return k.contiguous(), v.gather(-1, order).contiguous()

    for shape, (ak0, av0, bk0, bv0) in merge_shapes(
            sp, sw, fk, fv, sk_p, sv_p, sk_w, sv_w).items():
        ak0, av0, bk0, bv0 = (x.contiguous() for x in (ak0, av0, bk0, bv0))
        af, bf = flags_like(av0), flags_like(bv0)
        a_mixes = key_mixes(ak0, gen)
        for mix, bk_mix in key_mixes(bk0, gen).items():
            a = (*resorted(a_mixes[mix], av0), af)
            b = (*resorted(bk_mix, bv0), bf)
            cases.append(OpCase(
                "K1", f"merge_sorted {shape} {mix}",
                lambda a=a, b=b: ops.merge_sorted(*a, *b, backend=cuda),
                lambda a=a, b=b: ops.merge_sorted(*a, *b, backend=plain),
                lambda a=a, b=b: torch.sort(torch.cat([a[0], b[0]], -1),
                                            dim=-1, stable=True),
                traffic.k1_merge(ak0.shape[0], ak0.shape[1], bk0.shape[1]),
                2 * nbytes(*a, *b), timed=mix == "uniform", setting=shape))

    # K4: select_threshold on the PRODUCTION store and the w4096 store,
    # flattened (one stream each; the w4096 store is all INF after the
    # mix, so two of its add batches, [1, 8192] of DES keys and INF, carry
    # its k sweep), and on the PRODUCTION bucket rows as 1024 streams
    wk, wv, wc, wsp = store(w4096)
    w_adds = torch.where(w4096["rows"][2][:2], w4096["rows"][0][:2], inf)
    n_rows = pk.shape[0]
    row_k = torch.randint(0, pk.shape[1] + 2, (n_rows,), generator=gen,
                          device="cuda", dtype=torch.int32)
    row_k[:3] = torch.tensor([0, 1, pk.shape[1] + 1], device="cuda")
    selects = []
    for name, keys, mid in (("PRODUCTION store", pk.reshape(1, -1), 65536),
                            ("w4096 store", wk.reshape(1, -1), 4096),
                            ("w4096 add batches", w_adds.reshape(1, -1),
                             2048)):
        n_fin = int(torch.isfinite(keys).sum())
        selects += [(name, keys, k) for k in dict.fromkeys(
            (0, 1, 1024, mid, n_fin, n_fin + 1, keys.shape[1] + 1))]
    selects.append(("PRODUCTION bucket rows", pk, row_k))
    for name, keys, k in selects:
        rows, length = keys.shape
        kt = (k if isinstance(k, torch.Tensor) else
              torch.full((1,), k, dtype=torch.int32, device="cuda"))
        past = int(kt.max()) > length             # the oracle clamps k
        plain_fn = (
            (lambda keys=keys, kt=kt:
             radix_select.radix_select_threshold_plain(keys, kt)) if past
            else (lambda keys=keys, kt=kt:
                  ops.select_threshold(keys, kt, backend=plain)))
        library = (None if isinstance(k, torch.Tensor) or not k
                   or k > length else
                   (lambda keys=keys, k=k: torch.kthvalue(keys, k, dim=-1)))
        k_label = "per row" if isinstance(k, torch.Tensor) else k
        cases.append(OpCase(
            "K4", f"select_threshold {name} [{rows}, {length}] k={k_label}",
            lambda keys=keys, kt=kt: ops.select_threshold(keys, kt,
                                                          backend=cuda),
            plain_fn, library, traffic.k4_select(rows, length),
            nbytes(keys, kt) + 8 * rows,
            also=None if past else (
                lambda keys=keys, kt=kt:
                radix_select.radix_select_threshold_plain(keys, kt)),
            setting=f"[{rows}, {length}]"))

    # K4 then K2: the compositions
    k_max = prod["cfg"].move_k_max
    flat_k, flat_v = pk.reshape(1, -1), pv.reshape(1, -1)
    cases.append(OpCase(
        "K4+K2", f"select_k_smallest PRODUCTION store k={k_max} "
        f"k_max={k_max}",
        lambda: ops.select_k_smallest(flat_k, flat_v, k_max, k_max,
                                      backend=cuda),
        lambda: ops.select_k_smallest(flat_k, flat_v, k_max, k_max,
                                      backend=plain),
        lambda: torch.topk(flat_k, k_max, dim=-1, largest=False,
                           sorted=True),
        traffic.select_k_smallest(*flat_k.shape, k_max),
        nbytes(flat_k, flat_v) + 8 * k_max,
        setting=f"[1, {flat_k.shape[1]}]"))
    for cell, (sk, sv, sc, spl), km, ks in (
            ("PRODUCTION", (pk, pv, pc, psp), k_max, (1024, 65536)),
            ("w4096", (wk, wv, wc, wsp), w4096["cfg"].move_k_max,
             (1024, 8192))):
        for k in ks:
            cases.append(OpCase(
                "K4+K2", f"extract_k_bucketed {cell} store "
                f"{tuple(sk.shape)} k={k} k_max={km}",
                lambda a=(sk, sv, sc, k, km, spl): ops.extract_k_bucketed(
                    *a[:5], splitters=a[5], backend=cuda),
                lambda a=(sk, sv, sc, k, km, spl): ops.extract_k_bucketed(
                    *a[:5], splitters=a[5], backend=plain),
                None, traffic.extract_k_bucketed(*sk.shape, km),
                2 * nbytes(sk, sv, sc) + nbytes(spl) + 8 * km,
                canon=canon_extract, setting=f"[1, {sk.numel()}]"))
    return cases


def merge_shapes(sp, sw, fk, fv, sk_p, sv_p, sk_w, sv_w):
    """K1's four merges: the PRODUCTION and w4096 combines, the
    PRODUCTION rebalance and the sharded L=8 lanes' combine."""
    return {
        "PRODUCTION combine 131072+1024": (sp.seq_keys[None],
                                           sp.seq_vals[None], sk_p, sv_p),
        "w4096 combine 16384+4096": (sw.seq_keys[None], sw.seq_vals[None],
                                     sk_w, sv_w),
        "PRODUCTION rebalance 1048576+1024": (fk[None], fv[None], sk_p, sv_p),
        "sharded L=8 lanes [8, 1026]+[8, 512]": (
            sw.seq_keys[:8 * 1026].reshape(8, 1026),
            sw.seq_vals[:8 * 1026].reshape(8, 1026),
            sk_w.reshape(8, 512), sv_w.reshape(8, 512)),
    }


def canon_extract(out, bitonic):
    """The survivors' slot layout differs by design (the kernel branch
    keeps slot order, the plain branch leaves sorted runs): a stable row
    sort of the survivors gives the plain branch's layout bit for bit."""
    out_k, out_v, new_k, new_v, new_counts = out
    rk, rv, _ = bitonic.bitonic_sort_kvf_plain(new_k, new_v,
                                               torch.zeros_like(new_v))
    return out_k, out_v, rk, rv, new_counts


#: the final line's phase-6 rows: (kernel, wrapper, source, the TPU
#: kernel it replaces, (the row's name, the timed op it reads) a setting)
KERNEL_OPS_ROWS = (
    ("K1", "merge_sorted_kvf", "merge_consume.cu",
     "src/repro/kernels/merge_consume.py:119",
     [(shape, f"merge_sorted {shape} uniform") for shape in (
         "PRODUCTION combine 131072+1024", "w4096 combine 16384+4096",
         "PRODUCTION rebalance 1048576+1024",
         "sharded L=8 lanes [8, 1026]+[8, 512]")]),
    ("K2", "bitonic_sort_kvf", "bitonic.cu",
     "src/repro/kernels/bitonic.py:89",
     [("PRODUCTION bucket rows [1024, 1024] uniform",
       "sort_kvf PRODUCTION bucket rows [1024, 1024] uniform")]),
    ("K4", "radix_select_threshold", "radix_select.cu",
     "src/repro/kernels/radix_select.py:93",
     [("PRODUCTION store 1048576 keys k=65536",
       "select_threshold PRODUCTION store [1, 1048576] k=65536"),
      ("w4096 add batches [1, 8192] k=2048",
       "select_threshold w4096 add batches [1, 8192] k=2048"),
      ("PRODUCTION bucket rows [1024, 1024] k=per row",
       "select_threshold PRODUCTION bucket rows [1024, 1024] k=per row")]))


def kernel_ops_rows(records, totals):
    """The final line's rows of phase 6: a row per K1 merge and K4 shape
    (K2: its [1024, 1024] row).  ``launches`` is the wrapper's launches in
    phase 6's path run, ``setting_launches`` those at the row's setting
    (K4 also inside the compositions), ``max_abs_err`` the kernel's worst
    in the phase."""
    rows = []
    for kname, wrapper, src, replaces, settings in KERNEL_OPS_ROWS:
        of = [r for r in records.values() if kname in r["kernel"]]
        for name, label in settings:
            rec = records[label]
            rows.append(dict(
                name=f"{wrapper}[{name}]", route="cuda",
                source=f"src/repro_torch/kernels/csrc/{src}",
                replaces=replaces, launches=totals[wrapper],
                setting_launches=sum(r["launches"].get(wrapper, 0)
                                     for r in of
                                     if r["shape"] == rec["shape"]),
                max_abs_err=max(r["max_abs_err"] for r in of),
                **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}))
    return rows


def kernel_ops_path(args, w4096, prod, ops, pq, wrappers, bitonic,
                    radix_select, traffic):
    """Phase 6.  Every case's "cuda" call runs once with the launch counts
    set to 0 (the path run); then each is held against its "torch" call
    (and K4 also against its plain version) bit for bit and timed.
    Returns ({label: record}, {kernel: launches in the path run})."""
    cases = kernel_ops_cases(args, w4096, prod, ops, pq, radix_select,
                             traffic)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    got, launched = [], []
    for case in cases:
        before = {k: w.launches for k, w in wrappers.items()}
        got.append(case.cuda())
        launched.append({k: w.launches - before[k]
                         for k, w in wrappers.items()
                         if w.launches > before[k]})
    torch.cuda.synchronize()
    totals = {k: w.launches for k, w in wrappers.items()}
    print(f"kernel-ops path: {len(cases)} op calls, launches {totals}",
          flush=True)
    records = {}
    for case, out, launches in zip(cases, got, launched):
        want = case.plain()
        if case.canon is not None:
            out = case.canon(out, bitonic)
        torch.cuda.synchronize()
        err = 0.0
        refs = [("torch backend", want)]
        if case.also is not None:
            refs.append(("plain version", case.also()))
        for what, ref in refs:
            for i, (g, w) in enumerate(zip(out, ref)):
                if not same_bits(g, w):
                    fail(f"{case.label}: cuda != {what}, output {i}: "
                         f"max |diff| {max_abs_err(g, w)}")
                err = max(err, max_abs_err(g, w))
        rec = dict(kernel=case.kernel, op=case.label, launches=launches,
                   shape=case.setting,
                   max_abs_err=err, bytes=case.count.hbm_bytes,
                   bound_ms=case.count.bound_s() * 1e3, bound_by="bytes",
                   buffer_bytes=case.buffer_bytes)
        # device time per call; the host-clocked call time beside it
        for key, fn, reps in (("ms", case.cuda, 20),
                              ("plain_ms", case.plain, 10),
                              ("library_ms", case.library, 20)):
            fn = fn if case.timed else None
            rec[key], rec[key + "_device_only"] = (
                device_ms(fn, reps) if fn else (None, None))
            rec[key.replace("ms", "call_ms")] = (cuda_ms(fn, reps) if fn
                                                 else None)
        print(f"kernel_ops {json.dumps(rec)}", flush=True)
        records[case.label] = rec
    for name, w in wrappers.items():
        if totals[name] == 0:
            fail(f"the kernel-ops path never launched {name}")
    one_kernel_per_call(cases, wrappers)
    return records, totals


#: phase-6 ops whose wrapper call must be one kernel on the card: (label,
#: wrapper, the kernel's name)
ONE_KERNEL_OPS = (
    ("merge_sorted PRODUCTION combine 131072+1024 uniform",
     "merge_sorted_kvf", "merge_kernel"),
    ("merge_sorted PRODUCTION rebalance 1048576+1024 uniform",
     "merge_sorted_kvf", "merge_kernel"),
    ("select_threshold PRODUCTION store [1, 1048576] k=65536",
     "radix_select_threshold", "grid_kernel"),
    ("select_threshold w4096 add batches [1, 8192] k=2048",
     "radix_select_threshold", "row_kernel"),
    ("select_threshold PRODUCTION bucket rows [1024, 1024] k=per row",
     "radix_select_threshold", "row_kernel"))


def one_kernel_per_call(cases, wrappers, calls=10, markers=4):
    """K1's and K4's wrapper calls of :data:`ONE_KERNEL_OPS` under the
    profiler: besides ``markers`` device sleeps queued first (the
    profiler has lost the first records of a window), the device must
    show exactly one event a call, each the op's kernel (no memset, no
    copy).  A window short of that (the profiler can lose a record) is
    profiled again, up to :data:`PROFILE_WINDOWS`; a surplus fails at
    once.  Prints each op's windows: (events, the op's kernels, launches,
    marker events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    by_label = {c.label: c for c in cases}
    for label, wrapper, kernel in ONE_KERNEL_OPS:
        case = by_label[label]
        fn = case.cuda
        fn()
        torch.cuda.synchronize()
        windows = []
        for _ in range(PROFILE_WINDOWS):
            before = wrappers[wrapper].launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(markers):
                    torch.cuda._sleep(1000)
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_EDGE_S)
            launched = wrappers[wrapper].launches - before
            names = [ev.name for ev in prof.events()
                     if ev.device_type == DeviceType.CUDA]
            marks = sum("spin" in x or "sleep" in x for x in names)
            names = [x for x in names if not ("spin" in x or "sleep" in x)]
            ours = sum(kernel in x for x in names)
            windows.append([len(names), ours, launched, marks])
            if launched != calls or len(names) > calls:
                fail(f"{label}: {len(names)} device events ({ours} "
                     f"{kernel}) and {launched} launches for {calls} "
                     f"calls: {sorted(set(names))[:6]}")
            if ours == len(names) == calls:
                break
        else:
            fail(f"{label}: device events, {kernel}s and launches, window "
                 f"by window: {windows}")
        print(f"one kernel a call: {label}: {windows}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: the sharded main path
# ---------------------------------------------------------------------------

def packed_pairs(ops, keys, vals):
    """(key, val) pairs as one int64 each, ordered by key on the u32 map,
    then by val: equal multisets sort to equal arrays."""
    u = ops._to_sortable_u32(keys.contiguous()) - (1 << 31)
    return (u << 32) | (vals.long() & 0xFFFFFFFF)


def sub_multiset(small, big):
    """Whether the sorted int64 array ``small`` is a sub-multiset of the
    sorted ``big``."""
    if small.numel() == big.numel():
        return torch.equal(small, big)
    if small.numel() == 0:
        return True
    ub, cb = torch.unique_consecutive(big, return_counts=True)
    us, cs = torch.unique_consecutive(small, return_counts=True)
    idx = torch.searchsorted(ub, us).clamp(max=ub.numel() - 1)
    return bool(((ub[idx] == us) & (cb[idx] >= cs)).all())


class Conservation:
    """The exact multiset of a sharded queue, checked every tick:
    residents after the tick plus the served pairs equal residents before
    it plus the tick's adds, as sorted (key, val) pairs; and every served
    key lies within ``relax_bound(r)`` smallest of residents before plus
    adds.  Starts from an empty queue."""

    def __init__(self, eng, ops):
        self.eng, self.ops = eng, ops
        self.pairs = torch.zeros((0,), dtype=torch.int64, device="cuda")
        self.keys = torch.zeros((0,), dtype=torch.float32, device="cuda")
        self.worst = (0, 0)      # (largest served rank, its tick's c)

    def tick(self, label, t, state, result, ak, av, mask, rm, dropped=0):
        """Check one tick.  ``dropped`` is the count of keys the queue's
        own counters say it shed this tick: then residents after plus the
        served pairs must be residents before plus the adds less exactly
        that many pairs, and nothing else."""
        keys, vals, live = self.eng.resident(state)
        keys, vals = keys[live], vals[live]
        pairs = torch.sort(packed_pairs(self.ops, keys, vals)).values
        served_k = result.rm_keys[result.rm_served]
        served_v = result.rm_vals[result.rm_served]
        after = torch.sort(torch.cat(
            [pairs, packed_pairs(self.ops, served_k, served_v)])).values
        before = torch.sort(torch.cat(
            [self.pairs, packed_pairs(self.ops, ak[mask], av[mask])])).values
        if before.numel() - after.numel() != dropped or not sub_multiset(
                after, before):
            fail(f"{label} tick {t}: residents + served != residents before "
                 f"+ adds less the {dropped} counted drops "
                 f"({after.numel()} vs {before.numel()} pairs)")
        union = torch.sort(torch.cat([self.keys, ak[mask]])).values
        c = self.eng.relax_bound(int(rm))
        if served_k.numel():
            # the served key's rank: how many union keys lie below it
            rank = int(torch.searchsorted(union, served_k.max())) + 1
            self.worst = max(self.worst, (rank, c))
            if rank > c:
                fail(f"{label} tick {t}: served {float(served_k.max())} "
                     f"of rank {rank} in the union, beyond c={c}")
        self.pairs, self.keys = pairs, torch.sort(keys).values


def drive_sharded(label, engines, states, rows, cons, pq, shq, stop=None):
    """Tick the sharded cuda engine and its torch twin over device rows,
    checking each tick: results and every state leaf bit-equal (the
    router's generator state too), the multiset conserved and the
    envelope held (``cons``), nothing dropped.  Counts the ticks that did
    lane work (``shq.lane_work_marks`` grows).  Returns (states, ticks
    run, lane-work ticks)."""
    eng_c, eng_t = engines
    s_c, s_t = states
    ak, av, mask, rm = rows
    ran = work = 0
    marks = shq.lane_work_marks(s_c)
    for t in range(ak.shape[0]):
        s_c, r_c = eng_c.tick(s_c, ak[t], av[t], mask[t], rm[t])
        marks, before = shq.lane_work_marks(s_c), marks
        work += marks > before
        s_t, r_t = eng_t.tick(s_t, ak[t], av[t], mask[t], rm[t])
        leaves_equal(pq, (s_c, r_c), (s_t, r_t), label, t)
        if int(s_c.lanes.stats.n_dropped.sum()) or int(s_c.n_router_dropped):
            fail(f"{label} tick {t}: the queue dropped keys")
        cons.tick(label, t, s_c, r_c, ak[t], av[t], mask[t], rm[t])
        ran += 1
        if stop is not None and stop(s_c):
            break
    return (s_c, s_t), ran, work


def sharded_pair(factory, **spec):
    eng_c = factory.make_engine(factory.EngineSpec(engine="sharded", **spec))
    eng_t = factory.make_engine(factory.EngineSpec(
        engine="sharded", backend="torch", **spec))
    if eng_c.cfg.lane.backend != "cuda" or eng_c.device.type != "cuda":
        fail("the default sharded engine is not the cuda backend on the card")
    return (eng_c, eng_t), (eng_c.init(seed=0), eng_t.init(seed=0))


def lane_fired(state):
    st = state.lanes.stats
    return {k: int(getattr(st, k).sum()) for k in (
        "add_seq", "add_par", "n_rebalance", "n_movehead", "n_chophead",
        "n_spill")} | {"n_preroute_elim": int(state.n_preroute_elim),
                       "n_preroute_ticks": int(state.n_preroute_ticks)}


def sharded_cell(args, config, w4096):
    """Phase 7's cell streams on the card: the spec, then (fill, mix,
    quiet) device rows.  w4096: 2000 keys warm, 200 ticks at p_add 0.5
    with DES keys, then quiet ticks (None at PRODUCTION); PRODUCTION:
    filled to 262,144 residents, then 100 ticks at p_add 0.5 uniform."""
    width = 4096 if w4096 else 1024
    spec = dict(width=width, lanes=8)
    if not w4096:
        spec["base"] = config.PRODUCTION
    rng = np.random.default_rng(args.seed + (7 if w4096 else 8))
    quiet_rows = None
    if w4096:
        warm = rng.uniform(0, KEY_HI, WARM_ELEMENTS).astype(np.float32)
        first = to_device(batch_rows(width, [warm], [0]))
        mix, rms, lo = mix_keys(rng, width, 0.5, 200, "des")
        quiet = [(lo + rng.exponential(KEY_HI / WARM_ELEMENTS * 8, 64))
                 .astype(np.float32) for _ in range(200)]
        quiet_rows = to_device(batch_rows(width, quiet, [0] * 200))
    else:
        n_fill = 262_144 // width
        fill = [rng.uniform(0, KEY_HI, width).astype(np.float32)
                for _ in range(n_fill)]
        first = to_device(batch_rows(width, fill, [0] * n_fill))
        mix, rms, _ = mix_keys(rng, width, 0.5, 100, "uniform")
    return spec, first, to_device(batch_rows(width, mix, rms)), quiet_rows


def sharded_path(args, factory, config, pq, shq, lt, ops, counters):
    """Phase 7 over both cells.  Every launch count is set to 0 before
    each cell and read after it.  Returns {cell: record}."""
    mods = {"pq": pq, "lt": lt, "sh": shq}
    out = {}
    for cell in ("sharded_w4096_L8_des", "sharded_production_L8_uniform"):
        w4096 = cell.startswith("sharded_w4096")
        spec, first, mix_rows, quiet_rows = sharded_cell(args, config, w4096)
        engines, states = sharded_pair(factory, **spec)

        cons = Conservation(engines[0], ops)
        torch.cuda.synchronize()
        for w in counters.values():
            w.launches = 0
        ticks = work = 0
        for part, rows in (("fill", first), ("mix", mix_rows)):
            states, n, k = drive_sharded(f"{cell} {part}", engines, states,
                                         rows, cons, pq, shq)
            ticks, work = ticks + n, work + k
            if part == "fill":
                start = states
                resident = int(shq.size(states[0]))
        if w4096:
            states, n, k = drive_sharded(
                f"{cell} quiet", engines, states, quiet_rows, cons, pq, shq,
                stop=lambda s: int(s.lanes.stats.n_chophead.sum()) > 0)
            ticks, work = ticks + n, work + k
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in counters.items()}
        fired = lane_fired(states[0])
        print(f"{cell}: ticks {ticks}, lane-work ticks {work}, launches "
              f"{launches}, resident after fill {resident}, now "
              f"{int(shq.size(states[0]))}, lane counters {fired}, largest "
              f"served rank in the union (rank, c) {cons.worst}", flush=True)
        if launches["fused_tick_mid"] != work or work == 0:
            fail(f"{cell}: {launches['fused_tick_mid']} lane-tick launches "
                 f"for {work} lane-work ticks")
        if launches["bitonic_sort_kvf"] != work:
            fail(f"{cell}: {launches['bitonic_sort_kvf']} router sorts for "
                 f"{work} lane-work ticks")
        if launches["merge_sorted_kvf"] or launches["radix_select_threshold"]:
            fail(f"{cell}: the sharded path launched K1 or K4: {launches}")
        if fired["n_movehead"] == 0:
            fail(f"{cell}: moveHead never fired")
        if w4096 and fired["n_chophead"] == 0:
            fail(f"{cell}: chopHead never fired")
        if not w4096 and resident != 262_144:
            fail(f"{cell}: {resident} resident after the fill, not 262144")
        rec = timings(cell, engines, start, mix_rows, 50 if w4096 else 30,
                      mods, SHARDED_STAGES)
        out[cell] = dict(launches=launches, work=work, ticks=ticks,
                         fired=fired, worst_rank=cons.worst, timing=rec,
                         cfg=engines[0].cfg)
    return out


# ---------------------------------------------------------------------------
# phase 8: the baselines, the adaptive engine and the quality layer
# ---------------------------------------------------------------------------

def baselines_path(args, factory, pq, RefPQ, counters):
    """8a.  Each baseline at w4096 on the card beside the same engine on
    the CPU, over phase 4's stream (2000 keys warm, 200 ticks at p_add 0.5
    with DES keys): every tick, results and state bit-equal between the
    two and served keys equal to the heapq oracle's.  They run no kernel.
    Then µs per tick of the card's engine, two runs, and a profiled
    pass."""
    rng = np.random.default_rng(args.seed)
    warm = rng.uniform(0, KEY_HI, WARM_ELEMENTS).astype(np.float32)
    mix, rms, _ = mix_keys(rng, 4096, 0.5, 200, "des")
    rows = to_device(batch_rows(4096, [warm] + mix, [0] + rms))
    host = tuple(x.cpu() for x in rows)
    out = {}
    for kind in ("fcskiplist", "lfskiplist"):
        spec = factory.EngineSpec(engine=kind, width=4096)
        eng, twin = factory.make_engine(spec), factory.make_engine(
            spec, device="cpu")
        if eng.device.type != "cuda":
            fail(f"{kind}: the default engine is not on the card")
        start = eng.init(seed=0)
        s, s_h, ref = start, twin.init(seed=0), RefPQ()
        torch.cuda.synchronize()
        for w in counters.values():
            w.launches = 0
        for t in range(rows[0].shape[0]):
            s, r = eng.tick(s, *(x[t] for x in rows))
            s_h, r_h = twin.tick(s_h, *(x[t] for x in host))
            leaves_equal(pq, (s, r[:3]), (s_h, r_h[:3]), kind, t)
            keys = host[0][t][host[2][t]].numpy()
            exp = np.sort(np.array([k for k, _ in ref.tick(
                keys.tolist(), range(len(keys)), int(host[3][t]))
                if k != np.inf], np.float32))
            if not np.array_equal(np.sort(r_h.rm_keys[r_h.rm_served]
                                          .numpy()), exp):
                fail(f"{kind} tick {t}: served keys differ from the oracle")
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in counters.items()}
        if any(launches.values()):
            fail(f"{kind}: the baseline launched a kernel: {launches}")
        us = [time_ticks(eng, start, rows), time_ticks(eng, start, rows)]
        out[kind] = dict(cell="baselines_w4096_p50_des", ticks=len(mix) + 1,
                         resident=int(eng.size(s)), launches=launches,
                         us_per_tick_cuda=us, device=card(),
                         profile=kernel_share(eng, start, rows))
        print(f"baselines {json.dumps(out[kind])}", flush=True)
    return out


def adaptive_rows(rng, width):
    """2000 keys warm, then four phases of 64 ticks: p_add 0.5 uniform
    (balanced, dispersed), 0.5 DES (balanced, clustered), 0.3 DES
    (skewed), 0.5 uniform.  Returns host (numpy) rows and each tick's
    phase (0 for the warm tick)."""
    keys = [rng.uniform(0, KEY_HI, WARM_ELEMENTS).astype(np.float32)]
    rms, lo = [0], 0.0
    for p_add, dist in ((0.5, "uniform"), (0.5, "des"), (0.3, "des"),
                        (0.5, "uniform")):
        k, r, lo = mix_keys(rng, width, p_add, 64, dist, lo)
        keys, rms = keys + k, rms + r
    phase = [0] + [p for p in (1, 2, 3, 4) for _ in range(64)]
    return batch_rows(width, keys, rms), phase


class PlanLaunches:
    """The K3 and K2 launches of an adaptive engine, measured tick by
    tick and held to what its plan trace predicts.

    The prediction: a pqe tick launches K3 once (grid 1); a sharded tick
    with lane work (``sharded.lane_work_marks`` grows) K3 once (grid L)
    and K2 once; each re-insertion tick of an engine switch or a fold is
    a pqe tick or a sharded tick with adds.  The measurement: the
    wrappers' counters read before each tick, on entry to and exit from
    the engine's ``_window_boundary`` (wrapped here, which also catches
    the state between the chunk and the boundary) and after the tick.
    The chunk's launches are charged to the plan it ran under, the
    boundary's to the plan it switched to; each part must equal its
    prediction, or the run fails at that tick.  Tables are keyed by
    (kind, lanes): ``k3`` / ``k2`` measured, ``want_k3`` / ``want_k2``
    predicted."""

    def __init__(self, cell, eng, shq, counters):
        self.cell, self.eng, self.shq = cell, eng, shq
        self.k3_w = counters["fused_tick_mid"]
        self.k2_w = counters["bitonic_sort_kvf"]
        self.k3, self.k2, self.want_k3, self.want_k2 = {}, {}, {}, {}
        self.t, self.mid, self.entry, self.exit = None, None, None, None
        boundary = eng._window_boundary

        def caught(state):
            self.mid, self.entry = state, self._read()
            new = boundary(state)
            self.exit = self._read()
            self._charge("re-insertion", new, self._reinserted(state, new),
                         self.entry, self.exit)
            return new

        eng._window_boundary = caught

    def _read(self):
        return self.k3_w.launches, self.k2_w.launches

    def _charge(self, part, plan, n, before, after):
        """Charge ``after - before`` to ``plan``'s key; fail unless it
        is ``n`` K3 launches and, for a sharded plan, ``n`` K2 sorts."""
        key = (plan.kind, 1 if plan.kind == "pqe" else plan.lanes)
        got = (after[0] - before[0], after[1] - before[1])
        want = (n, n if plan.kind == "sharded" else 0)
        if got != want:
            fail(f"{self.cell} tick {self.t}: the {part} under "
                 f"{key[0]}/L{key[1]} launched K3 {got[0]} and K2 {got[1]} "
                 f"times, the plan trace predicts {want[0]} and {want[1]}")
        tables = [(self.k3, self.want_k3, 0)]
        if plan.kind == "sharded":
            tables.append((self.k2, self.want_k2, 1))
        for table, wtable, i in tables:
            table[key] = table.get(key, 0) + got[i]
            wtable[key] = wtable.get(key, 0) + want[i]

    def tick(self, t, state, *batch):
        self.t, self.mid, self.entry, self.exit = t, None, None, None
        start = self._read()
        new, res = self.eng.tick(state, *batch)
        end = self._read()
        mid = new if self.mid is None else self.mid
        chunk_end = end if self.entry is None else self.entry
        if self.exit is not None and end != self.exit:
            fail(f"{self.cell} tick {t}: kernels launched after the window "
                 "boundary")
        if state.kind == "pqe":
            n = 1
        else:
            n = int(self.shq.lane_work_marks(mid.inner)
                    > self.shq.lane_work_marks(state.inner))
        self._charge("tick", state, n, start, chunk_end)
        return new, res

    def _reinserted(self, mid, new):
        """Re-insertion ticks the boundary from ``mid`` to ``new`` runs."""
        if new.kind != mid.kind:
            n = int(self.eng.size(mid))
            w = self.eng.base.a_max if new.kind == "pqe" else self.eng.width
        elif new.kind == "sharded" and new.lanes < mid.lanes:
            n = int(self.shq.lane_sizes(mid.inner)[new.lanes:].sum())
            w = self.eng.width
        else:
            return 0
        return -(-n // w)

    def table(self):
        """{"kind/Llanes": {"k3", "k2", "want_k3", "want_k2"}}."""
        keys = sorted(self.want_k3)
        return {f"{k}/L{n}": dict(k3=self.k3.get((k, n), 0),
                                  k2=self.k2.get((k, n), 0),
                                  want_k3=self.want_k3.get((k, n), 0),
                                  want_k2=self.want_k2.get((k, n), 0))
                for k, n in keys}


def inner_drops(state):
    """Keys the adaptive engine's live structure has counted as shed."""
    inner = state.inner
    if state.kind == "pqe":
        return int(inner.stats.n_dropped)
    return int(inner.lanes.stats.n_dropped.sum()) + int(
        inner.n_router_dropped)


def tick_costs(eng, rows, phase):
    """One pass of ``eng`` from a fresh state over the rows, each tick
    timed on the host clock (ending in a synchronise) and by CUDA events
    around it; ticks grouped by the plan in force, a tick whose window
    boundary changed the plan counted apart as a switch.  Returns
    {group: dict(ticks, host_us, event_us)}."""
    def plan(state):
        return (state.kind if state.kind == "pqe"
                else f"sharded L={state.lanes}")

    state = eng.init(seed=0)
    groups = {}
    events = []
    for t in range(rows[0].shape[0]):
        before = plan(state)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        state, _ = eng.tick(state, *(x[t] for x in rows))
        e1.record()
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) * 1e6
        after = plan(state)
        group = (f"switch {before} -> {after}" if after != before
                 else f"{before} phase {phase[t]}")
        events.append((group, host_us, e0, e1))
    for group, host_us, e0, e1 in events:
        g = groups.setdefault(group, dict(ticks=0, host_us=0.0,
                                          event_us=0.0))
        g["ticks"] += 1
        g["host_us"] += host_us
        g["event_us"] += e0.elapsed_time(e1) * 1e3
    for g in groups.values():
        g["host_us"] /= g["ticks"]
        g["event_us"] /= g["ticks"]
    return groups


def fixed_engine_costs(factory, rows, phase):
    """What each choice costs per regime: the fixed pqe and sharded L=8
    engines (cuda) over the same rows, µs per tick by phase on the host
    clock (synchronised per tick), in turns pqe, sharded, sharded, pqe."""
    out = {}
    for kind in ("pqe", "sharded", "sharded", "pqe"):
        eng = factory.make_engine(factory.EngineSpec(engine=kind, width=4096,
                                                     lanes=8))
        state = eng.init(seed=0)
        spent = {}
        for t in range(rows[0].shape[0]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = eng.tick(state, *(x[t] for x in rows))
            torch.cuda.synchronize()
            spent.setdefault(phase[t], []).append(
                (time.perf_counter() - t0) * 1e6)
        for p, us in spent.items():
            if p:
                out.setdefault(f"{kind} phase {p}", []).append(
                    sum(us) / len(us))
    return out


def adaptive_path(cell, args, factory, adaptive, pq, shq, ops, counters,
                  min_lanes=None, engines=("pqe", "sharded")):
    """8b / 8c.  The adaptive engine at w4096, L=8, window 8 beside its
    "torch" twin on the card, over ``adaptive_rows``.  Every tick:
    results, inner state, plan and controller state bit-equal between
    the twins; the exact multiset conserved across switches and folds,
    less the keys the structure's own counters say it shed; no router
    drop; every served key within ``relax_bound(r)`` smallest of the
    union.  K3 and K2 launch as the plan trace predicts, tick by tick
    and plan by plan (``PlanLaunches``), K1 and K4 never.  Then the timings (``tick_costs``, a profiled pass and, for
    8b, ``fixed_engine_costs``).  Returns the record (the plan trace per
    window too)."""
    ctl = adaptive.ControllerConfig(window=8, engines=engines)
    spec = dict(engine="adaptive", width=4096, lanes=8, min_lanes=min_lanes,
                controller=ctl)
    eng_c = factory.make_engine(factory.EngineSpec(**spec))
    eng_t = factory.make_engine(factory.EngineSpec(backend="torch", **spec))
    if eng_c.base.backend != "cuda" or eng_c.device.type != "cuda":
        fail(f"{cell}: the default adaptive engine is not cuda on the card")
    rows, phase = adaptive_rows(np.random.default_rng(args.seed + 9), 4096)
    rows = to_device(rows)
    plan = PlanLaunches(cell, eng_c, shq, counters)
    cons = Conservation(eng_c, ops)
    s_c, s_t = eng_c.init(seed=0), eng_t.init(seed=0)
    trace, dropped = [], 0
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    for t in range(rows[0].shape[0]):
        batch = [x[t] for x in rows]
        pre = s_c
        s_c, r_c = plan.tick(t, s_c, *batch)
        s_t, r_t = eng_t.tick(s_t, *batch)
        host_c = (s_c.kind, s_c.lanes, s_c.preroute, s_c.tick_count, s_c.ctl)
        host_t = (s_t.kind, s_t.lanes, s_t.preroute, s_t.tick_count, s_t.ctl)
        if host_c != host_t:
            fail(f"{cell} tick {t}: plan or controller state differs "
                 f"between the twins: {host_c[:4]} vs {host_t[:4]}")
        leaves_equal(pq, (s_c.inner, r_c), (s_t.inner, r_t), cell, t)
        # sheds are counted by the live structure; a tick that switched
        # engines starts a fresh structure, which must not shed at all
        shed = inner_drops(s_c) - (inner_drops(pre) if pre.kind == s_c.kind
                                   else 0)
        if s_c.kind == "sharded" and int(s_c.inner.n_router_dropped):
            fail(f"{cell} tick {t}: the router dropped keys")
        cons.tick(cell, t, s_c, r_c, *batch, dropped=shed)
        dropped += shed
        if s_c.tick_count % ctl.window == 0:
            c = s_c.ctl
            trace.append(dict(window=c.n_windows, tick=t, phase=phase[t],
                              plan=[s_c.kind, s_c.lanes, s_c.preroute],
                              balance_ema=c.balance_ema,
                              disp_ema=c.disp_ema, hit_ema=c.hit_ema,
                              n_switches=c.n_switches))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in counters.items()}
    by_plan = plan.table()
    del eng_c._window_boundary        # the timed passes below run unwatched
    print(f"{cell} plan trace {json.dumps(trace)}", flush=True)
    print(f"{cell}: ticks {rows[0].shape[0]}, switches "
          f"{s_c.ctl.n_switches}, launches {launches}, measured and "
          f"predicted by plan {json.dumps(by_plan)}, keys shed {dropped}, "
          f"largest served rank (rank, c) {cons.worst}", flush=True)
    # every launch of the run fell inside a tick the plan table charged
    for wrapper, k in (("fused_tick_mid", "k3"), ("bitonic_sort_kvf", "k2")):
        charged = sum(v[k] for v in by_plan.values())
        if launches[wrapper] != charged:
            fail(f"{cell}: {launches[wrapper]} {wrapper} launches, "
                 f"{charged} of them within the engine's ticks")
    if launches["merge_sorted_kvf"] or launches["radix_select_threshold"]:
        fail(f"{cell}: the adaptive path launched K1 or K4: {launches}")
    rec = dict(cell=cell, device=card(), ticks=int(rows[0].shape[0]),
               n_switches=s_c.ctl.n_switches, launches=launches,
               launches_by_plan=by_plan,
               keys_shed=dropped, worst_rank=cons.worst, trace=trace,
               tick_costs=tick_costs(eng_c, rows, phase),
               profile=kernel_share(eng_c, eng_c.init(seed=0), rows))
    if min_lanes is None:
        rec["fixed_engine_costs"] = fixed_engine_costs(factory, rows, phase)
    print(f"adaptive {json.dumps({k: v for k, v in rec.items() if k != 'trace'})}",
          flush=True)
    return rec


def check_phased(rec):
    """8b: at least two engine switches, and no key shed."""
    if rec["n_switches"] < 2 or rec["keys_shed"]:
        emas = [(w["window"], round(w["balance_ema"], 4),
                 round(w["disp_ema"], 4), w["plan"][0]) for w in rec["trace"]]
        fail(f"{rec['cell']}: {rec['n_switches']} engine switches, "
             f"{rec['keys_shed']} keys shed; per-window (window, balance "
             f"EMA, dispersion EMA, engine): {emas}")


def check_fold(rec):
    """8c: folds to L=1 in both uniform phases and unfolds to L=8 in the
    DES phases."""
    lanes = {p: [w["plan"][1] for w in rec["trace"] if w["phase"] == p]
             for p in (1, 2, 3, 4)}
    if not (1 in lanes[1] and 8 in lanes[2] + lanes[3] and 1 in lanes[4]):
        fail(f"{rec['cell']}: the lanes did not fold to 1 in the uniform "
             f"phases and unfold to 8 in the DES phases: {lanes}")


#: the rank-error budget (rank_err_p99) phase 8d's tuner walk spends
TUNE_BUDGET = 2048.0


def quality_path(factory, quality, counters):
    """8d.  ``measure_engine`` of pqe and of sharded L=8 at w4096 on the
    tuner's probe stream from its warm set: pqe exact, sharded within
    ``relax_bound(r) - r``; then ``tune_lanes`` at w4096, p_add 0.5."""
    warm = quality.warm_keys()
    probe = quality.probe_stream(4096, 0.5, 35)
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    out = {}
    for kind in ("pqe", "sharded"):
        eng = factory.make_engine(factory.EngineSpec(engine=kind, width=4096,
                                                     lanes=8))
        s = quality.measure_engine(eng, *probe, warm_keys=warm)
        r = int(probe[3][0])
        out[kind] = dict(summary=s, envelope=eng.relax_bound(r) - r)
        if s["n_served"] == 0 or s["rank_err_max"] > out[kind]["envelope"]:
            fail(f"quality {kind}: {s} outside the envelope "
                 f"{out[kind]['envelope']}")
        if kind == "pqe" and (s["rank_err_max"] or s["stale_max"]):
            fail(f"quality pqe: the exact engine scored {s}")
    tune = quality.tune_lanes(width=4096, p_add=0.5, budget=TUNE_BUDGET)
    out["tune_lanes"] = dict(budget=tune.budget, metric=tune.metric,
                             lanes=tune.lanes, value=tune.value,
                             trace=[list(x) for x in tune.trace])
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in counters.items()}
    if launches["merge_sorted_kvf"] or launches["radix_select_threshold"]:
        fail(f"quality: launched K1 or K4: {launches}")
    if not launches["fused_tick_mid"]:
        fail("quality: the engines never launched the lane tick")
    out["launches"] = launches
    print(f"quality {json.dumps(out)}", flush=True)
    print(f"tune_lanes trace (L, {tune.metric}, us per tick): "
          f"{out['tune_lanes']['trace']} -> L={tune.lanes}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the serving path (the mesh queue, fault tolerance, the request
# engine)
# ---------------------------------------------------------------------------

#: two mesh positions on the one card
TWO_ON_ONE = ("cuda:0", "cuda:0")


def lane_geometry(lane):
    """A lane config's geometry, backend aside: the kernel settings of
    phase 3 and the lane work of phase 9 meet on it."""
    return repr(dataclasses.replace(lane, backend="torch"))


class _Charged:
    """A kernel wrapper stood in for its module's name: calls pass through,
    and each call that launched (the wrapper's count grew) adds one to
    ``table[key(args)]``.  ``launches`` reads and writes the wrapper's own
    count, which the wrapper's body increments through the module name."""

    def __init__(self, fn, key, table):
        self.fn, self.key, self.table = fn, key, table

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, *args, **kw):
        before = self.fn.launches
        out = self.fn(*args, **kw)
        if self.fn.launches > before:
            k = self.key(*args)
            self.table[k] = self.table.get(k, 0) + 1
        return out


class SettingLaunches:
    """K3 and K2 launches per kernel setting over any path.  Inside the
    ``with`` block (which may be entered again, the tables kept) the two
    wrappers' module names (which every caller looks up at call time)
    are wrapped: a call that launched charges ``k3[(lane geometry,
    grid)]`` or ``k2[(rows, width)]``."""

    def __init__(self, lt, bitonic):
        self.lt, self.bitonic = lt, bitonic
        self.k3, self.k2 = {}, {}

    def __enter__(self):
        self.saved = self.lt.fused_tick_mid, self.bitonic.bitonic_sort_kvf
        self.lt.fused_tick_mid = _Charged(
            self.saved[0], lambda cfg, lanes, lk, *a: (lane_geometry(cfg),
                                                        lk.shape[0]),
            self.k3)
        self.bitonic.bitonic_sort_kvf = _Charged(
            self.saved[1], lambda keys, *a: tuple(keys.shape), self.k2)
        return self

    def __exit__(self, *exc):
        self.lt.fused_tick_mid, self.bitonic.bitonic_sort_kvf = self.saved

    def check(self, label, k3, k2):
        """The settings' launches add up to ``k3`` K3 and ``k2`` K2."""
        got = sum(self.k3.values()), sum(self.k2.values())
        if got != (k3, k2):
            fail(f"{label}: {got[0]} K3 and {got[1]} K2 launches by "
                 f"setting, for {k3} and {k2}")

    def shapes(self):
        """The launches by kernel setting, for a cell's JSON record:
        (K3 [[lane geometry, grid, launches]], K2 [[rows, width,
        launches]])."""
        return ([[g, l, n] for (g, l), n in self.k3.items()],
                [[r, w, n] for (r, w), n in self.k2.items()])


class PositionLaunches:
    """K3 and K2 launches per mesh position.  Inside the ``with`` block,
    ``distributed._position_tick`` (one position's lane work, looked up
    at call time) is wrapped: each call of a "cuda" lane config charges
    the counters' growth within it to (lanes per position, position),
    ``calls[(l, p)]`` = [calls, K3 launches, K2 launches].  The launches
    per kernel setting are :class:`SettingLaunches`' count."""

    def __init__(self, dq, counters):
        self.dq, self.counters = dq, counters
        self.calls = {}

    def __enter__(self):
        inner, k3, k2 = (self.dq._position_tick,
                         self.counters["fused_tick_mid"],
                         self.counters["bitonic_sort_kvf"])
        calls = self.calls

        def counted(scfg, part, route_inv, ak, av, am, grants, lane_lo,
                    n_local):
            before = (k3.launches, k2.launches)
            out = inner(scfg, part, route_inv, ak, av, am, grants, lane_lo,
                        n_local)
            if scfg.lane.backend == "cuda":
                c = calls.setdefault((n_local, lane_lo // n_local), [0, 0, 0])
                c[0] += 1
                c[1] += k3.launches - before[0]
                c[2] += k2.launches - before[1]
            return out

        self.inner = inner
        self.dq._position_tick = counted
        return self

    def __exit__(self, *exc):
        self.dq._position_tick = self.inner

    def check(self, label, n_local, work_ticks):
        """Each position launched K3 and K2 once on each of its lane-work
        ticks (``work_ticks``, the queues' own count), and at least once."""
        got = [self.calls.get((n_local, p), [0, 0, 0])
               for p in range(len(work_ticks))]
        for p, (c, w) in enumerate(zip(got, work_ticks)):
            if not c[0] == c[1] == c[2] == w or w == 0:
                fail(f"{label}: position {p} ran its lanes {c[0]} times "
                     f"with {c[1]} K3 and {c[2]} K2 launches, for {w} "
                     "lane-work ticks")
        return got


def host_and_event_us(eng, state, rows):
    """Microseconds per tick over device rows on the host clock and
    between CUDA events (the device's timeline, idle included)."""
    ak, av, mask, rm = rows
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for t in range(ak.shape[0]):
        state, _ = eng.tick(state, ak[t], av[t], mask[t], rm[t])
    end.record()
    torch.cuda.synchronize()
    n = ak.shape[0]
    return ((time.perf_counter() - t0) / n * 1e6,
            start.elapsed_time(end) / n * 1e3)


def dist_pair(factory, n_devices, per_device, mesh, **spec):
    """The dist engine (the "cuda" backend by default) and its "torch"
    twin, over ``mesh`` (None: the default mesh)."""
    engines = tuple(factory.make_engine(factory.EngineSpec(
        engine="dist", n_devices=n_devices, lanes_per_device=per_device,
        **spec,
        **({} if b is None else {"backend": b})), mesh=mesh)
        for b in (None, "torch"))
    eng = engines[0]
    if eng.cfg.shard.lane.backend != "cuda" or any(
            d.type != "cuda" for d in eng.mesh):
        fail("the default dist engine is not the cuda backend on the card")
    return engines


def dist_path(args, factory, config, pq, shq, dq, ops, counters, lt,
              bitonic):
    """9a.  Phase 7's cells (fill, mix and at w4096 the quiet ticks)
    through the dist engine at D=2 x l=4 (both positions on the card) and
    D=1 x l=8, each beside its "torch" twin and the sharded L=8 cuda
    engine, every tick: the dist engines bit-equal to the sharded one
    (state gathered) and to their twins, the multiset conserved and the
    envelope held (D=2), nothing dropped.  K3 and K2 counted per position
    against its lane-work ticks and per kernel setting; then µs per tick
    of the three cuda engines in turns, from the filled states."""
    out = {}
    for cell in ("dist_w4096_des", "dist_production_uniform"):
        w4096 = cell.startswith("dist_w4096")
        spec, first, mix_rows, quiet_rows = sharded_cell(args, config, w4096)
        sh = factory.make_engine(factory.EngineSpec(engine="sharded",
                                                    **spec))
        meshes = {"D2x4": dist_pair(factory, 2, 4, TWO_ON_ONE, **spec),
                  "D1x8": dist_pair(factory, 1, 8, None, **spec)}
        for name, (eng, _) in meshes.items():
            if eng.cfg.shard != sh.cfg:
                fail(f"{cell} {name}: the dist config is not sharded L=8's")
        s_sh = sh.init(seed=0)
        states = {name: tuple(e.init(seed=0) for e in pair)
                  for name, pair in meshes.items()}
        cons = Conservation(meshes["D2x4"][0], ops)
        parts = [("fill", first), ("mix", mix_rows)]
        if quiet_rows is not None:
            parts.append(("quiet", quiet_rows))
        torch.cuda.synchronize()
        for w in counters.values():
            w.launches = 0
        ticks = sh_work = 0
        marks = shq.lane_work_marks(s_sh)
        results = {}
        sl = SettingLaunches(lt, bitonic)
        with PositionLaunches(dq, counters) as pl:
            for part, rows in parts:
                if part == "mix":     # the timings start from the fill
                    start = (s_sh, {n: s[0] for n, s in states.items()})
                ak, av, mask, rm = rows
                for t in range(ak.shape[0]):
                    label = f"{cell} {part} tick {t}"
                    batch = (ak[t], av[t], mask[t], rm[t])
                    s_sh, r_sh = sh.tick(s_sh, *batch)
                    marks, before = shq.lane_work_marks(s_sh), marks
                    sh_work += marks > before
                    for name, (e_c, e_t) in meshes.items():
                        with sl:      # the dist engines' launches only
                            s_c, r_c = e_c.tick(states[name][0], *batch)
                        s_t, r_t = e_t.tick(states[name][1], *batch)
                        states[name] = (s_c, s_t)
                        results[name] = r_c
                        leaves_equal(pq, (dq.gather(s_c), r_c), (s_sh, r_sh),
                                     f"{label} {name} vs sharded", t)
                        leaves_equal(pq, (s_c, r_c), (s_t, r_t),
                                     f"{label} {name} vs torch", t)
                    # the dist states equal the sharded one: its counters
                    # are theirs
                    if int(s_sh.lanes.stats.n_dropped.sum()) or int(
                            s_sh.n_router_dropped):
                        fail(f"{label}: the queue dropped keys")
                    cons.tick(label, t, states["D2x4"][0], results["D2x4"],
                              *batch)
                    ticks += 1
                    if part == "quiet" and int(
                            s_sh.lanes.stats.n_chophead.sum()):
                        break
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in counters.items()}
        per_pos = {name: pl.check(f"{cell} {name}", pair[0].cfg
                                  .lanes_per_device, pair[0].work_ticks)
                   for name, pair in meshes.items()}
        dist_k3 = sum(c[1] for cs in per_pos.values() for c in cs)
        sl.check(cell, dist_k3, sum(c[2] for cs in per_pos.values()
                                    for c in cs))
        if launches["fused_tick_mid"] != sh_work + dist_k3:
            fail(f"{cell}: {launches['fused_tick_mid']} K3 launches, "
                 f"expected {sh_work} (sharded) + {dist_k3} (positions)")
        if launches["merge_sorted_kvf"] or launches["radix_select_threshold"]:
            fail(f"{cell}: the dist path launched K1 or K4: {launches}")
        if meshes["D1x8"][0].work_ticks != [sh_work]:
            fail(f"{cell}: D=1 worked on {meshes['D1x8'][0].work_ticks} "
                 f"ticks, sharded on {sh_work}")
        # µs per tick from the filled states, in turns
        window = tuple(x[:30] for x in mix_rows)
        order = [("sharded", sh, start[0])] + [
            (n, meshes[n][0], start[1][n]) for n in ("D2x4", "D1x8")]
        us = {name: [] for name, _, _ in order}
        for name, eng, st in order + order[::-1]:
            us[name].append(host_and_event_us(eng, st, window))
        rec = dict(cell=cell, device=card(), ticks=ticks,
                   resident_after_fill=int(shq.size(start[0])),
                   sharded_work=sh_work, launches=launches,
                   per_position={n: [dict(calls=c[0], k3=c[1], k2=c[2])
                                     for c in cs]
                                 for n, cs in per_pos.items()},
                   shapes=sl.shapes(), worst_rank=cons.worst,
                   us_per_tick_host_and_events=us)
        print(f"dist_path {json.dumps(rec)}", flush=True)
        out[cell] = rec
    return out


def lane_drops(state):
    """Keys the lanes of a dist state have shed (their ``n_dropped``)."""
    return sum(int(p.stats.n_dropped.sum()) for p in state.lanes)


def resident_pairs(ops, eng, state):
    keys, vals, live = eng.resident(state)
    return torch.sort(packed_pairs(ops, keys[live], vals[live])).values


def kill_path(args, factory, config, pq, dq, ops, counters, lt, bitonic,
              at=10, after=30):
    """9b.  Phase 7's w4096 stream through dist D=2 x l=4 (both on the
    card) with ``spare_devices=1``: position 1 is removed at tick ``at``
    (``remove_device``: drain, fold, re-insert), then ``after`` more
    ticks at L=4.  The resize conserves the multiset exactly and the
    router drops nothing.  Every tick the envelope holds (at the new L
    from the first tick after) and the multiset is conserved but for the
    keys the lanes' own counters count as shed: the reference's geometry
    sizes ``spare_devices`` lanes' quotas, not their stores, so the
    surviving lanes shed keys after the kill, in the reference as in the
    port (tests/torch_kill_shed_check.py)."""
    spec, first, mix_rows, _ = sharded_cell(args, config, True)
    q = factory.make_engine(factory.EngineSpec(
        engine="dist", n_devices=2, lanes_per_device=4, spare_devices=1,
        **spec), mesh=TWO_ON_ONE)
    state = q.init(seed=0)
    rows = tuple(torch.cat([a, b[:at + after]]) for a, b in zip(first,
                                                                mix_rows))
    cons = Conservation(q, ops)
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    work = [0, 0]
    with PositionLaunches(dq, counters) as pl, SettingLaunches(
            lt, bitonic) as sl:
        for t in range(rows[0].shape[0]):
            if t == at:
                before = resident_pairs(ops, q, state)
                q0 = q
                q, state = q.remove_device(state, 1)
                if not torch.equal(resident_pairs(ops, q, state), before):
                    fail("kill: the resize lost or invented keys")
                if q.cfg.shard.n_lanes != 4 or len(q.mesh) != 1:
                    fail(f"kill: {q.cfg.shard.n_lanes} lanes after the kill")
                work = q0.work_ticks
                cons.eng = q
            batch = tuple(x[t] for x in rows)
            shed_before = lane_drops(state)
            state, res = q.tick(state, *batch)
            if int(state.n_router_dropped):
                fail(f"kill tick {t}: the router dropped keys")
            if t < at and lane_drops(state):
                fail(f"kill tick {t}: a lane shed keys before the kill")
            cons.tick("kill", t, state, res, *batch,
                      dropped=lane_drops(state) - shed_before)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in counters.items()}
    got = pl.check("kill", 4, [work[0] + q.work_ticks[0], work[1]])
    sl.check("kill", launches["fused_tick_mid"], launches["bitonic_sort_kvf"])
    rec = dict(cell="dist_kill_w4096", device=card(), killed_at=at,
               resident_at_kill=int(before.numel()),
               shed_after_kill=lane_drops(state),
               ticks=int(rows[0].shape[0]), launches=launches,
               per_position=[dict(calls=c[0], k3=c[1], k2=c[2])
                             for c in got], shapes=sl.shapes(),
               worst_rank=cons.worst)
    print(f"kill_path {json.dumps(rec)}", flush=True)
    return rec


#: benchmarks/serve_bench.py's cells at its own kwargs (width 64, D=2 x
#: l=2, n_slots 8, depth cap 48, seed 0), then one wide cell and its chaos
#: twin (width 1024, D=2 x l=4, n_slots 128)
SERVE_CELLS = {
    "serve_steady": dict(rho=0.7, pattern="poisson", ticks=300),
    "serve_over": dict(rho=1.5, pattern="poisson", ticks=500),
    "serve_burst": dict(rho=1.0, pattern="bursty", ticks=300,
                        burst_factor=4.0),
    "serve_chaos": dict(rho=0.9, pattern="poisson", ticks=120,
                        chaos="kill:1@10", spare_devices=1),
    "serve_relaxed": dict(rho=0.7, pattern="poisson", ticks=300,
                          quality=dict(max_defer=3, defer_frac=0.5)),
}
SERVE_NARROW = dict(width=64, lanes_per_device=2, n_slots=8, depth_cap=48)
SERVE_WIDE = dict(width=1024, lanes_per_device=4, n_slots=128)
#: the queues of repro_torch.examples.serve_requests: main (one position)
#: and main_mesh on two positions with one spare (a kill scheduled)
SERVE_EXAMPLE = dict(n_devices=1, lanes_per_device=4, width=64, n_slots=8,
                     depth_cap=48)
MESH_EXAMPLE = dict(n_devices=2, lanes_per_device=2, width=128, n_slots=32,
                    spare_devices=1, depth_cap=192, preroute="on")
WIDE_CELLS = {
    "serve_wide_steady": dict(rho=0.7, pattern="poisson", ticks=300),
    "serve_wide_chaos": dict(rho=0.9, pattern="poisson", ticks=300,
                             chaos="kill:1@10", spare_devices=1),
}


def serve_checks(cell, eng, rec, served_seen):
    """The request engine's contract after one tick: the outcome
    partition is exact, no rid is served twice or before it arrived, the
    depth stays under its cap."""
    total = (sum(eng.outcomes.values()) + eng.depth
             + eng.admission.pending)
    if total != eng.n_arrivals:
        fail(f"{cell} tick {eng.n_ticks}: {total} outcomes for "
             f"{eng.n_arrivals} arrivals")
    for rid in rec["served_rids"]:
        if rid in served_seen or rid >= eng.arrivals.next_rid:
            fail(f"{cell}: phantom or duplicate rid {rid}")
        served_seen.add(rid)
    if eng.depth > eng.policy.depth_cap:
        fail(f"{cell}: depth {eng.depth} over its cap "
             f"{eng.policy.depth_cap}")


def serving_path(args, serving, parse_chaos, dq, counters, bench, lt,
                 bitonic):
    """9c.  Each cell through ``repro_torch.serving.build_engine`` on
    two positions of the card: every tick the checks of
    :func:`serve_checks`; then the drain to empty, the retry flush and the
    exact partition; ticks 50-99 of the two steady cells profiled.
    Prints the quantiles beside BENCH_pq.json's (information only)."""
    out = {}
    cells = [(c, dict(SERVE_NARROW, **kw)) for c, kw in SERVE_CELLS.items()]
    cells += [(c, dict(SERVE_WIDE, **kw)) for c, kw in WIDE_CELLS.items()]
    for cell, kw in cells:
        kw = dict(kw)
        ticks = kw.pop("ticks")
        chaos = kw.pop("chaos", None)
        schedule = parse_chaos(chaos, n_devices=2) if chaos else None
        eng = serving.build_engine(n_devices=2, seed=args.seed,
                                   mesh=TWO_ON_ONE, schedule=schedule, **kw)
        q = eng.queue.queue
        if q.cfg.shard.lane.backend != "cuda" or any(
                d.type != "cuda" for d in q.mesh):
            fail(f"{cell}: the serving queue is not the cuda backend on "
                 "the card")
        torch.cuda.synchronize()
        for w in counters.values():
            w.launches = 0
        served, profile, spent, t, profiled = set(), None, 0.0, 0, 0
        with PositionLaunches(dq, counters) as pl, SettingLaunches(
                lt, bitonic) as sl:
            while t < ticks:
                if t == 50 and cell.endswith("steady"):   # ticks 50-99
                    profile = device_profile(lambda: serve_checks(
                        cell, eng, eng.tick(), served), 50)
                    # (and 100-149, ... for a window profiled again)
                    profiled = 50 * (len(profile["windows"]) if profile
                                     else 1)
                    t += profiled
                    continue
                t0 = time.perf_counter()
                rec = eng.tick()
                spent += time.perf_counter() - t0
                serve_checks(cell, eng, rec, served)
                t += 1
            drain = eng.drain()
            for _ev in eng.admission.flush(eng.clock.now):
                eng.outcomes[serving.SHED] += 1
        torch.cuda.synchronize()
        r = eng.report()
        if (r["served"] + r["shed"] + r["expired"] != r["arrivals"]
                or r["in_flight"] or r["retry_pending"]
                or eng.queue.size() != 0):
            fail(f"{cell}: did not drain to an exact partition: {r}")
        if chaos and len(eng.queue.live) != 1:
            fail(f"{cell}: the scheduled kill never fired")
        launches = {k: w.launches for k, w in counters.items()}
        k3 = sum(c[1] for c in pl.calls.values())
        k2 = sum(c[2] for c in pl.calls.values())
        # (pre-route elimination serves every request of a tick whose
        # arrivals fit the free slots: only the others reach the lanes)
        calls = sum(c[0] for c in pl.calls.values())
        if not (calls == k3 == k2 == launches["fused_tick_mid"]
                == launches["bitonic_sort_kvf"]):
            fail(f"{cell}: K3 {launches['fused_tick_mid']} and K2 "
                 f"{launches['bitonic_sort_kvf']} launches, {k3} / {k2} "
                 f"inside the positions' {calls} lane-work runs")
        sl.check(cell, k3, k2)
        n_timed = ticks - profiled
        rec = dict(cell=cell, device=card(), ticks=ticks, drain_ticks=drain,
                   arrivals=r["arrivals"], served=r["served"],
                   shed=r["shed"], expired=r["expired"],
                   shed_reasons=r["shed_reasons"], max_depth=r["max_depth"],
                   depth_cap=r["depth_cap"], p50=r["p50"], p99=r["p99"],
                   p999=r["p999"], live_devices=r["live_devices"],
                   bench_pq=bench.get(cell), k3=k3, k2=k2,
                   shapes=sl.shapes(),
                   us_per_serving_tick=spent / n_timed * 1e6,
                   profile=profile)
        print(f"serving_path {json.dumps(rec)}", flush=True)
        out[cell] = rec
    if not sum(r["k3"] for r in out.values()):
        fail("the serving cells never launched K3")
    return out


def held_settings(records, records_k3):
    """The settings phases 3 and 6 held against their plain versions: K3
    records by (lane geometry, grid), K2 records by [rows, width]."""
    k3_at, k2_at = {}, {}
    for r in records_k3.values():
        k3_at.setdefault((r["geometry"], r["lanes"]), r)
    for label, r in records.items():
        m = re.fullmatch(r"sort_kvf .*\[(\d+), (\d+)\] uniform", label)
        if m:
            k2_at.setdefault((int(m[1]), int(m[2])), r)
    return k3_at, k2_at


def setting_kernels(group, k3, k2, held):
    """The kernels line's entries of one group of runs: one K3 row per
    lane geometry and grid (``k3[(geometry, grid)]`` launches) and one K2
    row per router shape (``k2[(rows, width)]``), each with the launches
    made at that setting and the error and timings phases 3 and 6 took
    at the same setting.  A setting with launches that neither phase held
    against its plain version fails the run."""
    k3_at, k2_at = held
    kernels = []
    for (g, l), n in k3.items():
        r = k3_at.get((g, l))
        if r is None:
            fail(f"{group}: {n} K3 launches at grid {l} on lanes {g}, a "
                 "setting phase 3 did not hold against its plain version")
        kernels.append(dict(
            name=f"lane_tick[{group} {r['setting']}]", route="cuda",
            source="src/repro_torch/kernels/csrc/lane_tick.cu",
            replaces="src/repro/kernels/lane_tick.py:185",
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=None))
    for (l, n_), n in k2.items():
        r = k2_at.get((l, n_))
        if r is None:
            fail(f"{group}: {n} K2 launches on [{l}, {n_}] rows, a shape "
                 "phase 6 did not hold against its plain version")
        kernels.append(dict(
            name=f"bitonic_sort_kvf[router {group} [{l}, {n_}]]",
            route="cuda", source="src/repro_torch/kernels/csrc/bitonic.cu",
            replaces="src/repro/kernels/bitonic.py:89",
            launches=n, max_abs_err=r["max_abs_err"],
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}))
    return kernels


def serving_kernels(held, dist, kill, served):
    """The kernels line's entries of phase 9, per group of cells."""
    kernels = []
    for group, recs in (
            ("dist_w4096_des", [dist["dist_w4096_des"]]),
            ("dist_production_uniform", [dist["dist_production_uniform"]]),
            ("dist_kill_w4096", [kill]),
            ("serving W64", [served[c] for c in SERVE_CELLS]),
            ("serving W1024", [served[c] for c in WIDE_CELLS])):
        k3, k2 = {}, {}
        for rec in recs:
            at3, at2 = rec["shapes"]
            for g, l, n in at3:
                k3[g, l] = k3.get((g, l), 0) + n
            for l, n, k in at2:
                k2[l, n] = k2.get((l, n), 0) + k
        kernels += setting_kernels(group, k3, k2, held)
    return kernels


# ---------------------------------------------------------------------------
# phase 10: the queue's other users (the priority sampler, the examples)
# and the roofline
# ---------------------------------------------------------------------------

#: 10a: the sampler's groups, steps and batch, at PRODUCTION
SAMPLER_GROUPS, SAMPLER_STEPS, SAMPLER_K = 1024, 200, 256


class OracleFeed:
    """The heapq oracle beside every sampler queue's ticks: while active,
    ``_HostPQ.submit_and_acquire`` (the class's, wrapped) feeds each
    tick's arrivals and removals to a ``RefPQ`` per queue and fails when
    the gids served do not carry the oracle's smallest keys."""

    def __init__(self, host_cls, RefPQ):
        self.host_cls, self.RefPQ = host_cls, RefPQ
        self.refs, self.keys = {}, {}
        self.checked = 0

    def __enter__(self):
        inner = self.saved = self.host_cls.submit_and_acquire
        feed = self

        def checked(host, arrivals, free_slots):
            out = inner(host, arrivals, free_slots)
            ref = feed.refs.setdefault(id(host), feed.RefPQ())
            keys = feed.keys.setdefault(id(host), {})
            f32 = np.float32([k for _, k in arrivals])
            for (gid, _), k in zip(arrivals, f32):
                keys[gid] = k
            exp = np.sort(np.float32([k for k, _ in ref.tick(
                f32.tolist(), [g for g, _ in arrivals],
                min(free_slots, host.cfg.r_max)) if k != np.inf]))
            got = np.sort(np.float32([keys[g] for g in out]))
            if not np.array_equal(got, exp):
                fail(f"sampler: served keys differ from the oracle's "
                     f"{len(exp)} smallest")
            feed.checked += 1
            return out

        self.host_cls.submit_and_acquire = checked
        return self

    def __exit__(self, *exc):
        self.host_cls.submit_and_acquire = self.saved


def sampler_path(args, config, data, priority_sampler, RefPQ, counters,
                 lt, bitonic):
    """10a.  ``PrioritySampler(n_groups=1024, cfg=PRODUCTION)`` on the
    card beside its "torch" twin on the card: 200 steps of
    ``next_groups(256)``, ``report`` with losses drawn from the seed and
    ``requeue``.  Every step the two pick the same gids and every tick
    serves the heapq oracle's smallest keys; the final ``breakdown()``s
    are equal.  µs per step on the host clock, the two in turns; then a
    profiled window of 20 more steps of the card's sampler, and from it
    K3's device ms per launch on this path."""
    prod = config.PRODUCTION
    twin_cfg = dataclasses.replace(prod, backend="torch")
    rng = np.random.default_rng(args.seed + 10)
    torch.cuda.synchronize()
    for w in counters.values():
        w.launches = 0
    spent = {"cuda": 0.0, "torch": 0.0}
    with SettingLaunches(lt, bitonic) as sl, OracleFeed(
            priority_sampler._HostPQ, RefPQ) as feed:
        samplers = {
            "cuda": data.PrioritySampler(SAMPLER_GROUPS, cfg=prod,
                                         seed=args.seed),
            "torch": data.PrioritySampler(SAMPLER_GROUPS, cfg=twin_cfg,
                                          seed=args.seed)}
        if samplers["cuda"].sched.state.seq_keys.device.type != "cuda":
            fail("sampler: the default device is not the card")
        for step in range(SAMPLER_STEPS):
            losses = rng.exponential(2.0, SAMPLER_K)
            picked = {}
            order = ("cuda", "torch") if step % 2 == 0 else ("torch", "cuda")
            for name in order:
                s = samplers[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gids = s.next_groups(SAMPLER_K)
                for g, loss in zip(gids, losses):
                    s.report(g, float(loss))
                s.requeue(gids)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                picked[name] = gids
            if picked["cuda"] != picked["torch"]:
                fail(f"sampler step {step}: the card's groups differ from "
                     "the torch twin's")
            if len(picked["cuda"]) != SAMPLER_K:
                fail(f"sampler step {step}: {len(picked['cuda'])} groups")
        torch.cuda.synchronize()
    launches = {k: w.launches for k, w in counters.items()}
    n_ticks = 1 + 2 * SAMPLER_STEPS
    brk = {n: s.breakdown() for n, s in samplers.items()}
    if brk["cuda"] != brk["torch"]:
        fail(f"sampler: breakdown {brk['cuda']} != the twin's {brk['torch']}")
    if launches["fused_tick_mid"] != n_ticks or any(
            v for k, v in launches.items() if k != "fused_tick_mid"):
        fail(f"sampler: launches {launches}, expected K3 on each of "
             f"{n_ticks} ticks and nothing else")
    if feed.checked != 2 * n_ticks:
        fail(f"sampler: the oracle saw {feed.checked} ticks")
    cuda = samplers["cuda"]

    def step():
        gids = cuda.next_groups(SAMPLER_K)
        for g in gids:
            cuda.report(g, 1.0)
        cuda.requeue(gids)
    # the profile's "tick" is a step here: two K3 launches
    profile = device_profile(step, 20)
    rec = dict(cell="sampler_production", device=card(),
               groups=SAMPLER_GROUPS, steps=SAMPLER_STEPS, k=SAMPLER_K,
               launches=launches, breakdown=brk["cuda"],
               us_per_step={n: v / SAMPLER_STEPS * 1e6
                            for n, v in spent.items()},
               profile_per_step=profile,
               k3_ms_per_launch=profile and sum(
                   profile["lane_tick_us_per_tick"].values()) / 2e3,
               cfg=prod, k3=sl.k3, k2=sl.k2)
    print(f"sampler_path {json.dumps({k: v for k, v in rec.items() if k not in ('cfg', 'k3', 'k2')})}",
          flush=True)
    return rec


def _same(a, b):
    """Equal example outputs: arrays bit for bit, floats by bits,
    everything else by ==; ``us_per_tick`` (a host time) is skipped."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a if k != "us_per_tick")
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(
            a.view(np.int32) if a.dtype == np.float32 else a,
            b.view(np.int32) if b.dtype == np.float32 else b)
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


#: 10b: the mesh example's positions and kill
MESH_CHAOS = "kill:1@8"


def examples_path(ex, counters, lt, bitonic):
    """10b.  Each example module's ``main`` on the card under the "cuda"
    backend (its own asserts hold), beside its "torch" twin on the card
    where it has one (event_sim, quickstart, serve_requests.main: every
    number equal); ``serve_requests.main_mesh`` on two positions of the
    card with a kill of position 1 at t=8; ``dev_check_pq`` under "cuda"
    must print ALL OK.  Launches counted per example and setting."""
    out = {}
    runs = (
        ("event_sim", lambda b: ex.event_sim.main("cuda", b), True),
        ("quickstart", lambda b: ex.quickstart.main("cuda", b), True),
        ("serve_requests main",
         lambda b: ex.serve_requests.main("cuda", b), True),
        ("serve_requests main_mesh",
         lambda b: ex.serve_requests.main_mesh(
             TWO_ON_ONE, chaos=MESH_CHAOS, device="cuda", backend=b),
         False),
        ("dev_check_pq", lambda b: ex.dev_check_pq.main("cuda", b), False))
    for name, run, twin in runs:
        torch.cuda.synchronize()
        for w in counters.values():
            w.launches = 0
        t0 = time.perf_counter()
        with SettingLaunches(lt, bitonic) as sl:
            got = run("cuda")
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: w.launches for k, w in counters.items()}
        if twin and not _same(got, run("torch")):
            fail(f"{name}: the cuda run's numbers differ from the torch "
                 "twin's on the card")
        if launches["merge_sorted_kvf"] or launches["radix_select_threshold"]:
            fail(f"{name}: launched K1 or K4: {launches}")
        sl.check(name, launches["fused_tick_mid"],
                 launches["bitonic_sort_kvf"])
        out[name] = dict(result=got, launches=launches, k3=sl.k3, k2=sl.k2,
                         seconds=seconds)
        print(f"example {name}: {seconds:.1f} s, launches {launches}",
              flush=True)
    mesh = out["serve_requests main_mesh"]["result"]
    if mesh["removed"] != [1] or mesh["report"]["live_devices"] != [0]:
        fail(f"main_mesh: the kill did not fire as scheduled: {mesh}")
    if not out["dev_check_pq"]["result"]["ok"]:
        fail("dev_check_pq: not ALL OK")
    for name in ("event_sim", "quickstart", "serve_requests main",
                 "dev_check_pq"):
        if not out[name]["launches"]["fused_tick_mid"]:
            fail(f"{name}: never launched the lane tick")
    for name in ("quickstart", "serve_requests main"):
        if not out[name]["launches"]["bitonic_sort_kvf"]:
            fail(f"{name}: never launched the router's sort")
    return out


def roofline_path(w4096_run, prod_run, sharded, sampler, records,
                  records_k3, traffic, record_from_traffic):
    """10c.  A roofline record per engine cell of phases 4, 5 and 7 and
    for the sampler, from their timings and ``traffic``'s count of one
    tick; each kernel setting of phases 3 and 6 with its bound from
    ``traffic`` beside its own buffers' (the yardstick before).  Fails if
    any measured time falls under its bound."""
    cells = []
    for cell, run, count in (
            ("w4096_p50_des", w4096_run, traffic.pqe_tick(w4096_run["cfg"])),
            ("production_p50_uniform", prod_run,
             traffic.pqe_tick(prod_run["cfg"])),
            *((c, r, traffic.sharded_tick(r["cfg"]))
              for c, r in sharded.items())):
        t = run["timing"]
        for us in t["us_per_tick_cuda"]:
            cells.append((cell, record_from_traffic(
                count, us * 1e-6 * t["ticks"], t["ticks"], "cuda")))
    # a sampler step is two ticks
    count = traffic.pqe_tick(sampler["cfg"])
    cells.append(("sampler_production", record_from_traffic(
        count, sampler["us_per_step"]["cuda"] * 1e-6 * sampler["steps"],
        2 * sampler["steps"], "cuda")))
    for cell, rec in cells:
        print(f"roofline {cell} {json.dumps(rec)}", flush=True)
        if rec["frac_bound"] > 1.0:
            fail(f"{cell}: measured time under its traffic bound: {rec}")
    yardstick = {}
    for phase, recs in (("3", records_k3.values()), ("6", records.values())):
        for r in recs:
            name = r.get("setting") or r["op"]
            yardstick[f"{phase} {name}"] = dict(
                bytes=r["bytes"], buffer_bytes=r["buffer_bytes"],
                bound_ms=r["bound_ms"])
            if r["ms"] is not None and r["ms"] < r["bound_ms"]:
                fail(f"{name}: {r['ms']} ms, under its bound "
                     f"{r['bound_ms']} ms")
    print(f"yardstick {json.dumps(yardstick)}", flush=True)
    return cells


def sampler_stream(args, priority_sampler, cfg, steps):
    """10a's ticks as K3 input rows: the first ``steps`` steps of its
    sampler (seed and losses as 10a draws them) and one more
    ``next_groups``, each tick's arrivals and removeMin count recorded
    off a sampler of config ``cfg`` on the card."""
    ticks = []
    host = priority_sampler._HostPQ
    inner = host.submit_and_acquire

    def recorded(h, arrivals, free_slots):
        ticks.append((arrivals, min(free_slots, h.cfg.r_max)))
        return inner(h, arrivals, free_slots)

    host.submit_and_acquire = recorded
    try:
        s = priority_sampler.PrioritySampler(SAMPLER_GROUPS, cfg=cfg,
                                             seed=args.seed)
        rng = np.random.default_rng(args.seed + 10)
        for _ in range(steps):
            losses = rng.exponential(2.0, SAMPLER_K)
            gids = s.next_groups(SAMPLER_K)
            for g, loss in zip(gids, losses):
                s.report(g, float(loss))
            s.requeue(gids)
        s.next_groups(SAMPLER_K)
    finally:
        host.submit_and_acquire = inner
    shape = (len(ticks), cfg.a_max)
    ak = np.full(shape, np.inf, np.float32)
    av = np.full(shape, -1, np.int32)
    mask = np.zeros(shape, bool)
    for t, (arrivals, _) in enumerate(ticks):
        ak[t, :len(arrivals)] = [k for _, k in arrivals]
        av[t, :len(arrivals)] = [g for g, _ in arrivals]
        mask[t, :len(arrivals)] = True
    return to_device((ak, av, mask, np.int32([n for _, n in ticks])))


def kernel_settings_path(args, config, factory, serving, examples,
                         priority_sampler, lt, pq, traffic):
    """Phase 3: the lane-tick kernel against its plain version at every
    lane geometry and grid a later phase launches it at.  Returns
    {setting: record}."""
    repair_cfg = config.PQConfig(    # every pass fires at this geometry
        a_max=64, r_max=64, seq_cap=512, n_buckets=4, bucket_cap=8,
        detach_min=4, detach_max=64, detach_init=8, chop_patience=3,
        backend="torch")
    w4096 = factory.resolved_base(
        factory.EngineSpec(engine="pqe", width=4096, backend="torch"))
    prod = factory.resolved_base(factory.EngineSpec(
        engine="pqe", width=1024, base=config.PRODUCTION, backend="torch"))
    records_k3 = {}

    def repair_streams(lanes, ties=False):
        return [to_device(batch_rows(64, *repair_stream(
            np.random.default_rng(args.seed + 100 + i), 64, 26, ties)))
            for i in range(lanes)]

    def mix_streams(lanes, width, warm_ticks, ticks, dist):
        out = []
        for i in range(lanes):
            rng = np.random.default_rng(args.seed + 200 + i)
            keys = [rng.uniform(0, KEY_HI, width).astype(np.float32)
                    for _ in range(warm_ticks)]
            mix, rms, _ = mix_keys(rng, width, 0.5, ticks, dist)
            out.append(to_device(batch_rows(width, keys + mix,
                                            [0] * warm_ticks + rms)))
        return out

    def hold(name, cfg, streams, check_from, head_tile=None):
        records_k3[name] = kernel_vs_plain(name, cfg, streams, check_from,
                                           lt, pq, traffic, head_tile)
        return records_k3[name]

    for lanes in (1, 4):
        hold(f"repair_L{lanes}", repair_cfg, repair_streams(lanes), 0)
        hold(f"repair_L{lanes}_tile64", repair_cfg, repair_streams(lanes),
             0, head_tile=64)
    for lanes in (1, 3):
        hold(f"duplicates_L{lanes}_tile64", repair_cfg,
             repair_streams(lanes, ties=True), 0, head_tile=64)
    hold("w4096_L1", w4096, mix_streams(1, 4096, 1, 12, "des"), 1)
    hold("w4096_L8", w4096, mix_streams(8, 4096, 1, 6, "des"), 1)
    hold("production_L1", prod, mix_streams(1, 1024, 16, 6, "uniform"), 16)
    # the lane geometries of phase 7's cells, all eight lanes in one launch
    for cell, spec, dist, warm in (
            ("sharded_w4096", dict(width=4096), "des", 1),
            ("sharded_production", dict(width=1024, base=config.PRODUCTION),
             "uniform", 16)):
        lane = factory.make_engine(factory.EngineSpec(
            engine="sharded", lanes=8, backend="torch", **spec)).cfg.lane
        hold(f"{cell}_L8", lane, mix_streams(8, lane.a_max, warm, 6, dist),
             warm)
        # phase 9a's D=2 positions: four of these lanes a launch
        hold(f"{cell}_L4", lane, mix_streams(4, lane.a_max, warm, 6, dist),
             warm)
    # the adaptive engine's fold-headroom lane geometry (min_lanes=1) of
    # phase 8c, at both lane counts it runs
    fold_lane = factory.make_engine(factory.EngineSpec(
        engine="sharded", width=4096, lanes=8, min_lanes=1,
        backend="torch")).cfg.lane
    for lanes in (8, 1):
        hold(f"adaptive_fold_L{lanes}", fold_lane,
             mix_streams(lanes, fold_lane.a_max, 1, 6, "des"), 1)

    # phase 9's other lane geometries: the kill cell's spare-sized lanes
    # (grid 4), the serving cells' at width 64 (grid 2) and 1024 (grid 4),
    # each without and with a spare position (the chaos cells)
    kill_lane = factory.make_engine(factory.EngineSpec(
        engine="dist", width=4096, lanes=8, n_devices=2, lanes_per_device=4,
        spare_devices=1, backend="torch"), device="cpu").cfg.shard.lane
    hold("dist_kill_L4", kill_lane, mix_streams(4, kill_lane.a_max, 1, 6,
                                                "des"), 1)

    def serving_lane(**kw):
        return serving.build_engine(device="cpu", backend="torch", **{
            k: v for k, v in kw.items() if k != "depth_cap"}
        ).queue.queue.cfg.shard.lane

    for setting, kw, lanes in (("serve64_L2", SERVE_NARROW, 2),
                               ("serve1024_L4", SERVE_WIDE, 4)):
        for spare, suffix in ((0, ""), (1, "_spare")):
            lane = serving_lane(n_devices=2, spare_devices=spare, **kw)
            hold(setting + suffix, lane,
                 mix_streams(lanes, lane.a_max, 1, 6, "des"), 1)

    # phase 10's settings: the sampler's default queue (PRODUCTION is
    # held above), the examples' queues and lanes, the dev check's two
    # configs
    for name, cfg in (("sampler_default_L1", priority_sampler.DEFAULT_CFG),
                      ("event_sim_L1", examples.event_sim.CFG),
                      ("quickstart_L1", examples.quickstart.BASE),
                      ("dev_check_small_L1", config.SMALL),
                      ("dev_check_tiny_L1", examples.dev_check_pq.TINY)):
        cfg = dataclasses.replace(cfg, backend="torch")
        hold(name, cfg, mix_streams(1, cfg.a_max, 1, 6, "des"), 1)
    for name, lane, lanes in (
            ("quickstart_sharded_L4", factory.make_engine(factory.EngineSpec(
                engine="sharded", width=64, lanes=4, backend="torch"),
                device="cpu").cfg.lane, 4),
            ("serve_example_L4", serving_lane(**SERVE_EXAMPLE), 4),
            ("mesh_example_spare_L2", serving_lane(**MESH_EXAMPLE), 2)):
        hold(name, lane, mix_streams(lanes, lane.a_max, 1, 6, "des"), 1)
    # phase 12's settings: dev_check_dist's lanes at D=8 x l=2 (grid 2)
    # and on the single-device sharded queue it is held to (grid 16);
    # train_lm's sampler runs on the default queue held above
    dd_lane = factory.make_engine(examples.dev_check_dist.spec("torch"),
                                  device="cpu").cfg.shard.lane
    for lanes in (examples.dev_check_dist.LPD,
                  examples.dev_check_dist.D * examples.dev_check_dist.LPD):
        hold(f"dev_check_dist_L{lanes}", dd_lane,
             mix_streams(lanes, dd_lane.a_max, 1, 6, "des"), 1)
    # 10a's own ticks at PRODUCTION (1024 residents, steps of 256): the
    # sampler's kernel row reads this record, not production_L1's
    prod = dataclasses.replace(config.PRODUCTION, backend="torch")
    hold("sampler_production_L1", prod,
         [sampler_stream(args, priority_sampler, prod, 3)], 1)
    return records_k3


# ---------------------------------------------------------------------------
# phase 11: the model stack's serving path
# ---------------------------------------------------------------------------

#: 11a: gemma-2b whole, four prompts of 512 tokens, 32 greedy steps
FULL_ARCH, FULL_BATCH, FULL_PROMPT, FULL_STEPS = "gemma-2b", 4, 512, 32
#: 11b: every other arch, two prompts of 512 tokens, 8 steps, chunks of 256
GROUP_BATCH, GROUP_PROMPT, GROUP_STEPS, GROUP_CHUNK = 2, 512, 8, 256
#: archs that 11b runs whole (every other is cut to one pattern group)
GROUP_WHOLE = ("xlstm-350m", "whisper-tiny")
#: max |a - b| over max(1, max |b|): bf16 (the port against itself at
#: other shapes and sum orders: one-token steps against the whole
#: sequence, chunks of 256 against one shot) and float32 (TF32 off)
TF_TOL_BF16, TF_TOL_F32 = 5e-2, 1e-3
#: archs whose bf16 decode departs from their own bf16 forward by more
#: than TF_TOL_BF16 in the reference too: on the same weights, xlstm-350m
#: drifts 0.195 in the reference and 0.520 in the port, and 0.138-0.682
#: in the reference with its float32 weights nudged by one rounding (24
#: recurrent layers amplify rounding ~1e4 times; float32: 8.1e-4, 9.2e-4
#: and 7.5e-4-1.1e-3; tests/torch_model_drift_check.py); 11b records
#: their bf16 drift and holds their float32 copy to the tolerance given
DRIFTS = {"xlstm-350m": 1e-2}
#: 11c: the card against the port on the CPU, reduced configs, float32
CPU_TOL = 1e-4


def rel(a, b) -> float:
    """max |a - b| over max(1, max |b|), both moved to the CPU."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    if a.shape != b.shape:
        fail(f"shapes differ: {tuple(a.shape)} against {tuple(b.shape)}")
    if not torch.isfinite(a).all():
        fail("a non-finite value")
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def model_inputs(cfg, batch, prompt, seed, device):
    """Prompt tokens and the frontend stub inputs, from the seed."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt),
                                         dtype=np.int32)).to(device)
    extras = {}
    if cfg.frontend == "vit":
        extras["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model),
            dtype=np.float32)).to(device)
    if cfg.frontend == "audio":
        extras["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model), dtype=np.float32)).to(device)
    return toks, extras


def serve_run(tf, serve, cfg, params, toks, extras, steps, feed=None,
              mesh=None):
    """``make_prefill_step``, then ``steps`` ``make_decode_step``s, each
    fed the greedy token of the step before (or ``feed``'s); on ``mesh``
    (phase 13) the parameters come placed and the caches are placed by
    ``cache_shardings``.  Returns
    the logits at every generated position [B, steps + 1, V], the tokens
    fed [B, steps], the caches, the prefill's host and event ms (the first
    call of a process also pays its library set-up), the decode steps'
    event ms each (host included: the host issues every launch) and the
    host-clocked tokens/s."""
    b, s = toks.shape
    pre = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    dev = toks.device
    caches = tf.init_decode_caches(cfg, b, pre + s + steps, dev)
    if mesh is not None:
        from repro_torch import dist
        caches = dist.device_put(caches, serve.cache_shardings(cfg, mesh,
                                                               caches))
    prefill = serve.make_prefill_step(cfg, mesh=mesh)
    decode = serve.make_decode_step(cfg, mesh=mesh)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    last, caches = prefill(params, caches, toks, **extras)
    end.record()
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_event_ms = start.elapsed_time(end)
    logits, fed = [last[:, 0]], []
    t0 = time.perf_counter()
    start.record()
    for i in range(steps):
        tok = (feed[:, i:i + 1] if feed is not None else
               logits[-1][:, :cfg.vocab].argmax(-1, keepdim=True).int())
        fed.append(tok)
        out, caches = decode(params, caches, tok, torch.full(
            (b,), pre + s + i, dtype=torch.int32, device=dev))
        logits.append(out[:, 0])
    end.record()
    torch.cuda.synchronize()
    return dict(logits=torch.stack(logits, 1), fed=torch.cat(fed, 1),
                caches=caches, prefill_host_ms=1e3 * prefill_s,
                prefill_event_ms=prefill_event_ms,
                decode_event_ms=start.elapsed_time(end) / steps,
                tokens_per_s=b * steps / (time.perf_counter() - t0))


def teacher_forcing(tf, cfg, params, toks, extras, run, tol, label):
    """``forward`` over prompt + fed tokens against every generated
    position's logits (``tol``), and the greedy tokens equal where the
    forward's top-2 margin exceeds twice the tolerance.  An arch whose
    prefill needs chunk multiples (Mamba2, mLSTM) reads a forward padded
    with token 0 to a multiple of 256: the model is causal, so the
    positions compared see no padding."""
    seq = torch.cat([toks, run["fed"]], 1)
    if any(k in cfg.layer_pattern for k in "MX"):
        seq = torch.nn.functional.pad(seq, (0, (-seq.shape[1]) % 256))
    pre = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    s, n = toks.shape[1], run["logits"].shape[1]
    full, _ = tf.forward(cfg, params, seq, **extras)
    want = full[:, pre + s - 1:pre + s - 1 + n].float()
    del full
    got = run["logits"].float()
    err = rel(got, want)
    if err > tol:
        fail(f"{label}: decode logits differ from forward's by {err:.3e} "
             f"(> {tol})")
    top2 = want[..., :cfg.vocab].topk(2, dim=-1).values
    scale = max(1.0, float(want.abs().max()))
    wide = (top2[..., 0] - top2[..., 1]) > 2 * tol * scale
    same = got[..., :cfg.vocab].argmax(-1) == want[..., :cfg.vocab].argmax(-1)
    if not bool(same[wide].all()):
        fail(f"{label}: a greedy token differs where the margin allows")
    return dict(err=err, greedy_checked=int(wide.sum()),
                greedy_equal=float(same.float().mean()))


def step_profiles(serve, cfg, params, toks, run, last, reps, extras={},
                  mesh=None):
    """The device time of a prefill and of the last decode step, each
    called again ``reps[name]`` times under the profiler (both are
    idempotent: they write the same values to the same cache slots):
    every device event summed per call, the share of the window's wall it
    fills, the top kernels."""
    prefill = serve.make_prefill_step(cfg, mesh=mesh)
    decode = serve.make_decode_step(cfg, mesh=mesh)
    caches, b = run["caches"], toks.shape[0]
    pos = torch.full((b,), last, dtype=torch.int32, device=toks.device)
    steps = {"prefill": lambda: prefill(params, caches, toks, **extras),
             "decode": lambda: decode(params, caches, run["fed"][:, -1:],
                                      pos)}
    out = {}
    for name, n in reps.items():
        rec = _profile_window(steps[name], n)
        if rec is None:
            fail(f"{cfg.name}: the profiler recorded no device time")
        out[name] = {k: rec[k] for k in (
            "wall_us_per_tick", "device_us_per_tick",
            "device_events_per_tick", "device_busy_share",
            "top_other_device_us_per_tick")}
    return out


def serve_bounds(traffic, cfg, batch, seq, last):
    """The least ms a prefill of ``batch`` x ``seq`` positions and a
    decode step at position ``last`` could take on the card
    (``traffic.model_prefill`` / ``model_decode`` bytes against
    ``model_step_flops``), with their bytes and FLOPs."""
    pre = traffic.model_prefill(cfg, batch, seq)
    dec = traffic.model_decode(cfg, batch, batch * (last + 1))
    pre_flops = traffic.model_step_flops(cfg, batch * seq, batch)
    dec_flops = traffic.model_step_flops(cfg, batch, batch)
    return dict(
        prefill_bound_ms=1e3 * traffic.model_bound_s(pre, pre_flops),
        prefill_bytes=pre.hbm_bytes, prefill_flops=pre_flops,
        decode_bound_ms=1e3 * traffic.model_bound_s(dec, dec_flops),
        decode_bytes=dec.hbm_bytes, decode_flops=dec_flops)


def check_bounds(rec, keys):
    """No measured time under its step's bound (a wrong count)."""
    for key in keys:
        bound = rec[key.split("_")[0] + "_bound_ms"]
        if rec[key] < bound:
            fail(f"{rec['arch']}: {key} {rec[key]:.4f} under its bound "
                 f"{bound:.4f}")


def full_size_path(args, tf, serve, traffic, smi):
    """11a.  gemma-2b at its published configuration from a seeded
    generator on the card: four prompts of 512 tokens, one prefill step
    and 32 greedy decode steps; decode against ``forward`` (teacher
    forcing) in bf16, then the same tokens through a float32 copy of the
    weights at a tight tolerance; times on the device clock beside their
    bounds."""
    from repro_torch.configs import get_config
    from repro_torch.roofline import hw, model_flops
    cfg = get_config(FULL_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = tf.init_params(cfg, gen, "cuda")
    n_params = tf.param_count(params)
    toks, _ = model_inputs(cfg, FULL_BATCH, FULL_PROMPT, args.seed, "cuda")
    run = serve_run(tf, serve, cfg, params, toks, {}, FULL_STEPS)
    tforce = teacher_forcing(tf, cfg, params, toks, {}, run, TF_TOL_BF16,
                             f"{FULL_ARCH} bf16")
    last = FULL_PROMPT + FULL_STEPS - 1
    prof = step_profiles(serve, cfg, params, toks, run, last,
                         dict(prefill=2, decode=5))
    peak = torch.cuda.max_memory_allocated()
    tokens = FULL_BATCH * FULL_PROMPT
    rec = dict(
        arch=FULL_ARCH, params=n_params, batch=FULL_BATCH,
        prompt=FULL_PROMPT, steps=FULL_STEPS, card=smi,
        prefill_ms=prof["prefill"]["device_us_per_tick"] / 1e3,
        prefill_host_ms=run["prefill_host_ms"],
        decode_ms=prof["decode"]["device_us_per_tick"] / 1e3,
        decode_event_ms=run["decode_event_ms"],
        **serve_bounds(traffic, cfg, FULL_BATCH, FULL_PROMPT, last),
        tokens_per_s=run["tokens_per_s"], max_memory_allocated=peak,
        teacher_forcing_bf16=tforce, profiles=prof)
    # the reference's MFU convention: 2·N·D (analysis.model_flops)
    rec["prefill_model_flops"] = model_flops(cfg, "prefill", tokens)
    rec["prefill_peak_share"] = rec["prefill_model_flops"] / (
        1e-3 * rec["prefill_ms"] * hw.PEAK_FLOPS)
    check_bounds(rec, ("prefill_ms", "decode_ms"))
    fed = run["fed"]
    del run
    # the float32 copy (about 10 GB), fed the bf16 run's tokens, no TF32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tf.tree_map(lambda t: t.float(), params)
    run32 = serve_run(tf, serve, cfg32, params, toks, {}, FULL_STEPS,
                      feed=fed)
    rec["teacher_forcing_f32"] = teacher_forcing(
        tf, cfg32, params, toks, {}, run32, TF_TOL_F32, f"{FULL_ARCH} f32")
    rec["max_memory_allocated_f32"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def group_cfg(cfg):
    """11b's config: full width, cut in depth to one pattern group (but
    GROUP_WHOLE); MoE at capacity factor n_experts / top_k, where no
    assignment is dropped, so that forward, one-shot and chunked prefill
    route every token as the one-token steps do."""
    cuts = []
    if cfg.name not in GROUP_WHOLE and cfg.n_layers > len(cfg.layer_pattern):
        cuts.append(f"n_layers {cfg.n_layers} -> {len(cfg.layer_pattern)}")
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern))
    if cfg.family == "moe":
        cap = cfg.n_experts / cfg.top_k
        cuts.append(f"capacity_factor {cfg.capacity_factor} -> {cap}")
        cfg = dataclasses.replace(cfg, capacity_factor=cap)
    return cfg, cuts


def group_path(args, tf, serve, traffic, arch, smi):
    """11b.  One arch at full width (``group_cfg``): two prompts of 512
    tokens, prefill and 8 greedy decode steps, teacher forcing in bf16;
    where the reference runs it, chunked prefill at chunk_len=256 against
    a one-shot prefill of the same tokens (caches and logits)."""
    from repro_torch.configs import get_config
    cfg, cuts = group_cfg(get_config(arch))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = tf.init_params(cfg, gen, "cuda")
    toks, extras = model_inputs(cfg, GROUP_BATCH, GROUP_PROMPT, args.seed,
                                "cuda")
    run = serve_run(tf, serve, cfg, params, toks, extras, GROUP_STEPS)
    pre = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    last = pre + GROUP_PROMPT + GROUP_STEPS - 1
    prof = step_profiles(serve, cfg, params, toks, run, last,
                         dict(decode=3), extras)
    rec = dict(arch=arch, params=tf.param_count(params), cuts=cuts,
               layers=cfg.n_layers, card=smi,
               prefill_event_ms=run["prefill_event_ms"],
               decode_ms=prof["decode"]["device_us_per_tick"] / 1e3,
               decode_event_ms=run["decode_event_ms"],
               tokens_per_s=run["tokens_per_s"], profiles=prof)
    if arch in DRIFTS:
        # its own float32 copy holds the check; bf16's drift is recorded
        rec["teacher_forcing_bf16"] = teacher_forcing(
            tf, cfg, params, toks, extras, run, float("inf"), arch)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tf.tree_map(lambda t: t.float(), params)
        run32 = serve_run(tf, serve, cfg32, p32, toks, extras, GROUP_STEPS,
                          feed=run["fed"])
        rec["teacher_forcing_f32"] = teacher_forcing(
            tf, cfg32, p32, toks, extras, run32, DRIFTS[arch], f"{arch} f32")
        del p32, run32
    else:
        rec["teacher_forcing_bf16"] = teacher_forcing(
            tf, cfg, params, toks, extras, run, TF_TOL_BF16, arch)
    rec.update(serve_bounds(traffic, cfg, GROUP_BATCH, pre + GROUP_PROMPT,
                            last))
    check_bounds(rec, ("prefill_event_ms", "decode_ms"))
    del run
    if "X" not in cfg.layer_pattern and not cfg.enc_dec:
        s_max = GROUP_PROMPT + GROUP_STEPS
        one, c1 = tf.prefill(cfg, params, toks, tf.init_decode_caches(
            cfg, GROUP_BATCH, s_max, "cuda"))
        chk, c2 = serve.make_chunked_prefill_step(cfg, GROUP_CHUNK)(
            params, tf.init_decode_caches(cfg, GROUP_BATCH, s_max, "cuda"),
            toks)
        errs = [rel(chk, one)] + [rel(a, b) for a, b in zip(
            tf.tree_leaves(c2), tf.tree_leaves(c1))]
        if max(errs) > TF_TOL_BF16:
            fail(f"{arch}: chunked prefill differs from one-shot by "
                 f"{max(errs):.3e} (> {TF_TOL_BF16})")
        rec["chunked_err"] = max(errs)
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def port_steps(tf, cfg, params, inputs, device):
    """11c.  forward, prefill and two decode steps (rows at positions
    p0 and p0 - 5) of the port on ``device``; every output moved to the
    CPU."""
    toks, steps, extras = (tf.tree_map(lambda t: t.to(device), x)
                           for x in inputs)
    pre = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    b, s = toks.shape
    out = [tf.forward(cfg, params, toks, **extras)[0]]
    caches = tf.init_decode_caches(cfg, b, pre + s + 4, device)
    last, caches = tf.prefill(cfg, params, toks, caches, **extras)
    out += [last] + tf.tree_leaves(tf.tree_map(torch.clone, caches))
    for i in range(2):
        pos = torch.tensor([pre + s + i, pre + s - 5 + i], device=device)
        logits, caches = tf.decode_step(cfg, params, steps[i], caches, pos)
        out += [logits] + tf.tree_leaves(tf.tree_map(torch.clone, caches))
    return [x.cpu() for x in out]


def card_vs_cpu_path(args, tf, arch):
    """11c.  One arch at ``reduced_config`` in float32, the same weights
    on the CPU and on the card: every output of ``port_steps`` within
    CPU_TOL of the CPU's (tier-1 holds the CPU port to the reference)."""
    from repro_torch.configs import reduced_config
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(args.seed),
                            "cpu")
    toks, extras = model_inputs(cfg, 2, 32, args.seed, "cpu")
    steps = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, cfg.vocab, (2, 2, 1), dtype=np.int32))
    inputs = (toks, steps, extras)
    want = port_steps(tf, cfg, params, inputs, "cpu")
    got = port_steps(tf, cfg, tf.tree_map(lambda t: t.cuda(), params),
                     inputs, "cuda")
    errs = [rel(g, w) for g, w in zip(got, want)]
    if len(got) != len(want) or max(errs) > CPU_TOL:
        fail(f"{arch}: the card differs from the CPU port by {max(errs):.3e}"
             f" (> {CPU_TOL})")
    return max(errs)


def model_path(args, counters, smi):
    """Phase 11: 11a, 11b for every other arch, 11c for all ten; no
    queue kernel (K1-K4) may launch."""
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for w in counters.values():
        w.launches = 0
    t0 = time.perf_counter()
    full = full_size_path(args, tf, serve, traffic, smi)
    print(f"model 11a {json.dumps(full)}", flush=True)
    torch.cuda.empty_cache()
    groups = {}
    for arch in ALL_ARCHS:
        if arch != FULL_ARCH:
            groups[arch] = group_path(args, tf, serve, traffic, arch, smi)
            print(f"model 11b {json.dumps(groups[arch])}", flush=True)
            torch.cuda.empty_cache()
    t11c = time.perf_counter()
    cpu = {arch: card_vs_cpu_path(args, tf, arch) for arch in ALL_ARCHS}
    print(f"model 11c card vs CPU port, max rel err {json.dumps(cpu)} "
          f"({time.perf_counter() - t11c:.1f} s)", flush=True)
    launches = {k: w.launches for k, w in counters.items()}
    if any(launches.values()):
        fail(f"the model path launched a queue kernel: {launches}")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s, queue kernel "
          f"launches {launches}", flush=True)
    return dict(full=full, groups=groups, cpu=cpu)


# ---------------------------------------------------------------------------
# phase 12: training on one device
# ---------------------------------------------------------------------------

#: 12a: gemma-2b whole, 3 AdamW steps (then 1 AdamW8 step) on one fixed
#: batch of 4 x 512 tokens in 4 microbatches
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = (
    "gemma-2b", 4, 512, 4, 3)
#: 12b: remat's gradients against plain ones (gemma-2b, 2 layers, f32)
REMAT_LAYERS, REMAT_BATCH, REMAT_SEQ, REMAT_TOL = 2, 2, 128, 1e-6
#: 12d: train_lm at its default size
TRAIN_LM_STEPS = 100


def train_batch(cfg, batch, seq, seed, device):
    """Tokens from the seed, next-token labels (the last position and
    the first three of row 0 masked), a VLM's or an audio arch's stub
    inputs."""
    toks, extras = model_inputs(cfg, batch, seq, seed, device)
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    return dict(tokens=toks, labels=labels, **extras)


def timed_step(step, state, batch):
    """One train step on the card's clock, the host included (it issues
    every launch): CUDA events around the call, synchronised after."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    state, metrics = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return state, {k: float(v) for k, v in metrics.items()}, \
        start.elapsed_time(end)


def train_run(train, traffic, cfg, tcfg, batch, steps, seed, label,
              profile=False):
    """``steps`` train steps of ``tcfg`` from parameters drawn from
    ``seed`` on the card: losses, gradient norms, ms a step, tokens/s,
    peak memory and the step's bound (``traffic.model_train``); a step
    under its bound or a non-finite metric fails the run.  With
    ``profile``, one more step under the profiler: its device time,
    events, busy share and top kernels."""
    from repro_torch.roofline import hw
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = train.init_train_state(cfg, gen, tcfg, device="cuda")
    step = train.make_train_step(cfg, tcfg)
    b, s = batch["tokens"].shape
    rec = dict(opt="adamw8" if tcfg.opt_8bit else "adamw", loss=[],
               grad_norm=[], lr=[], ms=[])
    for _ in range(steps):
        state, m, ms = timed_step(step, state, batch)
        for k in ("loss", "grad_norm", "lr"):
            rec[k].append(m[k])
        rec["ms"].append(ms)
    if not all(np.isfinite(rec["loss"] + rec["grad_norm"])):
        fail(f"{label}: a loss or gradient norm is not finite: {rec}")
    count, flops = traffic.model_train(cfg, b, s, tcfg.n_micro,
                                       cfg.remat == "full", tcfg.opt_8bit)
    rec.update(ms_per_step=rec["ms"][-1], tokens_per_s=b * s / (
        1e-3 * rec["ms"][-1]), max_memory_allocated=(
        torch.cuda.max_memory_allocated()),
        bound_ms=1e3 * traffic.model_bound_s(count, flops),
        bound_bytes=count.hbm_bytes, bound_flops=flops)
    rec["bound_by"] = ("bytes" if count.hbm_bytes / hw.HBM_BW
                       > flops / hw.PEAK_FLOPS else "operations")
    if min(rec["ms"]) < rec["bound_ms"]:
        fail(f"{label}: a step took {min(rec['ms']):.2f} ms, under its "
             f"bound {rec['bound_ms']:.2f} ms")
    if profile:
        prof = _profile_window(lambda: step(state, batch), 1)
        if prof is None:
            fail(f"{label}: the profiler recorded no device time")
        rec["profile"] = {k: prof[k] for k in (
            "wall_us_per_tick", "device_us_per_tick",
            "device_events_per_tick", "device_busy_share",
            "top_other_device_us_per_tick")}
    del state
    torch.cuda.empty_cache()
    return rec


def full_train_path(args, train, traffic, smi):
    """12a.  gemma-2b as published (bf16, remat "full") from a seeded
    generator: 3 AdamW steps on one fixed batch (the loss must fall),
    then one AdamW8 step from the same parameters."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    if cfg.remat != "full" or cfg.dtype != "bfloat16":
        fail(f"{TRAIN_ARCH}: remat {cfg.remat}, dtype {cfg.dtype}")
    t0 = time.perf_counter()
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed, "cuda")
    tcfg = train.TrainConfig(n_micro=TRAIN_MICRO, warmup=0,
                             total_steps=TRAIN_STEPS)
    label = f"12a {TRAIN_ARCH}"
    adamw = train_run(train, traffic, cfg, tcfg, batch, TRAIN_STEPS,
                      args.seed, label, profile=True)
    if not adamw["loss"][-1] < adamw["loss"][0]:
        fail(f"{label}: the loss did not fall: {adamw['loss']}")
    adamw8 = train_run(train, traffic, cfg, dataclasses.replace(
        tcfg, opt_8bit=True), batch, 1, args.seed, label + " adamw8")
    return dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                n_micro=TRAIN_MICRO, remat=cfg.remat, card=smi, adamw=adamw,
                adamw8=adamw8, seconds=time.perf_counter() - t0)


def port_grads(tf, cfg, params, batch):
    """(loss, gradient leaves) of the port's ``loss_fn``."""
    live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = tf.loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, tf.tree_leaves(live))
    return loss.detach(), list(grads)


def leaf_err(got, want) -> float:
    """max |got - want| over the leaf's largest |want|, on ``want``'s
    device."""
    got = got.detach().double().to(want.device)
    want = want.detach().double()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"a leaf of shape {tuple(got.shape)}, not finite or not "
             f"{tuple(want.shape)}")
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), float(np.finfo(np.float32).tiny))


def remat_path(args, tf):
    """12b.  gemma-2b at full width cut to 2 layers, float32 (TF32 off):
    every gradient leaf under remat "full" within 1e-6 of the leaf's
    scale of the one under remat "none"."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=REMAT_LAYERS,
                              dtype="float32")
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        args.seed), "cuda")
    batch = train_batch(cfg, REMAT_BATCH, REMAT_SEQ, args.seed, "cuda")
    out = {r: port_grads(tf, dataclasses.replace(cfg, remat=r), params,
                         batch) for r in ("none", "full")}
    errs = [leaf_err(g, w) for g, w in zip(out["full"][1], out["none"][1])]
    loss_err = abs(float(out["full"][0]) - float(out["none"][0]))
    if max(errs) > REMAT_TOL or loss_err > REMAT_TOL:
        fail(f"12b: remat's gradients differ by {max(errs):.3e} (loss "
             f"{loss_err:.3e}; > {REMAT_TOL})")
    return dict(layers=REMAT_LAYERS, max_leaf_err=max(errs),
                loss_err=loss_err, leaves=len(errs),
                seconds=time.perf_counter() - t0)


def adam_params_err(got, want, p0, mu, lr, wd):
    """A first Adam step moves each weight by about lr·sign(g): where
    |mu| is over 1e-3 of its leaf's largest the two agree to lr·1e-4 +
    1e-7 + two float32 steps of |p|; elsewhere (a gradient that rounding
    may flip) to 2·lr·(1 + wd·|p|) + 1e-7.  Returns the worst share of
    either limit."""
    worst = 0.0
    for a, b, p, m in zip(got, want, p0, mu):
        a, b, p, m = (x.detach().double().to(b.device) for x in (a, b, p, m))
        d = (a - b).abs()
        clear = m.abs() > 1e-3 * m.abs().max()
        tight = torch.where(clear, d / (lr * 1e-4 + 1e-7
                                        + 2.0 ** -22 * p.abs()), 0.0)
        loose = d / (2 * lr * (1 + wd * p.abs()) + 1e-7)
        worst = max(worst, float(tight.max()), float(loose.max()))
    return worst


def train_card_vs_cpu(args, tf, train, arch):
    """12c.  One arch at ``reduced_config`` in float32, the same weights
    and batch on the CPU and the card: the loss and every gradient leaf
    (within CPU_TOL of the leaf's scale), then one AdamW and one AdamW8
    train step each (n_micro 2, warmup 0): the moments within CPU_TOL
    (nu 2·CPU_TOL) of each leaf's scale, the 8-bit codes within one step
    and their scales within 2·CPU_TOL, the parameters by
    ``adam_params_err``."""
    from repro_torch.configs import reduced_config
    from repro_torch.optim import adamw8_init, adamw_init
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(args.seed),
                            "cpu")
    batch = train_batch(cfg, 4, 32, args.seed, "cpu")
    runs = {}
    for dev in ("cpu", "cuda"):
        p = tf.tree_map(lambda t: t.to(dev, copy=True), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        runs[dev] = dict(grads=port_grads(tf, cfg, p, b))
        for opt8 in (False, True):
            tcfg = train.TrainConfig(n_micro=2, peak_lr=1e-3, warmup=0,
                                     total_steps=10, opt_8bit=opt8)
            state = train.TrainState(tf.tree_map(torch.clone, p),
                                     (adamw8_init if opt8 else adamw_init)(p))
            state, m = train.make_train_step(cfg, tcfg)(state, b)
            runs[dev][opt8] = (state, {k: float(v) for k, v in m.items()})
    (lc, gc), (lg, gg) = runs["cpu"]["grads"], runs["cuda"]["grads"]
    errs = dict(loss=abs(float(lg) - float(lc)) / max(1.0, abs(float(lc))),
                grads=max(leaf_err(g, w) for g, w in zip(gg, gc)))
    shares = {}
    p0 = tf.tree_leaves(params)
    for opt8 in (False, True):
        (sc, mc), (sg, mg) = runs["cpu"][opt8], runs["cuda"][opt8]
        name = "adamw8" if opt8 else "adamw"
        errs[f"{name}_metrics"] = max(
            abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])) for k in mc)
        if opt8:
            errs["adamw8_codes"] = max(
                int((a.cpu().int() - b.int()).abs().max())
                for part in ("q_mu", "q_nu") for a, b in zip(
                    tf.tree_leaves(getattr(sg.opt, part)),
                    tf.tree_leaves(getattr(sc.opt, part))))
            errs["adamw8_scales"] = max(
                leaf_err(a, b) / 2 for part in ("s_mu", "s_nu")
                for a, b in zip(tf.tree_leaves(getattr(sg.opt, part)),
                                tf.tree_leaves(getattr(sc.opt, part))))
            mu = [m.float() for m in tf.tree_leaves(runs["cpu"][False][0]
                                                    .opt.mu)]
        else:
            errs["adamw_moments"] = max(
                leaf_err(a, b) / (2 if part == "nu" else 1)
                for part in ("mu", "nu") for a, b in zip(
                    tf.tree_leaves(getattr(sg.opt, part)),
                    tf.tree_leaves(getattr(sc.opt, part))))
            mu = tf.tree_leaves(sc.opt.mu)
        shares[f"{name}_params"] = adam_params_err(
            tf.tree_leaves(sg.params), tf.tree_leaves(sc.params), p0, mu,
            mc["lr"], tcfg.weight_decay)
    codes = errs.pop("adamw8_codes")
    if codes > 1 or max(errs.values()) > CPU_TOL or max(
            shares.values()) > 1:
        fail(f"12c {arch}: the card differs from the CPU port: {errs}, "
             f"parameters at {shares} of their limits, codes {codes} steps "
             "apart")
    return dict(errs, adamw8_codes=codes, **shares)


def train_lm_path(args, ex, counters, lt, bitonic, held):
    """12d.  ``repro_torch.examples.train_lm`` at its default size (the
    ~100M config, 16 x 256 tokens) for TRAIN_LM_STEPS steps on the card,
    its sampler on K3: the loss falls, K3 launches once per sampler tick
    (and nothing else launches); then an async checkpoint of the final
    state, taken while a further step updates that state in place,
    restores bit for bit."""
    import shutil
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    ckpt = ROOT / "build" / "train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    for w in counters.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SettingLaunches(lt, bitonic) as sl:
        out = ex.train_lm.main("cuda", "cuda", steps=TRAIN_LM_STEPS,
                               ckpt=str(ckpt), seed=args.seed)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters.items()}
    ticks = out["breakdown"]["n_ticks"]
    if launches["fused_tick_mid"] != ticks or any(
            n for k, n in launches.items() if k != "fused_tick_mid"):
        fail(f"12d: launches {launches} for {ticks} sampler ticks")
    sl.check("12d train_lm", launches["fused_tick_mid"], 0)
    first, last = np.mean(out["loss"][:10]), np.mean(out["loss"][-10:])
    if not last < first - 0.1:
        fail(f"12d: the loss did not fall: {first:.4f} -> {last:.4f}")
    # an async save, the state updated in place while it runs
    state = out["state"]
    want = [t.detach().cpu().clone() for t in tf.tree_leaves(state)]
    mgr = CheckpointManager(ckpt / "async", keep=1)
    mgr.save(TRAIN_LM_STEPS, state, blocking=False)
    cfg = ex.train_lm.build_cfg(False)
    tcfg = train.TrainConfig(n_micro=2, peak_lr=1e-3, warmup=20,
                             total_steps=TRAIN_LM_STEPS)
    data = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=out["seq"], batch=out["batch"],
        seed=0).batch_at(TRAIN_LM_STEPS).items()}
    train.make_train_step(cfg, tcfg)(state, data)
    mgr.wait()
    got, at = mgr.restore(state, device="cuda")
    same = all(same_bits(g.cpu(), w) for g, w in zip(tf.tree_leaves(got),
                                                     want))
    if at != TRAIN_LM_STEPS or not same:
        fail(f"12d: the async checkpoint at step {at} does not restore "
             "bit for bit")
    shutil.rmtree(ckpt, ignore_errors=True)
    rec = dict(params=out["params"], steps=out["steps"], batch=out["batch"],
               seq=out["seq"], loss_first10=first, loss_last10=last,
               ms_per_step=out["ms_per_step"], sampler_ticks=ticks,
               launches=launches, k3=sl.shapes()[0],
               breakdown=out["breakdown"],
               checkpoint_restored=same, seconds=seconds)
    kernels = setting_kernels("train_lm", sl.k3, sl.k2, held)
    return rec, kernels


def dev_check_dist_path(ex, counters, lt, bitonic, held):
    """12e.  ``repro_torch.examples.dev_check_dist`` at D=8 x l=2 on
    ``["cuda:0"] * 8`` under "cuda" (its three checks): K3 (grid 2) and
    K2 launch once per position's lane-work tick, and once (grid 16) per
    lane-work tick of the single-device sharded queue it is held to."""
    for w in counters.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SettingLaunches(lt, bitonic) as sl:
        out = ex.dev_check_dist.main("cuda:0", "cuda")
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters.items()}
    work = sum(out["work_ticks"])
    grids = {}
    for (_, lanes), n in sl.k3.items():
        grids[lanes] = grids.get(lanes, 0) + n
    d, lpd = ex.dev_check_dist.D, ex.dev_check_dist.LPD
    single = grids.get(d * lpd, 0)
    if (grids.get(lpd) != work or not 0 < single <= ex.dev_check_dist.TICKS
            or set(grids) != {lpd, d * lpd}
            or launches["bitonic_sort_kvf"] != launches["fused_tick_mid"]
            or launches["merge_sorted_kvf"]
            or launches["radix_select_threshold"]):
        fail(f"12e: launches {launches} (K3 by grid {grids}) for {work} "
             "position lane-work ticks")
    sl.check("12e dev_check_dist", work + single, work + single)
    rec = dict(out, launches=launches, k3_by_grid=grids, seconds=seconds)
    return rec, setting_kernels("dev_check_dist", sl.k3, sl.k2, held)


def train_path(args, ex, counters, lt, bitonic, held, smi):
    """Phase 12: 12a-12e; TF32 stays off (phase 11).  Returns the
    records and the kernels line's rows of 12d and 12e."""
    from repro_torch.configs import ALL_ARCHS
    from repro_torch.launch import train
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import traffic
    t0 = time.perf_counter()
    for w in counters.values():
        w.launches = 0
    times = {}
    full = full_train_path(args, train, traffic, smi)
    times["12a"] = full["seconds"]
    print(f"train 12a {json.dumps(full)}", flush=True)
    t = time.perf_counter()
    remat = remat_path(args, tf)
    times["12b"] = time.perf_counter() - t
    print(f"train 12b {json.dumps(remat)}", flush=True)
    t = time.perf_counter()
    cpu = {}
    for arch in ALL_ARCHS:
        cpu[arch] = train_card_vs_cpu(args, tf, train, arch)
        ex.dev_check_models.check(arch, "cuda", args.seed)
    times["12c"] = time.perf_counter() - t
    print(f"train 12c card vs CPU port {json.dumps(cpu)}", flush=True)
    launches = {k: w.launches for k, w in counters.items()}
    if any(launches.values()):
        fail(f"12a-c launched a queue kernel: {launches}")
    lm, lm_kernels = train_lm_path(args, ex, counters, lt, bitonic, held)
    times["12d"] = lm["seconds"]
    print(f"train 12d {json.dumps(lm)}", flush=True)
    dd, dd_kernels = dev_check_dist_path(ex, counters, lt, bitonic, held)
    times["12e"] = dd["seconds"]
    print(f"train 12e {json.dumps(dd)}", flush=True)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s, by part "
          f"{json.dumps(times)}", flush=True)
    return dict(full=full, remat=remat, cpu=cpu, train_lm=lm,
                dev_check_dist=dd), lm_kernels + dd_kernels


# ---------------------------------------------------------------------------
# phase 13: the model stack on a mesh
# ---------------------------------------------------------------------------

#: the mesh: (data 2, model 4), eight positions on the one card
MESH_SHAPE, MESH_AXES, MESH_POSITIONS = (2, 4), ("data", "model"), 8
#: 13a: gemma-2b trained on the mesh (12a's batch and microbatches)
MESH_TRAIN_STEPS = 2
#: 13a: the mesh's loss and gradient norm against one device's, bf16:
#: |a - b| over |b| (the ZeRO gradient sums, the clip norm's sum order
#: and the bf16 updates part the two runs by roundings)
MESH_TRAIN_TOL = 1e-2
#: 13b: gemma-2b served on the mesh (11a's prompts and steps); bf16
#: logits against one device's within TF_TOL_BF16, the f32 copies' within
#: MESH_SERVE_TOL_F32 (the decode's softmax combined by log-sum-exp over
#: the positions' S blocks, in f32, where one device softmaxes whole)
MESH_SERVE_TOL_F32 = 1e-3
#: 13b: prefill and decode device ms of the mesh step that gathered the
#: whole model onto each data row's first position, before the steps
#: split it over ``model`` (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
GATHERED_MS = dict(prefill=41.53, decode=29.74)
#: 13c: moonshot-v1-16b-a3b at full width, one pattern group, f32: two
#: prompts a data row of MOE_SEQ tokens, n_micro 2 on the mesh against
#: n_micro 4 on one device (the same groups: a piece of a microbatch per
#: data row), capacity factor n_experts / top_k (nothing drops)
MOE_ARCH, MOE_BATCH, MOE_SEQ = "moonshot-v1-16b-a3b", 4, 512
#: 13c: f32 loss / gradient norm and MoE outputs (the reference's rtol
#: 2e-4 / atol 2e-5 for moe_apply_dist against _moe_local)
MOE_TOL, MOE_RTOL, MOE_ATOL = 1e-5, 2e-4, 2e-5


def mesh_of(dist, shape, axes):
    return dist.make_mesh(shape, axes, devices=["cuda:0"] * MESH_POSITIONS)


def placed_zero_opt(dist, tf, meta_opt, shardings):
    """An optimizer's zero state placed block by block (never whole)."""
    return dist.tree_map2(lambda s, sh: dist.zeros(s.shape, s.dtype, sh),
                          meta_opt, shardings)


def held_gb(dist, tree, mesh):
    return [b / 1e9 for b in dist.held_bytes(tree, mesh)]


def layout_gb(tf, shardings, shapes, itemsize):
    """GB each position holds for a layout (its blocks' sizes)."""
    out = [0] * tf.tree_leaves(shardings)[0].mesh.size
    for sh, s in zip(tf.tree_leaves(shardings), tf.tree_leaves(shapes)):
        n = int(np.prod(sh.shard_shape(s.shape)))
        for p in range(len(out)):
            out[p] += n * itemsize
    return [b / 1e9 for b in out]


def mesh_train_path(args, dist, train, tf, smi):
    """13a.  gemma-2b as published (bf16, remat "full"): 12a's batch in 4
    microbatches, MESH_TRAIN_STEPS AdamW steps on one device, freed, then
    the same steps on the (2, 4) mesh from the same seeded weights
    (FSDP, ZeRO-1): loss and gradient norm within MESH_TRAIN_TOL, ms a
    step, tokens/s, peak memory, each position's bytes held."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed, "cuda")
    tcfg = train.TrainConfig(n_micro=TRAIN_MICRO, warmup=0,
                             total_steps=TRAIN_STEPS, fsdp=True, zero1=True)
    rec = dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               n_micro=TRAIN_MICRO,
               mesh_shape=dict(zip(MESH_AXES, MESH_SHAPE)), card=smi)
    runs = {}
    for where in ("one_device", "mesh"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        if where == "one_device":
            state = train.init_train_state(cfg, gen, tcfg, device="cuda")
            step = train.make_train_step(cfg, tcfg)
        else:
            mesh = mesh_of(dist, MESH_SHAPE, MESH_AXES)
            meta = train.init_train_state(cfg, None, tcfg, device="meta")
            shard = train.state_shardings(cfg, tcfg, mesh, meta)
            params = dist.device_put(tf.init_params(cfg, gen, "cuda"),
                                     shard.params)
            torch.cuda.empty_cache()
            state = train.TrainState(params, placed_zero_opt(
                dist, tf, meta.opt, shard.opt))
            step = train.make_train_step(cfg, tcfg, mesh)
            rec["held_gb"] = dict(
                params=held_gb(dist, state.params, mesh),
                moments=held_gb(dist, state.opt, mesh),
                grad_buffer=layout_gb(tf, train.grad_shardings(
                    cfg, mesh, meta.params), meta.params, 4))
        run = dict(loss=[], grad_norm=[], ms=[])
        for _ in range(MESH_TRAIN_STEPS):
            state, m, ms = timed_step(step, state, batch)
            run["loss"].append(m["loss"])
            run["grad_norm"].append(m["grad_norm"])
            run["ms"].append(ms)
        run.update(ms_per_step=run["ms"][-1], tokens_per_s=(
            TRAIN_BATCH * TRAIN_SEQ / (1e-3 * run["ms"][-1])),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        runs[where] = run
        del state, step
    torch.cuda.empty_cache()
    rec.update(runs)
    errs = {k: max(abs(a - b) / abs(b) for a, b in zip(
        runs["mesh"][k], runs["one_device"][k]))
        for k in ("loss", "grad_norm")}
    rec["rel_err"] = errs
    if not all(np.isfinite(runs["mesh"]["loss"] + runs["mesh"]["grad_norm"])
               ) or max(errs.values()) > MESH_TRAIN_TOL:
        fail(f"13a: the mesh's metrics differ from one device's: {errs} "
             f"(> {MESH_TRAIN_TOL}): {runs}")
    # ZeRO-1: each position holds about an eighth of the float32 moments
    # and of the gradient buffer (small leaves replicate over `model`)
    n = sum(x.numel() for x in tf.tree_leaves(meta.params))
    held = rec["held_gb"]
    if max(held["moments"]) > 1.05 * 8e-9 * n / MESH_POSITIONS or max(
            held["grad_buffer"]) > 1.05 * 4e-9 * n / MESH_POSITIONS:
        fail(f"13a: a position holds more than its ZeRO-1 share: {held}")
    rec["seconds"] = time.perf_counter() - t0
    return rec


def mesh_greedy(run, want, tol, label, cfg):
    """The mesh's free-running greedy tokens against one device's: equal,
    or the first that differs (in a row) where one device's top-2 margin
    is within 2·tol of the logits' scale (a near-tie), the logits up to
    there within ``tol``.  Returns the equal share and the checks."""
    got_tok, want_tok = run["fed"], want["fed"]
    n = got_tok.shape[1]
    scale = max(1.0, float(want["logits"].float().abs().max()))
    ties = 0
    for r in range(got_tok.shape[0]):
        diff = (got_tok[r] != want_tok[r]).nonzero()
        upto = int(diff[0]) if len(diff) else n
        err = rel(run["logits"][r, :upto + 1], want["logits"][r, :upto + 1])
        if err > tol:
            fail(f"{label}: row {r}'s logits differ by {err:.3e} (> {tol})")
        if upto < n:
            top2 = want["logits"][r, upto, :cfg.vocab].float().topk(2).values
            if float(top2[0] - top2[1]) > 2 * tol * scale:
                fail(f"{label}: row {r}'s greedy token {upto} differs "
                     "where the margin allows")
            ties += 1
    return dict(tokens_equal=float((got_tok == want_tok).float().mean()),
                rows_parted_at_a_tie=ties)


class BlockReads:
    """A spy on ``Sharded.read`` and ``gather_box`` over a placed
    parameter tree's leaves:
    counts each read of a leaf split over ``model`` that is one
    position's block of one group, and each that is not (its leaf named),
    while entered."""

    def __init__(self, params, mesh):
        from repro_torch.dist import sharding
        self.sharding, self.m = sharding, mesh.shape["model"]
        self.leaves = {id(x) for x in tf_leaves(params)}
        self.blocks, self.whole = 0, []

    def __enter__(self):
        self._reads = {k: getattr(self.sharding.Sharded, k)
                       for k in ("read", "gather_box")}
        for name, read in self._reads.items():
            setattr(self.sharding.Sharded, name, self._spy(read))
        return self

    def _spy(self, read):
        def counted(leaf, box=None, device=None):
            if id(leaf) in self.leaves:
                self.check(leaf, box)
            return read(leaf, box, device)
        return counted

    def __exit__(self, *exc):
        for name, read in self._reads.items():
            setattr(self.sharding.Sharded, name, read)

    def check(self, leaf, box):
        parts = leaf.sharding._parts(leaf.ndim)
        dims = [i for i, a in enumerate(parts)
                if "model" in self.sharding.axes_of(a)]
        if not dims:
            return
        box = box or self.sharding.full_box(leaf.shape)
        n = box[dims[0]].stop - box[dims[0]].start
        if n * self.m == leaf.shape[dims[0]]:
            self.blocks += 1
        else:
            self.whole.append((tuple(leaf.shape), str(leaf.sharding.spec)))


def tf_leaves(tree):
    from repro_torch.models.transformer import tree_leaves
    return tree_leaves(tree)


def mesh_serve_path(args, dist, serve, tf, smi, phase11):
    """13b.  gemma-2b whole served on the mesh (params_shardings, caches
    by cache_shardings: S over `model`): 11a's four prompts of 512 tokens
    and 32 greedy steps, against the one-device port on the same
    weights: the greedy tokens, then an f32 copy fed the bf16 tokens;
    prefill and decode ms beside one device's."""
    from repro_torch.configs import get_config
    cfg = get_config(FULL_ARCH)
    t0 = time.perf_counter()
    mesh = mesh_of(dist, MESH_SHAPE, MESH_AXES)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = tf.init_params(cfg, gen, "cuda")
    toks, _ = model_inputs(cfg, FULL_BATCH, FULL_PROMPT, args.seed, "cuda")
    last = FULL_PROMPT + FULL_STEPS - 1
    rec = dict(arch=FULL_ARCH, batch=FULL_BATCH, prompt=FULL_PROMPT,
               steps=FULL_STEPS, card=smi)
    one = serve_run(tf, serve, cfg, params, toks, {}, FULL_STEPS)
    placed = dist.device_put(params, serve.params_shardings(cfg, mesh,
                                                            params))
    torch.cuda.reset_peak_memory_stats()
    with BlockReads(placed, mesh) as reads:
        run = serve_run(tf, serve, cfg, placed, toks, {}, FULL_STEPS,
                        mesh=mesh)
    rec["block_reads"] = reads.blocks
    if reads.whole or not reads.blocks:
        fail(f"13b: the mesh steps read {len(reads.whole)} model-split "
             f"leaves whole ({reads.whole[:4]}) and {reads.blocks} blocks")
    rec["greedy"] = mesh_greedy(run, one, TF_TOL_BF16, "13b bf16", cfg)
    prof = step_profiles(serve, cfg, placed, toks, run, last,
                         dict(prefill=2, decode=5), mesh=mesh)
    rec.update(
        prefill_ms=prof["prefill"]["device_us_per_tick"] / 1e3,
        decode_ms=prof["decode"]["device_us_per_tick"] / 1e3,
        prefill_event_ms=run["prefill_event_ms"],
        decode_event_ms=run["decode_event_ms"],
        tokens_per_s=run["tokens_per_s"], profiles=prof,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        one_device=dict(prefill_event_ms=one["prefill_event_ms"],
                        decode_event_ms=one["decode_event_ms"],
                        tokens_per_s=one["tokens_per_s"],
                        phase11_prefill_ms=phase11["prefill_ms"],
                        phase11_decode_ms=phase11["decode_ms"]),
        held_gb=held_gb(dist, placed, mesh), gathered_ms=GATHERED_MS)
    print(f"mesh 13b gemma-2b on the (2, 4) mesh, each position its own "
          f"blocks: prefill {rec['prefill_ms']:.2f} ms, decode "
          f"{rec['decode_ms']:.2f} ms a step on the card's clock (the "
          f"gathered step: {GATHERED_MS['prefill']} / "
          f"{GATHERED_MS['decode']} ms, NVIDIA H100 80GB HBM3, 700 W); "
          f"{smi}", flush=True)
    fed = one["fed"]
    del run, one, placed
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tf.tree_map(lambda t: t.float(), params)
    one32 = serve_run(tf, serve, cfg32, params, toks, {}, FULL_STEPS,
                      feed=fed)
    want32 = one32["logits"]
    del one32
    placed = dist.device_put(params, serve.params_shardings(cfg32, mesh,
                                                            params))
    del params
    torch.cuda.empty_cache()
    run32 = serve_run(tf, serve, cfg32, placed, toks, {}, FULL_STEPS,
                      feed=fed, mesh=mesh)
    rec["f32_err"] = rel(run32["logits"], want32)
    if rec["f32_err"] > MESH_SERVE_TOL_F32:
        fail(f"13b: the f32 mesh logits differ by {rec['f32_err']:.3e} "
             f"(> {MESH_SERVE_TOL_F32})")
    del run32, placed, want32
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def moe_batch(cfg, seed, device):
    """MOE_BATCH prompts of MOE_SEQ tokens from the seed, next-token
    labels with the last position masked (every piece the same count)."""
    toks, _ = model_inputs(cfg, MOE_BATCH, MOE_SEQ, seed, device)
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    return dict(tokens=toks, labels=labels)


def mesh_moe_path(args, dist, train, tf, moe, layers, smi):
    """13c.  moonshot-v1-16b-a3b at full width cut to one pattern group,
    f32: one AdamW step on the mesh (one-hot lookups, moe_apply_dist)
    against the one-device step on the same groups; moe_apply_dist
    against _moe_local; the one-hot lookup bit-equal to the gather.
    Returns the record and the mesh's state and shardings (13d, 13e)."""
    from repro_torch.configs import get_config
    cfg, cuts = group_cfg(get_config(MOE_ARCH))
    cfg = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    mesh = mesh_of(dist, MESH_SHAPE, MESH_AXES)
    batch = moe_batch(cfg, args.seed, "cuda")
    kw = dict(warmup=0, total_steps=10, peak_lr=1e-3)
    tc1 = train.TrainConfig(n_micro=2 * MESH_SHAPE[0], **kw)
    tcm = train.TrainConfig(n_micro=2, **kw)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    state = train.init_train_state(cfg, gen, tc1, device="cuda")
    p0 = [p.clone() for p in tf.tree_leaves(state.params)]
    meta = train.init_train_state(cfg, None, tcm, device="meta")
    shard = train.state_shardings(cfg, tcm, mesh, meta)
    placed = train.TrainState(dist.device_put(state.params, shard.params),
                              placed_zero_opt(dist, tf, meta.opt, shard.opt))
    rec = dict(arch=MOE_ARCH, cuts=cuts, batch=MOE_BATCH, seq=MOE_SEQ,
               card=smi, params=tf.param_count(state.params))
    # moe_apply_dist against _moe_local on the group's expert weights
    mp = tf.tree_map(lambda t: t[0], state.params["stack"]["p0"]["moe"])
    x = torch.randn((MOE_BATCH, MOE_SEQ, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        args.seed)) * 0.1
    y_local, aux_local = moe._moe_local(mp, cfg, x)
    with dist.use_mesh(mesh):
        y, aux = moe.moe_apply(mp, cfg, x)
    ok = torch.allclose(y, y_local, rtol=MOE_RTOL, atol=MOE_ATOL)
    rec["moe_dist"] = dict(max_abs_err=float((y - y_local).abs().max()),
                           aux=float(aux), aux_local=float(aux_local))
    if not ok or abs(float(aux) - float(aux_local)) > 1e-2 * abs(
            float(aux_local)):
        fail(f"13c: moe_apply_dist differs from _moe_local: "
             f"{rec['moe_dist']}")
    del y, y_local, x
    # the one-hot lookup against the gather, on the whole table
    table = state.params["embed"]
    a = layers.embed_apply(table, batch["tokens"], False, mode="onehot")
    b = layers.embed_apply(table, batch["tokens"], False, mode="take")
    rec["onehot_bit_equal"] = same_bits(a, b)
    if not rec["onehot_bit_equal"]:
        fail("13c: the one-hot lookup differs from the gather")
    del a, b
    s1, m1, ms1 = timed_step(train.make_train_step(cfg, tc1), state, batch)
    sm, mm, msm = timed_step(train.make_train_step(cfg, tcm, mesh), placed,
                             batch)
    errs = {k: abs(mm[k] - m1[k]) / abs(m1[k]) for k in ("loss",
                                                          "grad_norm")}
    full = dist.gather(sm.params, "cuda")
    params_err = adam_params_err(tf.tree_leaves(full),
                                 tf.tree_leaves(s1.params), p0,
                                 tf.tree_leaves(s1.opt.mu), m1["lr"],
                                 tc1.weight_decay)
    moments_err = max(leaf_err(a, b) for a, b in zip(
        tf.tree_leaves(dist.gather(sm.opt.mu, "cuda")),
        tf.tree_leaves(s1.opt.mu)))
    del full, s1, state, p0
    torch.cuda.empty_cache()
    rec.update(one_device=m1, mesh=mm, one_device_ms=ms1, mesh_ms=msm,
               rel_err=errs, params_err_share=params_err,
               mu_err=moments_err,
               held_gb=dict(params=held_gb(dist, sm.params, mesh),
                            moments=held_gb(dist, sm.opt, mesh)))
    if max(errs.values()) > MOE_TOL or params_err > 1.0 or \
            moments_err > 1e-4:
        fail(f"13c: the mesh step differs from one device's: {rec}")
    rec["seconds"] = time.perf_counter() - t0
    return rec, sm, shard, cfg, tcm


def compress_path(args, dist, compress, tf, train, cfg, state_params):
    """13d.  compressed_psum over the `pod` axis of a (2, 2, 2) mesh on
    13c's gradient leaves: pod k holds the gradient of its own prompt
    (k), each position its block of the ZeRO layout.  Every reduced
    element equals the int32 sum of the codes times the shared scale over
    n (recomputed here), and the error buffers hold what quantization
    left: sum(x) = n·reduced + sum(new error) within float32 rounding."""
    t0 = time.perf_counter()
    mesh = mesh_of(dist, (2, 2, 2), ("pod", "data", "model"))
    params = dist.gather(state_params, "cuda")
    batch = moe_batch(cfg, args.seed, "cuda")
    meta = tf.tree_map(lambda t: torch.empty(t.shape, device="meta"), params)
    layout = tf.tree_leaves(train.grad_shardings(cfg, mesh, meta))
    grads = []
    for k in range(2):
        live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = tf.loss_fn(cfg, live, {n: v[k:k + 1]
                                         for n, v in batch.items()})
        grads.append(torch.autograd.grad(loss, tf.tree_leaves(live)))
        del live, loss
    del params
    per_pos = [tuple(g[sh.block(g.shape, p)].clone()
                     for g, sh in zip(grads[mesh.coords(p)["pod"]], layout))
               for p in range(mesh.size)]
    del grads
    torch.cuda.empty_cache()
    states = [compress.compress_init(g) for g in per_pos]
    red, new = compress.compressed_psum(per_pos, states, mesh, "pod")
    worst_id, worst_sum, n_el = 0.0, 0.0, 0
    for i in range(len(layout)):
        for group in mesh.groups("pod"):
            xs = [per_pos[p][i].float() for p in group]
            scale = torch.stack([torch.clamp(x.abs().max() / 127.0,
                                             min=1e-12) for x in xs]).max()
            qs = [torch.clamp(torch.round(x / scale), -127, 127).to(
                torch.int8) for x in xs]
            total = sum(q.to(torch.int32) for q in qs)
            want = total.float() * scale / len(group)
            for p in group:
                if not same_bits(red[p][i], want):
                    fail(f"13d: leaf {i} at position {p}: the reduced "
                         "value is not the codes' sum times the scale")
            lhs = sum(x.double() for x in xs)
            rhs = len(group) * red[group[0]][i].double() + sum(
                new[p].error[i].double() for p in group)
            bound = 2.0 ** -22 * len(group) * 127 * float(scale)
            gap = float((lhs - rhs).abs().max())
            worst_id = max(worst_id, gap / bound)
            worst_sum = max(worst_sum, gap)
            n_el += xs[0].numel()
    if worst_id > 1.0:
        fail(f"13d: the error buffers miss what quantization left: "
             f"{worst_id:.3f} of the float32 bound")
    del per_pos, red, new, states
    torch.cuda.empty_cache()
    return dict(mesh=dict(pod=2, data=2, model=2), leaves=len(layout),
                elements_per_pod=n_el, identity_share_of_bound=worst_id,
                identity_max_abs=worst_sum,
                seconds=time.perf_counter() - t0)


def mesh_ckpt_path(dist, train, ckpt, tf, cfg, tcfg, state, shard):
    """13e.  13c's mesh state saved asynchronously from the (2, 4) mesh,
    then restored onto (1, 8) (placed by its state_shardings) and onto
    one device, bit for bit."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="mesh_ckpt_"))
    try:
        mgr = ckpt.CheckpointManager(tmp, keep=1)
        t = time.perf_counter()
        mgr.save(1, state, blocking=False)
        host_s = time.perf_counter() - t
        mgr.wait()
        save_s = time.perf_counter() - t
        meta = train.init_train_state(cfg, None, tcfg, device="meta")
        want = tf.tree_leaves(state)
        out = dict(host_copy_s=host_s, save_s=save_s, bytes=sum(
            x.numel() * torch.empty((), dtype=x.dtype).element_size()
            for x in want))
        mesh18 = mesh_of(dist, (1, 8), MESH_AXES)
        for name, kw in (("mesh_1x8", dict(shardings=train.state_shardings(
                cfg, tcfg, mesh18, meta))), ("one_device", dict(
                device="cuda"))):
            t = time.perf_counter()
            got, step = mgr.restore(meta, **kw)
            out[f"{name}_restore_s"] = time.perf_counter() - t
            if step != 1:
                fail(f"13e: restored step {step}")
            for a, b in zip(tf.tree_leaves(got), want):
                a = a.read() if isinstance(a, dist.Sharded) else a
                if not same_bits(a, b.read()):
                    fail(f"13e: a leaf restored onto {name} differs")
            del got
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_path(args, counters, smi, phase11):
    """Phase 13: 13a-13e on a (2, 4) mesh of positions on the one card;
    no queue kernel (K1-K4) may launch."""
    from repro_torch import ckpt, dist
    from repro_torch.launch import serve, train
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tf
    from repro_torch.optim import compress
    for w in counters.values():
        w.launches = 0
    t0 = time.perf_counter()
    times = {}
    rec = mesh_train_path(args, dist, train, tf, smi)
    times["13a"] = rec["seconds"]
    print(f"mesh 13a {json.dumps(rec)}", flush=True)
    rec = mesh_serve_path(args, dist, serve, tf, smi, phase11)
    times["13b"] = rec["seconds"]
    print(f"mesh 13b {json.dumps(rec)}", flush=True)
    rec, state, shard, cfg, tcfg = mesh_moe_path(args, dist, train, tf, moe,
                                                 layers, smi)
    times["13c"] = rec["seconds"]
    print(f"mesh 13c {json.dumps(rec)}", flush=True)
    rec = mesh_ckpt_path(dist, train, ckpt, tf, cfg, tcfg, state, shard)
    times["13e"] = rec["seconds"]
    print(f"mesh 13e {json.dumps(rec)}", flush=True)
    params = state.params
    del state
    torch.cuda.empty_cache()
    rec = compress_path(args, dist, compress, tf, train, cfg, params)
    times["13d"] = rec["seconds"]
    print(f"mesh 13d {json.dumps(rec)}", flush=True)
    del params
    torch.cuda.empty_cache()
    launches = {k: w.launches for k, w in counters.items()}
    print(f"phase 13: {time.perf_counter() - t0:.1f} s, by part "
          f"{json.dumps(times)}, queue kernel launches "
          f"{json.dumps(launches)}", flush=True)
    if any(launches.values()):
        fail(f"the mesh path launched a queue kernel: {launches}")


# ---------------------------------------------------------------------------
# phase 14: the dry run's count held to the card
# ---------------------------------------------------------------------------

#: 14a: |measured - traced| temporaries (bytes above the arguments at the
#: step's peak) within this share of the traced ones plus DRY_PEAK_SLACK
#: (PERF.md §6, the prediction written before the first card run)
DRY_PEAK_TOL, DRY_PEAK_SLACK = 0.05, 64 * 2 ** 20
#: 14a: memory_allocated's rounding per tensor: a block rounds up to 512
#: bytes, and a block of 1 MiB or more keeps the rest of its segment when
#: that is under 1 MiB (the caching allocator splits off no less)
ALLOC_BLOCK, ALLOC_LARGE = 512, 2 ** 20
#: 14b: the production cells counted on the card's host, each with its
#: budget in seconds from its process's start (PERF.md §6: about twice
#: its time on an 8-core CPU) and the processes its fit's traces run in
DRY_CELLS = ((("gemma-2b", "decode_32k"), 300.0, 1),
             (("qwen3-moe-235b-a22b", "train_4k"), 1200.0, 4),
             (("xlstm-350m", "train_4k"), 900.0, 4))


def tensors_of(tree):
    from repro_torch.roofline.trace_stats import tree_tensors
    return list(tree_tensors(tree))


def tree_nbytes(tree) -> int:
    seen, n = set(), 0
    for t in tensors_of(tree):
        st = t.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            n += st.nbytes()
    return n


def measured_step(step, args, kwargs):
    """One timed call (CUDA events, host included), then one under
    ``FlopCounterMode``: (ms, FLOPs, bytes above the arguments at the
    timed call's peak)."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(*args, **kwargs)
    end.record()
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base
    ms = start.elapsed_time(end)
    with FlopCounterMode(display=False) as fc:
        step(*args, **kwargs)
    torch.cuda.synchronize()
    return ms, fc.get_total_flops(), temp


def hold_count(label, lowered, placed_bytes, grown, ms, flops, temp, bound,
               smi):
    """The dry run of ``lowered`` (one fake device: the card), fitted over
    its loops' trip counts, against the card's run of the same step;
    fails the phase on a miss."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import hw
    t0 = time.perf_counter()
    counts, trips, _ = dryrun.count_step(lowered)
    dev = lowered.devices[0]
    st = counts.stats(dev)
    traced_temp = st.peak_bytes - st.argument_bytes
    rec = dict(step=label, card=smi, argument_bytes=st.argument_bytes,
               held_bytes=placed_bytes, allocated_growth=grown,
               flops=st.flops, card_flops=flops, traced_temp=traced_temp,
               card_temp=temp, ms=ms, compute_ms=1e3 * st.flops /
               hw.PEAK_FLOPS, memory_ms=1e3 * st.hbm_bytes / hw.HBM_BW,
               bound_ms=bound, hbm_bytes=st.hbm_bytes,
               link_bytes=st.link_bytes, ops=st.ops,
               trips={v["loop"]: v["full"] for v in trips["variables"]},
               traces=trips["traces"],
               count_s=time.perf_counter() - t0)
    rec["ms_over_memory_ms"] = ms / rec["memory_ms"]
    slack = sum(ALLOC_LARGE if t.numel() * t.element_size() >= ALLOC_LARGE
                else ALLOC_BLOCK
                for t in tensors_of((lowered.args, lowered.kwargs)))
    misses = []
    if st.argument_bytes != placed_bytes:
        misses.append("argument bytes")
    if not 0 <= grown - st.argument_bytes <= slack:
        misses.append("allocated growth")
    if st.flops != flops:
        misses.append("FLOPs")
    if abs(temp - traced_temp) > DRY_PEAK_TOL * traced_temp + DRY_PEAK_SLACK:
        misses.append("peak")
    if ms < rec["compute_ms"] or ms < bound:
        misses.append("a time under its bound")
    print(f"dryrun 14a {json.dumps(rec)}", flush=True)
    if misses:
        fail(f"14a {label}: the dry run misses the card: {misses}: {rec}")
    return rec


def dry_train(args, train, tf, dist, traffic, smi, mesh_run):
    """14a, training: 12a's step on one device, then 13a's on the (2, 4)
    mesh of positions on the card, each placed, timed, counted, and
    traced by the dry run on one fake device."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    tcfg = train.TrainConfig(n_micro=TRAIN_MICRO, warmup=0,
                             total_steps=TRAIN_STEPS, fsdp=True, zero1=True)
    specs = {k: ((TRAIN_BATCH, TRAIN_SEQ), torch.int32)
             for k in ("tokens", "labels")}
    count, flops = traffic.model_train(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                       TRAIN_MICRO, True, False)
    bound = 1e3 * traffic.model_bound_s(count, flops)
    out = []
    for where in ("one_device", "mesh"):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        batch = train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed, "cuda")
        if where == "one_device":
            state = train.init_train_state(cfg, gen, tcfg, device="cuda")
            step = train.make_train_step(cfg, tcfg)
            held = tree_nbytes((state, batch))
            lowered = train.lower_train_step(cfg, tcfg, None, specs)
        else:
            mesh = mesh_of(dist, MESH_SHAPE, MESH_AXES)
            meta = train.init_train_state(cfg, None, tcfg, device="meta")
            shard = train.state_shardings(cfg, tcfg, mesh, meta)
            params = dist.device_put(tf.init_params(cfg, gen, "cuda"),
                                     shard.params)
            batch = dist.device_put(batch, train.batch_specs(cfg, mesh))
            state = train.TrainState(params, placed_zero_opt(
                dist, tf, meta.opt, shard.opt))
            step = train.make_train_step(cfg, tcfg, mesh)
            held = sum(dist.held_bytes((state, batch), mesh))
            lowered = train.lower_train_step(
                cfg, tcfg, mesh_run(["cpu:0"] * MESH_POSITIONS), specs)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        ms, card_flops, temp = measured_step(step, (state, batch), {})
        out.append(hold_count(f"train {where}", lowered, held, grown, ms,
                              card_flops, temp, bound, smi))
        # nothing of this step may be freed inside the next one's count
        del state, batch, step, gen
    torch.cuda.empty_cache()
    return out


def dry_serve(args, serve, tf, dist, traffic, smi, mesh_run):
    """14a, serving: 11a's prefill of four 512-token prompts and one
    decode step at position 512 (caches of 544, filled by a prefill
    first), on one device and on 13b's (2, 4) mesh of positions on the
    card (each position its own blocks), placed, timed, counted and
    traced by the dry run on one fake device."""
    from repro_torch.configs import get_config
    cfg = get_config(FULL_ARCH)
    smax = FULL_PROMPT + FULL_STEPS
    tok_specs = dict(prefill={"tokens": ((FULL_BATCH, FULL_PROMPT),
                                         torch.int32)},
                     decode={"token": ((FULL_BATCH, 1), torch.int32),
                             "pos": ((FULL_BATCH,), torch.int32)})
    out = []
    for kind in ("prefill", "decode"):
        for where in ("one_device", "mesh"):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            params = tf.init_params(cfg, gen, "cuda")
            toks, _ = model_inputs(cfg, FULL_BATCH, FULL_PROMPT, args.seed,
                                   "cuda")
            mesh = fake = None
            if where == "mesh":
                mesh = mesh_of(dist, MESH_SHAPE, MESH_AXES)
                fake = mesh_run(["cpu:0"] * MESH_POSITIONS)
                params = dist.device_put(params, serve.params_shardings(
                    cfg, mesh, params))
                torch.cuda.empty_cache()
            clen = FULL_PROMPT if kind == "prefill" else smax
            caches = tf.init_decode_caches(cfg, FULL_BATCH, clen, "cuda")
            if mesh is not None:
                caches = dist.device_put(caches, serve.cache_shardings(
                    cfg, mesh, caches))
                torch.cuda.empty_cache()
            if kind == "prefill":
                step = serve.make_prefill_step(cfg, mesh=mesh)
                inputs = (toks,)
                lowered = serve.lower_prefill_step(
                    cfg, fake, batch=FULL_BATCH, seq_len=FULL_PROMPT,
                    specs=tok_specs[kind])
                count = traffic.model_prefill(cfg, FULL_BATCH, FULL_PROMPT)
                flops = traffic.model_step_flops(
                    cfg, FULL_BATCH * FULL_PROMPT, FULL_BATCH)
            else:
                serve.make_prefill_step(cfg, mesh=mesh)(params, caches, toks)
                inputs = (toks[:, -1:].contiguous(), torch.full(
                    (FULL_BATCH,), FULL_PROMPT, dtype=torch.int32,
                    device="cuda"))
                del toks
                step = serve.make_decode_step(cfg, mesh=mesh)
                lowered = serve.lower_serve_step(
                    cfg, fake, batch=FULL_BATCH, seq_len=smax,
                    specs=tok_specs[kind])
                count = traffic.model_decode(cfg, FULL_BATCH,
                                             FULL_BATCH * (FULL_PROMPT + 1))
                flops = traffic.model_step_flops(cfg, FULL_BATCH, FULL_BATCH)
            if mesh is None:
                call = (params, caches) + inputs
                held = tree_nbytes(call)
            else:
                inputs = tuple(dist.place(t, serve._token_sharding(
                    mesh, t.shape)) for t in inputs)
                toks = None
                call = (params, caches) + inputs
                held = sum(dist.held_bytes(call, mesh))
            torch.cuda.synchronize()
            grown = torch.cuda.memory_allocated() - before
            ms, card_flops, temp = measured_step(step, call, {})
            out.append(hold_count(f"{kind} {where}", lowered, held, grown,
                                  ms, card_flops, temp,
                                  1e3 * traffic.model_bound_s(count, flops),
                                  smi))
            # nothing of this step may be freed inside the next one's count
            del params, caches, call, step, gen, inputs
            toks = None
    torch.cuda.empty_cache()
    return out


class DryCells:
    """14b's production cells, counted by ``python -m
    repro_torch.launch.dryrun`` in processes of their own (fake devices,
    no card: they run beside phases 3-14a), each in a session of its own
    so that it and the workers it forks are stopped at exit."""

    def __init__(self, hbm_bytes: int):
        self.out = ROOT / "build" / "dryrun"
        self.out.mkdir(parents=True, exist_ok=True)
        self.procs = []
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        for (arch, shape), budget, workers in DRY_CELLS:
            path = self.out / f"{arch}__{shape}__16x16.json"
            path.unlink(missing_ok=True)
            log = open(self.out / f"{arch}__{shape}.log", "w")
            # at the lowest priority: the card's phases time the host
            proc = subprocess.Popen(
                ["nice", "-n", "19", sys.executable, "-m",
                 "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--out", str(self.out),
                 "--hbm-bytes", str(hbm_bytes), "--workers", str(workers)],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                start_new_session=True)
            self.procs.append((arch, shape, budget, proc, time.perf_counter(),
                               path))
        atexit.register(self.stop)

    def stop(self) -> None:
        for *_, proc, _, _ in self.procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            proc.wait()

    def collect(self, smi):
        """14b: each cell's record once its process ends, held to its
        budget (its own lowering and counting seconds; a process still
        running its budget after its start is stopped); the report's
        rows printed."""
        from repro_torch.roofline import hw, report
        seconds = {}
        for arch, shape, budget, proc, t0, path in self.procs:
            log = self.out / f"{arch}__{shape}.log"
            try:
                proc.wait(timeout=max(0.0, budget - (time.perf_counter()
                                                     - t0)))
            except subprocess.TimeoutExpired:
                self.stop()
                fail(f"14b: {arch} {shape} ran past its {budget:.0f} s")
            res = (json.loads(path.read_text()) if path.exists()
                   else {"status": "no record", "rc": proc.returncode})
            timing = res.get("timing", {})
            took = seconds[f"{arch} {shape}"] = (timing.get("lower_s", 0.0)
                                                 + timing.get("trace_s",
                                                              0.0))
            mem = res.get("memory", {})
            print(f"dryrun 14b {json.dumps(dict(res, card=smi, seconds=took))}",
                  flush=True)
            print(f"dryrun 14b {arch} {shape} 16x16: busiest position "
                  f"{mem.get('per_device_total', 0) / 1e9:.2f} GB, fits "
                  f"{mem.get('fits_hbm')}, lowered and counted in "
                  f"{took:.1f} s (budget {budget:.0f} s; its traces "
                  f"{res.get('trip_counts', {}).get('trace_s')} s), {smi}",
                  flush=True)
            if res.get("status") != "OK":
                tail = log.read_text().splitlines()[-30:]
                print("\n".join(f"dryrun 14b log | {ln}" for ln in tail),
                      flush=True)
                fail(f"14b: {arch} {shape} ended {res.get('status')}: "
                     f"{res.get('reason')}")
            if took > budget:
                fail(f"14b: {arch} {shape} took {took:.1f} s (> {budget})")
        print(report.render(report.load_rows(self.out, "16x16"),
                            capacity_gb=hw.hbm_bytes() / 1e9, trace_s=True),
              flush=True)
        return seconds


def dryrun_path(args, counters, smi, cells):
    """Phase 14: the dry run's count held to the card (14a) and the
    production cells counted on its host (14b, started at the run's
    beginning: ``cells``); no queue kernel may launch."""
    from repro_torch import dist
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as tf
    from repro_torch.roofline import traffic
    for w in counters.values():
        w.launches = 0
    t0 = time.perf_counter()

    def mesh_run(devices):
        return launch_mesh.fake_mesh(dist.abstract_mesh(MESH_SHAPE,
                                                        MESH_AXES), devices)

    times = {}
    dry_train(args, train, tf, dist, traffic, smi, mesh_run)
    times["14a train"] = time.perf_counter() - t0
    dry_serve(args, serve, tf, dist, traffic, smi, mesh_run)
    times["14a serve"] = time.perf_counter() - t0 - times["14a train"]
    times["14b"] = cells.collect(smi)
    launches = {k: w.launches for k, w in counters.items()}
    print(f"phase 14: {time.perf_counter() - t0:.1f} s, by part "
          f"{json.dumps(times)}, queue kernel launches "
          f"{json.dumps(launches)}", flush=True)
    if any(launches.values()):
        fail(f"the dry-run path launched a queue kernel: {launches}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import data, quality, serving
    from repro_torch import examples
    from repro_torch.data import priority_sampler
    from repro_torch.examples import (dev_check_dist,  # noqa: F401
                                      dev_check_models, dev_check_pq,
                                      event_sim, quickstart,
                                      serve_requests, train_lm)
    from repro_torch.roofline import record_from_traffic, traffic
    from repro_torch.core import adaptive, config, factory, pqueue as pq
    from repro_torch.core import distributed as dq
    from repro_torch.core import sharded as shq
    from repro_torch.ft.inject import parse_chaos
    from repro_torch.core.ref_pq import RefPQ
    from repro_torch.kernels import bitonic, build, merge_consume
    from repro_torch.kernels import lane_tick as lt
    from repro_torch.kernels import ops, radix_select
    wrappers = {"bitonic_sort_kvf": bitonic.bitonic_sort_kvf,
                "merge_sorted_kvf": merge_consume.merge_sorted_kvf,
                "radix_select_threshold":
                    radix_select.radix_select_threshold}

    t_start = time.perf_counter()
    # 1. device
    smi = card()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 14b's production cells count on the host from here on
    from repro_torch.roofline import hw
    dry_cells = DryCells(hw.hbm_bytes())

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for kname, (secs, log) in build.BUILD_LOG.items():
        print(f"build {kname}: {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {kname}: {line.strip()}", flush=True)

    # 3. kernel vs plain version
    records_k3 = kernel_settings_path(args, config, factory, serving,
                                      examples, priority_sampler, lt, pq,
                                      traffic)

    # 4-5. the main path through the engine API
    w4096_run = main_path_w4096(args, factory, pq, lt, RefPQ)
    prod_run = main_path_production(args, factory, pq, lt, RefPQ, config)
    engine_k124 = {k: w.launches for k, w in wrappers.items()}
    print(f"K1/K2/K4 launches after phases 3-5: {engine_k124}", flush=True)
    if any(engine_k124.values()):
        fail(f"the pqe path launched K1, K2 or K4: {engine_k124}")

    # 6. the kernel-ops path
    t6 = time.perf_counter()
    records, ops_launches = kernel_ops_path(args, w4096_run, prod_run, ops,
                                            pq, wrappers, bitonic,
                                            radix_select, traffic)
    print(f"kernel-ops path: {time.perf_counter() - t6:.1f} s", flush=True)
    k2_vs_sort = {r["op"].split(" ", 1)[1]: dict(
        ms=r["ms"], torch_sort_ms=r["library_ms"],
        ratio=r["ms"] / r["library_ms"])
        for r in records.values()
        if r["kernel"] == "K2" and r["ms"] is not None}
    print(f"k2_vs_torch_sort {json.dumps(k2_vs_sort)}", flush=True)

    # 7. the sharded main path
    t7 = time.perf_counter()
    sharded = sharded_path(args, factory, config, pq, shq, lt, ops,
                           dict(wrappers, fused_tick_mid=lt.fused_tick_mid))
    print(f"sharded path: {time.perf_counter() - t7:.1f} s", flush=True)

    # 8. the baselines, the adaptive engine and the quality layer
    t8 = time.perf_counter()
    counters = dict(wrappers, fused_tick_mid=lt.fused_tick_mid)
    baselines_path(args, factory, pq, RefPQ, counters)
    phased = adaptive_path("adaptive_w4096_L8_phased", args, factory,
                           adaptive, pq, shq, ops, counters)
    check_phased(phased)
    fold = adaptive_path("adaptive_w4096_L8_fold", args, factory, adaptive,
                         pq, shq, ops, counters, min_lanes=1,
                         engines=("sharded",))
    check_fold(fold)
    quality_path(factory, quality, counters)
    print(f"phase 8: {time.perf_counter() - t8:.1f} s", flush=True)

    # 9. the serving path: the mesh queue, a kill, the request engine
    t9 = time.perf_counter()
    dist = dist_path(args, factory, config, pq, shq, dq, ops, counters, lt,
                     bitonic)
    kill = kill_path(args, factory, config, pq, dq, ops, counters, lt,
                     bitonic)
    bench = json.loads((ROOT / "BENCH_pq.json").read_text())["results"]
    served = serving_path(args, serving, parse_chaos, dq, counters, bench,
                          lt, bitonic)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s", flush=True)

    # 10. the queue's other users, and the roofline
    t10 = time.perf_counter()
    sampler = sampler_path(args, config, data, priority_sampler, RefPQ,
                           counters, lt, bitonic)
    ran = examples_path(examples, counters, lt, bitonic)
    roofline_path(w4096_run, prod_run, sharded, sampler, records,
                  records_k3, traffic, record_from_traffic)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s", flush=True)

    # 11. the model stack's serving path
    phase11 = model_path(args, counters, smi)

    # 12. training on one device
    held = held_settings(records, records_k3)
    _, train_kernels = train_path(args, examples, counters, lt, bitonic,
                                  held, smi)

    # 13. the model stack on a mesh of positions on the card
    mesh_path(args, counters, smi, phase11["full"])

    # 14. the dry run: its count held to the card, a production cell
    dryrun_path(args, counters, smi, dry_cells)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for cell, run, k3 in (("w4096", w4096_run, "w4096_L1"),
                          ("production", prod_run, "production_L1")):
        r = records_k3[k3]
        kernels.append(dict(
            name=f"lane_tick[{cell}]", route="cuda",
            source="src/repro_torch/kernels/csrc/lane_tick.cu",
            replaces="src/repro/kernels/lane_tick.py:185",
            launches=run["launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=None))
    for cell, k3, k2 in (
            ("sharded_w4096_L8_des", "sharded_w4096_L8",
             "sort_kvf sharded L=8 lane batch [8, 512] uniform"),
            ("sharded_production_L8_uniform", "sharded_production_L8",
             "sort_kvf sharded L=8 lane batch [8, 128] uniform")):
        run, r = sharded[cell], records_k3[k3]
        kernels.append(dict(
            name=f"lane_tick[{cell}]", route="cuda",
            source="src/repro_torch/kernels/csrc/lane_tick.cu",
            replaces="src/repro/kernels/lane_tick.py:185",
            launches=run["launches"]["fused_tick_mid"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by="bytes", library_ms=None))
        kernels.append(dict(
            name=f"bitonic_sort_kvf[router {cell}]", route="cuda",
            source="src/repro_torch/kernels/csrc/bitonic.cu",
            replaces="src/repro/kernels/bitonic.py:89",
            launches=run["launches"]["bitonic_sort_kvf"],
            max_abs_err=records[k2]["max_abs_err"],
            **{k: records[k2][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}))
    k2_512 = records["sort_kvf sharded L=8 lane batch [8, 512] uniform"]
    k2_4096 = records["sort_kvf w4096 add batch [1, 4096] uniform"]
    for cell, rec, k3_rows, k2_rows in (
            ("adaptive_w4096_L8_phased", phased,
             (("pqe/L1", "w4096_L1"), ("sharded/L8", "sharded_w4096_L8")),
             (("sharded/L8", k2_512),)),
            ("adaptive_w4096_L8_fold", fold,
             (("sharded/L8", "adaptive_fold_L8"),
              ("sharded/L1", "adaptive_fold_L1")),
             (("sharded/L8", k2_512), ("sharded/L1", k2_4096)))):
        for plan, k3 in k3_rows:
            r = records_k3[k3]
            kernels.append(dict(
                name=f"lane_tick[{cell} {plan}]", route="cuda",
                source="src/repro_torch/kernels/csrc/lane_tick.cu",
                replaces="src/repro/kernels/lane_tick.py:185",
                launches=rec["launches_by_plan"][plan]["k3"],
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by="bytes", library_ms=None))
        for plan, r in k2_rows:
            kernels.append(dict(
                name=f"bitonic_sort_kvf[router {cell} {plan}]", route="cuda",
                source="src/repro_torch/kernels/csrc/bitonic.cu",
                replaces="src/repro/kernels/bitonic.py:89",
                launches=rec["launches_by_plan"][plan]["k2"],
                max_abs_err=r["max_abs_err"],
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}))
    kernels += serving_kernels(held, dist, kill, served)
    sampler_k3 = records_k3["sampler_production_L1"]
    rows = setting_kernels(
        "sampler PRODUCTION", sampler["k3"], sampler["k2"],
        ({**held[0], (sampler_k3["geometry"], 1): sampler_k3}, held[1]))
    for row in rows:     # beside phase 3's time: the path's own, profiled
        row["path_ms"] = sampler["k3_ms_per_launch"]
    kernels += rows
    for name, run in ran.items():
        kernels += setting_kernels(name, run["k3"], run["k2"], held)
    kernels += train_kernels
    kernels += kernel_ops_rows(records, ops_launches)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
