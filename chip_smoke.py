#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. device — the card's name and power limit (nvidia-smi);
2. build  — nvcc builds every kernel in src/repro_torch/kernels/csrc into
   build/ (one nvcc per source, all at once);
3. kernel vs plain version — the lane-tick kernel against its plain
   PyTorch version on the card, bit for bit, on states driven through
   real ticks, at twenty geometry/lane settings (the repair-forcing
   geometry also at a head tile width of 64 slots, so merge windows
   cross tile edges, and on a stream whose keys tie; the lane geometries
   of the two sharded cells of phase 7 at L=8 and, for phase 9's
   positions, L=4; the adaptive engine's fold-headroom lane geometry of
   phase 8c at L=8 and L=1; phase 9's kill lane geometry and its serving
   cells' lane geometries, with and without a spare position);
   both timed on the device clock, with the host-clocked call time
   beside it;
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
   (1 to 100000 keys), each held bit for bit against the same op under
   the "torch" backend and timed on the device clock beside it and one
   PyTorch library call (for K2, ``torch.sort``, listed beside it);
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
      BENCH_pq.json's, µs per serving tick and the device busy share.

The last lines are a JSON record of the kernels and the run's status
line.  Phase 9's rows in it are one per kernel setting (K3's lane
geometry and grid, K2's router shape), each with the launches made at
that setting and the error and times phase 3 or 6 measured there.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KEY_HI = 100_000.0
WARM_ELEMENTS = 2000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 peak (NVIDIA data sheet)


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


def kernel_vs_plain(name, cfg, streams, check_from, lt, pq, head_tile=None):
    """Drive every lane through its stream with the plain tick; from tick
    ``check_from`` on, hold the kernel against its plain version on the
    stacked lanes, at the head tile width ``head_tile`` (default: the
    wrapper's).  Returns a record with the last input's timings."""
    head_tile = head_tile or lt.HEAD_TILE
    lanes = len(streams)
    states = [pq.init(cfg, "cuda") for _ in streams]
    ticks = streams[0][0].shape[0]
    err, checked, fired = 0.0, 0, np.zeros(5, np.int64)
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
        states = [pq.tick(cfg, s, *(b[i] for b in batch))[0]
                  for i, s in enumerate(states)]
    # timings on the last checked input: device time per call (the host's
    # launch cost out), and the host-clocked call time beside it
    def kernel():
        lt.launch(cfg, inputs, outs, ws, head_tile=head_tile)

    def plain():
        lt.fused_tick_mid_plain(cfg, stacked, *batch)

    ms, ms_device_only = device_ms(kernel, 20)
    plain_ms, plain_device_only = device_ms(plain, 5)
    moved = sum(x.numel() * x.element_size() for x in inputs + outs)
    rec = dict(setting=name, lanes=lanes, head_tile=head_tile,
               geometry=lane_geometry(cfg), checked_ticks=checked,
               fired=fired.tolist(), max_abs_err=err, ms=ms,
               ms_device_only=ms_device_only, call_ms=cuda_ms(kernel, 20),
               plain_ms=plain_ms, plain_ms_device_only=plain_device_only,
               plain_call_ms=cuda_ms(plain, 5), bytes=moved,
               bound_ms=moved / HBM_BYTES_PER_S * 1e3)
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
KERNEL_GROUPS = (("lane_tick", ("head_kernel", "rows_kernel", "move_kernel")),
                 ("router_sort", ("row_sort_kernel", "sweep_kernel")))


def kernel_share(eng, state, rows):
    """:func:`device_profile` over the ticks of ``rows``."""
    ak, av, mask, rm = rows
    box = [state, 0]

    def step():
        t = box[1]
        box[0], _ = eng.tick(box[0], ak[t], av[t], mask[t], rm[t])
        box[1] += 1
    return device_profile(step, ak.shape[0])


def device_profile(step, n):
    """Device time over ``n`` calls of ``step`` (a tick) under the
    profiler: the port's kernels by name (the lane tick's three, and
    K2's, the sharded router's sort), every device event (kernels,
    copies, fills) in all, and both as shares of the window's wall time;
    None when the profiler records no device time.  Only device events
    are summed: a CPU op's self device time repeats the kernels it
    launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ours = {group: {} for group, _ in KERNEL_GROUPS}
    others = {}
    total = launches = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        total += ev.self_device_time_total
        launches += ev.count
        hit = next(((g, k) for g, names in KERNEL_GROUPS for k in names
                    if k in ev.key), None)
        if hit:
            g, k = hit
            ours[g][k] = ours[g].get(k, 0.0) + ev.self_device_time_total / n
        else:
            others[ev.key[:60]] = ev.self_device_time_total / n
    if total <= 0:
        return None
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    kernel_us = sum(sum(g.values()) for g in ours.values())
    return dict(ticks=n, wall_us_per_tick=wall_us / n,
                kernel_us_per_tick=kernel_us,
                lane_tick_us_per_tick=ours["lane_tick"],
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
    timings("w4096_p50_des", engines, warm_states, mix_rows, 50,
            {"pq": pq, "lt": lt})
    return dict(launches=launches, cfg=engines[0].cfg, state=mix_states[0],
                rows=mix_rows)


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
    timings("production_p50_uniform", engines, filled, mix_rows, 30,
            {"pq": pq, "lt": lt})
    return dict(launches=launches, cfg=engines[0].cfg, state=states[0],
                rows=mix_rows)


# ---------------------------------------------------------------------------
# phase 6: the kernel-ops path (K1, K2, K4 and their compositions)
# ---------------------------------------------------------------------------

class OpCase:
    """One op at one shape: its "cuda" and "torch" calls, a library call
    that computes the same function (timed only), the bytes it must move,
    and how its outputs compare (default: every output bit for bit)."""

    def __init__(self, kernel, label, cuda, plain, library, nbytes,
                 canon=None, also=None, timed=True):
        self.kernel, self.label = kernel, label
        self.cuda, self.plain, self.library = cuda, plain, library
        self.nbytes, self.canon, self.also = nbytes, canon, also
        self.timed = timed


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


def kernel_ops_cases(args, w4096, prod, ops, pq, radix_select):
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
                2 * nbytes(k, v, f), timed=mix == "uniform"))

    # K1: merge_sorted
    sk_p, sv_p = sorted_batch(prod, 0)
    sk_w, sv_w = sorted_batch(w4096, 0)
    sp, sw = prod["state"], w4096["state"]
    fk, fv = pq.flatten_parallel(prod["cfg"], pq._par_of(sp))
    merges = {
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
    for shape, (ak, av, bk, bv) in merges.items():
        ak, av, bk, bv = (x.contiguous() for x in (ak, av, bk, bv))
        af, bf = torch.zeros_like(av), torch.ones_like(bv)
        a, b = (ak, av, af), (bk, bv, bf)
        cases.append(OpCase(
            "K1", f"merge_sorted {shape}",
            lambda a=a, b=b: ops.merge_sorted(*a, *b, backend=cuda),
            lambda a=a, b=b: ops.merge_sorted(*a, *b, backend=plain),
            lambda a=a, b=b: torch.sort(torch.cat([a[0], b[0]], -1), dim=-1,
                                        stable=True),
            2 * nbytes(*a, *b)))

    # K4: select_threshold on the PRODUCTION store, flattened
    flat_k, flat_v = pk.reshape(1, -1), pv.reshape(1, -1)
    n_fin = int(torch.isfinite(flat_k).sum())
    for k in (0, 1, 1024, 65536, n_fin, n_fin + 1):
        kt = torch.full((1,), k, dtype=torch.int32, device="cuda")
        cases.append(OpCase(
            "K4", f"select_threshold PRODUCTION store 1048576 keys k={k}",
            lambda kt=kt: ops.select_threshold(flat_k, kt, backend=cuda),
            lambda kt=kt: ops.select_threshold(flat_k, kt, backend=plain),
            (lambda k=k: torch.kthvalue(flat_k, k, dim=-1)) if k else None,
            nbytes(flat_k, kt) + 8,
            also=lambda kt=kt: radix_select.radix_select_threshold_plain(
                flat_k, kt)))

    # K4 then K2: the compositions
    k_max = prod["cfg"].move_k_max
    cases.append(OpCase(
        "K4+K2", f"select_k_smallest PRODUCTION store k={k_max} "
        f"k_max={k_max}",
        lambda: ops.select_k_smallest(flat_k, flat_v, k_max, k_max,
                                      backend=cuda),
        lambda: ops.select_k_smallest(flat_k, flat_v, k_max, k_max,
                                      backend=plain),
        lambda: torch.topk(flat_k, k_max, dim=-1, largest=False,
                           sorted=True),
        nbytes(flat_k, flat_v) + 8 * k_max))
    wk, wv, wc, wsp = store(w4096)
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
                None, 2 * nbytes(sk, sv, sc) + nbytes(spl) + 8 * km,
                canon=canon_extract))
    return cases


def canon_extract(out, bitonic):
    """The survivors' slot layout differs by design (the kernel branch
    keeps slot order, the plain branch leaves sorted runs): a stable row
    sort of the survivors gives the plain branch's layout bit for bit."""
    out_k, out_v, new_k, new_v, new_counts = out
    rk, rv, _ = bitonic.bitonic_sort_kvf_plain(new_k, new_v,
                                               torch.zeros_like(new_v))
    return out_k, out_v, rk, rv, new_counts


def kernel_ops_path(args, w4096, prod, ops, pq, wrappers, bitonic,
                    radix_select):
    """Phase 6.  Every case's "cuda" call runs once with the launch counts
    set to 0 (the path run); then each is held against its "torch" call
    (and K4 also against its plain version) bit for bit and timed.
    Returns ({label: record}, {kernel: launches in the path run})."""
    cases = kernel_ops_cases(args, w4096, prod, ops, pq, radix_select)
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
                   max_abs_err=err,
                   bound_ms=case.nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
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
    return records, totals


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
                         fired=fired, worst_rank=cons.worst, timing=rec)
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


class PositionLaunches:
    """K3 and K2 launches per mesh position and per kernel setting.  Inside
    the ``with`` block, ``distributed._position_tick`` (one position's lane
    work, looked up at call time) is wrapped: each call of a "cuda" lane
    config charges the counters' growth within it to (lanes per position,
    position) and to its kernels' shapes.  ``calls[(l, p)]`` = [calls, K3
    launches, K2 launches]; ``k3[(lane geometry, l)]`` = K3 launches at
    grid l, ``k2[(l, smax)]`` = K2 launches on [l, smax] router rows."""

    def __init__(self, dq, counters):
        self.dq, self.counters = dq, counters
        self.calls, self.k3, self.k2 = {}, {}, {}

    def __enter__(self):
        inner, k3, k2 = (self.dq._position_tick,
                         self.counters["fused_tick_mid"],
                         self.counters["bitonic_sort_kvf"])
        calls, at3, at2 = self.calls, self.k3, self.k2

        def counted(scfg, part, route_inv, ak, av, am, grants, lane_lo,
                    n_local):
            before = (k3.launches, k2.launches)
            out = inner(scfg, part, route_inv, ak, av, am, grants, lane_lo,
                        n_local)
            if scfg.lane.backend == "cuda":
                got = (k3.launches - before[0], k2.launches - before[1])
                c = calls.setdefault((n_local, lane_lo // n_local), [0, 0, 0])
                c[0] += 1
                c[1] += got[0]
                c[2] += got[1]
                g3 = (lane_geometry(scfg.lane), n_local)
                g2 = (n_local, -(-ak.shape[0] // scfg.n_lanes))
                at3[g3] = at3.get(g3, 0) + got[0]
                at2[g2] = at2.get(g2, 0) + got[1]
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

    def shapes(self):
        """The launches by kernel setting, for a cell's record:
        (K3 [[lane geometry, grid, launches]], K2 [[rows, smax,
        launches]])."""
        return ([[g, l, n] for (g, l), n in self.k3.items()],
                [[l, n_, k] for (l, n_), k in self.k2.items()])


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


def dist_path(args, factory, config, pq, shq, dq, ops, counters):
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
                   shapes=pl.shapes(), worst_rank=cons.worst,
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


def kill_path(args, factory, config, pq, dq, ops, counters, at=10,
              after=30):
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
    with PositionLaunches(dq, counters) as pl:
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
    rec = dict(cell="dist_kill_w4096", device=card(), killed_at=at,
               resident_at_kill=int(before.numel()),
               shed_after_kill=lane_drops(state),
               ticks=int(rows[0].shape[0]), launches=launches,
               per_position=[dict(calls=c[0], k3=c[1], k2=c[2])
                             for c in got], shapes=pl.shapes(),
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


def serving_path(args, serving, parse_chaos, dq, counters, bench):
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
        served, profile, spent, t = set(), None, 0.0, 0
        with PositionLaunches(dq, counters) as pl:
            while t < ticks:
                if t == 50 and cell.endswith("steady"):   # ticks 50-99
                    profile = device_profile(lambda: serve_checks(
                        cell, eng, eng.tick(), served), 50)
                    t += 50
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
        n_timed = ticks - (50 if profile is not None else 0)
        rec = dict(cell=cell, device=card(), ticks=ticks, drain_ticks=drain,
                   arrivals=r["arrivals"], served=r["served"],
                   shed=r["shed"], expired=r["expired"],
                   shed_reasons=r["shed_reasons"], max_depth=r["max_depth"],
                   depth_cap=r["depth_cap"], p50=r["p50"], p99=r["p99"],
                   p999=r["p999"], live_devices=r["live_devices"],
                   bench_pq=bench.get(cell), k3=k3, k2=k2,
                   shapes=pl.shapes(),
                   us_per_serving_tick=spent / n_timed * 1e6,
                   profile=profile)
        print(f"serving_path {json.dumps(rec)}", flush=True)
        out[cell] = rec
    if not sum(r["k3"] for r in out.values()):
        fail("the serving cells never launched K3")
    return out


def serving_kernels(records, records_k3, dist, kill, served):
    """The kernels line's entries of phase 9: per group of cells, one K3
    row per lane geometry and grid and one K2 row per router shape, each
    with the launches made at that setting and the error and timings
    phases 3 and 6 took at the same setting.  A setting with launches
    that neither phase held against its plain version fails the run."""
    k3_at, k2_at = {}, {}
    for name, r in records_k3.items():
        k3_at.setdefault((r["geometry"], r["lanes"]), r)
    for label, r in records.items():
        m = re.fullmatch(r"sort_kvf .*\[(\d+), (\d+)\] uniform", label)
        if m:
            k2_at.setdefault((int(m[1]), int(m[2])), r)
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
    from repro_torch import quality, serving
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

    for lanes in (1, 4):
        kernel_vs_plain(f"repair_L{lanes}", repair_cfg,
                        repair_streams(lanes), 0, lt, pq)
        kernel_vs_plain(f"repair_L{lanes}_tile64", repair_cfg,
                        repair_streams(lanes), 0, lt, pq, head_tile=64)
    for lanes in (1, 3):
        kernel_vs_plain(f"duplicates_L{lanes}_tile64", repair_cfg,
                        repair_streams(lanes, ties=True), 0, lt, pq,
                        head_tile=64)
    records_k3["w4096"] = kernel_vs_plain(
        "w4096_L1", w4096, mix_streams(1, 4096, 1, 12, "des"), 1, lt, pq)
    kernel_vs_plain("w4096_L8", w4096, mix_streams(8, 4096, 1, 6, "des"),
                    1, lt, pq)
    records_k3["production"] = kernel_vs_plain(
        "production_L1", prod, mix_streams(1, 1024, 16, 6, "uniform"),
        16, lt, pq)
    # the lane geometries of phase 7's cells, all eight lanes in one launch
    for cell, spec, dist, warm in (
            ("sharded_w4096", dict(width=4096), "des", 1),
            ("sharded_production", dict(width=1024, base=config.PRODUCTION),
             "uniform", 16)):
        lane = factory.make_engine(factory.EngineSpec(
            engine="sharded", lanes=8, backend="torch", **spec)).cfg.lane
        records_k3[cell] = kernel_vs_plain(
            f"{cell}_L8", lane, mix_streams(8, lane.a_max, warm, 6, dist),
            warm, lt, pq)
        # phase 9a's D=2 positions: four of these lanes a launch
        records_k3[f"{cell}_L4"] = kernel_vs_plain(
            f"{cell}_L4", lane, mix_streams(4, lane.a_max, warm, 6, dist),
            warm, lt, pq)
    # the adaptive engine's fold-headroom lane geometry (min_lanes=1) of
    # phase 8c, at both lane counts it runs
    fold_lane = factory.make_engine(factory.EngineSpec(
        engine="sharded", width=4096, lanes=8, min_lanes=1,
        backend="torch")).cfg.lane
    for lanes in (8, 1):
        records_k3[f"fold_L{lanes}"] = kernel_vs_plain(
            f"adaptive_fold_L{lanes}", fold_lane,
            mix_streams(lanes, fold_lane.a_max, 1, 6, "des"), 1, lt, pq)

    # phase 9's other lane geometries: the kill cell's spare-sized lanes
    # (grid 4), the serving cells' at width 64 (grid 2) and 1024 (grid 4),
    # each without and with a spare position (the chaos cells)
    kill_lane = factory.make_engine(factory.EngineSpec(
        engine="dist", width=4096, lanes=8, n_devices=2, lanes_per_device=4,
        spare_devices=1, backend="torch"), device="cpu").cfg.shard.lane
    records_k3["kill_L4"] = kernel_vs_plain(
        "dist_kill_L4", kill_lane, mix_streams(4, kill_lane.a_max, 1, 6,
                                               "des"), 1, lt, pq)
    for setting, kw, lanes in (("serve64_L2", SERVE_NARROW, 2),
                               ("serve1024_L4", SERVE_WIDE, 4)):
        for spare, suffix in ((0, ""), (1, "_spare")):
            lane = serving.build_engine(
                n_devices=2, device="cpu", backend="torch",
                spare_devices=spare,
                **{k: v for k, v in kw.items() if k != "depth_cap"}
            ).queue.queue.cfg.shard.lane
            records_k3[setting + suffix] = kernel_vs_plain(
                setting + suffix, lane,
                mix_streams(lanes, lane.a_max, 1, 6, "des"), 1, lt, pq)

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
                                            radix_select)
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
    dist = dist_path(args, factory, config, pq, shq, dq, ops, counters)
    kill = kill_path(args, factory, config, pq, dq, ops, counters)
    bench = json.loads((ROOT / "BENCH_pq.json").read_text())["results"]
    served = serving_path(args, serving, parse_chaos, dq, counters, bench)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for cell, run in (("w4096", w4096_run), ("production", prod_run)):
        r = records_k3[cell]
        kernels.append(dict(
            name=f"lane_tick[{cell}]", route="cuda",
            source="src/repro_torch/kernels/csrc/lane_tick.cu",
            replaces="src/repro/kernels/lane_tick.py:185",
            launches=run["launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=None))
    for cell, k3, k2 in (
            ("sharded_w4096_L8_des", "sharded_w4096",
             "sort_kvf sharded L=8 lane batch [8, 512] uniform"),
            ("sharded_production_L8_uniform", "sharded_production",
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
             (("pqe/L1", "w4096"), ("sharded/L8", "sharded_w4096")),
             (("sharded/L8", k2_512),)),
            ("adaptive_w4096_L8_fold", fold,
             (("sharded/L8", "fold_L8"), ("sharded/L1", "fold_L1")),
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
    kernels += serving_kernels(records, records_k3, dist, kill, served)
    for kname, wrapper, src, replaces, label in (
            ("K1", "merge_sorted_kvf", "merge_consume.cu",
             "src/repro/kernels/merge_consume.py:119",
             "merge_sorted PRODUCTION combine 131072+1024"),
            ("K2", "bitonic_sort_kvf", "bitonic.cu",
             "src/repro/kernels/bitonic.py:89",
             "sort_kvf PRODUCTION bucket rows [1024, 1024] uniform"),
            ("K4", "radix_select_threshold", "radix_select.cu",
             "src/repro/kernels/radix_select.py:93",
             "select_threshold PRODUCTION store 1048576 keys k=65536")):
        err = max(r["max_abs_err"] for r in records.values()
                  if kname in r["kernel"])
        kernels.append(dict(
            name=f"{wrapper}[{label.split(' ', 1)[1]}]", route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=ops_launches[wrapper], max_abs_err=err,
            **{k: records[label][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
