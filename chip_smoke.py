#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, each fatal on failure:

1. device — the card's name and power limit (nvidia-smi);
2. build  — nvcc builds every kernel in src/repro_torch/kernels/csrc into
   build/ (one nvcc per source, all at once);
3. kernel vs plain version — the lane-tick kernel against its plain
   PyTorch version on the card, bit for bit, on states driven through
   real ticks, at five geometry/lane settings; both timed with CUDA
   events;
4. main path at w4096 — ``make_engine(EngineSpec(engine="pqe",
   width=4096))`` (the "cuda" kernel backend) beside a "torch" twin: warm
   2000 keys, 200 ticks at p_add 0.5 with DES keys, quiet ticks until
   chopHead fires.  Every result and state bit-equal between the two,
   served keys equal to the heapq oracle's, nothing dropped, all five
   passes fired, one kernel call per tick;
5. main path at PRODUCTION — filled to 262,144 residents, then 100 mixed
   ticks of uniform keys; the same checks, moveHead fired.

The last two lines are a JSON record of the kernel and the run's status
line.  Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


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


def repair_stream(rng, width, ticks):
    """Phased traffic that fires every pass at a tiny store: adds pile up
    (scatter, rebalance), then a big or a tiny drain (moveHead), then
    quiet ticks (chopHead)."""
    keys, rms = [], []
    for t in range(ticks):
        cycle, phase = t // 12, t % 12
        n_add, n_rm = 0, 0
        if phase < 4:
            n_add = int(rng.integers(width // 2, width + 1))
        elif phase == 4:
            n_rm = width if cycle % 2 else int(rng.integers(1, 5))
        keys.append(np.round(rng.uniform(0, 1000, n_add), 3)
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


def kernel_vs_plain(name, cfg, streams, check_from, lt, pq):
    """Drive every lane through its stream with the plain tick; from tick
    ``check_from`` on, hold the kernel against its plain version on the
    stacked lanes.  Returns a record with the last input's timings."""
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
            lt.launch(cfg, inputs, outs, ws)
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
    # timings on the last checked input
    ms = cuda_ms(lambda: lt.launch(cfg, inputs, outs, ws), 20)
    plain_ms = cuda_ms(lambda: lt.fused_tick_mid_plain(cfg, stacked, *batch), 5)
    moved = sum(x.numel() * x.element_size() for x in inputs + outs)
    rec = dict(setting=name, lanes=lanes, checked_ticks=checked,
               fired=fired.tolist(), max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bytes=moved,
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


def kernel_share(eng, state, rows):
    """Device time over a profiled window of ticks: the lane-tick
    kernels by name, every device event (kernels, copies, fills) in all,
    and both as shares of the window's wall time; None when the profiler
    records no device time.  Only device events are summed: a CPU op's
    self device time repeats the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ak, av, mask, rm = rows
    n = ak.shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(n):
            state, _ = eng.tick(state, ak[t], av[t], mask[t], rm[t])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ours, others = {}, {}
    total = launches = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        total += ev.self_device_time_total
        launches += ev.count
        name = next((k for k in ("head_kernel", "rows_kernel", "move_kernel")
                     if k in ev.key), None)
        if name:
            ours[name] = ours.get(name, 0.0) + ev.self_device_time_total / n
        else:
            others[ev.key[:60]] = ev.self_device_time_total / n
    if total <= 0:
        return None
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    kernel_us = sum(ours.values())
    return dict(ticks=n, wall_us_per_tick=wall_us / n,
                kernel_us_per_tick=kernel_us, lane_tick_us_per_tick=ours,
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


def stage_split(eng, state, rows, pq, lt):
    """Wall time per tick of each stage the tick calls, synchronising
    the device before and after every stage, over a window of ticks
    (a separate run: the syncs inflate its total).  The stages are
    module functions the tick looks up at call time, so each is swapped
    for a timed wrapper for the window and restored after."""
    mods = {"pq": pq, "lt": lt}
    spent = {name: 0.0 for _, name in STAGES}
    calls = {name: 0 for _, name in STAGES}
    saved = {name: getattr(mods[m], name) for m, name in STAGES}

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
        for m, name in STAGES:
            setattr(mods[m], name, timed(name, saved[name]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n):
            state, _ = eng.tick(state, ak[t], av[t], mask[t], rm[t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for m, name in STAGES:
            setattr(mods[m], name, saved[name])
    us = {k: v / n * 1e6 for k, v in spent.items() if calls[k]}
    return dict(ticks=n, wall_us_per_tick=wall / n * 1e6,
                stage_us_per_tick=us,
                stage_calls={k: v for k, v in calls.items() if v},
                rest_us_per_tick=(wall - sum(spent.values())) / n * 1e6)


def timings(cell, engines, start_states, rows, window, pq, lt):
    """us/tick of each backend from the same start state, in turns
    (cuda, torch, torch, cuda); then, over the first ``window`` ticks, a
    profiled run of the cuda engine and a stage split of each."""
    (eng_c, eng_t), (s_c, s_t) = engines, start_states
    us_c = [time_ticks(eng_c, s_c, rows)]
    us_t = [time_ticks(eng_t, s_t, rows), time_ticks(eng_t, s_t, rows)]
    us_c.append(time_ticks(eng_c, s_c, rows))
    part = tuple(x[:window] for x in rows)
    rec = dict(cell=cell, ticks=int(rows[0].shape[0]),
               us_per_tick_cuda=us_c, us_per_tick_torch=us_t,
               profile_cuda=kernel_share(eng_c, s_c, part),
               stages_cuda=stage_split(eng_c, s_c, part, pq, lt),
               stages_torch=stage_split(eng_t, s_t, part, pq, lt))
    print(f"main_path {json.dumps(rec)}", flush=True)


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
    timings("w4096_p50_des", engines, warm_states, mix_rows, 50, pq, lt)
    return launches


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
    timings("production_p50_uniform", engines, filled, mix_rows, 30, pq, lt)
    return launches


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
    from repro_torch.core import config, factory, pqueue as pq
    from repro_torch.core.ref_pq import RefPQ
    from repro_torch.kernels import build
    from repro_torch.kernels import lane_tick as lt

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
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
    records = {}

    def repair_streams(lanes):
        return [to_device(batch_rows(64, *repair_stream(
            np.random.default_rng(args.seed + 100 + i), 64, 26)))
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
    records["w4096"] = kernel_vs_plain(
        "w4096_L1", w4096, mix_streams(1, 4096, 1, 12, "des"), 1, lt, pq)
    kernel_vs_plain("w4096_L8", w4096, mix_streams(8, 4096, 1, 6, "des"),
                    1, lt, pq)
    records["production"] = kernel_vs_plain(
        "production_L1", prod, mix_streams(1, 1024, 16, 6, "uniform"),
        16, lt, pq)

    # 4-5. the main path through the engine API
    launches_w = main_path_w4096(args, factory, pq, lt, RefPQ)
    launches_p = main_path_production(args, factory, pq, lt, RefPQ, config)
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for cell, launches in (("w4096", launches_w), ("production", launches_p)):
        r = records[cell]
        kernels.append(dict(
            name=f"lane_tick[{cell}]", route="cuda",
            source="src/repro_torch/kernels/csrc/lane_tick.cu",
            replaces="src/repro/kernels/lane_tick.py:185",
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", library_ms=None))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
