"""The hand-written CUDA kernels against their plain versions.

Runs only where there is a CUDA GPU (the kernels have no CPU mode) and
imports nothing of JAX, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernel.py

K3, the lane tick, at the repair-forcing geometry (every pass fires), at
L=1 and L=3, on a stream of distinct keys and on one whose keys tie, each
at the wrapper's head tile width and at a width of 64 slots, so that the
head's merge windows cross tile edges; K2 at row lengths around its
one-CTA limit and past it, on all-equal keys (stability), both zeros, INF
padding, negatives and duplicates; K1 and K4 on ties, INF padding, -0.0
and rows past one CTA's shared memory; K1 also at K2's key mixes (-0.0 in
a against 0.0 in b), at the phase-6 merges, empty streams, tiles that end
inside a row, rows x tiles past 65535 and inputs off a 16-byte boundary;
K4 in both of its kernels (one CTA a row; the cooperative grid, staged
and not) at both digit widths; one call of each a single kernel on the
card under the profiler; and the kernel ops' "cuda" compositions on the
card against the same compositions on the CPU.
Every output must equal its plain version's bit for bit, and each wrapper
call counts one launch.  K3 also at the lane geometry of the adaptive
engine's fold headroom (``width=4096, lanes=8, min_lanes=1``: a_max 4096,
seq_cap 8194, 64x16 buckets) at L=8 and L=1, and K2 at that geometry's
router rows, [8, 4096] and [1, 4096].  Last, the sharded engine at L=2
and L=4 and the adaptive engine over a stream that switches engines: the
"cuda" engine equals its "torch" twin bit for bit on every tick, with one
lane-tick launch per pqe tick and one lane-tick launch and one router
sort (K2) per sharded tick that does lane work.  The priority sampler's
"cuda" queue picks the groups of its "torch" twin on the card; the
roofline reads the card's memory, and a lane-tick launch at PRODUCTION
takes no less than its traffic bound.  K3's one launch also on crafted
rows of every live-count class (0, 1, 2^k, 2^k + 1, full; live INF keys;
signed-zero ties) at a warp's rows and past them, with lanes that take
moveHead beside one that does not; at sharded PRODUCTION with one row a
rows CTA, a grid far past the card's resident CTAs; and twice back to
back on one counter workspace, then over outputs and scratch filled with
garbage, the counters zero after each launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import PRODUCTION, PQConfig, pqueue, sharded
from repro_torch.core.factory import EngineSpec, make_engine
from repro_torch.kernels import bitonic, build, lane_tick, merge_consume
from repro_torch.kernels import ops, radix_select
from repro_torch.data import PrioritySampler
from repro_torch.data.priority_sampler import DEFAULT_CFG
from repro_torch.roofline import hw, traffic

W = 64
CFG = PQConfig(a_max=W, r_max=W, seq_cap=512, n_buckets=4, bucket_cap=8,
               detach_min=4, detach_max=64, detach_init=8, chop_patience=3,
               backend="torch")


#: keys of the duplicate-heavy stream: adds tie with the sequential part
_POOL = np.array([0.0, -0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0, 34.0],
                 np.float32)


def _repair_batches(rng, ticks, ties=False):
    """Adds pile up (scatter, rebalance), a big or tiny drain (moveHead),
    then quiet ticks (chopHead); [T, W] keys/vals/mask and [T] removes.
    With ``ties`` the keys come from a few values."""
    ak = np.full((ticks, W), np.inf, np.float32)
    av = np.full((ticks, W), -1, np.int32)
    mask = np.zeros((ticks, W), bool)
    rm = np.zeros(ticks, np.int32)
    for t in range(ticks):
        cycle, phase = t // 12, t % 12
        if phase < 4:
            n = int(rng.integers(W // 2, W + 1))
            ak[t, :n] = (rng.choice(_POOL, n) if ties
                         else np.round(rng.uniform(0, 1000, n), 3))
            av[t, :n] = np.arange(t * W, t * W + n)
            mask[t, :n] = True
        elif phase == 4:
            rm[t] = W if cycle % 2 else int(rng.integers(1, 5))
    return [torch.from_numpy(x).cuda() for x in (ak, av, mask, rm)]


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("head_tile", [lane_tick.HEAD_TILE, 64])
@pytest.mark.parametrize("stream", ["repair", "duplicates"])
@pytest.mark.parametrize("lanes", [1, 3])
def test_cuda_kernel_matches_plain_version(lanes, stream, head_tile):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the lane-tick kernel has no CPU mode")
    streams = [_repair_batches(np.random.default_rng(31 + i), 26,
                               ties=stream == "duplicates")
               for i in range(lanes)]
    states = [pqueue.init(CFG, "cuda") for _ in range(lanes)]
    fired = np.zeros(5, np.int64)
    for t in range(26):
        batch = [torch.stack([s[f][t] for s in streams]) for f in range(4)]
        leaves = [pqueue.tree_leaves(s) for s in states]
        stacked = [torch.stack(xs) for xs in zip(*leaves)]
        n = len(pqueue.PQState._fields) - 1
        lanes_state = pqueue.PQState(*stacked[:n],
                                     stats=pqueue.PQStats(*stacked[n:]))
        if head_tile == lane_tick.HEAD_TILE:
            before = lane_tick.fused_tick_mid.launches
            got = lane_tick.fused_tick_mid(CFG, lanes_state, *batch)
            assert lane_tick.fused_tick_mid.launches == before + 1
        else:
            inputs = lane_tick.kernel_inputs(CFG, lanes_state, *batch)
            outs, ws = lane_tick.kernel_buffers(CFG, lanes, "cuda")
            lane_tick.launch(CFG, inputs, outs, ws, head_tile=head_tile)
            got = lane_tick.mid_from_outputs(outs, lanes_state.stats)
        want = lane_tick.fused_tick_mid_plain(CFG, lanes_state, *batch)
        for i, (g, w) in enumerate(zip(pqueue.tree_leaves(got),
                                       pqueue.tree_leaves(want))):
            assert _same_bits(g, w), f"{stream} tick {t} leaf {i}"
        p = got.pending
        fired += [int(x.any()) for x in (p.need_combine, p.need_scatter,
                                         p.need_rebal, p.need_move,
                                         p.need_chop)]
        states = [pqueue.tick(CFG, s, *(b[i] for b in batch))[0]
                  for i, s in enumerate(states)]
    assert (fired > 0).all(), fired.tolist()


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


def _fold_lane_cfg():
    """The lane config of the adaptive engine at w4096, L=8, min_lanes=1
    (plain backend: the test calls the kernel itself)."""
    return make_engine(EngineSpec(engine="sharded", width=4096, lanes=8,
                                  min_lanes=1, backend="torch"),
                       device="cpu").cfg.lane


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 8])
def test_cuda_kernel_at_fold_headroom_geometry(lanes):
    """K3 against its plain version at the fold-headroom lane geometry,
    each lane warmed with 2000 uniform keys and then fed DES mix ticks
    (2048 adds, 2048 removes) after a warm tick."""
    _need_gpu()
    cfg = _fold_lane_cfg()
    assert (cfg.a_max, cfg.seq_cap, cfg.n_buckets, cfg.bucket_cap) == \
        (4096, 8194, 64, 16)
    w, ticks = cfg.a_max, 6
    streams = []
    for i in range(lanes):
        rng = np.random.default_rng(61 + i)
        ak = np.full((ticks, w), np.inf, np.float32)
        mask = np.zeros((ticks, w), bool)
        rm = np.full(ticks, w // 2, np.int32)
        ak[0, :2000], mask[0, :2000], rm[0] = \
            rng.uniform(0, 1e5, 2000), True, 0
        lo = 0.0
        for t in range(1, ticks):
            lo += (w // 2) * 50.0
            ak[t, :w // 2] = lo + rng.exponential(400.0, w // 2)
            mask[t, :w // 2] = True
        av = np.tile(np.arange(w, dtype=np.int32), (ticks, 1))
        streams.append([torch.from_numpy(x).cuda()
                        for x in (ak, av, mask, rm)])
    states = [pqueue.init(cfg, "cuda") for _ in range(lanes)]
    n = len(pqueue.PQState._fields) - 1
    fired = np.zeros(3, np.int64)
    for t in range(ticks):
        batch = [torch.stack([s[f][t] for s in streams]) for f in range(4)]
        leaves = [torch.stack(xs) for xs in zip(
            *(pqueue.tree_leaves(s) for s in states))]
        lanes_state = pqueue.PQState(*leaves[:n],
                                     stats=pqueue.PQStats(*leaves[n:]))
        got = _launched_once(lane_tick.fused_tick_mid, cfg, lanes_state,
                             *batch)
        want = lane_tick.fused_tick_mid_plain(cfg, lanes_state, *batch)
        for i, (g, x) in enumerate(zip(pqueue.tree_leaves(got),
                                       pqueue.tree_leaves(want))):
            assert _same_bits(g, x), f"tick {t} leaf {i}"
        p = got.pending
        fired += [int(x.any()) for x in (p.need_scatter, p.need_rebal,
                                         p.need_move)]
        states = [pqueue.tick(cfg, s, *(b[i] for b in batch))[0]
                  for i, s in enumerate(states)]
    assert (fired > 0).all(), fired.tolist()


def _card():
    """The device of the one-launch kernel tests (skips without a card)."""
    _need_gpu()
    return torch.device("cuda")


def _counters(dev, lanes):
    """The counter workspace launches over ``lanes`` lanes use on the
    current stream of ``dev``."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lane_tick.counter_workspace(dev, stream, lanes)


def _launched(cfg, state, batch, outs=None, ws=None, **launch_kw):
    """The kernel's TickMid through ``lane_tick.launch`` (fresh buffers
    unless given)."""
    lanes = state.seq_len.shape[0]
    inputs = lane_tick.kernel_inputs(cfg, state, *batch)
    if outs is None:
        outs, ws = lane_tick.kernel_buffers(cfg, lanes, inputs[0].device)
    lane_tick.launch(cfg, inputs, outs, ws, **launch_kw)
    return lane_tick.mid_from_outputs(outs, state.stats)


def _assert_bit_equal(got, want, label):
    for i, (g, w) in enumerate(zip(pqueue.tree_leaves(got),
                                   pqueue.tree_leaves(want))):
        assert _same_bits(g, w), f"{label}: output leaf {i}"


def _stack(states):
    n = len(pqueue.PQState._fields) - 1
    leaves = [torch.stack(xs) for xs in zip(
        *(pqueue.tree_leaves(s) for s in states))]
    return pqueue.PQState(*leaves[:n], stats=pqueue.PQStats(*leaves[n:]))


#: the live counts of the crafted rows: 0, 1, 2^k and 2^k + 1, and full,
#: at a warp's rows (bucket_cap 128) and past them (1024: a warp sorts up
#: to 256 live slots, the CTA past that)
_ROW_COUNTS = {
    128: [0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65, 127, 128],
    1024: [0, 1, 2, 3, 128, 129, 256, 257, 512, 513, 1000, 1024],
}


def _crafted(bucket_cap, dev):
    """Three lanes over a store whose rows hold the live counts of
    ``_ROW_COUNTS``, keys in disjoint ordered ranges in shuffled slots:
    row 0 of signed zeros and ties, the last row ending in live INF keys,
    duplicates elsewhere.  Lane 0 takes moveHead and extracts every key,
    lane 1 takes adds and no removal (no moveHead), lane 2 takes
    moveHead and cuts its extraction inside a row.  Returns (cfg, state,
    batch)."""
    counts = _ROW_COUNTS[bucket_cap]
    nb = len(counts)
    cfg = PQConfig(a_max=64, r_max=64, seq_cap=4096, n_buckets=nb,
                   bucket_cap=bucket_cap, detach_min=4, detach_max=4096,
                   detach_init=64, chop_patience=3, backend="torch")
    rng = np.random.default_rng(bucket_cap)
    lanes = []
    for lane, detach in enumerate((4096, 64, 37)):
        s = pqueue.init(cfg, dev)
        bk = np.full((nb, bucket_cap), np.inf, np.float32)
        bv = np.full((nb, bucket_cap), -1, np.int32)
        for b, c in enumerate(counts):
            if b == 0:
                keys = rng.choice(np.float32([-0.0, 0.0, 0.0, 1.0]), c)
            else:
                keys = (b * 1000 + rng.integers(0, 40, c)).astype(np.float32)
            if b == nb - 1:
                keys[c // 2:] = np.inf
            order = rng.permutation(c)
            bk[b, :c] = keys[order]
            bv[b, :c] = (lane * 10 ** 6 + b * 10 ** 4 + order).astype(np.int32)
        spl = np.float32([-np.inf] + [b * 1000 for b in range(1, nb)])
        live = bk[np.arange(bucket_cap)[None, :] < np.array(counts)[:, None]]
        t = lambda x, d: torch.tensor(x, dtype=d, device=dev)  # noqa: E731
        s = s._replace(
            buckets=t(bk, torch.float32), bvals=t(bv, torch.int32),
            bcounts=t(counts, torch.int32), splitters=t(spl, torch.float32),
            par_count=t(sum(counts), torch.int32),
            par_min=t(live.min(), torch.float32),
            detach_n=t(detach, torch.int32))
        lanes.append(s)
    a = cfg.a_max
    ak = np.full((3, a), np.inf, np.float32)
    mask = np.zeros((3, a), bool)
    ak[1, :40] = rng.integers(1000, nb * 1000, 40).astype(np.float32)
    mask[1, :40] = True
    av = np.tile(np.arange(a, dtype=np.int32), (3, 1)) + 7 * 10 ** 6
    grant = np.int32([64, 0, 5])
    batch = [torch.from_numpy(x).to(dev) for x in (ak, av, mask, grant)]
    return cfg, _stack(lanes), batch


@pytest.mark.gpu
@pytest.mark.parametrize("bucket_cap", sorted(_ROW_COUNTS))
def test_one_launch_kernel_on_crafted_rows(bucket_cap):
    """Rows of every live-count class, live INF keys, signed-zero ties;
    lanes with and without moveHead in one grid: bit-equal to the plain
    version, one launch per call."""
    dev = _card()
    cfg, state, batch = _crafted(bucket_cap, dev)
    got = _launched_once(lane_tick.fused_tick_mid, cfg, state, *batch)
    want = lane_tick.fused_tick_mid_plain(cfg, state, *batch)
    _assert_bit_equal(got, want, f"bucket_cap {bucket_cap}")
    moved = (got.pending.need_move & ~got.pending.need_rebal).tolist()
    assert moved == [True, False, True], moved
    # lane 0 extracted every key, lane 2 stopped inside a row
    assert int(got.par.par_count[0]) == 0
    assert 0 < int(got.par.par_count[2]) < int(state.par_count[2])


@pytest.mark.gpu
def test_one_launch_kernel_outgrows_the_resident_ctas():
    """Sharded PRODUCTION's lanes at L=8 with one row a rows CTA: 8192
    rows CTAs, far more than the card holds at once; CTAs that wait only
    wait on earlier tickets, so the launch ends, bit-equal to the plain
    version on fill ticks and on a moveHead tick."""
    dev = _card()
    cfg = make_engine(EngineSpec(engine="sharded", width=1024, lanes=8,
                                 base=PRODUCTION, backend="torch"),
                      device="cpu").cfg.lane
    plan = lane_tick.launch_plan(cfg, 8, rows_per_cta=1)
    assert plan.role("rows").ctas_per_lane * 8 == 8192
    assert plan.grid > torch.cuda.get_device_properties(
        dev).multi_processor_count * 4
    rng = np.random.default_rng(5)
    states = [pqueue.init(cfg, dev) for _ in range(8)]
    a = cfg.a_max
    moved = 0
    for t in range(5):
        fill = t < 4
        ak = (rng.uniform(0, 1e5, (8, a)) if fill
              else np.full((8, a), np.inf)).astype(np.float32)
        mask = np.full((8, a), fill)
        av = np.tile(np.arange(a, dtype=np.int32), (8, 1)) + t * a
        grant = np.full(8, 0 if fill else a, np.int32)
        batch = [torch.from_numpy(x).to(dev) for x in (ak, av, mask, grant)]
        state = _stack(states)
        got = _launched(cfg, state, batch, rows_per_cta=1)
        want = lane_tick.fused_tick_mid_plain(cfg, state, *batch)
        torch.cuda.synchronize()
        _assert_bit_equal(got, want, f"tick {t}")
        moved += int((got.pending.need_move & ~got.pending.need_rebal).sum())
        states = [pqueue.tick(cfg, s, *(b[i] for b in batch))[0]
                  for i, s in enumerate(states)]
    assert moved > 0


@pytest.mark.gpu
def test_one_launch_kernel_reuses_its_workspace():
    """Two launches back to back on one counter workspace, then one whose
    outputs and scratch hold garbage: each bit-equal to the plain version,
    and every launch leaves the counters zero."""
    dev = _card()
    cfg, state, batch = _crafted(128, dev)
    want = lane_tick.fused_tick_mid_plain(cfg, state, *batch)
    ctr = _counters(dev, 3)
    first = _launched(cfg, state, batch)
    second = _launched(cfg, state, batch)
    torch.cuda.synchronize()
    assert not ctr.any(), ctr.tolist()
    _assert_bit_equal(first, want, "first launch")
    _assert_bit_equal(second, want, "second launch")
    outs, ws = lane_tick.kernel_buffers(cfg, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    for x in outs + ws:
        x.view(torch.int32).copy_(torch.randint(
            -2 ** 31, 2 ** 31 - 1, x.shape, generator=gen, device=dev,
            dtype=torch.int32))
    garbage = _launched(cfg, state, batch, outs=outs, ws=ws)
    torch.cuda.synchronize()
    assert not ctr.any(), ctr.tolist()
    _assert_bit_equal(garbage, want, "launch over garbage")


def _mixed_keys(rng, shape):
    """Uniform keys with duplicates, INF padding and both zeros."""
    k = rng.uniform(-100, 100, shape).astype(np.float32)
    k[rng.random(shape) < 0.2] = 7.0
    k[rng.random(shape) < 0.2] = np.inf
    k[rng.random(shape) < 0.05] = 0.0
    k[rng.random(shape) < 0.05] = -0.0
    return k


def _launched_once(wrapper, *args):
    before = wrapper.launches
    out = wrapper(*args)
    assert wrapper.launches == before + 1
    return out


def _sort_keys(rng, shape, mix):
    """The key mixes of the K2 checks."""
    if mix == "all_equal":                # stability: vals stay in order
        return np.full(shape, 7.0, np.float32)
    if mix == "signed_zeros":
        return rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), shape)
    if mix == "inf_heavy":
        k = rng.uniform(-100, 100, shape).astype(np.float32)
        k[rng.random(shape) < 0.7] = np.inf
        return k
    if mix == "negative_duplicates":
        return -rng.integers(0, 50, shape).astype(np.float32)
    return _mixed_keys(rng, shape)


#: one-CTA rows end at 4096 keys (csrc/bitonic.cu kRowTile)
_SORT_SHAPES = [(3, 1), (3, 31), (3, 32), (4, 1000), (2, 4095), (2, 4096),
                (2, 4097), (3, 16384), (2, 40000), (1, 65536), (1, 65537),
                (1, 100000), (1024, 1024), (8, 512), (8, 4096), (1, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("mix", ["mixed", "all_equal", "signed_zeros",
                                 "inf_heavy", "negative_duplicates"])
@pytest.mark.parametrize("rows,n", _SORT_SHAPES)
def test_bitonic_kernel_matches_plain_version(rows, n, mix):
    _need_gpu()
    rng = np.random.default_rng(n)
    keys = _sort_keys(rng, (rows, n), mix)
    vals = rng.integers(-(1 << 30), 1 << 30, (rows, n)).astype(np.int32)
    flags = rng.integers(0, 2, (rows, n)).astype(np.int32)
    args = [torch.from_numpy(x).cuda() for x in (keys, vals, flags)]
    got = _launched_once(bitonic.bitonic_sort_kvf, *args)
    want = bitonic.bitonic_sort_kvf_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w), (rows, n, mix)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,m", [(1, 5000, 3001), (8, 1026, 512),
                                      (1, 131072, 1024)])
def test_merge_kernel_matches_plain_version(rows, n, m):
    _need_gpu()
    rng = np.random.default_rng(n + m)
    ak = np.sort(_mixed_keys(rng, (rows, n)), -1)
    bk = np.sort(_mixed_keys(rng, (rows, m)), -1)
    av = rng.integers(-(1 << 30), 1 << 30, (rows, n)).astype(np.int32)
    bv = rng.integers(-(1 << 30), 1 << 30, (rows, m)).astype(np.int32)
    af = np.zeros((rows, n), np.int32)
    bf = np.ones((rows, m), np.int32)
    args = [torch.from_numpy(x).cuda() for x in (ak, av, af, bk, bv, bf)]
    got = _launched_once(merge_consume.merge_sorted_kvf, *args)
    want = merge_consume.merge_sorted_kvf_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w), (rows, n, m)


@pytest.mark.gpu
@pytest.mark.parametrize("length", [4096, 1 << 20])
def test_radix_select_kernel_matches_plain_version(length):
    _need_gpu()
    rng = np.random.default_rng(length)
    keys = _mixed_keys(rng, (6, length))
    keys[3] = np.inf                      # all INF
    keys[4] = -np.abs(keys[4])            # negative keys
    n_fin = int(np.isfinite(keys[0]).sum())
    k = np.array([0, 1, length // 3, n_fin + 1, length, length + 5],
                 np.int32)
    args = [torch.from_numpy(x).cuda() for x in (keys, k)]
    got = _launched_once(radix_select.radix_select_threshold, *args)
    want = radix_select.radix_select_threshold_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w), length


def _device_kernels(fn, calls, markers=4):
    """The names of the device events (kernels, copies, fills) that
    ``calls`` calls of ``fn`` put on the card, under the profiler.  The
    profiler can lose a window's first records, so ``markers`` device
    sleeps go first and are left out; a window still short is profiled
    again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(markers):
                torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and not ("spin" in ev.name or "sleep" in ev.name)]
        if len(names) >= calls:
            return names
    return names


def _merge_keys(rng, rows, n, m, mix):
    """Both streams' keys under a K2 key mix, each sorted again after it;
    "zeros": -0.0 in a against 0.0 in b."""
    if mix == "zeros":
        ak = rng.choice(np.array([-0.0, 1.0, -1.0], np.float32), (rows, n))
        bk = rng.choice(np.array([0.0, 1.0, -1.0], np.float32), (rows, m))
    else:
        ak = _sort_keys(rng, (rows, n), mix)
        bk = _sort_keys(rng, (rows, m), mix)
    return np.sort(ak, -1), np.sort(bk, -1)


def _merge_args(rng, ak, bk, offset=0):
    """(ak, av, af, bk, bv, bf) on the card; with ``offset`` each input
    starts ``offset`` words into its buffer (not 16-byte aligned)."""
    rows, n = ak.shape
    m = bk.shape[1]
    av = rng.integers(-(1 << 30), 1 << 30, (rows, n)).astype(np.int32)
    bv = rng.integers(-(1 << 30), 1 << 30, (rows, m)).astype(np.int32)
    af = rng.integers(0, 2, (rows, n)).astype(np.int32)
    bf = rng.integers(0, 2, (rows, m)).astype(np.int32)

    def card(x):
        buf = torch.zeros(x.size + offset, dtype=torch.from_numpy(x).dtype,
                          device="cuda")
        buf[offset:] = torch.from_numpy(x.reshape(-1)).cuda()
        return buf[offset:].view(x.shape)
    return [card(x) for x in (ak, av, af, bk, bv, bf)]


#: K1 shapes: the phase-6 merges, empty streams, one tile and tiles that
#: end inside a row, and rows x tiles past 65535
_MERGE_SHAPES = [(1, 131072, 1024), (1, 16384, 4096), (8, 1026, 512),
                 (1, 1048576, 1024), (1, 0, 700), (3, 900, 0),
                 (5, 700, 333), (70000, 3, 2), (1, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("mix", ["mixed", "all_equal", "zeros", "inf_heavy",
                                 "negative_duplicates"])
@pytest.mark.parametrize("rows,n,m", _MERGE_SHAPES)
def test_merge_kernel_at_key_mixes(rows, n, m, mix):
    """K1 bit-equal to its plain version at every key mix of the K2
    checks, one wrapper launch a call."""
    _need_gpu()
    rng = np.random.default_rng(rows + n + 7 * m)
    args = _merge_args(rng, *_merge_keys(rng, rows, n, m, mix))
    got = _launched_once(merge_consume.merge_sorted_kvf, *args)
    if n and m:
        want = merge_consume.merge_sorted_kvf_plain(*args)
    else:      # the plain version gathers from both: an empty one is a copy
        want = [torch.cat([a, b], -1) for a, b in zip(args[:3], args[3:])]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w), (rows, n, m, mix)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,m", [(1, 5001, 3003), (3, 1026, 511)])
def test_merge_kernel_on_unaligned_inputs(rows, n, m):
    """Inputs that start off a 16-byte boundary take the kernel's 4-byte
    copies; still bit-equal."""
    _need_gpu()
    rng = np.random.default_rng(n)
    args = _merge_args(rng, *_merge_keys(rng, rows, n, m, "mixed"),
                       offset=1)
    got = _launched_once(merge_consume.merge_sorted_kvf, *args)
    want = merge_consume.merge_sorted_kvf_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w), (rows, n, m)


@pytest.mark.gpu
def test_merge_kernel_is_one_device_kernel():
    _need_gpu()
    rng = np.random.default_rng(3)
    args = _merge_args(rng, *_merge_keys(rng, 1, 131072, 1024, "mixed"))
    names = _device_kernels(lambda: merge_consume.merge_sorted_kvf(*args), 5)
    assert len(names) == 5 and all("merge_kernel" in x for x in names), \
        names


def _select_keys(rng, rows, length):
    """Mixed keys, with an all-INF row, a negative row, a row of both
    zeros and a row of few finite keys among the first five."""
    keys = _mixed_keys(rng, (rows, length))
    if rows > 1:
        keys[1] = np.inf
    if rows > 2:
        keys[2] = -np.abs(keys[2])
    if rows > 3:
        keys[3] = rng.choice(np.array([0.0, -0.0], np.float32), length)
    if rows > 4:
        keys[4, length // 10:] = np.inf
    return keys


def _select_ks(rng, keys):
    """One k a row: 0, 1, the middle, the finite count, one past it, the
    length and past it, then random."""
    rows, length = keys.shape
    n_fin = np.isfinite(keys).sum(-1)
    k = rng.integers(0, length + 2, rows).astype(np.int32)
    edges = [0, 1, length // 2, None, None, length, length + 5]
    for r, e in enumerate(edges[:rows]):
        k[r] = (n_fin[r] if r == 3 else n_fin[r] + 1 if r == 4 else e)
    return k


#: K4 shapes: the row kernel ([1024, 1024] bucket rows, [8, 1024], the
#: w4096 store [1, 8192], the longest rows it takes alone and beside as
#: many rows as SMs) and the grid kernel (a row just past those, the
#: PRODUCTION store, six such rows, and a row past the card's shared
#: memory in total)
_SELECT_SHAPES = [(1024, 1024), (8, 1024), (1, 8192), (1, 16384),
                  (140, 40000), (1, 16385), (1, 1 << 20), (6, 1 << 20),
                  (1, 9 << 20)]


def _select_plan(rows, length):
    lim = radix_select.device_limits("cuda")
    return radix_select.launch_plan(rows, length, lim.sms, lim.smem_bytes,
                                    lim.blocks_per_sm)


_ROW_SHAPES = _SELECT_SHAPES[:5]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length", _SELECT_SHAPES)
def test_radix_select_kernel_in_both_regimes(rows, length):
    """K4 bit-equal to its plain version at every shape and edge k, one
    launch a call."""
    _need_gpu()
    rng = np.random.default_rng(rows + length)
    keys = _select_keys(rng, rows, length)
    k = _select_ks(rng, keys)
    args = [torch.from_numpy(x).cuda() for x in (keys, k)]
    got = _launched_once(radix_select.radix_select_threshold, *args)
    want = radix_select.radix_select_threshold_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w), (rows, length)
    plan = _select_plan(rows, length)
    assert plan.kernel == ("row" if (rows, length) in _ROW_SHAPES else "grid")
    assert plan.staged == (length < 9 << 20)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,length", [(1024, 1024), (1, 1 << 20)])
def test_radix_select_is_one_device_kernel(rows, length):
    """One K4 call is one kernel on the card: no memset, the grid
    kernel's workspace left zero for the next call."""
    _need_gpu()
    rng = np.random.default_rng(length)
    keys = torch.from_numpy(_mixed_keys(rng, (rows, length))).cuda()
    k = torch.full((rows,), length // 3, dtype=torch.int32, device="cuda")
    names = _device_kernels(
        lambda: radix_select.radix_select_threshold(keys, k), 5)
    kernel = f"{_select_plan(rows, length).kernel}_kernel"
    assert len(names) == 5 and all(kernel in x for x in names), names
    got = radix_select.radix_select_threshold(keys, k)
    want = radix_select.radix_select_threshold_plain(keys, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    for ws in radix_select._WORKSPACE.values():
        assert not ws.any()
    lib = build.load("radix_select")   # the plan's count of the workspace
    assert lib.radix_select_ws_ints() == radix_select.WS_INTS


@pytest.mark.gpu
def test_kernel_compositions_match_the_cpu():
    """select_k_smallest and extract_k_bucketed under the "cuda" backend:
    on the card through K4 and K2, bit-equal to the same compositions on
    the CPU through the kernels' plain versions."""
    _need_gpu()
    cuda = ops.resolve_backend("cuda")
    rng = np.random.default_rng(17)
    lanes, nb, bc, k_max = 3, 64, 128, 1000
    keys = np.sort(rng.uniform(0, 1000, (lanes, nb * bc)).astype(
        np.float32), -1).reshape(lanes, nb, bc)
    vals = rng.integers(0, 1 << 30, (lanes, nb, bc)).astype(np.int32)
    counts = rng.integers(0, bc + 1, (lanes, nb)).astype(np.int32)
    splitters = keys[:, :, 0].copy()
    k = np.array([1, 700, 5000], np.int32)
    host = [torch.from_numpy(x) for x in (keys, vals, counts, k, splitters)]
    dev = [x.cuda() for x in host]
    for args in (host, dev):
        args.append(ops.extract_k_bucketed(*args[:4], k_max,
                                           splitters=args[4], backend=cuda))
        args.append(ops.select_k_smallest(args[0].reshape(lanes, -1),
                                          args[1].reshape(lanes, -1),
                                          args[3], k_max, backend=cuda))
    torch.cuda.synchronize()
    for g, w in zip(dev[5] + dev[6], host[5] + host[6]):
        assert _same_bits(g.cpu(), w)


def _mixed_batches(rng, ticks):
    """Ticks with adds and removes both; some keys fall below the union
    minimum, so the pre-route pass pairs them."""
    ak = np.full((ticks, W), np.inf, np.float32)
    av = np.full((ticks, W), -1, np.int32)
    mask = np.zeros((ticks, W), bool)
    rm = rng.integers(8, W + 1, ticks).astype(np.int32)
    for t in range(ticks):
        n = int(rng.integers(8, W + 1))
        ak[t, :n] = np.round(rng.uniform(-200, 1000, n), 3)
        av[t, :n] = np.arange(n)
        mask[t, :n] = True
    return [torch.from_numpy(x).cuda() for x in (ak, av, mask, rm)]


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [2, 4])
def test_sharded_engine_matches_torch_twin(lanes):
    _need_gpu()
    spec = dict(engine="sharded", width=W, lanes=lanes)
    base = {f: getattr(CFG, f) for f in CFG.__dataclass_fields__
            if f != "backend"}
    eng_c = make_engine(EngineSpec(base=PQConfig(backend="cuda", **base),
                                   **spec))
    eng_t = make_engine(EngineSpec(base=PQConfig(backend="torch", **base),
                                   **spec))
    s_c, s_t = eng_c.init(seed=9), eng_t.init(seed=9)
    rows = [torch.cat(xs) for xs in zip(
        _repair_batches(np.random.default_rng(51), 48),
        _mixed_batches(np.random.default_rng(52), 24))]
    k3 = lane_tick.fused_tick_mid.launches
    k2 = bitonic.bitonic_sort_kvf.launches
    for t in range(rows[0].shape[0]):
        # a tick with lane work moves the lanes' add, remove or chopHead
        # counters; one without only counts a quiet tick
        before = sharded.lane_work_marks(s_c)
        s_c, r_c = eng_c.tick(s_c, *(x[t] for x in rows))
        work = int(sharded.lane_work_marks(s_c) > before)
        s_t, r_t = eng_t.tick(s_t, *(x[t] for x in rows))
        for i, (g, w) in enumerate(zip(pqueue.tree_leaves((s_c, r_c)),
                                       pqueue.tree_leaves((s_t, r_t)))):
            assert _same_bits(g, w), f"tick {t} leaf {i}"
        k3, k2 = k3 + work, k2 + work
        assert lane_tick.fused_tick_mid.launches == k3, t
        assert bitonic.bitonic_sort_kvf.launches == k2, t
    st = s_c.lanes.stats
    for name in ("add_par", "n_rebalance", "n_movehead", "n_chophead"):
        assert int(getattr(st, name).sum()) > 0, name
    assert int(s_c.n_preroute_elim) > 0


@pytest.mark.gpu
def test_adaptive_engine_matches_torch_twin():
    """The adaptive engine over a stream that switches sharded -> pqe ->
    sharded at the repair-forcing geometry: bit-equal to its "torch" twin
    on every tick, the plan and controller state too; K3 and K2 launch,
    K1 and K4 never (the launch counts against the plan trace are held
    at w4096 by chip_smoke.py)."""
    _need_gpu()
    base = {f: getattr(CFG, f) for f in CFG.__dataclass_fields__
            if f != "backend"}
    spec = dict(engine="adaptive", width=W, lanes=4)
    eng_c = make_engine(EngineSpec(base=PQConfig(backend="cuda", **base),
                                   **spec))
    eng_t = make_engine(EngineSpec(base=PQConfig(backend="torch", **base),
                                   **spec))
    s_c, s_t = eng_c.init(seed=0), eng_t.init(seed=0)
    rng = np.random.default_rng(71)
    launches = [w.launches for w in (
        lane_tick.fused_tick_mid, bitonic.bitonic_sort_kvf,
        merge_consume.merge_sorted_kvf, radix_select.radix_select_threshold)]
    kinds = set()
    for t in range(96):
        n = 64 if t == 0 else (32 if t < 48 else 0)
        keys = np.full(W, np.inf, np.float32)
        keys[:n] = rng.uniform(0, 1000, n)
        batch = [torch.as_tensor(x).cuda() for x in (
            keys, np.arange(W, dtype=np.int32), np.arange(W) < n,
            np.int32(0 if t == 0 else (32 if t < 48 else 16)))]
        s_c, r_c = eng_c.tick(s_c, *batch)
        s_t, r_t = eng_t.tick(s_t, *batch)
        assert (s_c.kind, s_c.lanes, s_c.preroute, s_c.ctl) == \
            (s_t.kind, s_t.lanes, s_t.preroute, s_t.ctl), t
        for i, (g, w) in enumerate(zip(pqueue.tree_leaves((s_c.inner, r_c)),
                                       pqueue.tree_leaves((s_t.inner, r_t)))):
            assert _same_bits(g, w), f"tick {t} leaf {i}"
        kinds.add(s_c.kind)
    assert kinds == {"pqe", "sharded"} and s_c.ctl.n_switches == 2
    k3, k2, k1, k4 = (w.launches - n for w, n in zip(
        (lane_tick.fused_tick_mid, bitonic.bitonic_sort_kvf,
         merge_consume.merge_sorted_kvf, radix_select.radix_select_threshold),
        launches))
    assert k3 > 0 and k2 > 0 and k1 == 0 and k4 == 0, (k3, k2, k1, k4)


@pytest.mark.gpu
def test_sampler_cuda_equals_torch_twin_on_card():
    _need_gpu()
    twin_cfg = dataclasses.replace(DEFAULT_CFG, backend="torch")
    before = lane_tick.fused_tick_mid.launches
    samplers = [PrioritySampler(n_groups=64, ema=0.5, staleness_weight=0.0,
                                cfg=cfg, device="cuda")
                for cfg in (DEFAULT_CFG, twin_cfg)]
    rng = np.random.default_rng(5)
    for step in range(40):
        picked = [s.next_groups(16) for s in samplers]
        assert picked[0] == picked[1], step
        # half the groups' EMA drops to exactly 0.0: their key is -0.0
        losses = [-samplers[0].groups[g].ema_loss if rng.random() < 0.5
                  else float(rng.exponential(2.0)) for g in picked[0]]
        for s in samplers:
            for g, loss in zip(picked[0], losses):
                s.report(g, loss)
            s.requeue(picked[0])
    assert samplers[0].breakdown() == samplers[1].breakdown()
    assert lane_tick.fused_tick_mid.launches - before == 1 + 2 * 40


@pytest.mark.gpu
def test_roofline_reads_the_card_memory():
    _need_gpu()
    assert hw.hbm_bytes() == torch.cuda.get_device_properties(0).total_memory
    assert hw.hbm_bytes() > 16 * 2 ** 30


@pytest.mark.gpu
def test_lane_tick_time_is_not_under_its_traffic_bound():
    _need_gpu()
    eng = make_engine(EngineSpec(engine="pqe", width=1024, base=PRODUCTION))
    cfg, state = eng.cfg, eng.init(seed=0)
    keys = torch.rand(1024, device="cuda") * 1000
    vals = torch.arange(1024, dtype=torch.int32, device="cuda")
    mask = torch.ones(1024, dtype=torch.bool, device="cuda")
    state, _ = eng.tick(state, keys, vals, mask, 0)
    lanes = pqueue.tree_map(lambda x: x[None].contiguous(), state)
    batch = (keys[None], vals[None], mask[None],
             torch.full((1,), 512, dtype=torch.int32, device="cuda"))
    lane_tick.fused_tick_mid(cfg, lanes, *batch)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        lane_tick.fused_tick_mid(cfg, lanes, *batch)
    end.record()
    torch.cuda.synchronize()
    assert start.elapsed_time(end) / 20 / 1e3 >= traffic.k3_launch(
        cfg, 1).bound_s()
