"""The hand-written CUDA kernels against their plain versions.

Runs only where there is a CUDA GPU (the kernels have no CPU mode) and
imports nothing of JAX, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernel.py

K3, the lane tick, at the repair-forcing geometry (every pass fires), at
L=1 and L=3; K1, K2 and K4 on ties, INF padding, -0.0 and rows past one
CTA's shared memory; and the kernel ops' "cuda" compositions on the card
against the same compositions on the CPU.  Every output must equal its
plain version's bit for bit, and each wrapper call counts one launch.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import PQConfig, pqueue
from repro_torch.kernels import bitonic, lane_tick, merge_consume
from repro_torch.kernels import ops, radix_select

W = 64
CFG = PQConfig(a_max=W, r_max=W, seq_cap=512, n_buckets=4, bucket_cap=8,
               detach_min=4, detach_max=64, detach_init=8, chop_patience=3,
               backend="torch")


def _repair_batches(rng, ticks):
    """Adds pile up (scatter, rebalance), a big or tiny drain (moveHead),
    then quiet ticks (chopHead); [T, W] keys/vals/mask and [T] removes."""
    ak = np.full((ticks, W), np.inf, np.float32)
    av = np.full((ticks, W), -1, np.int32)
    mask = np.zeros((ticks, W), bool)
    rm = np.zeros(ticks, np.int32)
    for t in range(ticks):
        cycle, phase = t // 12, t % 12
        if phase < 4:
            n = int(rng.integers(W // 2, W + 1))
            ak[t, :n] = np.round(rng.uniform(0, 1000, n), 3)
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
@pytest.mark.parametrize("lanes", [1, 3])
def test_cuda_kernel_matches_plain_version(lanes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the lane-tick kernel has no CPU mode")
    streams = [_repair_batches(np.random.default_rng(31 + i), 26)
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
        before = lane_tick.fused_tick_mid.launches
        got = lane_tick.fused_tick_mid(CFG, lanes_state, *batch)
        assert lane_tick.fused_tick_mid.launches == before + 1
        want = lane_tick.fused_tick_mid_plain(CFG, lanes_state, *batch)
        for i, (g, w) in enumerate(zip(pqueue.tree_leaves(got),
                                       pqueue.tree_leaves(want))):
            assert _same_bits(g, w), f"L={lanes} tick {t} leaf {i}"
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


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(4, 1000), (3, 16384), (2, 40000)])
def test_bitonic_kernel_matches_plain_version(rows, n):
    _need_gpu()
    rng = np.random.default_rng(n)
    keys = _mixed_keys(rng, (rows, n))
    vals = rng.integers(-(1 << 30), 1 << 30, (rows, n)).astype(np.int32)
    flags = rng.integers(0, 2, (rows, n)).astype(np.int32)
    args = [torch.from_numpy(x).cuda() for x in (keys, vals, flags)]
    got = _launched_once(bitonic.bitonic_sort_kvf, *args)
    want = bitonic.bitonic_sort_kvf_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w), (rows, n)


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
