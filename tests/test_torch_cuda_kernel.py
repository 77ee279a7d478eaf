"""The hand-written lane-tick CUDA kernel against its plain version.

Runs only where there is a CUDA GPU (the kernel has no CPU mode) and
imports nothing of JAX, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernel.py

At the repair-forcing geometry (every pass fires), at L=1 and L=3, every
output of the kernel must equal its plain version's bit for bit, and
each wrapper call counts one launch.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import PQConfig, pqueue
from repro_torch.kernels import lane_tick

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
