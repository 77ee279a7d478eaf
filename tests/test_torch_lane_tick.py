"""The port's lane-tick wrapper against the JAX package's megakernel.

On the CPU the wrapper runs its plain version (the ported pass chain over
[L, ...] lanes); it must reproduce, bit for bit, what
``repro.kernels.lane_tick.fused_tick_mid`` returns under
``pallas_interpret`` — including the fused output form (small_*/large_*
alias pend_*, stats0 is the input stats).  The CUDA kernel itself is
held against that plain version on the card by
tests/test_torch_cuda_kernel.py.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import pqueue as jpq
from repro.kernels import lane_tick as jlt
from repro.kernels import ops as jops
from repro_torch.core import PQConfig as TorchConfig
from repro_torch.core import pqueue as tpq
from repro_torch.kernels import lane_tick as tlt
from test_lane_megakernel import BASE, W, _batch, _repair_stream

JNP = jops.resolve_backend("jnp")
INTERP = jops.resolve_backend("pallas_interpret")
TICKS = 26   # two repair cycles: both drain sizes, chop, rebalance


def _dup_stream(rng, ticks):
    """``_repair_stream``'s phases with keys from a pool of a few values
    (both zeros among them), so adds tie with the sequential part, with
    the parallel part and with each other."""
    pool = np.array([0.0, -0.0, 1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0, 34.0],
                    np.float32)
    next_val = 0
    for t in range(ticks):
        cycle, phase = t // 12, t % 12
        n_add, n_rm = 0, 0
        if phase < 4:
            n_add = int(rng.integers(W // 2, W + 1))
        elif phase == 4:
            n_rm = W if cycle % 2 else int(rng.integers(1, 5))
        keys = rng.choice(pool, n_add)
        vals = np.arange(next_val, next_val + n_add, dtype=np.int32)
        next_val += n_add
        yield _batch(keys, vals, W) + (jnp.asarray(n_rm, jnp.int32),)


STREAMS = {"repair": _repair_stream, "duplicates": _dup_stream}


def _port_cfg(cfg, backend):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "backend"}
    return TorchConfig(backend=backend, **kw)


def _port_lanes(j_states):
    """[L, ...]-stacked port PQState from reference states (numpy copies)."""
    leaves = [[torch.from_numpy(np.array(x)) for x in jax.tree.leaves(s)]
              for s in j_states]
    stacked = [torch.stack(xs) for xs in zip(*leaves)]
    n = len(tpq.PQState._fields) - 1
    return tpq.PQState(*stacked[:n], stats=tpq.PQStats(*stacked[n:]))


def _assert_mid_equal(got, want, what):
    got_leaves = tpq.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        if g.dtype == np.float32:      # bits: -0.0 differs from 0.0
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} [{i}]")


@pytest.mark.parametrize("lanes,stream", [
    pytest.param(1, "repair", id="1"), pytest.param(3, "repair", id="3"),
    pytest.param(1, "duplicates", id="1-duplicates"),
    pytest.param(3, "duplicates", id="3-duplicates")])
def test_plain_fused_tick_mid_matches_reference(lanes, stream):
    cfg_j = dataclasses.replace(BASE, backend=JNP)
    cfg_i = dataclasses.replace(BASE, backend=INTERP)
    cfg_t = _port_cfg(BASE, "cuda")
    ref_fused = jax.jit(functools.partial(jlt.fused_tick_mid, cfg_i))
    streams = [list(STREAMS[stream](np.random.default_rng(21 + i), TICKS))
               for i in range(lanes)]
    states = [jpq.init(cfg_j) for _ in range(lanes)]
    fired = np.zeros(5, np.int64)
    launches = tlt.fused_tick_mid.launches
    for t in range(TICKS):
        batches = [s[t] for s in streams]
        lk, lv, lm, grants = (jnp.stack(xs) for xs in zip(*batches))
        want = ref_fused(jax.tree.map(lambda *xs: jnp.stack(xs), *states),
                         lk, lv, lm, grants)
        got = tlt.fused_tick_mid(
            cfg_t, _port_lanes(states),
            *(torch.from_numpy(np.array(x)) for x in (lk, lv, lm, grants)))
        _assert_mid_equal(got, want, f"{stream} L={lanes} tick {t}")
        p = got.pending
        fired += [int(x.any()) for x in (p.need_combine, p.need_scatter,
                                         p.need_rebal, p.need_move,
                                         p.need_chop)]
        states = [jpq.tick(cfg_j, s, *b)[0]
                  for s, b in zip(states, batches)]
    assert (fired > 0).all(), fired.tolist()
    # CPU tensors take the plain version: no kernel launched
    assert tlt.fused_tick_mid.launches == launches


def test_wrapper_rejects_other_devices():
    cfg = _port_cfg(BASE, "cuda")
    lanes = tpq.tree_map(lambda x: x[None].to("meta"), tpq.init(cfg, "cpu"))
    batch = [torch.zeros((1, cfg.a_max), device="meta"),
             torch.zeros((1, cfg.a_max), dtype=torch.int32, device="meta"),
             torch.zeros((1, cfg.a_max), dtype=torch.bool, device="meta"),
             torch.zeros((1,), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tlt.fused_tick_mid(cfg, lanes, *batch)


@pytest.mark.parametrize("lanes", [1, 3])
def test_adds_sorted_skips_presort_with_same_bits(lanes):
    """On a batch that is already stably key-sorted with a prefix mask
    (what the sharded router hands over), ``adds_sorted=True`` skips the
    presort and gives the same bits as presorting it again."""
    cfg = _port_cfg(BASE, "cuda")
    streams = [list(_dup_stream(np.random.default_rng(41 + i), TICKS))
               for i in range(lanes)]
    states = [tpq.init(cfg, "cpu") for _ in range(lanes)]
    for t in range(TICKS):
        lk, lv, lm, grants = (torch.from_numpy(np.array(jnp.stack(xs)))
                              for xs in zip(*(s[t] for s in streams)))
        sk, sv, sm = tlt._presort(lk, lv, lm)
        stacked = [torch.stack(xs) for xs in zip(*map(tpq.tree_leaves,
                                                      states))]
        n = len(tpq.PQState._fields) - 1
        lanes_in = tpq.PQState(*stacked[:n], stats=tpq.PQStats(*stacked[n:]))
        a = tlt.fused_tick_mid(cfg, lanes_in, sk, sv, sm, grants)
        b = tlt.fused_tick_mid(cfg, lanes_in, sk, sv, sm, grants,
                               adds_sorted=True)
        for i, (x, y) in enumerate(zip(tpq.tree_leaves(a),
                                       tpq.tree_leaves(b))):
            assert x.dtype == y.dtype
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            assert torch.equal(x, y), (t, i)
        states = [tpq.tick(cfg, s, sk[i], sv[i], sm[i], grants[i])[0]
                  for i, s in enumerate(states)]
