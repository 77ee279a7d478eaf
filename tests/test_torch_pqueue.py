"""The port's pqe tick against the JAX package and the heapq oracle.

* Tick-by-tick bit equality of every state leaf and every result with
  ``repro.core.pqueue.tick`` (jnp backend), over the stream that fires all
  five passes — for the port's plain backend and for its kernel backend's
  path (on the CPU the kernel wrapper runs its plain version, so this pins
  the fused pipeline and the repairs outside it).
* The heapq-oracle runs of tests/test_pq_properties.py on the port.
* ``tick_n``, ``add_batch``, ``remove_batch`` and ``resident``.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import pqueue as jpq
from repro.core.adaptive import update_detach as j_update_detach
from repro.kernels import ops as jops
from repro_torch.core import EMPTY_VAL, SMALL, PQConfig, RefPQ, pqueue
from repro_torch.core.adaptive import update_detach
from repro_torch.core.interop import state_to_numpy
from test_lane_megakernel import BASE, _repair_stream

JNP = jops.resolve_backend("jnp")
CFG = PQConfig(a_max=32, r_max=32, seq_cap=256, n_buckets=8, bucket_cap=32,
               detach_min=4, detach_max=64, detach_init=8, chop_patience=8,
               backend="torch")
TINY = PQConfig(a_max=16, r_max=16, seq_cap=64, n_buckets=4, bucket_cap=16,
                detach_min=2, detach_max=32, detach_init=4, chop_patience=4,
                backend="torch")


def _port_cfg(cfg, backend):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "backend"}
    return PQConfig(backend=backend, **kw)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tick_bit_equal_to_reference_across_repairs(backend):
    cfg_j = dataclasses.replace(BASE, backend=JNP)
    cfg_t = _port_cfg(BASE, backend)
    s_j = jpq.init(cfg_j)
    s_t = pqueue.init(cfg_t, "cpu")
    fired = np.zeros(5, np.int64)
    for t, (ak, av, mask, rm) in enumerate(
            _repair_stream(np.random.default_rng(13), 40)):
        s_t, r_t = pqueue.tick(cfg_t, s_t, np.asarray(ak), np.asarray(av),
                               np.asarray(mask), int(rm))
        s_j, r_j = jpq.tick(cfg_j, s_j, ak, av, mask, rm)
        for i, (g, w) in enumerate(zip(state_to_numpy(s_t),
                                       jax.tree.leaves(s_j))):
            w = np.asarray(w)
            assert g.dtype == w.dtype, (t, i)
            np.testing.assert_array_equal(g, w, err_msg=f"tick {t} leaf {i}")
        for i, (g, w) in enumerate(zip(r_t, jax.tree.leaves(r_j))):
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, (t, i)
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"tick {t} result {i}")
        fired += r_t.repairs.numpy()
    assert (fired > 0).all(), fired.tolist()


def _batch(cfg, keys, next_val):
    ak = np.full((cfg.a_max,), np.inf, np.float32)
    av = np.full((cfg.a_max,), EMPTY_VAL, np.int32)
    mask = np.zeros((cfg.a_max,), bool)
    ak[:len(keys)] = keys
    av[:len(keys)] = np.arange(next_val, next_val + len(keys))
    mask[:len(keys)] = True
    return ak, av, mask


def drive(cfg, ops):
    """ops: list of (keys list, rm_count). Asserts oracle agreement."""
    state = pqueue.init(cfg, "cpu")
    ref = RefPQ()
    next_val = 0
    for keys, n_rm in ops:
        keys = keys[:max(0, min(len(keys), cfg.par_cap - len(ref),
                                cfg.a_max))]
        state, res = pqueue.tick(cfg, state, *_batch(cfg, keys, next_val),
                                 n_rm)
        next_val += len(keys)
        got = np.sort(res.rm_keys[res.rm_served].numpy())
        exp = np.sort(np.array(
            [k for k, _ in ref.tick(keys, range(len(keys)), n_rm)
             if k != np.inf], np.float32))
        np.testing.assert_array_equal(got, exp)
        assert int(pqueue.size(state)) == len(ref)
    return state


key_lists = st.lists(
    st.floats(min_value=0.0, max_value=1e4, allow_nan=False, width=32),
    min_size=0, max_size=16)
op_seqs = st.lists(st.tuples(key_lists, st.integers(0, 16)), min_size=1,
                   max_size=25)


@given(op_seqs)
@settings(max_examples=10)
def test_pqe_matches_oracle(ops):
    drive(TINY, ops)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pqe_random_mixes(seed):
    rng = np.random.default_rng(seed)
    ops = [(rng.uniform(0, 1000, rng.integers(0, CFG.a_max + 1)).tolist(),
            int(rng.integers(0, CFG.r_max + 1)))
           for _ in range(30)]
    drive(CFG, ops)


def test_duplicate_keys_conserved():
    ops = [([5.0] * 16, 0), ([5.0] * 8 + [1.0] * 4, 10), ([], 16), ([], 16)]
    drive(TINY, ops)


def test_movehead_serves_same_tick_parallel_adds():
    ops = [([0.0, 1.0, 2.0, 3.0], 0), ([], 1), ([100.0], 4), ([], 4)]
    drive(TINY, ops)


def test_empty_removes_return_sentinel():
    state = pqueue.init(TINY, "cpu")
    state, res = pqueue.remove_batch(TINY, state, 5)
    assert int(res.rm_served.sum()) == 0
    assert int(state.stats.rm_empty) == 5


def test_detach_adapts_in_state():
    """moveHead events move detach_n within the paper's bounds."""
    state = pqueue.init(TINY, "cpu")
    rng = np.random.default_rng(3)
    seen, ref_len = set(), 0
    for _ in range(50):
        n_add = min(int(rng.integers(0, TINY.a_max + 1)),
                    TINY.par_cap - ref_len)
        keys = rng.uniform(0, 100, n_add).astype(np.float32)
        state, res = pqueue.tick(TINY, state, *_batch(TINY, keys, 0),
                                 int(rng.integers(0, TINY.r_max + 1)))
        ref_len += n_add - int(res.rm_served.sum())
        seen.add(int(state.detach_n))
        assert TINY.detach_min <= int(state.detach_n) <= TINY.detach_max
    assert len(seen) > 1, "detach size never adapted"


def test_elimination_stats_balanced_mix():
    """Balanced 50/50 mixes eliminate most adds (paper Figs. 7–8)."""
    state = pqueue.init(CFG, "cpu")
    rng = np.random.default_rng(0)
    for _ in range(4):
        keys = rng.uniform(0, 1000, CFG.a_max).astype(np.float32)
        state, _ = pqueue.tick(CFG, state, *_batch(CFG, keys, 0), 0)
    base = state.stats
    n = CFG.a_max // 2
    for _ in range(50):
        keys = rng.uniform(0, 1000, n).astype(np.float32)
        state, _ = pqueue.tick(CFG, state, *_batch(CFG, keys, 0), n)
    s = state.stats
    eliminated = int(s.add_imm_elim - base.add_imm_elim
                     + s.add_upc_elim - base.add_upc_elim)
    assert eliminated / (50 * n) > 0.5


def test_chophead_fires_on_quiet_stream():
    state = pqueue.init(TINY, "cpu")
    state = pqueue.add_batch(TINY, state, np.arange(16, dtype=np.float32))
    state = pqueue.add_batch(TINY, state, np.arange(16, 32, dtype=np.float32))
    state, _ = pqueue.remove_batch(TINY, state, 2)
    assert int(state.seq_len) > 0
    for _ in range(TINY.chop_patience + 1):
        state = pqueue.add_batch(TINY, state, np.array([], np.float32))
    assert int(state.stats.n_chophead) >= 1
    assert int(state.seq_len) == 0
    state, res = pqueue.remove_batch(TINY, state, 16)
    np.testing.assert_array_equal(np.sort(res.rm_keys[res.rm_served].numpy()),
                                  np.arange(2, 18, dtype=np.float32))


def test_capacity_drop_accounting():
    """Past capacity the queue drops the largest keys and counts them,
    exactly as the reference does."""
    state = pqueue.init(TINY, "cpu")
    total = TINY.par_cap + 10
    keys = np.arange(total, dtype=np.float32)
    for i in range(0, total, TINY.a_max):
        state = pqueue.add_batch(TINY, state, keys[i:i + TINY.a_max])
    assert int(state.stats.n_dropped) == 10
    assert int(pqueue.size(state)) == TINY.par_cap
    state, res = pqueue.remove_batch(TINY, state, 16)
    np.testing.assert_array_equal(np.sort(res.rm_keys[res.rm_served].numpy()),
                                  keys[:16])


@pytest.mark.parametrize("d,ins", [(8, 0), (8, 1001), (64, 0), (4, 10 ** 6),
                                   (16, 500)])
def test_update_detach_matches_reference(d, ins):
    want = int(j_update_detach(CFG, jax.numpy.asarray(d),
                               jax.numpy.asarray(ins)))
    assert int(update_detach(CFG, torch.tensor(d), torch.tensor(ins))) == want


def test_tick_n_equals_loop_of_tick():
    cfg = _port_cfg(BASE, "torch")
    stream = [tuple(np.asarray(x) for x in b)
              for b in _repair_stream(np.random.default_rng(17), 14)]
    stacked = [np.stack(xs) for xs in zip(*stream)]
    s_n, r_n = pqueue.tick_n(cfg, pqueue.init(cfg, "cpu"), *stacked)
    state = pqueue.init(cfg, "cpu")
    results = []
    for b in stream:
        state, res = pqueue.tick(cfg, state, *b)
        results.append(res)
    for g, w in zip(pqueue.tree_leaves(s_n), pqueue.tree_leaves(state)):
        assert torch.equal(g, w)
    for t, res in enumerate(results):
        for g, w in zip(r_n, res):
            assert torch.equal(g[t], w)


def test_add_remove_batch_and_resident():
    cfg = dataclasses.replace(SMALL, backend="torch")
    state = pqueue.init(cfg, "cpu")
    rng = np.random.default_rng(4)
    keys = rng.uniform(0, 100, 150).astype(np.float32)
    for i in range(0, 150, cfg.a_max):
        chunk = keys[i:i + cfg.a_max]
        state = pqueue.add_batch(cfg, state, chunk,
                                 np.arange(i, i + len(chunk)))
    with pytest.raises(ValueError, match="a_max"):
        pqueue.add_batch(cfg, state, np.zeros(cfg.a_max + 1, np.float32))
    rk, rv, live = pqueue.resident(cfg, state)
    assert rk.shape == (cfg.seq_cap + cfg.par_cap,)
    np.testing.assert_array_equal(np.sort(rk[live].numpy()), np.sort(keys))
    np.testing.assert_array_equal(np.sort(rv[live].numpy()), np.arange(150))
    state, res = pqueue.remove_batch(cfg, state, 40)
    got = res.rm_keys[res.rm_served].numpy()
    np.testing.assert_array_equal(np.sort(got), np.sort(keys)[:40])
    assert int(pqueue.size(state)) == 110
    assert float(pqueue.peek_min(state)) == np.sort(keys)[40]
