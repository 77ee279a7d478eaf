"""The port's baselines (FCPQ, ParallelPQ) against the JAX package and the
heapq oracle.

* Every state leaf and every result equals the reference's
  (``repro.core.baselines``), compared as bits, on every tick of: the
  oracle runs of tests/test_pq_properties.py; a stream that overflows a
  ParallelPQ bucket on most ticks (``scatter_parallel``'s rebalance
  branch); a stream of tied keys with both zeros; a stream that fills
  FCPQ past its capacity, where both must drop the same keys.
* Served keys equal the port's heapq oracle (``RefPQ``) while the load
  stays within capacity, subnormal keys included.  The bit comparisons
  with the reference flush subnormal keys to zero first: the reference
  runs on XLA:CPU, which flushes subnormals to zero when it compares, so
  it ties a subnormal key with 0.0 where the port (and the oracle)
  order it above (ROADMAP §3).
* ``scatter_parallel`` on its own, on both branches; the factory's
  ``fcskiplist`` / ``lfskiplist`` engines and their protocol members;
  ``FCState`` / ``ParState`` round trips through numpy.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import baselines as jb
from repro.core import pqueue as jpq
from repro.kernels import ops as jops
from repro_torch.core import EMPTY_VAL, PQConfig, RefPQ, pqueue
from repro_torch.core import baselines as tb
from repro_torch.core.factory import (BaselineEngine, EngineSpec,
                                      QueueEngine, engine_kinds,
                                      make_engine)
from repro_torch.core.interop import (fc_state_from_numpy,
                                      par_state_from_numpy, state_to_numpy)
from test_pq_properties import TINY as J_TINY

JNP = jops.resolve_backend("jnp")
REF_TINY = dataclasses.replace(J_TINY, backend=JNP)
TINY = PQConfig(backend="torch", **{
    f.name: getattr(J_TINY, f.name) for f in dataclasses.fields(J_TINY)
    if f.name != "backend"})
IMPLS = {"fc": (jb.FCPQ, tb.FCPQ), "par": (jb.ParallelPQ, tb.ParallelPQ)}


def _bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


def _batch(cfg, keys, next_val):
    ak = np.full((cfg.a_max,), np.inf, np.float32)
    av = np.full((cfg.a_max,), EMPTY_VAL, np.int32)
    mask = np.zeros((cfg.a_max,), bool)
    ak[:len(keys)] = keys
    av[:len(keys)] = np.arange(next_val, next_val + len(keys))
    mask[:len(keys)] = True
    return ak, av, mask


_TINY_F32 = np.finfo(np.float32).tiny


def drive(name, ops, cfg=TINY, ref_cfg=REF_TINY, oracle=True,
          reference=True):
    """ops: (keys, rm_count) pairs.  Ticks the port and, when
    ``reference``, the reference side by side, comparing every leaf and
    result as bits (subnormal keys flushed to zero for both); when
    ``oracle``, compares the served keys with the oracle (keys clipped so
    that the load stays within capacity, as in
    tests/test_pq_properties.py).  Returns the port's final state."""
    jimpl, timpl = IMPLS[name]
    s_j, s_t = jimpl.init(ref_cfg), timpl.init(cfg, "cpu")
    ref = RefPQ()
    next_val = 0
    for t, (keys, n_rm) in enumerate(ops):
        keys = np.asarray(keys, np.float32)
        if reference:
            keys = np.where(np.abs(keys) < _TINY_F32, np.float32(0), keys)
        if oracle:
            keys = keys[:max(0, min(len(keys), cfg.par_cap - len(ref),
                                    cfg.a_max))]
        ak, av, mask = _batch(cfg, keys, next_val)
        next_val += len(keys)
        s_t, r_t = timpl.tick(cfg, s_t, ak, av, mask, n_rm)
        assert r_t.repairs == ()
        if reference:
            s_j = _compare_tick(name, t, jimpl, ref_cfg, s_j, s_t, r_t, ak,
                                av, mask, n_rm)
        if oracle:
            got = np.sort(r_t.rm_keys[r_t.rm_served].numpy())
            exp = np.sort(np.array(
                [k for k, _ in ref.tick(keys.tolist(), range(len(keys)),
                                        n_rm) if k != np.inf], np.float32))
            np.testing.assert_array_equal(got, exp)
            assert int(timpl.size(s_t)) == len(ref)
    return s_t


def _compare_tick(name, t, jimpl, ref_cfg, s_j, s_t, r_t, ak, av, mask,
                  n_rm):
    """Tick the reference and hold the port's state and result to it."""
    s_j, r_j = jimpl.tick(ref_cfg, s_j, jnp.asarray(ak), jnp.asarray(av),
                          jnp.asarray(mask), jnp.asarray(n_rm))
    got, want = state_to_numpy(s_t), [np.asarray(x)
                                      for x in jax.tree.leaves(s_j)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (t, i)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{name} tick {t} leaf {i}")
    for i, (g, w) in enumerate(zip(r_t[:3], jax.tree.leaves(r_j))):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (t, i)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{name} tick {t} res {i}")
    return s_j


key_lists = st.lists(
    st.floats(min_value=0.0, max_value=1e4, allow_nan=False, width=32),
    min_size=0, max_size=16)
op_seqs = st.lists(st.tuples(key_lists, st.integers(0, 16)), min_size=1,
                   max_size=25)


@given(op_seqs)
@settings(max_examples=10)
def test_fc_baseline_matches_reference_and_oracle(ops):
    drive("fc", ops)


@given(op_seqs)
@settings(max_examples=10)
def test_parallel_baseline_matches_reference_and_oracle(ops):
    drive("par", ops)


@pytest.mark.parametrize("name", ["fc", "par"])
@given(ops=op_seqs)
@settings(max_examples=10)
def test_baseline_matches_oracle_on_raw_keys(name, ops):
    """The oracle runs as tests/test_pq_properties.py makes them, subnormal
    keys and all, against the port alone."""
    drive(name, ops, reference=False)


def _overflow_stream(rng, ticks):
    """Rising keys pile into the last bucket until it overflows; drains
    now and then redistribute the store."""
    lo = 0.0
    for t in range(ticks):
        n = int(rng.integers(4, 17))
        keys = lo + rng.uniform(0, 10, n)
        lo += 5.0
        yield np.round(keys, 2), (int(rng.integers(1, 17)) if t % 5 == 4
                                  else 0)


@pytest.mark.parametrize("name", ["fc", "par"])
def test_bucket_overflow_stream(name):
    ops = list(_overflow_stream(np.random.default_rng(1), 40))
    drive(name, ops)


def _tie_stream(rng, ticks):
    pool = np.array([0.0, -0.0, 1.0, 2.0, 3.0, -1.0], np.float32)
    for t in range(ticks):
        yield rng.choice(pool, int(rng.integers(0, 17))), \
            int(rng.integers(0, 12))


@pytest.mark.parametrize("name", ["fc", "par"])
def test_tied_keys_and_both_zeros(name):
    drive(name, list(_tie_stream(np.random.default_rng(2), 40)))


def test_fc_drops_the_same_keys_past_capacity():
    """Add-only ticks past total_cap: both packages keep the same
    smallest keys and silently drop the same largest ones."""
    rng = np.random.default_rng(3)
    ops = [(rng.uniform(0, 1000, 16), 0) for _ in range(20)]
    ops += [(rng.uniform(0, 1000, 16), 16) for _ in range(4)]
    state = drive("fc", ops, oracle=False)
    assert 20 * 16 > TINY.total_cap
    assert int(state.length) == TINY.total_cap - 16


def test_scatter_parallel_both_branches_match_reference():
    """The fast append and the rebalance branch against
    ``repro.core.pqueue.scatter_parallel``."""
    rng = np.random.default_rng(4)
    branches = set()
    for trial in range(12):
        s_j = jb.ParallelPQ.init(REF_TINY)
        s_t = tb.ParallelPQ.init(TINY, "cpu")
        for t in range(trial % 4):
            keys = rng.uniform(0, 100, 16).astype(np.float32)
            ak, av, m = _batch(TINY, keys, 16 * t)
            s_t, _ = tb.ParallelPQ.tick(TINY, s_t, ak, av, m, 0)
            s_j, _ = jb.ParallelPQ.tick(REF_TINY, s_j, jnp.asarray(ak),
                                        jnp.asarray(av), jnp.asarray(m), 0)
        n = int(rng.integers(1, 17))
        keys = (rng.uniform(0, 100, n) if trial % 2
                else rng.uniform(90, 100, n)).astype(np.float32)
        ak, av, _ = _batch(TINY, keys, 999)
        got = pqueue.scatter_parallel(TINY, s_t.par, torch.from_numpy(ak),
                                      torch.from_numpy(av))
        want = jpq.scatter_parallel(REF_TINY, s_j.par, jnp.asarray(ak),
                                    jnp.asarray(av))
        for g, w in zip(pqueue.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(_bits(g.numpy()),
                                          _bits(np.asarray(w)))
        branches.add(int(got[1]))
    assert branches == {0, 1}           # the append and the rebalance


def test_factory_builds_both_baselines():
    assert engine_kinds() == ["adaptive", "dist", "elastic", "fcskiplist",
                              "lfskiplist", "pqe", "sharded"]
    for kind in ("fcskiplist", "lfskiplist"):
        # the baselines read no kernel backend: the default spec builds
        # on the CPU too
        eng = make_engine(EngineSpec(engine=kind, width=16, base=TINY),
                          device="cpu")
        assert isinstance(eng, BaselineEngine)
        assert isinstance(eng, QueueEngine)
        assert eng.kind == kind and eng.width == 16
        assert eng.relax_bound(7) == 7 and eng.stats(None) is None
        state = eng.init(seed=3)
        rng = np.random.default_rng(5)
        batches = [_batch(TINY, rng.uniform(0, 50, 8).astype(np.float32),
                          8 * t) + (4,) for t in range(5)]
        stacked = [np.stack(xs) for xs in zip(*batches)]
        s_n, r_n = eng.tick_n(state, *stacked)
        s_1 = state
        for t, b in enumerate(batches):
            s_1, r = eng.tick(s_1, *b)
            for i in range(3):
                assert torch.equal(r_n[i][t], r[i])
        for a, b in zip(pqueue.tree_leaves(s_n), pqueue.tree_leaves(s_1)):
            assert torch.equal(a, b)
        assert int(eng.size(s_n)) == 5 * 8 - 5 * 4
        with pytest.raises(NotImplementedError):
            eng.resident(s_n)
    assert make_engine.__kwdefaults__["device"] == "cuda"


@pytest.mark.parametrize("name", ["fc", "par"])
def test_state_round_trip_through_numpy(name):
    jimpl, timpl = IMPLS[name]
    load = fc_state_from_numpy if name == "fc" else par_state_from_numpy
    s_j = jimpl.init(REF_TINY)
    rng = np.random.default_rng(6)
    for t in range(5):
        ak, av, m = _batch(TINY, rng.uniform(0, 50, 12).astype(np.float32),
                           12 * t)
        s_j, _ = jimpl.tick(REF_TINY, s_j, jnp.asarray(ak), jnp.asarray(av),
                            jnp.asarray(m), jnp.asarray(3))
    leaves = [np.array(x) for x in jax.tree.leaves(s_j)]
    s_t = load(TINY, leaves, "cpu")
    for g, w in zip(state_to_numpy(s_t), leaves):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="leaves"):
        load(TINY, leaves[:-1], "cpu")
    ak, av, m = _batch(TINY, np.arange(5, dtype=np.float32), 500)
    n_t, r_t = timpl.tick(TINY, s_t, ak, av, m, 9)
    n_j, r_j = jimpl.tick(REF_TINY, s_j, jnp.asarray(ak), jnp.asarray(av),
                          jnp.asarray(m), jnp.asarray(9))
    for g, w in zip(state_to_numpy(n_t), jax.tree.leaves(n_j)):
        np.testing.assert_array_equal(g, np.asarray(w))
