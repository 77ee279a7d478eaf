"""The port's sharded tick against the JAX package, bit for bit.

* Tick-by-tick equality of every state leaf and every result with
  ``repro.core.sharded.tick`` (jnp backend) at L in {2, 4}, under all
  three pre-route modes and both port backends (on the CPU the "cuda"
  backend's kernel wrappers run their plain versions), over the stream
  that fires every pass followed by mixed ticks that pair adds with
  removes.  The reference's routes are injected: its threefry draws
  cannot be reproduced.  Compared another way: ``rng`` not at all (the
  generators differ) and ``disp_ema`` within a relative 1e-6 (a float
  mean whose summation order differs).  ``elim_ema`` and ``balance_ema``
  are bit-equal: the port rounds their update once, as the reference's
  compiled fused multiply-add does (ROADMAP §3).
* The pieces on their own: ``eliminate_batch_unsorted`` and
  ``eliminate_batch`` (ties, both zeros), ``_alloc_removes_arrays`` with
  and without ``grant_cap``, ``_fold_results``, the routers.
"""

import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import elimination as jelim
from repro.core import sharded as jshq
from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import make_engine as j_make_engine
from repro_torch.core import PQConfig as TorchConfig
from repro_torch.core import elimination as telim
from repro_torch.core import sharded as tshq
from repro_torch.core.factory import EngineSpec, make_engine
from repro_torch.core.interop import sharded_state_to_numpy
from test_lane_megakernel import BASE, W, _batch, _repair_stream

#: leaves of the sharded state without rng, in the reference's order
_N_LANE_LEAVES = 29
_DISP_EMA = _N_LANE_LEAVES + 6


def port_base(cfg, backend="torch"):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "backend"}
    return TorchConfig(backend=backend, **kw)


def port_cfg(lanes, preroute, backend, base=BASE, width=W):
    """The sharded config the port's factory builds, with the lanes'
    backend set to ``backend`` (the "cuda" engine refuses a CPU device,
    so the "cuda" case takes the module-level tick on CPU tensors)."""
    eng = make_engine(EngineSpec(engine="sharded", width=width,
                                 base=port_base(base), lanes=lanes,
                                 preroute=preroute), device="cpu")
    return dataclasses.replace(
        eng.cfg, lane=dataclasses.replace(eng.cfg.lane, backend=backend))


def ref_cfg(lanes, preroute, base=BASE, width=W):
    return j_make_engine(JSpec(engine="sharded", width=width, base=base,
                               lanes=lanes, backend="jnp",
                               preroute=preroute)).cfg


def ref_leaves(state):
    return [np.asarray(x) for x in jax.tree.leaves(state._replace(rng=()))]


def _bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_state_equal(port, ref, what):
    got, want = sharded_state_to_numpy(port), ref_leaves(ref)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        if i == _DISP_EMA:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=what)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{what} leaf {i}")


def assert_result_equal(port, ref, what):
    for i, (g, w) in enumerate(zip(port, jax.tree.leaves(ref))):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (what, i)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} result {i}")


def mixed_stream(rng, ticks, width=W):
    """Ticks with both adds and removes; some keys fall below the union
    minimum, so the pre-route pass pairs them."""
    for _ in range(ticks):
        n_add = int(rng.integers(8, width + 1))
        n_rm = int(rng.integers(8, width + 1))
        keys = np.round(rng.uniform(-200, 1000, n_add), 3).astype(np.float32)
        yield _batch(keys, np.arange(n_add, dtype=np.int32), width) + (
            jnp.asarray(n_rm, jnp.int32),)


def parity_stream(seed):
    return itertools.chain(_repair_stream(np.random.default_rng(seed), 48),
                           mixed_stream(np.random.default_rng(seed + 1), 24))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("preroute", ["on", "off", "adaptive"])
@pytest.mark.parametrize("lanes", [2, 4])
def test_tick_bit_equal_to_reference(lanes, preroute, backend):
    cfg_j = ref_cfg(lanes, preroute)
    cfg_t = port_cfg(lanes, preroute, backend)
    s_j = jshq.init(cfg_j, seed=7)
    s_t = tshq.init(cfg_t, seed=7, device="cpu")
    combine = 0
    for t, (ak, av, mask, rm) in enumerate(parity_stream(11)):
        combine += int(jnp.any(s_j.lanes.seq_len > 0))
        s_j, r_j = jshq.tick(cfg_j, s_j, ak, av, mask, rm)
        s_t, r_t = tshq.tick(cfg_t, s_t, np.asarray(ak), np.asarray(av),
                             np.asarray(mask), int(rm),
                             route=np.asarray(s_j.route))
        assert_state_equal(s_t, s_j, f"tick {t}")
        assert_result_equal(r_t, r_j, f"tick {t}")
    st = s_t.lanes.stats
    fired = {"combine": combine, "scatter": int(st.add_par.sum()),
             "rebalance": int(st.n_rebalance.sum()),
             "movehead": int(st.n_movehead.sum()),
             "chophead": int(st.n_chophead.sum())}
    assert all(v > 0 for v in fired.values()), fired
    n_ticks = int(s_t.tick_idx)
    ran = int(s_t.n_preroute_ticks)
    assert {"on": ran == n_ticks, "off": ran == 0,
            "adaptive": 0 < ran < n_ticks}[preroute], ran
    assert (int(s_t.n_preroute_elim) > 0) == (preroute != "off")


def _elim_cases():
    rng = np.random.default_rng(3)
    pool = np.array([0.0, -0.0, 1.0, 1.0, 2.0, -3.0, 5.0], np.float32)
    for a in (1, 7, 32):
        for _ in range(6):
            keys = rng.choice(pool, a)
            vals = rng.integers(0, 100, a).astype(np.int32)
            mask = rng.random(a) < 0.7
            yield keys, vals, mask, int(rng.integers(0, a + 2)), \
                np.float32(rng.choice([0.0, -0.0, 1.0, 2.0, -5.0, np.inf]))


def _assert_elim_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} field {i}")


@pytest.mark.parametrize("variant", ["unsorted", "sorted"])
def test_elimination_matches_reference_on_ties_and_zeros(variant):
    j_fn, t_fn = {"unsorted": (jelim.eliminate_batch_unsorted,
                               telim.eliminate_batch_unsorted),
                  "sorted": (jelim.eliminate_batch,
                             telim.eliminate_batch)}[variant]
    j_fn = jax.jit(j_fn)
    matched = 0
    for n, (k, v, m, rm, mv) in enumerate(_elim_cases()):
        want = j_fn(jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
                    jnp.asarray(rm, jnp.int32), jnp.asarray(mv))
        got = t_fn(torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(m), rm, torch.tensor(mv))
        _assert_elim_equal(got, want, f"case {n}")
        matched += int(got.n_matched)
    assert matched > 0


@pytest.mark.parametrize("capped", [False, True])
def test_alloc_removes_matches_reference(capped):
    cfg_j = ref_cfg(4, "adaptive")
    cfg_t = port_cfg(4, "adaptive", "torch")
    rng = np.random.default_rng(5 + capped)
    rl = cfg_t.lane.r_max
    for n in range(40):
        sizes = rng.integers(0, 3 * rl, 4).astype(np.int32)
        sizes[rng.random(4) < 0.3] = 0
        heads = rng.choice(np.array([0.0, -0.0, 1.0, 1.0, 7.5, np.inf],
                                    np.float32), 4)
        incoming = rng.integers(0, rl // 2, 4).astype(np.int32)
        rm = int(rng.integers(0, 4 * rl + 8))
        cap = (rng.integers(0, rl + 4, 4).astype(np.int32) if capped
               else None)
        want = jshq._alloc_removes_arrays(
            cfg_j, jnp.asarray(sizes), jnp.asarray(heads), rm,
            jnp.asarray(incoming), None if cap is None else jnp.asarray(cap))
        got = tshq._alloc_removes_arrays(
            cfg_t, torch.from_numpy(sizes), torch.from_numpy(heads), rm,
            torch.from_numpy(incoming),
            None if cap is None else torch.from_numpy(cap))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"case {n}")


def test_fold_results_matches_reference():
    rng = np.random.default_rng(9)
    j_fold = jax.jit(jshq._fold_results)
    for lanes, w in ((1, 8), (3, 40), (4, 80)):
        rl = 16
        for n in range(8):
            n_lane = rng.integers(0, rl + 1, lanes).astype(np.int32)
            res_k = rng.uniform(0, 10, (lanes, rl)).astype(np.float32)
            res_v = rng.integers(0, 99, (lanes, rl)).astype(np.int32)
            n_matched = np.int32(rng.integers(0, w + 1))
            mk = rng.uniform(-5, 0, w).astype(np.float32)
            mv = rng.integers(0, 99, w).astype(np.int32)
            args = (n_matched, mk, mv, res_k, res_v, n_lane)
            want = j_fold(*(jnp.asarray(x) for x in args))
            got = tshq._fold_results(*(torch.from_numpy(np.array(x))
                                       for x in args))
            assert_result_equal(got, want, f"L={lanes} w={w} case {n}")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_routers_match_reference(backend):
    """The sorted router equals the reference's, and equals the reference
    router followed by a stable sort of each lane; the route counts and
    the dropped count agree too (an under-sized quota drops adds)."""
    rng = np.random.default_rng(2)
    for lanes, quota in ((2, None), (4, None), (4, 12)):
        cfg_j = ref_cfg(lanes, "on")
        cfg_t = port_cfg(lanes, "on", backend)
        if quota is not None:
            cfg_j = dataclasses.replace(cfg_j, lane=dataclasses.replace(
                cfg_j.lane, a_max=quota))
            cfg_t = dataclasses.replace(cfg_t, lane=dataclasses.replace(
                cfg_t.lane, a_max=quota))
        for _ in range(6):
            route = np.array(jshq._fresh_route(
                jax.random.PRNGKey(int(rng.integers(1 << 30))), W, lanes))
            inv = np.argsort(route, kind="stable").astype(np.int32)
            keys = rng.choice(np.array([0.0, -0.0, 1.0, 2.5, 9.0],
                                       np.float32), W)
            vals = np.arange(W, dtype=np.int32)
            mask = rng.random(W) < 0.8
            j_args = [jnp.asarray(x) for x in (keys, vals, mask)]
            t_args = [torch.from_numpy(x) for x in (keys, vals, mask)]
            want = jshq._route_adds_sorted(cfg_j, jnp.asarray(inv), *j_args)
            got = tshq._route_adds_sorted(cfg_t, torch.from_numpy(inv),
                                          *t_args)
            assert_result_equal(got, want, f"L={lanes} sorted router")
            lk, lv, lm, drop = tshq._route_adds(
                cfg_t, torch.from_numpy(route), *t_args)
            want_r = jshq._route_adds(cfg_j, jnp.asarray(route), *j_args)
            assert_result_equal((lk, lv, lm, drop), want_r,
                                f"L={lanes} reference router")
            if quota is None:    # nothing dropped: sorting commutes
                order = tshq.kops.argsort_f32_last(lk).long()
                np.testing.assert_array_equal(
                    torch.gather(lv, -1, order).numpy(), got[1].numpy())
            np.testing.assert_array_equal(
                tshq._route_counts(cfg_t, torch.from_numpy(inv),
                                   t_args[2]).numpy(),
                np.asarray(jshq._route_counts(cfg_j, jnp.asarray(inv),
                                              j_args[2])))


def test_tick_n_equals_loop_of_tick():
    cfg = port_cfg(2, "adaptive", "torch")
    stream = [tuple(np.asarray(x) for x in b) for b in parity_stream(17)][:20]
    stacked = [np.stack(xs) for xs in zip(*stream)]
    s_n, r_n = tshq.tick_n(cfg, tshq.init(cfg, seed=3, device="cpu"),
                           *stacked)
    state = tshq.init(cfg, seed=3, device="cpu")
    results = []
    for b in stream:
        state, res = tshq.tick(cfg, state, *b)
        results.append(res)
    for g, w in zip(tshq.pqueue.tree_leaves(s_n),
                    tshq.pqueue.tree_leaves(state)):
        assert torch.equal(g, w)
    for t, res in enumerate(results):
        for g, w in zip(r_n, res):
            assert torch.equal(g[t], w)
