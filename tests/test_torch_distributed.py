"""The port's lanes-over-devices queue on a CPU mesh.

* **Against itself**: ``dist`` over D positions of l lanes equals the
  port's ``sharded`` at L = D * l on every state leaf and result, every
  tick, for (D, l) in {(1, 8), (2, 4), (4, 2)} (both draw routes from the
  same generator), on the stream that fires every pass followed by mixed
  ticks; a position without lane work skips its lanes' pipeline while
  another runs.  Also with the "cuda" lane config (the kernel wrappers
  run their plain versions on CPU tensors), and with ``spare_devices=1``
  against ``sharded`` with ``min_lanes = (D - 1) * l``.
* **Against the reference** at D=1 (tier-1 has one JAX device) under its
  replayed routes, with ``lane_scale`` all ones and fractional: every
  leaf bit for bit (``disp_ema`` within a relative 1e-6, ``rng`` not
  compared: the generators differ), every result, and ``stats()``'s
  ``depth`` and ``min_head``.
* ``tick_n`` equals a loop of ``tick``; ``remove_device`` at D=2
  conserves the multiset, equals ``sharded.fold_lanes`` of the same lanes
  followed by re-insertion, and keeps the ``relax_bound`` envelope at the
  new L; the interop round trip, the default mesh and the checks.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import make_engine as j_make_engine
from repro_torch.core import distributed as dq
from repro_torch.core import pqueue
from repro_torch.core import sharded as tshq
from repro_torch.core.factory import EngineSpec, make_engine
from repro_torch.core.interop import (dist_state_from_numpy,
                                      dist_state_to_numpy,
                                      sharded_state_to_numpy)
from test_dist_sharded import BASE as DIST_BASE
from test_lane_megakernel import BASE, W, _batch
from test_torch_sharded import (_DISP_EMA, _bits, assert_result_equal,
                                parity_stream, port_base, ref_leaves)

REF_BASE = dataclasses.replace(BASE, backend="jnp")


def port_dist(n_devices, lanes, backend="torch", base=BASE, **kw):
    return make_engine(EngineSpec(engine="dist", width=W,
                                  base=port_base(base, backend),
                                  lanes=n_devices * lanes,
                                  n_devices=n_devices,
                                  lanes_per_device=lanes, **kw),
                       device="cpu")


def np_batch(b):
    ak, av, m, rm = b
    return np.asarray(ak), np.asarray(av), np.asarray(m), int(rm)


def assert_same(a, b, what):
    """Every tensor leaf of ``a`` bit-equal to ``b``'s."""
    la, lb = pqueue.tree_leaves(a), pqueue.tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{what}: leaf {i} differs"


@pytest.mark.parametrize("case", [
    (1, 8, "torch", 0), (2, 4, "torch", 0), (4, 2, "torch", 0),
    (2, 4, "cuda", 0), (2, 4, "torch", 1)],
    ids=["D1xl8", "D2xl4", "D4xl2", "D2xl4_cuda_config", "D2xl4_spare1"])
def test_dist_equals_sharded(case):
    n_dev, lanes, backend, spare = case
    q = port_dist(n_dev, lanes, spare_devices=spare)
    cfg = q.cfg
    if backend == "cuda":        # the module functions take CPU tensors
        cfg = dataclasses.replace(cfg, shard=dataclasses.replace(
            cfg.shard, lane=dataclasses.replace(cfg.shard.lane,
                                                backend="cuda")))
    eng = make_engine(EngineSpec(engine="sharded", width=W,
                                 base=port_base(BASE), lanes=n_dev * lanes,
                                 min_lanes=(n_dev - spare) * lanes),
                      device="cpu")
    assert eng.cfg.lane == dataclasses.replace(cfg.shard.lane,
                                               backend="torch")
    d_state = dq.init(cfg, q.mesh, seed=3)
    s_state = tshq.init(cfg.shard, seed=3, device="cpu")
    for t, b in enumerate(parity_stream(11)):
        b = np_batch(b)
        d_state, d_res = dq.tick(cfg, d_state, *b)
        s_state, s_res = tshq.tick(cfg.shard, s_state, *b)
        assert_same(dq.gather(d_state), s_state, f"tick {t} state")
        assert_same(d_res, s_res, f"tick {t} result")
    st = s_state.lanes.stats
    assert all(int(x.sum()) > 0 for x in (
        st.n_rebalance, st.n_movehead, st.n_chophead, st.add_par))
    assert int(s_state.n_preroute_elim) > 0


def test_positions_skip_on_their_own_predicate():
    """At D=4 some positions have no lane work while others do: the
    engine counts each position's work ticks, and they differ."""
    q = port_dist(4, 2)
    state = q.init(seed=3)
    for b in parity_stream(11):
        state, _ = q.tick(state, *np_batch(b))
    assert min(q.work_ticks) < max(q.work_ticks) <= int(state.tick_idx)


@pytest.fixture(scope="module")
def reference_dist_runs():
    """The reference's dist queue at D=1 over the parity stream: per tick
    the state leaves, the result, stats, and the route it drew."""
    out = {}
    q = j_make_engine(JSpec(engine="dist", width=W, base=REF_BASE, lanes=8,
                            n_devices=1, lanes_per_device=8))
    for name, scale in SCALES.items():
        state = q.init(seed=1)
        ticks = []
        for ak, av, m, rm in parity_stream(11):
            draws = int(state.tick_idx) % q.cfg.shard.stick == 0
            state, res = q.tick(state, ak, av, m, rm,
                                None if scale is None else jnp.asarray(scale))
            st = q.stats(state)
            ticks.append(dict(
                leaves=ref_leaves(state), res=res,
                route=np.asarray(state.route) if draws else None,
                depth=int(st.depth), min_head=np.asarray(st.min_head)))
        out[name] = ticks
    return out


SCALES = {"unthrottled": None,
          "fractional": np.array([1.0, 0.5, 0.3, 1.0, 0.75, 0.1, 1.0, 0.9],
                                 np.float32)}


@pytest.mark.parametrize("name", list(SCALES))
def test_dist_bit_equal_to_reference(name, reference_dist_runs):
    q = port_dist(1, 8)
    scale = SCALES[name]
    state = q.init(seed=1)
    for t, (b, want) in enumerate(zip(parity_stream(11),
                                      reference_dist_runs[name])):
        state, res = q.tick(state, *np_batch(b), scale, route=want["route"])
        got = dist_state_to_numpy(state)
        assert len(got) == len(want["leaves"])
        for i, (g, w) in enumerate(zip(got, want["leaves"])):
            assert g.dtype == w.dtype and g.shape == w.shape, (t, i)
            if i == _DISP_EMA:
                np.testing.assert_allclose(g, w, rtol=1e-6)
            else:
                np.testing.assert_array_equal(_bits(g), _bits(w),
                                              err_msg=f"tick {t} leaf {i}")
        assert_result_equal(res, want["res"], f"tick {t}")
        st = q.stats(state)
        assert int(st.depth) == want["depth"] == int(q.size(state))
        np.testing.assert_array_equal(_bits(st.min_head.numpy()),
                                      _bits(want["min_head"]))
    if name == "fractional":     # the caps bound a lane's serves
        assert int(state.n_preroute_elim) > 0


def test_tick_n_equals_loop_of_tick():
    q = port_dist(2, 4)
    stream = [np_batch(b) for b in parity_stream(17)][:20]
    stacked = [np.stack(xs) for xs in zip(*stream)]
    scale = np.full((8,), 0.5, np.float32)
    s_n, r_n = q.tick_n(q.init(seed=3), *stacked, scale)
    state = q.init(seed=3)
    for t, b in enumerate(stream):
        state, res = q.tick(state, *b, scale)
        for g, x in zip(r_n, res):
            assert torch.equal(g[t], x)
    assert_same(s_n, state, "tick_n state")


def _pairs(q, state):
    keys, vals, live = q.resident(state)
    return sorted(zip(keys[live].tolist(), vals[live].tolist()))


def test_remove_device_conserves_and_equals_fold():
    """At the geometry of tests/test_dist_sharded.py (the lanes hold
    what a fold re-inserts; the repair-forcing geometry's would shed)."""
    q = port_dist(2, 4, base=DIST_BASE, spare_devices=1)
    state = q.init(seed=5)
    for b in list(parity_stream(21))[:12]:
        state, _ = q.tick(state, *np_batch(b))
    before = _pairs(q, state)
    assert len(before) > 100
    q2, s2 = q.remove_device(state, 1)
    assert q2.cfg.n_devices == 1 and q2.cfg.shard.n_lanes == 4
    assert q2.mesh == [torch.device("cpu")]
    assert _pairs(q2, s2) == before
    # the same fold and re-insertion through the single-device queue
    cfg, folded, dk, dv = tshq.fold_lanes(q.cfg.shard, dq.gather(state),
                                          [0, 1, 2, 3])
    assert cfg == q2.cfg.shard and len(dk) == len(dv) > 0
    w = cfg.a_total
    for i in range(0, len(dk), w):
        ak, av, m = (np.asarray(x) for x in _batch(dk[i:i + w],
                                                   dv[i:i + w], w))
        folded, _ = tshq.tick(cfg, folded, ak, av, m, 0)
    assert_same(dq.gather(s2), folded, "resized state")
    # the envelope at the new L from the first tick after the resize
    assert q2.relax_bound(16) == tshq.relax_bound(cfg, 16) \
        < q.relax_bound(16)
    union = [k for k, _ in before]
    for t, b in enumerate(list(parity_stream(23))[48:64]):
        ak, av, m, rm = np_batch(b)
        union = sorted(union + ak[m].tolist())
        c = q2.relax_bound(rm)
        s2, res = q2.tick(s2, ak, av, m, rm)
        served = res.rm_keys[res.rm_served].tolist()
        for k in served:
            assert union.index(k) < c, (t, k, c)
            union.remove(k)
        assert sorted(k for k, _ in _pairs(q2, s2)) == union
    assert int(s2.n_router_dropped) == 0
    assert sum(int(p.stats.n_dropped.sum()) for p in s2.lanes) == 0


def test_interop_places_reference_leaves_on_a_mesh():
    q = j_make_engine(JSpec(engine="dist", width=W, base=REF_BASE, lanes=8,
                            n_devices=1, lanes_per_device=8))
    state = q.init(seed=2)
    for ak, av, m, rm in list(parity_stream(3))[:6]:
        state, _ = q.tick(state, ak, av, m, rm)
    leaves = ref_leaves(state)
    port = port_dist(2, 4)
    d_state = dist_state_from_numpy(port.cfg, leaves, port.mesh, seed=4)
    assert [p.seq_len.shape for p in d_state.lanes] == [(4,), (4,)]
    for g, w in zip(dist_state_to_numpy(d_state), leaves):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert d_state.rng.tolist() == [4, 0]
    s_state = tshq.init(port.cfg.shard, seed=4, device="cpu")
    assert len(sharded_state_to_numpy(s_state)) == len(leaves)


def test_default_mesh_and_construction_checks():
    cfg = port_dist(2, 4).cfg
    assert dq.default_mesh(cfg, "cpu") == [torch.device("cpu")] * 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="mesh="):
            dq.default_mesh(cfg, "cuda")
    with pytest.raises(ValueError, match="mesh has 1 devices"):
        dq.DistShardedQueue(cfg, ["cpu"])
    with pytest.raises(ValueError, match="cuda device"):
        make_engine(EngineSpec(engine="dist", width=W, base=port_base(BASE,
                                                                      "cuda"),
                               lanes=8, n_devices=2), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        make_engine(EngineSpec(engine="dist", width=W, lanes=7,
                               n_devices=2, backend="torch"), device="cpu")
    with pytest.raises(ValueError, match="spare_devices"):
        make_engine(EngineSpec(engine="dist", width=W, lanes=8, n_devices=2,
                               spare_devices=2, backend="torch"),
                    device="cpu")
    with pytest.raises(ValueError, match="last device"):
        q = port_dist(1, 8)
        q.remove_device(q.init(), 0)
