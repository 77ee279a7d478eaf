"""The port's sharded engine: its surface, its relaxed contract, its
elastic lane count, and the card.

* ``make_engine(EngineSpec(engine="sharded"))`` conforms to the port's
  ``QueueEngine`` protocol; its lane geometry, ``relax_bound`` and
  ``lanes_within_budget`` equal the reference's over a grid of specs.
* The properties of tests/test_sharded.py and tests/test_preroute.py on
  the port: every removed key lies within ``relax_bound`` smallest of
  the union, draining returns the inserted multiset, the router holds a
  route for ``stick`` ticks and then resamples, forced on and off
  pre-route elimination serve the same multiset.
* A sharded state crosses between the packages through
  ``sharded_state_from_numpy`` / ``sharded_state_to_numpy``, and
  ``fold_lanes`` / ``unfold_lanes`` equal the reference's under injected
  routes.

The sharded engine's check on the card is in tests/test_torch_cuda_kernel.py,
which imports nothing of JAX.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core import PQConfig as JConfig
from repro.core import sharded as jshq
from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import lanes_within_budget as j_lanes_within_budget
from repro.core.factory import make_engine as j_make_engine
from repro_torch.core import EMPTY_VAL
from repro_torch.core import sharded as tshq
from repro_torch.core.factory import (EngineSpec, QueueEngine, ShardedEngine,
                                      default_base, lanes_within_budget,
                                      make_engine)
from repro_torch.core.interop import (sharded_state_from_numpy,
                                      sharded_state_to_numpy)
from test_torch_sharded import (assert_result_equal, assert_state_equal,
                                parity_stream, port_base, ref_cfg)

W = 64
#: the geometry of tests/test_sharded.py and tests/test_preroute.py
PROP = JConfig(a_max=W, r_max=W, seq_cap=512, n_buckets=16, bucket_cap=32,
               detach_min=4, detach_max=64, detach_init=8, chop_patience=8)


def _engine(lanes, **kw):
    return make_engine(EngineSpec(engine="sharded", width=W,
                                  base=port_base(PROP), lanes=lanes, **kw),
                       device="cpu")


def _tick(eng, state, keys, vals, n_rm):
    ak = np.full((W,), np.inf, np.float32)
    av = np.full((W,), EMPTY_VAL, np.int32)
    mask = np.zeros((W,), bool)
    ak[:len(keys)] = keys
    av[:len(keys)] = vals
    mask[:len(keys)] = True
    return eng.tick(state, ak, av, mask, n_rm)


def _served(res):
    return res.rm_keys[res.rm_served].tolist()


def test_engine_protocol_and_geometry_match_reference():
    eng = _engine(4)
    assert isinstance(eng, ShardedEngine) and isinstance(eng, QueueEngine)
    assert eng.kind == "sharded" and eng.width == W
    ref = j_make_engine(JSpec(engine="sharded", width=W, base=PROP,
                              lanes=4)).cfg
    assert eng.cfg.n_lanes == ref.n_lanes and eng.cfg.stick == ref.stick
    for f in dataclasses.fields(ref.lane):
        if f.name != "backend":
            assert getattr(eng.cfg.lane, f.name) == getattr(ref.lane,
                                                            f.name), f.name
    state = eng.init(seed=0)
    state, res = _tick(eng, state, np.arange(8, dtype=np.float32),
                       np.arange(8, dtype=np.int32), 3)
    assert eng.stats(state).n_ticks.item() == 1
    assert int(eng.size(state)) == 5 and int(res.rm_served.sum()) == 3
    _, _, live = eng.resident(state)
    assert int(live.sum()) == 5
    with pytest.raises(ValueError, match="cuda device"):
        make_engine(EngineSpec(engine="sharded", width=W, lanes=4),
                    device="cpu")
    assert make_engine.__kwdefaults__["device"] == "cuda"


@pytest.mark.parametrize("width", [64, 256, 4096])
def test_relax_bound_and_budget_match_reference(width):
    for lanes in (1, 2, 3, 8):
        for min_lanes in (None, 1, 2):
            for slack in (1.0, 1.5):
                for budget in (None, 0, 3 * width, 10 * width):
                    kw = dict(engine="sharded", width=width, lanes=lanes,
                              min_lanes=min_lanes, slack=slack,
                              quality_budget=budget)
                    spec_t = EngineSpec(backend="torch", **kw)
                    spec_j = JSpec(backend="jnp", **kw)
                    assert lanes_within_budget(spec_t, lanes) == \
                        j_lanes_within_budget(spec_j, lanes)
                    if min_lanes is not None and min_lanes > lanes:
                        continue
                    t = make_engine(spec_t, device="cpu")
                    j = j_make_engine(spec_j)
                    assert t.cfg.n_lanes == j.cfg.n_lanes
                    assert t.cfg.lane.a_max == j.cfg.lane.a_max
                    assert t.cfg.lane.bucket_cap == j.cfg.lane.bucket_cap
                    for r in (0, 1, 7, width):
                        assert t.relax_bound(r) == j.relax_bound(r)
    assert default_base(width).a_max == width


@pytest.mark.parametrize("lanes", [2, 8])
def test_c_relaxed_removals(lanes):
    """Every removed key is within the c smallest of the union; the
    multiset is conserved and nothing is dropped."""
    eng = _engine(lanes)
    state = eng.init(seed=1)
    rng = np.random.default_rng(42)
    mirror = []
    load_cap = lanes * eng.cfg.lane.par_cap // 2
    for t in range(40):
        n_add = min(int(rng.integers(0, W + 1)), load_cap - len(mirror))
        n_rm = int(rng.integers(0, W // 2 + 1))
        keys = np.round(rng.uniform(0, 1000, n_add), 3).astype(np.float32)
        combined = sorted(mirror + keys.tolist())
        c = eng.relax_bound(n_rm)
        cutoff = combined[c - 1] if c <= len(combined) else np.inf
        state, res = _tick(eng, state, keys, np.arange(n_add), n_rm)
        got = _served(res)
        assert len(got) <= n_rm
        for k in got:
            assert k <= cutoff, (t, k, cutoff)
            combined.remove(float(np.float32(k)))
        mirror = combined
        assert int(state.n_router_dropped) == 0
        assert int(state.lanes.stats.n_dropped.sum()) == 0
        assert int(eng.size(state)) == len(mirror)


@pytest.mark.parametrize("lanes", [2, 8])
def test_drains_exactly(lanes):
    eng = _engine(lanes)
    state = eng.init(seed=3)
    rng = np.random.default_rng(7)
    inserted = []
    for _ in range(8):
        keys = rng.uniform(0, 100, W // 2).astype(np.float32)
        inserted += keys.tolist()
        state, _ = _tick(eng, state, keys, np.arange(W // 2), 0)
    drained = []
    for _ in range(64):
        state, res = _tick(eng, state, [], [], W)
        got = _served(res)
        if not got:
            break
        drained += got
    assert int(eng.size(state)) == 0
    assert sorted(drained) == sorted(inserted)


def test_router_sticks_resamples_and_spreads_load():
    eng = _engine(4)
    assert eng.cfg.stick > 1
    state = eng.init(seed=0)
    routes = []
    for _ in range(2 * eng.cfg.stick + 1):
        state, _ = _tick(eng, state, np.arange(8, dtype=np.float32),
                         np.arange(8), 0)
        routes.append(state.route.clone())
    for t in range(1, eng.cfg.stick):
        assert torch.equal(routes[0], routes[t])
    assert not torch.equal(routes[0], routes[eng.cfg.stick])
    assert not torch.equal(routes[eng.cfg.stick], routes[2 * eng.cfg.stick])
    assert state.rng.tolist() == [0, 3]          # one step per resample
    for r in routes:        # a permutation of the balanced arange(W) % L
        assert torch.equal(torch.bincount(r, minlength=4),
                           torch.full((4,), W // 4))
        assert torch.equal(
            tshq._with_route(r, "cpu")[1],
            torch.argsort(r, stable=True).to(torch.int32))
    # the same seed draws the same routes; another seed others
    again = eng.init(seed=0)
    other = eng.init(seed=1)
    again, _ = _tick(eng, again, [1.0], [0], 0)
    other, _ = _tick(eng, other, [1.0], [0], 0)
    assert torch.equal(again.route, routes[0])
    assert not torch.equal(other.route, routes[0])

    eng8 = _engine(8)
    state = eng8.init(seed=0)
    rng = np.random.default_rng(0)
    for _ in range(8):
        state, _ = _tick(eng8, state, rng.uniform(0, 1000, W)
                         .astype(np.float32), np.arange(W), 0)
    sizes = tshq.lane_sizes(state)
    assert bool((sizes > 0).all()) and int(sizes.sum()) == 8 * W


def _run_workload(eng, seed, ticks=40):
    state = eng.init(seed=seed)
    rng = np.random.default_rng(seed + 100)
    load_cap = eng.cfg.n_lanes * eng.cfg.lane.par_cap // 2
    inserted, served = [], []
    for _ in range(ticks):
        n_add = min(int(rng.integers(0, W + 1)),
                    load_cap - int(eng.size(state)))
        n_rm = int(rng.integers(0, W // 2 + 1))
        keys = np.round(rng.uniform(0, 1000, n_add), 3).astype(np.float32)
        inserted += keys.tolist()
        state, res = _tick(eng, state, keys, np.arange(n_add), n_rm)
        served += _served(res)
    for _ in range(128):
        state, res = _tick(eng, state, [], [], W)
        got = _served(res)
        if not got:
            break
        served += got
    assert int(eng.size(state)) == 0
    assert int(state.n_router_dropped) == 0
    assert int(state.lanes.stats.n_dropped.sum()) == 0
    return inserted, served, eng.stats(state)


def test_injected_route_must_permute_balanced_pattern():
    """A replayed route keeps the router's quotas only if it permutes
    arange(W) % L: another raises, on a tick and on a fold."""
    eng = _engine(4)
    state = eng.init(seed=0)
    batch = (np.full((W,), np.inf, np.float32), np.zeros((W,), np.int32),
             np.zeros((W,), bool), 0)
    good = np.random.default_rng(3).permutation(np.arange(W) % 4)
    state, _ = tshq.tick(eng.cfg, state, *batch, route=good)
    assert state.route.tolist() == good.tolist()
    for bad in (np.zeros((W,), np.int32), np.arange(W) % 5,
                (np.arange(W) % 4)[:-1]):
        with pytest.raises(ValueError, match="permute"):
            tshq.tick(eng.cfg, eng.init(seed=0), *batch, route=bad)
    with pytest.raises(ValueError, match="permute"):
        tshq.fold_lanes(eng.cfg, state, [0, 1], route=np.arange(W) % 4)


def test_lane_work_marks_grow_only_on_lane_work():
    """The lane counters behind ``lane_work_marks`` stand still on a tick
    with nothing for the lanes and grow on an add, a granted remove and a
    chopHead."""
    eng = _engine(4, preroute="off")
    state = eng.init(seed=0)
    marks = [tshq.lane_work_marks(state)]
    for keys, n_rm in (([], 0), ([3.0, 1.0, 2.0], 0), ([], 0), ([], 2),
                       ([], 0)):
        state, _ = _tick(eng, state, np.asarray(keys, np.float32),
                         np.arange(len(keys)), n_rm)
        marks.append(tshq.lane_work_marks(state))
    assert marks[1] == marks[0] == 0
    assert marks[2] > marks[1] and marks[3] == marks[2]
    assert marks[4] > marks[3] and marks[5] == marks[4]


@pytest.mark.parametrize("lanes", [2, 8])
def test_forced_on_off_same_served_multiset(lanes):
    ins_on, got_on, st_on = _run_workload(_engine(lanes, preroute="on"), 5)
    ins_off, got_off, st_off = _run_workload(_engine(lanes, preroute="off"),
                                             5)
    assert ins_on == ins_off
    assert sorted(got_on) == sorted(got_off) == sorted(ins_on)
    assert int(st_on.n_preroute_elim) > 0
    assert int(st_on.n_preroute_ticks) == int(st_on.n_ticks)
    assert int(st_off.n_preroute_elim) == 0
    assert int(st_off.n_preroute_ticks) == 0


def test_preroute_serves_eligible_adds_directly():
    eng = _engine(4, preroute="on")
    state = eng.init(seed=0)
    high = np.linspace(500, 600, 32).astype(np.float32)
    state, _ = _tick(eng, state, high, np.arange(32), 0)
    lane = eng.stats(state).lane
    before = int(lane.add_imm_elim + lane.add_upc_elim + lane.add_seq
                 + lane.add_par)
    state, res = _tick(eng, state, np.array([1.0, 2.0, 3.0], np.float32),
                       np.arange(3), 3)
    assert sorted(_served(res)) == [1.0, 2.0, 3.0]
    st = eng.stats(state)
    assert int(st.n_preroute_elim) == 3
    assert int(st.lane.add_imm_elim + st.lane.add_upc_elim + st.lane.add_seq
               + st.lane.add_par) == before
    assert int(eng.size(state)) == 32
    assert float(st.min_head) == 500.0 and int(st.depth) == 32


def _port_of(cfg_j, backend="torch"):
    """The port's ShardedPQConfig with the reference config's fields."""
    kw = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)
          if f.name != "lane"}
    return tshq.ShardedPQConfig(lane=port_base(cfg_j.lane, backend), **kw)


def _ref_state_after(cfg_j, ticks, seed=5):
    state = jshq.init(cfg_j, seed=seed)
    stream = list(parity_stream(seed))
    for b in stream[:ticks]:
        state, _ = jshq.tick(cfg_j, state, *b)
    return state, stream[ticks:]


def test_sharded_state_round_trip_through_numpy():
    """A reference state mid-stream crosses into the port and back bit for
    bit; both packages tick it on to the same states, stats included."""
    cfg_j = ref_cfg(4, "adaptive")
    cfg_t = _port_of(cfg_j)
    s_j, rest = _ref_state_after(cfg_j, 30)
    leaves = [np.array(x) for x in jax.tree.leaves(s_j._replace(rng=()))]
    s_t = sharded_state_from_numpy(cfg_t, leaves, "cpu", seed=5)
    for g, w in zip(sharded_state_to_numpy(s_t), leaves):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for t, b in enumerate(rest[:10]):
        s_j, r_j = jshq.tick(cfg_j, s_j, *b)
        s_t, r_t = tshq.tick(cfg_t, s_t, *(np.asarray(x) for x in b),
                             route=np.asarray(s_j.route))
        assert_state_equal(s_t, s_j, f"tick {t}")
        assert_result_equal(r_t, r_j, f"tick {t}")
    st_t, st_j = tshq.stats(s_t), jshq.stats(s_j)
    assert_result_equal(list(st_t.lane) + [st_t.depth, st_t.min_head],
                        list(st_j.lane) + [st_j.depth, st_j.min_head],
                        "stats")
    with pytest.raises(ValueError, match="leaves"):
        sharded_state_from_numpy(cfg_t, leaves[:-1], "cpu")


def test_fold_and_unfold_match_reference():
    """Fold 4 lanes to 3, tick, unfold back to 5, tick: the port equals
    the reference at every step under the reference's routes, and the
    drained elements are the reference's."""
    cfg_j = ref_cfg(4, "adaptive")
    s_j, rest = _ref_state_after(cfg_j, 30)
    leaves = [np.array(x) for x in jax.tree.leaves(s_j._replace(rng=()))]
    cfg_t = _port_of(cfg_j)
    s_t = sharded_state_from_numpy(cfg_t, leaves, "cpu")

    f_j, s_j, dk_j, dv_j = jshq.fold_lanes(cfg_j, s_j, [3, 0, 2])
    f_t, s_t, dk_t, dv_t = tshq.fold_lanes(cfg_t, s_t, [3, 0, 2],
                                           route=np.asarray(s_j.route))
    assert f_t.n_lanes == f_j.n_lanes == 3
    assert len(dk_t) > 0
    np.testing.assert_array_equal(dk_t.view(np.int32), dk_j.view(np.int32))
    np.testing.assert_array_equal(dv_t, dv_j)
    assert s_t.rng.tolist() == [0, 1]
    assert_state_equal(s_t, s_j, "after the fold")
    for t, b in enumerate(rest[:6]):
        s_j, r_j = jshq.tick(f_j, s_j, *b)
        s_t, r_t = tshq.tick(f_t, s_t, *(np.asarray(x) for x in b),
                             route=np.asarray(s_j.route))
        assert_state_equal(s_t, s_j, f"folded tick {t}")
        assert_result_equal(r_t, r_j, f"folded tick {t}")

    u_j, s_j = jshq.unfold_lanes(f_j, s_j, 5)
    u_t, s_t = tshq.unfold_lanes(f_t, s_t, 5, route=np.asarray(s_j.route))
    assert u_t.n_lanes == 5
    assert_state_equal(s_t, s_j, "after the unfold")
    for t, b in enumerate(rest[6:12]):
        s_j, r_j = jshq.tick(u_j, s_j, *b)
        s_t, r_t = tshq.tick(u_t, s_t, *(np.asarray(x) for x in b),
                             route=np.asarray(s_j.route))
        assert_state_equal(s_t, s_j, f"unfolded tick {t}")
        assert_result_equal(r_t, r_j, f"unfolded tick {t}")
    with pytest.raises(ValueError):
        tshq.fold_lanes(u_t, s_t, [0, 0])
    with pytest.raises(ValueError):
        tshq.unfold_lanes(u_t, s_t, 2)

