"""The port's workload controller and adaptive engine against the JAX
package.

* ``ControllerConfig`` rejects what the reference rejects; ``decide``
  returns the reference's ``ControllerState`` and ``Plan`` field for
  field on the inputs of tests/test_adaptive.py and on random ones;
  ``_window_signals`` gives the reference's counts exactly and its sums
  within a relative 1e-6 (a float sum in another order).
* ``AdaptiveEngine`` on the streams of tests/test_adaptive.py (switch and
  conserve, clustered stays sharded, alternating bounds switches, the
  sharded-only fold and unfold), under the reference's routes: every
  result and every state leaf equals the reference's on every tick
  (``disp_ema`` within a relative 1e-6, ``rng`` not compared: the
  generators differ), and the Plan, the tick count and the controller's
  state agree on every tick.  The routes are replayed by replacing the
  port's ``sharded._fresh_route`` with the reference's draws in order,
  recorded from its states on each tick that draws.
* ``engines=("pqe",)`` equals the reference every tick, ``freeze=True``
  equals the port's fixed sharded engine, the quality budget caps the
  lane ceiling as in tests/test_quality.py, and a cloned state replays
  the same decisions.

Reference runs are made once per module, in fixtures.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sharded as jshq
from repro.core.adaptive import ControllerConfig as JCtlCfg
from repro.core.adaptive import ControllerState as JCtlState
from repro.core.adaptive import Plan as JPlan
from repro.core.adaptive import _window_signals as j_window_signals
from repro.core.adaptive import decide as j_decide
from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import make_engine as j_make_engine
from repro_torch.core import pqueue
from repro_torch.core import sharded as tshq
from repro_torch.core.adaptive import (AdaptiveEngine, AdaptiveState,
                                       ControllerConfig, ControllerState,
                                       Plan, _window_signals, decide)
from repro_torch.core.factory import EngineSpec, QueueEngine, make_engine
from repro_torch.core.interop import sharded_state_to_numpy, state_to_numpy
from test_adaptive import BASE, W, _batch, _clustered_keys, _uniform_keys
from test_torch_sharded import _DISP_EMA, _bits, port_base

REF_BASE = dataclasses.replace(BASE, backend="jnp")
PORT_BASE = port_base(BASE)
_FLOAT_CTL = ("balance_ema", "disp_ema", "acc_bal", "acc_disp")


def _ref_engine(**kw):
    return j_make_engine(JSpec(engine="adaptive", width=W, base=REF_BASE,
                               lanes=4, **kw))


def _port_engine(**kw):
    return make_engine(EngineSpec(engine="adaptive", width=W,
                                  base=PORT_BASE, lanes=4, **kw),
                       device="cpu")


# ---------------------------------------------------------------------------
# the host logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(window=0),
    dict(decay=0.0),
    dict(decay=1.5),
    dict(confirm=0),
    dict(cooldown=-1),
    dict(engines=()),
    dict(engines=("pqe", "nope")),
    dict(balance_lo=0.8, balance_hi=0.5),
    dict(quality_budget=-1.0),
])
def test_controller_config_validation(kw):
    with pytest.raises(ValueError):
        JCtlCfg(**kw)
    with pytest.raises(ValueError):
        ControllerConfig(**kw)


def _obs(balance, disp, n=8.0, **kw):
    return dict(acc_bal=balance * n, acc_bal_n=n, acc_disp=disp * n,
                acc_disp_n=n, **kw)


#: (controller config, controller state, current plan) of the decide()
#: tests in tests/test_adaptive.py, as keyword dicts
_SEEDED = dict(seeded_balance=True, seeded_disp=True)
DECIDE_CASES = [
    (dict(confirm=1, cooldown=0), _obs(1.0, 0.5), ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0), _obs(1.0, 0.10), ("pqe", 4, "adaptive")),
    (dict(confirm=1, cooldown=0), _obs(0.43, 0.5), ("pqe", 4, "adaptive")),
    (dict(confirm=1, cooldown=0),
     _obs(0.6, 0.5, balanced=True, dispersed=True, balance_ema=0.6,
          disp_ema=0.5, **_SEEDED), ("pqe", 4, "adaptive")),
    (dict(confirm=1, cooldown=0),
     _obs(0.6, 0.5, balanced=False, seeded_balance=True, balance_ema=0.6),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0), _obs(0.43, 0.13),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0),
     _obs(1.0, 0.5, balance_ema=0.43, disp_ema=0.13, **_SEEDED),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0),
     dict(balance_ema=0.9, disp_ema=0.5, balanced=True, dispersed=True,
          **_SEEDED), ("pqe", 4, "adaptive")),
    (dict(confirm=2, cooldown=0), _obs(1.0, 0.5), ("sharded", 4, "adaptive")),
    (dict(confirm=2, cooldown=0),
     _obs(1.0, 0.5, pending=("pqe", 4, "adaptive"), pending_n=1,
          balanced=True, dispersed=True, balance_ema=1.0, disp_ema=0.5,
          **_SEEDED), ("sharded", 4, "adaptive")),
    (dict(confirm=2, cooldown=0),
     _obs(0.0, 0.5, pending=("pqe", 4, "adaptive"), pending_n=1),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0), _obs(1.0, 0.5, cooldown=2),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0),
     _obs(1.0, 0.5, cooldown=1, balanced=True, dispersed=True,
          balance_ema=1.0, disp_ema=0.5, **_SEEDED),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0, freeze=True), _obs(1.0, 0.5),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0, engines=("sharded",)), _obs(1.0, 0.5),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0, engines=("sharded",)), _obs(0.2, 0.5),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0, reprobe=4), _obs(0.2, 0.5, hit_ema=0.01),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0, reprobe=4),
     _obs(0.2, 0.5, low_hit=True, hit_ema=0.12, n_windows=1),
     ("sharded", 4, "adaptive")),
    (dict(confirm=1, cooldown=0, reprobe=4),
     _obs(0.2, 0.5, low_hit=True, hit_ema=0.01, n_windows=3),
     ("sharded", 4, "adaptive")),
]


def _random_cases(n):
    rng = np.random.default_rng(5)
    plans = [("pqe", 4, "adaptive"), ("sharded", 4, "adaptive"),
             ("sharded", 2, "adaptive"), ("sharded", 4, "off")]
    for _ in range(n):
        cfg = dict(confirm=int(rng.integers(1, 4)),
                   cooldown=int(rng.integers(0, 3)),
                   reprobe=int(rng.integers(0, 5)),
                   engines=[("pqe", "sharded"), ("sharded",), ("pqe",)][
                       int(rng.integers(0, 3))])
        ctl = dict(
            balance_ema=float(rng.uniform()), disp_ema=float(rng.uniform()),
            hit_ema=float(rng.uniform(0, 0.2)),
            seeded_balance=bool(rng.integers(0, 2)),
            seeded_disp=bool(rng.integers(0, 2)),
            balanced=bool(rng.integers(0, 2)),
            dispersed=bool(rng.integers(0, 2)),
            low_hit=bool(rng.integers(0, 2)),
            pending=plans[int(rng.integers(0, 4))] if rng.integers(0, 2)
            else None,
            pending_n=int(rng.integers(0, 3)),
            cooldown=int(rng.integers(0, 3)),
            n_windows=int(rng.integers(0, 20)),
            n_switches=int(rng.integers(0, 5)),
            acc_bal=float(rng.uniform(0, 8)),
            acc_bal_n=float(rng.integers(0, 9)),
            acc_disp=float(rng.uniform(0, 8)),
            acc_disp_n=float(rng.integers(0, 9)))
        yield cfg, ctl, plans[int(rng.integers(0, 4))]


def _as_plain(ctl):
    d = dataclasses.asdict(ctl)
    if d["pending"] is not None:
        d["pending"] = tuple(d["pending"])
    return d


@pytest.mark.parametrize("case", DECIDE_CASES + list(_random_cases(40)))
def test_decide_equals_reference(case):
    cfg, ctl, current = case
    got = want = None
    for C, S, P, fn in ((ControllerConfig, ControllerState, Plan, decide),
                        (JCtlCfg, JCtlState, JPlan, j_decide)):
        kw = dict(ctl)
        if kw.get("pending") is not None:
            kw["pending"] = P(*kw["pending"])
        out = fn(C(**cfg), S(**kw), P(*current), max_lanes=4, min_lanes=2,
                 base_preroute="adaptive")
        if fn is decide:
            got = out
        else:
            want = out
    assert type(got[0]) is ControllerState and type(got[1]) is Plan
    assert _as_plain(got[0]) == _as_plain(want[0])
    assert tuple(got[1]) == tuple(want[1])


def _signal_batches(rng, t):
    ak = np.full((t, W), np.inf, np.float32)
    am = np.zeros((t, W), bool)
    rm = rng.integers(0, W + 1, t).astype(np.int32)
    for i in range(t):
        n = int(rng.integers(0, W + 1)) if i % 4 else int(rng.integers(0, 2))
        lo = float(rng.uniform(-100, 100))
        ak[i, :n] = lo + rng.exponential(30.0, n) if i % 2 else \
            rng.uniform(lo, lo + 500, n)
        if i % 5 == 0 and n:
            ak[i, :n] = 7.0          # one distinct key: uninformative
        am[i, :n] = True
    rm[::3] = 0
    return ak, am, rm


@pytest.mark.parametrize("t", [1, 3, 8, 20])
def test_window_signals_match_reference(t):
    ak, am, rm = _signal_batches(np.random.default_rng(t), t)
    got = _window_signals(torch.from_numpy(ak), torch.from_numpy(am),
                          torch.from_numpy(rm))
    assert got.shape == (4,) and got.dtype == torch.float32
    want = np.asarray(jnp.stack(j_window_signals(
        jnp.asarray(ak), jnp.asarray(am), jnp.asarray(rm))))
    got = got.numpy()
    assert got[1] == want[1] and got[3] == want[3]      # the counts
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-6)


# ---------------------------------------------------------------------------
# the engine against the reference, tick by tick, under replayed routes
# ---------------------------------------------------------------------------

def _switch_stream(seed):
    rng = np.random.default_rng(seed)
    return ([_batch(_uniform_keys(rng, 64), 0)]
            + [_batch(_uniform_keys(rng), 32) for _ in range(47)]
            + [_batch([], 16) for _ in range(48)])


def _clustered_stream():
    rng = np.random.default_rng(2)
    return [_batch(_clustered_keys(rng), 32) for _ in range(48)]


def _alternating_stream():
    rng = np.random.default_rng(3)
    out = []
    for w in range(24):
        out += ([_batch(_uniform_keys(rng), 32) for _ in range(8)]
                if w % 2 == 0 else [_batch([], 16) for _ in range(8)])
    return out


def _fold_overflow_stream():
    """256 keys warm, then the balanced-uniform mix: a fold to one lane
    of the min_lanes=1 geometry re-inserts more keys than that lane
    holds (seq_cap 130 with a spill threshold of 2, 16x8 buckets), and
    the lane sheds the largest, in the reference as in the port."""
    rng = np.random.default_rng(9)
    return ([_batch(_uniform_keys(rng, 64), 0) for _ in range(4)]
            + [_batch(_uniform_keys(rng), 32) for _ in range(44)]
            + [_batch([], 16) for _ in range(48)])


#: name -> (engine keywords, stream)
STREAMS = {
    "switch": (dict(), lambda: _switch_stream(1)),
    "clustered": (dict(), _clustered_stream),
    "alternating": (dict(controller=ControllerConfig()),
                    _alternating_stream),
    "fold": (dict(min_lanes=2,
                  controller=ControllerConfig(engines=("sharded",))),
             lambda: _switch_stream(6)),
    "fold_overflow": (dict(min_lanes=1,
                           controller=ControllerConfig(engines=("sharded",))),
                      _fold_overflow_stream),
}


def _ref_kw(kw):
    kw = dict(kw)
    if kw.get("controller") is not None:
        kw["controller"] = JCtlCfg(**dataclasses.asdict(kw["controller"]))
    return kw


def _inner_leaves(kind, inner):
    if kind == "sharded":
        return [np.asarray(x) for x in jax.tree.leaves(inner._replace(rng=()))]
    return [np.asarray(x) for x in jax.tree.leaves(inner)]


def _record_reference(eng, stream):
    """Drive the reference adaptive engine ``eng`` one tick at a time;
    record every tick's results, inner leaves, plan and controller
    state, and every route it draws, in draw order."""
    routes = []
    ticks = []
    chunk_fn = eng._chunk_fn

    def recording_chunk_fn(kind, lanes, preroute):
        fn = chunk_fn(kind, lanes, preroute)
        if kind != "sharded":
            return fn

        def run(inner, ak, av, am, rm):
            t0, stick = int(inner.tick_idx), eng.cfg.stick
            out = fn(inner, ak, av, am, rm)
            draws = sum((t0 + i) % stick == 0 for i in range(ak.shape[0]))
            assert draws <= 1
            if draws:
                routes.append(np.asarray(out[0].route))
            return out
        return run

    tick, fold, unfold = jshq.tick, jshq.fold_lanes, jshq.unfold_lanes

    def recording_tick(cfg, state, *args):
        t0 = int(state.tick_idx)
        out = tick(cfg, state, *args)
        if t0 % cfg.stick == 0:
            routes.append(np.asarray(out[0].route))
        return out

    def recording_fold(cfg, state, keep):
        out = fold(cfg, state, keep)
        routes.append(np.asarray(out[1].route))
        return out

    def recording_unfold(cfg, state, n_lanes):
        out = unfold(cfg, state, n_lanes)
        if n_lanes != cfg.n_lanes:
            routes.append(np.asarray(out[1].route))
        return out

    eng._chunk_fn = recording_chunk_fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshq, "tick", recording_tick)
        mp.setattr(jshq, "fold_lanes", recording_fold)
        mp.setattr(jshq, "unfold_lanes", recording_unfold)
        state = eng.init(seed=0)
        for ak, av, m, rm in stream:
            state, res = eng.tick(state, jnp.asarray(ak), jnp.asarray(av),
                                  jnp.asarray(m), jnp.asarray(rm))
            ticks.append(dict(
                res=[np.asarray(x) for x in res],
                inner=_inner_leaves(state.kind, state.inner),
                host=(state.kind, state.lanes, state.preroute,
                      state.tick_count, state.seed),
                ctl=_as_plain(state.ctl)))
    return ticks, routes


@pytest.fixture(scope="module")
def reference_runs():
    return {name: _record_reference(_ref_engine(**_ref_kw(kw)), make())
            for name, (kw, make) in STREAMS.items()}


def replay_routes(mp, routes):
    """Make the port's router draw ``routes`` in order."""
    it = iter(routes)

    def fresh(seed, count, w, n_lanes, device):
        route = next(it)
        assert route.shape == (w,) and int(route.max()) == n_lanes - 1
        return torch.tensor(route, dtype=torch.int32, device=device)

    mp.setattr(tshq, "_fresh_route", fresh)
    return it


def _assert_ctl_equal(got, want, what, rtol=1e-6):
    got = _as_plain(got)
    for k, w in want.items():
        if k in _FLOAT_CTL:
            if rtol is not None:       # None: the caller weighs the sums
                np.testing.assert_allclose(got[k], w, rtol=rtol,
                                           err_msg=f"{what} ctl.{k}")
        else:
            assert got[k] == w, (what, k, got[k], w)


def _assert_tick_equal(state, res, want, what, float_rtol=1e-6):
    assert (state.kind, state.lanes, state.preroute, state.tick_count,
            state.seed) == want["host"], what
    for i, (g, w) in enumerate(zip(res, want["res"])):
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} result {i}")
    got = (sharded_state_to_numpy(state.inner) if state.kind == "sharded"
           else state_to_numpy(state.inner))
    assert len(got) == len(want["inner"]), what
    for i, (g, w) in enumerate(zip(got, want["inner"])):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        if state.kind == "sharded" and i == _DISP_EMA:
            if float_rtol is not None:
                np.testing.assert_allclose(g, w, rtol=float_rtol,
                                           err_msg=what)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{what} leaf {i}")
    _assert_ctl_equal(state.ctl, want["ctl"], what, float_rtol)


@pytest.mark.parametrize("name", list(STREAMS))
def test_engine_bit_equal_to_reference(name, reference_runs, monkeypatch):
    kw, make = STREAMS[name]
    want, routes = reference_runs[name]
    left = replay_routes(monkeypatch, routes)
    eng = _port_engine(**kw)
    state = eng.init(seed=0)
    inserted, served_all = [], []
    for t, (ak, av, m, rm) in enumerate(make()):
        inserted.extend(ak[m].tolist())
        state, res = eng.tick(state, ak, av, m, rm)
        served_all.extend(res.rm_keys[res.rm_served].tolist())
        _assert_tick_equal(state, res, want[t], f"{name} tick {t}")
    assert next(left, None) is None, "a reference route was not drawn"
    keys, _, live = eng.resident(state)
    resident = keys.reshape(-1)[live.reshape(-1)].numpy()
    kept = np.sort(np.concatenate([np.asarray(served_all, np.float32),
                                   resident]))
    n_switches = state.ctl.n_switches
    if name == "fold_overflow":
        # the reference's fault, reproduced: the folded lane sheds keys
        # (counted in its n_dropped, which the comparison above pins)
        dropped = int(state.inner.lanes.stats.n_dropped.sum())
        assert dropped > 0 and len(kept) == len(inserted) - dropped
        assert n_switches >= 2 and state.lanes == 4
        return
    np.testing.assert_array_equal(
        np.sort(np.asarray(inserted, np.float32)), kept)
    if name == "switch":
        assert n_switches == 2 and state.kind == "sharded"
    elif name == "clustered":
        assert n_switches == 0 and state.kind == "sharded"
        assert state.ctl.balanced and not state.ctl.dispersed
    elif name == "alternating":
        assert state.ctl.n_windows == 24 and n_switches <= 24 // 6 + 1
    else:
        assert n_switches == 2 and state.lanes == 4
        assert eng.controller_stats(state)["lanes"] == 4


def test_fold_plans_fold_and_unfold(reference_runs):
    """The sharded-only stream folds to min_lanes and back: the plan
    trace passes through L=2 (checked against the reference tick by tick
    above)."""
    want, _ = reference_runs["fold"]
    lanes = [t["host"][1] for t in want]
    assert 2 in lanes and lanes[-1] == 4
    assert all(t["host"][0] == "sharded" for t in want)


def test_pqe_only_equals_reference_every_tick():
    ctl = ControllerConfig(engines=("pqe",))
    eng = _port_engine(controller=ctl)
    ref = _ref_engine(controller=JCtlCfg(engines=("pqe",)))
    s_t, s_j = eng.init(seed=0), ref.init(seed=0)
    assert s_t.kind == "pqe" and s_j.kind == "pqe"
    rng = np.random.default_rng(5)
    for t in range(16):
        ak, av, m, rm = _batch(_uniform_keys(rng), 16)
        s_t, r_t = eng.tick(s_t, ak, av, m, rm)
        s_j, r_j = ref.tick(s_j, jnp.asarray(ak), jnp.asarray(av),
                            jnp.asarray(m), jnp.asarray(rm))
        _assert_tick_equal(s_t, r_t, dict(
            res=[np.asarray(x) for x in r_j],
            inner=_inner_leaves("pqe", s_j.inner),
            host=(s_j.kind, s_j.lanes, s_j.preroute, s_j.tick_count,
                  s_j.seed), ctl=_as_plain(s_j.ctl)), f"pqe tick {t}")
    assert s_t.ctl.n_switches == 0


def _stack(batches):
    return tuple(np.stack(xs) for xs in zip(*batches))


def test_freeze_is_bit_identical_to_fixed_sharded():
    frozen = _port_engine(controller=ControllerConfig(freeze=True))
    fixed = make_engine(EngineSpec(engine="sharded", width=W, base=PORT_BASE,
                                   lanes=4), device="cpu")
    assert frozen.cfg == fixed.cfg
    rng = np.random.default_rng(4)
    batches = ([_batch(_uniform_keys(rng), 32) for _ in range(16)]
               + [_batch([], 16) for _ in range(16)])
    astate, ares = frozen.tick_n(frozen.init(seed=3), *_stack(batches))
    fstate, fres = fixed.tick_n(fixed.init(seed=3), *_stack(batches))
    assert astate.kind == "sharded" and astate.ctl.n_switches == 0
    for a, f in zip(ares, fres):
        assert torch.equal(a, f)
    for a, f in zip(pqueue.tree_leaves(astate.inner),
                    pqueue.tree_leaves(fstate)):
        assert torch.equal(a, f)


def test_tick_n_chunks_equal_single_ticks():
    """tick_n over calls that cross window boundaries (chunks of 5, 3,
    8, 8 ticks) equals the same ticks one at a time."""
    rng = np.random.default_rng(8)
    batches = ([_batch(_uniform_keys(rng, 64), 0)]
               + [_batch(_uniform_keys(rng), 32) for _ in range(23)])
    eng = _port_engine()
    s1 = eng.init(seed=0)
    s1, _ = eng.tick_n(s1, *_stack(batches[:5]))
    s1, r1 = eng.tick_n(s1, *_stack(batches[5:]))
    s2 = eng.init(seed=0)
    rows = []
    for b in batches:
        s2, r = eng.tick(s2, *b)
        rows.append(r)
    assert r1.rm_keys.shape == (19, eng.out_w)
    for i, field in enumerate(r1):
        assert torch.equal(field, torch.stack([r[i] for r in rows[5:]]))
    # the window sums are f32 sums per chunk, so chunking moves their
    # last bits (as in the reference); every other field is exact
    _assert_ctl_equal(s1.ctl, _as_plain(s2.ctl), "chunked")
    assert s1.kind == s2.kind
    for a, b in zip(pqueue.tree_leaves(s1.inner),
                    pqueue.tree_leaves(s2.inner)):
        assert torch.equal(a, b)


def test_cloned_state_replays_the_same_decisions():
    eng = _port_engine()
    rng = np.random.default_rng(7)
    batches = ([_batch(_uniform_keys(rng, 64), 0)]
               + [_batch(_uniform_keys(rng), 32) for _ in range(31)])
    state, _ = eng.tick_n(eng.init(seed=0), *_stack(batches[:8]))
    copy = dataclasses.replace(state,
                               inner=pqueue.tree_map(torch.clone,
                                                     state.inner))
    assert isinstance(copy, AdaptiveState) and copy.ctl == state.ctl
    s1, r1 = eng.tick_n(state, *_stack(batches[8:]))
    s2, r2 = eng.tick_n(copy, *_stack(batches[8:]))
    assert s1.ctl == s2.ctl and s1.kind == s2.kind
    assert s1.ctl.n_switches == 1 and s1.kind == "pqe"
    assert torch.equal(r1.rm_keys, r2.rm_keys)


def test_protocol_surface_and_relax_bound():
    eng = _port_engine()
    ref = _ref_engine()
    assert isinstance(eng, AdaptiveEngine) and isinstance(eng, QueueEngine)
    assert eng.kind == "adaptive" and eng.width == W
    assert eng.out_w == ref.out_w
    for r in (0, 1, 8, W):
        assert eng.relax_bound(r) == ref.relax_bound(r) \
            == tshq.relax_bound(eng.cfg, r)
    state = eng.init(seed=0)
    eng.prewarm(state, 20)
    rng = np.random.default_rng(8)
    state, res = eng.tick(state, *_batch(_uniform_keys(rng), 4))
    assert res.rm_keys.shape == (eng.out_w,)
    assert int(res.rm_served.sum()) == 4 and int(eng.size(state)) == 28
    assert int(eng.stats(state).n_ticks) == 1
    assert eng.controller_stats(state)["engine"] == "sharded"
    with pytest.raises(ValueError, match="cuda device"):
        make_engine(EngineSpec(engine="adaptive", width=W, lanes=4),
                    device="cpu")


def test_quality_budget_caps_lane_ceiling():
    """The cases of tests/test_quality.py: budget 0 folds the ceiling to
    the exact L=1 engine; the tighter of the spec's and the controller's
    budgets wins; the caps equal the reference's."""
    eng = make_engine(EngineSpec(engine="adaptive", width=W, lanes=8,
                                 quality_budget=0.0, backend="torch"),
                      device="cpu")
    assert eng.max_lanes == 1 and eng.min_lanes == 1
    eng = make_engine(EngineSpec(
        engine="adaptive", width=W, lanes=8, quality_budget=1e9,
        backend="torch", controller=ControllerConfig(quality_budget=0.0)),
        device="cpu")
    assert eng.max_lanes == 1
    for budget in (None, 0.0, 3.0 * W, 1e9):
        for min_lanes in (None, 1, 2):
            t = make_engine(EngineSpec(
                engine="adaptive", width=W, lanes=8, min_lanes=min_lanes,
                quality_budget=budget, backend="torch"), device="cpu")
            j = j_make_engine(JSpec(engine="adaptive", width=W, lanes=8,
                                    min_lanes=min_lanes,
                                    quality_budget=budget))
            assert (t.max_lanes, t.min_lanes, t.out_w) == \
                (j.max_lanes, j.min_lanes, j.out_w)
            assert t.cfg.lane.a_max == j.cfg.lane.a_max
