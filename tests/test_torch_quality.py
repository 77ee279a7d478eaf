"""The port's quality layer (``repro_torch.quality``) against the JAX
package's.

* ``RankErrorMeter`` and ``replay`` (copied, numpy only) give the
  reference's summary dict exactly on seeded streams: exact and relaxed
  serves, duplicate keys, a settle window, and the conservation error.
* ``measure_engine`` on the port's pqe engine gives the reference's
  summary (``us_per_tick`` aside); on the sharded engine at L=2 under the
  reference's routes, the reference's summary too; port sharded engines
  stay within the envelope ``relax_bound(r) - r``.
* ``tune_lanes``: budget 0 gives L=1, an unbounded budget the full
  ladder, and the result respects the budget.
* The net-filling stream of tests/test_quality.py sheds the same number
  of keys in the port as in the reference.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sharded as jshq
from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import make_engine as j_make_engine
from repro.quality import harness as jh
from repro.quality import tuner as jt
from repro_torch.core import PQConfig
from repro_torch.core import sharded as tshq
from repro_torch.core.factory import EngineSpec, default_base, make_engine
from repro_torch.quality import (SUMMARY_KEYS, RankErrorMeter,
                                 measure_engine, probe_stream, replay,
                                 tune_lanes, warm_keys)
from repro_torch.quality import tuner

W = 64


def _meter_stream(rng, ticks, dup):
    """A served stream off an imaginary relaxed engine: each tick serves
    some of the smallest live keys, skipping a few."""
    live = list(rng.uniform(0, 100, 40).round(1 if dup else 4))
    warm = list(live)
    for _ in range(ticks):
        adds = rng.uniform(0, 100, int(rng.integers(0, 8))).round(
            1 if dup else 4)
        live = sorted(live + list(adds))
        rm = int(rng.integers(0, 6))
        pick = [i for i in range(min(len(live), rm + 3))
                if rng.uniform() < 0.7][:rm]
        served = [live[i] for i in pick]
        for i in sorted(pick, reverse=True):
            live.pop(i)
        yield warm, adds, served, rm


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("record_from", [0, 5])
def test_meter_and_replay_equal_reference(dup, record_from):
    rng = np.random.default_rng(10 + dup)
    stream = list(_meter_stream(rng, 30, dup))
    warm = stream[0][0]
    metres = []
    for Meter in (RankErrorMeter, jh.RankErrorMeter):
        m = Meter()
        m.preload(warm)
        for t, (_, adds, served, rm) in enumerate(stream):
            m.observe(adds, served, rm, record=t >= record_from)
        metres.append(m)
    got, want = (m.summary() for m in metres)
    assert got == want and set(got) == set(SUMMARY_KEYS)
    np.testing.assert_array_equal(metres[0].rank_errors(),
                                  metres[1].rank_errors())
    np.testing.assert_array_equal(metres[0].staleness(),
                                  metres[1].staleness())
    assert got["n_served"] > 0 and (dup or got["rank_err_max"] > 0)

    # the same stream stacked, through replay
    T, w = len(stream), 8
    ak = np.full((T, w), np.inf, np.float32)
    am = np.zeros((T, w), bool)
    rk = np.full((T, w), np.inf, np.float32)
    rs = np.zeros((T, w), bool)
    rc = np.zeros(T, np.int64)
    for t, (_, adds, served, rm) in enumerate(stream):
        ak[t, :len(adds)], am[t, :len(adds)] = adds, True
        rk[t, :len(served)], rs[t, :len(served)] = served, True
        rc[t] = rm
    warm32 = np.asarray(warm, np.float32)
    kw = dict(warm_keys=warm32, record_from=record_from)
    assert replay(ak, am, rk, rs, rc, **kw) == jh.replay(ak, am, rk, rs, rc,
                                                         **kw)


def test_meter_errors_equal_reference():
    for Meter in (RankErrorMeter, jh.RankErrorMeter):
        m = Meter()
        m.preload([1.0, 2.0])
        with pytest.raises(ValueError, match="conserve"):
            m.observe([], [7.0], 1)
        m = Meter()
        m.observe([1.0], [], 0)
        with pytest.raises(ValueError, match="preload"):
            m.preload([2.0])
    m = RankErrorMeter()
    m.preload([5.0, 5.0, 5.0, 9.0])
    m.observe([5.0], [5.0, 5.0], 2)
    assert m.summary()["rank_err_max"] == 0 and len(m) == 3


def _port_engine(**kw):
    return make_engine(EngineSpec(width=W, backend="torch", **kw),
                       device="cpu")


def test_measure_engine_pqe_equals_reference():
    warm = warm_keys(200)
    np.testing.assert_array_equal(warm, jt.warm_keys(200))
    ak, av, am, rc = probe_stream(W, 0.5, 10)
    for a, b in zip((ak, av, am, rc), jt.probe_stream(W, 0.5, 10)):
        np.testing.assert_array_equal(a, b)
    got = measure_engine(_port_engine(engine="pqe"), ak, av, am, rc,
                         warm_keys=warm, record_from=2)
    want = jh.measure_engine(j_make_engine(JSpec(engine="pqe", width=W)),
                             ak, av, am, rc, warm_keys=warm, record_from=2)
    assert got.pop("us_per_tick") > 0 and want.pop("us_per_tick") > 0
    assert got == want
    assert got["n_served"] > 0 and got["rank_err_max"] == 0
    assert got["stale_max"] == 0


def test_measure_engine_sharded_equals_reference_under_its_routes(
        monkeypatch):
    """The reference's sharded engine at L=2, its routes recorded on the
    ticks that draw, replayed into the port's router."""
    warm = warm_keys(200)
    ak, av, am, rc = probe_stream(W, 0.5, 12, key_dist="des")
    routes = []
    tick = jshq.tick

    def recording_tick(cfg, state, *args):
        t0 = int(state.tick_idx)
        out = tick(cfg, state, *args)
        if t0 % cfg.stick == 0:
            routes.append(np.array(out[0].route))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshq, "tick", recording_tick)
        want = jh.measure_engine(
            j_make_engine(JSpec(engine="sharded", width=W, lanes=2,
                                backend="jnp")),
            ak, av, am, rc, warm_keys=warm)
    it = iter(routes)
    monkeypatch.setattr(tshq, "_fresh_route", lambda *a: torch.tensor(
        next(it), dtype=torch.int32, device=a[-1]))
    got = measure_engine(_port_engine(engine="sharded", lanes=2), ak, av,
                         am, rc, warm_keys=warm)
    assert next(it, None) is None and len(routes) >= 2
    del got["us_per_tick"], want["us_per_tick"]
    assert got == want


@pytest.mark.parametrize("lanes", [2, 8])
def test_relaxed_engines_within_envelope(lanes):
    eng = _port_engine(engine="sharded", lanes=lanes)
    warm = warm_keys(200)
    ak, av, am, rc = probe_stream(W, 0.5, 10)
    s = measure_engine(eng, ak, av, am, rc, warm_keys=warm)
    n_rm = int(rc[0])
    assert s["n_served"] > 0
    assert s["rank_err_max"] <= eng.relax_bound(n_rm) - n_rm, s


@pytest.mark.parametrize("spec_kw", [
    dict(engine="sharded", lanes=1, preroute="off"),
    dict(engine="fcskiplist"),
    dict(engine="adaptive", lanes=4),
])
def test_other_engines_score(spec_kw):
    """Exact engines score zero; the adaptive engine's serves stay within
    its worst-case envelope."""
    eng = _port_engine(**spec_kw)
    ak, av, am, rc = probe_stream(W, 0.5, 10)
    s = measure_engine(eng, ak, av, am, rc, warm_keys=warm_keys(200))
    assert s["n_served"] > 0
    n_rm = int(rc[0])
    assert s["rank_err_max"] <= eng.relax_bound(n_rm) - n_rm, s
    if spec_kw["engine"] != "adaptive":
        assert s["rank_err_max"] == 0 and s["stale_max"] == 0, s


_TUNE = dict(width=256, p_add=0.3, key_dist="des", lanes_max=8, ticks=6,
             settle=2, base=dataclasses.replace(default_base(256),
                                                backend="torch"),
             device="cpu")


def test_tuner_budget_zero_forces_exact():
    r = tune_lanes(budget=0.0, **_TUNE)
    assert r.lanes == 1 and r.value == 0.0


def test_tuner_unbounded_budget_takes_full_ladder():
    r = tune_lanes(budget=1e9, **_TUNE)
    assert r.lanes == 8
    assert [t[0] for t in r.trace] == [1, 2, 4, 8]
    assert tuner._lane_ladder(8, 1) == jt._lane_ladder(8, 1)
    assert tuner._lane_ladder(6, 3) == jt._lane_ladder(6, 3)


def test_tuner_result_respects_budget():
    budget = 40.0
    r = tune_lanes(budget=budget, **_TUNE)
    assert r.value <= budget and r.metric == "rank_err_p99"
    lanes = [t[0] for t in r.trace]
    assert lanes == sorted(lanes)
    assert tune_lanes.__kwdefaults__["device"] == "cuda"


def _tiny_pqe(port):
    kw = dict(a_max=32, r_max=32, seq_cap=128, n_buckets=4, bucket_cap=16,
              detach_min=8, detach_max=64, detach_init=16)
    if port:
        return make_engine(EngineSpec(engine="pqe", width=32,
                                      base=PQConfig(backend="torch", **kw)),
                           device="cpu")
    from repro.core import PQConfig as JConfig
    return j_make_engine(JSpec(engine="pqe", width=32, base=JConfig(**kw)))


def _run_ticks(eng, ticks, rm_count, rng, port):
    state = eng.init(seed=0)
    n_in = n_served = 0
    for _ in range(ticks):
        ak = rng.uniform(0, 100, 32).astype(np.float32)
        batch = (ak, np.zeros(32, np.int32), np.ones(32, bool), rm_count)
        if not port:
            batch = tuple(jnp.asarray(x) for x in batch)
        state, res = eng.tick(state, *batch)
        n_in += 32
        n_served += int(np.asarray(res.rm_served).sum())
    _, _, live = eng.resident(state)
    return n_in, n_served, int(np.asarray(live).sum())


@pytest.mark.parametrize("rm_count", [0, 28])
def test_net_filling_stream_sheds_as_reference(rm_count):
    """20 add-only ticks overflow the finite structure and shed keys
    silently; a balanced mix conserves.  The port sheds exactly as many
    keys as the reference."""
    ticks = 20 if rm_count == 0 else 10
    got = _run_ticks(_tiny_pqe(True), ticks, rm_count,
                     np.random.default_rng(0), True)
    want = _run_ticks(_tiny_pqe(False), ticks, rm_count,
                      np.random.default_rng(0), False)
    assert got == want
    n_in, n_served, resident = got
    if rm_count == 0:
        assert n_served == 0 and resident < n_in
    else:
        assert n_served > 0 and n_in - n_served - resident == 0
