"""The port's fault tolerance against the JAX package's.

* The copied modules give the reference's outputs: ``FailureDetector``
  over a scripted fleet, ``FaultSchedule.seeded`` events, ``parse_chaos``
  (spec strings and ``PQ_CHAOS``), ``FaultInjector.step`` verdicts over 30
  steps, ``lane_weights``, ``CostEma.weights`` and the straggler
  ``simulate()``.
* ``ElasticDistQueue`` at D=1 on the slow-then-kill schedule of
  tests/test_ft.py, under the reference's replayed routes: on every step
  the result, ``info``, the clock, the detector's verdicts,
  ``capacity_scale()`` and every state leaf (``disp_ema`` within a
  relative 1e-6) equal the reference's; with a ``ControllerConfig`` also
  the ``LaneScaleController``'s latches and ``lane_scale``.
* ``LaneScaleController`` alone at 8 lanes folding to 2, on a stream that
  latches the balanced-dispersed regime: ``lane_scale``, counts and
  latches exactly every tick, the float sums within a relative 1e-6.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.adaptive import ControllerConfig as JCtlCfg
from repro.core.adaptive import LaneScaleController as JLaneScale
from repro.core.config import PQConfig as JPQConfig
from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import make_engine as j_make_engine
from repro.ft import CostEma as JCostEma
from repro.ft import ElasticDistQueue as JElastic
from repro.ft import FailureDetector as JDetector
from repro.ft import FaultEvent as JEvent
from repro.ft import FaultInjector as JInjector
from repro.ft import FaultSchedule as JSchedule
from repro.ft import SimClock as JClock
from repro.ft import lane_weights as j_lane_weights
from repro.ft import parse_chaos as j_parse_chaos
from repro.ft.straggler import simulate as j_simulate
from repro_torch.core import PQConfig
from repro_torch.core.adaptive import ControllerConfig, LaneScaleController
from repro_torch.core.config import EMPTY_VAL
from repro_torch.core.factory import EngineSpec, make_engine
from repro_torch.core.interop import dist_state_to_numpy
from repro_torch.ft import (CostEma, ElasticDistQueue, FailureDetector,
                            FaultEvent, FaultInjector, FaultSchedule,
                            SimClock, lane_weights, parse_chaos)
from repro_torch.ft.straggler import simulate
from test_adaptive import _batch, _clustered_keys, _uniform_keys
from test_torch_adaptive import _as_plain, replay_routes
from test_torch_sharded import _DISP_EMA, _bits, ref_leaves
from torch_serving_ref import record_routes


def _events(sched):
    return [dataclasses.astuple(e) for e in sched.events]


def test_failure_detector_matches_reference():
    rng = np.random.default_rng(0)
    fds = [cls(range(5), suspect_after=2.0, dead_after=5.0, now=0.0)
           for cls in (FailureDetector, JDetector)]
    for t in range(40):
        now = t * 0.5
        for w in range(7):          # 5 and 6 join late
            if rng.random() < 0.6:
                for fd in fds:
                    fd.beat(w, now)
        if t == 20:
            for fd in fds:
                fd.declare_dead(1)
        got, want = (fd.check(now) for fd in fds)
        assert got == want, t
        assert fds[0].alive() == fds[1].alive()
        assert fds[0].table.last_seen == fds[1].table.last_seen
    with pytest.raises(ValueError):
        FailureDetector([0], suspect_after=3.0, dead_after=1.0)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_seeded_schedule_matches_reference(seed):
    for kw in (dict(n_kill=1), dict(n_kill=2, n_slow=2, n_partition=1),
               dict(n_kill=0, n_slow=3, slow_factor=2.5, window=3.0,
                    horizon=40.0)):
        assert _events(FaultSchedule.seeded(seed, 8, **kw)) == _events(
            JSchedule.seeded(seed, 8, **kw))
    with pytest.raises(ValueError):
        FaultSchedule.seeded(seed, 2, n_kill=3)


def test_parse_chaos_matches_reference(monkeypatch):
    for spec in ("kill:3@8", "kill:3@8, slow:1x4@5-20, part:5@2-6",
                 "partition:2@1.5", "slow:0x2.5@3", "seed:7:2",
                 "seed:3, kill:0@1", ""):
        got = parse_chaos(spec, n_devices=8)
        want = j_parse_chaos(spec, n_devices=8)
        assert (got is None) == (want is None), spec
        if got is not None:
            assert _events(got) == _events(want), spec
    for bad in ("explode:1@2", "seed:4"):
        with pytest.raises(ValueError):
            parse_chaos(bad)
        with pytest.raises(ValueError):
            j_parse_chaos(bad)
    monkeypatch.setenv("PQ_CHAOS", "kill:1@10,slow:0x3@2-9")
    assert _events(parse_chaos()) == _events(j_parse_chaos())


def test_fault_injector_matches_reference():
    def run(clock_cls, event_cls, sched_cls, det_cls, inj_cls):
        clock = clock_cls()
        sched = sched_cls([event_cls("kill", 0, 4.0),
                           event_cls("slow", 1, 1.0, 20.0, factor=3.0),
                           event_cls("partition", 2, 3.0, 9.0),
                           event_cls("partition", 3, 12.0, 40.0)])
        det = det_cls(range(5), suspect_after=2.0, dead_after=6.0)
        inj = inj_cls(sched, det, clock, base_cost=1.5)
        out = []
        for _ in range(30):
            out.append(inj.step())
            clock.advance(1.0)
        return out, det.alive()

    got = run(SimClock, FaultEvent, FaultSchedule, FailureDetector,
              FaultInjector)
    want = run(JClock, JEvent, JSchedule, JDetector, JInjector)
    assert got == want
    assert any(v["dead"] for v in got[0]) and any(
        v["suspected"] for v in got[0])


def test_lane_weights_and_cost_ema_match_reference():
    w = [1.0, 0.5, 0.25]
    np.testing.assert_array_equal(lane_weights(w, 3), j_lane_weights(w, 3))
    rng = np.random.default_rng(3)
    emas = [CostEma(5, decay=0.3, floor=0.2),
            JCostEma(5, decay=0.3, floor=0.2)]
    for _ in range(20):
        costs = {int(d): float(rng.uniform(0.5, 6.0))
                 for d in rng.choice(5, int(rng.integers(0, 5)), False)}
        for ema in emas:
            ema.update(costs)
        for devs in (None, [0, 2, 4], [3]):
            got, want = (ema.weights(devs) for ema in emas)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for bad in (dict(decay=0.0), dict(floor=1.5)):
        with pytest.raises(ValueError):
            CostEma(2, **bad)


def test_straggler_simulation_matches_reference():
    kw = dict(n_items=32, n_workers=5, straggler=2, slow_factor=3.0, seed=4)
    got = simulate(device="cpu", backend="torch", **kw)
    assert got == j_simulate(**kw)
    assert got["pq"] < got["static"] * 0.7, got


# ---------------------------------------------------------------------------
# the elastic queue at D=1 against the reference
# ---------------------------------------------------------------------------

W = 64


def _base(cls, **kw):
    return cls(a_max=W, r_max=W, seq_cap=4 * W + 2, n_buckets=8,
               bucket_cap=W, detach_min=8, detach_max=256, detach_init=8,
               chop_patience=64, **kw)


def _schedule(event_cls, sched_cls):
    """tests/test_ft.py: slow on [2, 8), then killed at 10."""
    return sched_cls([event_cls("slow", 0, 2.0, 8.0, factor=4.0),
                      event_cls("kill", 0, 10.0)])


ELASTIC_KW = dict(seed=0, suspect_after=2.0, dead_after=4.0,
                  collective_timeout=1.0, max_retries=2)


def _steps(n=16):
    rng = np.random.default_rng(0)
    out = []
    for r in range(n):
        p = 0.25 if r % 4 else 0.6
        ak = rng.uniform(0, 100, W).astype(np.float32)
        m = rng.random(W) < p
        av = np.where(m, np.arange(W, dtype=np.int32), EMPTY_VAL).astype(
            np.int32)
        out.append((np.where(m, ak, np.inf).astype(np.float32), av, m,
                    int(rng.integers(4, 24))))
    return out


def _ctl_view(ctl):
    return None if ctl is None else _as_plain(ctl.ctl)


@pytest.fixture(scope="module")
def reference_elastic_runs():
    runs = {}
    q = j_make_engine(JSpec(engine="dist", width=W, base=_base(
        JPQConfig, backend="jnp"), lanes=4, n_devices=1, lanes_per_device=4))
    for name, ctl in CONTROLLERS.items():
        def run():
            jctl = (None if ctl is None
                    else JCtlCfg(**dataclasses.asdict(ctl)))
            e = JElastic(q, schedule=_schedule(JEvent, JSchedule),
                         controller=jctl, **ELASTIC_KW)
            ticks = []
            for ak, av, m, rm in _steps():
                res, info = e.step(jnp.asarray(ak), jnp.asarray(av),
                                   jnp.asarray(m), jnp.asarray(rm, jnp.int32))
                ticks.append(dict(
                    res=[np.asarray(x) for x in res], info=info,
                    now=e.clock.now, dead=set(e.detector.dead),
                    suspected=set(e.detector.suspected),
                    scale=e.capacity_scale(), leaves=ref_leaves(e.state),
                    ctl=_ctl_view(e.controller)))
            return ticks
        runs[name] = record_routes(run)
    return runs


CONTROLLERS = {"no_controller": None,
               "controller": ControllerConfig(window=2, confirm=1)}


@pytest.mark.parametrize("name", list(CONTROLLERS))
def test_elastic_bit_equal_to_reference(name, reference_elastic_runs,
                                        monkeypatch):
    want, routes = reference_elastic_runs[name]
    replay_routes(monkeypatch, routes)
    q = make_engine(EngineSpec(engine="dist", width=W,
                               base=_base(PQConfig, backend="torch"),
                               lanes=4, n_devices=1, lanes_per_device=4),
                    device="cpu")
    e = ElasticDistQueue(q, schedule=_schedule(FaultEvent, FaultSchedule),
                         controller=CONTROLLERS[name], **ELASTIC_KW)
    for t, ((ak, av, m, rm), w) in enumerate(zip(_steps(), want)):
        res, info = e.step(torch.from_numpy(ak), torch.from_numpy(av),
                           torch.from_numpy(m), rm)
        for g, x in zip(res, w["res"]):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(x),
                                          err_msg=f"step {t}")
        assert {k: v for k, v in info.items() if k != "weights"} == {
            k: v for k, v in w["info"].items() if k != "weights"}, t
        np.testing.assert_array_equal(info["weights"], w["info"]["weights"])
        assert (e.clock.now, set(e.detector.dead), set(e.detector.suspected),
                e.capacity_scale()) == (w["now"], w["dead"], w["suspected"],
                                        w["scale"]), t
        for i, (g, x) in enumerate(zip(dist_state_to_numpy(e.state),
                                       w["leaves"])):
            if i == _DISP_EMA:
                np.testing.assert_allclose(g, x, rtol=1e-6)
            else:
                np.testing.assert_array_equal(_bits(g), _bits(x),
                                              err_msg=f"step {t} leaf {i}")
        if w["ctl"] is not None:
            got = _ctl_view(e.controller)
            for k, x in w["ctl"].items():
                if k.startswith(("acc_", "balance_ema", "disp_ema")):
                    np.testing.assert_allclose(got[k], x, rtol=1e-6)
                else:
                    assert got[k] == x, (t, k)
    assert e.live == [0] and e.clock.now > len(want) + 2
    assert e.size() == int(q.size(e.state))


def _latching_stream(rng, n):
    """The streams of tests/test_adaptive.py: balanced uniform ticks (the
    balanced-dispersed regime), then clustered adds with no removes."""
    for t in range(n):
        if t < n // 2:
            ak, _, m, rm = _batch(_uniform_keys(rng), 32)
        else:
            ak, _, m, rm = _batch(_clustered_keys(rng), 0)
        yield ak, m, int(rm)


def test_lane_scale_controller_matches_reference():
    cfg = dict(window=3, confirm=1, cooldown=0)
    got = LaneScaleController(ControllerConfig(**cfg), 8, 2, floor=0.3)
    want = JLaneScale(JCtlCfg(**cfg), 8, 2, floor=0.3)
    scales = set()
    for t, (k, m, rm) in enumerate(_latching_stream(
            np.random.default_rng(1), 48)):
        got.observe(torch.from_numpy(k), torch.from_numpy(m), rm)
        want.observe(jnp.asarray(k), jnp.asarray(m), rm)
        np.testing.assert_array_equal(got.lane_scale(), want.lane_scale())
        assert got.lane_scale().dtype == np.float32
        g, w = _as_plain(got.ctl), _as_plain(want.ctl)
        for key, x in w.items():
            if key.startswith(("acc_bal", "acc_disp")) and not key.endswith(
                    "_n") or key in ("balance_ema", "disp_ema"):
                np.testing.assert_allclose(g[key], x, rtol=1e-6)
            else:
                assert g[key] == x, (t, key)
        scales.add(tuple(got.lane_scale().tolist()))
    assert len(scales) == 2      # latched in, then out
    frozen = LaneScaleController(ControllerConfig(freeze=True, **cfg), 8, 2)
    for k, m, rm in _latching_stream(np.random.default_rng(1), 24):
        frozen.observe(k, m, rm)
    assert (frozen.lane_scale() == 1).all()
