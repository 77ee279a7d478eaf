"""The port's examples (``repro_torch.examples``) against the JAX
package's scripts of the same name, on the CPU.

* ``event_sim``: every tick's served keys and the final state bit-equal
  to ``examples/event_sim.py``'s; the returned numbers are the ones it
  prints.
* ``dev_check_pq.run``: ``scripts/dev_check_pq.py``'s ``run`` on the same
  config and seed passes in both, and the final states are bit-equal.
* ``quickstart``: held against the reference script's parts (its
  ``pallas_interpret`` tick costs more than the test should): the pqe
  engine's inserts, combined tick and breakdown, the backend section's
  8 smallest, and ``measure_engine`` of pqe and of sharded L=4 under the
  reference's replayed routes, with the same rank-error figures.
* ``serve_requests.main`` and ``main_mesh`` at one position under the
  reference's replayed routes: the same request ids served on every tick
  and the same reports.
"""

import dataclasses
import importlib.util
import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import PQConfig as JPQConfig
from repro.core import sharded as jshq
from repro.core import distributed as jdq
from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import make_engine as j_make_engine
from repro.quality import measure_engine as j_measure_engine
from repro.quality import probe_stream as j_probe_stream
from repro.quality import warm_keys as j_warm_keys
from repro.serving import RequestEngine as JRequestEngine
from repro_torch.core import SMALL
from repro_torch.core import sharded as tshq
from repro_torch.core.interop import state_to_numpy
from repro_torch.examples import dev_check_pq, event_sim, quickstart
from repro_torch.examples import serve_requests
from repro_torch.serving import RequestEngine
from torch_serving_ref import _shared_tick, record_routes, record_served

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    """The reference script at ``rel`` as a module."""
    name = "ref_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _recording(tick, log):
    def run(cfg, state, *args):
        out = tick(cfg, state, *args)
        log.append(out)
        return out
    return run


def _served(res):
    keys, served = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
                    for x in (res.rm_keys, res.rm_served))
    return _bits(keys[served])


def _assert_state_equal(got, want):
    w_leaves = [np.asarray(x) for x in jax.tree.leaves(want)]
    g_leaves = state_to_numpy(got)
    assert len(g_leaves) == len(w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(i))


def _stats(state):
    return {k: int(v) for k, v in state.stats._asdict().items()}


def test_event_sim_matches_reference(monkeypatch):
    ref = _load("examples/event_sim.py")
    want, got = [], []
    monkeypatch.setattr(ref, "tick", _recording(ref.tick, want))
    ref.main()
    monkeypatch.setattr(event_sim, "tick", _recording(event_sim.tick, got))
    out = event_sim.main("cpu", "torch")
    assert len(got) == len(want) == 8 + 60
    for t, ((_, g), (_, w)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_served(g), _served(w), err_msg=str(t))
    _assert_state_equal(got[-1][0], want[-1][0])
    rounds = [np.asarray(r.rm_keys)[np.asarray(r.rm_served)]
              for _, r in want[8:]]
    assert out["processed"] == sum(len(k) for k in rounds) == 1920
    assert out["clock"] == float([k for k in rounds if len(k)][-1].max())
    assert out["stats"] == _stats(want[-1][0])
    assert out["stats"]["add_imm_elim"] + out["stats"]["add_upc_elim"] > 0


def _ref_tiny():
    return JPQConfig(**{f.name: getattr(dev_check_pq.TINY, f.name)
                        for f in dataclasses.fields(dev_check_pq.TINY)
                        if f.name != "backend"})


@pytest.mark.parametrize("which,seed,ticks", [
    ("small", 0, 60), ("small", 5, 60), ("tiny", 8, 80), ("tiny", 13, 80)])
def test_dev_check_run_matches_reference(which, seed, ticks, monkeypatch):
    ref = _load("scripts/dev_check_pq.py")
    if which == "small":
        jcfg, cfg = ref.SMALL, SMALL
    else:
        jcfg, cfg = _ref_tiny(), dev_check_pq.TINY
    cfg = dataclasses.replace(cfg, backend="torch")
    want, got = [], []
    monkeypatch.setattr(ref, "pq", types.SimpleNamespace(
        init=ref.pq.init, tick=_recording(ref.pq.tick, want)))
    assert ref.run(jcfg, seed, ticks) is True
    monkeypatch.setattr(dev_check_pq, "pq", types.SimpleNamespace(
        init=dev_check_pq.pq.init, tick=_recording(dev_check_pq.pq.tick,
                                                   got)))
    out = dev_check_pq.run(cfg, seed, ticks, device="cpu")
    assert out["ok"] and out["ticks"] == ticks == len(got) == len(want)
    for t, ((_, g), (_, w)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_served(g), _served(w), err_msg=str(t))
    _assert_state_equal(got[-1][0], want[-1][0])
    assert out["stats"] == _stats(want[-1][0])


def _reference_quickstart():
    """The reference script's sections, bar its pallas_interpret tick:
    its engine ticks on the same draws of the same generator, and its
    measure_engine calls, the sharded one's routes recorded."""
    base = JPQConfig(a_max=64, r_max=64, seq_cap=512, n_buckets=16,
                     bucket_cap=64, detach_min=8, detach_max=256,
                     detach_init=32)
    eng = j_make_engine(JSpec(engine="pqe", width=64, base=base))
    state = eng.init(seed=0)
    rng = np.random.default_rng(0)
    out = {}
    for b in range(3):
        keys = rng.uniform(0, 1000, 64).astype(np.float32)
        state, _ = eng.tick(state, keys, np.arange(64, dtype=np.int32)
                            + b * 64, np.ones((64,), bool), 0)
    out["inserted"] = dict(size=int(eng.size(state)),
                           min=float(state.min_value),
                           last_seq=float(state.last_seq),
                           detach_n=int(state.detach_n))
    keys = rng.uniform(0, 1000, 32).astype(np.float32)
    ak = np.full((64,), np.inf, np.float32)
    ak[:32] = keys
    mask = np.arange(64) < 32
    state, res = eng.tick(state, ak, np.arange(64, dtype=np.int32) + 1000,
                          mask, 32)
    out["served"] = np.sort(np.asarray(res.rm_keys)[np.asarray(
        res.rm_served)])
    out["stats"] = _stats(state)
    fkeys = rng.uniform(0, 1000, 64).astype(np.float32)
    out["backend_served"] = np.sort(fkeys)[:8]   # the script asserts this

    warm = j_warm_keys(200)
    ak, av, am, rc = j_probe_stream(64, 0.5, 10)
    routes, tick = [], jshq.tick

    def recording_tick(cfg, st, *args):
        t0 = int(st.tick_idx)
        o = tick(cfg, st, *args)
        if t0 % cfg.stick == 0:
            routes.append(np.array(o[0].route))
        return o

    out["quality"] = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jshq, "tick", recording_tick)
        for spec in (dict(engine="pqe", width=64, base=base),
                     dict(engine="sharded", width=64, lanes=4)):
            q = j_make_engine(JSpec(**spec))
            qs = j_measure_engine(q, ak, av, am, rc, warm_keys=warm)
            n_rm = int(rc[0])
            out["quality"][spec["engine"]] = dict(
                qs, envelope=q.relax_bound(n_rm) - n_rm)
    return out, routes


def test_quickstart_matches_reference_parts(monkeypatch):
    want, routes = _reference_quickstart()
    it = iter(routes)
    monkeypatch.setattr(tshq, "_fresh_route", lambda *a: torch.tensor(
        next(it), dtype=torch.int32, device=a[-1]))
    got = quickstart.main("cpu", "torch")
    assert next(it, None) is None and len(routes) >= 2
    assert got["inserted"] == want["inserted"]
    for k in ("served", "backend_served"):
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    assert got["stats"] == want["stats"]
    for kind in ("pqe", "sharded"):
        g, w = dict(got["quality"][kind]), dict(want["quality"][kind])
        assert g.pop("us_per_tick") > 0 and w.pop("us_per_tick") > 0
        assert g == w, kind
    assert got["quality"]["pqe"]["rank_err_max"] == 0
    assert got["quality"]["sharded"]["rank_err_max"] > 0


def _replay(routes, fn):
    """``fn()`` with the port's router drawing ``routes`` in order; every
    route must be used."""
    it = iter(routes)

    def fresh(seed, count, w, n_lanes, device):
        route = np.asarray(next(it), np.int32)
        assert route.shape == (w,) and int(route.max()) == n_lanes - 1
        return torch.tensor(route, dtype=torch.int32, device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tshq, "_fresh_route", fresh)
        out = fn()
    assert next(it, None) is None, "the port drew fewer routes"
    return out


def _reference_serve(entry, capsys):
    """One of the reference script's entry points at one device: its
    run_sla reports, the request ids served on every tick, the routes
    drawn and what it printed."""
    assert len(jax.devices()) == 1
    ref = _load("examples/serve_requests.py")
    reports, run_sla = [], ref.run_sla

    def recording_run_sla(eng, n):
        reports.append(run_sla(eng, n))
        return reports[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "run_sla", recording_run_sla)
        mp.setattr(jdq, "make_dist_tick", _shared_tick)
        (_, served), routes = record_routes(lambda: record_served(
            JRequestEngine, getattr(ref, entry)))
    return reports, served, routes, capsys.readouterr().out


def test_serve_requests_main_matches_reference(capsys):
    reports, want_served, routes, _ = _reference_serve("main", capsys)
    got, served = _replay(routes, lambda: record_served(
        RequestEngine, lambda: serve_requests.main("cpu", "torch")))
    assert served == want_served
    assert list(got.values()) == reports
    assert reports[1]["shed"] > 0 and reports[0]["shed"] == 0


def test_serve_requests_main_mesh_matches_reference(capsys):
    reports, want_served, routes, text = _reference_serve("main_mesh",
                                                          capsys)
    got, served = _replay(routes, lambda: record_served(
        RequestEngine, lambda: serve_requests.main_mesh(
            ["cpu"], device="cpu", backend="torch")))
    assert served == want_served
    assert [got["report"]] == reports
    elim, ticks = map(int, re.search(
        r"pre-route eliminations \(never routed\): (\d+) over (\d+) ticks",
        text).groups())
    assert (got["n_preroute_elim"], got["n_ticks"]) == (elim, ticks)
    assert got["removed"] == [] and max(got["urgent_latency"]) <= 1
    assert got["depth"] == 0


def test_serve_requests_main_mesh_kill_on_two_positions():
    """Two CPU positions with a scheduled kill: the example's own checks
    (exact partition, the kill fired, urgent requests within one tick)."""
    got = serve_requests.main_mesh(["cpu", "cpu"], chaos="kill:1@8",
                                   device="cpu", backend="torch")
    assert got["removed"] == [1] and got["n_kill"] == 1
    rep = got["report"]
    assert rep["served"] + rep["shed"] + rep["expired"] == rep["arrivals"]
    assert rep["live_devices"] == [0]
