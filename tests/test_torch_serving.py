"""The port's request engine against the JAX package's.

* The copied modules give the reference's outputs: the ``wave()``
  sequences of the three arrival patterns, ``AdmissionController.admit``
  / ``flush`` decisions, and the quality-relaxed ``ServeDeferrer`` quotas.
* ``run_sla`` at D=1 for the cells ``serve_steady``, ``serve_over``,
  ``serve_burst`` and ``serve_relaxed`` of benchmarks/serve_bench.py (their
  kwargs, with fewer ticks), under the reference's replayed routes: the
  request ids served on every tick and the whole report (every count,
  ``shed_reasons``, p50 / p99 / p999 in simulated ticks, live devices)
  equal the reference's.
* ``serve_chaos`` at D=2 with its kill of device 1 at t=10: the reference
  runs in a subprocess with two forced host devices
  (tests/torch_serving_ref.py), and the port on a two-position CPU mesh
  under the routes it drew gives the same served ids and report.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serving import arrivals as jarr
from repro.serving import scheduler as jsch
from repro.ft.inject import SimClock as JClock
from repro_torch.core import sharded as tshq
from repro_torch.ft.inject import SimClock, parse_chaos
from repro_torch.serving import RequestEngine, arrivals, build_engine
from repro_torch.serving import run_sla, scheduler
from torch_serving_ref import record_served, run_reference, run_sla_cell

ROOT = Path(__file__).resolve().parents[1]

#: benchmarks/serve_bench.py's shared kwargs
SERVE = dict(lanes_per_device=2, width=64, n_slots=8, seed=0, depth_cap=48)

#: serve_bench.py's cells at D=1, tick counts cut from 300 / 500 / 300 /
#: 300 to keep the test fast
CELLS = {
    "serve_steady": dict(rho=0.7, pattern="poisson", ticks=80),
    "serve_over": dict(rho=1.5, pattern="poisson", ticks=100),
    "serve_burst": dict(rho=1.0, pattern="bursty", ticks=100,
                        burst_factor=4.0),
    "serve_relaxed": dict(rho=0.7, pattern="poisson", ticks=80,
                          quality=dict(max_defer=3, defer_frac=0.5)),
}


def _requests(wave):
    return [(r.rid, r.arrival, r.deadline, r.retries) for r in wave]


@pytest.mark.parametrize("pattern,kw", [
    ("PoissonArrivals", dict()),
    ("PoissonArrivals", dict(p_urgent=0.2, urgent_sla=0.5)),
    ("BurstyArrivals", dict(burst_factor=3.0, mean_on=3.0, mean_off=6.0)),
    ("DiurnalArrivals", dict(period=30.0, amplitude=0.9, sla_min=5.0))])
def test_arrival_waves_match_reference(pattern, kw):
    streams = []
    for mod, clock_cls in ((arrivals, SimClock), (jarr, JClock)):
        clock = clock_cls()
        proc = getattr(mod, pattern)(6.0, clock=clock, seed=3, **kw)
        waves = []
        for _ in range(60):
            waves.append(_requests(proc.wave()))
            clock.advance(1.0)
        streams.append((waves, proc.next_rid, proc.n_generated))
    assert streams[0] == streams[1]
    assert sum(map(len, streams[0][0])) > 100


def _admission_run(mod, rng_seed, max_retries):
    rng = np.random.default_rng(rng_seed)
    ctl = mod.AdmissionController(mod.OverloadPolicy(
        depth_cap=24, serve_rate=4.0, slack=1.2, max_retries=max_retries))
    inflight, log, rid = [], [], 0
    for t in range(40):
        now = float(t)
        ctl.set_capacity_scale(float(rng.choice([1.0, 1.0, 0.5])))
        wave = []
        for _ in range(int(rng.integers(0, 16))):
            wave.append(mod.Request(rid, now, now + float(rng.uniform(
                0.5, 60.0))))
            rid += 1
        admitted, shed = ctl.admit(wave, np.sort(np.asarray(inflight)),
                                   len(inflight), now, max_admit=8)
        inflight += [r.deadline for r in admitted]
        served = int(rng.integers(0, 4))
        inflight = sorted(inflight)[served:]
        log.append((_requests(admitted),
                    [(e.request.rid, e.reason, e.time) for e in shed],
                    ctl.pending, ctl.effective_rate, ctl.n_retried))
    flushed = [(e.request.rid, e.reason) for e in ctl.flush(40.0)]
    return log, flushed, dict(ctl.shed_reasons), ctl.n_offered


@pytest.mark.parametrize("max_retries", [0, 2])
def test_admission_matches_reference(max_retries):
    got = _admission_run(scheduler, 5, max_retries)
    assert got == _admission_run(jsch, 5, max_retries)
    reasons = got[2]
    assert reasons["infeasible"] > 0
    # a depth shed retries while the budget lasts, then sheds as "retry"
    assert reasons["retry" if max_retries else "depth"] > 0, reasons


def test_serve_deferrer_matches_reference():
    rng = np.random.default_rng(2)
    pols = [mod.ServeDeferrer(mod.QualityPolicy(max_defer=3,
                                                defer_frac=0.5))
            for mod in (scheduler, jsch)]
    for t in range(60):
        depth = int(rng.integers(0, 30))
        dl = np.sort(rng.uniform(t, t + 60.0, depth))
        args = (dl, float(t), float(rng.choice([8.0, 4.0])), 1.0, 8, depth)
        assert pols[0].quota(*args) == pols[1].quota(*args), t
    assert pols[0].report() == pols[1].report()
    assert pols[0].report()["deferred_ticks"] > 0


def replay(routes, fn):
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


def run_port(kw, routes):
    return replay(routes, lambda: record_served(RequestEngine, lambda: (
        run_sla_cell(build_engine, run_sla, parse_chaos,
                     dict(kw, device="cpu", backend="torch")))))


@pytest.mark.parametrize("cell", list(CELLS))
def test_run_sla_matches_reference(cell):
    kw = dict(SERVE, n_devices=1, **CELLS[cell])
    want, want_served, routes = run_reference(kw)
    got, served = run_port(kw, routes)
    assert served == want_served
    assert got == want
    assert got["served"] + got["shed"] + got["expired"] == got["arrivals"]
    if cell in ("serve_over", "serve_burst"):
        assert got["shed"] > 0
    if cell == "serve_relaxed":
        assert got["deferred_ticks"] > 0


def test_run_sla_with_a_kill_on_two_devices_matches_reference():
    """serve_chaos: D=2, kill:1@10, spare_devices=1, 120 ticks."""
    kw = dict(SERVE, n_devices=2, rho=0.9, pattern="poisson", ticks=120,
              chaos="kill:1@10", spare_devices=1)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_serving_ref.py"),
         json.dumps(kw)], capture_output=True, text=True, env=env,
        timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    got, served = run_port(kw, ref["routes"])
    assert served == ref["served"]
    assert got == ref["report"]
    assert got["live_devices"] == [0]
