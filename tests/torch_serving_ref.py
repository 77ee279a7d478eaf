"""Run the JAX package's serving stack and record what the port needs to
replay and check it: the report of ``repro.serving.run_sla``, the request
ids served on each tick, and every route the reference's router drew, in
draw order (resample ticks of the dist queue, and the fold of each
resize).

Imported by tests/test_torch_serving.py for runs on one device; run as a
script for a mesh of forced host devices, in a subprocess (the device
count locks at JAX's first use):

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        PYTHONPATH=src python tests/torch_serving_ref.py '<json kwargs>'

prints one JSON line ``{"report": ..., "served": [...], "routes": [...]}``
(the request ids served on each tick).
"""

import json
import sys

import numpy as np
import pytest

from repro.core import distributed as jdq
from repro.core import sharded as jshq


def record_routes(fn):
    """Call ``fn()`` with the reference's draws recorded; returns (its
    result, [routes as numpy arrays])."""
    routes = []
    tick, fold = jdq.DistShardedQueue.tick, jshq.fold_lanes

    def recording_tick(self, state, *args, **kw):
        draws = int(state.tick_idx) % self.cfg.shard.stick == 0
        out = tick(self, state, *args, **kw)
        if draws:
            routes.append(np.asarray(out[0].route))
        return out

    def recording_fold(cfg, state, keep):
        out = fold(cfg, state, keep)
        routes.append(np.asarray(out[1].route))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdq.DistShardedQueue, "tick", recording_tick)
        mp.setattr(jshq, "fold_lanes", recording_fold)
        out = fn()
    return out, routes


def record_served(engine_cls, fn):
    """Call ``fn()`` with every ``engine_cls.tick``'s served request ids
    recorded; returns (its result, [[rid, ...] per tick])."""
    served = []
    tick = engine_cls.tick

    def recording_tick(self, *args, **kw):
        out = tick(self, *args, **kw)
        served.append(out["served_rids"])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_cls, "tick", recording_tick)
        return fn(), served


def run_sla_cell(build_engine, run_sla, parse_chaos, kw):
    """``run_sla(build_engine(**kw), kw["ticks"])`` of either package
    (``kw["chaos"]``, if any, a ``PQ_CHAOS`` spec)."""
    kw = dict(kw)
    ticks = kw.pop("ticks")
    chaos = kw.pop("chaos", None)
    if chaos:
        kw["schedule"] = parse_chaos(chaos, n_devices=kw["n_devices"])
    return run_sla(build_engine(**kw), ticks)


#: the reference's jitted dist ticks by (config, mesh), shared by every
#: run of one process: each engine it builds would compile its own
_TICKS = {}


def _shared_tick(cfg, mesh, _make=jdq.make_dist_tick):
    if (cfg, mesh) not in _TICKS:
        _TICKS[cfg, mesh] = _make(cfg, mesh)
    return _TICKS[cfg, mesh]


def run_reference(kw):
    """The reference's run of :func:`run_sla_cell`: returns (report,
    served rids per tick, routes)."""
    from repro.ft.inject import parse_chaos
    from repro.serving import RequestEngine, build_engine, run_sla

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdq, "make_dist_tick", _shared_tick)
        (report, served), routes = record_routes(lambda: record_served(
            RequestEngine,
            lambda: run_sla_cell(build_engine, run_sla, parse_chaos, kw)))
    return report, served, routes


if __name__ == "__main__":
    report, served, routes = run_reference(json.loads(sys.argv[1]))
    print(json.dumps({"report": report, "served": served,
                      "routes": [r.tolist() for r in routes]}))
