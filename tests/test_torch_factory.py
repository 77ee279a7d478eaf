"""The port's engine surface, its interop, and its import boundary.

* ``PQEngine`` conforms to the port's ``QueueEngine`` protocol and gives
  the same ``relax_bound`` as the reference engine for the same spec.
* Construction rejects the kernel backend on a CPU device, unknown
  backends and unknown engines; the mesh kinds ``dist`` and ``elastic``
  build on a CPU mesh.
* A state crosses between the packages through ``state_from_numpy`` /
  ``state_to_numpy`` unchanged.
* ``repro_torch`` and ``chip_smoke.py`` import neither JAX nor ``repro``.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from repro.core import pqueue as jpq
from repro.core.config import PRODUCTION as J_PRODUCTION
from repro.core.config import SMALL as J_SMALL
from repro.core.factory import EngineSpec as JSpec
from repro.core.factory import default_base as j_default_base
from repro.core.factory import make_engine as j_make_engine
from repro.kernels import ops as jops
from repro_torch.core import config as tcfg
from repro_torch.core import pqueue
from repro_torch.core.factory import (EngineSpec, PQEngine, QueueEngine,
                                      default_base, engine_kinds,
                                      make_engine)
from repro_torch.core.interop import state_from_numpy, state_to_numpy
from test_lane_megakernel import BASE, _repair_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "backend"}


def test_configs_match_reference():
    assert _fields(tcfg.PRODUCTION) == _fields(J_PRODUCTION)
    assert _fields(tcfg.SMALL) == _fields(J_SMALL)
    for w in (64, 256, 4096):
        t, j = default_base(w), j_default_base(w)
        assert _fields(t) == _fields(j)
        for prop in ("spill_threshold", "par_cap", "move_k_max", "total_cap"):
            assert getattr(t, prop) == getattr(j, prop), (w, prop)
    assert tcfg.tick_shapes(tcfg.SMALL) == ((64,), (64,))
    assert tcfg.PQConfig().backend == "cuda"


@pytest.mark.parametrize("bad", [
    dict(a_max=0), dict(seq_cap=10), dict(detach_min=0),
    dict(detach_init=1), dict(n_buckets=0), dict(backend="jnp")])
def test_config_checks_raise(bad):
    with pytest.raises(ValueError):
        tcfg.PQConfig(**bad)


def test_engine_protocol_and_relax_bound():
    spec = dict(engine="pqe", width=64, base=_port_base())
    eng = make_engine(EngineSpec(backend="torch", **spec), device="cpu")
    assert isinstance(eng, PQEngine) and isinstance(eng, QueueEngine)
    assert eng.kind == "pqe" and eng.width == 64
    ref = j_make_engine(JSpec(engine="pqe", width=64, base=BASE))
    for r in (0, 1, 8, 64):
        assert eng.relax_bound(r) == ref.relax_bound(r)
    state = eng.init(seed=0)
    ak, av, mask, _ = next(_repair_stream(np.random.default_rng(0), 1))
    state, res = eng.tick(state, np.asarray(ak), np.asarray(av),
                          np.asarray(mask), 0)
    assert eng.stats(state).n_ticks.item() == 1
    # the tiny store sheds past capacity, and counts what it sheds
    assert (int(eng.size(state)) + int(state.stats.n_dropped)
            == int(np.asarray(mask).sum()))
    _, _, live = eng.resident(state)
    assert int(live.sum()) == int(eng.size(state))
    assert res.rm_keys.device.type == "cpu"


def _port_base(backend="cuda"):
    return tcfg.PQConfig(backend=backend, **_fields(BASE))


def test_spec_knobs_and_backend_resolve():
    eng = make_engine(EngineSpec(engine="pqe", width=64, backend="torch",
                                 detach_init=16, halve_threshold=7),
                      device="cpu")
    assert eng.cfg.backend == "torch"
    assert eng.cfg.detach_init == 16 and eng.cfg.halve_threshold == 7
    base = _port_base("torch")
    kept = make_engine(EngineSpec(engine="pqe", width=64, base=base),
                       device="cpu")
    assert kept.cfg is base


def test_cuda_backend_on_cpu_raises():
    with pytest.raises(ValueError, match="cuda device"):
        make_engine(EngineSpec(engine="pqe", width=64), device="cpu")
    with pytest.raises(ValueError, match="cuda device"):
        make_engine(EngineSpec(engine="pqe", width=64, backend="cuda"),
                    device="cpu")


@pytest.mark.parametrize("kind", ["dist", "elastic", "nope"])
def test_unported_or_unknown_engine_raises(kind):
    """The mesh kinds build on the CPU (every kind of the reference is
    ported); an unknown kind raises, naming the seven."""
    kinds = ["adaptive", "dist", "elastic", "fcskiplist", "lfskiplist",
             "pqe", "sharded"]
    assert engine_kinds() == kinds
    spec = EngineSpec(engine=kind, width=64, backend="torch", lanes=4,
                      n_devices=2)
    if kind == "nope":
        with pytest.raises(ValueError, match=re.escape(str(kinds))):
            make_engine(spec, device="cpu")
        return
    eng = make_engine(spec, device="cpu")
    assert eng.kind == kind and isinstance(eng, QueueEngine)
    queue = eng if kind == "dist" else eng.queue
    assert queue.mesh == [torch.device("cpu")] * 2
    assert queue.cfg.lanes_per_device == 2 and eng.width == 64
    state = eng.init(seed=0)
    state, res = eng.tick(state, np.zeros(64, np.float32),
                          np.arange(64, dtype=np.int32), np.ones(64, bool),
                          8)
    assert int(res.rm_served.sum()) == 8
    assert int(eng.stats(state).depth) == 56


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown kernel backend"):
        make_engine(EngineSpec(engine="pqe", width=64, backend="pallas"),
                    device="cpu")


def test_state_round_trip_through_numpy():
    """A reference state mid-stream crosses into the port and back
    bit for bit, and both packages tick it to the same next state."""
    cfg_j = dataclasses.replace(BASE, backend=jops.resolve_backend("jnp"))
    cfg_t = _port_base("torch")
    s_j = jpq.init(cfg_j)
    stream = list(_repair_stream(np.random.default_rng(3), 6))
    for b in stream[:5]:
        s_j, _ = jpq.tick(cfg_j, s_j, *b)
    leaves = [np.array(x) for x in jax.tree.leaves(s_j)]
    s_t = state_from_numpy(cfg_t, leaves, "cpu")
    for g, w in zip(state_to_numpy(s_t), leaves):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    n_t, _ = pqueue.tick(cfg_t, s_t, *(np.asarray(x) for x in stream[5]))
    n_j, _ = jpq.tick(cfg_j, s_j, *stream[5])
    for g, w in zip(state_to_numpy(n_t), jax.tree.leaves(n_j)):
        np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="leaves"):
        state_from_numpy(cfg_t, leaves[:-1], "cpu")
    bad = list(leaves)
    bad[0] = bad[0][:-1]
    with pytest.raises(ValueError, match="leaf 0"):
        state_from_numpy(cfg_t, bad, "cpu")


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.kernels, repro_torch.kernels.lane_tick, "
            "repro_torch.kernels.build, repro_torch.kernels.bitonic, "
            "repro_torch.kernels.merge_consume, "
            "repro_torch.kernels.radix_select, repro_torch.kernels.ref, "
            "repro_torch.core.sharded, repro_torch.core.elimination, "
            "repro_torch.core.factory, repro_torch.core.interop, "
            "repro_torch.core.baselines, repro_torch.core.adaptive, "
            "repro_torch.quality, repro_torch.quality.harness, "
            "repro_torch.quality.tuner, repro_torch.core.distributed, "
            "repro_torch.ft, repro_torch.ft.heartbeat, repro_torch.ft.inject, "
            "repro_torch.ft.straggler, repro_torch.ft.elastic, "
            "repro_torch.serving, repro_torch.serving.arrivals, "
            "repro_torch.serving.scheduler, repro_torch.serving.engine, "
            "repro_torch.serving.sla\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_jax_or_reference_import_in_port_sources():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 5 and (ROOT / "chip_smoke.py").exists()
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert not offenders, offenders


def test_device_default_is_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    import inspect
    assert inspect.signature(make_engine).parameters["device"].default \
        == "cuda"
    assert inspect.signature(pqueue.init).parameters["device"].default \
        == "cuda"
    assert torch.device(make_engine.__kwdefaults__["device"]).type == "cuda"
