"""Quickstart: the adaptive priority queue with elimination and combining
(port of the JAX package's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        --device cpu --backend torch

Engines are built through the unified factory (repro_torch.core.factory):
one ``EngineSpec`` names the engine kind — ``pqe`` (the paper's combined
queue, used here), ``sharded`` (L relaxed lanes), ``dist`` / ``elastic``
(a mesh of positions, fault tolerance), or ``adaptive`` (a workload
controller that picks between them at runtime).  The last section
measures what relaxation *costs*: the rank-error meter
(repro_torch.quality) replays each engine's served stream against the
exact reference.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import EngineSpec, PQConfig, make_engine
from repro_torch.quality import measure_engine, probe_stream, warm_keys


#: a small queue: 64-op ticks, a 512-slot sequential head, 16 buckets
BASE = PQConfig(a_max=64, r_max=64, seq_cap=512, n_buckets=16,
                bucket_cap=64, detach_min=8, detach_max=256, detach_init=32)


def main(device="cuda", backend: str = "cuda") -> dict:
    """Every section on ``device`` under ``backend`` (a CPU device needs
    ``"torch"``); the backend section ticks a ``backend`` engine beside
    a ``"torch"`` one."""
    dev = torch.device(device)

    def engine(**spec):
        return make_engine(EngineSpec(**spec), device=dev)

    eng = engine(engine="pqe", width=64, base=BASE, backend=backend)
    state = eng.init(seed=0)
    rng = np.random.default_rng(0)
    out = {}

    print("== insert three batches of 64 random keys ==")
    for b in range(3):
        keys = rng.uniform(0, 1000, 64).astype(np.float32)
        av = np.arange(64, dtype=np.int32) + b * 64
        state, _ = eng.tick(state, keys, av, np.ones((64,), bool), 0)
    out["inserted"] = dict(size=int(eng.size(state)),
                           min=float(state.min_value),
                           last_seq=float(state.last_seq),
                           detach_n=int(state.detach_n))
    print(f"queue size: {out['inserted']['size']}"
          f"  min={out['inserted']['min']:.2f}"
          f"  lastSeq={out['inserted']['last_seq']:.2f}"
          f"  detach_n={out['inserted']['detach_n']}")

    print("\n== a combined tick: 32 adds + 32 removeMin ==")
    keys = rng.uniform(0, 1000, 32).astype(np.float32)
    ak = np.full((64,), np.inf, np.float32)
    ak[:32] = keys
    av = np.arange(64, dtype=np.int32) + 1000
    mask = np.zeros((64,), bool)
    mask[:32] = True
    state, res = eng.tick(state, ak, av, mask, 32)
    served = res.rm_keys[res.rm_served].cpu().numpy()
    out["served"] = np.sort(served)
    print(f"removed the {len(served)} smallest keys: "
          f"{np.sort(served)[:8].round(1)} ...")

    s = {k: int(v) for k, v in eng.stats(state)._asdict().items()}
    out["stats"] = s
    print("\n== per-path breakdown (the paper's Figs. 7-8) ==")
    print(f" adds eliminated immediately : {s['add_imm_elim']}")
    print(f" adds eliminated after aging : {s['add_upc_elim']}")
    print(f" adds combined (server)      : {s['add_seq']}")
    print(f" adds inserted in parallel   : {s['add_par']}")
    print(f" removes served from head    : {s['rm_seq']}")
    print(f" moveHead / chopHead events  : {s['n_movehead']}"
          f" / {s['n_chophead']}")

    print("\n== kernel backend: config, not per-call ==")
    # the backend rides the spec and resolves ONCE at engine construction:
    # "cuda" (the hand-written lane-tick kernel, the default on the card)
    # or "torch" (every pass in plain PyTorch, the twin of the reference's
    # jnp path).  Same stream, bit-identical serves on either backend.
    fkeys = rng.uniform(0, 1000, 64).astype(np.float32)
    fserved = {}
    for b in (backend, "torch"):
        fused = engine(engine="pqe", width=64, base=BASE, backend=b)
        fstate = fused.init(seed=0)
        fstate, _ = fused.tick(fstate, fkeys, np.arange(64, dtype=np.int32),
                               np.ones((64,), bool), 0)
        fstate, fres = fused.tick(fstate, np.full((64,), np.inf, np.float32),
                                  np.zeros((64,), np.int32),
                                  np.zeros((64,), bool), 8)
        fserved[b] = np.sort(fres.rm_keys[fres.rm_served].cpu().numpy())
    print(f" resolved at construction: {backend} beside torch")
    assert np.array_equal(fserved[backend], np.sort(fkeys)[:8])
    assert np.array_equal(fserved[backend].view(np.int32),
                          fserved["torch"].view(np.int32))
    out["backend_served"] = fserved[backend]
    print(f" {backend} served the exact 8 smallest: "
          f"{fserved[backend].round(1)}")

    print("\n== relaxation quality: rank error vs the exact reference ==")
    # the meter replays each engine's own (adds, served) stream against
    # the instantaneous exact union: pqe is exact, so it scores
    # identically 0; relaxed lanes trade rank error for speed, bounded by
    # relax_bound(r) - r
    warm = warm_keys(200)
    ak, av, am, rc = probe_stream(64, 0.5, 10)
    n_rm = int(rc[0])
    out["quality"] = {}
    for name, spec in (
        ("pqe (exact)  ", dict(engine="pqe", width=64, base=BASE)),
        ("sharded L=4  ", dict(engine="sharded", width=64, lanes=4)),
    ):
        q = engine(backend=backend, **spec)
        # measure_engine warms the fresh engine with the same keys it
        # preloads into the reference union, then scores every tick
        qs = measure_engine(q, ak, av, am, rc, warm_keys=warm)
        envelope = q.relax_bound(n_rm) - n_rm
        out["quality"][spec["engine"]] = dict(qs, envelope=envelope)
        print(f" {name}: rank_err p50={qs['rank_err_p50']:5.1f}"
              f" p99={qs['rank_err_p99']:6.1f}"
              f" max={qs['rank_err_max']:4d}"
              f" (envelope {envelope})"
              f"  stale_max={qs['stale_max']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    a = ap.parse_args()
    main(a.device, a.backend)
