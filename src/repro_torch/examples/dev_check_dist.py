"""Dev check: the mesh queue (lanes over positions) at D=8 x l=2 (port
of the JAX package's ``scripts/dev_check_dist.py``).

    PYTHONPATH=src python -m repro_torch.examples.dev_check_dist
    PYTHONPATH=src python -m repro_torch.examples.dev_check_dist \\
        --device cpu --backend torch

Drives ``make_engine(EngineSpec(engine="dist", ...))`` on eight mesh
positions (all on ``device``: ``["cuda:0"] * 8`` on the card) for 40
ticks against the single-device sharded queue on the same op stream and
a Python multiset mirror: every tick the served keys equal the sharded
queue's, each served key lies within ``relax_bound`` of the union, and
the size equals the mirror's.  Under ``"cuda"`` each position's lane
work launches the lane-tick kernel (grid 2) and its router's row sort.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import sharded as shq
from repro_torch.core.config import PQConfig
from repro_torch.core.factory import EngineSpec, make_engine

#: positions, lanes a position, width, ticks
D, LPD, W, TICKS = 8, 2, 64, 40
#: the queue each lane is cut from (the backend is ``main``'s)
BASE = PQConfig(a_max=W, r_max=W, seq_cap=512, n_buckets=16, bucket_cap=32,
                detach_min=4, detach_max=64, detach_init=8, chop_patience=8)


def spec(backend: str = "cuda") -> EngineSpec:
    """The mesh queue's spec: D positions of LPD lanes at width W."""
    return EngineSpec(engine="dist", width=W,
                      base=dataclasses.replace(BASE, backend=backend),
                      lanes=D * LPD, n_devices=D, lanes_per_device=LPD)


def main(device="cuda", backend: str = "cuda") -> dict:
    """40 ticks on D positions of ``device`` under ``backend``, each
    checked.  Returns the final stats, the lanes' sizes and each
    position's lane-work ticks."""
    dev = torch.device(device)
    mesh = [dev] * D
    base = dataclasses.replace(BASE, backend=backend)
    q = make_engine(spec(backend), device=dev, mesh=mesh)
    scfg = make_engine(EngineSpec(engine="sharded", width=W, base=base,
                                  lanes=D * LPD), device=dev).cfg
    if scfg != q.cfg.shard:
        raise AssertionError(f"the mesh's lanes {q.cfg.shard} differ from "
                             f"the sharded queue's {scfg}")
    dstate = q.init(seed=1)
    sstate = shq.init(scfg, seed=1, device=dev)

    rng = np.random.default_rng(0)
    mirror = []
    next_val = 0
    for t in range(TICKS):
        n_add = int(rng.integers(0, W + 1))
        n_rm = int(rng.integers(0, W // 2 + 1))
        keys = np.round(rng.uniform(0, 1000, n_add), 3).astype(np.float32)
        ak = np.full((W,), np.inf, np.float32)
        av = np.full((W,), -1, np.int32)
        mask = np.zeros((W,), bool)
        ak[:n_add] = keys
        av[:n_add] = np.arange(next_val, next_val + n_add)
        mask[:n_add] = True
        next_val += n_add

        combined = sorted(mirror + keys.tolist())
        c = q.relax_bound(n_rm)
        cutoff = combined[c - 1] if c <= len(combined) else np.inf

        dstate, dres = q.tick(dstate, ak, av, mask, n_rm)
        sstate, sres = shq.tick(scfg, sstate, ak, av, mask, n_rm)

        got = np.sort(dres.rm_keys[dres.rm_served].cpu().numpy())
        ref = np.sort(sres.rm_keys[sres.rm_served].cpu().numpy())
        if not np.array_equal(got, ref):                  # dist == 1-dev
            raise AssertionError(f"tick {t}: served {got}, the sharded "
                                 f"queue {ref}")
        for k in got:
            if k > cutoff:
                raise AssertionError(f"tick {t}: served {k} past the "
                                     f"relax bound's {c}-th key {cutoff}")
            combined.remove(float(np.float32(k)))
        mirror = combined
        if int(q.size(dstate)) != len(mirror):
            raise AssertionError(f"tick {t}: size {int(q.size(dstate))}, "
                                 f"the mirror holds {len(mirror)}")

    st = q.stats(dstate)
    out = dict(ticks=int(st.n_ticks), preroute_elim=int(st.n_preroute_elim),
               lane_removes=int(st.lane.n_removes),
               lane_sizes=q.lane_sizes(dstate).cpu().tolist(),
               work_ticks=list(q.work_ticks), size=len(mirror))
    print(f"OK dist_sharded: ticks={out['ticks']} "
          f"preroute_elim={out['preroute_elim']} "
          f"lane_removes={out['lane_removes']} "
          f"lane_sizes={out['lane_sizes']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    a = ap.parse_args()
    main(a.device, a.backend)
