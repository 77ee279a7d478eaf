"""Discrete-event simulation on the priority queue — the paper's first
motivating use case ("parallel priority queues are often used in discrete
event simulations").  Port of the JAX package's ``examples/event_sim.py``.

An M/M/k queueing network: events are (time, kind); each processed event
schedules successors at time + Exp(rate).  New events land just above the
current minimum — the regime where the paper's elimination shines (the
benchmark's "des" key distribution).

    PYTHONPATH=src python -m repro_torch.examples.event_sim
    PYTHONPATH=src python -m repro_torch.examples.event_sim \
        --device cpu --backend torch

On the card the tick runs the lane-tick kernel (backend ``"cuda"``).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import PQConfig, init, tick


#: the event queue's geometry
CFG = PQConfig(a_max=64, r_max=64, seq_cap=1024, n_buckets=32,
               bucket_cap=128, detach_min=8, detach_max=1024,
               detach_init=64)


def main(device="cuda", backend: str = "cuda") -> dict:
    cfg = dataclasses.replace(CFG, backend=backend)
    state = init(cfg, torch.device(device))
    rng = np.random.default_rng(0)
    vals = np.arange(cfg.a_max, dtype=np.int32)

    # seed the event queue
    t_seed = rng.exponential(10.0, 512).cumsum().astype(np.float32)
    for i in range(0, 512, cfg.a_max):
        chunk = t_seed[i:i + cfg.a_max]
        ak = np.full((cfg.a_max,), np.inf, np.float32)
        ak[:len(chunk)] = chunk
        state, _ = tick(cfg, state, ak, vals, ak < np.inf, 0)

    clock = 0.0
    processed = 0
    rounds = 60
    width = 32
    for r in range(rounds):
        # pop the next `width` events AND push their successors in ONE
        # combined tick — successors of the previous round
        succ = clock + rng.exponential(10.0, width).astype(np.float32)
        ak = np.full((cfg.a_max,), np.inf, np.float32)
        ak[:width] = succ
        state, res = tick(cfg, state, ak, vals, ak < np.inf, width)
        served = res.rm_keys[res.rm_served].cpu().numpy()
        if len(served):
            clock = float(served.max())
        processed += len(served)

    s = {k: int(v) for k, v in state.stats._asdict().items()}
    adds = s["add_imm_elim"] + s["add_upc_elim"] + s["add_seq"] + s["add_par"]
    elim = s["add_imm_elim"] + s["add_upc_elim"]
    print(f"processed {processed} events, virtual clock {clock:.1f}")
    print(f"elimination rate: {elim}/{adds} = {elim/max(adds,1):.1%} "
          f"(DES workloads keep new events near the minimum)")
    print(f"moveHead events: {s['n_movehead']}  "
          f"adaptive detach_n: {int(state.detach_n)}")
    return dict(processed=processed, clock=clock, stats=s,
                detach_n=int(state.detach_n), size=int(
                    state.seq_len + state.par_count))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    a = ap.parse_args()
    main(a.device, a.backend)
