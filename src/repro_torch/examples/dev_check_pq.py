"""Dev sanity check: drive the pqe tick against the heapq oracle with
random mixes (port of the JAX package's ``scripts/dev_check_pq.py``).

    PYTHONPATH=src python -m repro_torch.examples.dev_check_pq
    PYTHONPATH=src python -m repro_torch.examples.dev_check_pq \\
        --device cpu --backend torch

Prints one line per seed and ``ALL OK`` when every drive matched.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import pqueue as pq
from repro_torch.core.config import SMALL, PQConfig
from repro_torch.core.ref_pq import RefPQ

#: a tiny config that forces the overflow / rebalance / spill paths hard
TINY = PQConfig(a_max=16, r_max=16, seq_cap=64, n_buckets=4, bucket_cap=16,
                detach_min=2, detach_max=32, detach_init=4, chop_patience=4)


def run(cfg, seed, ticks, p_add=0.5, key_hi=1000.0, verbose=False,
        device="cuda") -> dict:
    """``ticks`` seeded random ticks of ``cfg`` on ``device``, each checked
    against the oracle.  Returns ``ok`` (every tick matched), the ticks
    run and the final per-path stats."""
    rng = np.random.default_rng(seed)
    state = pq.init(cfg, torch.device(device))
    ref = RefPQ()
    next_val = 0
    ok, t = True, 0
    for t in range(ticks):
        n_add = int(rng.integers(0, cfg.a_max + 1))
        n_rm = int(rng.integers(0, cfg.r_max + 1))
        if rng.random() < 0.2:
            n_rm = 0  # quiet ticks to exercise chopHead
        # admission control: the structure is statically sized; the engine
        # layer never admits beyond capacity. chopHead can move everything
        # to the parallel part, so bound by par_cap.
        n_add = min(n_add, max(0, cfg.par_cap - len(ref)))
        keys = rng.uniform(0, key_hi, size=n_add).astype(np.float32)
        vals = np.arange(next_val, next_val + n_add, dtype=np.int32)
        next_val += n_add

        ak = np.full((cfg.a_max,), np.inf, np.float32)
        av = np.full((cfg.a_max,), -1, np.int32)
        mask = np.zeros((cfg.a_max,), bool)
        ak[:n_add] = keys; av[:n_add] = vals; mask[:n_add] = True

        state, res = pq.tick(cfg, state, ak, av, mask, n_rm)
        got_keys = res.rm_keys[res.rm_served].cpu().numpy()
        exp = ref.tick(keys.tolist(), vals.tolist(), n_rm)
        exp_keys = np.array([k for k, _ in exp if k != np.inf], np.float32)
        got_sorted = np.sort(got_keys)
        exp_sorted = np.sort(exp_keys)
        if got_sorted.shape != exp_sorted.shape or not np.allclose(
                got_sorted, exp_sorted):
            print(f"MISMATCH tick {t}: n_add={n_add} n_rm={n_rm}")
            print(" got", got_sorted[:20], len(got_sorted))
            print(" exp", exp_sorted[:20], len(exp_sorted))
            print(" state seq_len", int(state.seq_len), "par_count",
                  int(state.par_count), "min", float(state.min_value),
                  "last_seq", float(state.last_seq))
            ok = False
            break
        # size invariant
        sz = int(state.seq_len) + int(state.par_count)
        if sz != len(ref):
            print(f"SIZE MISMATCH tick {t}: got {sz} exp {len(ref)} "
                  f"(dropped={int(state.stats.n_dropped)})")
            ok = False
            break
    s = {k: int(v) for k, v in state.stats._asdict().items()}
    if ok and verbose:
        print(f"seed={seed} OK  elim(imm/upc)={s['add_imm_elim']}/"
              f"{s['add_upc_elim']} addseq={s['add_seq']} "
              f"addpar={s['add_par']} rmseq={s['rm_seq']} "
              f"rmpar={s['rm_par']} empty={s['rm_empty']} "
              f"mv={s['n_movehead']} chop={s['n_chophead']} "
              f"rebal={s['n_rebalance']} spill={s['n_spill']} "
              f"drop={s['n_dropped']}")
    return dict(ok=ok, ticks=t + 1, stats=s)


def main(device="cuda", backend: str = "cuda") -> dict:
    """``SMALL`` over seeds 0-7 (60 ticks) and ``TINY`` over seeds 8-15
    (80 ticks), both under ``backend``."""
    runs = {}
    for cfg, seeds, ticks in ((SMALL, range(8), 60), (TINY, range(8, 16),
                                                       80)):
        cfg = dataclasses.replace(cfg, backend=backend)
        for seed in seeds:
            runs[seed] = run(cfg, seed, ticks=ticks, verbose=True,
                             device=device)
    ok = all(r["ok"] for r in runs.values())
    print("ALL OK" if ok else "FAILURES")
    return dict(ok=ok, runs=runs)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    a = ap.parse_args()
    raise SystemExit(0 if main(a.device, a.backend)["ok"] else 1)
