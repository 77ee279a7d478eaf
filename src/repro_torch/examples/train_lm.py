"""End-to-end training driver: a ~100M-parameter LM for a few hundred
steps on the synthetic stream, with checkpointing and the
loss-prioritized curriculum sampler (port of the JAX package's
``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --small \\
        --device cpu --backend torch

``--small`` shrinks to a ~2M model and 60 steps (``--steps`` overrides
the count here).  Each step draws its group from a
``repro_torch.data.PrioritySampler`` of 8 groups on ``device`` under
``backend``: on the card, under ``"cuda"``, every sampler tick (two a
step) runs the lane-tick kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import PrioritySampler, SyntheticLM
from repro_torch.data.priority_sampler import DEFAULT_CFG
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import transformer as tf


def build_cfg(small: bool):
    base = get_config("gemma-2b")
    if small:
        return dataclasses.replace(
            base, n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
            head_dim=32, d_ff=512, vocab=512, remat="none",
            dtype="float32")
    # ~100M: 8L x 640d, 8 heads, GeGLU
    return dataclasses.replace(
        base, n_layers=8, d_model=640, n_heads=8, n_kv_heads=1,
        head_dim=80, d_ff=2560, vocab=32_000, dtype="float32",
        remat="none")


def main(device="cuda", backend: str = "cuda", small: bool = False,
         steps: Optional[int] = None, ckpt: str = "artifacts/train_lm",
         seed: int = 0) -> dict:
    """Train on ``device``, the sampler's queue under ``backend``.
    Returns the model's size, each step's group, loss, gradient norm and
    learning rate, the host-clocked ms a step and the sampler's
    breakdown."""
    cfg = build_cfg(small)
    steps = steps or (60 if small else 300)
    batch, seq = (8, 128) if small else (16, 256)

    tcfg = TrainConfig(n_micro=2, peak_lr=1e-3, warmup=20,
                       total_steps=steps, fsdp=False, zero1=False)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(cfg, gen, tcfg, device=device)
    n_params = tf.param_count(state.params)
    print(f"model: {n_params/1e6:.1f}M params | steps={steps} "
          f"batch={batch} seq={seq}")

    step_fn = make_train_step(cfg, tcfg, None)
    mgr = CheckpointManager(ckpt, keep=2)

    # priority curriculum: 8 synthetic group-streams keyed by EMA loss
    n_groups = 8
    sampler = PrioritySampler(
        n_groups, cfg=dataclasses.replace(DEFAULT_CFG, backend=backend),
        device=device)
    streams = [SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch,
                           seed=g) for g in range(n_groups)]

    out = dict(params=n_params, steps=steps, batch=batch, seq=seq,
               groups=[], loss=[], grad_norm=[], lr=[])
    t0 = time.time()
    for step in range(steps):
        (gid,) = sampler.next_groups(1)
        data = streams[gid].batch_at(step)
        b = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        sampler.report(gid, loss)
        sampler.requeue([gid])
        out["groups"].append(gid)
        out["loss"].append(loss)
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["lr"].append(float(metrics["lr"]))
        if step % max(1, steps // 15) == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"step {step:4d}  loss {loss:7.4f}  "
                  f"gnorm {out['grad_norm'][-1]:6.3f}  "
                  f"lr {out['lr'][-1]:.2e}  "
                  f"({dt/(step+1)*1e3:.0f} ms/step)  group={gid}")
        if (step + 1) % 100 == 0:
            mgr.save(step + 1, state, blocking=False)
    mgr.wait()
    out["ms_per_step"] = 1e3 * (time.time() - t0) / steps
    mgr.save(steps, state)
    print(f"done in {time.time()-t0:.1f}s; checkpoints in {ckpt}")
    out["breakdown"] = {k: v for k, v in sampler.breakdown().items() if v}
    print("sampler breakdown:", out["breakdown"])
    out["state"] = state
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt", default="artifacts/train_lm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    a = ap.parse_args()
    main(a.device, a.backend, a.small, a.steps, a.ckpt)
