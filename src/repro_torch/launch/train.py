"""The training step on one device (port of the JAX package's
``launch/train.py`` at ``mesh=None``).

* **Microbatches.** The global batch is split into ``n = min(n_micro,
  b)`` contiguous blocks of ``b // n`` rows, run one after another: each
  block's gradients come out of autograd in the parameter dtype and are
  added, as float32 divided by ``n``, into one float32 buffer; the loss
  is summed as ``loss / n``.  This bounds logits and activation memory,
  as the reference's microbatch scan does.
* **The update.** The cosine learning rate at ``state.opt.step``, then
  ``adamw_update`` or, under ``opt_8bit``, ``adamw8_update``.  The step
  updates the state's tensors in place and returns them, as the
  reference's jitted step donates its state.
* **What waits for the mesh.** ``zero1``, ``fsdp`` and
  ``sequence_parallel`` are kept in ``TrainConfig`` and ignored, as the
  reference ignores them on one device.  Its spec functions
  (``param_spec``, ``sanitize_spec``, ``zero1_spec``,
  ``train_param_specs``, ``state_shardings``, ``batch_specs``) and
  ``lower_train_step`` wait for the mesh slice of the model stack
  (ROADMAP queue 1, item 3); a ``mesh`` other than ``None`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.arch_config import ArchConfig
from repro_torch.optim import (adamw8_init, adamw8_update, adamw_init,
                               adamw_update, cosine_schedule)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_micro: int = 8
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # the reference's mesh layout knobs: kept, and ignored on one device
    zero1: bool = True
    fsdp: bool = True
    sequence_parallel: bool = False
    # 8-bit Adam moments (repro_torch.optim.adamw8)
    opt_8bit: bool = False


class TrainState(NamedTuple):
    params: Any
    opt: Any          # AdamWState or AdamW8State


def init_train_state(cfg: ArchConfig, generator: Optional[torch.Generator],
                     tcfg: Optional[TrainConfig] = None,
                     device="cuda") -> TrainState:
    """Parameters drawn by ``tf.init_params`` from ``generator`` on
    ``device``, and the optimizer's zero state."""
    params = tf.init_params(cfg, generator, device)
    opt8 = tcfg is not None and tcfg.opt_8bit
    return TrainState(params=params,
                      opt=adamw8_init(params) if opt8 else adamw_init(params))


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tf.tree_map(lambda _: next(it), tree)


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``, with
    ``metrics = {"loss", "grad_norm", "lr"}`` as 0-dim float32 tensors.
    ``batch`` holds tensors on the parameters' device: ``tokens`` and
    ``labels`` [B, S], and ``prefix_embeds`` / ``enc_frames`` where the
    arch's frontend takes them."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step on a mesh waits for the mesh slice of the "
            "model stack (ROADMAP queue 1, item 3); pass mesh=None")

    def accum_grads(params, batch):
        b = batch["tokens"].shape[0]
        n = min(tcfg.n_micro, b)
        micro = {k: v.reshape((n, b // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        leaves = tf.tree_leaves(params)
        live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)
        inputs = tf.tree_leaves(live)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n):
            loss, _ = tf.loss_fn(cfg, live, {k: v[i] for k, v in
                                             micro.items()})
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float() / n)
            del grads
            total = total + loss.detach() / n
        return _unflatten(params, acc), total

    def train_step(state: TrainState, batch):
        grads, loss = accum_grads(state.params, batch)
        lr = cosine_schedule(state.opt.step, peak_lr=tcfg.peak_lr,
                             warmup=tcfg.warmup, total=tcfg.total_steps)
        update = adamw8_update if tcfg.opt_8bit else adamw_update
        params, opt, metrics = update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
        metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return train_step
