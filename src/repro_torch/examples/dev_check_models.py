"""Dev shakeout: the reduced config of every arch through the training
loss and its gradient, prefill and two decode steps (port of the JAX
package's ``scripts/dev_check_models.py``).

    PYTHONPATH=src python -m repro_torch.examples.dev_check_models
    PYTHONPATH=src python -m repro_torch.examples.dev_check_models \\
        --device cpu

Prints one line per arch; raises at the first arch whose loss, gradient
norm or logits are not finite.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ALL_ARCHS, reduced_config
from repro_torch.models import transformer as tf


def check(name: str, device="cuda", seed: int = 0) -> dict:
    """One arch's reduced config on ``device``: loss and gradient norm
    finite, prefill and two greedy decode steps finite.  Returns the
    numbers it prints."""
    cfg = reduced_config(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tf.init_params(cfg, gen, device)
    n_params = tf.param_count(params)

    B, S = 2, 64
    tokens = torch.randint(0, cfg.vocab, (B, S), device=device,
                           generator=gen, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.frontend == "vit":
        batch["prefix_embeds"] = torch.full(
            (B, cfg.frontend_tokens, cfg.d_model), 0.01,
            dtype=torch.bfloat16, device=device)
    if cfg.frontend == "audio":
        batch["enc_frames"] = torch.full((B, cfg.enc_seq, cfg.d_model),
                                         0.01, dtype=torch.bfloat16,
                                         device=device)

    # train forward + loss + grad
    live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = tf.loss_fn(cfg, live, batch)
    if not torch.isfinite(loss):
        raise AssertionError(f"{name}: loss {float(loss)}")
    grads = torch.autograd.grad(loss, tf.tree_leaves(live))
    loss = loss.detach()
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads))
    if not torch.isfinite(gnorm):
        raise AssertionError(f"{name}: grad nan")

    # prefill + two decode steps; the caches hold a VLM's prefix too
    # (the reference sizes them S + 8 and JAX drops its decode writes
    # past the end, where torch's indexing raises)
    prefix = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    caches = tf.init_decode_caches(cfg, B, prefix + S + 8, device)
    logits_pre, caches = tf.prefill(
        cfg, params, tokens, caches, enc_frames=batch.get("enc_frames"),
        prefix_embeds=batch.get("prefix_embeds"))
    if not torch.isfinite(logits_pre).all():
        raise AssertionError(f"{name}: prefill logits")

    pos = torch.full((B,), S + prefix, dtype=torch.int32, device=device)
    tok = logits_pre[:, -1, :cfg.vocab].argmax(-1).int()
    logits_d, caches = tf.decode_step(cfg, params, tok[:, None], caches, pos)
    if not torch.isfinite(logits_d).all():
        raise AssertionError(f"{name}: decode logits")
    logits_d2, caches = tf.decode_step(
        cfg, params, logits_d[:, -1, :cfg.vocab].argmax(-1)[:, None].int(),
        caches, pos + 1)
    if not torch.isfinite(logits_d2).all():
        raise AssertionError(f"{name}: second decode logits")
    print(f"{name:24s} OK  params={n_params:>10,d} loss={float(loss):.3f} "
          f"gnorm={float(gnorm):.3f}")
    return dict(params=n_params, loss=float(loss), grad_norm=float(gnorm))


def main(device="cuda") -> dict:
    out = {}
    for a in ALL_ARCHS:
        try:
            out[a] = check(a, device)
        except Exception as e:
            print(f"{a:24s} FAIL {type(e).__name__}: {e}")
            raise
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
