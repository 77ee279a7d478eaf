"""How far a model's decode steps drift from its own teacher-forcing
``forward``, in the JAX package and in the port, at xlstm-350m's full
published depth (24 sLSTM / mLSTM layers) on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_model_drift_check.py

(~60 s; not collected by pytest).  One prompt of 512 tokens from a numpy
seed, a prefill and 8 greedy decode steps, then ``forward`` over the
prompt and the fed tokens (padded with token 0 to a multiple of the
mLSTM chunk; the model is causal).  Prints, per package and dtype, the
largest |decode - forward| over the logits' scale at each generated
position.  Random weights in 24 recurrent layers amplify rounding: the
drift in bfloat16 is of the order of the logits' scale in both packages,
which is why ``chip_smoke.py`` phase 11b holds xlstm-350m's float32 copy
and only records its bf16 drift.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models import transformer as tf

ARCH, PROMPT, STEPS = "xlstm-350m", 512, 8


def drift(got, want):
    return (np.abs(got - want).max(-1) / np.abs(want).max()).ravel()


def reference(dtype, toks):
    cfg = dataclasses.replace(j_get_config(ARCH), dtype=dtype)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    caches = jtf.init_decode_caches(cfg, 1, PROMPT + STEPS)
    last, caches = jax.jit(lambda p, t, c: jtf.prefill(cfg, p, t, c))(
        params, toks, caches)
    step = jax.jit(lambda p, t, c, pos: jtf.decode_step(cfg, p, t, c, pos))
    logits, fed = [np.asarray(last[:, 0], np.float32)], []
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(last[:, -1, :cfg.vocab], -1),
                         np.int32)[:, None]
        fed.append(tok)
        last, caches = step(params, tok, caches,
                            np.full((1,), PROMPT + i, np.int32))
        logits.append(np.asarray(last[:, 0], np.float32))
    seq = np.concatenate([toks] + fed, 1)
    seq = np.pad(seq, ((0, 0), (0, (-seq.shape[1]) % 256)))
    full, _ = jax.jit(lambda p, t: jtf.forward(cfg, p, t))(params, seq)
    want = np.asarray(full[:, PROMPT - 1:PROMPT + STEPS], np.float32)
    return drift(np.stack(logits, 1), want)


def port(dtype, toks):
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(toks)
    caches = tf.init_decode_caches(cfg, 1, PROMPT + STEPS, "cpu")
    last, caches = tf.prefill(cfg, params, toks, caches)
    logits, fed = [last[:, 0]], []
    for i in range(STEPS):
        tok = logits[-1][:, :cfg.vocab].argmax(-1, keepdim=True)
        fed.append(tok)
        out, caches = tf.decode_step(cfg, params, tok, caches,
                                     torch.full((1,), PROMPT + i))
        logits.append(out[:, 0])
    seq = torch.cat([toks] + fed, 1)
    seq = torch.nn.functional.pad(seq, (0, (-seq.shape[1]) % 256))
    with torch.inference_mode():
        full, _ = tf.forward(cfg, params, seq)
    want = full[:, PROMPT - 1:PROMPT + STEPS].float().numpy()
    return drift(torch.stack(logits, 1).float().numpy(), want)


def main():
    toks = np.random.default_rng(0).integers(
        0, get_config(ARCH).vocab, (1, PROMPT)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        for name, fn in (("reference", reference), ("port", port)):
            d = fn(dtype, toks)
            print(f"{ARCH} {dtype:8s} {name:9s} decode - forward over "
                  f"the logits' scale, per position: {np.round(d, 5)} "
                  f"max {d.max():.3e}", flush=True)


if __name__ == "__main__":
    main()
