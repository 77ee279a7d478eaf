"""How far a model's decode steps drift from its own teacher-forcing
``forward``, in the JAX package and in the port, at xlstm-350m's full
published depth (24 sLSTM / mLSTM layers) on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_model_drift_check.py

(~60 s; not collected by pytest).  Both packages run the same model:
the reference's ``init_params`` from ``jax.random.PRNGKey(0)``, carried
to the port by ``repro_torch.models.interop``.  One prompt of 512 tokens
from a numpy seed, a prefill and 8 decode steps fed the reference's
greedy tokens, then ``forward`` over the prompt and the fed tokens
(padded with token 0 to a multiple of the mLSTM chunk; the model is
causal).  Prints, per package and dtype, the largest |decode - forward|
over the logits' scale at each generated position, and the two
packages' drifts side by side.  Random weights in 24 recurrent layers
amplify rounding: the drift in bfloat16 is of the order of the logits'
scale in both packages, which is why ``chip_smoke.py`` phase 11b holds
xlstm-350m's float32 copy and only records its bf16 drift.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.models import interop
from repro_torch.models import transformer as tf
from torch_models_ref import np_tree

ARCH, PROMPT, STEPS = "xlstm-350m", 512, 8


def drift(got, want):
    return (np.abs(got - want).max(-1) / np.abs(want).max()).ravel()


def nudged(params, seed):
    """The parameters with every float32 leaf scaled by 1 +- 2**-23 (a
    random sign per element from ``seed``): a perturbation the size of
    one rounding."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        if x.dtype != jnp.float32:
            return x
        sign = rng.choice(np.float32([-1, 1]), x.shape)
        return x * (1 + sign * np.float32(2.0 ** -23))
    return jax.tree.map(leaf, params)


def reference(dtype, toks, nudge=None, fed=None):
    """The reference's drift, its parameters (numpy), the tokens it fed,
    and its decode and forward logits; with ``nudge``, on the parameters
    ``nudged`` by that seed and fed ``fed``."""
    cfg = dataclasses.replace(j_get_config(ARCH), dtype=dtype)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    if nudge is not None:
        params = nudged(params, nudge)
    fed_in = fed
    caches = jtf.init_decode_caches(cfg, 1, PROMPT + STEPS)
    last, caches = jax.jit(lambda p, t, c: jtf.prefill(cfg, p, t, c))(
        params, toks, caches)
    step = jax.jit(lambda p, t, c, pos: jtf.decode_step(cfg, p, t, c, pos))
    logits, fed = [np.asarray(last[:, 0], np.float32)], []
    for i in range(STEPS):
        tok = (fed_in[:, i:i + 1] if fed_in is not None else np.asarray(
            jnp.argmax(last[:, -1, :cfg.vocab], -1), np.int32)[:, None])
        fed.append(tok)
        last, caches = step(params, tok, caches,
                            np.full((1,), PROMPT + i, np.int32))
        logits.append(np.asarray(last[:, 0], np.float32))
    seq = np.concatenate([toks] + fed, 1)
    seq = np.pad(seq, ((0, 0), (0, (-seq.shape[1]) % 256)))
    full, _ = jax.jit(lambda p, t: jtf.forward(cfg, p, t))(params, seq)
    want = np.asarray(full[:, PROMPT - 1:PROMPT + STEPS], np.float32)
    dec = np.stack(logits, 1)
    return (drift(dec, want), np_tree(params), np.concatenate(fed, 1),
            dec, want)


def port(dtype, toks, params, fed):
    """The port's drift on the reference's parameters, fed the same
    tokens."""
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    params = interop.params_from_numpy(cfg, params, "cpu")
    toks = torch.from_numpy(toks)
    caches = tf.init_decode_caches(cfg, 1, PROMPT + STEPS, "cpu")
    last, caches = tf.prefill(cfg, params, toks, caches)
    logits = [last[:, 0]]
    fed = [torch.from_numpy(fed[:, i:i + 1]) for i in range(STEPS)]
    for i, tok in enumerate(fed):
        out, caches = tf.decode_step(cfg, params, tok, caches,
                                     torch.full((1,), PROMPT + i))
        logits.append(out[:, 0])
    seq = torch.cat([toks] + fed, 1)
    seq = torch.nn.functional.pad(seq, (0, (-seq.shape[1]) % 256))
    with torch.inference_mode():
        full, _ = tf.forward(cfg, params, seq)
    want = full[:, PROMPT - 1:PROMPT + STEPS].float().numpy()
    dec = torch.stack(logits, 1).float().numpy()
    return drift(dec, want), dec, want


def main():
    toks = np.random.default_rng(0).integers(
        0, get_config(ARCH).vocab, (1, PROMPT)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        ref, params, fed, r_dec, r_fwd = reference(dtype, toks)
        got, p_dec, p_fwd = port(dtype, toks, params, fed)
        del params
        # the reference against itself, one rounding apart in its weights
        for seed in (1, 2):
            d, _, _, n_dec, n_fwd = reference(dtype, toks, seed, fed)
            print(f"{ARCH} {dtype:8s} reference nudged (seed {seed}): "
                  f"decode - forward {np.round(d, 5)} max {d.max():.3e}; "
                  f"its forward - the reference's "
                  f"{np.round(drift(n_fwd, r_fwd), 5)}", flush=True)
        for name, d in (("reference", ref), ("port", got)):
            print(f"{ARCH} {dtype:8s} {name:9s} decode - forward over "
                  f"the logits' scale, per position: {np.round(d, 5)} "
                  f"max {d.max():.3e}", flush=True)
        print(f"{ARCH} {dtype:8s} port / reference per position: "
              f"{np.round(got / ref, 3)}", flush=True)
        for name, g, w in (("decode", p_dec, r_dec),
                           ("forward", p_fwd, r_fwd)):
            print(f"{ARCH} {dtype:8s} port {name} - reference {name} over "
                  f"the logits' scale, per position: "
                  f"{np.round(drift(g, w), 5)}", flush=True)


if __name__ == "__main__":
    main()
