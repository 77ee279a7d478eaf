"""Run the JAX package's model stack and the port's on the same inputs,
for the model parity tests (``tests/test_torch_models*.py``).

One reference run per architecture and dtype: ``forward`` logits,
``prefill`` (last logits and every cache leaf), two ``decode_step``s
with the rows at different positions (logits and every cache leaf after
each) and, where the reference allows it, ``prefill_chunked``.  The
reference's functions run jitted, as its serving steps do.  Inputs come
from a numpy seed; the parameters are the reference's ``init_params``,
carried to the port by ``repro_torch.models.interop``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import transformer as jtf
from repro_torch.configs import reduced_config
from repro_torch.models import interop
from repro_torch.models import transformer as tf

B, S = 2, 32          # two prompts of 32 tokens (a multiple of ssm_chunk)
EXTRA = 4             # decode room in the caches
BACK = 5              # the second row decodes BACK positions earlier


def np_tree(tree):
    """A JAX tree as numpy, bfloat16 leaves as their uint16 bit view."""
    def leaf(x):
        x = np.asarray(x)
        return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x
    return jax.tree.map(leaf, tree)


def as_f32(x):
    """A numpy leaf (bf16 as uint16 bits) or tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return (x.astype(np.uint32) << 16).view(np.float32)
    return x.astype(np.float32)


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|)."""
    got, want = as_f32(got), as_f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


def configs(arch: str, dtype: str):
    return (dataclasses.replace(j_reduced(arch), dtype=dtype),
            dataclasses.replace(reduced_config(arch), dtype=dtype))


def inputs(cfg, seed: int = 1):
    """Prompt tokens, two decode tokens and the frontend extras, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (2, B, 1)).astype(np.int32)
    extras = {}
    if cfg.frontend == "vit":
        extras["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        extras["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return toks, steps, extras


def prefix_len(cfg) -> int:
    return cfg.frontend_tokens if cfg.frontend == "vit" else 0


def positions(cfg):
    """The two decode steps' per-row positions: row 0 right after the
    prompt, row 1 BACK positions earlier (it overwrites its cache there)."""
    p0 = prefix_len(cfg) + S
    return [np.array([p0 + i, p0 - BACK + i], np.int32) for i in range(2)]


def chunked_applies(cfg) -> bool:
    return "X" not in cfg.layer_pattern and not cfg.enc_dec


def run_reference(arch: str, dtype: str):
    """The reference's outputs (numpy) and params (numpy tree)."""
    jcfg, _ = configs(arch, dtype)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    toks, steps, extras = inputs(jcfg)
    s_max = prefix_len(jcfg) + S + EXTRA
    out = {"params": np_tree(params)}
    logits, aux = jax.jit(lambda p, t, e: jtf.forward(jcfg, p, t, **e))(
        params, toks, extras)
    out["forward"], out["aux"] = np.asarray(logits), float(aux)
    caches = jtf.init_decode_caches(jcfg, B, s_max)
    logits, caches = jax.jit(lambda p, t, c, e: jtf.prefill(
        jcfg, p, t, c, **e))(params, toks, caches, extras)
    out["prefill"] = (np.asarray(logits), np_tree(caches))
    step = jax.jit(lambda p, t, c, pos: jtf.decode_step(jcfg, p, t, c, pos))
    out["decode"] = []
    for tok, pos in zip(steps, positions(jcfg)):
        logits, caches = step(params, tok, caches, pos)
        out["decode"].append((np.asarray(logits), np_tree(caches)))
    if chunked_applies(jcfg):
        caches = jtf.init_decode_caches(jcfg, B, s_max)
        logits, caches = jax.jit(lambda p, t, c: jtf.prefill_chunked(
            jcfg, p, t, c, chunk_len=S // 2))(params, toks, caches)
        out["chunked"] = (np.asarray(logits), np_tree(caches))
    return out


def run_port(arch: str, dtype: str, ref):
    """The port's outputs on the CPU, the same steps on the same inputs
    and the reference's parameters."""
    _, cfg = configs(arch, dtype)
    params = interop.params_from_numpy(cfg, ref["params"], "cpu")
    toks, steps, extras = inputs(cfg)
    toks = torch.from_numpy(toks)
    extras = {k: torch.from_numpy(v) for k, v in extras.items()}
    s_max = prefix_len(cfg) + S + EXTRA
    out = {}
    logits, aux = tf.forward(cfg, params, toks, **extras)
    out["forward"], out["aux"] = logits, float(aux)
    caches = tf.init_decode_caches(cfg, B, s_max, "cpu")
    logits, caches = tf.prefill(cfg, params, toks, caches, **extras)
    out["prefill"] = (logits, interop.to_numpy(caches))
    out["decode"] = []
    for tok, pos in zip(steps, positions(cfg)):
        logits, caches = tf.decode_step(cfg, params, torch.from_numpy(tok),
                                        caches, torch.from_numpy(pos))
        out["decode"].append((logits, interop.to_numpy(caches)))
    if chunked_applies(cfg):
        caches = tf.init_decode_caches(cfg, B, s_max, "cpu")
        logits, caches = tf.prefill_chunked(cfg, params, toks, caches,
                                            chunk_len=S // 2)
        out["chunked"] = (logits, interop.to_numpy(caches))
    return out


def cache_errors(got, want):
    """{leaf path: rel_err} over two cache trees of numpy leaves."""
    errs = {}
    paths_g = jax.tree_util.tree_flatten_with_path(got)[0]
    leaves_w = jax.tree.leaves(want)
    assert len(paths_g) == len(leaves_w)
    for (path, g), w in zip(paths_g, leaves_w):
        errs[jax.tree_util.keystr(path)] = rel_err(g, w)
    return errs


def leaves(tree):
    """The tree's leaves, in ``cache_errors``' order."""
    return jax.tree.leaves(tree)
