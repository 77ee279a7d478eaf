"""Run the JAX package's training pieces and the port's on the same
inputs, for the training parity tests (``tests/test_torch_train*.py``).

One reference run per architecture: the loss and ``jax.grad`` of
``loss_fn`` (jitted), on the reference's ``init_params`` carried to the
port by ``repro_torch.models.interop``.  Inputs come from a numpy seed:
tokens, next-token labels with some positions masked (-1), and the
frontend extras of ``torch_models_ref.inputs``.  Gradient leaves are
compared in the reference's leaf order (dict keys sorted), which
``repro_torch.optim._tree.sorted_paths`` gives for the port's trees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import transformer as jtf
from repro_torch.configs import reduced_config
from repro_torch.models import interop
from repro_torch.models import transformer as tf
from repro_torch.optim._tree import sorted_paths
from torch_models_ref import np_tree

#: a loss's tolerance (relative to max(1, |loss|)) and a gradient leaf's
#: (relative to the leaf's largest |value|)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread: the suite runs several workers on
    the machine's cores, and torch's intra-op pool of one thread per core
    in every worker oversubscribes them (a 3 s training test took 310 s
    that way); alone, these small products run as fast on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch: str, dtype: str = "float32", **changes):
    return (dataclasses.replace(j_reduced(arch), dtype=dtype, **changes),
            dataclasses.replace(reduced_config(arch), dtype=dtype,
                                **changes))


def train_batch(cfg, b: int = 2, s: int = 32, seed: int = 1):
    """A numpy batch: tokens, next-token labels (the last position and
    the first three of row 0 masked) and the frontend extras."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.frontend == "vit":
        out["prefix_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        out["enc_frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def reference_grads(jcfg, params, batch):
    """(loss, [grad leaves as numpy, reference order]) of ``loss_fn``."""
    f = jax.jit(jax.value_and_grad(lambda p, b: jtf.loss_fn(jcfg, p, b)[0]))
    loss, grads = f(params, batch)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def port_grads(cfg, params, batch):
    """(loss, {path: grad as numpy}) of the port's ``loss_fn``, the paths
    in the reference's leaf order."""
    live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, _ = tf.loss_fn(cfg, live, to_torch(batch))
    paths = list(sorted_paths(live))
    grads = torch.autograd.grad(loss, [leaf for _, leaf in paths])
    return float(loss.detach()), {p: g.numpy() for (p, _), g in
                                  zip(paths, grads)}


def run(arch: str):
    """The reference's and the port's loss and gradients on the
    reference's parameters."""
    jcfg, cfg = configs(arch)
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    batch = train_batch(jcfg)
    ref = reference_grads(jcfg, params, batch)
    p_np = np_tree(params)
    got = port_grads(cfg, interop.params_from_numpy(cfg, p_np, "cpu"), batch)
    return dict(arch=arch, ref=ref, got=got, params=p_np, batch=batch)


def leaf_err(got, want) -> float:
    """max |got - want| over the leaf's largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)),
                float(np.finfo(np.float32).tiny))
    return float(np.abs(got - want).max(initial=0.0)) / scale


def as_f32(x):
    """A numpy leaf (bf16 as its uint16 bits) or tensor as float32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    x = np.asarray(x)
    if x.dtype == np.uint16:
        return (x.astype(np.uint32) << 16).view(np.float32)
    if x.dtype == jnp.bfloat16:
        return x.astype(np.float32)
    return x
