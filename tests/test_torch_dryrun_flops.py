"""The dry run's FLOPs on one device against the JAX package's compiled
programs, at the reduced configs of all ten archs, on the CPU.

The port's count is ``roofline.trace_stats`` over the step traced on a
fake device; the reference's is ``hlo_stats.analyze(...).flops`` of the
same step jitted and compiled (the trip-corrected dot FLOPs).

* Prefill and decode: equal, exactly, for every arch.
* Training: the reference's train step computes each microbatch's loss
  once by itself and again inside ``jax.grad`` (``micro_step`` in its
  ``launch/train.py``), and XLA keeps both forwards: its step is
  ``n_micro · (forward + grad)``, held exactly for gemma-2b.  The port
  takes its gradients from the loss it computed (``autograd.grad``), so
  its step is ``n_micro · grad``: one forward fewer.  Where the backward
  costs twice the forward that is 3/4 of the reference.  Held exactly,
  arch by arch: the port's step is ``n_micro`` times its forward and
  backward; for the eight archs without recurrent blocks its forward and
  its forward-and-backward equal the reference's ``jit(loss)`` and
  ``jit(grad(loss))``, so port = reference − n_micro · forward exactly.
* The two archs with recurrent blocks (zamba2-2.7b's Mamba2, xlstm-350m's
  mLSTM) also compute each block's final recurrent state in training,
  which the loss does not read: XLA drops those products as dead code,
  eager PyTorch runs them.  Their forward differs from the reference's
  by exactly the FLOPs of those products (``mamba2``'s ``s_chunk``
  einsum, whose only reader at one chunk is the final state, and
  ``xlstm``'s ``c_fin`` / ``n_fin`` einsums), held exactly.  Their
  backward contracts differently in the two frameworks: the reference's
  grad is 65,536 FLOPs larger at xlstm-350m's shapes and 8,192,000 at
  zamba2-2.7b's; these are printed, and the counter is held to
  ``FlopCounterMode`` on the same program run on real CPU tensors (it
  counts what torch runs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import reduced_config as j_reduced
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro.roofline.hlo_stats import analyze
from repro_torch.configs import ALL_ARCHS, reduced_config
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import fake_mode
from repro_torch.models import mamba2, xlstm
from repro_torch.models import transformer as tf
from repro_torch.roofline.trace_stats import TraceStats, count
from torch_train_ref import one_torch_thread  # noqa: F401

B, S, SMAX = 2, 64, 64          # prefill prompts, decode cache length
MB, MS, N_MICRO = 2, 32, 2      # a microbatch's rows and tokens
RECURRENT = {"zamba2-2.7b": (mamba2, {"bcjn,bcjhp->bchnp"}),
             "xlstm-350m": (xlstm, {"bhs,bshq->bhsq", "bhsp,bshq->bhpq",
                                    "bhs,bshp->bhp"})}


def extras(cfg, b):
    out = {}
    if cfg.frontend == "vit":
        out["prefix_embeds"] = (b, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "audio":
        out["enc_frames"] = (b, cfg.enc_seq, cfg.d_model)
    return out


def ref_flops(fn, *args) -> float:
    return analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def j_params(jcfg):
    return jax.eval_shape(lambda: jtf.init_params(jcfg, jax.random.PRNGKey(0)))


def j_batch(jcfg, cfg, b, s, labels=True):
    dt = jnp.dtype(jcfg.dtype)
    out = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if labels:
        out["labels"] = jax.ShapeDtypeStruct((b, s), jnp.int32)
    out.update({k: jax.ShapeDtypeStruct(v, dt)
                for k, v in extras(cfg, b).items()})
    return out


def t_specs(cfg, b, s, labels=True):
    dt = getattr(torch, cfg.dtype)
    out = {"tokens": ((b, s), torch.int32)}
    if labels:
        out["labels"] = ((b, s), torch.int32)
    out.update({k: (v, dt) for k, v in extras(cfg, b).items()})
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serving_flops_equal_reference(arch):
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    p = j_params(jcfg)
    cache_len = S + (jcfg.frontend_tokens if jcfg.frontend == "vit" else 0)
    c = jax.eval_shape(lambda: jtf.init_decode_caches(jcfg, B, cache_len))
    batch = j_batch(jcfg, cfg, B, S, labels=False)
    toks = batch.pop("tokens")
    want = ref_flops(lambda p, c, t, e: jserve.make_prefill_step(jcfg)(
        p, c, t, **e), p, c, toks, batch)
    _, got = serve.lower_prefill_step(cfg, None, batch=B, seq_len=S,
                                      specs=t_specs(cfg, B, S, False)
                                      ).trace()
    assert got.stats("cpu:0").flops == want

    c = jax.eval_shape(lambda: jtf.init_decode_caches(jcfg, B, SMAX))
    if jcfg.enc_dec:
        c = {**c, "xkv": jax.eval_shape(jserve._xkv_builder(jcfg, B))}
    want = ref_flops(jserve.make_decode_step(jcfg), p, c,
                     jax.ShapeDtypeStruct((B, 1), jnp.int32),
                     jax.ShapeDtypeStruct((B,), jnp.int32))
    _, got = serve.lower_serve_step(
        cfg, None, batch=B, seq_len=SMAX,
        specs={"token": ((B, 1), torch.int32), "pos": ((B,), torch.int32)}
    ).trace()
    assert got.stats("cpu:0").flops == want


def port_micro(cfg, real=False):
    """The port's FLOPs of one microbatch's loss, and of the loss with
    its gradients, traced on a fake device (or, ``real``, run on CPU
    tensors under ``FlopCounterMode``)."""
    def run():
        params = tf.tree_map(lambda s: torch.zeros(
            s.shape, dtype=s.dtype, device=dev), tf.init_params(
                cfg, None, "meta"))
        mb = {k: torch.zeros(s, dtype=dt, device=dev)
              for k, (s, dt) in t_specs(cfg, MB, MS).items()}
        live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)

        def grad():
            loss, _ = tf.loss_fn(cfg, live, mb)
            return torch.autograd.grad(loss, tf.tree_leaves(live),
                                       allow_unused=True)

        if real:
            with FlopCounterMode(display=False) as fc:
                grad()
            _, cnt = count(grad)
            return fc.get_total_flops(), cnt.total_flops()
        with torch.no_grad():
            _, fwd = count(lambda: tf.loss_fn(cfg, params, mb))
        _, both = count(grad)
        return fwd.total_flops(), both.total_flops()

    if real:
        dev = "cpu"
        return run()
    dev = "cpu:0"
    with fake_mode():
        return run()


def dead_state_flops(cfg, module, equations) -> float:
    """FLOPs of the einsums that only make the final recurrent state,
    in one microbatch's training forward."""
    seen = [0.0]
    einsum = torch.einsum

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        def einsum(self, eq, *ops):
            if eq not in equations:
                return einsum(eq, *ops)
            c = TraceStats()
            with c:
                out = einsum(eq, *ops)
            seen[0] += c.total_flops()
            return out

    module.torch = Torch()
    try:
        with fake_mode(), torch.no_grad():
            params = tf.tree_map(lambda s: torch.zeros(
                s.shape, dtype=s.dtype, device="cpu:0"), tf.init_params(
                    cfg, None, "meta"))
            mb = {k: torch.zeros(s, dtype=dt, device="cpu:0")
                  for k, (s, dt) in t_specs(cfg, MB, MS).items()}
            tf.loss_fn(cfg, params, mb)
    finally:
        module.torch = torch
    return seen[0]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_flops_against_reference(arch):
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    p = j_params(jcfg)
    mb = j_batch(jcfg, cfg, MB, MS)
    ref_fwd = ref_flops(lambda p, b: jtf.loss_fn(jcfg, p, b)[0], p, mb)
    ref_grad = ref_flops(jax.grad(lambda p, b: jtf.loss_fn(jcfg, p, b)[0]),
                         p, mb)
    fwd, both = port_micro(cfg)
    _, step = train.lower_train_step(
        cfg, train.TrainConfig(n_micro=N_MICRO), None,
        t_specs(cfg, N_MICRO * MB, MS)).trace()
    assert step.stats("cpu:0").flops == N_MICRO * both
    if arch not in RECURRENT:
        assert (fwd, both) == (ref_fwd, ref_grad)
        return
    module, equations = RECURRENT[arch]
    assert fwd - ref_fwd == dead_state_flops(cfg, module, equations) > 0
    print(f"{arch}: backward, reference {ref_grad - ref_fwd:.0f}, port "
          f"{both - fwd:.0f}")
    counted, traced = port_micro(dataclasses.replace(cfg, dtype="float32"),
                                 real=True)
    assert counted == traced


def test_reference_train_step_runs_the_forward_twice():
    jcfg, cfg = j_reduced("gemma-2b"), reduced_config("gemma-2b")
    tc = jtrain.TrainConfig(n_micro=N_MICRO)
    st = jax.eval_shape(lambda: jtrain.init_train_state(
        jcfg, jax.random.PRNGKey(0), tc))
    want = ref_flops(jtrain.make_train_step(jcfg, tc, None), st,
                     j_batch(jcfg, cfg, N_MICRO * MB, MS))
    p, mb = j_params(jcfg), j_batch(jcfg, cfg, MB, MS)
    ref_fwd = ref_flops(lambda p, b: jtf.loss_fn(jcfg, p, b)[0], p, mb)
    ref_grad = ref_flops(jax.grad(lambda p, b: jtf.loss_fn(jcfg, p, b)[0]),
                         p, mb)
    assert want == N_MICRO * (ref_fwd + ref_grad)
    _, got = train.lower_train_step(
        cfg, train.TrainConfig(n_micro=N_MICRO), None,
        t_specs(cfg, N_MICRO * MB, MS)).trace()
    assert got.stats("cpu:0").flops * 4 == want * 3
