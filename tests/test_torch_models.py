"""The port's model stack against the JAX package's, whole, for each of
the 10 architectures at ``reduced_config`` in float32 on the CPU:
``forward`` logits, ``prefill`` (last logits and every cache leaf), two
``decode_step``s with the rows at different positions (logits and every
cache leaf after each) and ``prefill_chunked`` where the reference runs
it (the port refuses it where the reference does).  The same inputs and
the reference's parameters go to both (``torch_models_ref``).

Tolerance: max |port - reference| <= 1e-4 * max(1, max |reference|) for
each compared tensor (float32 sums in another order; measured up to
4e-6 here).  Also, port only: the decode logits after prefill equal
``forward``'s at the same positions (teacher forcing).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as tf
import torch_models_ref as R

TOL = 1e-4


@pytest.fixture(scope="module", params=ALL_ARCHS)
def run(request):
    ref = R.run_reference(request.param, "float32")
    return request.param, ref, R.run_port(request.param, "float32", ref)


def _check_caches(got, want):
    errs = R.cache_errors(got, want)
    bad = {k: v for k, v in errs.items() if v > TOL}
    assert not bad, bad


def test_forward_matches_reference(run):
    _, ref, got = run
    assert R.rel_err(got["forward"], ref["forward"]) <= TOL
    assert abs(got["aux"] - ref["aux"]) <= TOL * max(1.0, abs(ref["aux"]))


def test_prefill_matches_reference(run):
    _, ref, got = run
    assert R.rel_err(got["prefill"][0], ref["prefill"][0]) <= TOL
    _check_caches(got["prefill"][1], ref["prefill"][1])


def test_decode_steps_at_per_row_positions_match_reference(run):
    _, ref, got = run
    for (gl, gc), (wl, wc) in zip(got["decode"], ref["decode"]):
        assert R.rel_err(gl, wl) <= TOL
        _check_caches(gc, wc)


def test_prefill_chunked_matches_reference(run):
    arch, ref, got = run
    if not R.chunked_applies(reduced_config(arch)):
        cfg = reduced_config(arch)
        params = tf.init_params(cfg, None, "meta")
        with pytest.raises(NotImplementedError, match="cache-continuable"):
            tf.prefill_chunked(cfg, params, torch.zeros(
                (R.B, R.S), dtype=torch.int32, device="meta"), {})
        assert "chunked" not in ref
        return
    assert R.rel_err(got["chunked"][0], ref["chunked"][0]) <= TOL
    _check_caches(got["chunked"][1], ref["chunked"][1])


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_after_prefill_equals_teacher_forcing(arch):
    """Prefill 16 tokens, then decode 4 fed tokens one by one: each decode
    step's logits equal ``forward``'s over the whole sequence at that
    position (1e-4).  MoE archs run at a capacity factor of
    n_experts / top_k, where no assignment is dropped: at 1.25 the
    forward pass over 20 tokens drops assignments that a one-token step
    keeps, in the reference too."""
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)))
    extras = {}
    if cfg.frontend == "vit":
        extras["prefix_embeds"] = torch.randn(
            (2, cfg.frontend_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(1))
    if cfg.frontend == "audio":
        extras["enc_frames"] = torch.randn(
            (2, cfg.enc_seq, cfg.d_model),
            generator=torch.Generator().manual_seed(1))
    pre = R.prefix_len(cfg)
    full, _ = tf.forward(cfg, params, toks, **extras)
    caches = tf.init_decode_caches(cfg, 2, pre + 20, "cpu")
    last, caches = tf.prefill(cfg, params, toks[:, :16], caches, **extras)
    assert R.rel_err(last[:, 0], full[:, pre + 15]) <= TOL
    for i in range(16, 20):
        pos = torch.full((2,), pre + i)
        logits, caches = tf.decode_step(cfg, params, toks[:, i:i + 1],
                                        caches, pos)
        assert R.rel_err(logits[:, 0], full[:, pre + i]) <= TOL, i
