"""The port's training loss and its gradient against ``jax.grad`` of the
JAX package's ``loss_fn``, for each of the 10 architectures at
``reduced_config`` in float32 on the CPU, on the reference's parameters
and the same batch (``torch_train_ref``): the VLM's prefix masked out of
the labels, the MoE aux loss, the enc-dec cross stack.

Tolerances: the loss within 1e-5 of max(1, |loss|); every gradient leaf
within 1e-4 of the leaf's largest |value| (float32 sums in another
order; up to 3.6e-5 measured, on zamba2's ``a_log``, whose gradient is
a sum over every position and row that cancels to 1e-3; every other
leaf under 4e-6).  Also, port only:
``remat="full"`` gives the gradients of ``remat="none"`` within 1e-6 of
each leaf's scale, and the gradient norm is finite (the reference's
``scripts/dev_check_models.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro_torch.models import interop
import torch_train_ref as T
from torch_train_ref import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=ALL_ARCHS)
def run(request):
    return T.run(request.param)


def test_loss_matches_reference(run):
    (want, _), (got, _) = run["ref"], run["got"]
    assert abs(got - want) <= T.LOSS_TOL * max(1.0, abs(want)), (got, want)


def test_every_gradient_leaf_matches_reference(run):
    (_, want), (_, got) = run["ref"], run["got"]
    assert len(got) == len(want)
    errs = {"/".join(map(str, p)): T.leaf_err(g, w)
            for (p, g), w in zip(got.items(), want)}
    bad = {k: v for k, v in errs.items() if v > T.GRAD_TOL}
    assert not bad, bad
    norm = np.sqrt(sum(float(np.sum(np.square(g))) for g in got.values()))
    assert np.isfinite(norm) and norm > 0


def test_remat_full_gives_the_gradients_of_remat_none(run):
    _, cfg = T.configs(run["arch"])
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        params = interop.params_from_numpy(c, run["params"], "cpu")
        out[remat] = T.port_grads(c, params, run["batch"])
    assert out["full"][0] == out["none"][0]
    for p, g in out["full"][1].items():
        assert T.leaf_err(g, out["none"][1][p]) <= 1e-6, p


def test_remat_runs_under_checkpoint_only_while_grad_is_enabled(
        monkeypatch):
    """The training forward recomputes each pattern group (one
    ``checkpoint`` call a group); ``no_grad`` and the serving modes call
    none."""
    from repro_torch.models import transformer as tf
    _, cfg = T.configs("zamba2-2.7b", remat="full")
    calls = []
    real = tf.checkpoint
    monkeypatch.setattr(tf, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = T.to_torch(T.train_batch(cfg))
    live = tf.tree_map(lambda t: t.requires_grad_(), params)
    tf.loss_fn(cfg, live, batch)[0].backward()
    assert len(calls) == cfg.pattern_reps
    with torch.no_grad():
        tf.loss_fn(cfg, live, batch)
    assert len(calls) == cfg.pattern_reps
