"""The port's optimizers, schedule and train step against the JAX
package's, on the CPU, and the reference's own training checks
(``tests/test_train.py``) run on the port.

* ``cosine_schedule`` at steps before, at and after warmup and past
  ``total``: within rtol 1e-6 (float32, the same operations).
* ``adamw_update`` / ``adamw8_update`` on identical inputs (the
  reference's parameters of reduced gemma-2b, and two of its gradient
  trees carried across), two steps, with the clip off and on: the
  moments, scales and int8 / uint8 codes bit-equal without clipping,
  the parameters within rtol 1e-6 (atol 1e-9; bit-equal in bfloat16),
  ``grad_norm`` within rtol 1e-6.  With clipping the norm's sum order
  parts them by roundings (each test says how far: moments within 1e-5
  of each leaf's scale).
* One whole ``train_step`` (AdamW, warmup 0, so the first step moves) at
  n_micro 1 and 4, on the reference's parameters: loss and
  ``grad_norm`` within 1e-5, ``lr`` within rtol 1e-6, the moments within
  1e-4 (``mu``) and 2e-4 (``nu``, a square) of each leaf's scale.  The
  parameters: Adam's first step moves each weight by lr·g/(|g| + eps),
  about lr·sign(g), so a weight whose gradient is within the gradients'
  tolerance (1e-4 of its leaf's scale) of zero may move either way: those
  are held to 2·lr·(1 + wd·|p|) + 1e-7, the rest (|mu| over 1e-3 of the
  leaf's scale) to lr·1e-4 + 1e-7 and two float32 steps of |p|.
* ``train_state_from_numpy`` takes the reference's AdamW and AdamW8
  states leaf for leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import init_train_state as j_init_train_state
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import transformer as jtf
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.optim.adamw8 import adamw8_init as j_adamw8_init
from repro.optim.adamw8 import adamw8_update as j_adamw8_update
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import (TrainConfig, TrainState,
                                      init_train_state, make_train_step)
from repro_torch.models import interop
from repro_torch.models import transformer as tf
from repro_torch.optim import (adamw8_init, adamw8_update, adamw_init,
                               adamw_update, cosine_schedule)
from repro_torch.optim._tree import sorted_leaves
from torch_models_ref import np_tree
import torch_train_ref as T
from torch_train_ref import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 10])
def test_cosine_schedule_matches_reference(warmup):
    steps = [0, 1, 5, 10, 11, 50, 99, 100, 150]
    got = [float(cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                 peak_lr=1e-3, warmup=warmup, total=100))
           for s in steps]
    want = [float(j_cosine_schedule(jnp.asarray(s, jnp.int32), peak_lr=1e-3,
                                    warmup=warmup, total=100))
            for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == (0.0 if warmup else pytest.approx(1e-3))


# ---------------------------------------------------------------------------
# the optimizers on identical inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grad_inputs():
    """The reference's reduced gemma-2b parameters and two gradient
    trees (two batches), as numpy and as reference trees."""
    jcfg, _ = T.configs("gemma-2b")
    params = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    f = jax.jit(jax.grad(lambda p, b: jtf.loss_fn(jcfg, p, b)[0]))
    grads = [f(params, T.train_batch(jcfg, seed=s)) for s in (1, 2)]
    return params, grads


def _cast(tree, dtype):
    return jax.tree.map(lambda x: x.astype(dtype), tree)


def _port(tree):
    """A reference tree of arrays as the port's tensors (CPU)."""
    return jax.tree.map(lambda x: interop._from_numpy(
        torch.empty(x.shape, dtype=getattr(torch, str(x.dtype)),
                    device="meta"), np_tree(x), "cpu", ""), tree)


def _codes(state):
    return [np.asarray(x, np.int32) for part in ("q_mu", "q_nu")
            for x in sorted_leaves(getattr(state, part))]


def _blocks(mask):
    """Per 256-wide block of the last axis: does it hold a True?"""
    n = mask.shape[-1]
    pad = np.zeros(mask.shape[:-1] + (-n % 256,), bool)
    full = np.concatenate([mask, pad], -1)
    return full.reshape(mask.shape[:-1] + (-1, 256)).any(-1)


def _close(got, want, dtype, clip):
    """Parameters: bit-equal in bfloat16 without clipping; else within
    rtol 1e-6, atol 1e-9 (a few float32 steps of a 1e-3 update)."""
    if dtype == "bfloat16" and clip == "off":
        np.testing.assert_array_equal(T.as_f32(got), T.as_f32(want))
    else:
        np.testing.assert_allclose(T.as_f32(got), T.as_f32(want),
                                   rtol=1e-6, atol=1e-9)


CLIP = {"off": 1e9, "on": 1.0}


@pytest.mark.parametrize("clip", ["off", "on"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_on_identical_inputs(grad_inputs, dtype,
                                                     clip):
    """Without clipping (the norm 3.9 under ``clip_norm``) the moments
    are bit-equal.  With it, the clip scale divides by the norm, which
    the two packages sum in another order (XLA's reduction against
    torch's: 3.9489152 against 3.9489164), so every moment is a rounding
    apart: rtol 1e-5."""
    params, grads = grad_inputs
    jp = _cast(params, dtype)
    jg = [_cast(g, dtype) for g in grads]
    js = j_adamw_init(jp)
    tp = _port(jp)
    ts = adamw_init(tp)
    for g in jg:
        jp, js, jm = j_adamw_update(jp, g, js, lr=1e-3, clip_norm=CLIP[clip])
        tp, ts, tm = adamw_update(tp, _port(g), ts, lr=1e-3,
                                  clip_norm=CLIP[clip])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts.step) == int(js.step)
        for a, b in zip(sorted_leaves(tp), jax.tree.leaves(jp)):
            _close(a, np.asarray(b), dtype, clip)
        for part in ("mu", "nu"):
            for a, b in zip(sorted_leaves(getattr(ts, part)),
                            jax.tree.leaves(getattr(js, part))):
                if clip == "off":
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                else:
                    assert T.leaf_err(a.numpy(), np.asarray(b)) <= 1e-5


@pytest.mark.parametrize("clip", ["off", "on"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw8_matches_reference_on_identical_inputs(grad_inputs, dtype,
                                                      clip):
    """Without clipping the codes and scales are bit-equal.  With it,
    every moment is a rounding apart (the norm's sum order, as for
    AdamW), and a code whose value before rounding lies that close to a
    half step lands one step apart: at most one step, in under 0.1 % of
    the elements (measured: 1-3 of 344,704 in float32, up to 206 in
    bfloat16); scales within rtol 1e-5 but in a block holding a code
    that parted at the step before (its dequantized moment is a step
    apart).  A weight whose code parted at the step before takes another
    update, so it is held to 2·lr only."""
    params, grads = grad_inputs
    jp = _cast(params, dtype)
    jg = [_cast(g, dtype) for g in grads]
    js = j_adamw8_init(jp)
    tp = _port(jp)
    ts = adamw8_init(tp)
    parted = [np.zeros(x.shape, bool) for x in sorted_leaves(tp)]
    for g in jg:
        jp, js, jm = j_adamw8_update(jp, g, js, lr=1e-3,
                                     clip_norm=CLIP[clip])
        tp, ts, tm = adamw8_update(tp, _port(g), ts, lr=1e-3,
                                   clip_norm=CLIP[clip])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for a, b, off in zip(sorted_leaves(tp), jax.tree.leaves(jp), parted):
            a, b = T.as_f32(a), T.as_f32(np.asarray(b))
            _close(a[~off], b[~off], dtype, clip)
            assert (np.abs(a - b)[off] <= 2e-3 * (1 + 0.1 * np.abs(b[off]))
                    ).all()
        got, want = _codes(ts), _codes(js)
        assert [g.dtype for g in sorted_leaves(ts.q_mu)] == [torch.int8] * len(
            parted)
        assert [g.dtype for g in sorted_leaves(ts.q_nu)] == [torch.uint8] * len(
            parted)
        for part in ("s_mu", "s_nu"):
            for a, b, off in zip(sorted_leaves(getattr(ts, part)),
                                 jax.tree.leaves(getattr(js, part)), parted):
                free = ~_blocks(off)
                np.testing.assert_allclose(a.numpy()[free],
                                           np.asarray(b)[free],
                                           rtol=0 if clip == "off" else 1e-5)
        diff = [np.abs(a - b) for a, b in zip(got, want)]
        if clip == "off":
            assert not any(d.any() for d in diff)
        else:
            assert max(int(d.max()) for d in diff) <= 1
            n = sum(d.size for d in diff)
            assert sum(int(d.sum()) for d in diff) <= 1e-3 * n
        half = len(parted)
        parted = [(a != 0) | (b != 0) for a, b in zip(diff[:half],
                                                      diff[half:])]


# ---------------------------------------------------------------------------
# one whole train step
# ---------------------------------------------------------------------------

STEP_ARCHS = ["gemma-2b", "qwen3-moe-235b-a22b", "internvl2-26b"]


@pytest.mark.parametrize("n_micro", [1, 4])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference(arch, n_micro):
    jcfg, cfg = T.configs(arch)
    batch = T.train_batch(jcfg, b=4)
    kw = dict(n_micro=n_micro, peak_lr=1e-3, warmup=0, total_steps=10)
    jtc, tc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = j_init_train_state(jcfg, jax.random.PRNGKey(0), jtc)
    state = interop.train_state_from_numpy(cfg, np_tree(jstate), tc, "cpu")
    p0 = [T.as_f32(x) for x in sorted_leaves(state.params)]
    jstate, jm = jax.jit(j_make_train_step(jcfg, jtc, None))(jstate, batch)
    state, m = make_train_step(cfg, tc)(state, T.to_torch(batch))
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state.opt.step) == 1
    lr, wd = float(jm["lr"]), tc.weight_decay
    for part, tol in (("mu", T.GRAD_TOL), ("nu", 2 * T.GRAD_TOL)):
        for a, b in zip(sorted_leaves(getattr(state.opt, part)),
                        jax.tree.leaves(getattr(jstate.opt, part))):
            assert T.leaf_err(T.as_f32(a), np.asarray(b)) <= tol, part
    for a, b, mu, p in zip(sorted_leaves(state.params),
                           jax.tree.leaves(jstate.params),
                           jax.tree.leaves(jstate.opt.mu), p0):
        a, b, mu = T.as_f32(a), T.as_f32(np.asarray(b)), np.asarray(mu)
        clear = np.abs(mu) > 1e-3 * np.abs(mu).max()
        d = np.abs(a - b)
        assert (d[clear] <= lr * 1e-4 + 1e-7 + 2.0 ** -22 * np.abs(
            p[clear])).all()
        assert (d <= 2 * lr * (1 + wd * np.abs(p)) + 1e-7).all()


def test_train_step_on_a_mesh_waits_for_the_mesh_slice():
    """The mesh slice has landed: a ``dist`` mesh gives the mesh step
    (``tests/test_torch_mesh.py`` holds it to the reference's); a bare
    list of devices is refused."""
    from repro_torch.dist import make_mesh
    cfg = reduced_config("gemma-2b")
    with pytest.raises(TypeError, match="make_mesh"):
        make_train_step(cfg, TrainConfig(), mesh=["cpu"])
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    assert callable(make_train_step(cfg, TrainConfig(), mesh=mesh))


@pytest.mark.parametrize("opt_8bit", [False, True])
def test_train_state_crosses_from_the_reference(opt_8bit):
    jcfg, cfg = T.configs("gemma-2b", dtype="bfloat16")
    kw = dict(opt_8bit=opt_8bit)
    jstate = j_init_train_state(jcfg, jax.random.PRNGKey(0),
                                JTrainConfig(**kw))
    jstate = jax.tree.map(lambda x: x + 1 if x.dtype != jnp.bool_ else x,
                          jstate)      # every leaf nonzero
    tree = np_tree(jstate)
    state = interop.train_state_from_numpy(cfg, tree, TrainConfig(**kw),
                                           "cpu")
    assert isinstance(state, TrainState)
    assert type(state.opt).__name__ == type(jstate.opt).__name__
    want = jax.tree.leaves(tree)
    back = sorted_leaves(interop.to_numpy(state))
    assert len(back) == len(want)
    for got, w in zip(back, want):
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
    bad = jax.tree.map(lambda x: x.astype(np.float32) if x.dtype == np.int8
                       else x, tree)
    if opt_8bit:
        with pytest.raises(ValueError, match="q_mu|int8"):
            interop.train_state_from_numpy(cfg, bad, TrainConfig(**kw),
                                           "cpu")


# ---------------------------------------------------------------------------
# the reference's tests/test_train.py, on the port
# ---------------------------------------------------------------------------

def _tiny_cfg(dtype="float32"):
    cfg = reduced_config("gemma-2b")
    return dataclasses.replace(cfg, n_layers=2, vocab=256, dtype=dtype)


def _gen():
    return torch.Generator().manual_seed(0)


def _batch(data, t):
    return {k: torch.from_numpy(v) for k, v in data.batch_at(t).items()}


def test_loss_decreases():
    cfg = _tiny_cfg()
    tcfg = TrainConfig(n_micro=2, peak_lr=3e-3, warmup=5, total_steps=60,
                       fsdp=False, zero1=False)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, batch=8, seed=0)
    state = init_train_state(cfg, _gen(), tcfg, device="cpu")
    step = make_train_step(cfg, tcfg, None)
    losses = []
    for t in range(40):
        state, metrics = step(state, _batch(data, t))
        losses.append(float(metrics["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(last)
    assert last < first - 0.3, (first, last)


def test_grad_accum_equivalence():
    """n_micro=1 vs n_micro=4 must give (nearly) identical updates."""
    cfg = _tiny_cfg("float32")
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=8, seed=1)
    batch = _batch(data, 0)
    out = {}
    for n in (1, 4):
        tcfg = TrainConfig(n_micro=n, fsdp=False, zero1=False)
        state = init_train_state(cfg, _gen(), tcfg, device="cpu")
        new_state, m = make_train_step(cfg, tcfg, None)(state, batch)
        out[n] = (new_state.params, float(m["loss"]))
    l1, l4 = out[1][1], out[4][1]
    assert abs(l1 - l4) < 1e-4 * max(1.0, abs(l1))
    for a, b in zip(tf.tree_leaves(out[1][0]), tf.tree_leaves(out[4][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_adamw8_tracks_adamw():
    """8-bit moments track exact AdamW closely over a few steps."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(0, 0.1, (64, 512))).float(),
              "b": torch.from_numpy(rng.normal(0, 0.1, (512,))).float()}
    p32 = tf.tree_map(torch.clone, params)
    p8 = tf.tree_map(torch.clone, params)
    s32, s8 = adamw_init(p32), adamw8_init(p8)
    for t in range(5):
        grads = tf.tree_map(lambda p: torch.from_numpy(
            rng.normal(0, 0.01, tuple(p.shape))).float(), params)
        p32, s32, _ = adamw_update(p32, grads, s32, lr=1e-3)
        p8, s8, _ = adamw8_update(p8, grads, s8, lr=1e-3)
    for a, b in zip(tf.tree_leaves(p32), tf.tree_leaves(p8)):
        err = float((a - b).abs().max())
        scale = float(a.abs().max()) + 1e-9
        assert err / scale < 0.05, err / scale


def test_cosine_schedule_shape():
    warm = cosine_schedule(torch.tensor(5), peak_lr=1e-3, warmup=10,
                           total=100)
    peak = cosine_schedule(torch.tensor(10), peak_lr=1e-3, warmup=10,
                           total=100)
    end = cosine_schedule(torch.tensor(100), peak_lr=1e-3, warmup=10,
                          total=100, floor=0.1)
    assert float(warm) < float(peak)
    assert abs(float(peak) - 1e-3) < 1e-6
    assert abs(float(end) - 1e-4) < 1e-6


def test_moe_arch_trains():
    cfg = dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"),
                              vocab=256, dtype="float32")
    tcfg = TrainConfig(n_micro=1, peak_lr=5e-3, warmup=3, total_steps=40,
                       fsdp=False, zero1=False)
    # single fixed batch: the MoE stack can fit it (routing, experts and
    # the aux loss all receive gradients)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=3)
    batch = _batch(data, 0)
    state = init_train_state(cfg, _gen(), tcfg, device="cpu")
    step = make_train_step(cfg, tcfg, None)
    losses = []
    for t in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
