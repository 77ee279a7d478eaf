"""The port's checkpoints (``repro_torch.ckpt``): the reference's own
checks (``tests/test_ckpt.py``) run on the port, and checkpoints that
cross between the packages bit for bit in both directions (the same
``host_0.npz`` / ``manifest.json`` format: leaf keys joined by ``::``,
NamedTuple fields as ``.name``, bfloat16 stored as its uint16 view).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as j_restore
from repro.ckpt import save_checkpoint as j_save
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import init_train_state as j_init_train_state
from repro_torch.ckpt import (CheckpointManager, restore_checkpoint,
                              save_checkpoint)
from repro_torch.launch.train import TrainConfig, init_train_state
from repro_torch.models import interop
from repro_torch.models import transformer as tf
from repro_torch.optim._tree import sorted_leaves
from torch_models_ref import np_tree
import torch_train_ref as T
from torch_train_ref import one_torch_thread  # noqa: F401


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(16, 32))).float(),
                   "b": torch.from_numpy(rng.normal(size=(32,)).astype(
                       np.float32)).to(torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "mu": torch.from_numpy(rng.normal(size=(16, 32))).float()},
    }


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _assert_same(a_tree, b_tree):
    a, b = tf.tree_leaves(a_tree), tf.tree_leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# the reference's tests/test_ckpt.py, on the port
# ---------------------------------------------------------------------------

def test_roundtrip_exact(tmp_path):
    tree = _tree()
    save_checkpoint(tmp_path, 3, tree)
    got, step = restore_checkpoint(tmp_path, tree)
    assert step == 3
    _assert_same(got, tree)


def test_crc_detects_corruption(tmp_path):
    tree = _tree()
    d = save_checkpoint(tmp_path, 1, tree)
    # flip bytes in the npz payload
    f = d / "host_0.npz"
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    data[len(data) // 2 + 1] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(Exception):
        restore_checkpoint(tmp_path, tree)


def test_manager_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 30
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [20, 30]


def test_async_save(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, _tree(), blocking=False)
    mgr.wait()
    got, step = mgr.restore(_tree())
    assert step == 5


def test_atomic_save_no_partial(tmp_path):
    """A leftover .tmp dir must never shadow a complete checkpoint."""
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree())
    (tmp_path / "step_00000002.tmp").mkdir()
    assert mgr.latest_step() == 1
    got, step = mgr.restore(_tree())
    assert step == 1


def test_restore_onto_a_given_device(tmp_path):
    """``device=`` (the reference's ``shardings=``) places every leaf."""
    tree = _tree()
    save_checkpoint(tmp_path, 2, tree)
    like = tf.tree_map(lambda t: t.to("meta"), tree)
    got, step = restore_checkpoint(tmp_path, like, device="cpu")
    assert all(t.device.type == "cpu" for t in tf.tree_leaves(got))
    _assert_same(got, tree)


def test_async_save_copies_before_the_thread_starts(tmp_path):
    """The optimizers update tensors in place: a save that returned keeps
    the values it was given."""
    tree = _tree()
    want = tf.tree_map(torch.clone, tree)
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(4, tree, blocking=False)
    for t in tf.tree_leaves(tree):
        t.add_(1)
    mgr.wait()
    got, _ = mgr.restore(want)
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _states(opt_8bit):
    """A reference TrainState (bf16 params, every leaf nonzero) and the
    port's copy of it."""
    jcfg, cfg = T.configs("gemma-2b", dtype="bfloat16")
    kw = dict(opt_8bit=opt_8bit)
    jstate = j_init_train_state(jcfg, jax.random.PRNGKey(0),
                                JTrainConfig(**kw))
    jstate = jax.tree.map(lambda x: x + 3, jstate)
    state = interop.train_state_from_numpy(cfg, np_tree(jstate),
                                           TrainConfig(**kw), "cpu")
    like = init_train_state(cfg, None, TrainConfig(**kw), device="meta")
    return jstate, state, like


def _assert_bits(port_state, ref_state):
    got = sorted_leaves(interop.to_numpy(port_state))
    want = jax.tree.leaves(np_tree(ref_state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("opt_8bit", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, opt_8bit):
    jstate, _, like = _states(opt_8bit)
    j_save(tmp_path, 11, jstate, extra={"arch": "gemma-2b"})
    got, step = restore_checkpoint(tmp_path, like, device="cpu")
    assert step == 11
    _assert_bits(got, jstate)


@pytest.mark.parametrize("opt_8bit", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, opt_8bit):
    jstate, state, _ = _states(opt_8bit)
    save_checkpoint(tmp_path, 12, state)
    like = jax.tree.map(jnp.zeros_like, jstate)
    got, step = j_restore(tmp_path, like)
    assert step == 12
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(
            np.asarray(g).reshape(-1).view(np.uint8),
            np.asarray(w).reshape(-1).view(np.uint8))


def test_manifests_are_the_same(tmp_path):
    """The same keys (``.params::embed``, ``.opt::.mu::embed``, ...),
    shapes, dtypes, stored forms and CRCs."""
    jstate, state, _ = _states(True)
    j_save(tmp_path / "ref", 1, jstate)
    save_checkpoint(tmp_path / "port", 1, state)
    ref, port = (json.loads((tmp_path / d / "step_00000001" /
                             "manifest.json").read_text())
                 for d in ("ref", "port"))
    assert ".params::embed" in port["leaves"]
    assert ".opt::.q_mu::stack::p0::attn::wq" in port["leaves"]
    assert port == ref
