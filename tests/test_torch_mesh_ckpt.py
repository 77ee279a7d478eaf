"""Checkpoints across meshes and across packages (``repro_torch.ckpt``
with ``shardings=``, ``ft.ElasticTrainer.resume(shardings=)``), on CPU
meshes:

* a port checkpoint of a placed train state (AdamW and AdamW8), saved
  from a (2, 4) mesh, restores onto (1, 8), (8, 1) and one device bit
  for bit, an async save included (the leaves are gathered before the
  thread starts, so a step taken meanwhile does not reach the file);
* a reference checkpoint (written on one device, as
  ``tests/test_torch_ckpt.py`` writes it) restores onto a port mesh,
  each position holding only its block, and ``gather`` gives its leaves
  back bit for bit;
* ``ElasticTrainer`` on the mesh step: a crash, then ``resume`` onto the
  same mesh continues bit-equal to an uninterrupted run, and onto a
  (1, 8) mesh within float32 rounding of it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import save_checkpoint as j_save
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import init_train_state as j_init_train_state
from repro_torch.ckpt import CheckpointManager, restore_checkpoint
from repro_torch.configs import reduced_config
from repro_torch.dist import sharding as sh
from repro_torch.ft import ElasticTrainer
from repro_torch.launch import train
from repro_torch.models import interop
from repro_torch.optim._tree import sorted_leaves
from torch_models_ref import np_tree
import torch_train_ref as T
from torch_train_ref import one_torch_thread  # noqa: F401

MESHES = {"d2m4": (2, 4), "d1m8": (1, 8), "d8m1": (8, 1)}


def mesh(name):
    return sh.make_mesh(MESHES[name], ("data", "model"), devices=["cpu"] * 8)


def cfgs(opt_8bit=False, dtype="float32"):
    cfg = dataclasses.replace(reduced_config("gemma-2b"), n_layers=2,
                              vocab=512, dtype=dtype)
    return cfg, train.TrainConfig(n_micro=2, peak_lr=1e-3, warmup=0,
                                  total_steps=10, opt_8bit=opt_8bit)


def shardings(cfg, tc, m):
    like = train.init_train_state(cfg, None, tc, device="meta")
    return like, train.state_shardings(cfg, tc, m, like)


def batch(cfg, step=0):
    rng = np.random.default_rng(step)
    toks = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, 1))}


def raw(x):
    return np.asarray(x).reshape(-1).view(np.uint8)


def bits(tree):
    return [raw(x) for x in sorted_leaves(interop.to_numpy(tree))]


def assert_bits(a, b):
    a, b = bits(a), bits(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def assert_placed(tree, shards):
    """Every leaf placed by its sharding, each position holding exactly
    its block of the global value."""
    for x, s in zip(sorted_leaves(tree), sorted_leaves(shards)):
        assert isinstance(x, sh.Sharded) and x.sharding is s
        full = x.read(device="cpu")
        for p, shard in enumerate(x.shards):
            assert tuple(shard.shape) == s.shard_shape(x.shape)
            assert torch.equal(shard.view(torch.uint8) if shard.dtype ==
                               torch.bool else shard, full[x.block(p)])


@pytest.mark.parametrize("opt_8bit", [False, True])
def test_checkpoint_crosses_meshes_bit_for_bit(tmp_path, opt_8bit):
    cfg, tc = cfgs(opt_8bit)
    like, sh24 = shardings(cfg, tc, mesh("d2m4"))
    state = sh.device_put(train.init_train_state(
        cfg, torch.Generator().manual_seed(0), tc, "cpu"), sh24)
    step = train.make_train_step(cfg, tc, mesh("d2m4"))
    state, _ = step(state, batch(cfg))
    saved = interop.to_numpy(state)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, state, blocking=False)
    state, _ = step(state, batch(cfg, 1))      # moves the live state
    mgr.wait()
    assert mgr.latest_step() == 1
    for name in ("d1m8", "d8m1"):
        _, target = shardings(cfg, tc, mesh(name))
        got, s = mgr.restore(like, shardings=target)
        assert s == 1
        assert_placed(got, target)
        for x, y in zip(bits(got), map(raw, sorted_leaves(saved))):
            np.testing.assert_array_equal(x, y)
    one, _ = restore_checkpoint(tmp_path, like, device="cpu")
    for x, y in zip(bits(one), map(raw, sorted_leaves(saved))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("opt_8bit", [False, True])
def test_reference_checkpoint_restores_onto_a_port_mesh(tmp_path, opt_8bit):
    jcfg, cfg = T.configs("gemma-2b", dtype="bfloat16")
    kw = dict(opt_8bit=opt_8bit)
    jstate = j_init_train_state(jcfg, jax.random.PRNGKey(0),
                                JTrainConfig(**kw))
    jstate = jax.tree.map(lambda x: x + 3, jstate)
    j_save(tmp_path, 5, jstate)
    tc = train.TrainConfig(**kw)
    like, target = shardings(cfg, tc, mesh("d2m4"))
    got, step = restore_checkpoint(tmp_path, like, shardings=target)
    assert step == 5
    assert_placed(got, target)
    want = jax.tree.leaves(np_tree(jstate))
    back = sorted_leaves(interop.to_numpy(sh.gather(got, "cpu")))
    assert len(back) == len(want)
    for g, w in zip(back, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_elastic_trainer_resumes_on_a_mesh(tmp_path):
    cfg, tc = cfgs()
    init = train.init_train_state(cfg, torch.Generator().manual_seed(0), tc,
                                  "cpu")
    like, sh24 = shardings(cfg, tc, mesh("d2m4"))
    step24 = train.make_train_step(cfg, tc, mesh("d2m4"))

    def data(i):
        return batch(cfg, i)

    def fresh():
        return sh.device_put(init, sh24)

    whole, n, _ = ElasticTrainer(tmp_path / "whole", save_every=2).run(
        fresh(), step24, data, 4, shardings=sh24)
    assert n == 4
    ft = ElasticTrainer(tmp_path / "ft", save_every=2)
    with pytest.raises(RuntimeError, match="failure at step 3"):
        ft.run(fresh(), step24, data, 4, fail_at=3)
    state, start = ft.resume(like, shardings=sh24)
    assert start == 2
    state, n, hist = ft.run(state, step24, data, 4, start_step=start)
    assert n == 4 and len(hist) == 2
    assert_bits(state, whole)
    # onto another mesh, from the step-2 checkpoint: the same run within
    # rounding (a weight whose gradient is near zero may step either way:
    # 2·lr·(1 + wd·|p|) a step, two steps)
    _, sh18 = shardings(cfg, tc, mesh("d1m8"))
    state, start = ft.mgr.restore(like, step=2, shardings=sh18)
    assert start == 2
    assert_placed(state, sh18)
    state, n, _ = ElasticTrainer(tmp_path / "ft18", save_every=100).run(
        state, train.make_train_step(cfg, tc, mesh("d1m8")), data, 4,
        start_step=start)
    for a, b in zip(sorted_leaves(interop.to_numpy(state.params)),
                    sorted_leaves(interop.to_numpy(whole.params))):
        bound = 2 * 2 * tc.peak_lr * (1 + tc.weight_decay * np.abs(b)) + 1e-6
        assert (np.abs(a - b) <= bound).all()
        assert np.mean(np.abs(a - b) <= 1e-5) > 0.99
