"""Training's drivers and restart path on the CPU:

* ``repro_torch.ft.ElasticTrainer``: a run that crashes at step 9 and
  resumes from its step-8 checkpoint ends bit-equal to the
  uninterrupted run (the reference's ``tests/test_ft.py::
  test_elastic_crash_restart_bit_exact``, on the port); and the port's
  trainer gives the reference trainer's losses within 1e-5 on the same
  parameters and data.
* ``repro_torch.examples.train_lm --small`` against the JAX package's
  ``examples/train_lm.py --small`` (loaded by path, its sampler and
  initial state recorded): the same group every step and losses within
  1e-4 over its 60 steps (measured: within 1e-6), on the reference's
  initial parameters; the sampler's breakdown equal.
* ``repro_torch.examples.dev_check_models`` on every arch and
  ``dev_check_dist`` at D=8 x l=2 (its three checks: served keys equal
  to the single-device sharded queue's, within ``relax_bound``, the size
  equal to a multiset mirror), the port alone: the sharded queue it is
  held to is pinned to the reference elsewhere.
* The training slice imports neither JAX, the JAX package nor
  ``ml_dtypes``.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import reduced_config as j_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.ft import ElasticTrainer as JElasticTrainer
from repro.launch.train import TrainConfig as JTrainConfig
from repro.launch.train import init_train_state as j_init_train_state
from repro.launch.train import make_train_step as j_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.examples import dev_check_dist, dev_check_models, train_lm
from repro_torch.ft import ElasticTrainer
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import interop
from repro_torch.models import transformer as tf
from torch_models_ref import np_tree
from torch_train_ref import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _elastic_setup():
    cfg = dataclasses.replace(reduced_config("gemma-2b"), n_layers=1,
                              vocab=128, dtype="float32")
    tcfg = TrainConfig(n_micro=1, fsdp=False, zero1=False, warmup=2,
                       total_steps=50)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    data_fn = lambda s: {k: torch.from_numpy(v)  # noqa: E731
                         for k, v in data.batch_at(s).items()}
    return cfg, tcfg, data_fn


def test_elastic_crash_restart_bit_exact(tmp_path):
    """Crash at step k, restore, replay: the (seed, step)-pure data
    pipeline makes the resumed run identical."""
    cfg, tcfg, data_fn = _elastic_setup()
    step_fn = make_train_step(cfg, tcfg, None)

    def fresh(seed):
        return init_train_state(cfg, torch.Generator().manual_seed(seed),
                                tcfg, device="cpu")

    # uninterrupted run
    t0 = ElasticTrainer(tmp_path / "a", save_every=4)
    ref_state, _, ref_hist = t0.run(fresh(0), step_fn, data_fn, 12)

    # crashed + resumed run
    t1 = ElasticTrainer(tmp_path / "b", save_every=4)
    with pytest.raises(RuntimeError):
        t1.run(fresh(0), step_fn, data_fn, 12, fail_at=9)
    resumed, start = t1.resume(fresh(1))
    assert start == 8   # last durable step before the crash
    final, _, hist = t1.run(resumed, step_fn, data_fn, 12,
                            start_step=start)
    assert hist == ref_hist[8:]
    for a, b in zip(tf.tree_leaves(ref_state), tf.tree_leaves(final)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_elastic_trainer_matches_the_reference_trainer(tmp_path):
    """Both trainers on the reference's initial state and data, 6 steps
    with a checkpoint every 4: the same losses (1e-5), the same last
    step, and the port restores the reference's last checkpoint."""
    cfg, tcfg, data_fn = _elastic_setup()
    jcfg = dataclasses.replace(j_reduced("gemma-2b"), n_layers=1, vocab=128,
                               dtype="float32")
    jtcfg = JTrainConfig(n_micro=1, fsdp=False, zero1=False, warmup=2,
                         total_steps=50)
    jdata = JSyntheticLM(vocab=cfg.vocab, seq_len=32, batch=4, seed=0)
    jstate = j_init_train_state(jcfg, jax.random.PRNGKey(0), jtcfg)
    state = interop.train_state_from_numpy(cfg, np_tree(jstate), tcfg,
                                           "cpu")
    jt = JElasticTrainer(tmp_path / "ref", save_every=4)
    jfinal, jstep, jhist = jt.run(
        jstate, jax.jit(j_make_train_step(jcfg, jtcfg, None)),
        lambda s: {k: jnp.asarray(v) for k, v in jdata.batch_at(s).items()},
        6)
    t = ElasticTrainer(tmp_path / "port", save_every=4)
    final, step, hist = t.run(state, make_train_step(cfg, tcfg, None),
                              data_fn, 6)
    assert step == jstep == 6
    for h, jh in zip(hist, jhist):
        assert abs(h["loss"] - jh["loss"]) <= 1e-5 * max(1, abs(jh["loss"]))
    restored, at = ElasticTrainer(tmp_path / "ref").resume(final)
    assert at == 6
    for a, b in zip(tf.tree_leaves(restored),
                    tf.tree_leaves(interop.train_state_from_numpy(
                        cfg, np_tree(jfinal), tcfg, "cpu"))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _load(rel):
    """The reference script at ``rel`` as a module."""
    name = "ref_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_small_matches_the_reference_script(tmp_path,
                                                     monkeypatch):
    ref = _load("examples/train_lm.py")
    log = {"groups": [], "loss": []}

    class Recorded(ref.PrioritySampler):
        def next_groups(self, k):
            got = super().next_groups(k)
            log["groups"] += got
            return got

        def report(self, gid, loss):
            log["loss"].append(loss)
            super().report(gid, loss)

        def breakdown(self):
            log["breakdown"] = super().breakdown()
            return log["breakdown"]

    init = {}

    def recorded_init(cfg, key, tcfg):
        state = j_init_train_state(cfg, key, tcfg)
        init["state"] = np_tree(state)
        return state

    monkeypatch.setattr(ref, "PrioritySampler", Recorded)
    monkeypatch.setattr(ref, "init_train_state", recorded_init)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--small", "--ckpt",
                                      str(tmp_path / "ref")])
    ref.main()
    monkeypatch.setattr(
        train_lm, "init_train_state",
        lambda cfg, gen, tcfg, device: interop.train_state_from_numpy(
            cfg, init["state"], tcfg, device))
    out = train_lm.main("cpu", "torch", small=True,
                        ckpt=str(tmp_path / "port"))
    assert out["steps"] == 60
    assert out["groups"] == log["groups"]
    np.testing.assert_allclose(out["loss"], log["loss"], rtol=0, atol=1e-4)
    assert out["breakdown"] == {k: int(v) for k, v in
                                log["breakdown"].items() if v}
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000060"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_dev_check_models(arch):
    out = dev_check_models.check(arch, "cpu")
    assert np.isfinite(out["loss"]) and out["grad_norm"] > 0


def test_dev_check_dist_at_d8_l2():
    out = dev_check_dist.main("cpu", "torch")
    assert out["ticks"] == dev_check_dist.TICKS
    assert len(out["lane_sizes"]) == dev_check_dist.D * dev_check_dist.LPD
    assert sum(out["lane_sizes"]) == out["size"] > 0
    assert min(out["work_ticks"]) > 0


def test_training_slice_imports_no_jax():
    mods = ("repro_torch.launch.train", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.optim.adamw8",
            "repro_torch.optim.schedule", "repro_torch.ckpt",
            "repro_torch.ckpt.checkpoint", "repro_torch.ft",
            "repro_torch.examples.train_lm",
            "repro_torch.examples.dev_check_models",
            "repro_torch.examples.dev_check_dist",
            "repro_torch.models.layers", "repro_torch.models.transformer",
            "repro_torch.models.interop", "repro_torch.roofline.traffic")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.models.layers import softmax_xent\n"
            "from repro_torch.models.transformer import loss_fn\n"
            "from repro_torch.ft import ElasticTrainer\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro', "
            "'ml_dtypes') or m.startswith(('jax.', 'repro.', "
            "'ml_dtypes.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_default_to_the_card():
    """Training's entry points run on the card unless the caller asks for
    the CPU."""
    import inspect
    for fn in (init_train_state, train_lm.main, dev_check_models.check,
               dev_check_models.main, dev_check_dist.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(train_lm.main).parameters[
        "backend"].default == "cuda"
