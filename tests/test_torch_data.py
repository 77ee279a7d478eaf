"""The port's data side (``repro_torch.data``) against the JAX package's.

* ``PrioritySampler`` (``device="cpu"``; the ``"torch"`` backend, and the
  default ``"cuda"`` config, whose lane tick takes its plain version on a
  CPU tensor) gives the reference's groups on every step and the
  reference's ``breakdown()`` on the three scenarios of
  tests/test_sampler.py and on a loss stream whose keys include -0.0.
* ``make_batch`` gives the reference's arrays.

The sampler's card-only check is in tests/test_torch_cuda_kernel.py.
"""

import dataclasses

import numpy as np
import pytest

from repro.data import PrioritySampler as JSampler
from repro.data import make_batch as j_make_batch
from repro_torch.data import PrioritySampler, SyntheticLM, make_batch
from repro_torch.data.priority_sampler import DEFAULT_CFG


def _cfg(backend):
    return dataclasses.replace(DEFAULT_CFG, backend=backend)


def _hard_easy(s, g, rng):
    return 8.0 if g < 4 else 0.5


def _one_hot(s, g, rng):
    return 8.0 if g == 0 else 0.1


def _flat(s, g, rng):
    return 1.0


def _zeroing(s, g, rng):
    """Drive a group's EMA to exactly 0.0 about half the time (ema=0.5:
    0.5 * e + 0.5 * -e == 0.0); with staleness weight 0 its key is then
    -(0.0 + 0.0) == -0.0."""
    if rng.random() < 0.5:
        return -s.groups[g].ema_loss
    return float(rng.choice([0.0, 0.25, 3.0, -1.0]))


#: tests/test_sampler.py's three scenarios, and the signed-zero stream
SCENARIOS = {
    "high_loss": (dict(n_groups=16, staleness_weight=0.0), 60, 4,
                  _hard_easy),
    "staleness": (dict(n_groups=12, staleness_weight=1.0), 90, 2, _one_hot),
    "breakdown": (dict(n_groups=8), 30, 2, _flat),
    "signed_zero_keys": (dict(n_groups=10, ema=0.5, staleness_weight=0.0),
                         50, 3, _zeroing),
}


def _drive(sampler, steps, k, loss, seed=3):
    """Each step's groups, and every key the step re-queued."""
    rng = np.random.default_rng(seed)
    picked, keys = [], []
    for _ in range(steps):
        gids = sampler.next_groups(k)
        for g in gids:
            sampler.report(g, loss(sampler, g, rng))
        sampler.requeue(gids)
        picked.append(gids)
        keys.append([sampler._key(sampler.groups[g]) for g in gids])
    return picked, keys


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_sampler_matches_reference(scenario, backend):
    kw, steps, k, loss = SCENARIOS[scenario]
    want = JSampler(**kw)
    got = PrioritySampler(**kw, cfg=_cfg(backend), device="cpu")
    w_picked, w_keys = _drive(want, steps, k, loss)
    g_picked, g_keys = _drive(got, steps, k, loss)
    assert g_picked == w_picked
    assert np.array_equal(np.float32(g_keys).view(np.int32),
                          np.float32(w_keys).view(np.int32))
    assert got.breakdown() == want.breakdown()
    assert got.breakdown()["n_ticks"] == 2 * steps + 1
    if scenario == "signed_zero_keys":
        flat = np.float32([x for ks in g_keys for x in ks])
        assert (np.signbit(flat) & (flat == 0)).sum() >= 10   # -0.0 keys
        assert (flat > 0).any() and (flat < 0).any()


def test_sampler_default_config_and_admission():
    """The default queue is the reference's geometry under "cuda"; the
    one-tick ``__init__`` admits at most a_max groups, as the reference's
    does."""
    s = PrioritySampler(n_groups=4, device="cpu")
    assert s.sched.cfg.backend == "cuda"
    assert s.sched.state.seq_keys.device.type == "cpu"
    ref = JSampler(n_groups=4).sched.cfg
    for f in dataclasses.fields(ref):
        if f.name != "backend":
            assert getattr(s.sched.cfg, f.name) == getattr(ref, f.name), f
    for mk in (lambda: PrioritySampler(n_groups=65, device="cpu"),
               lambda: JSampler(n_groups=65)):
        with pytest.raises(ValueError, match="admission overflow"):
            mk()


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_make_batch_matches_reference(seed, step):
    got = make_batch(512, 64, 4, seed, step)
    want = j_make_batch(512, 64, 4, seed, step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    lm = SyntheticLM(vocab=512, seq_len=64, batch=4, seed=seed)
    np.testing.assert_array_equal(lm.batch_at(step)["tokens"],
                                  want["tokens"])
