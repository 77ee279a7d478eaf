"""The adaptive engine's fold cell on the CPU, the JAX package beside the
port: how many keys the folded lane sheds at the geometry of
``chip_smoke.py``'s phase 8c (width 4096, lanes 8, ``min_lanes=1``,
window 8, sharded only) over the same stream (``chip_smoke.adaptive_rows``
from the same seed).

The reference runs one tick at a time and records every route it draws;
the port (``backend="torch"``, on the CPU) replays those routes and is
held to the reference bit for bit on every tick, every result and every
state leaf (``disp_ema`` within a relative 1e-6), as
tests/test_torch_adaptive.py does at width 64, except for the float
sums: the sharded state's ``disp_ema`` and the controller's EMAs and
window sums.  They sum 2048 DES keys a tick in float32, in another order
than XLA's, and the dispersion subtracts the batch minimum from that
mean, so far up the DES clock (keys near 1e7, spread near 1e3) the two
orders part by more than 1e-6.  Their largest relative difference is
printed instead; the plans, latches and counts they drive stay exact.
It then prints the keys
shed, counted as phase 8c counts them (the growth of the live lanes'
``n_dropped``) and as the conservation gap (inserted less served less
resident).

The card draws its routes from CUDA's generator, which neither the CPU
nor the reference can draw, so this run's count need not be the card's.

    PYTHONPATH=src:tests python tests/torch_fold_shed_check.py [--seed 0]

Takes a few minutes and a few GiB; prints one JSON line and exits 0 when
the two packages agree on every tick.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro.core.adaptive import ControllerConfig as JCtlCfg  # noqa: E402
from repro.core.factory import EngineSpec as JSpec  # noqa: E402
from repro.core.factory import make_engine as j_make_engine  # noqa: E402
from repro_torch.core.adaptive import ControllerConfig  # noqa: E402
from repro_torch.core.factory import EngineSpec, make_engine  # noqa: E402
from repro_torch.core.interop import sharded_state_to_numpy  # noqa: E402
from test_torch_adaptive import (_FLOAT_CTL, _as_plain,  # noqa: E402
                                 _assert_tick_equal, _record_reference,
                                 replay_routes)
from test_torch_sharded import _DISP_EMA  # noqa: E402


def _rel(got, want):
    return abs(got - want) / abs(want) if want else float(got != want)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's --seed (its stream uses seed + 9)")
    args = ap.parse_args()

    (ak, av, mask, rms), _ = chip_smoke.adaptive_rows(
        np.random.default_rng(args.seed + 9), 4096)
    stream = [(ak[t], av[t], mask[t], rms[t]) for t in range(len(rms))]
    spec = dict(engine="adaptive", width=4096, lanes=8, min_lanes=1)
    engines = ("sharded",)

    t0 = time.perf_counter()
    ref = j_make_engine(JSpec(backend="jnp", controller=JCtlCfg(
        window=8, engines=engines), **spec))
    want, routes = _record_reference(ref, stream)
    t_ref = time.perf_counter() - t0

    eng = make_engine(EngineSpec(backend="torch", controller=ControllerConfig(
        window=8, engines=engines), **spec), device="cpu")
    shed_counted, inserted, served = 0, 0, 0
    rel = dict.fromkeys(("disp_ema_state",) + _FLOAT_CTL, 0.0)
    lanes = []
    with pytest.MonkeyPatch.context() as mp:
        left = replay_routes(mp, routes)
        state = eng.init(seed=0)
        for t, (k, v, m, r) in enumerate(stream):
            pre = state
            state, res = eng.tick(state, k, v, m, r)
            _assert_tick_equal(state, res, want[t], f"fold tick {t}",
                               float_rtol=None)
            pairs = [("disp_ema_state",
                      float(sharded_state_to_numpy(state.inner)[_DISP_EMA]),
                      float(want[t]["inner"][_DISP_EMA]))]
            ctl = _as_plain(state.ctl)
            pairs += [(k, float(ctl[k]), float(want[t]["ctl"][k]))
                      for k in _FLOAT_CTL]
            for k, g, w in pairs:
                rel[k] = max(rel[k], _rel(g, w))
            shed_counted += (chip_smoke.inner_drops(state)
                             - chip_smoke.inner_drops(pre))
            inserted += int(m.sum())
            served += int(res.rm_served.sum())
            lanes.append(state.lanes)
        if next(left, None) is not None:
            raise AssertionError("a reference route was not drawn")
    resident = int(eng.size(state))
    print(json.dumps(dict(
        cell="adaptive_w4096_L8_fold", seed=args.seed, ticks=len(stream),
        ticks_equal=len(stream), routes_replayed=len(routes),
        max_rel_diff=rel, keys_shed_counted=shed_counted,
        conservation_gap=inserted - served - resident,
        folds=sum(a > b for a, b in zip(lanes, lanes[1:])),
        unfolds=sum(a < b for a, b in zip(lanes, lanes[1:])),
        reference_s=round(t_ref, 1),
        total_s=round(time.perf_counter() - t0, 1))), flush=True)


if __name__ == "__main__":
    main()
