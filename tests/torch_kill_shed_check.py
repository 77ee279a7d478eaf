"""The kill cell of ``chip_smoke.py``'s phase 9b on the CPU, the JAX
package beside the port: how many keys the surviving lanes shed after a
mesh position is removed.

The port's dist queue (D=2 positions of 4 lanes on a CPU mesh, width
4096, ``spare_devices=1``) runs 9b's stream (phase 7's w4096 cell from
the same seed) and removes position 1 at tick 10 through
``remove_device``.  The reference runs the same geometry as its
single-device equivalent (sharded, L=8, ``min_lanes=4``; its own tests
pin dist over D devices to it), folds to the first position's lanes at
tick 10 with ``fold_lanes`` and re-inserts the drained keys in
full-width zero-remove ticks, as its ``remove_device`` does.  The port
replays every route the reference draws and is held to it on every tick:
every result and every state leaf bit for bit, but ``disp_ema`` (a
float32 mean of 2048 DES keys summed in another order; its largest
relative difference is printed).  It then prints the keys the lanes
shed (the growth of their ``n_dropped``), tick by tick from the kill.

    PYTHONPATH=src:tests python tests/torch_kill_shed_check.py [--seed 0]

Takes about a minute; prints one JSON line and exits 0 when the two
packages agree on every tick.
"""

import argparse
import json
import sys
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro.core import sharded as jshq  # noqa: E402
from repro.core.factory import EngineSpec as JSpec  # noqa: E402
from repro.core.factory import make_engine as j_make_engine  # noqa: E402
from repro_torch.core import config  # noqa: E402
from repro_torch.core import sharded as tshq  # noqa: E402
from repro_torch.core.factory import EngineSpec, make_engine  # noqa: E402
from repro_torch.core.interop import dist_state_to_numpy  # noqa: E402
from test_torch_sharded import _DISP_EMA, _bits, ref_leaves  # noqa: E402

KILL_AT, AFTER = 10, 30


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "to_device", lambda rows: rows)
        spec, first, mix, _ = chip_smoke.sharded_cell(
            types.SimpleNamespace(seed=args.seed), config, True)
    rows = [np.concatenate([a, b[:KILL_AT + AFTER]])
            for a, b in zip(first, mix)]
    jcfg = j_make_engine(JSpec(engine="sharded", width=4096, lanes=8,
                               min_lanes=4, backend="jnp")).cfg
    q = make_engine(EngineSpec(engine="dist", n_devices=2,
                               lanes_per_device=4, spare_devices=1,
                               backend="torch", **spec), device="cpu")
    j_state, d_state = jshq.init(jcfg, seed=0), q.init(seed=0)
    routes = []

    def j_tick(state, batch):
        draws = int(state.tick_idx) % jcfg.stick == 0
        state, res = jshq.tick(jcfg, state, *(jnp.asarray(x)
                                             for x in batch))
        if draws:
            routes.append(np.asarray(state.route))
        return state, res

    shed, worst = [], 0.0
    with pytest.MonkeyPatch.context() as mp:
        it = iter(routes)
        mp.setattr(tshq, "_fresh_route",
                   lambda seed, count, w, n, device: torch.tensor(
                       next(it), dtype=torch.int32, device=device))
        for t in range(rows[0].shape[0]):
            batch = [x[t] for x in rows]
            if t == KILL_AT:
                jcfg, j_state, dk, dv = jshq.fold_lanes(
                    jcfg, jax.tree.map(np.asarray, j_state), [0, 1, 2, 3])
                routes.append(np.asarray(j_state.route))
                w = jcfg.a_total
                for i in range(0, len(dk), w):
                    ak = np.full(w, np.inf, np.float32)
                    av = np.full(w, -1, np.int32)
                    m = np.zeros(w, bool)
                    n = len(dk[i:i + w])
                    ak[:n], av[:n], m[:n] = dk[i:i + w], dv[i:i + w], True
                    j_state, _ = j_tick(j_state, (ak, av, m, np.int32(0)))
                q, d_state = q.remove_device(d_state, 1)
            j_state, j_res = j_tick(j_state, batch)
            d_state, d_res = q.tick(d_state, *batch)
            for i, (g, w) in enumerate(zip(d_res, j_res)):
                np.testing.assert_array_equal(
                    _bits(g.numpy()), _bits(np.asarray(w)),
                    err_msg=f"tick {t} result {i}")
            for i, (g, w) in enumerate(zip(dist_state_to_numpy(d_state),
                                           ref_leaves(j_state))):
                if i == _DISP_EMA:
                    worst = max(worst, abs(float(g) - float(w)) / abs(
                        float(w)))
                else:
                    np.testing.assert_array_equal(
                        _bits(g), _bits(w), err_msg=f"tick {t} leaf {i}")
            shed.append(sum(int(p.stats.n_dropped.sum())
                            for p in d_state.lanes))
    print(json.dumps({
        "cell": "dist_kill_w4096 (cpu)", "ticks": len(shed),
        "killed_at": KILL_AT, "routes_replayed": len(routes),
        "shed_by_tick_from_kill": shed[KILL_AT:],
        "router_dropped": int(d_state.n_router_dropped),
        "disp_ema_max_rel_diff": worst}))


if __name__ == "__main__":
    main()
