"""Quality auto-tuner: widen the lane count until a rank-error budget binds
(PyTorch port of the JAX package's ``quality/tuner.py``).

The c-relaxed contract's *adversarial* envelope is nearly flat in L for
the bench geometry (per-lane quotas are sized so ``L * lane.a_max ~= W``,
so ``relax_bound(r) - r ~= r + 2W`` for every L >= 2) — useful as a CI
gate, useless as a tuning signal.  The *measured* rank-error
distribution is graded in L: each extra lane adds one more locally-exact
head the router spreads the prefix over, so p99 rank error grows roughly
linearly with L on dispersed mixes.  This tuner is the measured
instrument (the envelope inversion lives in
:func:`repro_torch.core.factory.lanes_within_budget`): it probes the
sharded engine up the lane ladder on a caller-shaped workload and
returns the widest L whose measured rank error still fits the budget —
i.e. it spends exactly as much quality as the budget allows.

Usage::

    from repro_torch.quality.tuner import probe_stream, tune_lanes

    res = tune_lanes(width=4096, p_add=0.3, budget=256.0, key_dist="des")
                                                        # on cuda
    eng = make_engine(EngineSpec(engine="sharded", width=4096,
                                 lanes=res.lanes))

Monotonicity caveat: the walk stops at the first lane count whose
measured metric exceeds the budget.  Measured rank error is monotone in
L in expectation (more lanes, more displacement), not per-seed-sample;
``trace`` records every probe so a non-monotone sample is visible
rather than silently truncated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.quality.harness import measure_engine

KEY_HI = 100_000.0       # the bench key space (the reference's bench)
WARM_ELEMENTS = 2000     # paper: pre-warm to a stable state


def warm_keys(n: int = WARM_ELEMENTS, *, seed: int = 0,
              key_hi: float = KEY_HI) -> np.ndarray:
    """The warm resident set the probe stream starts from."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0, key_hi, n).astype(np.float32)


def probe_stream(width: int, p_add: float, ticks: int, *,
                 key_dist: str = "uniform", seed: int = 0,
                 key_hi: float = KEY_HI):
    """A [T, W] p-coin mix probe (same shape as the bench workload:
    "des" clusters new keys just above the drifting minimum, "uniform"
    draws over the whole space).  Returns (add_keys, add_vals, add_mask,
    rm_counts) as numpy arrays — a PROBE for the tuner, not a bench's
    bit-exact stream."""
    rng = np.random.default_rng(seed + 1)
    n_add = int(round(width * p_add))
    n_rm = width - n_add
    ak = np.full((ticks, width), np.inf, np.float32)
    av = np.tile(np.arange(width, dtype=np.int32), (ticks, 1))
    mask = np.zeros((ticks, width), bool)
    mask[:, :n_add] = True
    lo = 0.0
    for t in range(ticks):
        if key_dist == "des":
            lo += n_rm * key_hi / WARM_ELEMENTS
            ak[t, :n_add] = lo + rng.exponential(
                key_hi / WARM_ELEMENTS * 8, n_add)
        else:
            ak[t, :n_add] = rng.uniform(0, key_hi, n_add)
    rm_counts = np.full((ticks,), n_rm, np.int64)
    return ak, av, mask, rm_counts


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one :func:`tune_lanes` walk."""

    lanes: int               # widest L whose measured metric <= budget
    budget: float
    metric: str              # which summary key was budgeted
    value: float             # that metric, measured at `lanes`
    us_per_tick: float       # eager probe time at `lanes` (signal only)
    trace: Tuple[Tuple[int, float, float], ...]  # (L, metric, us) probes


def _lane_ladder(lanes_max: int, min_lanes: int):
    ladder, ln = [], max(min_lanes, 1)
    while ln < lanes_max:
        ladder.append(ln)
        ln *= 2
    ladder.append(lanes_max)
    return ladder


def tune_lanes(*, width: int, p_add: float, budget: float,
               key_dist: str = "uniform", lanes_max: int = 8,
               min_lanes: int = 1, ticks: int = 30, settle: int = 5,
               seed: int = 0, base=None, preroute: str = "adaptive",
               metric: str = "rank_err_p99",
               warm: Optional[np.ndarray] = None,
               device="cuda") -> TuneResult:
    """Walk the lane ladder (min_lanes, 2x, ..., lanes_max) measuring
    ``metric`` on a probe stream; return the widest L within budget.
    The probe engines are the port's sharded engines on ``device``, built
    through its factory from ``base`` (a CPU device needs a base with
    ``backend="torch"``).

    L = 1 is exact (rank error identically 0), so the walk always has a
    feasible floor; it stops at the first L whose measured metric
    exceeds ``budget`` and keeps the last one that fit.
    """
    from repro_torch.core.factory import EngineSpec, make_engine

    if warm is None:
        warm = warm_keys(seed=seed)
    ak, av, mask, rc = probe_stream(width, p_add, settle + ticks,
                                    key_dist=key_dist, seed=seed)
    best: Optional[Tuple[int, float, float]] = None
    trace = []
    for lanes in _lane_ladder(lanes_max, min_lanes):
        eng = make_engine(EngineSpec(
            engine="sharded", width=width, base=base, lanes=lanes,
            preroute=preroute), device=device)
        state = eng.init(seed=seed)
        # absorb the warm set through one zero-remove tick per chunk
        for i in range(0, warm.size, width):
            chunk = warm[i:i + width]
            wk = np.full((width,), np.inf, np.float32)
            wm = np.zeros((width,), bool)
            wk[:chunk.size] = chunk
            wm[:chunk.size] = True
            state, _ = eng.tick(state, wk, np.zeros(width, np.int32), wm, 0)
        s = measure_engine(eng, ak, av, mask, rc, state=state,
                           warm_keys=warm, record_from=settle)
        val = float(s[metric])
        trace.append((lanes, val, s["us_per_tick"]))
        if val <= budget:
            best = trace[-1]
        else:
            break
    if best is None:   # min_lanes itself violated the budget
        best = trace[0]
    return TuneResult(lanes=best[0], budget=float(budget), metric=metric,
                      value=best[1], us_per_tick=best[2],
                      trace=tuple(trace))
