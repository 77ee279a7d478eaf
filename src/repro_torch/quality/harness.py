"""Rank-error harness: replay a served stream against the exact reference
(PyTorch port of the JAX package's ``quality/harness.py``; the meter and
``replay`` are numpy only and copied as they are).

The c-relaxed contract (``relax_bound``) promises that every key a tick
serves lies within the c smallest of the union state (pre-tick residents
plus that tick's adds) — but a promise is not a measurement.  MultiQueues
(arXiv:1411.1209) and Practical Concurrent Priority Queues
(arXiv:1509.07053) treat the *measured* rank-error distribution as the
axis that purchases scalability; this module makes it measurable for any
:class:`~repro_torch.core.factory.QueueEngine` without touching the engine:
the meter replays the engine's own (adds, served) stream against an
instantaneous exact reference — the sorted union multiset the
batch-sequential spec (:mod:`repro_torch.core.ref_pq`, DESIGN.md §2) would
hold at each serve point.

Two per-serve metrics (DESIGN.md §12):

* **rank error** — the served key's position in the exact sorted union
  at serve time, minus the position an exact engine would have served
  in the same batch slot.  A width-r exact tick serves union positions
  0..r-1, so matching the tick's served keys (ascending) against the
  union gives error ``pos_i - i >= 0``; an exact engine scores
  identically 0, and the c-relaxed contract bounds the maximum by
  ``relax_bound(r) - r`` (the r served keys occupy r distinct union
  positions below c, so ``pos_i <= c - r + i``).
* **staleness** — ticks since the key first entered the exact serve
  prefix (the batch generalization of "ticks since it first became the
  exact minimum").  An exact engine clears the whole prefix every tick,
  so it scores identically 0; a relaxed engine's staleness is the tick
  count by which it is serving the past.

The meter is pure host-side numpy over sorted arrays (O(W log N) per
tick), engine-agnostic, and self-checking: a served key that is not in
the replayed union multiset means the stream and the meter disagree on
conservation, which raises immediately instead of producing garbage
percentiles.  Caveat: the replay assumes no silent drops — the bench
engines run at router slack 1.0 (``n_router_dropped == 0``); a dropped
add would sit in the meter's union forever and inflate measured ranks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: keys recorded by :meth:`RankErrorMeter.summary` (the reference bench's
#: per-cell quality schema)
SUMMARY_KEYS = (
    "rank_err_p50", "rank_err_p99", "rank_err_max",
    "stale_p50", "stale_p99", "stale_max", "n_served",
)


class RankErrorMeter:
    """Streaming rank-error / staleness meter over one engine's ticks.

    Feed it the same per-tick (live adds, served keys, rm_count) stream
    the engine consumed and produced; it maintains the exact reference
    union as a sorted multiset and scores every serve.  ``record=False``
    ticks (warm / settle) update the reference without contributing to
    the aggregates — the measured window then starts from the same
    absorbed workload the timed bench window does.
    """

    def __init__(self) -> None:
        self._keys = np.empty(0, np.float64)   # sorted resident multiset
        self._due = np.empty(0, np.int64)      # tick it entered the exact
        self._tick = 0                         # serve prefix; -1 = never
        self._rank_err: list = []              # per-recorded-tick arrays
        self._stale: list = []

    # -- state -----------------------------------------------------------

    def __len__(self) -> int:
        return int(self._keys.size)

    def preload(self, keys) -> None:
        """Install pre-warmed resident keys (never scored, never due).
        Must precede the first :meth:`observe` — warm state is part of
        the reference's initial condition, not of the stream."""
        if self._tick:
            raise ValueError("preload() must come before observe()")
        k = np.sort(np.asarray(keys, np.float64))
        self._keys = np.concatenate([self._keys, k])
        self._keys.sort(kind="stable")
        self._due = np.full(self._keys.size, -1, np.int64)

    # -- one tick --------------------------------------------------------

    def observe(self, add_keys, served_keys, rm_count: int, *,
                record: bool = True) -> None:
        """Score one tick: ``add_keys`` are the tick's LIVE adds (mask
        already applied), ``served_keys`` the keys it actually served,
        ``rm_count`` the removes it was asked for (the exact prefix an
        exact engine would have cleared).  Raises ``ValueError`` if a
        served key is not in the replayed union (conservation break)."""
        t = self._tick
        self._tick += 1
        adds = np.sort(np.asarray(add_keys, np.float64).ravel())
        if adds.size:
            # side="right": fresh adds land AFTER existing equal keys, so
            # the leftmost equal copy is the oldest — due-marking and
            # serve-matching then both consume oldest-first, and ties
            # cannot launder staleness through a same-key fresh add
            idx = np.searchsorted(self._keys, adds, side="right")
            self._keys = np.insert(self._keys, idx, adds)
            self._due = np.insert(self._due, idx, -1)

        # the exact engine would clear this prefix of the union now; any
        # prefix element it has NOT served yet starts aging from here
        due_m = min(int(rm_count), self._keys.size)
        if due_m:
            head = self._due[:due_m]
            self._due[:due_m] = np.where(head < 0, t, head)

        served = np.sort(np.asarray(served_keys, np.float64).ravel())
        m = served.size
        if m == 0:
            if record:
                self._rank_err.append(np.empty(0, np.int64))
                self._stale.append(np.empty(0, np.int64))
            return
        # match the i-th served key (ascending) to its copy in the union:
        # leftmost equal position plus how many equal served keys precede
        lt_union = np.searchsorted(self._keys, served, side="left")
        occ = np.arange(m) - np.searchsorted(served, served, side="left")
        pos = lt_union + occ
        if pos[-1] >= self._keys.size or not np.array_equal(
                self._keys[pos], served):
            missing = served[(pos >= self._keys.size)
                             | (self._keys[np.minimum(pos, self._keys.size - 1)]
                                != served)]
            raise ValueError(
                f"tick {t}: served key(s) {missing[:4]} not in the "
                "replayed union — the stream fed to the meter does not "
                "conserve the queue's multiset")
        rank_err = pos - np.arange(m)
        due = self._due[pos]
        stale = np.where(due >= 0, t - due, 0)
        if record:
            self._rank_err.append(rank_err.astype(np.int64))
            self._stale.append(stale.astype(np.int64))
        keep = np.ones(self._keys.size, bool)
        keep[pos] = False
        self._keys = self._keys[keep]
        self._due = self._due[keep]

    # -- aggregates ------------------------------------------------------

    def rank_errors(self) -> np.ndarray:
        return (np.concatenate(self._rank_err)
                if self._rank_err else np.empty(0, np.int64))

    def staleness(self) -> np.ndarray:
        return (np.concatenate(self._stale)
                if self._stale else np.empty(0, np.int64))

    def summary(self) -> Dict[str, float]:
        """p50/p99/max of both metrics over every recorded serve."""
        re, st = self.rank_errors(), self.staleness()
        out: Dict[str, float] = {"n_served": int(re.size)}
        for name, x in (("rank_err", re), ("stale", st)):
            if x.size:
                out[f"{name}_p50"] = round(float(np.percentile(x, 50)), 2)
                out[f"{name}_p99"] = round(float(np.percentile(x, 99)), 2)
                out[f"{name}_max"] = int(x.max())
            else:
                out[f"{name}_p50"] = 0.0
                out[f"{name}_p99"] = 0.0
                out[f"{name}_max"] = 0
        return out


def replay(add_keys, add_mask, rm_keys, rm_served, rm_counts, *,
           warm_keys=None, record_from: int = 0) -> Dict[str, float]:
    """Score a whole stacked run post-hoc (the bench path).

    ``add_keys``/``add_mask`` are the [T, W] op batches the engine
    consumed, ``rm_keys``/``rm_served`` the [T, out_w] results it
    returned, ``rm_counts`` the [T] remove requests.  ``warm_keys``
    preloads the pre-stream resident multiset; ticks before
    ``record_from`` (the settle window) update the reference without
    entering the aggregates.  Runs entirely on host copies, so it never
    touches the timed region that produced the arrays.
    """
    ak = np.asarray(add_keys)
    am = np.asarray(add_mask, bool)
    rk = np.asarray(rm_keys)
    rs = np.asarray(rm_served, bool)
    rc = np.asarray(rm_counts).astype(np.int64).ravel()
    meter = RankErrorMeter()
    if warm_keys is not None:
        meter.preload(warm_keys)
    for tt in range(ak.shape[0]):
        meter.observe(ak[tt][am[tt]], rk[tt][rs[tt]], int(rc[tt]),
                      record=tt >= record_from)
    return meter.summary()


def measure_engine(eng, add_keys, add_vals, add_mask, rm_counts, *,
                   state=None, warm_keys=None,
                   record_from: int = 0) -> Dict[str, float]:
    """Drive ``eng`` eagerly over a [T, W] stream and score every tick.

    The tuner's probe path: builds its own state when none is given,
    ticks one batch at a time (each moved to the engine's device), and
    replays each result into a :class:`RankErrorMeter`.  Returns the
    meter summary plus ``us_per_tick`` of the recorded ticks (host wall
    time, the device synchronised at both ends on a cuda device: a probe
    signal for the tuner, not a bench number).

    ``warm_keys`` preloads the reference union; when ``state`` is None
    the fresh engine absorbs the same keys through zero-remove ticks
    first, so meter and engine always start from the same multiset (a
    caller-provided ``state`` must already hold them).
    """
    import time

    import torch

    device = torch.device(eng.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    ak = np.asarray(add_keys)
    av = np.asarray(add_vals)
    am = np.asarray(add_mask, bool)
    rc = np.asarray(rm_counts).astype(np.int64).ravel()
    if state is None:
        state = eng.init(seed=0)
        if warm_keys is not None:
            w = int(eng.width)
            wks = np.asarray(warm_keys, np.float32)
            zeros = dev(np.zeros(w, np.int32), torch.int32)
            for i in range(0, wks.size, w):
                chunk = wks[i:i + w]
                fk = np.full((w,), np.inf, np.float32)
                fm = np.zeros((w,), bool)
                fk[:chunk.size] = chunk
                fm[:chunk.size] = True
                state, _ = eng.tick(state, dev(fk, torch.float32), zeros,
                                    dev(fm, torch.bool), 0)
    meter = RankErrorMeter()
    if warm_keys is not None:
        meter.preload(warm_keys)
    t0: Optional[float] = None
    for tt in range(ak.shape[0]):
        if tt == record_from:
            sync()
            t0 = time.perf_counter()
        state, res = eng.tick(state, dev(ak[tt], torch.float32),
                              dev(av[tt], torch.int32),
                              dev(am[tt], torch.bool), int(rc[tt]))
        served = res.rm_keys[res.rm_served].cpu().numpy()
        meter.observe(ak[tt][am[tt]], served, int(rc[tt]),
                      record=tt >= record_from)
    sync()
    n_rec = max(ak.shape[0] - record_from, 1)
    out = meter.summary()
    out["us_per_tick"] = (time.perf_counter() - t0) / n_rec * 1e6 \
        if t0 is not None else 0.0
    return out
