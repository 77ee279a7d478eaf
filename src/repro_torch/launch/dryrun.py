"""The dry run: trace every (arch × shape × mesh) cell of the model stack
on fake devices and count what each mesh position computes, moves and
holds (port of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads ``memory_analysis()`` and the HLO.  The port places
the production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) on
fake devices, one a position (``launch.mesh.fake_mesh``),
builds the step's arguments there by the ported layouts under
``launch.fake.FakeDevices`` (nothing is allocated), and counts the step
under ``roofline.trace_stats.TraceStats``: traced at its full shapes
with its loops capped, the counts fitted over the loops' trip counts
and held to a check trace (``TripCounts``, the reference's
``hlo_stats`` trip counts), or traced whole once (``run_cell(...,
trips=False)``).  No
``XLA_FLAGS`` set-up comes first: a fake device is a name, so there is
no device count to fix before the first import.

Usage (one cell per process; ``repro_torch.examples.dryrun_sweep`` runs
them all):

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gemma-2b --shape decode_32k [--multi-pod] \\
        [--out artifacts/dryrun] [--save-trace] [--hbm-bytes N] \\
        [--workers N]

The artifact has the reference's keys (``memory``, ``cost``,
``collectives``, ``roofline``, ``timing``; ``timing`` holds ``lower_s``
and ``trace_s``, the seconds of counting, for the reference's
``compile_s``) plus ``by_position`` and ``trip_counts`` (each fitted
loop, its full trip count and caps, the check's verdict, each trace's
seconds: the counterpart of ``HloStats.trip_counts``).
The port's positions are not alike: a data row's dense compute runs on
its first position's device.  So each per-device figure is the busiest
position's (never a total over the chips), and ``by_position`` gives
the min, the max, the arg-max position and the sum over positions of
FLOPs, HBM bytes, link bytes and peak bytes.

* ``memory``: ``argument_size_in_bytes`` (the state or parameters,
  caches and inputs a position holds), ``output_size_in_bytes``,
  ``alias_size_in_bytes`` (outputs that are arguments updated in place,
  what the reference donates), ``temp_size_in_bytes`` = peak -
  arguments, ``per_device_total`` = the peak (the port updates in
  place, so no alias is subtracted), ``fits_hbm`` against one card's
  memory (``hw.hbm_bytes()`` where a card is visible, else
  ``--hbm-bytes``), all of the position with the highest peak.
* ``cost``: ``flops``; ``bytes_accessed`` and ``bytes_accessed_upper``
  are both the counter's HBM bytes (an upper estimate: no fusion, no L2
  model).
* ``roofline``: the port's H100 terms (``hw``, ``analysis.Roofline``),
  the link term at ``hw.ICI_BW`` (NVLink) or, across pods, ``hw.DCN_BW``.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import itertools
import json
import math
import multiprocessing
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, cell_is_skipped, input_specs
from repro_torch.dist.sharding import batch_axes, rows
from repro_torch.launch.fake import storage_of
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.launch.serve import lower_prefill_step, lower_serve_step
from repro_torch.launch.train import TrainConfig, lower_train_step
from repro_torch.models.trips import capped, first, small
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import Roofline, model_flops
from repro_torch.roofline.trace_stats import (COLLECTIVES, DeviceStats,
                                              tree_tensors)


def lower_cell(arch: str, shape: str, multi_pod: bool,
               tcfg: TrainConfig = None, chunked_prefill: bool = False,
               devices=None):
    """(``Lowered``, ``ShapeSpec``) of one cell on the production mesh
    placed on ``devices`` (default a fake device a position), or
    (None, "SKIP") where the arch skips the shape."""
    tcfg = tcfg or TrainConfig()
    cfg = get_config(arch)
    if cell_is_skipped(cfg, shape):
        return None, "SKIP"
    mesh = fake_mesh(make_production_mesh(multi_pod=multi_pod), devices)
    spec = SHAPES[shape]
    specs = input_specs(cfg, shape)
    if spec.kind == "train":
        lowered = lower_train_step(cfg, tcfg, mesh, specs)
    elif spec.kind == "prefill":
        lowered = lower_prefill_step(cfg, mesh, batch=spec.batch,
                                     seq_len=spec.seq, specs=specs,
                                     chunked=chunked_prefill)
    else:
        lowered = lower_serve_step(cfg, mesh, batch=spec.batch,
                                   seq_len=spec.seq, specs=specs)
    return lowered, spec


def cell_tokens(spec) -> int:
    """Tokens a cell's step processes: train and prefill take batch x
    seq, decode emits one a row."""
    return spec.batch * (spec.seq if spec.kind in ("train", "prefill")
                         else 1)


def _bytes_by_device(tree) -> dict:
    """The bytes of ``tree``'s storages on each device, each storage
    once."""
    seen, out = set(), {}
    for t in tree_tensors(tree):
        st = storage_of(t)
        key = (t.device, id(st))
        if key not in seen:
            seen.add(key)
            out[t.device] = out.get(t.device, 0) + st.nbytes()
    return out


# ---------------------------------------------------------------------------
# what a trace counts, per device
# ---------------------------------------------------------------------------

#: the counts of one device that a trace gives and the fit recovers
FIELDS = ("flops", "hbm_bytes", *(f"link:{k}" for k in COLLECTIVES),
          "peak_bytes", "ops", "output_bytes", "alias_bytes")


class Counts:
    """What one step counts on each of its devices: ``table[device]``
    maps each of ``FIELDS`` to an exact integer, ``argument`` the
    device's argument bytes, ``per_op[device]`` (where asked) each op's
    [count, FLOPs, HBM bytes].  ``stats`` gives a device's figures as a
    ``trace_stats.DeviceStats``."""

    def __init__(self, table, argument, per_op=None, places=None):
        self.table, self.argument, self.per_op = table, argument, per_op
        #: (keys, values): each place of the loop nest and device (an
        #: [n, 3] int64 array, sorted: place, its data row or -1, the
        #: device's index in the table) with the most bytes live there
        #: ([n] int64)
        self.places = places

    @classmethod
    def of_trace(cls, lowered, out, counter, per_op: bool = False):
        devs = list(dict.fromkeys(lowered.devices))
        held = counter.held_arguments(out)
        output = _bytes_by_device(out)
        table = {}
        for d in devs:
            st = counter.stats(d)
            row = {"flops": st.flops, "hbm_bytes": st.hbm_bytes,
                   "peak_bytes": st.peak_bytes, "ops": st.ops,
                   "output_bytes": output.get(d, 0),
                   "alias_bytes": held.get(d, 0)}
            row.update({f"link:{k}": v for k, v in st.link.items()})
            table[d] = row
        argument = {d: counter.stats(d).argument_bytes for d in devs}
        ops = ({d: {k: list(v) for k, v in counter.table[d].items()}
                for d in devs} if per_op else None)
        places = None
        if counter.placed:
            index = {d: i for i, d in enumerate(devs)}
            kept = [(k[0][0], -1 if k[0][1] is None else k[0][1],
                     index[k[1]], v) for k, v in counter.places.items()
                    if k[1] in index]
            arr = np.array(kept, dtype=np.int64).reshape(-1, 4)
            arr = arr[np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))]
            places = (arr[:, :3].copy(), arr[:, 3].copy())
        return cls(table, argument, ops, places)

    def in_order(self) -> tuple:
        """The counts as lists in the table's device order (what a forked
        worker hands back); ``by_index`` makes them again."""
        devs = list(self.table)
        return ([self.table[d] for d in devs],
                [self.argument[d] for d in devs],
                None if self.per_op is None else [self.per_op[d]
                                                  for d in devs],
                self.places)

    @classmethod
    def by_index(cls, lists, devs):
        rows, argument, per_op, places = lists
        return cls(dict(zip(devs, rows)), dict(zip(devs, argument)),
                   None if per_op is None else dict(zip(devs, per_op)),
                   places)

    def stats(self, device) -> DeviceStats:
        row = self.table[torch.device(device)]
        return DeviceStats(
            flops=row["flops"], hbm_bytes=row["hbm_bytes"],
            link={k: row[f"link:{k}"] for k in COLLECTIVES},
            argument_bytes=self.argument[torch.device(device)],
            peak_bytes=row["peak_bytes"], ops=row["ops"])


def _by_position(counts: Counts, devices, field: str) -> dict:
    """min, max, the arg-max position and the sum of one field over a
    mesh's positions (a device shared by several positions counts once
    in the sum), as ``trace_stats.by_position``."""
    vals = [counts.table[d][field] for d in devices]
    top = max(range(len(vals)), key=lambda p: vals[p])
    return {"min": min(vals), "max": vals[top], "argmax": top,
            "sum": sum(counts.table[d][field] for d in set(devices))}


def summarize(lowered, counts: Counts, *, chips: int, kind: str,
              tokens: int, cfg, link_bw: float, hbm_bytes) -> dict:
    """The artifact's ``memory``, ``cost``, ``collectives``, ``roofline``
    and ``by_position`` from the step's ``counts`` (of one trace, or
    fitted over trip counts)."""
    devs = lowered.devices
    links = [counts.stats(d).link_bytes for d in devs]
    pos = {"flops": _by_position(counts, devs, "flops"),
           "hbm_bytes": _by_position(counts, devs, "hbm_bytes"),
           "link_bytes": {"min": min(links), "max": max(links),
                          "argmax": links.index(max(links)),
                          "sum": sum(counts.stats(d).link_bytes
                                     for d in set(devs))},
           "peak_bytes": _by_position(counts, devs, "peak_bytes")}
    top = devs[pos["peak_bytes"]["argmax"]]
    st = counts.stats(top)
    total = st.peak_bytes
    memory = {"argument_size_in_bytes": st.argument_bytes,
              "output_size_in_bytes": counts.table[top]["output_bytes"],
              "temp_size_in_bytes": st.peak_bytes - st.argument_bytes,
              "alias_size_in_bytes": counts.table[top]["alias_bytes"],
              "per_device_total": total,
              "hbm_bytes": hbm_bytes,
              "fits_hbm": (None if hbm_bytes is None
                           else bool(total < hbm_bytes))}
    flops = pos["flops"]["max"]
    hbm = pos["hbm_bytes"]["max"]
    busiest = counts.stats(devs[pos["link_bytes"]["argmax"]])
    rl = Roofline.from_measurements(flops, hbm, busiest.link_bytes,
                                    link_bw=link_bw)
    mf_dev = model_flops(cfg, kind, tokens) / chips
    return {
        "memory": memory,
        "cost": {"flops": flops, "bytes_accessed": hbm,
                 "bytes_accessed_upper": hbm},
        "collectives": dict(busiest.link),
        "roofline": {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "bound_step_s": rl.bound_step_time(),
            "model_flops_per_dev": mf_dev,
            "useful_flops_ratio": (mf_dev / rl.flops) if rl.flops else 0.0,
            "mfu_bound": rl.mfu(mf_dev)},
        "by_position": pos,
        "n_ops": sum(counts.table[d]["ops"] for d in set(devs)),
    }


# ---------------------------------------------------------------------------
# trip counts: the step traced with its loops capped, the counts fitted
# ---------------------------------------------------------------------------

#: A loop repeats its body on the same shapes every iteration, so each
#: count is of degree 1 in each loop's trip count (``DEGREE``); a count
#: of nested loops is of degree 1 in each of them, a product that the
#: tensor-product grid over the variables holds.  Each variable's sample
#: caps (the grid) are ``trips.first(site)`` and the next, its check
#: point the one after.
DEGREE = 1

#: a loop is fitted where its full trip count is at least this many
#: times its check cap: a shorter inner loop (a train step's 8 query
#: chunks) costs about as much run whole as traced at three caps in
#: twice as many traces.  The loops over the whole model (its pattern
#: groups, a train step's microbatches or a data row's pieces) pay
#: wherever they are longer than their check cap.
WORTH = 2
WHOLE_MODEL = ("groups", "microbatches", "pieces")


def points(site: str) -> tuple:
    return tuple(range(first(site), first(site) + DEGREE + 1))


def check_cap(site: str) -> int:
    return first(site) + DEGREE + 1


#: mismatches a FAIL record lists
SHOWN = 8


class TripFailure(Exception):
    """The fitted counts missed the check point, or came out other
    than whole, non-negative numbers."""

    def __init__(self, message: str, mismatches=()):
        super().__init__(message, list(mismatches))
        self.mismatches = list(mismatches)

    def __str__(self) -> str:
        return self.args[0]


def _weights(points, x) -> list:
    """The Lagrange weights of ``points`` at ``x`` (exact)."""
    out = []
    for i, p in enumerate(points):
        w = Fraction(1)
        for j, q in enumerate(points):
            if j != i:
                w *= Fraction(x - q, p - q)
        out.append(w)
    return out


def _grid_weights(axes, grid, at) -> list:
    """Each grid point's weight in the tensor-product interpolant over
    ``axes`` (each variable's sample points) at ``at`` (one value a
    variable)."""
    per = [_weights(ax, x) for ax, x in zip(axes, at)]
    out = []
    for g in grid:
        w = Fraction(1)
        for v, gv in enumerate(g):
            w *= per[v][axes[v].index(gv)]
        out.append(w)
    return out


class RowPlan:
    """The data rows of a mesh step that the dry run runs, and the row
    each other row is charged like (``TraceStats.predict_row``).

    Every data row runs the same ops on the same shapes, on its own
    positions, and exchanges the same blocks with the others: it reads
    each parameter block from its first holder, adds its gradients'
    blocks into every position's, sends its loss to the first position
    (``launch.train``); a serving step's row reads its positions'
    parameter blocks the same way, writes its own rows of the caches and
    sends its logits to the first position (``launch.serve``).  So a row
    not run counts as a row that ran, with
    the two rows' positions swapped, where the swap changes nothing else
    of the step.  It does not for:

    * the row holding the first position (``home``: the loss, and the
      first holder of every block replicated over the rows);
    * rows of another pod: a block is replicated over ``pod``, so every
      row of pod 1 reads it from pod 0, and a row of pod 0 reads its own
      locally: each pod's rows are charged like one of the same pod;
    * a row holding a device without an index (the last two positions of
      2 x 16 x 16, ``launch.mesh.fake_devices``): the constants of every
      row lie there, on the one of each of the row's devices' type
      (``cpu`` or ``meta``), so where those are positions a row is
      charged like one whose devices are of the same types;
    * the last row: what it leaves (its last piece's batch, loss terms
      and gradient leaf) stays live on its device through the update.

    Those rows run, with one row of each pod and types (its last other
    row); the others are predicted.  The dry run holds the prediction to
    the trace of every row at caps of 1 (``TripCounts``).

    A serving step's row on a mesh of pods also writes its caches'
    replicas on its twins, the rows of its ``data`` index in the other
    pods (``launch.serve._row_span``): a row is then charged like
    another with their twins swapped too, the home's twins run, and a
    row's group also names its twins' device types."""

    def __init__(self, mesh, twins: bool = False):
        data_rows = rows(mesh)
        inner = batch_axes(mesh)[:-1]   # the axes a pod is named by
        typed = any(d.index is None for d in mesh.devices)
        n_data = mesh.shape.get("data", 1)

        def twins_of(row):      # the rows of its data index, other pods
            if not twins or not inner:
                return []
            return [t for t in data_rows if t is not row
                    and t.index % n_data == row.index % n_data]

        def types(row):
            return tuple(d.type for d in row.devices) if typed else ()

        def group(row):         # its pod, and its devices' types
            c = mesh.coords(row.positions[0])
            return (tuple(c[a] for a in inner), types(row),
                    tuple(types(t) for t in twins_of(row)))

        def special(row):
            return any(0 in r.positions or any(d.index is None
                                               for d in r.devices)
                       for r in [row] + twins_of(row))

        like = {}
        for r in reversed(data_rows):
            if not special(r):
                like.setdefault(group(r), r)
        run = {r.index for r in data_rows if special(r)}
        run |= {data_rows[-1].index} | {t.index for t in like.values()}
        self.run = run
        #: each predicted row -> (the row it is charged like, the device
        #: map from that row's positions to its own and back)
        self.like = {}
        for r in data_rows:
            if r.index not in run:
                t = like[group(r)]
                moved = {}
                for a, c in zip([t] + twins_of(t), [r] + twins_of(r)):
                    moved.update(zip(a.devices, c.devices))
                    moved.update(zip(c.devices, a.devices))
                self.like[r.index] = (t.index, moved)

    @classmethod
    def of(cls, lowered):
        """The plan of ``lowered``'s step, or None where every row runs:
        not a step on a mesh of distinct devices, or no row to
        predict."""
        mesh = lowered.mesh
        if mesh is None or len(set(mesh.devices)) != mesh.size:
            return None
        plan = cls(mesh, twins=lowered.kind != "train")
        return plan if plan.like else None

    def predict(self, counter) -> None:
        """Charge ``counter`` (a trace of the rows run) with each row not
        run."""
        for r, (t, moved) in sorted(self.like.items()):
            counter.predict_row(r, t, moved)

    def record(self) -> dict:
        return {"run": sorted(self.run),
                "predicted": {str(r): t for r, (t, _) in
                              sorted(self.like.items())}}


class TripCounts:
    """A step's counts recovered from traces with its loops capped
    (``models.trips``): the counterpart of ``hlo_stats.analyze``
    multiplying each while loop's body by its trip count.

    The step is traced at its full shapes.  A first trace with every
    loop cut to one iteration finds the loops: each (site, full trip
    count) longer than ``trips.small(site)`` (and, but for the
    ``WHOLE_MODEL`` loops, ``WORTH`` times its check cap) is a
    variable, and other loops run whole.  Then one trace at each point
    of the tensor-product grid of the variables' ``points`` and one at
    the check point (each variable at its ``check_cap``), in
    ``workers`` processes forked before the first trace.  Every field
    of every device is fitted over the grid in ``fractions.Fraction``
    and evaluated at the full trip counts and at the check point.  The peak is a maximum over the trace, so it
    is fitted place by place (the live bytes after the allocations at
    one place of the loop nest, ``TraceStats.places``) and the maximum
    taken over the places' fitted values.  The fit must predict the check
    trace exactly, every field and every place, and every fitted value
    must be a whole, non-negative number; else ``TripFailure``.
    Argument bytes are the placed arguments' (the same in every trace).

    A mesh step's traces run only the data rows of its
    ``RowPlan`` and charge the others like them.  The first trace is
    then made twice, of those rows and of every row (beside the others),
    and the prediction must equal the trace of every row in every field
    of every position and at every place; else ``TripFailure``.  A miss
    never falls back to tracing every row.
    """

    def __init__(self, lowered, per_op: bool = False, workers: int = 1):
        self.lowered, self.keep_ops = lowered, per_op
        self.plan = RowPlan.of(lowered)
        self.traces, self.seconds, self.corner_s = 0, [], {}
        with self._pool(workers) as pool:
            if self.plan is None:
                ran = (pool.apply(_forked_corner, (False,)) if pool
                       else self._corner(False))
            elif pool is None:
                every, ran = self._corner(False), self._corner(True)
                self._hold_rows(ran, every)
            else:
                # every row's first trace runs beside the others
                every = pool.apply_async(_forked_corner, (False,))
                ran = pool.apply(_forked_corner, (True,))
            self.variables = ran[1]
            full = tuple(n for _, n in self.variables)
            self.axes = [points(s) for s, _ in self.variables]
            grid = list(itertools.product(*self.axes))
            self.check_point = tuple(check_cap(s)
                                     for s, _ in self.variables)
            todo = [dict(zip(self.variables, g))
                    for g in grid + ([self.check_point] if full else [])]
            done = self._traces(todo, pool)
            if self.plan is not None and pool is not None:
                self._hold_rows(ran, every.get())
        samples = dict(zip(grid, done))
        corner = done[0]
        check = done[-1]
        self.grid, self.samples, self.full = grid, samples, full
        keys = corner.places[0]
        if any(not np.array_equal(c.places[0], keys)
               for c in (*samples.values(), check)):
            raise TripFailure("the traces allocate at different places of "
                              "the loop nest")
        self.counts = self._evaluate(full, corner)
        predicted = self._evaluate(self.check_point, corner, keep=True)
        self.mismatches = _misses(predicted, check, lowered.devices,
                                  "fitted")
        if self.mismatches:
            raise TripFailure(
                f"{len(self.mismatches)} fitted values miss the check "
                f"point {dict(zip(self._names(), self.check_point))}",
                self.mismatches)
        for c in samples.values():
            c.places = None

    def _corner(self, predicted: bool):
        """The step traced with every loop cut to one iteration, of the
        plan's rows (the others predicted) or of every row: (its counts
        in device order, the loops to fit, its seconds)."""
        t0 = time.time()
        with capped({}, lambda s, n: 1,
                    rows=self.plan.run if predicted else None) as seen:
            out, counter = self.lowered.trace(placed=self.plan is not None)
            if predicted:
                self.plan.predict(counter)
            counts = Counts.of_trace(self.lowered, out, counter)
        del out, counter
        return (counts.in_order(),
                sorted(v for v in seen if self._fitted(*v)),
                round(time.time() - t0, 1))

    def _hold_rows(self, ran, every) -> None:
        """The first trace of the plan's rows, its other rows predicted,
        against the same trace of every row: equal in every field of
        every position and at every place, and meeting the same loops;
        else ``TripFailure``."""
        self.corner_s = {"rows_run": ran[2], "every_row": every[2]}
        devs = list(dict.fromkeys(self.lowered.devices))
        got, want = (Counts.by_index(c[0], devs) for c in (ran, every))
        if ran[1] != every[1]:
            raise TripFailure(f"the rows run meet the loops {ran[1]}, "
                              f"every row {every[1]}")
        misses = _misses(got, want, self.lowered.devices, "predicted")
        if misses:
            raise TripFailure(
                f"{len(misses)} values of the rows predicted miss the "
                f"trace of every row at caps of 1", misses)

    def _fitted(self, site: str, n: int) -> bool:
        return n > small(site) and (site in WHOLE_MODEL
                                    or n >= WORTH * check_cap(site))

    def _names(self):
        return [f"{s}@{n}" for s, n in self.variables]

    @contextlib.contextmanager
    def _pool(self, workers: int):
        """``workers`` processes forked from this one before it traces
        anything (autograd refuses to run in a process forked after a
        backward started its threads), or None for one."""
        if workers <= 1:
            yield None
            return
        global _FORKED
        _FORKED = self
        try:
            with multiprocessing.get_context("fork").Pool(workers) as pool:
                yield pool
        finally:
            _FORKED = None

    def _traces(self, todo, pool) -> list:
        """``Counts`` of a trace at each of ``todo``'s caps, in order: in
        this process, or in ``pool``'s (each trace is independent; a
        place is the same integer in each process)."""
        if pool is None:
            return [self._trace(caps)[0] for caps in todo]
        got = pool.map(_forked_trace, [(caps, self.variables)
                                       for caps in todo], chunksize=1)
        devs = list(dict.fromkeys(self.lowered.devices))
        for _, secs in got:
            self.traces += 1
            self.seconds.append(secs)
        return [Counts.by_index(c, devs) for c, _ in got]

    def _trace(self, caps, variables=None):
        """One trace at ``caps`` (of the plan's rows, the others
        predicted): its ``Counts`` and the loops it met, which must be
        ``variables`` (this object's by default: a forked worker is
        handed them)."""
        variables = self.variables if variables is None else variables
        t0 = time.time()
        with capped(caps, rows=self.plan and self.plan.run) as seen:
            out, counter = self.lowered.trace(per_op=self.keep_ops,
                                              placed=True)
            if self.plan is not None:
                self.plan.predict(counter)
            counts = Counts.of_trace(self.lowered, out, counter,
                                     self.keep_ops)
        del out, counter
        self.traces += 1
        self.seconds.append(round(time.time() - t0, 1))
        met = {v for v in seen if self._fitted(*v)}
        if met != set(variables):
            raise TripFailure(f"the loops {sorted(met)} are not the first "
                              f"trace's {variables}")
        return counts, seen

    def _evaluate(self, at, corner: Counts, keep: bool = False) -> Counts:
        """The fitted counts at trip counts ``at``; ``keep`` keeps the
        fitted peak of each place.  The weights are brought to integers
        over their common denominator, so each value is an exact integer
        sum and one division."""
        weights = _grid_weights(self.axes, self.grid, at)
        den = math.lcm(*(w.denominator for w in weights))
        ints = [int(w * den) for w in weights]
        bad = []

        def fitted(values, where):
            v, r = divmod(sum(w * y for w, y in zip(ints, values)), den)
            if r or v < 0:
                bad.append(where + (str(Fraction(v * den + r, den)),))
            return v

        cs = [self.samples[g] for g in self.grid]
        table = {d: {f: fitted([c.table[d][f] for c in cs], (str(d), f))
                     for f in row if f != "peak_bytes"}
                 for d, row in corner.table.items()}
        keys, vals = corner.places[0], _fit_rows(
            ints, den, [c.places[1] for c in cs], bad)
        if bad:
            raise TripFailure(f"fitted values that are not whole, "
                              f"non-negative numbers: {bad[:SHOWN]}")
        devs = list(corner.table)
        peak = np.array([corner.argument[d] for d in devs], dtype=np.int64)
        np.maximum.at(peak, keys[:, 2], vals)
        for d, v in zip(devs, peak):
            table[d]["peak_bytes"] = int(v)
        return Counts(table, corner.argument,
                      places=(keys, vals) if keep else None)

    def per_op(self, device) -> dict:
        """``device``'s fitted table of (count, FLOPs, HBM bytes) by op
        (the traces must have kept theirs: ``per_op=True``)."""
        weights = _grid_weights(self.axes, self.grid, self.full)
        cs = [self.samples[g].per_op[device] for g in self.grid]
        out = {}
        for k in set().union(*cs):
            out[k] = [int(sum(w * c.get(k, (0, 0, 0))[i]
                              for w, c in zip(weights, cs)))
                      for i in range(3)]
        return out

    def record(self) -> dict:
        """The artifact's ``trip_counts``: each variable (its loop, full
        trip count and sample caps), the check point and its verdict."""
        return {"variables": [{"loop": s, "full": n, "degree": DEGREE,
                               "points": list(ax)}
                              for (s, n), ax in zip(self.variables,
                                                    self.axes)],
                "check": {"point": list(self.check_point),
                          "verdict": "exact" if self.variables else
                          "no loop to fit: one trace of the whole step"},
                "traces": self.traces, "trace_s": self.seconds,
                **({} if self.plan is None else {"rows": dict(
                    self.plan.record(), check="exact",
                    corner_s=self.corner_s)})}


def _misses(got: Counts, want: Counts, devices, name: str) -> list:
    """Each field of each position, and each place, where ``got`` (the
    ``name``d values: fitted or predicted) differs from ``want`` (the
    traced), as {"field", "position", name, "traced"}."""
    devs = list(got.table)
    position = {d: p for p, d in reversed(list(enumerate(devices)))}
    out = [{"field": f, "position": p, name: got.table[d][f],
            "traced": want.table[d][f]}
           for p, d in enumerate(devices) for f in FIELDS
           if got.table[d][f] != want.table[d][f]]
    out += [{"field": "argument_bytes", "position": p, name: got.argument[d],
             "traced": want.argument[d]}
            for p, d in enumerate(devices)
            if got.argument[d] != want.argument[d]]
    (gk, gv), (wk, wv) = got.places, want.places
    if not np.array_equal(gk, wk):
        have = {tuple(k) for k in gk.tolist()}
        need = {tuple(k) for k in wk.tolist()}
        for k, a, b in sorted([(k, "present", "absent") for k in have - need]
                              + [(k, "absent", "present")
                                 for k in need - have])[:SHOWN]:
            out.append({"field": f"place {k[0]} of row {k[1]}",
                        "position": position[devs[k[2]]], name: a,
                        "traced": b})
        return out
    for i in np.flatnonzero(gv != wv):
        out.append({"field": f"peak at place {int(gk[i, 0])} of row "
                             f"{int(gk[i, 1])}",
                    "position": position[devs[gk[i, 2]]],
                    name: int(gv[i]), "traced": int(wv[i])})
    return out


def _fit_rows(ints, den: int, rows, bad) -> np.ndarray:
    """``sum(ints[g] * rows[g]) / den`` element by element, in int64
    where no sum can overflow it, else in Python integers; a value that
    is not a whole, non-negative number is added to ``bad``."""
    bound = sum(abs(w) for w in ints) * max(
        (int(np.abs(r).max()) for r in rows if r.size), default=0)
    if bound < 2 ** 62:
        total = sum(w * r for w, r in zip(ints, rows))
    else:
        total = np.array([sum(w * int(r[i]) for w, r in zip(ints, rows))
                          for i in range(rows[0].size)], dtype=object)
    q, r = np.divmod(total, den) if den > 1 else (total, 0 * total)
    for i in np.flatnonzero((r != 0) | (q < 0))[:SHOWN]:
        bad.append(("place", str(Fraction(int(total[i]), den))))
    return np.asarray(q, dtype=np.int64)


#: the ``TripCounts`` whose traces forked workers run
_FORKED = None


def _forked_corner(predicted):
    return _FORKED._corner(predicted)


def _forked_trace(task):
    """A worker's trace, its counts in device order (a fake device with
    a wrapped, negative index does not unpickle)."""
    counts, _ = _FORKED._trace(*task)
    return counts.in_order(), _FORKED.seconds[-1]


def count_step(lowered, trips: bool = True, per_op: bool = False,
               workers: int = 1):
    """(``Counts`` of ``lowered``'s step, the ``trip_counts`` record or
    None, a device's table of counts by op where ``per_op``): fitted
    over its loops' trip counts (``TripCounts``), or from one full trace
    where ``trips`` is false.  Raises ``TripFailure``."""
    if not trips:
        out, counter = lowered.trace(per_op=per_op)
        counts = Counts.of_trace(lowered, out, counter, per_op)
        return counts, None, (lambda d: counts.per_op[d])
    tc = TripCounts(lowered, per_op=per_op, workers=workers)
    return tc.counts, tc.record(), tc.per_op


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             save_trace: bool = False, tcfg: TrainConfig = None,
             chunked_prefill: bool = False, hbm_bytes=None,
             devices=None, trips: bool = True, workers: int = 1) -> dict:
    """One cell's artifact.  ``trips`` (the default) fits the counts over
    the loops' trip counts (``TripCounts``, its traces in ``workers``
    forked processes); ``trips=False`` traces the whole step once.  A
    fit that misses its check point gives a ``FAIL`` record naming the
    field, the position and both values."""
    t0 = time.time()
    cfg = get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    result = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "chips": chips}

    lowered, spec = lower_cell(arch, shape, multi_pod, tcfg,
                               chunked_prefill, devices)
    if lowered is None:
        result["status"] = "SKIP"
        result["reason"] = f"{arch} skips {shape} (see DESIGN.md)"
        return result
    t_lower = time.time() - t0

    try:
        counts, record, ops_of = count_step(lowered, trips,
                                            per_op=save_trace,
                                            workers=workers)
    except TripFailure as e:
        result.update(status="FAIL", reason=str(e),
                      mismatches=e.mismatches[:SHOWN],
                      timing={"lower_s": round(t_lower, 1),
                              "trace_s": round(time.time() - t0
                                               - t_lower, 1)})
        return result
    t_trace = time.time() - t0 - t_lower

    result.update(summarize(
        lowered, counts, chips=chips, kind=spec.kind,
        tokens=cell_tokens(spec),
        cfg=cfg, link_bw=hw.DCN_BW if multi_pod else hw.ICI_BW,
        hbm_bytes=hbm_bytes))
    result["timing"] = {"lower_s": round(t_lower, 1),
                        "trace_s": round(t_trace, 1)}
    if record is not None:
        result["trip_counts"] = record
    result["status"] = "OK"

    if save_trace:
        top = lowered.devices[result["by_position"]["flops"]["argmax"]]
        table = sorted(([op, *row] for op, row in ops_of(top).items()),
                       key=lambda r: -r[3])
        tdir = out_dir / "trace"
        tdir.mkdir(parents=True, exist_ok=True)
        with gzip.open(tdir / f"{arch}__{shape}__{mesh_name}.tsv.gz",
                       "wt") as f:
            f.write("op\tcount\tflops\thbm_bytes\n")
            for op, n, fl, b in table:
                f.write(f"{op}\t{n}\t{fl:.0f}\t{b:.0f}\n")
    return result


def card_hbm_bytes(given):
    """One card's memory: ``given`` (``--hbm-bytes``), else the visible
    card's; None where neither is known."""
    if given is not None:
        return int(given)
    import torch
    return hw.hbm_bytes() if torch.cuda.is_available() else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-trace", action="store_true",
                    help="write the busiest position's per-op table "
                         "(gzipped tsv)")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel rules (the same trace: the "
                         "port's layouts do not read them)")
    ap.add_argument("--opt8", action="store_true",
                    help="8-bit Adam moments")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="prefill over chunks of 2048 tokens")
    ap.add_argument("--n-micro", type=int, default=8)
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix for variants")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="one card's memory, for fits_hbm (read from the "
                         "card where one is visible)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes to run the fit's traces in")
    args = ap.parse_args(argv)

    hbm = card_hbm_bytes(args.hbm_bytes)
    if hbm is None:
        ap.error("no card is visible: give --hbm-bytes for fits_hbm")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tcfg = TrainConfig(n_micro=args.n_micro, sequence_parallel=args.sp,
                       opt_8bit=args.opt8)
    res = run_cell(args.arch, args.shape, args.multi_pod, out_dir,
                   save_trace=args.save_trace, tcfg=tcfg,
                   chunked_prefill=args.chunked_prefill, hbm_bytes=hbm,
                   workers=args.workers)
    if args.sp or args.opt8 or args.chunked_prefill \
            or args.n_micro != 8 or args.tag:
        res["variant"] = {"sp": args.sp, "opt8": args.opt8,
                          "chunked_prefill": args.chunked_prefill,
                          "n_micro": args.n_micro, "tag": args.tag}
    mesh_name = res["mesh"]
    suffix = f"__{args.tag}" if args.tag else ""
    path = out_dir / f"{args.arch}__{args.shape}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(res, indent=2))
    print(json.dumps(res, indent=2))
    if res["status"] == "FAIL":
        raise SystemExit(f"{path.name}: {res['reason']}")


if __name__ == "__main__":
    main()
