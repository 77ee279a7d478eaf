"""The dry run's data rows predicted from the rows it runs
(``repro_torch.launch.dryrun.RowPlan``, ``TraceStats.predict_row``), on
the CPU.

* A mesh train step traced with only the plan's rows run and the others
  charged like them equals the step traced with every row, in every
  field of every position (FLOPs, HBM bytes, each collective's link
  bytes, ops, peak, output and alias bytes, argument bytes) and at
  every place of the loop nest: for the archs with the most loops
  (xlstm-350m, zamba2-2.7b, internvl2-26b, whisper-tiny) and an MoE arch
  (moonshot-v1-16b-a3b, whose experts run over its row's positions
  under ``row_scope``), with AdamW and AdamW8, on a (4, 2) mesh (four
  rows of two), a (2, 2, 2) mesh (four rows over two pods) and a
  (2, 4) mesh (two rows: every row runs); on a (6, 2) mesh whose
  devices are laid out as 2 x 16 x 16's (``cpu`` rows, ``meta`` rows,
  the devices without an index last), each row is charged like a row
  of its devices' types.  Each arch at its
  ``reduced_config``, remat "full", three pieces a row, at caps of 1
  (the dry run's check), xlstm-350m also at caps of 2.
* The fit over trip counts with rows predicted (``TripCounts``) equals
  the whole step traced once, each position's ops table too, and its
  record names the rows run and predicted.
* A row made to differ (an extra op on one row's device) ends in a
  ``FAIL`` record naming the field, the position and both values: the
  dry run never falls back to tracing every row.
"""

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import trips

ARCHS = ("xlstm-350m", "zamba2-2.7b", "internvl2-26b", "whisper-tiny",
         "moonshot-v1-16b-a3b")
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "6x2": ((6, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: the rows each mesh runs and the row each other row is charged like
PLANS = {"4x2": ([0, 3], {"1": 3, "2": 3}), "2x4": None,
         "2x2x2": ([0, 1, 3], {"2": 3})}
CASES = ["4x2", "2x4", "2x2x2"]


#: a (6, 2) mesh laid out as 2 x 16 x 16 is (``launch.mesh.fake_devices``):
#: ``cpu`` rows, then ``meta`` rows, the last two positions the devices
#: without an index, where every row's constants lie
TYPED = ["cpu:0", "cpu:1", "cpu:2", "cpu:3", "cpu:4", "cpu:5", "meta:0",
         "meta:1", "meta:2", "meta:3", "meta", "cpu"]


def lower(arch: str, mesh: str, opt8: bool, pieces: int = 3, seq: int = 16,
          devices=None):
    """The train step of ``arch``'s reduced config (remat "full") on a
    fake ``mesh`` (on ``devices``: one a position by default),
    ``pieces`` pieces of one row a data row."""
    cfg = dataclasses.replace(reduced_config(arch), remat="full")
    shape, axes = MESHES[mesh]
    m = fake_mesh(sh.abstract_mesh(shape, axes), devices)
    b = len(sh.rows(m)) * pieces
    dt = getattr(torch, cfg.dtype)
    specs = {"tokens": ((b, seq), torch.int32),
             "labels": ((b, seq), torch.int32)}
    if cfg.frontend == "vit":
        specs["prefix_embeds"] = ((b, cfg.frontend_tokens, cfg.d_model), dt)
    if cfg.frontend == "audio":
        specs["enc_frames"] = ((b, cfg.enc_seq, cfg.d_model), dt)
    tcfg = train.TrainConfig(n_micro=pieces, opt_8bit=opt8)
    return train.lower_train_step(cfg, tcfg, m, specs)


def traced(lowered, cap: int, plan=None):
    """The step's ``Counts`` with every loop cut to ``cap``: every row
    run, or only ``plan``'s and the others predicted."""
    with trips.capped({}, lambda s, n: cap,
                      rows=None if plan is None else plan.run):
        out, counter = lowered.trace(placed=True)
        if plan is not None:
            plan.predict(counter)
        return dryrun.Counts.of_trace(lowered, out, counter)


@pytest.mark.parametrize("mesh", CASES)
@pytest.mark.parametrize("opt8", [False, True], ids=["adamw", "adamw8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rows_predicted_equal_every_row(arch, opt8, mesh):
    lo = lower(arch, mesh, opt8)
    plan = dryrun.RowPlan.of(lo)
    if PLANS[mesh] is None:
        assert plan is None          # two rows: both run
        return
    assert (plan.record()["run"], plan.record()["predicted"]) == PLANS[mesh]
    for cap in (1, 2) if arch == "xlstm-350m" else (1,):
        every, predicted = traced(lo, cap), traced(lo, cap, plan)
        assert dryrun._misses(predicted, every, lo.devices,
                              "predicted") == [], cap
        assert len(every.places[1]) > 1000
        for d in lo.devices:        # FIELDS and places compared above
            assert predicted.table[d] == every.table[d]


@pytest.mark.parametrize("arch", ["gemma-2b", "moonshot-v1-16b-a3b"])
def test_rows_charged_like_rows_of_their_device_types(arch):
    """Where the devices without an index are positions, a ``cpu`` row is
    charged like a ``cpu`` row and a ``meta`` row like a ``meta`` row:
    each row's constants land on the index-less device of its type."""
    lo = lower(arch, "6x2", opt8=False, devices=TYPED)
    plan = dryrun.RowPlan.of(lo)
    assert (plan.record()["run"], plan.record()["predicted"]) == (
        [0, 2, 4, 5], {"1": 2, "3": 4})
    every, predicted = traced(lo, 1), traced(lo, 1, plan)
    assert dryrun._misses(predicted, every, lo.devices, "predicted") == []


def test_fit_with_rows_predicted_equals_the_whole_step(monkeypatch):
    """Six pieces a row on the (4, 2) mesh: the pieces are fitted, rows
    1 and 2 predicted."""
    lo = lower("internvl2-26b", "4x2", opt8=False, pieces=6)
    whole, _, whole_ops = dryrun.count_step(lo, trips=False, per_op=True)
    monkeypatch.setattr(dryrun, "WORTH", 1)
    fit, rec, fit_ops = dryrun.count_step(lo, per_op=True)
    assert [v["loop"] for v in rec["variables"]] == ["pieces"]
    assert rec["rows"]["run"] == [0, 3] and rec["rows"]["check"] == "exact"
    assert set(rec["rows"]["corner_s"]) == {"rows_run", "every_row"}
    for p, d in enumerate(lo.devices):
        for f in dryrun.FIELDS:
            assert fit.table[d][f] == whole.table[d][f], (p, f)
        assert fit.argument[d] == whole.argument[d]
        # the ops tables (``--save-trace``), a predicted row's included
        want = {k: v for k, v in whole_ops(d).items() if v[0]}
        assert {k: v for k, v in fit_ops(d).items() if any(v)} == want, p


def test_a_row_that_differs_fails(monkeypatch, tmp_path):
    """An extra op on row 2's device (position 4 of the (4, 2) mesh) in
    each of its scatters: the rows run cannot see it, so the prediction
    misses the trace of every row, and the cell is a FAIL."""
    lo = lower("internvl2-26b", "4x2", opt8=False)
    scatter = train.scatter_add

    def odd(acc, g):
        if trips.now() == 2:
            g.neg()
        scatter(acc, g)

    monkeypatch.setattr(train, "scatter_add", odd)
    monkeypatch.setattr(dryrun, "WORTH", 1)
    rows_run = []
    trace = type(lo).trace

    def spy(self, *a, **k):
        rows_run.append(trips._ROWS)
        return trace(self, *a, **k)

    monkeypatch.setattr(type(lo), "trace", spy)
    with pytest.raises(dryrun.TripFailure) as e:
        dryrun.TripCounts(lo)
    assert "every row" in str(e.value)
    miss = {(m["field"], m["position"]): m for m in e.value.mismatches}
    ops = miss[("ops", 4)]
    assert ops["traced"] > ops["predicted"]
    # the first trace twice, of every row and of the rows run: the miss
    # stops the count there, and no other trace runs every row
    assert rows_run == [None, {0, 3}]

    class Spec:
        kind, batch, seq = "train", 12, 16

    monkeypatch.setattr(dryrun, "lower_cell", lambda *a: (lo, Spec))
    res = dryrun.run_cell("internvl2-26b", "train_4k", False, tmp_path,
                          hbm_bytes=80 * 10 ** 9)
    assert res["status"] == "FAIL" and "every row" in res["reason"]
    assert {"field": "ops", "position": 4, "predicted": ops["predicted"],
            "traced": ops["traced"]} in res["mismatches"]
    assert "cost" not in res and "memory" not in res
    json.dumps(res)


def test_rows_and_copies_run_as_written_outside_the_dry_run():
    items = [object(), object()]
    assert trips.each_row(items) is items
    assert trips.each_copy(items) is items
    with trips.capped({}):
        assert trips.each_copy(items) is items     # no row running
        assert trips.now() is None
    assert trips.now() is None
