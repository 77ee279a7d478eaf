"""The dry run's trip counts (``repro_torch.launch.dryrun.TripCounts``,
``repro_torch.models.trips``) and its block lookups, on the CPU.

* Fitted against traced: for each of the ten archs' ``reduced_config``,
  train (remat "full"), prefill, chunked prefill (chunks of 512 tokens;
  not xlstm-350m or whisper-tiny, which refuse it) and decode, on one
  fake device and on the fake (2, 4) mesh, each at the least size that
  makes one or two of its loops fitted variables (``shape_of``: six
  pattern groups, or two with a longer loop inside): every field of
  every position
  (FLOPs, HBM bytes, each collective's link bytes, peak, ops, output and
  alias bytes, argument bytes) fitted over the loops' trip counts equals
  the whole step traced once (``trips=False``).  The shapes make each
  family's loops longer than ``trips.small``, so that each is fitted:
  the groups, the microbatches and a data row's pieces, the encoder's
  layers, attention's query chunks, the SSD chunks, the mLSTM chunks,
  the sLSTM steps and the chunked prefill's chunks.  Each arch's cases
  run once, in a module-scoped fixture.
* The block lookups, found once per layout (``dist.sharding.Layout``),
  dispatch what the lookups by position did: the same ops in the same
  order with the same counts, on one (2, 4) train step.
* A toy step whose count is not of degree 1 in its loop's trip count
  ends in a ``FAIL`` record naming the field, the position and both
  values; the fit never falls back to the full trace.
"""

import dataclasses
import itertools
import json

import pytest
import torch

from repro_torch.configs import ALL_ARCHS, reduced_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun, serve, train
from repro_torch.launch.fake import FakeDevices
from repro_torch.launch.mesh import Lowered, fake_mesh
from repro_torch.models import trips
from repro_torch.roofline import trace_stats

KINDS = ("train", "prefill", "chunked", "decode")
WHERE = ("one_device", "mesh")
REFUSE_CHUNKED = ("xlstm-350m", "whisper-tiny")
CASES = [(a, k, w) for a in ALL_ARCHS for k in KINDS for w in WHERE
         if not (k == "chunked" and a in REFUSE_CHUNKED)]


def shape_of(arch: str, kind: str, where: str) -> dict:
    """Each case's size: its pattern groups, encoder layers (whisper),
    sequence, batch and microbatches, the least that makes one or two
    of its loops longer than ``trips.small`` (6 groups, 6 microbatches
    or pieces a data row, 6 query chunks of 512 in 3,072 tokens, 6
    chunks of 512 in a chunked prefill, 8 or 16 SSD chunks of 32, 10
    mLSTM chunks of 256, an sLSTM of 16 to 2,560 steps)."""
    sh_ = dict(groups=2, enc=2, seq=512, batch=2, micro=1)
    if kind == "decode":
        sh_.update(groups=6, seq=64)
    elif kind == "train":
        if arch == "gemma-2b":      # the microbatches and a row's pieces
            sh_.update(batch=6 if where == "one_device" else 12, micro=6,
                       groups=6 if where == "one_device" else 2)
        else:
            sh_.update(groups=6, batch=1 if where == "one_device" else 2)
    elif kind == "prefill":
        sh_.update(seq=3072) if where == "one_device" else sh_.update(
            groups=6)
    elif kind == "chunked":
        sh_.update(seq=3072) if where == "one_device" else sh_.update(
            groups=6, seq=1024)
    if arch == "zamba2-2.7b" and kind != "decode":
        sh_["groups"] = 2           # six layers a group: the SSD chunks
        if kind != "chunked":
            sh_["seq"] = min(sh_["seq"], 256)
    if arch == "xlstm-350m" and kind != "decode":
        sh_.update(groups=1, seq={("prefill", "one_device"): 2560,
                                  ("prefill", "mesh"): 256}.get(
                                      (kind, where), 16))
    if arch == "whisper-tiny" and kind in ("train", "prefill") \
            and where == "one_device":
        sh_["enc"] = 6
    return sh_


def lower(arch: str, kind: str, where: str):
    z = shape_of(arch, kind, where)
    cfg = reduced_config(arch)
    changes = dict(n_layers=len(cfg.layer_pattern) * z["groups"],
                   remat="full")
    if cfg.enc_dec:
        changes["n_enc_layers"] = z["enc"]
    cfg = dataclasses.replace(cfg, **changes)
    mesh = (fake_mesh(sh.abstract_mesh((2, 4), ("data", "model")))
            if where == "mesh" else None)
    s, b = z["seq"], z["batch"]
    dt = getattr(torch, cfg.dtype)
    extras = {}
    if cfg.frontend == "vit":
        extras["prefix_embeds"] = ((b, cfg.frontend_tokens, cfg.d_model), dt)
    if cfg.frontend == "audio":
        extras["enc_frames"] = ((b, cfg.enc_seq, cfg.d_model), dt)
    if kind == "train":
        specs = {"tokens": ((b, s), torch.int32),
                 "labels": ((b, s), torch.int32), **extras}
        return train.lower_train_step(
            cfg, train.TrainConfig(n_micro=z["micro"]), mesh, specs)
    if kind == "decode":
        return serve.lower_serve_step(
            cfg, mesh, batch=b, seq_len=s,
            specs={"token": ((b, 1), torch.int32), "pos": ((b,), torch.int32)})
    specs = {"tokens": ((b, s), torch.int32)}
    if kind == "prefill":
        specs.update(extras)
    return serve.lower_prefill_step(cfg, mesh, batch=b, seq_len=s,
                                    specs=specs, chunked=kind == "chunked",
                                    chunk_len=512)


@pytest.fixture(scope="module")
def counted():
    """(full trace, fitted counts, trip record) of each case, each arch's
    cases computed together the first time one of them is asked for.
    Every loop longer than its check cap is fitted (``WORTH`` 1), so
    that loops of six are."""
    done = {}

    def get(arch, kind, where):
        if (arch, kind, where) not in done:
            for c in CASES:
                if c[0] == arch:
                    lo = lower(*c)
                    full, _, _ = dryrun.count_step(lo, trips=False)
                    with pytest.MonkeyPatch.context() as m:
                        m.setattr(dryrun, "WORTH", 1)
                        fit, rec, _ = dryrun.count_step(lo)
                    done[c] = (lo, full, fit, rec)
        return done[(arch, kind, where)]
    return get


@pytest.mark.parametrize("arch,kind,where", CASES)
def test_fitted_counts_equal_the_full_trace(counted, arch, kind, where):
    lo, full, fit, rec = counted(arch, kind, where)
    assert rec["variables"] and rec["check"]["verdict"] == "exact"
    assert rec["traces"] == 2 ** len(rec["variables"]) + 1
    assert len(rec["trace_s"]) == rec["traces"]
    assert set(fit.table) == set(full.table) == set(lo.devices)
    for p, d in enumerate(lo.devices):
        for f in dryrun.FIELDS:
            assert fit.table[d][f] == full.table[d][f], (p, f)
        assert fit.argument[d] == full.argument[d]


def test_every_loop_is_fitted_somewhere(counted):
    loops = set()
    for c in CASES:
        loops |= {v["loop"] for v in counted(*c)[3]["variables"]}
    assert loops == {"groups", "microbatches", "pieces", "encoder.layers",
                     "attention.q", "ssd.chunks", "mlstm.q", "mlstm.k",
                     "slstm.steps", "prefill.chunks"}


# ---------------------------------------------------------------------------
# the block lookups, found once per layout
# ---------------------------------------------------------------------------

def _old_block(self, p):
    return self.sharding.block(self.shape, p)


def _old_owners(self):
    seen, out = set(), []
    for p in range(self.mesh.size):
        key = self.sharding.block_index(self.shape, p)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def _old_read(self, box=None, device=None):
    box = sh.full_box(self.shape) if box is None else tuple(box)
    device = self.mesh.devices[0] if device is None else device
    out = torch.empty(tuple(s.stop - s.start for s in box),
                      dtype=self.dtype, device=device)
    with sh.link_kind("all-gather"):
        for p in _old_owners(self):
            blk = _old_block(self, p)
            ov = sh._overlap(blk, box)
            if ov is not None:
                out[sh._shift(ov, box)] = self.shards[p][
                    sh._shift(ov, blk)].to(device)
    return out


def _old_write(self, box, value):
    box = tuple(box)
    with sh.link_kind("reduce-scatter"):
        for p in range(self.mesh.size):
            blk = _old_block(self, p)
            ov = sh._overlap(blk, box)
            if ov is not None:
                dst = self.shards[p]
                dst[sh._shift(ov, blk)] = value[sh._shift(ov, box)].to(
                    dst.device, dst.dtype)


def _old_scatter_add(acc, g):
    with sh.link_kind("reduce-scatter"):
        for p, s in enumerate(acc.shards):
            s.add_(g[_old_block(acc, p)].float().to(s.device))


def _old_regions(x, whole_last=False):
    seen, out = set(), []
    for p in _old_owners(x):
        box = _old_block(x, p)
        if whole_last and x.ndim:
            box = box[:-1] + (slice(0, x.shape[-1]),)
        key = tuple((s.start, s.stop) for s in box)
        if key not in seen:
            seen.add(key)
            out.append((box, x.mesh.devices[p]))
    return out


def _ops_of(lowered):
    """The step's counted ops in order, and its counter."""
    seen = []
    observe = trace_stats.TraceStats.observe

    def spy(self, info, func, *rest):
        seen.append(str(func))
        return observe(self, info, func, *rest)

    trace_stats.TraceStats.observe = spy
    try:
        _, counter = lowered.trace(per_op=True)
    finally:
        trace_stats.TraceStats.observe = observe
    return seen, counter


@pytest.mark.parametrize("opt8", [False, True])
def test_block_lookups_once_dispatch_the_same_ops(monkeypatch, opt8):
    cfg = dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"),
                              n_layers=2, remat="full")
    mesh = fake_mesh(sh.abstract_mesh((2, 4), ("data", "model")))
    specs = {k: ((4, 32), torch.int32) for k in ("tokens", "labels")}
    tcfg = train.TrainConfig(n_micro=2, opt_8bit=opt8)
    new_ops, new = _ops_of(train.lower_train_step(cfg, tcfg, mesh, specs))
    with monkeypatch.context() as m:
        m.setattr(sh.Sharded, "read", _old_read)
        m.setattr(sh.Sharded, "write", _old_write)
        m.setattr(sh.Sharded, "owners", _old_owners)
        m.setattr(sh.Sharded, "block", _old_block)
        m.setattr(train, "scatter_add", _old_scatter_add)
        m.setattr(train, "_regions", _old_regions)
        old_ops, old = _ops_of(train.lower_train_step(cfg, tcfg, mesh,
                                                      specs))
    assert len(new_ops) > 10_000 and new_ops == old_ops
    for d in mesh.devices:
        assert new.stats(d) == old.stats(d)
        assert new.table[d] == old.table[d]


def test_layout_overlaps_match_a_scan_of_every_block():
    mesh = sh.abstract_mesh((2, 2, 4), ("pod", "data", "model"))
    shape = (8, 16, 16)
    for spec in (sh.P(("pod", "data"), None, "model"), sh.P(None, "model"),
                 sh.P("data", ("model", "pod")), sh.P()):
        nsh = sh.NamedSharding(mesh, spec)
        lay = nsh.layout(shape)
        for box in ((slice(0, 8), slice(0, 16), slice(0, 16)),
                    (slice(2, 7), slice(3, 4), slice(5, 16)),
                    (slice(4, 4), slice(0, 16), slice(0, 16))):
            for owners_only in (True, False):
                among = lay.owners if owners_only else range(mesh.size)
                want = []
                for p in among:
                    blk = nsh.block(shape, p)
                    ov = sh._overlap(blk, box)
                    if ov is not None:
                        want.append((p, sh._shift(ov, box),
                                     sh._shift(ov, blk)))
                got = lay.reads(box) if owners_only else lay.writes(box)
                assert got == want


# ---------------------------------------------------------------------------
# a fit that misses its check point
# ---------------------------------------------------------------------------

def _toy_lowered(n: int):
    """A step whose loop's iteration i multiplies i + 1 blocks of 64
    rows: its FLOPs grow as the square of the trip count."""
    mode = FakeDevices()
    with mode:
        x = torch.zeros(64 * n, 64, device="cpu:0")
        w = torch.zeros(64, 64, device="cpu:0")

    def step(x, w):
        for i in trips.trips("toy", n):
            y = x[:64 * (i + 1)] @ w
        return y

    return Lowered("decode", step, (x, w), {}, None,
                   [torch.device("cpu:0")], mode)


def test_a_count_not_of_degree_one_fails(monkeypatch, tmp_path):
    lo = _toy_lowered(12)
    monkeypatch.setattr(dryrun, "WORTH", 1)
    with pytest.raises(dryrun.TripFailure) as e:
        dryrun.TripCounts(lo)
    miss = {m["field"]: m for m in e.value.mismatches}
    # caps 3, 4: 6, 10 blocks; the fit says 14 at 5, the trace 15
    assert miss["flops"] == {"field": "flops", "position": 0,
                             "fitted": 14 * 2 * 64 ** 3,
                             "traced": 15 * 2 * 64 ** 3}

    class Spec:
        kind, batch, seq = "decode", 1, 1

    monkeypatch.setattr(dryrun, "lower_cell", lambda *a: (lo, Spec))
    res = dryrun.run_cell("gemma-2b", "decode_32k", False, tmp_path,
                          hbm_bytes=80 * 10 ** 9)
    assert res["status"] == "FAIL" and "check point" in res["reason"]
    assert "flops" in {m["field"] for m in res["mismatches"]}
    json.dumps(res)
    full = dryrun.run_cell("gemma-2b", "decode_32k", False, tmp_path,
                           hbm_bytes=80 * 10 ** 9, trips=False)
    assert full["status"] == "OK"
    assert full["cost"]["flops"] == sum(range(1, 13)) * 2 * 64 ** 3


def test_loops_run_as_written_outside_the_dry_run():
    assert not trips.active()
    assert trips.trips("groups", 7) == range(7)
    with trips.capped({("groups", 7): 3},
                      lambda s, n: trips.first(s) if n > trips.small(s)
                      else None) as seen:
        assert list(trips.trips("groups", 7)) == [0, 1, 2]
        assert list(trips.trips("groups", 5)) == list(range(5))
        assert list(trips.trips("pieces", 9)) == list(range(3))
        assert list(trips.trips("ssd.chunks", 9)) == list(range(5))
    assert seen == {("groups", 7), ("groups", 5), ("pieces", 9),
                    ("ssd.chunks", 9)}
    assert list(itertools.islice(trips.trips("groups", 7), 9)) == list(
        range(7))
