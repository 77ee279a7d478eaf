"""The port's dry run (``repro_torch.launch.dryrun`` and the counter
``repro_torch.roofline.trace_stats``) on the CPU.

* The counter on known programs, under both fake modes (the port's
  ``launch.fake.FakeDevices`` and torch's ``FakeTensorMode``): a matmul
  in a 7-iteration loop counts 7 · 2n³ FLOPs, a nested 3 × 5 loop 15×, a
  copy between two fake devices counts as link bytes under the
  collective its extent names, a view moves no bytes, and a known
  sequence of allocations and frees gives its peak.  The counter's
  FLOPs equal ``FlopCounterMode``'s on the same program.
* The port's lowerings at reduced configs on a fake (2, 4) mesh against
  the reference's own ``lower_*`` compiled on an 8-device host mesh
  (``tests/torch_dryrun_ref.py``, one subprocess): each position's
  argument bytes equal the reference's ``argument_size_in_bytes``
  exactly.  FLOPs: the reference splits every product evenly over the
  mesh (GSPMD), so its per-device FLOPs times 8 are its whole program's.
  The port's serving steps split each product over a data row's
  ``model`` positions as GSPMD does: each position's prefill and decode
  FLOPs equal the reference's per-device FLOPs exactly (and their sum
  its FLOPs times 8).  The port's train step computes a data row's dense
  blocks on the row's first position and splits only the MoE experts,
  so its per-position figures are uneven by design.  The reference's train
  step runs each microbatch's forward twice (the loss, then inside
  ``jax.grad``; ``tests/test_torch_dryrun_flops.py``), so the port's
  train FLOPs summed over positions are held to the port's one-device
  step on the same global batch instead (dense archs: an MoE row's
  capacity comes from its own tokens, so its expert products differ
  from one device's); both are printed beside the reference's.
* The mesh chunked prefill against the reference's ``prefill_chunked``
  under its 8-device run: logits and caches within 1e-4 of their scale
  (the bounds of ``tests/test_torch_mesh.py``).
* ``model_flops`` of every cell, the report's table against the
  reference's ``render``, one ``run_cell`` (and the command line) at a
  reduced config on the production mesh, the skips and the sweep's
  records.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as j_get_config
from repro.roofline import report as jreport
from repro.roofline.analysis import model_flops as j_model_flops
from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.configs import shapes
from repro_torch.dist import sharding as sh
from repro_torch.examples import dryrun_sweep
from repro_torch.launch import dryrun, fake, serve, train
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models import interop
from repro_torch.models import transformer as tf
from repro_torch.optim._tree import sorted_paths
from repro_torch.roofline import report, trace_stats
import torch_dryrun_ref as R
from torch_train_ref import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MODES = {"fake_devices": fake.FakeDevices,
         "fake_tensor_mode": lambda: FakeTensorMode()}


# ---------------------------------------------------------------------------
# the counter on known programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_loop_flops_counted_per_iteration(mode):
    n = 64
    with MODES[mode]():
        x = torch.zeros(n, n, device="cpu:0")
        w = torch.zeros(n, n, device="cpu:0")

        def loop():
            c = x
            for _ in range(7):
                c = c @ w
            return c

        def nested():
            c = x
            for _ in range(5):
                for _ in range(3):
                    c = torch.mm(c, w)
            return c

        _, one = trace_stats.count(loop)
        _, two = trace_stats.count(nested)
        with FlopCounterMode(display=False) as fc:
            loop()
    assert one.stats("cpu:0").flops == 7 * 2 * n ** 3
    assert two.stats("cpu:0").flops == 15 * 2 * n ** 3
    assert fc.get_total_flops() == one.total_flops()


@pytest.mark.parametrize("mode", list(MODES))
def test_copies_between_devices_are_link_bytes(mode):
    with MODES[mode]():
        a = torch.zeros(10, 20, device="cpu:0")

        def step():
            b = a.to("cpu:1")
            with sh.link_kind("all-gather"):
                c = a[:5].to("cpu:2")
                with sh.link_kind("reduce-scatter"):   # the outer name wins
                    d = torch.zeros(5, 20, device="cpu:3")
                    d.copy_(a[5:])
            e = b.to("cpu:1")                        # same device: no link
            return b, c, d, e

        _, c = trace_stats.count(step)
    assert c.stats("cpu:1").link == {**dict.fromkeys(
        trace_stats.COLLECTIVES, 0.0), "collective-permute": 800.0}
    assert c.stats("cpu:2").link["all-gather"] == 400.0
    assert c.stats("cpu:3").link["all-gather"] == 400.0
    assert c.stats("cpu:0").link_bytes == 0.0
    # the copy reads its source on the source's device, writes on its own
    assert c.stats("cpu:0").hbm_bytes == 800 + 400 + 400


@pytest.mark.parametrize("mode", list(MODES))
def test_collectives_name_their_kind(mode):
    mesh = sh.make_mesh((2, 2), ("data", "model"),
                        devices=[f"cpu:{p}" for p in range(4)])
    with MODES[mode]():
        xs = [torch.zeros(8, device=f"cpu:{p}") for p in range(4)]
        _, c = trace_stats.count(lambda: (
            sh.psum(xs, mesh, "model"), sh.all_gather(xs, mesh, "data"),
            sh.reduce_scatter(xs, mesh, "model")))
    # psum: position 1 sends its 32 bytes to 0, the sum goes back to 1
    assert c.stats("cpu:0").link["all-reduce"] == 32
    assert c.stats("cpu:1").link["all-reduce"] == 32
    assert c.stats("cpu:1").link["reduce-scatter"] == 32
    assert c.stats("cpu:2").link["all-gather"] == 64


@pytest.mark.parametrize("mode", list(MODES))
def test_views_move_no_bytes(mode):
    with MODES[mode]():
        x = torch.zeros(4, 6, device="cpu:0")
        _, c = trace_stats.count(lambda: (x.view(6, 4), x[:, 2:], x.t(),
                                          x.reshape(24), x.unsqueeze(0)))
        _, d = trace_stats.count(lambda: x.t().reshape(24))   # a copy
    assert c.stats("cpu:0").hbm_bytes == 0 and c.stats("cpu:0").ops == 0
    assert d.stats("cpu:0").hbm_bytes == 2 * 96


@pytest.mark.parametrize("mode", list(MODES))
def test_peak_of_allocations_and_frees(mode):
    with MODES[mode]():
        arg = torch.zeros(250, device="cpu:0")              # 1000 bytes

        def step(x):
            a = torch.zeros(1000, device="cpu:0")           # +4000
            b = torch.zeros(2000, device="cpu:0")           # +8000
            v = a[:10]                                      # a view: 0
            del a                                           # a lives on
            c = torch.zeros(500, device="cpu:0")            # +2000: 15000
            del v, b                                        # -12000
            d = torch.zeros(1000, device="cpu:0")           # +4000
            x.add_(1)                                       # in place: 0
            return c, d, x

        out, cnt = trace_stats.count(step, arg)
    st = cnt.stats("cpu:0")
    assert st.argument_bytes == 1000
    assert st.peak_bytes == 1000 + 4000 + 8000 + 2000
    assert st.live_bytes == 1000 + 2000 + 4000
    assert cnt.held_arguments(out) == {torch.device("cpu:0"): 1000}


def test_fake_devices_behave_as_cards():
    with fake.FakeDevices():
        a = torch.zeros(3, device="cpu:1")
        b = torch.zeros(3, device="cpu:2")
        with pytest.raises(RuntimeError, match="operands on"):
            a + b
        assert (a + torch.tensor(2.0)).device == torch.device("cpu:1")
        b.copy_(a)
        assert b.device == torch.device("cpu:2")
        with pytest.raises(Exception):
            a.sum().item()
        g = torch.zeros(4, 4, device="cpu:3", requires_grad=True)
        (grad,) = torch.autograd.grad((g @ g).sum(), [g])
        assert grad.device == torch.device("cpu:3") and grad.shape == (4, 4)


# ---------------------------------------------------------------------------
# the lowerings against the reference's, at reduced configs on (2, 4)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, str(Path(R.__file__)), str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    files = {"ref": json.loads((out / "ref.json").read_text())}
    for p in out.glob("*.npz"):
        with np.load(p) as d:
            files[p.stem] = {k: d[k] for k in d.files}
    return files


def lowered(cfg, kind, mesh):
    sp = {k: (s, getattr(torch, d)) for k, (s, d) in R.specs(cfg,
                                                             kind).items()}
    if kind == "train":
        return train.lower_train_step(
            cfg, train.TrainConfig(n_micro=R.N_MICRO), mesh, sp)
    if kind == "prefill":
        b, s = sp["tokens"][0]
        return serve.lower_prefill_step(cfg, mesh, batch=b, seq_len=s,
                                        specs=sp)
    return serve.lower_serve_step(cfg, mesh, batch=sp["token"][0][0],
                                  seq_len=R.DECODE_SMAX, specs=sp)


@pytest.mark.parametrize("arch,kind", R.LOWER)
def test_lowering_matches_reference_on_2x4(ref, arch, kind):
    want = ref["ref"][f"{arch}/{kind}"]
    cfg = reduced_config(arch)
    mesh = fake_mesh(sh.abstract_mesh((2, 4), ("data", "model")))
    low = lowered(cfg, kind, mesh)
    _, cnt = low.trace()
    held = [cnt.stats(d).argument_bytes for d in mesh.devices]
    assert held == [want["argument_bytes"]] * 8
    total = sum(cnt.stats(d).flops for d in mesh.devices)
    _, one = lowered(cfg, kind, None).trace()
    print(f"{arch} {kind}: port sum over positions {total:.0f}, "
          f"one device {one.total_flops():.0f}, reference per device x 8 "
          f"{8 * want['flops']:.0f}")
    if kind != "train":
        assert total == 8 * want["flops"]
    elif cfg.family != "moe":
        assert total == one.total_flops()


@pytest.mark.parametrize("arch,kind", [c for c in R.LOWER
                                       if c[1] != "train"])
def test_each_position_computes_the_reference_per_device_flops(ref, arch,
                                                               kind):
    """The serving steps split every product over a row's ``model``
    positions as GSPMD splits the reference's: each position's FLOPs
    equal the reference's per-device count."""
    want = ref["ref"][f"{arch}/{kind}"]["flops"]
    mesh = fake_mesh(sh.abstract_mesh((2, 4), ("data", "model")))
    _, cnt = lowered(reduced_config(arch), kind, mesh).trace()
    assert [cnt.stats(d).flops for d in mesh.devices] == [want] * 8


@pytest.mark.parametrize("arch", list(R.CHUNKED))
def test_mesh_chunked_prefill_matches_reference(ref, arch):
    d = ref[f"chunked_{arch}"]
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **R.CHUNKED[arch])
    mesh = sh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    like = tf.init_params(cfg, None, device="meta")
    params = interop.placed_from_numpy(
        tree_from(d, "params", like), serve.params_shardings(cfg, mesh,
                                                             like))
    c_like = tf.init_decode_caches(cfg, R.CHUNK_B, R.CHUNK_S, "meta")
    caches = sh.device_put(
        tf.init_decode_caches(cfg, R.CHUNK_B, R.CHUNK_S, "cpu"),
        serve.cache_shardings(cfg, mesh, c_like))
    step = serve.make_chunked_prefill_step(cfg, R.CHUNK_LEN, mesh)
    logits, caches = step(params, caches, torch.from_numpy(d["tokens"]))
    assert scale_err(logits.numpy(), d["logits"]) <= 1e-4
    want = tree_from(d, "caches", c_like)
    for (_, a), (_, b) in zip(sorted_paths(caches), sorted_paths(want)):
        assert scale_err(a.read(device="cpu").numpy(), b) <= 1e-4


def tree_from(flat: dict, prefix: str, like):
    leaves = [v for k, v in flat.items() if k.startswith(prefix)]
    paths = [p for p, _ in sorted_paths(like)]
    assert len(paths) == len(leaves), (prefix, len(paths), len(leaves))
    by_path = dict(zip(paths, leaves))
    return sh.tree_map_with_path(lambda p, _: by_path[p], like)


def scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0)) / max(
        float(np.abs(want).max(initial=0.0)), 1e-30)


# ---------------------------------------------------------------------------
# model FLOPs, the report, run_cell, the sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cell_model_flops_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, spec in shapes.SHAPES.items():
        tokens = dryrun.cell_tokens(spec)
        for chips in (256, 512):
            got = dryrun.model_flops(cfg, spec.kind, tokens) / chips
            assert got == j_model_flops(jcfg, spec.kind, tokens) / chips


def artifact(arch, shape, status="OK", **roof):
    if status != "OK":
        return {"arch": arch, "shape": shape, "mesh": "16x16",
                "status": status, **({"reason": "skips"}
                                     if status == "SKIP" else {})}
    rl = {"compute_s": 1.5e-5, "memory_s": 0.0123, "collective_s": 2.5,
          "dominant": "collective", "bound_step_s": 2.5,
          "useful_flops_ratio": 0.3456, "mfu_bound": 0.00123, **roof}
    return {"arch": arch, "shape": shape, "mesh": "16x16", "status": "OK",
            "roofline": rl, "timing": {"lower_s": 1.0, "trace_s": 12.3},
            "memory": {"per_device_total": 81.5e9, "fits_hbm": False,
                       "hbm_bytes": 80e9}}


def test_report_renders_as_the_reference(tmp_path):
    arts = [artifact("gemma-2b", "decode_32k"),
            artifact("gemma-2b", "long_500k", "SKIP"),
            artifact("qwen3-moe-235b-a22b", "train_4k", "TIMEOUT"),
            artifact("xlstm-350m", "prefill_32k", compute_s=0.5,
                     dominant="compute", bound_step_s=0.5)]
    for a in arts:
        (tmp_path / f"{a['arch']}__{a['shape']}__16x16.json").write_text(
            json.dumps(a))
    rows = report.load_rows(tmp_path, "16x16")
    assert len(rows) == 4
    for md in (True, False):
        assert report.render(rows, markdown=md) == jreport.render(
            rows, markdown=md)
    text = report.render(rows, capacity_gb=80.0, trace_s=True)
    assert "HBM/pos (card 80.0GB)" in text and "| TIMEOUT |" in text
    assert "81.5GB | NO | 12.3s |" in text


@pytest.fixture
def small_cells(monkeypatch):
    """The dry run at reduced configs with the decode cell cut to 16 rows
    of 256 tokens (the production mesh and layouts unchanged)."""
    monkeypatch.setattr(dryrun, "get_config", reduced_config)
    monkeypatch.setitem(shapes.SHAPES, "decode_32k", shapes.ShapeSpec(
        "decode_32k", "decode", 256, 16))


def test_run_cell_at_a_reduced_config(small_cells, tmp_path):
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--out",
                 str(tmp_path), "--hbm-bytes", "80000000000"])
    res = json.loads((tmp_path / "gemma-2b__decode_32k__16x16.json")
                     .read_text())
    assert res["status"] == "OK" and res["chips"] == 256
    assert set(res) >= {"arch", "shape", "mesh", "chips", "status",
                        "memory", "cost", "collectives", "roofline",
                        "timing", "by_position"}
    assert set(res["memory"]) >= {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes", "per_device_total",
        "fits_hbm"}
    assert set(res["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "dominant",
        "bound_step_s", "model_flops_per_dev", "useful_flops_ratio",
        "mfu_bound"}
    assert set(res["collectives"]) == set(trace_stats.COLLECTIVES)
    pos = res["by_position"]
    # each position computes its own blocks (tensor parallelism over
    # model): the even share of the cell's FLOPs on every position
    assert pos["flops"]["argmax"] % 16 == 0
    assert res["cost"]["flops"] == pos["flops"]["max"] == pos["flops"][
        "min"] == pos["flops"]["sum"] // 256
    mem = res["memory"]
    assert mem["per_device_total"] == pos["peak_bytes"]["max"]
    assert mem["per_device_total"] == (mem["argument_size_in_bytes"]
                                       + mem["temp_size_in_bytes"])
    # the caches are written in place: donated in the reference
    assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    assert mem["fits_hbm"] is True


def test_skips_match_skip_shapes(tmp_path):
    for arch in ALL_ARCHS:
        for shape in shapes.SHAPES:
            if shapes.cell_is_skipped(get_config(arch), shape):
                res = dryrun.run_cell(arch, shape, False, tmp_path)
                assert res["status"] == "SKIP" and res["reason"]
    spec = importlib.util.spec_from_file_location(
        "ref_dryrun_sweep", ROOT / "scripts" / "dryrun_sweep.py")
    ref_sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_sweep)
    assert dryrun_sweep.SKIPS == ref_sweep.SKIPS
    assert dryrun_sweep.ARCHS == ref_sweep.ARCHS
    assert dryrun_sweep.SHAPES == ref_sweep.SHAPES


def test_sweep_writes_skip_and_timeout_records(tmp_path):
    def sweep(*argv):
        ap_args = ["--out", str(tmp_path), "--only-mesh", "16x16",
                   "--archs", "gemma-2b", *argv]
        dryrun_sweep.main(ap_args)

    sweep("--shapes", "long_500k,decode_32k", "--timeout", "1",
          "--hbm-bytes", "80000000000")
    skip = json.loads((tmp_path / "gemma-2b__long_500k__16x16.json")
                      .read_text())
    late = json.loads((tmp_path / "gemma-2b__decode_32k__16x16.json")
                      .read_text())
    assert skip["status"] == "SKIP" and late["status"] == "TIMEOUT"
