"""The serving steps' tensor parallelism over ``model`` on a (2, 4) CPU
mesh (``launch/serve.py``'s mesh steps over ``dist.sharding.RowSplit``).

* Every reduced arch in float32: a prefill, two decode steps (rows at
  different positions) and, where the arch takes one, a chunked prefill
  on the mesh against the port's one-device steps run on each data row's
  batch (an MoE row's capacity comes from its own tokens, in both): the
  logits and every cache leaf within 1e-5 of their scale, the greedy
  tokens equal; on (2, 4), and on (1, 8), where the four heads leave
  positions without one, column blocks cut heads, and the decode caches
  (66 long) do not split over ``model``.
* zamba2-2.7b and moonshot-v1-16b-a3b against the reference's own
  (2, 4) run (``tests/torch_mesh_tp_ref.py``, one subprocess): logits
  and caches within 1e-4 of their scale, as ``tests/test_torch_mesh.py``
  holds gemma-2b.
* The boxes the positions read, recorded on the fake (2, 4) mesh: a
  leaf whose spec names ``model`` is read only as the reading position's
  block (the expert-parallel router whole, as the reference's
  ``shard_map`` takes it), a stacked leaf one group at a time (where
  ``zero1_spec`` splits its group dim over ``data``, the position's block
  of every group, once), and a group's blocks are freed before the next
  group is read.
* The row's collectives name their kind: the sum of partial products
  ``all-reduce``, a block read ``all-gather``.
* ``head_bounds``: each position's heads and the kv groups they read.
* The dry run's rows predicted for a serving step (``RowPlan``): traced
  with only the plan's rows run and the others charged like them, it
  equals the step traced with every row in every field of every
  position and at every place, on a (4, 2) mesh, on a (2, 4, 2) mesh of
  pods (a row's twin in the other pod swapped with it) and on that mesh
  with its devices typed as 2 x 16 x 16's.
"""

import dataclasses
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ALL_ARCHS, reduced_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import dryrun, fake, serve
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import interop
from repro_torch.models import transformer as tf
from repro_torch.models import trips
from repro_torch.models.attention import head_bounds
from repro_torch.optim._tree import sorted_paths
from repro_torch.roofline import trace_stats
import torch_mesh_tp_ref as R
from torch_train_ref import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MESH = sh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
#: (data, model) -> its mesh and the decode caches' length
MESHES = {(2, 4): (MESH, 64),
          (1, 8): (sh.make_mesh((1, 8), ("data", "model"),
                                devices=["cpu"] * 8), 66)}
B, PROMPT, CHUNK = 4, 32, 16


def scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0)) / max(
        float(np.abs(want).max(initial=0.0)), 1e-30)


def as_np(t):
    if isinstance(t, sh.Sharded):
        t = t.read(device="cpu")
    return t.detach().cpu().numpy()


def f32(arch: str):
    return dataclasses.replace(reduced_config(arch), dtype="float32")


def placed(cfg, mesh, params, batch: int, s_max: int):
    like = tf.init_params(cfg, None, device="meta")
    c_like = tf.init_decode_caches(cfg, batch, s_max, "meta")
    return (sh.device_put(params, serve.params_shardings(cfg, mesh, like)),
            sh.device_put(tf.init_decode_caches(cfg, batch, s_max, "cpu"),
                          serve.cache_shardings(cfg, mesh, c_like)))


def per_row(n: int, fn, *batched):
    """``fn`` on each of ``n`` data rows' slices of the batched arguments,
    the outputs' logits concatenated and the caches returned per row."""
    k = B // n
    outs = [fn(r, *(a[k * r:k * (r + 1)] for a in batched))
            for r in range(n)]
    return torch.cat([o[0] for o in outs]), [o[1] for o in outs]


def check_caches(mesh_caches, row_caches, what):
    got = [as_np(x) for _, x in sorted_paths(mesh_caches)]
    rows = [[as_np(x) for _, x in sorted_paths(c)] for c in row_caches]
    for i, a in enumerate(got):
        want = np.concatenate([r[i] for r in rows], axis=1)
        assert scale_err(a, want) <= 1e-5, (what, i)


@pytest.mark.parametrize("shape", list(MESHES), ids=["2x4", "1x8"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_mesh_serving_matches_one_device_rows(arch, shape):
    mesh, smax = MESHES[shape]
    n = shape[0]
    cfg = f32(arch)
    g = torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, g, "cpu")
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, PROMPT)))
    extras = {}
    if cfg.frontend == "vit":
        extras["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.frontend == "audio":
        extras["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    front = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    s_max = smax + front
    pp, caches = placed(cfg, mesh, params, B, s_max)
    logits, caches = serve.make_prefill_step(cfg, mesh)(pp, caches, toks,
                                                        **extras)
    rows = [tf.init_decode_caches(cfg, B // n, s_max, "cpu")
            for _ in range(n)]

    def prefill(r, t, *ex):
        return tf.prefill(cfg, params, t, rows[r],
                          **dict(zip(extras, ex)))
    want, rows = per_row(n, prefill, toks, *extras.values())
    assert scale_err(logits.numpy(), want.numpy()) <= 1e-5
    check_caches(caches, rows, "prefill")
    tok = logits.argmax(-1)
    assert torch.equal(tok, want.argmax(-1))
    decode = serve.make_decode_step(cfg, mesh)
    for i in range(2):
        pos = torch.full((B,), PROMPT + front + i)
        pos[1::2] -= 5
        logits, caches = decode(pp, caches, tok, pos)
        want, rows = per_row(n, lambda r, t, p: tf.decode_step(
            cfg, params, t, rows[r], p), tok, pos)
        assert scale_err(logits.numpy(), want.numpy()) <= 1e-5, i
        check_caches(caches, rows, f"decode {i}")
        tok = logits.argmax(-1)
        assert torch.equal(tok, want.argmax(-1))
    if "X" in cfg.layer_pattern or cfg.enc_dec:
        return
    pp, caches = placed(cfg, mesh, params, B, PROMPT)
    logits, caches = serve.make_chunked_prefill_step(cfg, CHUNK, mesh)(
        pp, caches, toks)
    rows = [tf.init_decode_caches(cfg, B // n, PROMPT, "cpu")
            for _ in range(n)]
    want, rows = per_row(n, lambda r, t: tf.prefill_chunked(
        cfg, params, t, rows[r], chunk_len=CHUNK), toks)
    assert scale_err(logits.numpy(), want.numpy()) <= 1e-5
    assert torch.equal(logits.argmax(-1), want.argmax(-1))
    check_caches(caches, rows, "chunked")


# ---------------------------------------------------------------------------
# against the reference's own (2, 4) run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_tp_ref")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    proc = subprocess.run([sys.executable, str(Path(R.__file__)), str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    files = {}
    for p in out.glob("*.npz"):
        with np.load(p) as d:
            files[p.stem] = {k: d[k] for k in d.files}
    return files


def tree_from(flat: dict, prefix: str, like):
    leaves = [v for k, v in flat.items() if k.startswith(prefix)]
    paths = [p for p, _ in sorted_paths(like)]
    assert len(paths) == len(leaves), (prefix, len(paths), len(leaves))
    by_path = dict(zip(paths, leaves))
    return sh.tree_map_with_path(lambda p, _: by_path[p], like)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_mesh_serving_matches_reference_mesh(ref, arch):
    d = ref[f"serve_{arch}"]
    cfg = dataclasses.replace(reduced_config(arch), vocab=512,
                              dtype="float32")
    like = tf.init_params(cfg, None, device="meta")
    params = interop.placed_from_numpy(
        tree_from(d, "params", like), serve.params_shardings(cfg, MESH,
                                                             like))
    c_like = tf.init_decode_caches(cfg, R.B, R.SMAX, "meta")
    caches = sh.device_put(tf.init_decode_caches(cfg, R.B, R.SMAX, "cpu"),
                           serve.cache_shardings(cfg, MESH, c_like))
    logits, caches = serve.make_prefill_step(cfg, MESH)(
        params, caches, torch.from_numpy(d["tokens"]))
    assert scale_err(logits.numpy(), d["logits_prefill"]) <= 1e-4

    def check(prefix):
        want = tree_from(d, prefix, c_like)
        for (_, a), (_, b) in zip(sorted_paths(caches), sorted_paths(want)):
            assert scale_err(as_np(a), b) <= 1e-4, prefix

    check("caches_prefill")
    decode = serve.make_decode_step(cfg, MESH)
    for i in range(2):
        logits, caches = decode(params, caches,
                                torch.from_numpy(d["steps"][i]),
                                torch.from_numpy(d[f"pos{i}"]))
        assert scale_err(logits.numpy(), d[f"logits_decode{i}"]) <= 1e-4
        check(f"caches_decode{i}")


# ---------------------------------------------------------------------------
# what each position reads, and the collectives' kinds
# ---------------------------------------------------------------------------

def _lowered(arch: str, kind: str):
    cfg = dataclasses.replace(reduced_config(arch), n_layers=3 * len(
        reduced_config(arch).layer_pattern))
    mesh = fake_mesh(sh.abstract_mesh((2, 4), ("data", "model")))
    if kind == "decode":
        return mesh, serve.lower_serve_step(
            cfg, mesh, batch=4, seq_len=64,
            specs={"token": ((4, 1), torch.int32),
                   "pos": ((4,), torch.int32)})
    specs = {"tokens": ((4, 32), torch.int32)}
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "vit":
        specs["prefix_embeds"] = ((4, cfg.frontend_tokens, cfg.d_model), dt)
    if cfg.frontend == "audio":
        specs["enc_frames"] = ((4, cfg.enc_seq, cfg.d_model), dt)
    return mesh, serve.lower_prefill_step(cfg, mesh, batch=4, seq_len=32,
                                          specs=specs)


@pytest.mark.parametrize("arch,kind", [
    (a, k) for a in ("gemma-2b", "zamba2-2.7b", "moonshot-v1-16b-a3b",
                     "xlstm-350m", "whisper-tiny") for k in ("prefill",
                                                             "decode")])
def test_positions_read_their_blocks_one_group_at_a_time(monkeypatch,
                                                         arch, kind):
    mesh, low = _lowered(arch, kind)
    params = low.args[0]
    names = {id(x): path for path, x in sorted_paths(params)}
    where = {d: p for p, d in enumerate(mesh.devices)}
    reads, alive, once = [], [], set()
    read = sh.Sharded.gather_box

    def spy(self, box, device):
        out = read(self, box, device)
        path = names.get(id(self))
        if path is None:                       # a cache or an input
            return out
        p = where[torch.device(device)]
        row, j = divmod(p, mesh.shape["model"])
        stacked = path[0] in ("stack", "enc_stack", "cross")
        parts = self.sharding._parts(self.ndim)
        if stacked and parts[0] is not None:
            # the group dim split over data: the position's block of
            # every group, read once
            assert (box[0].start, box[0].stop) == (0, self.shape[0])
            assert (path, p) not in once, path
            once.add((path, p))
            stacked = False
        group = box[0].start if stacked else None
        if stacked:
            assert box[0].stop == group + 1, (path, box)
            for r, g, ref_ in alive:
                if r == row and g < group:
                    assert ref_() is None, (path, "group", g, "alive at",
                                            group)
            alive.append((row, group, weakref.ref(out)))
        reads.append((path, row, j, group, box))
        dims = [i for i, a in enumerate(parts) if "model" in sh.axes_of(a)]
        if dims and path[-1] != "router":
            n = self.shape[dims[0]] // mesh.shape["model"]
            assert (box[dims[0]].start, box[dims[0]].stop) == (
                j * n, (j + 1) * n), (path, j, box)
            for i, sl in enumerate(box):
                if i not in dims and not (stacked and i == 0):
                    assert (sl.start, sl.stop) == (0, self.shape[i])
        elif dims:                             # the router, whole a group
            assert all((sl.start, sl.stop) == (0, n) for sl, n in zip(
                box[1:], self.shape[1:])), (path, box)
        return out

    monkeypatch.setattr(sh.Sharded, "gather_box", spy)
    low.trace()
    for row in range(2):
        groups = {g for _, r, _, g, _ in reads if r == row}
        assert groups >= {0, 1, 2}
        # every position of the row read its blocks
        assert {j for _, r, j, _, _ in reads if r == row} == set(range(4))


def test_row_collectives_name_their_kind():
    mesh = sh.make_mesh((1, 4), ("data", "model"),
                        devices=[f"cpu:{p}" for p in range(4)])
    with fake.FakeDevices():
        w = sh.place(torch.zeros(8, 16, device="cpu:0"),
                     sh.NamedSharding(mesh, sh.P(None, "model")))
        split = sh.RowSplit(sh.rows(mesh)[0])
        blocks = split.view({"w": w})["w"]
        assert blocks.dim == 1 and blocks.bounds == [(0, 4), (4, 8),
                                                     (8, 12), (12, 16)]
        x = torch.zeros(3, 8, device="cpu:0")

        def step():
            parts = [xs @ blocks.block(j)
                     for j, xs in enumerate(split.spread(x))]
            return split.sum([p[:, :2] for p in parts]), split.gather(
                parts, -1)

        (total, whole), cnt = trace_stats.count(step)
    assert tuple(total.shape) == (3, 2) and tuple(whole.shape) == (3, 16)
    # each block is its position's own: no block read crosses a link
    assert all(cnt.stats(f"cpu:{p}").link["all-gather"] == 0
               for p in range(1, 4))
    # the sum: three partials of 3 x 2 floats reach the home; the gather:
    # three parts of 3 x 4
    assert cnt.stats("cpu:0").link["all-reduce"] == 3 * 24
    assert cnt.stats("cpu:0").link["all-gather"] == 3 * 48
    # the spread: x to each other position
    assert all(cnt.stats(f"cpu:{p}").link["all-reduce"] == 96
               for p in range(1, 4))
    # a row's read of a block held across data is an all-gather
    mesh2 = sh.make_mesh((2, 2), ("data", "model"),
                         devices=[f"cpu:{p}" for p in range(4)])
    with fake.FakeDevices():
        w = sh.place(torch.zeros(8, 16, device="cpu:0"),
                     sh.NamedSharding(mesh2, sh.P("data", "model")))
        b2 = sh.RowSplit(sh.rows(mesh2)[1]).view({"w": w})["w"]
        _, cnt = trace_stats.count(lambda: b2.block(1))
    # position 3 holds rows 4-7 of its columns, and reads 0-3 from 1
    assert cnt.stats("cpu:3").link["all-gather"] == 4 * 8 * 4


def test_head_bounds():
    # gemma-2b reduced on a 4-way model: one head a position, one group
    assert head_bounds(4, 1, 4) == [((j, j + 1), (0, 1)) for j in range(4)]
    # phi4-mini on 16: one or two heads a position, never two groups
    got = head_bounds(24, 8, 16)
    assert [h for h, _ in got][:4] == [(0, 1), (1, 3), (3, 4), (4, 6)]
    assert all(g1 - g0 == 1 for _, (g0, g1) in got)
    # qwen3-moe on 16: four heads of a 16-head group
    assert head_bounds(64, 4, 16)[5] == ((20, 24), (1, 2))
    # fewer heads than positions: some take none
    assert [h for h, _ in head_bounds(4, 4, 16)].count((0, 0)) == 3
    with pytest.raises(ValueError, match="part of a kv group"):
        head_bounds(6, 3, 2)


# ---------------------------------------------------------------------------
# the dry run's rows predicted for a serving step
# ---------------------------------------------------------------------------

#: mesh -> (shape, axes, devices or None: one fake device a position)
ROW_MESHES = {
    "4x2": ((4, 2), ("data", "model"), None),
    "2x4x2": ((2, 4, 2), ("pod", "data", "model"), None),
    # laid out as 2 x 16 x 16 is: cpu, then meta, the index-less last
    "2x4x2_typed": ((2, 4, 2), ("pod", "data", "model"),
                    [f"cpu:{i}" for i in range(8)]
                    + [f"meta:{i}" for i in range(6)] + ["meta", "cpu"])}
ROW_PLANS = {"4x2": ([0, 3], {"1": 3, "2": 3}),
             "2x4x2": ([0, 3, 4, 7], {"1": 3, "2": 3, "5": 7, "6": 7}),
             "2x4x2_typed": ([0, 2, 3, 4, 6, 7], {"1": 2, "5": 6})}


def _traced_rows(lowered, plan=None):
    with trips.capped({}, lambda s, n: 1,
                      rows=None if plan is None else plan.run):
        out, counter = lowered.trace(placed=True)
        if plan is not None:
            plan.predict(counter)
        return dryrun.Counts.of_trace(lowered, out, counter)


@pytest.mark.parametrize("mesh", list(ROW_MESHES))
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["gemma-2b", "zamba2-2.7b",
                                  "moonshot-v1-16b-a3b", "whisper-tiny"])
def test_serving_rows_predicted_equal_every_row(arch, kind, mesh):
    shape, axes, devices = ROW_MESHES[mesh]
    m = fake_mesh(sh.abstract_mesh(shape, axes), devices)
    cfg = reduced_config(arch)
    b = 2 * len(sh.rows(m))
    if kind == "decode":
        lo = serve.lower_serve_step(
            cfg, m, batch=b, seq_len=64,
            specs={"token": ((b, 1), torch.int32),
                   "pos": ((b,), torch.int32)})
    else:
        specs = {"tokens": ((b, 32), torch.int32)}
        if cfg.frontend == "audio":
            specs["enc_frames"] = ((b, cfg.enc_seq, cfg.d_model),
                                   getattr(torch, cfg.dtype))
        lo = serve.lower_prefill_step(cfg, m, batch=b, seq_len=32,
                                      specs=specs)
    plan = dryrun.RowPlan.of(lo)
    assert (plan.record()["run"], plan.record()["predicted"]) == \
        ROW_PLANS[mesh]
    every, predicted = _traced_rows(lo), _traced_rows(lo, plan)
    assert dryrun._misses(predicted, every, lo.devices, "predicted") == []
    for d in lo.devices:
        assert predicted.table[d] == every.table[d]
