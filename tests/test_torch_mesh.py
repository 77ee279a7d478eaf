"""The port's mesh computation against the JAX package's 8-device mesh
runs, on the CPU.

``tests/torch_mesh_ref.py`` runs the reference once, in a subprocess
with eight forced host devices, and leaves npz files; the port runs each
check on an 8-position CPU mesh (``make_mesh(..., devices=["cpu"] *
8)``) from the same weights, carried by ``interop.placed_from_numpy``:

* ``moe_apply`` under ``use_mesh`` (``moe_apply_dist``) against the
  reference's: y within rtol 2e-4 / atol 2e-5 and aux within rtol 1e-2
  of the reference's local run (its own bounds), and both within 1e-5
  of the reference's mesh run (the same per-shard semantics);
* one sharded train step (FSDP, ZeRO-1, float32; reduced gemma-2b with
  AdamW and AdamW8, reduced moonshot with one-hot lookups and
  ``moe_apply_dist``): loss and gradient norm within rtol 1e-5, the
  moments within 1e-4 (``mu``) / 2e-4 (``nu``) of each leaf's scale, the
  8-bit codes at most one step apart, and the parameters by the rule of
  ``tests/test_torch_train.py`` (a first Adam step is about lr·sign(g):
  a weight whose gradient is near zero may move either way and is held
  to 2·lr·(1 + wd·|p|); the rest to lr·1e-4 and two float32 steps);
* a sharded prefill and two decode steps: logits within 1e-4 of their
  scale, the gathered caches within 1e-4;
* ``compressed_psum`` over ``pod``: bit-equal outputs and error buffers.

Also: the port's mesh step against its own ``mesh=None`` step, each
position holding only its block, the collectives, and the one-hot
lookup bit-equal to the gather.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import serve, train
from repro_torch.models import interop, layers, moe
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw8, compress
from repro_torch.optim._tree import sorted_paths
import torch_mesh_ref as R
from torch_train_ref import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MESH = sh.make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
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
    """The port's tree ``like`` with its leaves, in the reference's order
    (``sorted_paths``), taken from ``flat``'s entries under ``prefix``."""
    leaves = [v for k, v in flat.items() if k.startswith(prefix)]
    paths = [p for p, _ in sorted_paths(like)]
    assert len(paths) == len(leaves), (prefix, len(paths), len(leaves))
    by_path = dict(zip(paths, leaves))
    return sh.tree_map_with_path(lambda p, _: by_path[p], like)


def leaves(tree):
    return [x for _, x in sorted_paths(tree)]


def scale_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0)) / max(
        float(np.abs(want).max(initial=0.0)), 1e-30)


def as_np(t):
    if isinstance(t, sh.Sharded):
        t = t.read(device="cpu")
    return t.detach().cpu().numpy()


def moe_cfg():
    import dataclasses
    return dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"),
                               dtype="float32", **R.MOE_CFG)


def test_moe_dist_matches_reference(ref):
    d, cfg = ref["moe"], moe_cfg()
    like = moe.moe_init(None, cfg, torch.float32, "meta")
    params = tf.tree_map(torch.from_numpy, tree_from(d, "params", like))
    x = torch.from_numpy(d["x"])
    y_local, aux_local = moe._moe_local(params, cfg, x)
    with sh.use_mesh(MESH):
        y, aux = moe.moe_apply(params, cfg, x)
    np.testing.assert_allclose(y_local.numpy(), d["y_local"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(y.numpy(), d["y_dist"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(y.numpy(), d["y_local"], rtol=2e-4,
                               atol=2e-5)
    assert scale_err(y.numpy(), d["y_dist"]) <= 1e-5
    np.testing.assert_allclose(float(aux), float(d["aux_local"]), rtol=1e-2)
    np.testing.assert_allclose(float(aux), float(d["aux_dist"]), rtol=1e-5)
    np.testing.assert_allclose(float(aux_local), float(d["aux_local"]),
                               rtol=1e-5)


def train_cfgs(name):
    import dataclasses
    arch, changes, opt8 = R.TRAIN[name]
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **changes)
    return cfg, train.TrainConfig(opt_8bit=opt8, **R.TRAIN_KW)


def state_from(d, prefix, cfg, tc):
    like = train.init_train_state(cfg, None, tc, device="meta")
    return tree_from(d, prefix, like)


def check_params(got, want, mu, p0, lr, wd):
    """tests/test_torch_train.py's rule for parameters after one step."""
    for a, b, m, p in zip(got, want, mu, p0):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        m, p = np.asarray(m, np.float32), np.asarray(p, np.float32)
        clear = np.abs(m) > 1e-3 * np.abs(m).max()
        diff = np.abs(a - b)
        assert (diff[clear] <= lr * 1e-4 + 1e-7 + 2.0 ** -22 * np.abs(
            p[clear])).all()
        assert (diff <= 2 * lr * (1 + wd * np.abs(p)) + 1e-7).all()


@pytest.mark.parametrize("name", list(R.TRAIN))
def test_train_step_matches_reference_mesh(ref, name):
    d = ref[f"train_{name}"]
    cfg, tc = train_cfgs(name)
    before = state_from(d, "before", cfg, tc)
    after = state_from(d, "after", cfg, tc)
    shp = train.init_train_state(cfg, None, tc, device="meta")
    state = interop.placed_from_numpy(
        before, train.state_shardings(cfg, tc, MESH, shp))
    batch = {k: torch.from_numpy(d[k]) for k in ("tokens", "labels")}
    placed = sh.device_put(batch, train.batch_specs(cfg, MESH))
    state, m = train.make_train_step(cfg, tc, MESH)(state, placed)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(d[f"metric_{k}"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), float(d["metric_lr"]),
                               rtol=1e-6)
    got, want = interop.to_numpy(state), after
    assert int(got.opt.step) == int(want.opt.step) == 1
    if tc.opt_8bit:
        for part in ("q_mu", "q_nu"):
            diff = [np.abs(a.astype(np.int32) - b.astype(np.int32))
                    for a, b in zip(leaves(getattr(got.opt, part)),
                                    leaves(getattr(want.opt, part)))]
            assert max(int(x.max()) for x in diff) <= 1, part
            n = sum(x.size for x in diff)
            assert sum(int((x != 0).sum()) for x in diff) <= 1e-2 * n, part
        for part in ("s_mu", "s_nu"):
            for a, b in zip(leaves(getattr(got.opt, part)),
                            leaves(getattr(want.opt, part))):
                assert scale_err(a, b) <= 1e-4, part
        # the reference's first moment, dequantized
        mu = [adamw8._dequantize(torch.from_numpy(q), torch.from_numpy(
            sc)).numpy() for q, sc in zip(leaves(want.opt.q_mu),
                                          leaves(want.opt.s_mu))]
    else:
        for part, tol in (("mu", 1e-4), ("nu", 2e-4)):
            for a, b in zip(leaves(getattr(got.opt, part)),
                            leaves(getattr(want.opt, part))):
                assert scale_err(a, b) <= tol, part
        mu = leaves(want.opt.mu)
    check_params(leaves(got.params), leaves(want.params), mu,
                 leaves(before.params), float(d["metric_lr"]),
                 tc.weight_decay)


@pytest.mark.parametrize("opt_8bit", [False, True])
def test_mesh_step_matches_one_device_step(opt_8bit):
    import dataclasses
    cfg = dataclasses.replace(reduced_config("gemma-2b"), n_layers=2,
                              vocab=512, dtype="float32")
    tc = train.TrainConfig(opt_8bit=opt_8bit, **R.TRAIN_KW)
    batch = {k: torch.from_numpy(v)
             for k, v in R.train_batch(cfg.vocab).items()}
    state = train.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   tc, "cpu")
    p0 = [x.clone() for x in leaves(state.params)]
    shp = train.init_train_state(cfg, None, tc, device="meta")
    placed = sh.device_put(state, train.state_shardings(cfg, tc, MESH, shp))
    one, m1 = train.make_train_step(cfg, tc)(state, batch)
    mesh, m2 = train.make_train_step(cfg, tc, MESH)(placed, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5)
    got = interop.to_numpy(mesh)
    mu = ([adamw8._dequantize(q, sc).numpy() for q, sc in zip(
        leaves(one.opt.q_mu), leaves(one.opt.s_mu))] if opt_8bit else
        [x.numpy() for x in leaves(one.opt.mu)])
    check_params(leaves(got.params), [x.numpy() for x in leaves(one.params)],
                 mu, [x.numpy() for x in p0], float(m1["lr"]),
                 tc.weight_decay)
    # the whole optimizer state agrees too: codes within one step
    for a, b in zip(leaves(got.opt), leaves(interop.to_numpy(one.opt))):
        if a.dtype in (np.int8, np.uint8):
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        else:
            assert scale_err(a, b) <= 2e-4


def test_decode_matches_reference_mesh(ref):
    import dataclasses
    d = ref["decode"]
    cfg = dataclasses.replace(reduced_config("gemma-2b"), n_layers=2,
                              vocab=512, dtype="float32")
    like = tf.init_params(cfg, None, device="meta")
    params = interop.placed_from_numpy(
        tree_from(d, "params", like), serve.params_shardings(cfg, MESH,
                                                             like))
    c_like = tf.init_decode_caches(cfg, R.DECODE_B, R.DECODE_SMAX, "meta")
    caches = sh.device_put(
        tf.init_decode_caches(cfg, R.DECODE_B, R.DECODE_SMAX, "cpu"),
        serve.cache_shardings(cfg, MESH, c_like))
    logits, caches = serve.make_prefill_step(cfg, MESH)(
        params, caches, torch.from_numpy(d["tokens"]))
    assert scale_err(logits.numpy(), d["logits_prefill"]) <= 1e-4

    def check_caches(prefix):
        want = tree_from(d, prefix, c_like)
        for (_, a), (_, b) in zip(sorted_paths(caches), sorted_paths(want)):
            assert scale_err(as_np(a), b) <= 1e-4, prefix

    check_caches("caches_prefill")
    decode = serve.make_decode_step(cfg, MESH)
    for i in range(2):
        logits, caches = decode(params, caches,
                                torch.from_numpy(d["steps"][i]),
                                torch.from_numpy(d[f"pos{i}"]))
        assert scale_err(logits.numpy(), d[f"logits_decode{i}"]) <= 1e-4
        check_caches(f"caches_decode{i}")


def test_compressed_psum_bit_equal(ref):
    d = ref["compress"]
    mesh = sh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                        devices=["cpu"] * 8)
    names = ("a", "b", "c")

    def per_position(prefix):
        return [{k: torch.from_numpy(d[f"{prefix}['{k}']"][
            mesh.coords(p)["pod"]][None].copy()) for k in names}
            for p in range(mesh.size)]

    states = [compress.CompressState(error=e) for e in per_position("e0")]
    for step in range(2):
        red, states = compress.compressed_psum(per_position(f"g{step}"),
                                               states, mesh, "pod")
        for prefix, trees in ((f"red{step}", red),
                              (f"e{step + 1}", [s.error for s in states])):
            for p, tree in enumerate(trees):
                for k in names:
                    want = d[f"{prefix}['{k}']"][mesh.coords(p)["pod"]][None]
                    np.testing.assert_array_equal(
                        tree[k].numpy().view(np.int32), want.view(np.int32))


def test_positions_hold_only_their_blocks():
    x = torch.arange(8 * 16 * 6, dtype=torch.float32).reshape(8, 16, 6)
    for spec in (sh.P("data", "model"), sh.P(("model", "data")),
                 sh.P(None, ("data", "model")), sh.P()):
        s = sh.NamedSharding(MESH, spec)
        placed = sh.device_put(x, s)
        for p, shard in enumerate(placed.shards):
            assert tuple(shard.shape) == s.shard_shape(x.shape)
            assert torch.equal(shard, x[s.block(x.shape, p)])
            assert shard.untyped_storage().data_ptr() != \
                x.untyped_storage().data_ptr()
        assert torch.equal(sh.gather(placed, "cpu"), x)
        box = (slice(3, 7), slice(2, 11), slice(1, 6))
        assert torch.equal(placed.read(box, "cpu"), x[box])
        placed.write(box, -x[box])
        y = x.clone()
        y[box] = -x[box]
        assert torch.equal(placed.read(device="cpu"), y)
    # (model, data): the model index outermost, as in jax
    s = sh.NamedSharding(MESH, sh.P(("model", "data")))
    assert MESH.coords(6) == {"data": 1, "model": 2}
    assert s.block((8,), 6) == (slice(5, 6),)
    with pytest.raises(ValueError, match="not in the mesh"):
        sh.NamedSharding(MESH, sh.P("pod"))
    bytes_held = sh.held_bytes({"x": sh.device_put(x, sh.NamedSharding(
        MESH, sh.P("data", "model")))}, MESH)
    assert bytes_held == [x.numel() * 4 // 8] * 8


def test_collectives_reduce_in_position_order():
    mesh = sh.make_mesh((2, 2, 2), ("pod", "data", "model"),
                        devices=["cpu"] * 8)
    xs = [torch.full((4,), float(p + 1)) for p in range(8)]
    for axis, groups in (("pod", [[0, 4], [1, 5], [2, 6], [3, 7]]),
                         (("data", "model"), [[0, 1, 2, 3], [4, 5, 6, 7]])):
        assert mesh.groups(axis) == groups
        s, m, mean = (sh.psum(xs, mesh, axis), sh.pmax(xs, mesh, axis),
                      sh.pmean(xs, mesh, axis))
        ag = sh.all_gather(xs, mesh, axis)
        rs = sh.reduce_scatter([torch.arange(4.0) * (p + 1)
                                for p in range(8)], mesh, axis)
        for g in groups:
            tot = sum(p + 1 for p in g)
            for k, p in enumerate(g):
                assert torch.equal(s[p], torch.full((4,), float(tot)))
                assert torch.equal(m[p], torch.full((4,), float(max(g) + 1)))
                assert torch.equal(mean[p], torch.full((4,), tot / len(g)))
                assert torch.equal(ag[p], torch.cat([xs[q] for q in g]))
                n = 4 // len(g)
                assert torch.equal(rs[p], (torch.arange(4.0) * tot)[
                    k * n:(k + 1) * n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_lookup_equals_take(dtype):
    g = torch.Generator().manual_seed(0)
    table = torch.randn(300, 16, generator=g).to(dtype)
    toks = torch.randint(0, 300, (3, 7), generator=g)
    for scale in (False, True):
        a = layers.embed_apply(table, toks, scale, mode="onehot")
        b = layers.embed_apply(table, toks, scale, mode="take")
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    cfg = reduced_config("moonshot-v1-16b-a3b")
    assert not cfg.tie_embeddings and tf._embed_mode(cfg) == "take"
    with sh.use_mesh(MESH):
        assert tf._embed_mode(cfg) == "onehot"
        assert tf._embed_mode(reduced_config("gemma-2b")) == "take"


def test_remat_recompute_reenters_the_mesh():
    """A remat "full" MoE group recomputed in a backward run outside the
    forward's mesh context (as autograd's worker thread runs it on the
    card) routes as the forward did: the same gradients as a backward
    inside it."""
    import dataclasses
    cfg = dataclasses.replace(reduced_config("moonshot-v1-16b-a3b"),
                              dtype="float32", remat="full")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v[:2]) for k, v in R.train_batch(
        cfg.vocab).items()}
    row = sh.rows(MESH)[0]
    grads = []
    for inside in (True, False):
        live = tf.tree_map(lambda t: t.detach().requires_grad_(), params)
        with sh.use_mesh(MESH), sh.row_scope(row):
            loss, _ = tf.loss_fn(cfg, live, b)
            if inside:
                grads.append(torch.autograd.grad(loss, tf.tree_leaves(live)))
        if not inside:
            grads.append(torch.autograd.grad(loss, tf.tree_leaves(live)))
    for a, c in zip(*grads):
        assert torch.equal(a, c)
