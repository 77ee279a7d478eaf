"""The port's mesh layouts against the JAX package's, in process.

The spec functions are pure over shapes, so every leaf must get the same
axis names.  The reference runs on ``jax.sharding.AbstractMesh``, the
port on its abstract ``Mesh`` (``repro_torch.dist.abstract_mesh``), both
at the full configs of all ten archs (shapes only: ``jax.eval_shape``
and the port's trees on the ``meta`` device) on meshes (data 1),
(2, 4), (16, 16) and (2, 16, 16):

* ``train_param_specs`` / ``state_shardings`` under ``TrainConfig`` with
  ``fsdp`` and ``zero1`` on and off and ``opt_8bit`` on and off (AdamW8's
  scales drop the last dim), and the gradient buffer's layout
  (``grad_shardings``: the reference's ``constrain_grads``);
* ``params_shardings``, ``cache_shardings`` for every decode and prefill
  cell of ``configs/shapes.py`` the arch runs (an enc-dec arch's decode
  caches with the cross K/V of ``_xkv_builder``), and ``batch_specs``.

Leaves are compared in the reference's order (dict keys sorted), by
their dict-key path and their spec (trailing ``None`` dropped, a
one-name tuple as the name).  ``spec`` / ``sp_rules`` under ``use_mesh``
and ``sanitize_spec`` / ``zero1_spec`` on hand-made shapes too.
"""

import contextlib
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import cell_is_skipped
from repro.dist import sharding as jsh
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tf

MESHES = {"d1": ((1,), ("data",)), "d2m4": ((2, 4), ("data", "model")),
          "d16m16": ((16, 16), ("data", "model")),
          "p2d16m16": ((2, 16, 16), ("pod", "data", "model"))}

TCFGS = [dict(fsdp=True, zero1=True), dict(fsdp=False, zero1=False),
         dict(fsdp=True, zero1=True, opt_8bit=True),
         dict(fsdp=False, zero1=True, opt_8bit=True)]


def norm(spec):
    """A spec as a plain tuple: one-name tuples as the name, empty
    tuples as None, trailing Nones dropped."""
    out = []
    for p in tuple(spec):
        if isinstance(p, (tuple, list)):
            p = None if not p else (p[0] if len(p) == 1 else tuple(p))
        out.append(p)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def j_items(tree):
    """(dict-key path, spec) of each NamedSharding / PartitionSpec leaf
    in the reference's order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = []
    for path, leaf in flat:
        keys = tuple(p.key for p in path
                     if isinstance(p, jax.tree_util.DictKey))
        out.append((keys, norm(getattr(leaf, "spec", leaf))))
    return out


def t_items(tree):
    def leaf_spec(x):
        return norm(x.spec if isinstance(x, sh.NamedSharding) else x)
    return [(tuple(p for p in path if isinstance(p, str)), leaf_spec(x))
            for path, x in _paths(tree)]


def _paths(tree, path=()):
    """``sorted_paths``, with a ``P`` as a leaf."""
    if isinstance(tree, sh.P) or not isinstance(tree, (dict, tuple, list)):
        yield path, tree
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))


def assert_same(got, want, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for (gp, gs), (wp, ws) in zip(got, want):
        assert gp == wp, (what, gp, wp)
        assert gs == ws, (what, gp, gs, ws)


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), sh.abstract_mesh(shape, axes)


@functools.lru_cache(maxsize=None)
def shapes(arch, opt_8bit):
    """The reference's and the port's train state shapes at full config."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jst = jax.eval_shape(lambda: jtrain.init_train_state(
        jcfg, jax.random.PRNGKey(0), jtrain.TrainConfig(opt_8bit=opt_8bit)))
    st = train.init_train_state(cfg, None,
                                train.TrainConfig(opt_8bit=opt_8bit),
                                device="meta")
    return jst, st


@functools.lru_cache(maxsize=None)
def cache_shapes(arch, batch, seq, xkv):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jc = jax.eval_shape(lambda: jtf.init_decode_caches(jcfg, batch, seq))
    c = tf.init_decode_caches(cfg, batch, seq, device="meta")
    if xkv:
        jc = {**jc, "xkv": jax.eval_shape(jserve._xkv_builder(jcfg, batch))}
        c = {**c, "xkv": serve._xkv_builder(cfg, batch)()}
    return jc, c


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_layouts_match_reference(arch, mesh_name):
    jmesh, mesh = meshes(mesh_name)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    for kw in TCFGS:
        jtc, tc = jtrain.TrainConfig(**kw), train.TrainConfig(**kw)
        jst, st = shapes(arch, tc.opt_8bit)
        assert_same(t_items(train.train_param_specs(cfg, tc, mesh,
                                                    st.params)),
                    j_items(jtrain.train_param_specs(jcfg, jtc, jmesh,
                                                     jst.params)),
                    (arch, mesh_name, kw, "params"))
        assert_same(t_items(train.state_shardings(cfg, tc, mesh, st)),
                    j_items(jtrain.state_shardings(jcfg, jtc, jmesh, jst)),
                    (arch, mesh_name, kw, "state"))
    # the gradient buffer: the reference's constrain_grads layout
    jst, st = shapes(arch, False)
    want = jax.tree_util.tree_map_with_path(
        lambda p, s: jtrain.zero1_spec(jtrain.sanitize_spec(
            jtrain.param_spec(p, s, tied=jcfg.tie_embeddings), s.shape,
            jmesh), s.shape, jmesh), jst.params)
    assert_same(t_items(train.grad_shardings(cfg, mesh, st.params)),
                j_items(want), (arch, mesh_name, "grads"))
    assert_same(t_items(train.batch_specs(cfg, mesh)),
                j_items(jtrain.batch_specs(jcfg, jmesh)),
                (arch, mesh_name, "batch"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serving_layouts_match_reference(arch, mesh_name):
    jmesh, mesh = meshes(mesh_name)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jst, st = shapes(arch, False)
    assert_same(t_items(serve.params_shardings(cfg, mesh, st.params)),
                j_items(jserve.params_shardings(jcfg, jmesh, jst.params)),
                (arch, mesh_name, "serve params"))
    cells = 0
    for name, shp in J_SHAPES.items():
        if shp.kind == "train" or cell_is_skipped(jcfg, name):
            continue
        seq = shp.seq + (jcfg.frontend_tokens if shp.kind == "prefill"
                         and jcfg.frontend == "vit" else 0)
        xkv = shp.kind == "decode" and jcfg.enc_dec
        jc, c = cache_shapes(arch, shp.batch, seq, xkv)
        if "model" not in jmesh.axis_names:
            # the reference's cache_leaf_spec names `model` even where the
            # mesh lacks it (m = 1 divides every dim): both refuse
            with pytest.raises(ValueError, match="model"):
                jserve.cache_shardings(jcfg, jmesh, jc)
            with pytest.raises(ValueError, match="model"):
                serve.cache_shardings(cfg, mesh, c)
            cells += 1
            continue
        assert_same(t_items(serve.cache_shardings(cfg, mesh, c)),
                    j_items(jserve.cache_shardings(jcfg, jmesh, jc)),
                    (arch, mesh_name, name))
        cells += 1
    assert cells >= 2


@contextlib.contextmanager
def j_use_mesh(mesh, rules=None):
    """The reference's ``use_mesh`` context on an abstract mesh (which
    cannot be entered as a ``with`` target): its (mesh, rules) pair set
    for the extent."""
    if rules is None:
        rules = jsh.RULES_3D if "pod" in mesh.axis_names else jsh.RULES_2D
    prev = (jsh._CTX.mesh, jsh._CTX.rules)
    jsh._CTX.mesh, jsh._CTX.rules = mesh, rules
    try:
        yield
    finally:
        jsh._CTX.mesh, jsh._CTX.rules = prev


LOGICAL = [("batch", None, None), ("batch", "seq", "vocab"),
           ("heads", "expert", "model"), ("seq",), ("nope", "batch")]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_spec_matches_reference(mesh_name):
    jmesh, mesh = meshes(mesh_name)
    for sp in (False, True):
        jr = jsh.sp_rules(jsh.RULES_3D if "pod" in jmesh.axis_names
                          else jsh.RULES_2D) if sp else None
        r = sh.sp_rules(sh.RULES_3D if "pod" in mesh.axis_names
                        else sh.RULES_2D) if sp else None
        for logical in LOGICAL:
            with j_use_mesh(jmesh, jr):
                want = jsh.spec(*logical)
            with sh.use_mesh(mesh, r):
                got = sh.spec(*logical)
                assert sh.current_mesh() is mesh
            assert tuple(got) == tuple(want), (logical, sp, got, want)
    assert sh.current_mesh() is None
    assert tuple(sh.spec("batch", None)) == (None, None)
    x = torch.ones(2, 3)
    assert sh.shard(x, "batch") is x and sh.shard_activation_sp(x) is x


SPEC_CASES = [
    (("model", None), (256000, 2048)), ((None, "model"), (2048, 8)),
    ((("model", "data"), None), (64, 16)), ((None, None), (18, 2048)),
    (("data", "model"), (7, 12)), ((None, "model", None), (4, 6, 8)),
    ((), (16,)), ((None,), (3,)), (("model",), (32, 1024)),
]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sanitize_and_zero1_match_reference(mesh_name):
    jmesh, mesh = meshes(mesh_name)
    for spec, shape in SPEC_CASES:
        jsan = jtrain.sanitize_spec(jax.sharding.PartitionSpec(*spec),
                                    shape, jmesh)
        san = train.sanitize_spec(sh.P(*spec), shape, mesh)
        assert norm(san) == norm(jsan), (spec, shape)
        jz = jtrain.zero1_spec(jsan, shape, jmesh)
        z = train.zero1_spec(san, shape, mesh)
        assert norm(z) == norm(jz), (spec, shape)
        assert norm(train.zero1_spec(z, shape, mesh)) == norm(z)


def test_production_meshes_are_abstract():
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert tuple(m.shape.values()) == shape and m.abstract
        with pytest.raises(ValueError, match="abstract"):
            m.devices
    with pytest.raises(ValueError, match="devices"):
        sh.make_mesh((2, 4), ("data", "model"))
