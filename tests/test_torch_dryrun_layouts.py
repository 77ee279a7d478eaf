"""What each mesh position of a production cell holds, the port's dry run
against the JAX package's layouts, at full configs on the CPU.

The port places a cell's arguments on fake devices, one ``cpu:{p}`` a
position (``launch.dryrun.lower_cell``; placement only, no step is
run), and its counter (``roofline.trace_stats.TraceStats``) gives each
position's argument bytes.  The reference's are the bytes of
``NamedSharding(AbstractMesh, spec).shard_shape(leaf.shape)`` summed
over the same cell's trees from ``jax.eval_shape``: the train state and
the batch under ``state_shardings`` / ``batch_specs``, or the
parameters, caches (an enc-dec arch's with the cross K/V) and the token
and position under ``params_shardings`` / ``cache_shardings``.  Every
position must hold exactly that, byte for byte: each arch at
``train_4k`` and ``decode_32k`` on 16 × 16 (xlstm-350m and zamba2-2.7b
also at ``long_500k``), gemma-2b on 2 × 16 × 16.
"""

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.configs.shapes import input_specs as j_input_specs
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro_torch.configs import ALL_ARCHS
from repro_torch.launch import dryrun
from repro_torch.roofline.trace_stats import TraceStats
from torch_train_ref import one_torch_thread  # noqa: F401

CELLS = ([(a, "train_4k", False) for a in ALL_ARCHS]
         + [(a, "decode_32k", False) for a in ALL_ARCHS]
         + [(a, "long_500k", False) for a in ("xlstm-350m", "zamba2-2.7b")]
         + [("gemma-2b", "train_4k", True), ("gemma-2b", "decode_32k", True)])


def shard_bytes(tree, shardings) -> int:
    total = 0
    for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))):
        total += int(np.prod(sh.shard_shape(leaf.shape))) * \
            np.dtype(leaf.dtype).itemsize
    return total


def reference_bytes(arch, shape, multi_pod) -> int:
    """One position's bytes of the cell's arguments in the reference."""
    cfg, spec = j_get_config(arch), J_SHAPES[shape]
    mesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                        ("pod", "data", "model") if multi_pod
                        else ("data", "model"))
    specs = j_input_specs(cfg, shape)
    if spec.kind == "train":
        tcfg = jtrain.TrainConfig()
        st = jax.eval_shape(lambda: jtrain.init_train_state(
            cfg, jax.random.PRNGKey(0), tcfg))
        b_sh = jtrain.batch_specs(cfg, mesh)
        return (shard_bytes(st, jtrain.state_shardings(cfg, tcfg, mesh, st))
                + sum(shard_bytes(v, b_sh[k]) for k, v in specs.items()))
    params = jax.eval_shape(lambda: jtf.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    caches = jax.eval_shape(lambda: jtf.init_decode_caches(
        cfg, spec.batch, spec.seq))
    if cfg.enc_dec:
        caches = {**caches, "xkv": jax.eval_shape(
            jserve._xkv_builder(cfg, spec.batch))}
    bax = ("pod", "data") if multi_pod else "data"
    t_sh = NamedSharding(mesh, jtrain.sanitize_spec(
        JP(bax, None), specs["token"].shape, mesh))
    pos_sh = NamedSharding(mesh, jtrain.sanitize_spec(
        JP(bax), specs["pos"].shape, mesh))
    return (shard_bytes(params, jserve.params_shardings(cfg, mesh, params))
            + shard_bytes(caches, jserve.cache_shardings(cfg, mesh, caches))
            + shard_bytes(specs["token"], t_sh)
            + shard_bytes(specs["pos"], pos_sh))


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_position_bytes_match_reference(arch, shape, multi_pod):
    lowered, _ = dryrun.lower_cell(arch, shape, multi_pod)
    held = TraceStats((lowered.args, lowered.kwargs))
    got = {held.stats(d).argument_bytes for d in lowered.devices}
    assert len(lowered.devices) == (512 if multi_pod else 256)
    assert got == {reference_bytes(arch, shape, multi_pod)}
