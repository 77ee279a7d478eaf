"""The port's model configs and roofline against the JAX package's.

* Every arch's ``ArchConfig`` (fields, ``param_count``,
  ``active_param_count``) and ``reduced_config`` equal the reference's;
  ``input_specs`` give the reference's shapes with torch dtypes.
* ``model_flops`` for every arch and shape kind equals the reference's.
* ``Roofline`` terms and dominance on the reference test's inputs,
  against the H100 peaks of ``hw``.
* ``traffic``'s count of a pqe, sharded and dist tick at W=64 equals a
  count worked out here from the state's own leaves, and does not depend
  on the kernel backend; the kernel-op counts match the op's own buffers.
* ``record_from_traffic`` fills the reference record's fields.

The card-only checks (``hw.hbm_bytes``, a lane-tick launch against its
traffic bound) are in tests/test_torch_cuda_kernel.py.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs import shapes as jshapes
from repro.roofline import measure as jmeasure
from repro.roofline.analysis import model_flops as j_model_flops
from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.configs import shapes
from repro_torch.core import pqueue
from repro_torch.core.factory import EngineSpec, make_engine
from repro_torch.kernels import ops
from repro_torch.roofline import Roofline, hw, model_flops, traffic
from repro_torch.roofline.measure import record_from_traffic

W = 64


def _facts(cfg):
    return (dataclasses.asdict(cfg), cfg.param_count(),
            cfg.active_param_count(), cfg.vocab_padded, cfg.pattern_reps)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_arch_configs_match_reference(arch):
    assert ALL_ARCHS == J_ARCHS
    assert _facts(get_config(arch)) == _facts(j_get_config(arch))
    assert _facts(reduced_config(arch)) == _facts(j_reduced_config(arch))


def test_unknown_arch_raises_as_reference():
    for fn in (get_config, j_get_config):
        with pytest.raises(KeyError, match="unknown arch"):
            fn("no-such-arch")


@pytest.mark.parametrize("arch", J_ARCHS)
def test_model_flops_and_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for kind in ("train", "prefill", "decode"):
        for tokens in (1, 4096, 1 << 20):
            assert model_flops(cfg, kind, tokens) == j_model_flops(
                jcfg, kind, tokens)
    for name in shapes.SHAPES:
        assert shapes.SHAPES[name].__dict__ == jshapes.SHAPES[name].__dict__
        if jshapes.cell_is_skipped(jcfg, name):
            assert shapes.cell_is_skipped(cfg, name)
            with pytest.raises(ValueError):
                shapes.input_specs(cfg, name)
            continue
        got, want = shapes.input_specs(cfg, name), jshapes.input_specs(
            jcfg, name)
        assert got.keys() == want.keys()
        for k, (shape, dtype) in got.items():
            assert shape == want[k].shape
            assert str(dtype).replace("torch.", "") == str(
                jnp.dtype(want[k].dtype))


def test_roofline_terms_and_dominance():
    """The reference test's inputs, against the H100's peaks."""
    r = Roofline.from_measurements(197e12, 10e9, 1e9)
    assert r.compute_s == pytest.approx(197e12 / hw.PEAK_FLOPS)
    assert r.memory_s == pytest.approx(10e9 / hw.HBM_BW)
    assert r.collective_s == pytest.approx(1e9 / hw.ICI_BW)
    assert r.dominant == "compute"
    r2 = Roofline.from_measurements(1e12, 819e9 * 2, 1e9)
    assert r2.dominant == "memory"
    assert r2.bound_step_time() == pytest.approx(819e9 * 2 / hw.HBM_BW)
    r3 = Roofline.from_measurements(1e12, 1e9, 50e9 * 3)
    assert r3.dominant == "collective"
    assert r3.mfu(1e12) == pytest.approx(
        1e12 / (r3.bound_step_time() * hw.PEAK_FLOPS))
    assert (hw.PEAK_FLOPS, hw.HBM_BW, hw.ICI_BW) == (989e12, 3.35e12,
                                                       450e9)


def _nbytes(tree):
    return sum(x.numel() * x.element_size() for x in pqueue.tree_leaves(tree))


def _tick_count(state, width, out_w):
    """State in and out, the [width] batch and its removeMin count in,
    the [out_w] removal stream (keys, vals, served) out."""
    return 2 * _nbytes(state) + width * 9 + 4 + out_w * 9


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_tick_traffic_counts_the_state_leaves(backend):
    def engine(**spec):
        return make_engine(EngineSpec(width=W, backend="torch", **spec),
                           device="cpu")

    pqe = engine(engine="pqe")
    sharded = engine(engine="sharded", lanes=4)
    dist = engine(engine="dist", lanes=4, n_devices=2)
    k = np.arange(W, dtype=np.float32)
    out = []
    for eng, count in (
            (pqe, traffic.pqe_tick(dataclasses.replace(pqe.cfg,
                                                       backend=backend))),
            (sharded, traffic.sharded_tick(dataclasses.replace(
                sharded.cfg, lane=dataclasses.replace(sharded.cfg.lane,
                                                      backend=backend)))),
            (dist, traffic.dist_tick(dist.cfg))):
        state = eng.init(seed=0)
        state, res = eng.tick(state, k, k.astype(np.int32),
                              np.ones(W, bool), 8)
        out_w = res.rm_keys.shape[0]
        assert count.hbm_bytes == _tick_count(state, W, out_w)
        out.append(count)
    # the mesh moves the sharded tick's bytes, plus the all-gather of its
    # L lane heads and sizes
    assert out[2].hbm_bytes == out[1].hbm_bytes
    assert out[2].link_bytes == 4 * 8 and out[0].link_bytes == 0
    assert out[1].bound_s() == out[1].hbm_bytes / hw.HBM_BW


def test_kernel_traffic_counts_buffers():
    """K3's count is what the lanes' hot ticks touch with the state
    updated in place: the batches and grants, the removal streams and
    counts, the scalar leaves and bucket counts in and out, the
    splitters in, and 8 bytes for each add stored, each removal taken
    and twice each slot detached — a full tick by default, far under
    the lanes' state in and out, and the same under either backend.
    K2, K1 and K4 count their operands and results once."""
    lane = make_engine(EngineSpec(engine="sharded", width=W, lanes=4,
                                  backend="torch"), device="cpu").cfg.lane
    one = pqueue.init(lane, "cpu")
    state = _nbytes(one)
    scalars = sum(x.nbytes for x in pqueue.tree_leaves(one) if x.dim() == 0)
    per_lane = (lane.a_max * 9 + 4 + lane.r_max * 8 + 4 + 2 * scalars
                + 2 * one.bcounts.nbytes + one.splitters.nbytes)
    full = 4 * (per_lane + 8 * (lane.a_max + lane.r_max
                                + 2 * min(lane.seq_cap, lane.move_k_max)))
    assert traffic.k3_launch(lane, 4).hbm_bytes == full < 2 * 4 * state
    assert traffic.k3_launch(lane, 4, adds=0, removals=0,
                             detached=0).hbm_bytes == 4 * per_lane
    assert traffic.k3_launch(lane, 4, adds=10, removals=3,
                             detached=5).hbm_bytes == 4 * per_lane + 8 * 23
    assert traffic.k3_launch(dataclasses.replace(lane, backend="cuda"),
                             4) == traffic.k3_launch(lane, 4)
    assert traffic.lane_state_bytes(lane) == state
    kvf = 3 * 4
    assert traffic.k2_sort(4, 16).hbm_bytes == 2 * 4 * 16 * kvf
    assert traffic.k1_merge(8, 1026, 512).hbm_bytes == 2 * 8 * 1538 * kvf
    keys = torch.rand(1, 4096)
    tau, n_below = ops.select_threshold(keys, torch.tensor([7]),
                                        backend=ops.TORCH)
    assert traffic.k4_select(1, 4096).hbm_bytes == (
        keys.nbytes + 4 + tau.numel() * 4 + n_below.numel() * 4)


def test_record_from_traffic_has_the_reference_fields():
    count = traffic.Traffic(3_350_000, 450)
    rec = record_from_traffic(count, 0.002, 2, torch.zeros(1))
    want = jmeasure.record_from_stats(types.SimpleNamespace(
        flops=1.0, hbm_bytes=8.0, hbm_bytes_adj=0.0, coll_total=0.0), 1e-3)
    assert want.keys() <= rec.keys()
    assert rec["device"] == "cpu" and rec["peak_ref"] == "h100_sxm"
    assert rec["flops"] is None and rec["n_ticks"] == 2
    assert rec["hbm_bytes"] == 2 * 3_350_000
    assert rec["collective_bytes"] == 900
    assert rec["bound"] == "memory"
    assert rec["frac_peak_bw"] == pytest.approx(
        2 * 3_350_000 / 0.002 / 3.35e12)
    assert rec["frac_bound"] == pytest.approx(2e-6 / 0.002)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serving_traffic_counts_the_parameter_tree(arch):
    """A serving step's count (``traffic.model_prefill`` /
    ``model_decode``) reads every weight of the parameter tree once (an
    untied embedding table only at its gathered rows, an MoE decode at
    top_k experts), and ``model_step_flops`` stays under the reference's
    2·N·D for a prefill."""
    from repro_torch.models import transformer as tf
    cfg = reduced_config(arch)
    tree = tf.init_params(cfg, None, "meta")
    item = 2                                       # the bf16 table
    every = sum(t.numel() * t.element_size() for t in tf.tree_leaves(tree))
    table = cfg.vocab_padded * cfg.d_model * item
    rows = 3 * 40
    want = every - (0 if cfg.tie_embeddings else table - rows
                    * cfg.d_model * item)
    assert traffic.weight_bytes(cfg, rows) == want
    pre = traffic.model_prefill(cfg, 3, 40).hbm_bytes
    assert pre > want + 3 * cfg.vocab_padded * 4
    dec = traffic.model_decode(cfg, 3, 3 * 41).hbm_bytes
    if cfg.family == "moe":
        experts = sum(t.numel() * t.element_size() for k, t in
                      tree["stack"]["p0"]["moe"].items() if k != "router")
        assert traffic.weight_bytes(cfg, 3, cfg.top_k) == (
            traffic.weight_bytes(cfg, 3) - experts
            + experts * cfg.top_k // cfg.n_experts)
    else:
        assert dec > traffic.weight_bytes(cfg, 3)
    flops = traffic.model_step_flops(cfg, 120, 3)
    assert 0 < flops < model_flops(cfg, "prefill", 120)
    assert traffic.model_bound_s(traffic.Traffic(pre), flops) == max(
        pre / hw.HBM_BW, flops / hw.PEAK_FLOPS)


def test_serving_traffic_at_gemma_2b():
    """gemma-2b as published: 5.01 GB of bf16 weights read a decode step
    (1.50 ms at 3.35 TB/s with four rows' caches), a 4 x 512 prefill
    2·(N - V·d)·D + 2·V·d·4 FLOPs."""
    cfg = get_config("gemma-2b")
    n = cfg.param_count() + cfg.d_model           # + the final norm
    assert traffic.weight_bytes(cfg, 4) == 2 * n
    dec = traffic.model_decode(cfg, 4, 4 * 544)
    assert 1.50e-3 < dec.bound_s() < 1.51e-3
    vd = cfg.vocab_padded * cfg.d_model
    layers = cfg.n_layers * (cfg._attn_params() + cfg._ffn_params())
    assert traffic.model_step_flops(cfg, 2048, 4) == 2.0 * (
        layers * 2048 + vd * 4)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_traffic_counts_passes_and_optimizer_state(arch):
    """A train step's count (``traffic.model_train``): the FLOPs are the
    forward's products times 3, times 4 under remat; each microbatch adds
    a weight read per pass, the gradients and the float32 accumulator;
    the 8-bit moments save 16 - 4·(1 + 4/256) bytes a parameter, read
    and written."""
    from repro_torch.models import transformer as tf
    cfg = reduced_config(arch)
    b, s = 4, 32
    t1, f1 = traffic.model_train(cfg, b, s, 1, False, False)
    t4, f4 = traffic.model_train(cfg, b, s, 4, False, False)
    r4, fr = traffic.model_train(cfg, b, s, 4, True, False)
    e4, fe = traffic.model_train(cfg, b, s, 4, False, True)
    assert f1 == f4 == fe == 3 * traffic.model_step_flops(cfg, b * s, b * s)
    assert fr == 4 * f4 / 3
    tree = tf.init_params(cfg, None, "meta")
    count = sum(t.numel() for t in tf.tree_leaves(tree))
    pbytes = sum(t.numel() * t.element_size() for t in tf.tree_leaves(tree))
    assert r4.hbm_bytes - t4.hbm_bytes == 4 * traffic.weight_bytes(cfg, s)
    assert abs(t4.hbm_bytes - e4.hbm_bytes
               - (16 - 4 * (1 + 4 / 256)) * count) <= 1
    assert t4.hbm_bytes - t1.hbm_bytes == (
        4 * (2 * traffic.weight_bytes(cfg, s) + 2 * pbytes + 8 * count)
        - (2 * traffic.weight_bytes(cfg, b * s) + 2 * pbytes + 8 * count))


def test_train_traffic_at_gemma_2b():
    """gemma-2b (tied, dense): the products' FLOPs equal the reference's
    6·N·D within 1e-4 (N counts the norms, which are no products; where
    they part elsewhere, 6·N·D counts an untied table's lookup and an
    encoder as products, and a shared block once); a 4 x 512 step in
    4 microbatches moves at least 220 GB (AdamW) or 191 GB (AdamW8),
    more than its FLOPs take at the bf16 peak."""
    cfg = get_config("gemma-2b")
    t, f = traffic.model_train(cfg, 4, 512, 4, False, False)
    assert f == pytest.approx(model_flops(cfg, "train", 2048), rel=1e-4)
    assert 220e9 < t.hbm_bytes < 221e9
    t8, _ = traffic.model_train(cfg, 4, 512, 4, False, True)
    assert 190e9 < t8.hbm_bytes < 191e9
    assert traffic.model_bound_s(t, f) == t.hbm_bytes / hw.HBM_BW
