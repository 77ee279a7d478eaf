"""The lane-tick kernel's launch plan, on the CPU.

``repro_torch.kernels.lane_tick.launch_plan`` computes the one launch of a
tick in Python: its CTA roles (control, head tiles, rows, move tiles), their
counts, threads and shared memory, which the kernel takes as dimensions.
At every lane geometry and grid that ``chip_smoke.py`` phase 3 holds the
kernel at (the repair-forcing geometry also at a head tile of 64 slots),
the plan must cover every bucket row and every head and move slot of a
lane exactly once, and no role may ask for more threads or shared memory
than the card gives a block.  The settings are built inside the tests, the
same way phase 3 builds them.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import PRODUCTION, SMALL, PQConfig
from repro_torch.core.factory import EngineSpec, make_engine, resolved_base
from repro_torch.kernels import lane_tick

#: a Hopper block's limits: threads, and shared memory past the opt-in
MAX_BLOCK_THREADS = 1024
MAX_BLOCK_SMEM = 232_448

_REPAIR = PQConfig(a_max=64, r_max=64, seq_cap=512, n_buckets=4,
                   bucket_cap=8, detach_min=4, detach_max=64, detach_init=8,
                   chop_patience=3, backend="torch")

#: phase 3's settings: name -> (lanes, head tile or None for the default)
_SETTINGS = {
    "repair_L1": (1, None), "repair_L4": (4, None),
    "repair_L1_tile64": (1, 64), "repair_L4_tile64": (4, 64),
    "duplicates_L1_tile64": (1, 64), "duplicates_L3_tile64": (3, 64),
    "w4096_L1": (1, None), "w4096_L8": (8, None),
    "production_L1": (1, None),
    "sharded_w4096_L8": (8, None), "sharded_w4096_L4": (4, None),
    "sharded_production_L8": (8, None), "sharded_production_L4": (4, None),
    "adaptive_fold_L8": (8, None), "adaptive_fold_L1": (1, None),
    "dist_kill_L4": (4, None),
    "serve64_L2": (2, None), "serve64_L2_spare": (2, None),
    "serve1024_L4": (4, None), "serve1024_L4_spare": (4, None),
    "sampler_default_L1": (1, None), "event_sim_L1": (1, None),
    "quickstart_L1": (1, None), "dev_check_small_L1": (1, None),
    "dev_check_tiny_L1": (1, None), "quickstart_sharded_L4": (4, None),
    "serve_example_L4": (4, None), "mesh_example_spare_L2": (2, None),
    "sampler_production_L1": (1, None),
}


def _serving_lane(**kw):
    from repro_torch import serving
    return serving.build_engine(device="cpu", backend="torch",
                                **kw).queue.queue.cfg.shard.lane


@functools.lru_cache(maxsize=None)
def _lane_cfg(name):
    """The lane config of phase-3 setting ``name``."""
    if name.startswith(("repair", "duplicates")):
        return _REPAIR
    if name.startswith("w4096"):
        return resolved_base(EngineSpec(engine="pqe", width=4096,
                                        backend="torch"))
    if name.startswith(("production", "sampler_production")):
        return dataclasses.replace(PRODUCTION, backend="torch")
    if name.startswith("sharded_w4096"):
        spec = EngineSpec(engine="sharded", width=4096, lanes=8,
                          backend="torch")
    elif name.startswith("sharded_production"):
        spec = EngineSpec(engine="sharded", width=1024, lanes=8,
                          base=PRODUCTION, backend="torch")
    elif name.startswith("adaptive_fold"):
        spec = EngineSpec(engine="sharded", width=4096, lanes=8,
                          min_lanes=1, backend="torch")
    elif name == "quickstart_sharded_L4":
        spec = EngineSpec(engine="sharded", width=64, lanes=4,
                          backend="torch")
    elif name == "dist_kill_L4":
        return make_engine(EngineSpec(
            engine="dist", width=4096, lanes=8, n_devices=2,
            lanes_per_device=4, spare_devices=1, backend="torch"),
            device="cpu").cfg.shard.lane
    elif name.startswith("serve64"):
        return _serving_lane(n_devices=2, width=64, lanes_per_device=2,
                             n_slots=8, spare_devices=int("spare" in name))
    elif name.startswith("serve1024"):
        return _serving_lane(n_devices=2, width=1024, lanes_per_device=4,
                             n_slots=128, spare_devices=int("spare" in name))
    elif name == "serve_example_L4":
        return _serving_lane(n_devices=1, lanes_per_device=4, width=64,
                             n_slots=8)
    elif name == "mesh_example_spare_L2":
        return _serving_lane(n_devices=2, lanes_per_device=2, width=128,
                             n_slots=32, spare_devices=1, preroute="on")
    else:
        from repro_torch.data.priority_sampler import DEFAULT_CFG
        from repro_torch.examples import dev_check_pq, event_sim, quickstart
        return dataclasses.replace({
            "sampler_default_L1": DEFAULT_CFG,
            "event_sim_L1": event_sim.CFG,
            "quickstart_L1": quickstart.BASE,
            "dev_check_small_L1": SMALL,
            "dev_check_tiny_L1": dev_check_pq.TINY}[name], backend="torch")
    return make_engine(spec, device="cpu").cfg.lane


def _plan(name):
    lanes, tile = _SETTINGS[name]
    cfg = _lane_cfg(name)
    return cfg, lane_tick.launch_plan(cfg, lanes, tile or lane_tick.HEAD_TILE)


def _covered_once(ranges, n):
    hits = np.zeros(n, np.int64)
    for r in ranges:
        hits[r.start:r.stop] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("name", sorted(_SETTINGS))
def test_plan_covers_every_row_and_slot_once(name):
    cfg, plan = _plan(name)
    slots = cfg.r_max + cfg.seq_cap
    assert _covered_once(plan.cover("rows", cfg.n_buckets), cfg.n_buckets)
    assert _covered_once(plan.cover("head", slots), slots)
    assert _covered_once(plan.cover("move", slots), slots)
    assert plan.role("control").ctas_per_lane == 1
    assert plan.grid == plan.lanes * sum(r.ctas_per_lane for r in plan.roles)
    # the order the kernel decodes tickets in, and the dims it reads
    assert tuple(r.name for r in plan.roles) == lane_tick.ROLES
    assert len(plan.dims()) == 16


@pytest.mark.parametrize("name", sorted(_SETTINGS))
def test_plan_fits_a_block_of_the_card(name):
    cfg, plan = _plan(name)
    assert plan.block_threads <= lane_tick.MAX_THREADS <= MAX_BLOCK_THREADS
    assert plan.smem_bytes <= MAX_BLOCK_SMEM
    for role in plan.roles:
        assert 32 <= role.threads <= plan.block_threads, role
        assert role.threads % 32 == 0, role
        assert role.smem_bytes <= plan.smem_bytes, role
    # the rows role: a warp a row up to WARP_ROW_MAX slots, within its CTA
    rows = plan.role("rows")
    if cfg.bucket_cap <= lane_tick.WARP_ROW_MAX:
        assert rows.threads <= 32 * rows.width
    # a grid the card holds at two CTAs an SM takes the two-CTA build
    assert plan.min_blocks == (2 if plan.grid <= lane_tick.RESIDENT_AT_TWO
                               else 4)


def test_plan_scales_rows_with_lanes_and_sizes_head_to_the_batch():
    """More lanes put more rows in each rows CTA; a narrow batch gets a
    narrow control role; a test override of the rows per CTA outgrows
    the card's resident CTAs at sharded PRODUCTION."""
    cfg = _lane_cfg("sharded_production_L8")
    p4 = lane_tick.launch_plan(cfg, 4)
    p8 = lane_tick.launch_plan(cfg, 8)
    assert p8.role("rows").width >= p4.role("rows").width
    assert p8.role("rows").ctas_per_lane * 8 <= lane_tick.WARP_ROW_CTAS
    prod = lane_tick.launch_plan(_lane_cfg("production_L1"), 1)
    assert prod.role("rows").ctas_per_lane <= lane_tick.CTA_ROW_CTAS
    tiny = lane_tick.launch_plan(_lane_cfg("serve64_L2"), 2)
    assert tiny.role("control").threads == 32
    wide = lane_tick.launch_plan(cfg, 8, rows_per_cta=1)
    assert wide.role("rows").ctas_per_lane == cfg.n_buckets
    assert wide.grid > 132 * 4


def test_role_spans_read_a_trace():
    """role_spans: each role's CTAs and spans from a traced launch."""
    t = torch.zeros((3, lane_tick.TRACE_WORDS), dtype=torch.int64)
    t[0, :4] = torch.tensor([0, 1000, 1000, 5000])       # control, lane 0
    t[0, 4:7] = torch.tensor([2000, 3000, 4000])
    t[1, :4] = torch.tensor([(2 << 32) | 0, 1100, 5200, 7000])   # rows
    t[2, :4] = torch.tensor([(3 << 32) | 0, 1200, 7100, 8000])   # move
    spans = lane_tick.role_spans(t)
    assert spans["launch"] == pytest.approx(7.0)
    assert spans["rows"] == dict(ctas=1, span_us=pytest.approx(5.9),
                                 work_us=pytest.approx(1.8))
    assert spans["move"]["work_us"] == pytest.approx(0.9)
    assert spans["control"]["milestones_us"] == pytest.approx(
        [1.0, 2.0, 3.0, 4.0])
    assert "head" not in spans


def test_counter_workspace_is_kept_per_stream_and_lanes():
    a = lane_tick.counter_workspace("cpu", 7, 4)
    assert a.dtype == torch.int32 and a.shape == (10,) and not a.any()
    assert lane_tick.counter_workspace("cpu", 7, 4) is a
    assert lane_tick.counter_workspace("cpu", 8, 4) is not a
    assert lane_tick.counter_workspace("cpu", 7, 2).shape == (6,)
