"""Serving driver: open-loop request traffic through the overload-robust
engine (repro_torch.serving) on the mesh queue (port of the JAX package's
``examples/serve_requests.py``).

Part 1 — one position: seeded Poisson arrivals with deadline SLAs flow
through admission control (depth cap + EDF feasibility shedding + bounded
retry) into the elastic queue; the SLA report accounts every request to
exactly one of served / shed / expired and prints time-to-serve
quantiles, steady state vs overload.

Part 2 — mesh dispatch: the same engine over a list of positions (two
positions may share one card).  Each tick admits a wave and serves the
near-minimal deadlines into free worker slots.  Urgent SLA-0 requests
dispatch via the pre-route elimination pass — asserted ≤ 1 tick from
admission.  With a chaos spec (``chaos=`` or ``PQ_CHAOS``, e.g.
``kill:1@8`` or ``seed:7``; see repro_torch.ft.inject.parse_chaos) and
more than one position, the schedule's kills declare positions dead
mid-serving: lanes drain-and-remap over the survivors and the final
served/shed/expired partition proves zero requests were lost or
duplicated.

    PYTHONPATH=src python -m repro_torch.examples.serve_requests
    PYTHONPATH=src python -m repro_torch.examples.serve_requests \\
        --mesh cuda:0 cuda:0 --chaos kill:1@8
    PYTHONPATH=src python -m repro_torch.examples.serve_requests \\
        --device cpu --backend torch --mesh cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.ft import parse_chaos
from repro_torch.serving import Request, build_engine, run_sla


def _print_report(tag: str, rep: dict) -> None:
    print(f"{tag}: {rep['arrivals']} arrivals -> {rep['served']} served / "
          f"{rep['shed']} shed / {rep['expired']} expired "
          f"(sheds: {rep['shed_reasons']})")
    print(f"  time-to-serve ticks p50 {rep['p50']:.1f}  "
          f"p99 {rep['p99']:.1f}  p99.9 {rep['p999']:.1f}   "
          f"max depth {rep['max_depth']}/{rep['depth_cap']}")


def main(device="cuda", backend: Optional[str] = None) -> dict:
    """Part 1 on ``device``; ``backend`` None keeps the lanes' "cuda"
    (a CPU device needs "torch").  Returns {tag: report}."""
    print("single-device engine: admission control + load shedding")
    reports = {}
    for tag, rho in (("steady  rho=0.7", 0.7), ("overload rho=1.5", 1.5)):
        eng = build_engine(rho=rho, n_slots=8, seed=0, depth_cap=48,
                           pattern="poisson", device=device, backend=backend)
        rep = run_sla(eng, 300)
        _print_report(tag, rep)
        assert rep["served"] + rep["shed"] + rep["expired"] == \
            rep["arrivals"], "outcome partition broken"
        assert rep["max_depth"] <= 48, "admission cap violated"
        reports[tag] = rep
    print("  (overload sheds explicitly at admission; depth stays capped)")
    return reports


def main_mesh(mesh: Optional[Sequence] = None, *, chaos: Optional[str] = None,
              device="cuda", backend: Optional[str] = None) -> dict:
    """Fleet-scale dispatch, chaos-tolerant, over ``mesh`` (a list of
    devices, one per position; default ``[device]``).  ``chaos`` None
    reads ``PQ_CHAOS``; a single position runs without a schedule."""
    mesh = list(mesh) if mesh is not None else [device]
    n_devices = len(mesh)
    schedule = parse_chaos(chaos, n_devices=n_devices) \
        if n_devices > 1 else None
    n_kill = sum(1 for e in schedule.events if e.kind == "kill") \
        if schedule is not None else 0
    eng = build_engine(
        n_devices=n_devices, lanes_per_device=2, width=128, rho=0.9,
        n_slots=32, seed=0, schedule=schedule,
        spare_devices=min(n_kill, n_devices - 1), depth_cap=192,
        sla_mean=50.0, sla_min=20.0, preroute="on", device=device,
        mesh=mesh, backend=backend)
    print(f"\nmesh dispatch: {n_devices} position(s) x 2 lanes, wave width "
          f"{eng.width}, {eng.n_slots} worker slots/tick"
          + (f", chaos schedule with {n_kill} kill(s)" if n_kill else ""))

    # urgent SLA-0 probes ride along every 4th wave; measure dispatch
    # latency in ENGINE TICKS (the clock also absorbs fault burns)
    urgent_submit = {}     # rid -> tick submitted
    urgent_latency = []
    removed = []
    for step in range(24):
        wave = eng.arrivals.wave()
        if step % 4 == 0:
            rid = 10_000_000 + step
            now = eng.clock.now
            wave.append(Request(rid=rid, arrival=now,
                                deadline=now + eng.policy.tick_dt))
            urgent_submit[rid] = eng.n_ticks
        info = eng.tick(wave=wave)
        removed += info["removed"]
        for rid in list(urgent_submit):
            if rid in info["served_rids"]:
                urgent_latency.append(eng.n_ticks - 1 - urgent_submit.pop(rid))
    if removed:
        print(f"chaos: position(s) {removed} died mid-serving; lanes "
              f"re-sharded over {len(eng.queue.live)} survivors")
    rep = run_sla(eng, 0)   # drain + flush: exact partition
    _print_report("mesh", rep)

    # zero lost or duplicated requests across the resize: duplicates
    # raise inside the engine; losses would break this partition
    assert rep["served"] + rep["shed"] + rep["expired"] == rep["arrivals"]
    assert rep["in_flight"] == 0 and rep["retry_pending"] == 0
    if n_kill and n_devices > 1:
        assert len(removed) == n_kill, "scheduled kill never fired"
    # urgent SLA-0 requests dispatch within one tick of admission (the
    # pre-route elimination path: matched to a slot before routing)
    assert not urgent_submit, f"urgent requests stuck: {urgent_submit}"
    assert max(urgent_latency) <= 1, urgent_latency
    print(f"urgent dispatch latency (ticks): {urgent_latency}")
    st = eng.queue_stats()
    print(f"pre-route eliminations (never routed): "
          f"{int(st.n_preroute_elim)} over {int(st.n_ticks)} ticks")
    print(f"queue depth at exit: {int(st.depth)} (drained)")
    return dict(report=rep, removed=removed, n_kill=n_kill,
                urgent_latency=urgent_latency,
                n_preroute_elim=int(st.n_preroute_elim),
                n_ticks=int(st.n_ticks), depth=int(st.depth))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("cuda", "torch"))
    ap.add_argument("--mesh", nargs="+", default=None,
                    help="one device per position (default: --device)")
    ap.add_argument("--chaos", default=None,
                    help="a chaos spec (default: $PQ_CHAOS)")
    a = ap.parse_args()
    main(a.device, a.backend)
    main_mesh(a.mesh, chaos=a.chaos, device=a.device, backend=a.backend)
