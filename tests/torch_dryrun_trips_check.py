"""The dry run's fitted counts against the whole step traced once, at
full size on the production mesh (not collected by pytest; minutes of
CPU: the full prefill trace is most of it).

For each cell, every position's FLOPs, HBM bytes, link bytes, argument
bytes and peak bytes (256 positions x 5 fields = 1280 values on 16 x 16)
fitted over the loops' trip counts (``launch.dryrun.TripCounts``) must
equal the full trace's (``trips=False``).  Prints one line per cell
with the count of values that differ and both times.

    PYTHONPATH=src python tests/torch_dryrun_trips_check.py \\
        [--cells gemma-2b:decode_32k,gemma-2b:prefill_32k] [--multi-pod]

``--depth`` instead prints, for each arch at full width, the part of a
train step's HBM bytes that grows as the square of its pattern groups:
one microbatch of 1 x 512 tokens on one device traced at 2, 3 and 4
groups, the second difference of the bytes (and of ``select_backward``'s
alone, the backward of ``transformer._slice``'s ``a[r]``, which writes
a gradient the size of the whole ``[reps, ...]`` stack in every group),
and what the term comes to at the arch's own depth.
"""

import argparse
import json
import sys
import time

from repro_torch.launch import dryrun

FIVE = ("flops", "hbm_bytes", "link_bytes", "argument_bytes", "peak_bytes")


def values(lowered, counts) -> list:
    out = []
    for d in lowered.devices:
        st = counts.stats(d)
        out.append({f: getattr(st, f) for f in FIVE})
    return out


def check(arch: str, shape: str, multi_pod: bool) -> dict:
    lowered, _ = dryrun.lower_cell(arch, shape, multi_pod)
    t0 = time.time()
    fit, record, _ = dryrun.count_step(lowered)
    t_fit = time.time() - t0
    full, _, _ = dryrun.count_step(lowered, trips=False)
    t_full = time.time() - t0 - t_fit
    got, want = values(lowered, fit), values(lowered, full)
    off = [(p, f, got[p][f], want[p][f]) for p in range(len(got))
           for f in FIVE if got[p][f] != want[p][f]]
    return {"cell": f"{arch}:{shape}", "values": len(got) * len(FIVE),
            "off": len(off), "first_off": off[:5],
            "fit_s": round(t_fit, 1), "full_s": round(t_full, 1),
            "variables": record["variables"],
            "busiest_peak_gb": max(w["peak_bytes"] for w in want) / 1e9}


def depth_terms() -> None:
    import dataclasses

    import torch

    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.launch import train

    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        dt = getattr(torch, cfg.dtype)
        total, select = [], []
        for reps in (2, 3, 4):
            c = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern)
                                    * reps)
            specs = {k: ((1, 512), torch.int32) for k in ("tokens",
                                                          "labels")}
            if cfg.frontend == "vit":
                specs["prefix_embeds"] = ((1, cfg.frontend_tokens,
                                           cfg.d_model), dt)
            if cfg.frontend == "audio":
                specs["enc_frames"] = ((1, cfg.enc_seq, cfg.d_model), dt)
            lo = train.lower_train_step(c, train.TrainConfig(n_micro=1),
                                        None, specs)
            counts, _, ops_of = dryrun.count_step(lo, trips=False,
                                                  per_op=True)
            total.append(counts.stats(lo.devices[0]).hbm_bytes)
            select.append(ops_of(lo.devices[0]).get(
                "aten.select_backward", [0, 0, 0])[2])
        d2 = total[2] - 2 * total[1] + total[0]
        s2 = select[2] - 2 * select[1] + select[0]
        r = cfg.pattern_reps
        print(json.dumps({
            "arch": arch, "groups": r,
            "bytes_per_group2_gb": d2 / 2 / 1e9,
            "select_backward_share": s2 / d2 if d2 else 0.0,
            "at_full_depth_gb_per_microbatch": d2 / 2 * r * r / 1e9}),
            flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells",
                    default="gemma-2b:decode_32k,gemma-2b:prefill_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--depth", action="store_true",
                    help="the train step's depth-quadratic HBM term")
    args = ap.parse_args(argv)
    if args.depth:
        depth_terms()
        return 0
    bad = 0
    for cell in args.cells.split(","):
        arch, shape = cell.split(":")
        res = check(arch, shape, args.multi_pod)
        print(json.dumps(res), flush=True)
        bad += res["off"] > 0
    print("ALL EXACT" if not bad else f"{bad} CELLS OFF")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
