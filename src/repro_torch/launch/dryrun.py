"""The dry run: trace every (arch × shape × mesh) cell of the model stack
on fake devices and count what each mesh position computes, moves and
holds (port of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads ``memory_analysis()`` and the HLO.  The port places
the production mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) on
fake devices, one a position (``launch.mesh.fake_mesh``),
builds the step's arguments there by the ported layouts under
``FakeTensorMode`` (nothing is allocated), and runs the step once under
``roofline.trace_stats.TraceStats``.  No ``XLA_FLAGS`` set-up comes
first: a fake device is a name, so there is no device count to fix
before the first import.

Usage (one cell per process; ``repro_torch.examples.dryrun_sweep`` runs
them all):

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gemma-2b --shape decode_32k [--multi-pod] \\
        [--out artifacts/dryrun] [--save-trace] [--hbm-bytes N]

The artifact has the reference's keys (``memory``, ``cost``,
``collectives``, ``roofline``, ``timing``; ``timing`` holds ``lower_s``
and ``trace_s`` for the reference's ``compile_s``) plus ``by_position``.
The port's positions are not alike: a data row's dense compute runs on
its first position's device.  So each per-device figure is the busiest
position's (never a total over the chips), and ``by_position`` gives
the min, the max, the arg-max position and the sum over positions of
FLOPs, HBM bytes, link bytes and peak bytes.

* ``memory``: ``argument_size_in_bytes`` (the state or parameters,
  caches and inputs a position holds), ``output_size_in_bytes``,
  ``alias_size_in_bytes`` (outputs that are arguments updated in place,
  what the reference donates), ``temp_size_in_bytes`` = peak -
  arguments, ``per_device_total`` = the peak (the port updates in
  place, so no alias is subtracted), ``fits_hbm`` against one card's
  memory (``hw.hbm_bytes()`` where a card is visible, else
  ``--hbm-bytes``), all of the position with the highest peak.
* ``cost``: ``flops``; ``bytes_accessed`` and ``bytes_accessed_upper``
  are both the counter's HBM bytes (an upper estimate: no fusion, no L2
  model).
* ``roofline``: the port's H100 terms (``hw``, ``analysis.Roofline``),
  the link term at ``hw.ICI_BW`` (NVLink) or, across pods, ``hw.DCN_BW``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, cell_is_skipped, input_specs
from repro_torch.launch.fake import storage_of
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.launch.serve import lower_prefill_step, lower_serve_step
from repro_torch.launch.train import TrainConfig, lower_train_step
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import Roofline, model_flops
from repro_torch.roofline.trace_stats import by_position, tree_tensors


def lower_cell(arch: str, shape: str, multi_pod: bool,
               tcfg: TrainConfig = None, chunked_prefill: bool = False,
               devices=None):
    """(``Lowered``, ``ShapeSpec``) of one cell on the production mesh
    placed on ``devices`` (default a fake device a position), or
    (None, "SKIP") where the arch skips the shape."""
    tcfg = tcfg or TrainConfig()
    cfg = get_config(arch)
    if cell_is_skipped(cfg, shape):
        return None, "SKIP"
    mesh = fake_mesh(make_production_mesh(multi_pod=multi_pod), devices)
    spec = SHAPES[shape]
    specs = input_specs(cfg, shape)
    if spec.kind == "train":
        lowered = lower_train_step(cfg, tcfg, mesh, specs)
    elif spec.kind == "prefill":
        lowered = lower_prefill_step(cfg, mesh, batch=spec.batch,
                                     seq_len=spec.seq, specs=specs,
                                     chunked=chunked_prefill)
    else:
        lowered = lower_serve_step(cfg, mesh, batch=spec.batch,
                                   seq_len=spec.seq, specs=specs)
    return lowered, spec


def cell_tokens(spec) -> int:
    """Tokens a cell's step processes: train and prefill take batch x
    seq, decode emits one a row."""
    return spec.batch * (spec.seq if spec.kind in ("train", "prefill")
                         else 1)


def _bytes_on(tree, device) -> int:
    seen, n = set(), 0
    for t in tree_tensors(tree):
        st = storage_of(t)
        if t.device == device and id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def summarize(lowered, out, counter, *, chips: int, kind: str,
              tokens: int, cfg, link_bw: float, hbm_bytes) -> dict:
    """The artifact's ``memory``, ``cost``, ``collectives``, ``roofline``
    and ``by_position`` from one trace (``counter``) of ``lowered``'s
    step, whose output is ``out``."""
    devs = lowered.devices
    pos = {name: by_position(counter, devs, key) for name, key in (
        ("flops", lambda d: d.flops), ("hbm_bytes", lambda d: d.hbm_bytes),
        ("link_bytes", lambda d: d.link_bytes),
        ("peak_bytes", lambda d: d.peak_bytes))}
    top = devs[pos["peak_bytes"]["argmax"]]
    st = counter.stats(top)
    alias = counter.held_arguments(out).get(top, 0)
    total = st.peak_bytes
    memory = {"argument_size_in_bytes": st.argument_bytes,
              "output_size_in_bytes": _bytes_on(out, top),
              "temp_size_in_bytes": st.peak_bytes - st.argument_bytes,
              "alias_size_in_bytes": alias,
              "per_device_total": total,
              "hbm_bytes": hbm_bytes,
              "fits_hbm": (None if hbm_bytes is None
                           else bool(total < hbm_bytes))}
    flops = pos["flops"]["max"]
    hbm = pos["hbm_bytes"]["max"]
    busiest = counter.stats(devs[pos["link_bytes"]["argmax"]])
    rl = Roofline.from_measurements(flops, hbm, busiest.link_bytes,
                                    link_bw=link_bw)
    mf_dev = model_flops(cfg, kind, tokens) / chips
    return {
        "memory": memory,
        "cost": {"flops": flops, "bytes_accessed": hbm,
                 "bytes_accessed_upper": hbm},
        "collectives": dict(busiest.link),
        "roofline": {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "bound_step_s": rl.bound_step_time(),
            "model_flops_per_dev": mf_dev,
            "useful_flops_ratio": (mf_dev / rl.flops) if rl.flops else 0.0,
            "mfu_bound": rl.mfu(mf_dev)},
        "by_position": pos,
        "n_ops": sum(counter.stats(d).ops for d in set(devs)),
    }


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             save_trace: bool = False, tcfg: TrainConfig = None,
             chunked_prefill: bool = False, hbm_bytes=None,
             devices=None) -> dict:
    t0 = time.time()
    cfg = get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    result = {"arch": arch, "shape": shape, "mesh": mesh_name,
              "chips": chips}

    lowered, spec = lower_cell(arch, shape, multi_pod, tcfg,
                               chunked_prefill, devices)
    if lowered is None:
        result["status"] = "SKIP"
        result["reason"] = f"{arch} skips {shape} (see DESIGN.md)"
        return result
    t_lower = time.time() - t0

    out, counter = lowered.trace(per_op=save_trace)
    t_trace = time.time() - t0 - t_lower

    result.update(summarize(
        lowered, out, counter, chips=chips, kind=spec.kind,
        tokens=cell_tokens(spec),
        cfg=cfg, link_bw=hw.DCN_BW if multi_pod else hw.ICI_BW,
        hbm_bytes=hbm_bytes))
    result["timing"] = {"lower_s": round(t_lower, 1),
                        "trace_s": round(t_trace, 1)}
    result["status"] = "OK"

    if save_trace:
        top = lowered.devices[result["by_position"]["flops"]["argmax"]]
        table = sorted(([op, *row] for op, row in
                        counter.table[top].items()),
                       key=lambda r: -r[3])
        tdir = out_dir / "trace"
        tdir.mkdir(parents=True, exist_ok=True)
        with gzip.open(tdir / f"{arch}__{shape}__{mesh_name}.tsv.gz",
                       "wt") as f:
            f.write("op\tcount\tflops\thbm_bytes\n")
            for op, n, fl, b in table:
                f.write(f"{op}\t{n}\t{fl:.0f}\t{b:.0f}\n")
    return result


def card_hbm_bytes(given):
    """One card's memory: ``given`` (``--hbm-bytes``), else the visible
    card's; None where neither is known."""
    if given is not None:
        return int(given)
    import torch
    return hw.hbm_bytes() if torch.cuda.is_available() else None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-trace", action="store_true",
                    help="write the busiest position's per-op table "
                         "(gzipped tsv)")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel rules (the same trace: the "
                         "port's layouts do not read them)")
    ap.add_argument("--opt8", action="store_true",
                    help="8-bit Adam moments")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="prefill over chunks of 2048 tokens")
    ap.add_argument("--n-micro", type=int, default=8)
    ap.add_argument("--tag", default="",
                    help="artifact filename suffix for variants")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="one card's memory, for fits_hbm (read from the "
                         "card where one is visible)")
    args = ap.parse_args(argv)

    hbm = card_hbm_bytes(args.hbm_bytes)
    if hbm is None:
        ap.error("no card is visible: give --hbm-bytes for fits_hbm")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tcfg = TrainConfig(n_micro=args.n_micro, sequence_parallel=args.sp,
                       opt_8bit=args.opt8)
    res = run_cell(args.arch, args.shape, args.multi_pod, out_dir,
                   save_trace=args.save_trace, tcfg=tcfg,
                   chunked_prefill=args.chunked_prefill, hbm_bytes=hbm)
    if args.sp or args.opt8 or args.chunked_prefill \
            or args.n_micro != 8 or args.tag:
        res["variant"] = {"sp": args.sp, "opt8": args.opt8,
                          "chunked_prefill": args.chunked_prefill,
                          "n_micro": args.n_micro, "tag": args.tag}
    mesh_name = res["mesh"]
    suffix = f"__{args.tag}" if args.tag else ""
    path = out_dir / f"{args.arch}__{args.shape}__{mesh_name}{suffix}.json"
    path.write_text(json.dumps(res, indent=2))
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
