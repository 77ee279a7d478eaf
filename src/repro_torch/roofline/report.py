"""Render the roofline table from the dry run's artifacts (port of the
JAX package's ``roofline/report.py``).

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir artifacts/dryrun] [--mesh 16x16] [--csv]

``render(rows)`` is the reference's table.  The command line adds the
card's memory to the HBM column's head (the column is the busiest
position's peak) and a column of each cell's trace time.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def load_rows(d: Path, mesh: str):
    rows = []
    for p in sorted(d.glob(f"*__{mesh}.json")):
        r = json.loads(p.read_text())
        arch, shape = r["arch"], r["shape"]
        if r.get("status") == "SKIP":
            rows.append({"arch": arch, "shape": shape, "skip": True,
                         "reason": r.get("reason", "")})
            continue
        if r.get("status") != "OK":
            rows.append({"arch": arch, "shape": shape, "skip": True,
                         "reason": r.get("status", "?")})
            continue
        rl = r["roofline"]
        m = r["memory"]
        rows.append({
            "arch": arch, "shape": shape, "skip": False,
            "compute": rl["compute_s"], "memory": rl["memory_s"],
            "coll": rl["collective_s"], "dom": rl["dominant"],
            "bound": rl["bound_step_s"],
            "useful": rl["useful_flops_ratio"],
            "mfu": rl["mfu_bound"],
            "hbm_gb": m["per_device_total"] / 1e9,
            "fits": m["fits_hbm"],
            "card_gb": (m["hbm_bytes"] / 1e9 if m.get("hbm_bytes")
                        else None),
            "trace_s": r["timing"]["trace_s"],
        })
    return rows


def render(rows, markdown: bool = True, capacity_gb=None,
           trace_s: bool = False) -> str:
    """The reference's table; ``capacity_gb`` names the card's memory in
    the HBM column's head and ``trace_s`` adds a column of trace times
    (both off by default, which gives the reference's text)."""
    out = []
    if markdown:
        hbm = ("HBM/dev" if capacity_gb is None
               else f"HBM/pos (card {capacity_gb:.1f}GB)")
        extra, sep = (" trace |", "---|") if trace_s else ("", "")
        out.append("| arch | shape | compute | memory | collective | "
                   f"dominant | bound | useful-FLOPs | MFU-bound | {hbm} |"
                   f" fits |{extra}")
        out.append("|---|---|---|---|---|---|---|---|---|---|---|" + sep)
    for r in rows:
        if r["skip"]:
            tail = " — |" if trace_s else ""
            status = (r["reason"] if trace_s and r["reason"] in (
                "FAIL", "TIMEOUT") else "SKIP")
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{status} | — | — | — | — | — |{tail}"
                       if markdown else f"{r['arch']},{r['shape']},SKIP")
            continue
        if markdown:
            tail = f" {r['trace_s']:.1f}s |" if trace_s else ""
            out.append(
                f"| {r['arch']} | {r['shape']} | {_fmt_s(r['compute'])} | "
                f"{_fmt_s(r['memory'])} | {_fmt_s(r['coll'])} | "
                f"**{r['dom']}** | {_fmt_s(r['bound'])} | "
                f"{r['useful']:.2f} | {r['mfu']:.4f} | "
                f"{r['hbm_gb']:.1f}GB | "
                f"{'yes' if r['fits'] else 'NO'} |{tail}")
        else:
            out.append(f"{r['arch']},{r['shape']},{r['dom']},"
                       f"{r['bound']:.4f},{r['mfu']:.5f}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = load_rows(Path(args.dir), args.mesh)
    cards = {r["card_gb"] for r in rows if r.get("card_gb")}
    print(render(rows, markdown=not args.csv,
                 capacity_gb=max(cards) if cards else None, trace_s=True))


if __name__ == "__main__":
    main()
