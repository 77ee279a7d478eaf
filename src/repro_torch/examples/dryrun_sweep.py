"""Run the whole dry-run sweep: every (arch × shape × mesh) cell in its own
subprocess (``python -m repro_torch.launch.dryrun``), so that a crash or
a timeout in one cell does not stop the sweep (port of the JAX
package's ``scripts/dryrun_sweep.py``).  Resumable: a cell whose
artifact exists is skipped unless ``--force``.  A cell that fails
leaves a ``FAIL`` record with the tail of its errors (a fit that missed
its check point keeps its own record: the field, the position and both
values), one that runs past ``--timeout`` a ``TIMEOUT`` record; a cell
its arch skips (its config's ``skip_shapes``) a ``SKIP`` record.  Each
cell's counts are fitted over its loops' trip counts
(``launch.dryrun.TripCounts``), its traces in ``--workers`` processes.

    PYTHONPATH=src python -m repro_torch.examples.dryrun_sweep \\
        [--out artifacts/dryrun] [--timeout 2400] [--only-mesh 16x16] \\
        [--archs a,b,...] [--shapes s,...] [--hbm-bytes N] [--force] \\
        [--workers N]

Several sweeps may run side by side, each over its own ``--archs``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.configs.registry import ALL_ARCHS

ARCHS = list(ALL_ARCHS)
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SKIPS = {(a, s) for a in ARCHS for s in get_config(a).skip_shapes}
SKIP_REASON = ("full attention cannot serve 500k decode sub-quadratically "
               "(DESIGN.md §5)")


def _run(cmd, timeout, env) -> subprocess.CompletedProcess:
    """``cmd`` in a session of its own, so that a cell past ``timeout``
    is stopped with the workers it forked."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def run(args) -> list:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = args.archs.split(",") if args.archs else ARCHS
    shapes = args.shapes.split(",") if args.shapes else SHAPES
    meshes = [("16x16", False), ("2x16x16", True)]
    if args.only_mesh:
        meshes = [m for m in meshes if m[0] == args.only_mesh]
    src = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": src}

    results = []
    for mesh_name, multi in meshes:
        for arch in archs:
            for shape in shapes:
                cell = f"{arch}__{shape}__{mesh_name}"
                path = out / f"{cell}.json"
                if (arch, shape) in SKIPS:
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "SKIP", "reason": SKIP_REASON}))
                    results.append((cell, "SKIP", 0.0))
                    print(f"[skip] {cell}", flush=True)
                    continue
                if path.exists() and not args.force:
                    st = json.loads(path.read_text()).get("status", "?")
                    results.append((cell, f"cached:{st}", 0.0))
                    print(f"[cached:{st}] {cell}", flush=True)
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", str(out)]
                if multi:
                    cmd.append("--multi-pod")
                if args.save_trace:
                    cmd.append("--save-trace")
                if args.hbm_bytes is not None:
                    cmd += ["--hbm-bytes", str(args.hbm_bytes)]
                cmd += ["--workers", str(args.workers)]
                path.unlink(missing_ok=True)
                t0 = time.time()
                try:
                    proc = _run(cmd, args.timeout, env)
                    dt = time.time() - t0
                    if proc.returncode == 0:
                        results.append((cell, "OK", dt))
                        print(f"[ok {dt:6.1f}s] {cell}", flush=True)
                    else:
                        tail = proc.stderr.strip().splitlines()[-12:]
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_name}
                        if path.exists():      # the cell's own FAIL record
                            rec = json.loads(path.read_text())
                        rec.update(status="FAIL", stderr_tail=tail)
                        path.write_text(json.dumps(rec))
                        results.append((cell, "FAIL", dt))
                        print(f"[FAIL {dt:6.1f}s] {cell}", flush=True)
                        for ln in tail:
                            print("   |", ln)
                except subprocess.TimeoutExpired:
                    dt = time.time() - t0
                    path.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh_name,
                        "status": "TIMEOUT", "timeout_s": args.timeout}))
                    results.append((cell, "TIMEOUT", dt))
                    print(f"[TIMEOUT {dt:6.1f}s] {cell}", flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--only-mesh", default=None)
    ap.add_argument("--archs", default=None)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-trace", action="store_true")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="one card's memory (read from the card where one "
                         "is visible)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes a cell runs its fit's traces in")
    results = run(ap.parse_args(argv))
    ok = sum(1 for _, s, _ in results if s in ("OK", "cached:OK"))
    skip = sum(1 for _, s, _ in results if s in ("SKIP", "cached:SKIP"))
    bad = [c for c, s, _ in results
           if s not in ("OK", "SKIP", "cached:OK", "cached:SKIP")]
    print(f"\nSWEEP: {ok} ok, {skip} skip, {len(bad)} bad of "
          f"{len(results)}")
    for c in bad:
        print("  BAD:", c)


if __name__ == "__main__":
    main()
