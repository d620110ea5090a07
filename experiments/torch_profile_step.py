"""Where one iteration of the port's main path spends its time (H100).

Builds the CUDA kernels, sets up the 128^3 bench mesh of chip_smoke.py
with the default parameters (face angle on; ``--band`` sets its band)
or, with ``--boundary``, in bench.py's boundary configuration (layers +
boundary smoothing onto the k = 64 dome, chip_smoke.boundary_params),
runs 4 warm-up iterations, then traces ``--iters`` iterations of
``Smoother.steps`` with ``torch.profiler``, writes the chrome trace to
chiprun_out/torch_profile_step_<band>.json and summarizes it: device
busy time (the union of kernel, memcpy and memset intervals) against
the span from the first to the last device event, and device time per
iteration by kernel, with the card's name and power limit.

Run from the repository root on a machine with a CUDA card:
    python experiments/torch_profile_step.py [--side 128] [--iters 8]
        [--band 60 120 | --boundary]
Summarize a trace again (no card needed):
    python experiments/torch_profile_step.py --summarize TRACE --iters 8
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from smoothmesh_torch import kernels  # noqa: E402
from smoothmesh_torch.driver import Smoother  # noqa: E402
from smoothmesh_torch.params import SmoothingParams  # noqa: E402
from smoothmesh_torch.testcases import bench_dome_geometry  # noqa: E402


def summarize(trace_path: str, iters: int) -> None:
    """Print device busy/idle and device ms per iteration by kernel."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, start, end = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > end:
            busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += end - start
    span = spans[-1][1] - spans[0][0]
    print(f"{iters} iterations: device busy {busy / 1e3:.3f} ms of a "
          f"{span / 1e3:.3f} ms span ({100 * busy / span:.1f}%, idle "
          f"{100 * (1 - busy / span):.1f}%)")
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        name = (e["name"].replace("(anonymous namespace)::", "")
                .split("(")[0] if e["cat"] == "kernel" else e["cat"])
        per[name][0] += 1
        per[name][1] += e["dur"] / 1e3
    for name, (count, ms) in sorted(per.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ms / iters:9.4f} ms/iteration  {count / iters:5.1f} "
              f"calls/iteration  {name[:80]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--band", type=float, nargs=2, default=(35.0, 160.0),
                    help="face-angle band in degrees (default 35 160)")
    ap.add_argument("--boundary", action="store_true",
                    help="bench.py's boundary configuration instead")
    ap.add_argument("--summarize", metavar="TRACE",
                    help="summarize an existing trace and exit")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize, args.iters)
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels.build_all()
    if args.boundary:
        params = chip_smoke.boundary_params(1000)
        label = "boundary"
    else:
        params = SmoothingParams(rel_tol=0.0, min_angle=args.band[0],
                                 max_angle=args.band[1])
        label = f"{args.band[0]:g}_{args.band[1]:g}"
    sm = Smoother(chip_smoke.bench_mesh(args.side), params, device="cuda")
    if args.boundary:
        sm.enable_boundary_smoothing(*bench_dome_geometry()[1:])
    sm.steps(4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = sm.steps(args.iters)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"torch_profile_step_{label}.json")
    prof.export_chrome_trace(path)
    print(f"{args.side}^3, {label}: {len(steps)} iterations in "
          f"{wall_ms:.3f} ms under the profiler on {smi}; trace {path}")
    summarize(path, len(steps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
