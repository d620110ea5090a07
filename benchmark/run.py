"""The benchmark of ``smoothmesh_torch`` (the PyTorch and CUDA port):
smoothing jobs on one cell of ``BENCHMARK.json``.

    python benchmark/run.py --workload hex128.default --seed 1 \\
        --seconds 20 --trace 0

Set-up makes the cell's mesh from the seed, builds the port's smoother
(and the boundary set-up where the traffic mix asks for it), captures
its batch and runs one warm batch.  The window then runs whole jobs
back to back, each ``Smoother.steps(centroidalIters)`` from the start
state, until ``--seconds`` have passed.  After it, the traced run
(``--trace 1``) profiles a steady part of one job, and the check
follows segments of a job with the plain reference (``harness/check``).
The last line of standard output is the result, as JSON; everything
else goes to standard error, which ends with the numbers compared and
their limits.

The run needs a CUDA card (as many as the cell asks for) and fails
without one; it imports neither JAX nor the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

from harness import check, reftopo, trace, work  # noqa: E402
from harness.cells import Cell  # noqa: E402
from harness.program import Program  # noqa: E402

#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "smoothmesh_tpu")
CSRC = HERE.parent / "smoothmesh_torch" / "csrc"


class NoCard(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: this benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell asks for {n} cards and "
                     f"{torch.cuda.device_count()} are visible")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def traced_part(prog: Program, mix: dict) -> dict:
    """A steady part of one job under the profiler: ``skip`` iterations
    from the start state unprofiled, then ``iters`` traced."""
    tr = mix["trace"]
    prog.job(int(tr["skip"]))
    return trace.profile(lambda: prog.sm.steps(int(tr["iters"])),
                         prog.device)


def measure(cell: Cell, seed: int, seconds: float, traced: bool,
            device="cuda", config=None) -> tuple:
    """One run of ``cell`` (``config`` in place of the cell's, where
    given) -> (the result line, the record for standard error)."""
    mix = cell.mix
    config = cell.config if config is None else config
    prog = Program(config, mix, seed, device)
    prog.setup()
    setup_s = time.perf_counter() - T_START
    win = prog.window(seconds)
    dev = torch.device(device)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    prof = traced_part(prog, mix) if traced else None
    bad = forbidden_modules()
    if bad:
        raise Forbidden("loaded: " + ", ".join(bad))

    # the program's segments, then the program freed, then the reference;
    # a job that raised fails the run, and where no job finished there
    # is nothing to compare (the numbers stay missing: not correct)
    t_check = time.perf_counter()
    n_iters = len(win["last"])
    mesh = prog.mesh
    times = dict(prog.times)
    limits = dict(mix["check"]["limits"], failed_jobs=0)
    checks = {"failed_jobs": win["failed"]}
    cmp = dict(segments=[])
    if n_iters:
        segs, seg_end = check.read_program(prog, mix, n_iters, seed)
    prog.close()
    t_ref = time.perf_counter()
    if n_iters or traced:
        T = reftopo.build(mesh, dev)
    if n_iters:
        cmp = check.judge(mesh, config, mix, segs, T, dev)
        checks.update((k, cmp[k]) for k in limits if k in cmp)
        # the checked job's end against the window's last job's
        checks["rerun_off"] = int((check.gaps(
            seg_end, win["final"], cmp["min_edge"]) > 0).sum())
    t_end = time.perf_counter()
    correct = all(k in checks and checks[k] <= limits[k] for k in limits)

    iters = len(win["walls"])
    ctx = types.SimpleNamespace(
        n_points=len(mesh["points"]), walls=win["walls"],
        job_ms=win["job_ms"], iterations=iters, window_s=win["seconds"],
        stops=win["stops"], setup_s=setup_s, times=times, trace=prof,
        traced_iters=len(prof["result"]) if prof else 0)
    if traced:
        names = trace.program_kernel_names(CSRC)
        ctx.stage_work = work.stage_works(
            cell.stages(), work.shapes(mesh, T, config, mix))
        ctx.kernel_s = lambda: sum(v for k, v in prof["by_op"].items()
                                   if k in names)
    metrics = {}
    for m in (cell.per_layer() if traced else cell.end_to_end()):
        v = cell.reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    info = dict(cell=cell.name, seed=seed, jobs=win["jobs"],
                iterations=iters, job_iterations=n_iters,
                job_ms=win["job_ms"],
                window_s=win["seconds"], stops=win["stops"],
                times=times, setup_s=setup_s,
                segments_s=t_ref - t_check, reference_s=t_end - t_ref,
                segments=cmp["segments"])
    result = {"correct": bool(correct), "attempted": win["jobs"],
              "failed": win["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda"
                         else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": int(peak)}}
    if dev.type == "cuda":
        result["device"]["power_limit"] = power_limit()
    if traced:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        ops = sorted(prof["by_op"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                               "idle_gaps": prof["gaps"]}
        info["traced_iters"] = len(prof["result"])
    result["checks"] = {k: {"value": checks.get(k), "limit": v}
                        for k, v in limits.items()}
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    try:
        require_cards(cell.chips)
    except NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    try:
        result, info = measure(cell, args.seed, args.seconds,
                               bool(args.trace))
    except Forbidden as e:
        print(f"benchmark: JAX modules in the process: {e}", file=sys.stderr)
        return 3
    print(json.dumps(info), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
