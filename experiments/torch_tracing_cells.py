"""The smoother's own trace (``smoothmesh_torch.tracing``) read in a
cell of the benchmark, on the card: the readings that the per-layer
metrics of the set-up spans, the host reads, the batch edges and the
boundary pass would report, and what tracing costs.

    python3 experiments/torch_tracing_cells.py --workload hex128.default \\
        --seed 7 [--seconds 20] [--setup-profiled] [--out DIR]

(``--device cpu --side 8 --seconds 2`` rehearses it on the CPU.)

One process a cell, as the benchmark runs one: the set-up clock starts
at the process's start.  The run builds the cell's program as
``benchmark/run.py`` does (``harness.program.Program``), then:

1. the window: whole jobs for ``--seconds``, with ``host_reads``
   counted over it (per 1000 iterations completed);
2. the profiled part of the benchmark's traced run (``skip`` iterations,
   then ``iters`` traced), its Chrome trace kept: the device's idle time
   inside each batch edge, from a ``batch.read`` span's start to the
   next ``batch.replay`` span's start, per traced iteration;
3. the stage-timed part: ``time_stages(True)``, a job's ``skip``
   iterations (a capture of its own), then 16 batches of 16; each
   stage's median device ms over the batches, and the boundary pass
   (normals, layer blend, boundary projection);
4. the cost: 8 s windows with stage timing on, then off, and 4 s under
   ``torch.profiler`` (CPU and CUDA activity, nothing exported),
   against the window of step 1 (``iteration_ms_p50``).

``--setup-profiled`` runs the set-up under the profiler, as the CLI's
``-profileDir`` now does, reports its ``setup_s`` and stops.  The
result is one JSON line on standard output, with ``--out DIR`` also
written to ``DIR/<workload>[.setup-profiled].json``.  It imports
neither JAX nor the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

import torch  # noqa: E402

from harness.cells import Cell  # noqa: E402
from harness.program import Program  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "smoothmesh::"
STAGE_BATCHES = 16


def activities(device) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled_events(fn, device) -> tuple:
    """``fn()`` under the profiler, synchronized at both ends -> (its
    result, the Chrome trace's events)."""
    from torch.profiler import profile

    sync(device)
    with profile(activities=activities(device)) as prof:
        out = fn()
        sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, events


def program_spans(events: list) -> list:
    """The program's spans in a Chrome trace: [(name, start, end)] (µs),
    in start order, the prefix taken off."""
    return sorted((e["name"][len(PREFIX):], e["ts"], e["ts"] + e["dur"])
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith(PREFIX))


def busy_segments(events: list) -> list:
    """The device's busy time as disjoint (start, end) segments (µs)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_within(events: list, intervals: list) -> float:
    """Seconds of ``intervals`` ([(start, end)] µs) in which no device
    operation ran."""
    busy = busy_segments(events)
    idle = 0.0
    for a, b in intervals:
        covered = sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy)
        idle += (b - a) - covered
    return idle * 1e-6


def batch_edges(spans: list) -> list:
    """From each ``batch.read`` span's start to the next ``batch.replay``
    span's start: [(start, end)] µs."""
    reads = [s for n, s, _ in spans if n == "batch.read"]
    replays = [s for n, s, _ in spans if n == "batch.replay"]
    out = []
    for r in reads:
        nxt = [s for s in replays if s > r]
        if nxt:
            out.append((r, min(nxt)))
    return out


def top_level_setup_s(trace) -> float:
    """The sum of the trace's set-up spans that no span encloses."""
    return sum(s.total_s for n, s in trace.spans.items()
               if n.startswith("setup.") and s.parent is None)


def card(device) -> dict:
    if device.type != "cuda":
        return {"card": "cpu"}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=30)
    return {"card": out.stdout.strip()}


def p50(walls: list):
    return statistics.median(walls) if walls else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--setup-profiled", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--side", type=int, default=None,
                    help="cells a side in place of the configuration's")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    config = dict(cell.config)
    if args.side:
        config["cells_per_side"] = args.side
    dev = torch.device(args.device)
    rec = dict(workload=args.workload, seed=args.seed, **card(dev))

    prog = Program(config, cell.mix, args.seed, dev)
    if args.setup_profiled:
        from torch.profiler import profile

        with profile(activities=activities(dev)):
            prog.setup()
    else:
        prog.setup()
    rec["setup_s"] = time.perf_counter() - T_START
    rec["times"] = dict(prog.times)
    sm = prog.sm
    tr = sm.trace
    rec["setup_spans"] = {n: [s.count, s.total_s, s.parent]
                          for n, s in tr.spans.items()
                          if n.startswith("setup.")}
    top = top_level_setup_s(tr)
    rec["setup_spans_top_level_s"] = top
    rec["setup_unspanned_s"] = (rec["setup_s"] - prog.times["build_s"]
                                - top)
    init = [n for n in ("setup.reorder", "setup.topology", "setup.stats",
                        "setup.upload", "setup.layer_maps")
            if n in tr.spans]
    rec["smoother_spans_s"] = sum(tr.total(n) for n in init)
    if args.setup_profiled:
        return finish(rec, args)

    # 1. the window, host reads counted
    reads0 = tr.counters.get("host_reads", 0)
    win = prog.window(args.seconds)
    iters = len(win["walls"])
    rec["window"] = dict(seconds=win["seconds"], iterations=iters,
                         jobs=win["jobs"], failed=win["failed"],
                         iteration_ms_p50=p50(win["walls"]),
                         host_reads=tr.counters["host_reads"] - reads0)
    rec["host_reads_per_kiter"] = (1000.0 * rec["window"]["host_reads"]
                                   / iters if iters else None)

    # 2. the profiled part, as the benchmark's traced run profiles it
    tmix = cell.mix["trace"]
    skip, traced = int(tmix["skip"]), int(tmix["iters"])
    prog.job(skip)
    res, events = profiled_events(lambda: sm.steps(traced), dev)
    spans = program_spans(events)
    edges = batch_edges(spans)
    n_traced = len(res)
    rec["profiled"] = dict(
        iterations=n_traced, batch_edges=len(edges),
        span_counts={n: sum(1 for m, _, _ in spans if m == n)
                     for n in sorted({m for m, _, _ in spans})},
        edge_ms=[(b - a) * 1e-3 for a, b in edges])
    rec["batch_edge_idle_ms_per_iter"] = (
        idle_within(events, edges) * 1e3 / n_traced if n_traced else None)

    # 3. the stage-timed part
    capture0 = tr.total("setup.capture")
    t0 = time.perf_counter()
    sm.time_stages(True)
    prog.job(skip)
    rec["stage_part_capture_s"] = tr.total("setup.capture") - capture0
    samples = []
    for _ in range(STAGE_BATCHES):
        before = {n: s.total_s for n, s in tr.spans.items()
                  if n.startswith("iter.")}
        sm.steps(sm.iter_batch)
        samples.append({n: (s.total_s - before.get(n, 0.0)) * 1e3
                        for n, s in tr.spans.items()
                        if n.startswith("iter.")})
    rec["stage_part_s"] = time.perf_counter() - t0
    names = sorted(samples[0])
    rec["stages_ms"] = {n: statistics.median(s[n] for s in samples)
                        for n in names}
    rec["stages_ms_sum"] = sum(rec["stages_ms"].values())
    boundary = ("iter.normals", "iter.layer_blend",
                "iter.boundary_projection")
    if all(n in names for n in boundary):
        rec["boundary_pass_ms_per_iter"] = statistics.median(
            sum(s[n] for n in boundary) for s in samples)

    # 4. the cost: stage timing on, then off, then under the profiler
    on = prog.window(8.0)
    sm.time_stages(False)
    off = prog.window(8.0)
    from torch.profiler import profile

    with profile(activities=activities(dev)):
        under = prog.window(4.0)
    rec["cost"] = dict(
        iteration_ms_p50_off=rec["window"]["iteration_ms_p50"],
        iteration_ms_p50_stages_on=p50(on["walls"]),
        iteration_ms_p50_off_after=p50(off["walls"]),
        iteration_ms_p50_profiler_on=p50(under["walls"]),
        points_per_s_off=len(prog.mesh["points"]) * iters / win["seconds"],
        points_per_s_stages_on=(len(prog.mesh["points"]) * len(on["walls"])
                                / on["seconds"]),
        points_per_s_off_after=(len(prog.mesh["points"])
                                * len(off["walls"]) / off["seconds"]))
    return finish(rec, args)


def finish(rec: dict, args) -> int:
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        name = args.workload + (".setup-profiled" if args.setup_profiled
                                else "")
        (out / f"{name}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
