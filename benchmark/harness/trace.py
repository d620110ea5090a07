"""The traced run: ``torch.profiler`` (CPU and CUDA activity) around a
call, read back from its Chrome trace.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events.  The program's own kernels are told from
PyTorch's by name: the ``__global__`` functions declared in the
program's CUDA sources, read at run time, so a kernel added later is
counted without a list to edit here.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GLOBAL_RE = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def program_kernel_names(csrc: Path) -> set:
    """Names of the ``__global__`` functions in ``csrc``'s CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(GLOBAL_RE.findall(path.read_text()))
    return names


def kernel_id(name: str) -> str:
    """A device event's function name without its arguments, namespaces
    and template arguments."""
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("(")[0].split("<")[0].strip()
    return base.split("::")[-1].split(" ")[-1]


def profile(fn, device) -> dict:
    """Run ``fn`` under the profiler, synchronized at both ends -> the
    summary of :func:`summarize` plus ``window_s``, the host's seconds
    around the call."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    summary = summarize(events)
    summary["window_s"] = window_s
    summary["result"] = out
    return summary


def _union(spans):
    """Total length of the union of (start, end) spans, and the gaps
    between them: [(gap start, gap length)]."""
    spans = sorted(spans)
    busy, gaps = 0.0, []
    start, end = spans[0]
    for a, b in spans[1:]:
        if a > end:
            busy += end - start
            gaps.append((end, a - end))
            start, end = a, b
        else:
            end = max(end, b)
    busy += end - start
    return busy, gaps


def summarize(events: list) -> dict:
    """Device time by operation, busy time and the ten longest idle
    gaps, each named by the innermost host operation running when it
    began, else by the last one begun before it (times in seconds)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "python_function",
                                 "cuda_runtime", "cuda_driver",
                                 "user_annotation")]
    by_op = {}
    for e in dev:
        name = kernel_id(e["name"]) if e["cat"] == "kernel" else e["cat"]
        by_op[name] = by_op.get(name, 0.0) + e["dur"] * 1e-6
    if not dev:
        return dict(by_op={}, busy_s=0.0, gaps=[])
    busy, gaps = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    named = []
    for start, length in sorted(gaps, key=lambda g: -g[1])[:10]:
        around = [h for h in host
                  if h["ts"] <= start <= h["ts"] + h.get("dur", 0)]
        if around:
            name = min(around, key=lambda h: h.get("dur", 0))["name"]
        else:       # between host operations: the one that began last
            before = [h for h in host if h["ts"] <= start]
            name = ("after " + max(before, key=lambda h: h["ts"])["name"]
                    if before else "before any host operation")
        named.append([name, length * 1e-6])
    return dict(by_op=by_op, busy_s=busy * 1e-6, gaps=named)
