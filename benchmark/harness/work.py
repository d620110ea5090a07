"""The yardstick of the roofline shares: the chip's published peaks and
the shapes that the work stages (``benchmark/stages/*.py``) count
their bytes and operations from.

A stage module defines ``KERNEL`` (the kernel that does the stage in
the program, for the record) and ``work(shapes) -> (bytes, fp32
operations)`` or None where the cell does not run the stage.  Each
input is counted once and each output once, as the algorithm defines
them: float32 fields at 4 bytes a component, index tables at the
narrowest whole-byte width their values fit, ragged rows with one byte
a row for their length.  No stage counts what a kernel happens to read
again, so a share reads the same work whatever implements it.
"""

from __future__ import annotations

import math

import numpy as np

from harness import inputs

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and dense float32 rate
#: outside the tensor cores, at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
F32 = 4


def index_bytes(n: int) -> int:
    """Whole bytes that hold the values 0 .. n - 1."""
    return max(1, math.ceil(math.log2(max(n, 2)) / 8))


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S)


def shapes(mesh: dict, T: dict, config: dict, mix: dict) -> dict:
    """The counts the stages read, from the benchmark's own
    connectivity (``reftopo``) and inputs."""
    s = dict(N=T["n_points"], F=T["n_faces"], C=T["n_cells"],
             E=T["n_edges"],
             M=int(T["face_npoints"].sum()),            # face corners
             PC=int(T["pc_mask"].sum()),                 # point-cell
             PP=int(T["pp_mask"].sum()),                 # point-point
             CF=int(T["cf_mask"].sum()),                 # cell-face
             EC=int(T["ec_mask"].sum()),                 # edge-cell
             rays=0, tris=0)
    target = inputs.target(config, mix)
    if target is not None:
        s["tris"] = len(target[1])
        s["rays"] = smoothing_surface_interior(mesh, mix)
    return s


def smoothing_surface_interior(mesh: dict, mix: dict) -> int:
    """Points of the smoothing patches that lie on no other patch: the
    free boundary points, one ray each an iteration."""
    import re

    sel = mix["params"].get("smoothing_patches", [".*"])
    offs, flat = mesh["face_offsets"], mesh["face_flat"]
    on_sel = np.zeros(len(mesh["points"]), dtype=bool)
    on_other = np.zeros_like(on_sel)
    for name, n, start in mesh["patches"]:
        pts = flat[offs[start]:offs[start + n]]
        if any(re.fullmatch(p, name) for p in sel):
            on_sel[pts] = True
        else:
            on_other[pts] = True
    return int((on_sel & ~on_other).sum())


def stage_works(stages: list, s: dict) -> dict:
    """{stage module name: (bytes, ops)} of the stages the cell runs."""
    out = {}
    for mod in stages:
        w = mod.work(s)
        if w is not None:
            out[mod.__name__.split("_stages_")[-1]] = w
    return out

