#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smoothmesh_torch) on one CUDA card.

Phases, each fatal on failure:
  1. the card's name and power limit; build the CUDA kernels (K1-K8,
     one nvcc per source, all at once; a second run in the same
     checkout compiles none) and print the build time;
  2. the 128^3 graded, perturbed hex of bench.py (2,146,689 points),
     with the patches of its boundary mode ("top" = zmax, "rest" = the
     other five), and a Smoother with the default parameters (face
     angle on; boundary points fixed);
  3. each kernel against its plain PyTorch version on the card, on the
     main path's inputs: the largest error scaled by the field's
     magnitude (<= 1e-4) or the freeze-mask mismatches (<= 1e-4 * N),
     the kernel's and the plain version's times, and the kernel's
     bound (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s);
     K4 held bit for bit (no mask mismatch at the main thresholds or at
     tight ones, 3 x the minimum edge length and 60 degrees) and K5 bit
     for bit (max abs err 0), with their byte bounds on the packed
     tables they read and on the old ones, their launch geometry,
     registers, shared memory and spills; K3's launch, registers and
     the points that ran its share-a-cell test (those with a positive
     blend fraction and two closest neighbours);
     then the face-angle fixed point at 128^3 under a band that bites
     (60/120 degrees), once with the current angles from K5/K6 and once
     from their plain versions: more than 0 points frozen, at most
     1e-4 * N masks differing; its frozen count, sweeps and time;
  4. the default path: Smoother(...).steps(32) with the defaults, every
     one of K1-K6 launched once per iteration and K7, K8 never, finite
     residuals, 0 <= nFrozen <= N and positive cell volumes at the end;
  5. the boundary path on the same mesh and compiled topology, in
     bench.py's boundary configuration (layers and boundary smoothing
     on the top patch, min angle 15, ray misses frozen, the k = 64 dome
     as target surface): on the first iteration's inputs, K8 against
     its plain version (at most 1e-4 * B rays differing in hit or miss,
     the others within 1e-5 relative, and then bit for bit: no ray
     differing, every t equal), also on a random soup of 1,000
     triangles (not a multiple of the tile) and, bit for bit, at its
     edges (no triangles, one ray, one triangle fewer, origins on
     triangles so that t = +-0), with its launch geometry, registers
     and shared memory; K3 with boundary points moving (and the points
     that ran its share-a-cell test) and K4 with the boundary pass's
     incoming freeze mask (bit for bit) against theirs, and the times of
     the plain-PyTorch boundary stages; then
     Smoother.steps(32) with every kernel but K7 (K8 too) launched once
     per iteration, the top points' largest distance to the dome falling,
     and positive cell volumes;
  6. a 32^3 mesh of the same recipe for 8 iterations through the kernels
     and through the plain versions on the card, with the face angle
     off, at the default band, at 60/120 and at 80/100 (which freezes
     internal points there), and in the boundary configuration with
     the max step pinned above the raw steps (residuals within 2e-3,
     frozen counts within 10% + 10, equal ray-miss counts; in the
     boundary configuration also every residual below 1 and the points
     within 1e-3 at the end); under the four bands K4 and K5 also held
     bit for bit against their plain versions on every iteration's
     inputs (K4 at the main and the tight thresholds);
  3b. K7 (the table gather) against its plain version at the two 128^3
     shapes, point_cells (C = 3) and cell_faces (C = 4), bit-equal over
     the whole output, masked slots included; its time, its bytes bound
     and the time of torch.index_select + the mask's where;
  4b. the quality report (Smoother.quality()) of the default path's
     smoothed points, once through the kernels (K1, K2, K7) and once
     through their plain versions on the card: integer keys equal,
     lengths and volumes within 1e-5 relative, angles within 1e-3
     degrees, the aspect ratio within 1e-4 relative, the skewness and
     the cell openness (near 0, float32 residues) within 1e-4 and 1e-5
     absolute; its time;
  7. the port's CLI (smoothmesh_torch.cli.main, in-process) on the 128^3
     bench mesh written as a binary OpenFOAM case in a temporary
     directory, with the k = 64 dome as targetSurfaces.obj and its
     border ring as initEdges.obj: 8 iterations with boundary smoothing
     and layers on "top", min angle 15, ray misses frozen, -checkMesh,
     binary output.  Exit code 0, boundary smoothing enabled, no
     negative volume in the report, the written time directory reads
     back with every point, and every kernel (K1-K8) launched during
     the call; the wall time split into read, set-up (topology compile,
     upload, classification), smoothing, report and write;
  8. one JSON line of the kernels, then the last line
     {"ok": true, "device": {"platform": "gpu", ...}}.

Exits non-zero, printing no result, without a CUDA device or without
the smoothmesh_torch package beside this file.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM, fp32 outside the tensor cores
FIELD_TOL = 1e-4              # max |kernel - plain| / max |plain|
MASK_TOL = 1e-4               # freeze-mask mismatches / N
MAIN_SIDE = 128
MAIN_ITERS = 32
SMALL_SIDE = 32
SMALL_ITERS = 8
TIGHT_BAND = (60.0, 120.0)    # degrees: bites on the 128^3 bench mesh
TIGHTER_BAND = (80.0, 100.0)  # degrees: bites on the 32^3 one too
#: the 32^3 boundary comparison's max step (external units), above its
#: raw steps: a step at the limiter lands on the limiter's discontinuity
SMALL_BND_MAX_STEP = 0.25
BND_POINT_TOL = 1e-3          # normalized units (minimum edge length 1)
#: bench.py's boundary-mode patches (bench.py:126-130)
TOP_PATCHES = {"top": ["zmax"],
               "rest": ["xmin", "xmax", "ymin", "ymax", "zmin"]}
#: fp32 operations of one ray-triangle test in K8's body: 27 multiplies,
#: 18 adds and subtracts, 1 division, 8 comparisons, an abs and a select
RAY_TEST_OPS = 56
#: K3's block (kThreads in smoothmesh_torch/csrc/predictor.cu)
K3_THREADS = 128
#: K4's and K5's blocks and their shared memory a thread: K4 36 bytes
#: a neighbour slot, K5 a float4 a face slot (kThreads, kSlotBytes in
#: csrc/freeze.cu and csrc/face_angles.cu)
K4_THREADS = K5_THREADS = 128
K4_SLOT_BYTES, K5_SLOT_BYTES = 36, 16
#: what K4's plain version reads that the card's default path does not
#: stage (K4 reads the packed wedge words instead)
K4_PLAIN_KEYS = ("point_faces_mask", "wedge_prev", "wedge_next")
#: tight freeze thresholds (x min edge length, degrees): they freeze
#: many points of the bench meshes where the main path's freeze few
TIGHT_FREEZE = (3.0, 60.0)
#: the quality report's tolerances (float32, kernels against plain)
Q_REL_TOL = 1e-5              # lengths and volumes, relative
Q_DEG_TOL = 1e-3              # angles, degrees
Q_ASPECT_TOL = 1e-4           # aspect ratio, relative
#: skewness and cell openness, absolute: both are near 0 on this mesh
#: and carry the float32 error of a centre or an area sum, ~1e-7 of the
#: ~200-unit normalized coordinates over ~1-unit cells
Q_SKEW_TOL = 1e-4
Q_OPEN_TOL = 1e-5
CLI_ITERS = 8
#: the device tables that the face angle adds (K5, K6, the fixed point)
FACE_ANGLE_KEYS = ("edges", "edge_faces", "edge_cells", "edge_cells_mask",
                   "edge_cell_f0", "edge_cell_f1", "edge_cell_words",
                   "point_edges", "point_edges_mask", "pps_signed",
                   "pe_flat")


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bench_mesh(side: int):
    """bench.py's mesh: graded hex (2.0, 1.0, 0.5), perturbed by 0.25 x
    the minimum spacing, seed 3, with its boundary mode's patches."""
    from smoothmesh_torch.mesh.blockmesh import hex_block, perturb

    base = hex_block(n=(side, side, side), grading=(2.0, 1.0, 0.5),
                     patches=TOP_PATCHES)
    min_spacing = min(np.diff(np.unique(base.points[:, a])).min()
                      for a in range(3))
    return perturb(base, amplitude=0.25 * min_spacing, seed=3)


def device_ms(fn, reps: int) -> float:
    """Median device time of one call: an event pair around each call,
    so host time between calls is not counted."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def field_err(got, want):
    """(max abs error, max abs error / max |want|) over tensors."""
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    mag = max(float(w.float().abs().max()) for w in want)
    return err, err / max(mag, 1e-30)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def boundary_params(iters: int):
    """bench.py's boundary configuration (bench.py:98-101,146-149)."""
    from smoothmesh_torch.params import SmoothingParams

    return SmoothingParams(centroidal_iters=iters, rel_tol=0.0,
                           smoothing_patches=("top",),
                           layer_patches=("top",), min_angle=15.0,
                           ray_miss_fatal=False)


def check_rays(name, got, want, n_rays: int):
    """K8 against its plain version, held like a mask: rays on an edge
    shared by two triangles sit on the barycentric tolerance's knife
    edge, so at most MASK_TOL * n_rays rays may differ in hit or miss;
    where both hit, t agrees within 1e-5 relative.  -> (max abs error
    where both hit, rays differing, hits of the plain version)."""
    differ = torch.zeros(n_rays, dtype=torch.bool, device=want[0].device)
    err, beyond, hits = 0.0, 0, 0
    for g, w in zip(got, want):
        fg, fw = torch.isfinite(g), torch.isfinite(w)
        differ |= fg != fw
        both = fg & fw
        d = (g - w).abs()[both]
        if d.numel():
            err = max(err, float(d.max()))
            beyond += int((d > 1e-5 * w.abs()[both]).sum())
        hits += int(fw.sum())
    n_differ = int(differ.sum())
    require(n_differ <= MASK_TOL * n_rays and beyond == 0,
            f"{name}: {n_differ} of {n_rays} rays differ in hit or miss, "
            f"{beyond} hit times beyond 1e-5 relative")
    require(hits > 0, f"{name}: no ray hit")
    return err, n_differ, hits


def check_rays_exact(name, got, want):
    """K8 held bit for bit: no ray differs in hit or miss and every t
    equals the plain version's (a zero hit compares equal whatever its
    sign: the kernel writes +0) -> (rays, zero hits, of which -0 in the
    plain version)."""
    n_differ = sum(int((torch.isfinite(g) != torch.isfinite(w)).sum())
                   for g, w in zip(got, want))
    n_neq = sum(int((g != w).sum()) for g, w in zip(got, want))
    require(n_differ == 0 and n_neq == 0,
            f"{name}: {n_differ} rays differ in hit or miss, {n_neq} t "
            "values differ (held bit for bit)")
    zeros = sum(int((w == 0).sum()) for w in want)
    neg = sum(int(((w == 0) & torch.signbit(w)).sum()) for w in want)
    return int(want[0].numel()), zeros, neg


def resources_of(kernel, marker: str):
    """(registers, shared bytes, spilled bytes) of the entry function of
    ``kernel`` whose mangled name holds ``marker``."""
    for fn, regs, smem, spill in kernel.resources():
        if marker in fn:
            return regs, smem, spill
    raise RuntimeError(f"chip_smoke: no {marker} in {kernel.source}'s log")


def with_plain_tables(td, topo) -> dict:
    """``td`` and the tables K4's plain version reads that the card's
    path does not stage (K4 reads the packed wedge words)."""
    from smoothmesh_torch.device import to_device

    missing = [k for k in K4_PLAIN_KEYS if k not in td]
    return {**td, **(to_device(topo, "cuda", missing) if missing else {})}


def exact_k4_k5_stages(stats: dict):
    """The plain stages, holding K4 and K5 bit for bit against their
    plain versions on every iteration's inputs: K4 at the iteration's
    thresholds and at TIGHT_FREEZE, K5 on the iteration's face means
    and cell centres (also where the face angle is off).  Counts into
    ``stats``: K4 mask mismatches, K5 values not bit-equal, K5's max
    abs err, points frozen at the tight thresholds."""
    from smoothmesh_torch.driver import PLAIN_STAGES, Stages
    from smoothmesh_torch.ops import constraints as con

    seen = {}
    for k in ("k4_mismatches", "k4_tight_frozen", "k5_bits", "calls"):
        stats.setdefault(k, 0)
    stats.setdefault("k5_max_abs_err", 0.0)

    def face_geometry(*a):
        seen["fg"] = PLAIN_STAGES.face_geometry(*a)
        return seen["fg"]

    def cell_centres_vols(*a):
        out = PLAIN_STAGES.cell_centres_vols(*a)
        seen["cc"] = out[0]
        return out

    def freeze(points, prop, td, min_edge, tmf, angle, edge_angle, frozen):
        tight = (TIGHT_FREEZE[0] * min_edge, math.radians(TIGHT_FREEZE[1]))
        wants = []
        for e_, a_ in ((min_edge, angle), tight):
            args = (points, prop, td, e_, tmf, a_, edge_angle, frozen)
            wants.append(con.freeze_constraints_plain(*args))
            got = con.freeze_constraints(*args)
            stats["k4_mismatches"] += int((got != wants[-1]).sum())
        stats["k4_tight_frozen"] += int(wants[1].sum())
        ue = [f(points, seen["fg"].means, seen["cc"], td) for f in (
            con.edge_face_angles, con.edge_face_angles_plain)]
        stats["k5_bits"] += int((ue[0].view(torch.int32)
                                 != ue[1].view(torch.int32)).sum())
        stats["k5_max_abs_err"] = max(stats["k5_max_abs_err"], float(
            (ue[0] - ue[1]).abs().max()))
        stats["calls"] += 1
        return wants[0]

    return Stages(face_geometry, cell_centres_vols, PLAIN_STAGES.predictor,
                  freeze, PLAIN_STAGES.face_angles_per_point,
                  PLAIN_STAGES.ray_cast)


def k4_k5_edge_cases(pts, prop, means, cc, td_p, freeze_args) -> dict:
    """K4 and K5 against their plain versions, bit for bit, on the paths
    the main inputs do not take: a wedge row whose width is not a
    multiple of 4 (K4's scalar word loads), face rows wider than 32
    (K5's 128-bit slot set), and operands outside the range in which the
    kernels divide without a check (K4: 1,000 points proposed onto a
    neighbour, so one norm is 0; K5: 1,000 edges of zero length), which
    each kernel redoes with '/'.  freeze_args: K4's thresholds and
    flags after the td argument."""
    from smoothmesh_torch.ops import constraints as con

    out = {}
    cut = {k: td_p[k][:, :-1].contiguous() for k in (
        "wedge_words", "point_faces_mask", "wedge_prev", "wedge_next")}
    onto = prop.clone()
    rows = torch.arange(1000, device=pts.device)
    onto[rows] = pts[td_p["point_points"][rows, 0].long()]
    for name, p_, td_ in (
            (f"wedge rows of width {cut['wedge_words'].shape[1]}", prop,
             {**td_p, **cut}),
            ("1000 points proposed onto a neighbour", onto, td_p)):
        a = (pts, p_, td_) + freeze_args
        got, want = con.freeze_constraints(*a), con.freeze_constraints_plain(*a)
        mism = int((got != want).sum())
        require(mism == 0, f"K4 ({name}): {mism} mask mismatches")
        out[f"K4 {name}"] = dict(mismatches=mism, frozen=int(want.sum()))
    wef = td_p["edge_faces"].shape[1]
    wide = torch.nn.functional.pad(td_p["edge_faces"], (0, 40 - wef))
    flat = pts.clone()
    ends = td_p["edges"][:1000].long()
    flat[ends[:, 1]] = flat[ends[:, 0]]
    for name, p_, td_ in (
            ("edge_faces rows padded to width 40", pts,
             {**td_p, "edge_faces": wide.contiguous()}),
            ("1000 edges of zero length", flat, td_p)):
        a = (p_, means, cc, td_)
        got, want = con.edge_face_angles(*a), con.edge_face_angles_plain(*a)
        bits = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        require(bits == 0, f"K5 ({name}): {bits} values not bit-equal")
        out[f"K5 {name}"] = dict(values_not_bit_equal=bits)
    for k, v in out.items():
        print(f"{k}: bit-equal to its plain version ({v})", flush=True)
    return out


def k8_edge_cases(o, d, max_dist, tri, dev) -> dict:
    """K8 against its plain version, bit for bit, at its edges: no
    triangles, one ray, a triangle count that is not a multiple of the
    tile or of the slices, and origins on triangles (t = +-0)."""
    from smoothmesh_torch.ops import raycast

    rng = np.random.default_rng(1)
    ta = rng.random((1000, 3)) * 2
    tb = ta + rng.random((1000, 3)) * 0.5
    tc = ta + rng.random((1000, 3)) * 0.5
    soup = torch.tensor(raycast.pack_triangles(ta, tb, tc), device=dev)
    # from vertex a along +-the normal: s = 0, so t = +-0 exactly
    nrm = np.cross(tb - ta, tc - ta)
    nrm *= np.where(np.arange(1000) % 2, -1.0, 1.0)[:, None]
    on_o = soup[:3].T.contiguous()
    on_d = torch.nn.functional.normalize(torch.tensor(
        nrm, dtype=torch.float32, device=dev), dim=1)
    cases = {"0 triangles": (o, d, max_dist, tri[:, :0].contiguous()),
             "1 ray": (o[:1], d[:1], max_dist, tri),
             f"{tri.shape[1] - 1} triangles": (
                 o, d, max_dist, tri[:, :-1].contiguous()),
             "origins on triangles": (on_o, on_d, 1.0, soup)}
    out = {}
    for name, args in cases.items():
        got = raycast.segment_triangle_hits(*args)
        want = raycast.segment_triangle_hits_plain(*args)
        n, zeros, neg = check_rays_exact(f"K8 ({name})", got, want)
        hits = sum(int(torch.isfinite(w).sum()) for w in want)
        if name == "origins on triangles":
            require(zeros == n, f"K8 ({name}): {zeros} zero hits of {n}")
        out[name] = dict(rays=n, hits=hits, zero_hits=zeros,
                         plain_negative_zeros=neg)
        print(f"K8 edge case, {name} ({n} rays x {args[3].shape[1]} "
              f"triangles): bit-equal to its plain version, {hits} hits, "
              f"{zeros} zero hits ({neg} of them -0 in the plain version, "
              "+0 in the kernel)", flush=True)
    return out


def boundary_path(topo, mesh_int, smi: str) -> dict:
    """Phase 5: the boundary path at 128^3 -> its K8 record and launch
    counts."""
    from smoothmesh_torch import boundary as bps
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch import kernels
    from smoothmesh_torch import layers as lay
    from smoothmesh_torch.driver import (KERNEL_STAGES, Smoother, Stages,
                                         iteration_body)
    from smoothmesh_torch.ops import constraints as con
    from smoothmesh_torch.ops import raycast
    from smoothmesh_torch.ops import smoothing as smo
    from smoothmesh_torch.testcases import bench_dome_geometry

    dome_z, V, T, bpts, bedges = bench_dome_geometry()
    t0 = time.perf_counter()
    sb = Smoother(mesh_int, boundary_params(MAIN_ITERS), topo=topo,
                  device="cuda")
    torch.cuda.synchronize()
    t_maps = time.perf_counter() - t0
    t0 = time.perf_counter()
    setup = sb.enable_boundary_smoothing(V, T, bpts, bedges)
    torch.cuda.synchronize()
    t_cls = time.perf_counter() - t0
    p, td, bd, N, dev = sb.params, sb.td, sb.bnd, topo.n_points, sb.device
    rows = bd["surf_rows"]
    n_rays, n_tri = rows.numel(), bd["tri_packed"].shape[1]
    tables = [*sb.layer.values(),
              *(v for v in bd.values() if isinstance(v, torch.Tensor))]
    print(f"boundary path at {MAIN_SIDE}^3: Smoother set-up on the "
          f"compiled topology (upload, normals, layer maps) {t_maps:.2f} s,"
          f" boundary classification {t_cls:.2f} s; {n_rays} rays (free "
          f"top points), {int(setup.is_feature_edge.sum())} feature "
          f"points, {int(setup.is_corner.sum())} corners, {n_tri} "
          f"triangles, {int((sb.layer['outer_map'] >= 0).sum())} outer "
          f"and {int((bd['inner_map'] >= 0).sum())} inner layer maps; "
          f"device topology {nbytes(*td.values()) / 1e9:.3f} GB, boundary "
          f"and layer tables {nbytes(*tables) / 1e9:.3f} GB", flush=True)

    # the first iteration's inputs of each kernel stage
    rec = {}

    def recording(name, fn):
        def call(*args):
            out = fn(*args)
            rec[name] = (args, out)
            return out
        return call

    stages = Stages(*(recording(n, f) for n, f in
                      zip(Stages._fields, KERNEL_STAGES)))
    iteration_body(sb.points, td, p, sb._scale, stages, normals=sb.normals,
                   smoothing_surface=sb.smoothing_surface, layer=sb.layer,
                   bnd=bd)
    torch.cuda.synchronize()

    # K8 on the first iteration's rays, then on a random soup
    (o, d, max_dist, tri), got = rec["ray_cast"]
    want = raycast.segment_triangle_hits_plain(o, d, max_dist, tri)
    err, n_differ, hits = check_rays("K8", got, want, n_rays)
    check_rays_exact("K8", got, want)
    ms = device_ms(lambda: raycast.segment_triangle_hits(o, d, max_dist,
                                                         tri), 20)
    plain_ms = device_ms(lambda: raycast.segment_triangle_hits_plain(
        o, d, max_dist, tri), 5)
    work = (nbytes(o, d, tri, *got), RAY_TEST_OPS * n_rays * n_tri)
    b_ms, b_by = bound(*work)
    print(f"K8 segment_triangle_hits at {MAIN_SIDE}^3 ({n_rays} rays x "
          f"{n_tri} triangles): {n_differ} rays differ in hit or miss, "
          f"{hits} hits, max abs err {err:.3g}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) on {smi}",
          flush=True)
    rng = np.random.default_rng(0)
    ta = rng.random((1000, 3)) * 2
    soup = torch.tensor(raycast.pack_triangles(
        ta, ta + rng.random((1000, 3)) * 0.5, ta + rng.random((1000, 3))
        * 0.5), device=dev)
    ro = torch.tensor(rng.random((5000, 3)) * 2, dtype=torch.float32,
                      device=dev)
    rd = torch.nn.functional.normalize(torch.tensor(
        rng.normal(size=(5000, 3)), dtype=torch.float32, device=dev), dim=1)
    got_s = raycast.segment_triangle_hits(ro, rd, 10.0, soup)
    want_s = raycast.segment_triangle_hits_plain(ro, rd, 10.0, soup)
    r_err, r_differ, r_hits = check_rays("K8 (random soup)", got_s, want_s,
                                         5000)
    check_rays_exact("K8 (random soup)", got_s, want_s)
    print(f"K8 on a random soup (5000 rays x 1000 triangles): {r_differ} "
          f"rays differ in hit or miss, {r_hits} hits, max abs err "
          f"{r_err:.3g}; bit-equal", flush=True)
    edges = k8_edge_cases(o, d, max_dist, tri, dev)
    geom = raycast.launch_geometry(n_rays, n_tri, raycast._sm_count(
        torch.cuda.current_device()))
    regs, smem, spill = resources_of(kernels.RAYCAST, "raycast_kernel")
    launch = dict(ray_blocks=geom.ray_blocks, slices=geom.slices,
                  threads=raycast.THREADS,
                  rays_per_thread=raycast.RAYS_PER_THREAD,
                  tris_per_slice=geom.tris_per_slice, registers=regs,
                  shared_bytes=smem, spilled_bytes=spill)
    print(f"K8 launch at {MAIN_SIDE}^3: {geom.ray_blocks} x {geom.slices} "
          f"blocks of {raycast.THREADS} threads, {raycast.RAYS_PER_THREAD} "
          f"rays a thread, {geom.tris_per_slice} triangles a slice (after "
          f"a fill of both outputs); {regs} registers, {smem} bytes "
          f"shared, {spill} bytes spilled", flush=True)

    # K3 with boundary points moving, K4 with the boundary pass's mask
    args, got = rec["predictor"]
    want = smo.predictor_plain(*args)
    k3_err, scaled = field_err(got, want)
    per_pt = torch.maximum((got[0] - want[0]).abs().amax(1),
                           (got[1] - want[1]).abs()) / float(
                               want[0].abs().max())
    beyond = int((per_pt > FIELD_TOL).sum())
    intern = td["is_internal_point"]
    moving = int(((want[0] != args[0]).any(1) & ~intern).sum())
    require(args[5] and beyond <= MASK_TOL * N and moving > 0,
            f"K3 (boundary): {beyond} points beyond scaled error "
            f"{FIELD_TOL}, {moving} boundary points moving")
    n_share = int(smo.share_test_mask(args[0], td).sum())
    print(f"K3 with boundary smoothing on: max abs err {k3_err:.3g}, "
          f"scaled {scaled:.3g}; {beyond} of {N} points beyond it; "
          f"{moving} boundary points move; {n_share} points ran the share "
          "test", flush=True)
    args, got = rec["freeze_constraints"]
    incoming = args[-1]
    extra = incoming | torch.tensor(rng.random(N) < 0.01, device=dev)
    td_p = with_plain_tables(td, topo)
    mism = []
    for mask in (incoming, extra):
        a = args[:2] + (td_p,) + args[3:-1] + (mask,)
        k = con.freeze_constraints(*a)
        mism.append(int((k != con.freeze_constraints_plain(*a)).sum()))
        require(bool((k | ~mask).all()), "K4 dropped an incoming freeze")
    require(max(mism) <= MASK_TOL * N,
            f"K4 (incoming mask): {mism} freeze-mask mismatches")
    require(max(mism) == 0, f"K4 (incoming mask): {mism} freeze-mask "
            "mismatches (held bit for bit)")
    del td_p
    print(f"K4 with the boundary pass's incoming mask ({int(incoming.sum())}"
          f" frozen on entry, {int(got.sum())} on exit): {mism[0]} "
          f"mismatches of {N}; with 1% of points more frozen on entry "
          f"({int(extra.sum())}): {mism[1]} mismatches", flush=True)

    # the boundary stages in plain PyTorch (K8 inside the projection)
    pts, fg = sb.points, rec["face_geometry"][1]
    prop = rec["predictor"][1][0]
    max_step = p.max_step_length * sb._scale
    normals, sharp = lay.accumulate_point_normals(sb.normals, fg.areas, td)

    def blend():
        outer = lay.update_neigh_coords(pts, sb.layer["outer_map"])
        q = lay.blend_with_orthogonal_points(
            pts, prop, td, sb.layer["hops_layer"], normals, outer,
            p.layer_max_blending_fraction, p.layer_edge_length * sb._scale,
            p.layer_expansion_ratio, p.min_layers, p.max_layers + 1)
        return smo.constrain_max_step_length(pts, q, max_step,
                                             p.rel_step_frac)

    prop_l = blend()
    none = torch.zeros(N, dtype=torch.bool, device=dev)

    def project():
        return bps.project_boundary_points(pts, prop_l, normals, none, bd,
                                           td, sharp, fg.centres)

    prop_b = project()[0]

    def prismatic():
        inner = lay.update_neigh_coords(pts, bd["inner_map"])
        q = lay.project_prismatic_boundary_points(
            prop_b, bd, normals, inner, sharp,
            p.internal_smoothing_blending_fraction)
        return smo.constrain_max_step_length(pts, q, max_step,
                                             p.rel_step_frac)

    stage_ms = {name: device_ms(fn, 10) for name, fn in (
        ("normals", lambda: lay.accumulate_point_normals(
            sb.normals, fg.areas, td)),
        ("layer blend", blend), ("boundary projection", project),
        ("prismatic projection", prismatic))}
    print("boundary stages (plain PyTorch, first iteration's inputs, "
          "device ms): " + ", ".join(f"{k} {v:.4f}"
                                     for k, v in stage_ms.items())
          + f"; {sum(stage_ms.values()):.4f} in all, of which K8 "
          f"{ms:.4f}", flush=True)
    del rec, prop, prop_l, prop_b, normals, sharp, fg, got, want

    # the path itself
    top = rows.cpu().numpy()

    def dome_err():
        q = sb.denormalize()[top]
        return float(np.abs(q[:, 2] - dome_z(np.clip(q[:, 0], 0, 1),
                                             np.clip(q[:, 1], 0, 1))).max())

    err_before = dome_err()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    steps = sb.steps(MAIN_ITERS)
    t_run = time.perf_counter() - t0
    launches = {k: k.launches for k in kernels.ALL}
    require(len(steps) == MAIN_ITERS, f"{len(steps)} iterations ran")
    for k, n in launches.items():
        want_n = 0 if k is kernels.TABLE_GATHER else MAIN_ITERS
        require(n == want_n, f"{k.name} launched {n} times in "
                f"{MAIN_ITERS} iterations of the boundary path")
    for r in steps:
        require(math.isfinite(r.residual), f"residual {r.residual}")
        require(0 <= r.n_frozen <= N, f"nFrozenPoints {r.n_frozen}")
    for r in (steps[0], steps[1], steps[-1]):
        print(f"Smoothing iteration={r.iteration} "
              f"nFrozenPoints={r.n_frozen} residual={r.residual:.6g} "
              f"nRayMisses={r.n_ray_miss}")
    err_after = dome_err()
    require(err_after < err_before, f"the top points' largest distance "
            f"to the dome went from {err_before} to {err_after}")
    fgn = geo.face_centres_areas(sb.points, td["face_points"],
                                 td["face_mask"], td["face_npoints"])
    _, vol = geo.cell_centres_vols(fgn, td["owner"], td["cell_faces"],
                                   td["cell_faces_mask"])
    vmin = float(vol.min())
    require(vmin > 0, f"cell volume {vmin} at the end of the boundary path")
    walls = [r.wall_ms for r in steps]
    iter_ms = float(np.mean(walls))
    print(f"boundary path (layers + boundary smoothing): {MAIN_ITERS} "
          f"iterations in {t_run:.2f} s; {iter_ms:.3f} ms/iteration (median"
          f" {np.median(walls):.3f}, max {max(walls):.3f} at iteration "
          f"{int(np.argmax(walls)) + 1} of {len(walls)}), "
          f"{N / (iter_ms / 1e3):,.0f} point-updates/s on {smi}; nFrozen "
          f"{steps[0].n_frozen} -> {steps[-1].n_frozen}, ray misses "
          f"{sum(r.n_ray_miss for r in steps)} in all; largest |z - dome|"
          f" over the free top points {err_before:.6g} -> {err_after:.6g};"
          f" peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; min cell "
          f"volume {vmin:.4g} (normalized units)", flush=True)
    return dict(record=dict(
        name=kernels.RAYCAST.name, route="cuda",
        source=f"smoothmesh_torch/csrc/{kernels.RAYCAST.source}",
        replaces=kernels.RAYCAST.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bytes=work[0], ops=work[1], rays_differing=n_differ,
        random_soup_rays_differing=r_differ, edge_cases=edges,
        launch=launch), launches=launches, k3_share_test_points=n_share)

def gather_phase(td, cell_ctrs, face_geo, smi: str) -> dict:
    """Phase 3b: K7 against its plain version at the two 128^3 shapes ->
    its record (the cell_faces shape, the -checkMesh path's, first)."""
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch import kernels
    from smoothmesh_torch.ops import gather

    packed = torch.cat([face_geo.areas, geo.norm3(face_geo.areas)[:, None]],
                       1).contiguous()
    shapes = (("cell_faces", packed, td["cell_faces"], td["cell_faces_mask"]),
              ("point_cells", cell_ctrs.contiguous(), td["point_cells"],
               td["point_cells_mask"]))
    rec = {}
    for name, x, table, mask in shapes:
        n, w = table.shape
        c = x.shape[1]
        got = gather.table_gather(x, table, mask)
        want = gather.table_gather_plain(x, table, mask)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = float((got - want).abs().max())
        require(differ == 0, f"K7 at {name}: {differ} of {got.numel()} "
                "values differ from the plain version (bits)")
        n_masked = int((~mask).sum())
        require(bool((got[~mask] == 0).all()), f"K7 at {name}: a masked "
                "slot is not 0")
        del got, want
        flat = table.flatten()

        def library():
            g = torch.index_select(x, 0, flat).view(n, w, c)
            return torch.where(mask[..., None], g, 0.0)

        lib = library()
        require(bool(torch.equal(lib, gather.table_gather_plain(x, table,
                                                                mask))),
                f"index_select at {name} differs from the plain version")
        del lib
        ms = device_ms(lambda: gather.table_gather(x, table, mask), 20)
        plain_ms = device_ms(lambda: gather.table_gather_plain(x, table,
                                                               mask), 5)
        lib_ms = device_ms(library, 20)
        n_bytes = nbytes(x, table, mask) + n * w * c * 4
        b_ms, b_by = bound(n_bytes, 0)
        print(f"K7 table_gather at {MAIN_SIDE}^3, {name} ({n} x {w} slots, "
              f"C = {c}, {n_masked} masked): bit-equal to its plain "
              f"version; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_select + where {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {n_bytes / 1e6:.1f} MB) on {smi}", flush=True)
        vals = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    bytes=n_bytes, bits_differing=differ)
        if not rec:
            rec = dict(name=kernels.TABLE_GATHER.name, route="cuda",
                       source="smoothmesh_torch/csrc/"
                       f"{kernels.TABLE_GATHER.source}",
                       replaces=kernels.TABLE_GATHER.replaces, shape=name,
                       **vals)
        else:
            rec.update({f"{name}_{k}": v for k, v in vals.items()})
    return rec


@contextlib.contextmanager
def plain_quality():
    """The quality report through the plain versions of K1, K2 and K7
    (on whatever device its inputs lie)."""
    import types

    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch import quality
    from smoothmesh_torch.ops import gather

    saved = quality.geo, quality.table_gather
    quality.geo = types.SimpleNamespace(
        face_centres_areas=geo.face_centres_areas_plain,
        cell_centres_vols=geo.cell_centres_vols_plain,
        norm3=geo.norm3, dot3=geo.dot3)
    quality.table_gather = gather.table_gather_plain
    try:
        yield
    finally:
        quality.geo, quality.table_gather = saved


def quality_phase(sm, smi: str) -> dict:
    """Phase 4b: Smoother.quality() through the kernels and through the
    plain versions on the card -> the kernels' report and its time."""
    from smoothmesh_torch import kernels

    sm.quality()                               # stages its tables
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rep_k = sm.quality()
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t0) * 1e3
    launched = {k.name: k.launches for k in kernels.ALL if k.launches}
    with plain_quality():
        t0 = time.perf_counter()
        rep_p = sm.quality()
        torch.cuda.synchronize()
        qp_ms = (time.perf_counter() - t0) * 1e3
    print(f"quality report at {MAIN_SIDE}^3 (the default path's smoothed "
          f"points): {q_ms:.1f} ms through the kernels (launches "
          f"{launched}), {qp_ms:.1f} ms through the plain versions "
          f"(host clock, synchronized) on {smi}", flush=True)
    require(set(launched) == {kernels.FACE_GEOMETRY.name,
                              kernels.CELL_CENTRES.name,
                              kernels.TABLE_GATHER.name},
            f"the report launched {launched}")
    bad = []
    for k, want in rep_p.items():
        got = rep_k[k]
        if isinstance(want, int):
            ok, tol = got == want, "equal"
        elif k.endswith("_deg"):
            ok, tol = abs(got - want) <= Q_DEG_TOL, f"{Q_DEG_TOL} deg"
        elif k == "max_cell_openness":
            ok, tol = abs(got - want) <= Q_OPEN_TOL, f"{Q_OPEN_TOL} abs"
        elif k == "max_skewness":
            ok, tol = abs(got - want) <= Q_SKEW_TOL, f"{Q_SKEW_TOL} abs"
        elif k == "max_aspect_ratio":
            ok = abs(got - want) <= Q_ASPECT_TOL * abs(want)
            tol = f"{Q_ASPECT_TOL} rel"
        else:
            ok = abs(got - want) <= Q_REL_TOL * abs(want)
            tol = f"{Q_REL_TOL} rel"
        print(f"    {k:22s} kernels {got!r:24} plain {want!r:24} ({tol})")
        if not ok:
            bad.append(k)
    require(not bad, f"quality report: kernels and plain versions differ "
            f"in {bad}")
    require(rep_k["n_negative_volumes"] == 0, "negative volumes")
    return dict(report=rep_k, ms=q_ms, plain_ms=qp_ms)


def write_obj(path: str, verts, tris=None, edges=None) -> None:
    with open(path, "w") as f:
        f.writelines("v %.17g %.17g %.17g\n" % tuple(v) for v in verts)
        if tris is not None:
            f.writelines("f %d %d %d\n" % tuple(t) for t in tris + 1)
        if edges is not None:
            f.writelines("l %d %d\n" % tuple(e) for e in edges + 1)


@contextlib.contextmanager
def timed(timers: dict, cls, name: str, key: str, out=None):
    """Add the wall time of every call of ``cls.name`` to timers[key]
    (synchronizing the card after it); keep its result in ``out``."""
    orig = getattr(cls, name)

    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        try:
            res = orig(*args, **kw)
            torch.cuda.synchronize()
            if out is not None:
                out.append(res)
            return res
        finally:
            timers[key] = timers.get(key, 0.0) + time.perf_counter() - t0

    setattr(cls, name, wrapper)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def cli_phase(mesh, smi: str) -> dict:
    """Phase 7: the port's CLI on the 128^3 bench mesh as a binary case,
    with boundary smoothing, layers and -checkMesh -> launch counts."""
    from smoothmesh_torch import cli, kernels
    from smoothmesh_torch.driver import Smoother
    from smoothmesh_torch.io.case import FoamCase
    from smoothmesh_torch.io.polymesh import write_polymesh
    from smoothmesh_torch.testcases import bench_dome_geometry

    _, V, T, bpts, bedges = bench_dome_geometry()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_case_") as root:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, "system"))
        with open(os.path.join(root, "system", "controlDict"), "w") as f:
            f.write("deltaT 1;\n")
        write_polymesh(os.path.join(root, "constant", "polyMesh"), mesh,
                       binary=True)
        gdir = os.path.join(root, "constant", "geometry")
        os.makedirs(gdir)
        write_obj(os.path.join(gdir, "targetSurfaces.obj"), V, tris=T)
        write_obj(os.path.join(gdir, "initEdges.obj"), bpts, edges=bedges)
        t_case = time.perf_counter() - t0
        args = ["-case", root, "-centroidalIters", str(CLI_ITERS),
                "-checkMesh", "-writeFormat", "binary",
                "-smoothingPatches", "top", "-layerPatches", "top",
                "-minAngle", "15", "-allowRayMiss"]
        print(f"CLI at {MAIN_SIDE}^3: case written (binary) in {t_case:.1f}"
              f" s; smoothmesh_torch.cli.main({' '.join(args[2:])})",
              flush=True)
        timers, reports = {}, []
        out = io.StringIO()
        kernels.reset_launches()
        with contextlib.ExitStack() as stack:
            for cls, name, key, keep in (
                    (FoamCase, "read_mesh", "read", None),
                    (Smoother, "__init__", "set-up", None),
                    (Smoother, "enable_boundary_smoothing", "set-up", None),
                    (Smoother, "run", "run", None),
                    (FoamCase, "write_mesh", "write", None),
                    (FoamCase, "write_label_io_list", "write", None),
                    (Smoother, "quality", "report", reports)):
                stack.enter_context(timed(timers, cls, name, key, keep))
            stack.enter_context(contextlib.redirect_stdout(out))
            t0 = time.perf_counter()
            rc = cli.main(args)
            t_cli = time.perf_counter() - t0
        launches = {k: k.launches for k in kernels.ALL}
        text = out.getvalue()
        lines = text.splitlines()
        keep = [s for s in lines if not s.startswith("Smoothing iteration=")]
        print("\n".join("  | " + s for s in keep), flush=True)
        require(rc == 0, f"the CLI exited with {rc}")
        require("Enabled boundary point smoothing" in text,
                "the CLI did not enable boundary smoothing")
        require(len(reports) == 1 and reports[0]["n_negative_volumes"] == 0,
                f"the CLI's report: {reports}")
        require(f"Smoothing iteration={CLI_ITERS} " in text,
                f"the CLI did not run {CLI_ITERS} iterations")
        for k, n in launches.items():
            require(n >= 1, f"{k.name} was not launched during the CLI run")
        case = FoamCase(root)
        require(case.time_dirs() == [float(CLI_ITERS)],
                f"time directories {case.time_dirs()}")
        back = case.read_mesh(float(CLI_ITERS)).points
        require(back.shape == (mesh.n_points, 3)
                and bool(np.isfinite(back).all())
                and float(np.abs(back - mesh.points).max()) > 0,
                f"the written points read back as {back.shape}")
    split = dict(read=timers["read"], setup=timers["set-up"],
                 smoothing=timers["run"] - timers["write"],
                 report=timers["report"], write=timers["write"])
    print(f"CLI wall time {t_cli:.2f} s on {smi}: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in split.items())
          + f"; {sum(split.values()):.2f} s in these parts; launches "
          + ", ".join(f"{k.name.split()[0]} {n}" for k, n in
                      launches.items()), flush=True)
    return dict(launches=launches, wall_s=t_cli, split_s=split,
                report=reports[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    import smoothmesh_torch

    require(os.path.dirname(os.path.dirname(
        os.path.abspath(smoothmesh_torch.__file__))) == here,
        "smoothmesh_torch is not the package beside this script")
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch import kernels
    from smoothmesh_torch.driver import PLAIN_STAGES, Smoother, iteration_body
    from smoothmesh_torch.ops import constraints as con
    from smoothmesh_torch.ops import smoothing as smo
    from smoothmesh_torch.params import SmoothingParams

    # -- 1. device + build -------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    n_new = sum(not (k.library_path().exists() and k.log_path().exists())
                for k in kernels.ALL)
    t_build = kernels.build_all()
    print(f"build: {t_build:.2f} s for {len(kernels.ALL)} kernels, {n_new} "
          f"of them compiled now (the others were built before)")
    for k in kernels.ALL:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.source}: {line.strip()}")

    # -- 2. the main path's mesh --------------------------------------------
    t0 = time.perf_counter()
    mesh = bench_mesh(MAIN_SIDE)
    t_mesh = time.perf_counter() - t0
    params = SmoothingParams(centroidal_iters=MAIN_ITERS, rel_tol=0.0)
    t0 = time.perf_counter()
    sm = Smoother(mesh, params, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    topo, td, N = sm.topo, sm.td, sm.topo.n_points
    print(f"mesh: {MAIN_SIDE}^3 hex, {N} points, {topo.n_cells} cells, "
          f"{topo.n_faces} faces; generated in {t_mesh:.1f} s, "
          f"Smoother set up (reorder, topology, upload) in {t_setup:.1f} s",
          flush=True)
    fa_bytes = nbytes(*(td[k] for k in FACE_ANGLE_KEYS))
    print(f"device topology: {nbytes(*td.values()) / 1e9:.3f} GB, of "
          f"which the face angle's tables {fa_bytes / 1e9:.3f} GB "
          f"({topo.n_edges} edges)", flush=True)

    # -- 3. each kernel against its plain version ---------------------------
    p = sm.params
    max_step = p.max_step_length * sm._scale
    min_edge = p.min_edge_length * sm._scale
    pts = sm.points
    fp, fm, fn = td["face_points"], td["face_mask"], td["face_npoints"]
    own, cf, cfm = td["owner"], td["cell_faces"], td["cell_faces_mask"]
    pc, pcm = td["point_cells"], td["point_cells_mask"]
    pp, ppm = td["point_points"], td["point_points_mask"]
    td_p = with_plain_tables(td, topo)      # + K4's plain version's tables
    pfm, wpv, wnx = (td_p["point_faces_mask"], td_p["wedge_prev"],
                     td_p["wedge_next"])
    words = td["wedge_words"]
    intern = td["is_internal_point"]
    none = torch.zeros(N, dtype=torch.bool, device=sm.device)

    fg_p = geo.face_centres_areas_plain(pts, fp, fm, fn)
    cc_p, vol_p = geo.cell_centres_vols_plain(fg_p, own, cf, cfm)
    prop_p, curmin_p = smo.predictor_plain(pts, cc_p, td, max_step,
                                           p.rel_step_frac, False)

    def freeze(stage, edge, angle):
        return stage(pts, prop_p, td_p, edge, p.total_min_freeze, angle,
                     p.edge_angle_constraint, none)

    frz_p = freeze(con.freeze_constraints_plain, min_edge, p.min_angle_rad)
    ue_p = con.edge_face_angles_plain(pts, fg_p.means, cc_p, td)
    up_p = con.point_face_angles_plain(ue_p, td)

    def check_fields(name, got, want):
        err, scaled = field_err(got, want)
        require(math.isfinite(scaled) and scaled <= FIELD_TOL,
                f"{name}: scaled error {scaled:.3g} > {FIELD_TOL}")
        return err, {"scaled_err": scaled}, \
            f"max abs err {err:.3g}, scaled {scaled:.3g}"

    def check_exact(name, got, want):
        err, extra, msg = check_fields(name, got, want)
        bits = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                   for g, w in zip(got, want))
        require(err == 0 and bits == 0, f"{name}: max abs err {err}, {bits} "
                "values not bit-equal (held bit for bit)")
        return err, dict(extra, values_not_bit_equal=bits), \
            f"{msg}, bit-equal"

    def check_k3(name, got, want):
        err, scaled = field_err(got, want)
        # the predictor is discontinuous where |step| == max_step and
        # where two candidate neighbours tie in length: there a last-bit
        # difference of a sum flips the branch, so K3 is held like a
        # mask — at most 1e-4 * N points beyond the field tolerance
        per_pt = torch.maximum((got[0] - want[0]).abs().amax(1),
                               (got[1] - want[1]).abs())
        per_pt = per_pt / float(want[0].abs().max())
        beyond = int((per_pt > FIELD_TOL).sum())
        for i in torch.topk(per_pt, min(5, N)).indices.tolist():
            if per_pt[i] > FIELD_TOL:
                ratio = [float((q[i] - pts[i]).norm()) / max_step
                         for q in (got[0], want[0])]
                print(f"  K3 point {i}: internal={bool(intern[i])}, "
                      f"scaled err {float(per_pt[i]):.3g}; applied step "
                      f"/ max_step: kernel {ratio[0]:.6f}, plain "
                      f"{ratio[1]:.6f}")
        require(math.isfinite(scaled) and beyond <= MASK_TOL * N,
                f"{name}: {beyond} points beyond scaled error {FIELD_TOL}")
        return err, {"scaled_err": scaled, "points_beyond_tol": beyond}, \
            (f"max abs err {err:.3g}, scaled {scaled:.3g}; {beyond} of {N}"
             " points beyond it")

    def check_k4(name, got, want):
        mism = int((got != want).sum())
        # the main path's thresholds freeze few or no internal points of
        # this mesh; tighter ones (3 x min edge, 60 degrees) freeze many
        tight = (TIGHT_FREEZE[0] * min_edge, math.radians(TIGHT_FREEZE[1]))
        want_t = freeze(con.freeze_constraints_plain, *tight)
        mism_t = int((freeze(con.freeze_constraints, *tight)
                      != want_t).sum())
        n_t = int(want_t.sum())
        require(mism <= MASK_TOL * N and mism_t <= MASK_TOL * N,
                f"{name}: {mism} / {mism_t} freeze-mask mismatches")
        require(mism == 0 and mism_t == 0, f"{name}: {mism} / {mism_t} "
                "freeze-mask mismatches (held bit for bit)")
        require(n_t > 0, f"{name}: tight thresholds froze no point")
        return float(max(mism, mism_t) > 0), \
            {"mismatches": mism, "tight_mismatches": mism_t,
             "tight_frozen": n_t}, \
            (f"{mism} mismatches of {N} ({int(want.sum())} frozen); "
             f"tight thresholds: {mism_t} mismatches ({n_t} frozen)")

    n_fv = int(fm.sum())                  # valid face-vertex slots
    n_cf = int(cfm.sum())
    n_pc, n_pp, n_pf = int(pcm.sum()), int(ppm.sum()), int(pfm.sum())
    edges, ef, ec = td["edges"], td["edge_faces"], td["edge_cells"]
    ef0, ef1, ecm = (td["edge_cell_f0"], td["edge_cell_f1"],
                     td["edge_cells_mask"])
    cw = td["edge_cell_words"]
    n_ef = int(topo.edge_faces_mask.sum())      # faces a valid cell names
    pe, pem = td["point_edges"], td["point_edges_mask"]
    n_ec, n_pe = int(ecm.sum()), int(pem.sum())
    stages = (   # kernel call, plain call, check, plain result,
        #          (bytes: inputs read once + outputs written once,
        #           fp32 operations)
        (lambda: geo.face_centres_areas(pts, fp, fm, fn),
         lambda: geo.face_centres_areas_plain(pts, fp, fm, fn),
         check_fields, fg_p,
         (nbytes(pts, fp, fn) + 3 * nbytes(fg_p.centres), 40 * n_fv)),
        (lambda: geo.cell_centres_vols(fg_p, own, cf, cfm),
         lambda: geo.cell_centres_vols_plain(fg_p, own, cf, cfm),
         check_fields, (cc_p, vol_p),
         (nbytes(fg_p.centres, fg_p.areas, own, cf, cfm, cc_p, vol_p),
          28 * n_cf)),
        (lambda: smo.predictor(pts, cc_p, td, max_step, p.rel_step_frac,
                               False),
         lambda: smo.predictor_plain(pts, cc_p, td, max_step,
                                     p.rel_step_frac, False),
         check_k3, (prop_p, curmin_p),
         (nbytes(pts, cc_p, pc, pcm, pp, ppm, intern, prop_p, curmin_p),
          3 * n_pc + 12 * n_pp + 60 * N)),
        (lambda: freeze(con.freeze_constraints, min_edge, p.min_angle_rad),
         lambda: freeze(con.freeze_constraints_plain, min_edge,
                        p.min_angle_rad),
         check_k4, frz_p,
         # ~30 operations a neighbour (three vectors and norms), ~49 a
         # wedge (five dots, products, divisions and clamps)
         (nbytes(pts, prop_p, pp, ppm, words, none, frz_p),
          30 * n_pp + 49 * n_pf)),
        (lambda: (con.edge_face_angles(pts, fg_p.means, cc_p, td),),
         lambda: con.edge_face_angles_plain(pts, fg_p.means, cc_p, td),
         check_exact, (ue_p,),
         # ~19 operations per edge (its frame), ~26 per face projected,
         # ~52 per valid (edge, cell) slot (its centre's projection, two
         # dots and the u metric)
         (nbytes(pts, fg_p.means, cc_p, edges, ef, ec, cw, ue_p),
          19 * topo.n_edges + 26 * n_ef + 52 * n_ec)),
        (lambda: (con.point_face_angles(ue_p, td),),
         lambda: con.point_face_angles_plain(ue_p, td),
         check_fields, (up_p,),
         (nbytes(ue_p, pe, pem, up_p), 2 * n_pe)),
    )
    results = {}
    for k, (run_k, run_p, check, want, work) in zip(kernels.ALL[:6], stages):
        got = run_k()
        torch.cuda.synchronize()
        err, extra, msg = check(k.name, got, want)
        del got
        ms = device_ms(run_k, 20)
        plain_ms = device_ms(run_p, 5)
        b_ms, b_by = bound(*work)
        results[k] = dict(
            name=k.name, route="cuda",
            source=f"smoothmesh_torch/csrc/{k.source}",
            replaces=k.replaces, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, bytes=work[0], ops=work[1], **extra)
        print(f"{k.name}: {msg}; kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms, bound {b_ms:.4f} ms ({b_by}) on {kind}", flush=True)
    # the byte bounds on the unpacked tables the words replace:
    # wedge_prev, wedge_next and point_faces_mask; edge_cell_f0,
    # edge_cell_f1 and edge_cells_mask (9 bytes a slot against one
    # 2-byte word)
    for k, old_bytes in (
            (kernels.FREEZE, nbytes(pts, prop_p, pp, ppm, pfm, wpv, wnx, none,
                                    frz_p)),
            (kernels.FACE_ANGLES, nbytes(pts, fg_p.means, cc_p, edges, ef, ec,
                                         ef0, ef1, ecm, ue_p))):
        b_old, _ = bound(old_bytes, 0)
        r = results[k]
        r.update(bytes_old_tables=old_bytes, bound_ms_old_tables=b_old)
        print(f"{k.name} bound: {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['bytes'] / 1e6:.1f} MB) on the tables it reads now, "
              f"{b_old:.4f} ms ({old_bytes / 1e6:.1f} MB) on the old ones",
              flush=True)
    wp, wef = pp.shape[1], ef.shape[1]
    for k, marker, threads, dyn, rows, unit in (
            (kernels.FREEZE, "freeze_kernel", K4_THREADS,
             K4_SLOT_BYTES * wp * K4_THREADS, N, "point"),
            (kernels.FACE_ANGLES,
             f"face_angles_kernelILb{int(wef > 32)}E", K5_THREADS,
             K5_SLOT_BYTES * wef * K5_THREADS, topo.n_edges, "edge")):
        regs, smem, spill = resources_of(k, marker)
        results[k]["launch"] = dict(
            blocks=-(-rows // threads), threads=threads,
            dynamic_shared_bytes=dyn, registers=regs,
            static_shared_bytes=smem, spilled_bytes=spill)
        print(f"{k.name} launch at {MAIN_SIDE}^3: {-(-rows // threads)} "
              f"blocks of {threads} threads, one {unit} a thread, {dyn} "
              f"bytes of dynamic shared memory a block; {regs} registers, "
              f"{smem} bytes static shared, {spill} bytes spilled",
              flush=True)
    n_share = int(smo.share_test_mask(pts, td).sum())
    regs, smem, spill = resources_of(kernels.PREDICTOR, "predictor_kernel")
    results[kernels.PREDICTOR].update(
        share_test_points_default=n_share,
        launch=dict(blocks=-(-N // K3_THREADS), threads=K3_THREADS,
                    registers=regs, shared_bytes=smem, spilled_bytes=spill))
    print(f"K3 launch at {MAIN_SIDE}^3: {-(-N // K3_THREADS)} blocks of "
          f"{K3_THREADS} threads, one point a thread; {regs} registers, "
          f"{smem} bytes "
          f"shared, {spill} bytes spilled; {n_share} of {N} points ran the "
          "share test (a positive blend fraction, two closest neighbours)",
          flush=True)
    edge_cases = k4_k5_edge_cases(
        pts, prop_p, fg_p.means, cc_p, td_p,
        (min_edge, p.total_min_freeze, p.min_angle_rad,
         p.edge_angle_constraint, none))
    for k, tag in ((kernels.FREEZE, "K4"), (kernels.FACE_ANGLES, "K5")):
        results[k]["edge_cases"] = {n: v for n, v in edge_cases.items()
                                    if n.startswith(tag)}
    results[kernels.TABLE_GATHER] = gather_phase(td, cc_p, fg_p, smi)

    # the face-angle fixed point (plain PyTorch, as in the JAX package)
    # under a band that bites, with the current angles from K5/K6 (the
    # main path) and from their plain versions
    u_lo, u_hi = (con.angle_to_u(math.radians(a)) for a in (35.0, 160.0))
    cur_k = con.face_angles_per_point(pts, fg_p.means, cc_p, td)
    n_act = int(((cur_k[0] <= u_lo) | (cur_k[1] >= u_hi)).sum())
    print(f"face angle at the default band (35/160): {n_act} of {N} "
          f"points active", flush=True)
    band = tuple(math.radians(a) for a in TIGHT_BAND)

    def fixed_point(cur, stats):
        return con.restrict_face_angle_deterioration(
            pts, cc_p, prop_p, td, *band, frz_p, fc_base=fg_p.means,
            cur_minmax=cur, u_space=True, stats=stats)

    cur_p = con.face_angles_per_point_plain(pts, fg_p.means, cc_p, td)
    stats_p, stats_k = {}, {}
    fa_p = fixed_point(cur_p, stats_p)
    fixed_point(cur_k, stats_k)             # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fa_k = fixed_point(cur_k, stats_k)
    torch.cuda.synchronize()
    fa_ms = (time.perf_counter() - t0) * 1e3
    fa_new = int((fa_k & ~frz_p).sum())
    fa_mism = int((fa_k != fa_p).sum())
    require(fa_new > 0, f"the {TIGHT_BAND} band froze no point")
    require(fa_mism <= MASK_TOL * N,
            f"fixed point: {fa_mism} masks differ between the current "
            "angles of K5/K6 and of their plain versions")
    print(f"face-angle fixed point at {MAIN_SIDE}^3, band {TIGHT_BAND}: "
          f"{stats_k['active']} points active, {fa_new} frozen beyond "
          f"the {int(frz_p.sum())} of K4 ({int(fa_p.sum())} in all from "
          f"the plain current angles), {stats_k['sweeps']} pair sweeps, "
          f"{fa_mism} masks differ; {fa_ms:.2f} ms (host clock, "
          f"synchronized) on {smi}", flush=True)
    del fg_p, cc_p, vol_p, prop_p, curmin_p, frz_p, ue_p, up_p, cur_k, cur_p
    del td_p, pfm, wpv, wnx

    # -- 4. the default path through the user's entry point ------------------
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    steps = sm.steps(MAIN_ITERS)
    t_run = time.perf_counter() - t0
    launches = {k: k.launches for k in kernels.ALL}
    require(len(steps) == MAIN_ITERS, f"{len(steps)} iterations ran")
    for k, n in launches.items():
        want_n = (0 if k in (kernels.RAYCAST, kernels.TABLE_GATHER)
                  else MAIN_ITERS)
        require(n == want_n, f"{k.name} launched {n} times in "
                f"{MAIN_ITERS} iterations of the default path")
    for r in steps:
        require(math.isfinite(r.residual), f"residual {r.residual}")
        require(0 <= r.n_frozen <= N, f"nFrozenPoints {r.n_frozen}")
    for r in (steps[0], steps[1], steps[-1]):
        print(f"Smoothing iteration={r.iteration} "
              f"nFrozenPoints={r.n_frozen} residual={r.residual:.6g}")
    fg = geo.face_centres_areas(sm.points, fp, fm, fn)
    _, vol = geo.cell_centres_vols(fg, own, cf, cfm)
    vmin = float(vol.min())
    require(vmin > 0, f"cell volume {vmin} at the end")
    walls = [r.wall_ms for r in steps]
    iter_ms = float(np.mean(walls))
    print(f"default path (face angle on): {MAIN_ITERS} iterations "
          f"in {t_run:.2f} s; {iter_ms:.3f} ms/iteration (median "
          f"{np.median(walls):.3f}, max {max(walls):.3f} at iteration "
          f"{int(np.argmax(walls)) + 1} of {len(walls)}), "
          f"{N / (iter_ms / 1e3):,.0f} point-updates/s on {smi}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; min cell volume {vmin:.4g} (normalized units)", flush=True)
    del fg, vol
    quality = quality_phase(sm, smi)
    mesh_int = sm.mesh_internal
    del sm, td, pts

    # -- 5. the boundary path on the same mesh and topology -------------------
    bnd = boundary_path(topo, mesh_int, smi)
    results[kernels.RAYCAST] = bnd["record"]
    results[kernels.PREDICTOR]["share_test_points_boundary"] = \
        bnd["k3_share_test_points"]

    # -- 6. 32^3: kernels against plain versions over 8 iterations ----------
    small = bench_mesh(SMALL_SIDE)
    configs = [("face angle off", dict(face_angle_constraint=False)),
               ("default band", {})]
    configs += [(f"band {lo, hi}", dict(min_angle=lo, max_angle=hi))
                for lo, hi in (TIGHT_BAND, TIGHTER_BAND)]
    small_exact = {}
    for label, kw in configs:
        sk = Smoother(small, SmoothingParams(
            centroidal_iters=SMALL_ITERS, rel_tol=0.0, **kw), device="cuda")
        n_bnd = int((~sk.td["is_internal_point"]).sum())
        pts_p = sk.points.clone()
        rk = sk.steps(SMALL_ITERS)
        td_p = with_plain_tables(sk.td, sk.topo)
        exact = small_exact[label] = {}
        for i, r in enumerate(rk):
            pts_p, _, res_p, nf_p, _ = iteration_body(
                pts_p, td_p, sk.params, sk._scale, exact_k4_k5_stages(exact))
            res_p, nf_p = float(res_p), int(nf_p)
            where = f"{SMALL_SIDE}^3 {label}, iteration {i + 1}"
            require(abs(r.residual - res_p) < 2e-3,
                    f"{where}: residual {r.residual} (kernels) vs {res_p} "
                    "(plain)")
            require(abs(r.n_frozen - nf_p) <= 0.1 * nf_p + 10,
                    f"{where}: nFrozen {r.n_frozen} (kernels) vs {nf_p} "
                    "(plain)")
        require(exact["calls"] == SMALL_ITERS and exact["k4_mismatches"] == 0
                and exact["k5_bits"] == 0 and exact["k4_tight_frozen"] > 0,
                f"{SMALL_SIDE}^3 {label}: K4 and K5 against their plain "
                f"versions on each iteration's inputs: {exact}")
        print(f"{SMALL_SIDE}^3 x {SMALL_ITERS}, {label}: kernels and plain "
              f"versions agree (last residual {rk[-1].residual:.6g} vs "
              f"{res_p:.6g}, nFrozen {rk[-1].n_frozen} vs {nf_p}, of "
              f"which {n_bnd} boundary points); on each iteration's "
              f"inputs K4 {exact['k4_mismatches']} mask mismatches at the "
              f"main and tight thresholds ({exact['k4_tight_frozen']} "
              f"frozen at the tight ones in all), K5 "
              f"{exact['k5_bits']} values not bit-equal, max abs err "
              f"{exact['k5_max_abs_err']:.3g}", flush=True)
    require(rk[-1].n_frozen > n_bnd,
            f"{SMALL_SIDE}^3, band {TIGHTER_BAND}: no internal point froze")

    from smoothmesh_torch.testcases import bench_dome_geometry

    sk = Smoother(small, dataclasses.replace(
        boundary_params(SMALL_ITERS), max_step_length=SMALL_BND_MAX_STEP),
        device="cuda")
    sk.enable_boundary_smoothing(*bench_dome_geometry()[1:])
    pts_p, nrm_p = sk.points.clone(), sk.normals.clone()
    rk = sk.steps(SMALL_ITERS)
    td_p = with_plain_tables(sk.td, sk.topo)
    for i, r in enumerate(rk):
        pts_p, nrm_p, res_p, nf_p, nm_p = iteration_body(
            pts_p, td_p, sk.params, sk._scale, PLAIN_STAGES, normals=nrm_p,
            smoothing_surface=sk.smoothing_surface, layer=sk.layer,
            bnd=sk.bnd)
        res_p, nf_p, nm_p = float(res_p), int(nf_p), int(nm_p)
        where = f"{SMALL_SIDE}^3 boundary path, iteration {i + 1}"
        require(abs(r.residual - res_p) < 2e-3,
                f"{where}: residual {r.residual} (kernels) vs {res_p} "
                "(plain)")
        require(abs(r.n_frozen - nf_p) <= 0.1 * nf_p + 10,
                f"{where}: nFrozen {r.n_frozen} (kernels) vs {nf_p} (plain)")
        require(r.n_ray_miss == nm_p, f"{where}: ray misses "
                f"{r.n_ray_miss} (kernels) vs {nm_p} (plain)")
        require(r.residual < 1.0, f"{where}: residual {r.residual}: a "
                "step reached the limiter")
    moved = float((pts_p - sk.points).abs().max())
    require(moved < BND_POINT_TOL, f"{SMALL_SIDE}^3 boundary path: points "
            f"{moved} apart at the end (kernels vs plain)")
    print(f"{SMALL_SIDE}^3 x {SMALL_ITERS}, boundary path (layers + boundary"
          f" smoothing, max step {SMALL_BND_MAX_STEP}): kernels and plain "
          f"versions agree (last residual {rk[-1].residual:.6g} vs "
          f"{res_p:.6g}, nFrozen {rk[-1].n_frozen} vs {nf_p}, ray misses "
          f"{rk[-1].n_ray_miss} vs {nm_p}; largest point difference at the "
          f"end {moved:.3g} < {BND_POINT_TOL}, normalized units)", flush=True)

    # -- 7. the CLI at full size ------------------------------------------
    del small, sk, pts_p, nrm_p, td_p
    torch.cuda.empty_cache()
    cli = cli_phase(mesh, smi)

    # -- 8. the record ----------------------------------------------------
    main_path = {kernels.RAYCAST: bnd["launches"],
                 kernels.TABLE_GATHER: cli["launches"]}
    for k in results:
        results[k]["launches"] = main_path.get(k, launches)[k]
        results[k]["launches_default_path"] = launches[k]
        results[k]["launches_boundary_path"] = bnd["launches"][k]
        results[k]["launches_cli"] = cli["launches"][k]
    for k in (kernels.FREEZE, kernels.FACE_ANGLES):
        results[k]["small_runs_exact"] = small_exact
    results[kernels.TABLE_GATHER]["quality_report_ms"] = quality["ms"]
    results[kernels.TABLE_GATHER]["quality_report_plain_ms"] = \
        quality["plain_ms"]
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
