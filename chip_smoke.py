#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smoothmesh_torch) on one CUDA card.

Phases, each fatal on failure:
  1. the card's name and power limit; build the CUDA kernels (K1-K9,
     one nvcc per source, all at once) and the native topology
     compiler (g++); a second run in the same checkout compiles none;
     print the build time;
  2. the 128^3 graded, perturbed hex of bench.py (2,146,689 points),
     with the patches of its boundary mode ("top" = zmax, "rest" = the
     other five), and a Smoother with the default parameters (face
     angle on; boundary points fixed), its set-up split into the
     spatial reorder, the native topology compile and the three word
     packings (K4's, K5's and K2's); the same topology compiled by the
     numpy path too, for its time: every row of the native tables
     left-packed, the row counts of the point, face and cell tables
     and the edge count equal on both paths; everything after this
     phase uses the native tables;
  3. each kernel against its plain PyTorch version on the card, on the
     main path's inputs: the largest error scaled by the field's
     magnitude (<= 1e-4) or the freeze-mask mismatches (<= 1e-4 * N),
     the kernel's and the plain version's times, and the kernel's
     bound (bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s);
     K1, K2 and K5 held bit for bit (no value whose bits differ), K4 bit
     for bit (no mask mismatch at the main thresholds or at tight ones,
     3 x the minimum edge length and 60 degrees), K2, K4 and K5 with
     their byte bounds on the packed words they read and on the old
     tables, the four with their launch geometry, registers, shared
     memory and spills; K1 and K2 also bit for bit on their other paths
     and branches (rows wider and narrower than their register paths,
     degenerate faces, flat and inverted cells, sums below the range in
     which they divide without a check); K3's launch, registers and
     the points that ran its share-a-cell test (those with a positive
     blend fraction and two closest neighbours);
     then the face-angle fixed point at 128^3 under a band that bites
     (60/120 degrees), once with the current angles from K5/K6 and once
     from their plain versions: more than 0 points frozen, at most
     1e-4 * N masks differing; its frozen count, sweeps and time;
  4. the default path: Smoother(...).steps(32) with the defaults, once
     one iteration a dispatch (iter_batch 1) and once from the same
     start in batches of 16 (SMOOTHMESH_ITER_BATCH unset), each batch
     16 replays of one iteration captured as a CUDA graph: points and
     normals bit-equal, residuals, frozen counts and iteration numbers
     equal; the batched call reads the host exactly twice (counted
     under torch.cuda.set_sync_debug_mode("warn")) and runs its replays
     under "error"; in both runs every one of K1-K6 launched once per
     iteration (through the replays in the batched one) and K7-K9
     never; finite residuals, 0 <= nFrozen <= N and positive cell
     volumes at the end; the ms/iteration of both, the capture time and
     the peak device memory;
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
     incoming freeze mask (bit for bit) against theirs, K9 (the point
     normals) bit for bit against its plain version with its time, its
     bytes bound, registers and launch, and the times of the
     plain-PyTorch boundary stages beside K9's; then
     Smoother.steps(32) one iteration a dispatch and in batches of 16,
     compared as in phase 4, with every kernel but K7 (K8 and K9 too)
     launched once per iteration, the top points' largest distance to
     the dome falling, positive cell volumes, and K9 bit for bit
     against its plain version on the state the batched steps left;
  6. a 32^3 mesh of the same recipe for 8 iterations through the kernels
     and through the plain versions on the card, with the face angle
     off, at the default band, at 60/120 and at 80/100 (which freezes
     internal points there), and in the boundary configuration with
     the max step pinned above the raw steps (residuals within 2e-3,
     frozen counts within 10% + 10, equal ray-miss counts; in the
     boundary configuration also every residual below 1 and the points
     within 1e-3 at the end); under the four bands K4 and K5 also held
     bit for bit against their plain versions on every iteration's
     inputs (K4 at the main and the tight thresholds), and K1, K2, K4,
     K5 and K9 likewise in the boundary configuration; each of the five
     runs batched (16) and again one iteration a dispatch from the
     same start, bit-equal, with the face-angle stops of the batched
     run printed (the 60/120 and 80/100 bands take one);
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
     back with every point, and every kernel (K1-K9) launched during
     the call; the wall time split into read, set-up (native topology
     compile, upload, classification), smoothing, report and write, and
     the set-up into its parts as in phase 2;
  9. (before the record) the halo decomposition
     (smoothmesh_torch.parallel): the 128^3 bench mesh in 4 shards on
     the card through UnionSync (the shards' union, each kernel one
     launch an iteration over all of them), its set-up split into the
     shard build (with the four topology compiles), the union and the
     upload; 8 iterations against the single device from the same
     start (phase 4's mesh and topology: frozen counts within 1e-4 * N,
     residuals within 1e-3 relative, all but 1e-4 * N points within
     1e-5 x the coordinate scale, positive volumes) and the same 8
     through the plain versions on the union, compared as phase 6
     compares them (K1, K2, K5 bit for bit, K4 without a mismatch on
     every iteration's inputs); steps(32) batched against one by one
     as in phase 4 (bit-equal, 2 host reads, K1-K6 32 launches); the
     exchanges' device time; quality() from the claims against the
     global report (integer keys equal, the rest within 5e-4 relative
     + 1e-5; K7 one launch); at 32^3 the boundary configuration in 4
     shards against the single device (phase 6's criteria, K8 launched
     every iteration); and DistSync, 2 gloo ranks in 2 processes sharing
     cuda:0 (smoothmesh_torch.parallel.ranks), bit-equal to UnionSync
     with 2 shards after 8 iterations;
  10. (before the record) the disjoint decomposition
     (smoothmesh_torch.parallel.sharded): the 128^3 bench mesh in 4
     shards on the card through UnionPointSync (the shards' union, each
     kernel one launch an iteration over all of them, K3 too, whose
     shared rows are then recomputed with the exchanges), its set-up
     split into the shard build (with the four topology compiles), the
     union and the upload; 8 iterations through the kernels against the
     same 8 through the plain versions on the union (residuals within
     2e-3, frozen counts within 10% + 10; K1, K2, K5 bit for bit, K4
     without a mismatch, K3 on the unshared rows held like a mask, at
     most 1e-4 * N points beyond the field tolerance); with the freezes
     off, 8 iterations against the single device from the same points
     (every point within 1e-4 x the coordinate scale); every holder of
     a shared point bit-identical after each run; steps(32) batched
     against one by one as in phase 4 (bit-equal, 2 host reads, K1-K6
     32 launches); the device time of the shared rows' predictor beside
     K3's and the whole plain chain's; at 32^3 the boundary configuration
     in 4 shards through the kernels against the plain versions on the
     union (K8 launched every iteration) and its quality() (the global
     report, K7 one launch); DistPointSync, 2 gloo ranks in 2 processes
     sharing cuda:0, bit-equal to UnionPointSync with 2 shards after 8
     iterations; and the CLI's -parallel on the 32^3 case (exit 0, the
     points read back);
  11. (before the record) float64 on the card, where every wrapper
     runs its plain version and no kernel launches: the 32^3 mesh in
     float64 for 8 iterations on the card against the CPU, at the
     default band, at 60/120 and in the boundary configuration with the
     max step pinned at 0.25 (every point within 1e-10 x the coordinate
     scale, residuals within 1e-10 relative, equal ray misses, the
     masks of the points each iteration held and the frozen counts
     differing at most 1e-4 * N; the card's batched steps bit-equal to
     its step() run); the 128^3 default path in float64, steps(32)
     batched against one by one as in phase 4 (bit-equal, 2 host
     reads, no launch), within 2e-3 in residual and 10% + 10 in frozen
     count of phase 4's float32 kernels on every iteration, its
     ms/iteration both ways, capture time and peak memory; the 128^3
     boundary configuration in float64, 8 batched iterations, its
     ms/iteration and peak memory; at 64^3 in 4 shards on the card
     (n_shards=4) the halo against the single device and the disjoint
     one (the rule's choice in float64, driver.decomposition) against
     it with the freezes off, in float64 and then in float32: the
     farthest point in units of the coordinate scale and the points
     beyond 1e-5 of it (phase 9's and 10's tolerances); the CLI with -dtype float64 on the 32^3
     case on the card and on the CPU (-checkMesh: exit 0, Mesh OK, the
     report's integers equal and the rest within 1e-9 relative + 1e-12,
     the written points within 1e-10 x the scale) and with -parallel
     (exit 0); no kernel launched in any float64 run of the phase
     (launch and capture counts); then a float32 step() launching K1-K6
     once each and a float16 smoother on cuda raising TypeError;
  12. (before the record) the decompositions one rank a card over NCCL
     (smoothmesh_torch.parallel.ranks.join: NCCL on cuda, rank r on
     cuda:r): the NCCL version, whether torch has NCCL and the card
     count; at world 1 on cuda:0 (run_ranks(..., backend "nccl")) the
     halo and the disjoint decomposition at 128^3 with the default
     parameters, steps(32), and the halo's 32^3 boundary configuration
     (max step 0.25, 8 iterations, K8), each against the same class
     with one shard in this process (UnionSync / UnionPointSync):
     results, points and denormalize() bit-equal, quality() within
     1e-12 relative, every kernel of the run launched in the rank (K1-K6
     every iteration, K7 in the report, K8 in the boundary run), the
     ms/iteration of both forms; one NCCL rank more than there are cards
     refused in join before any collective, with a message naming both
     numbers; the CLI under torchrun's environment (RANK 0, WORLD_SIZE 1,
     LOCAL_RANK 0, a free MASTER_PORT) with -device cuda -parallel in a
     subprocess: exit 0, NCCL in its log, the written points equal to
     the in-process -parallel's at one shard; with two cards or more,
     two NCCL ranks on two cards at 128^3 against HaloSmoother with 2
     shards on one card (bit-equal; the report within Q_REL_TOL, its
     parts summed in another order), else a line saying it was not run;
  13. (before the record) the decompositions over several devices in
     one process, one host thread a device (devices=,
     smoothmesh_torch.parallel.cards): the card count, peer access
     between each pair of cards and the card's name and power limit;
     each run against the same class with as many shards on one card
     (the union, graph replays), from shards built once for both:
     world 1 (devices=[cuda:0]) for the halo and the disjoint
     decomposition at 128^3, steps(32); world 2 with both members on
     cuda:0, each on its own stream, at 128^3 for both and the halo's
     32^3 boundary configuration (max step 0.25, 8 iterations, K8).
     Required: results, points and denormalize() bit-equal, the holders
     of a shared point bit-identical, each member's launches of K1-K8
     equal to the union's and the members' counts summing to the
     total; at world 2 quality() within 1e-12 relative for the disjoint
     decomposition, 1e-5 for the halo (its float32 parts summed a
     member at a time, as phase 12's ranks sum them); each member's
     launches and the ms/iteration of both forms printed.  On 2 (and
     4) cards where the machine has them, devices=cuda:0..N-1 at 128^3
     for both decompositions, else a line saying why not;
     Smoother(n_devices=cards + 1) refused before any build with a
     message naming both numbers; the CLI with -device cuda -parallel
     in a subprocess with no RANK: exit 0, "N cards in this process"
     in its log, the written points equal to ShardedSmoother(
     n_shards=N) in this process;
  8. one JSON line of the halo's figures, one of the disjoint
     decomposition's, one of phase 11's, one of phase 12's, one of
     phase 13's, one of the kernels (with the halo's, the disjoint
     decomposition's, the NCCL ranks' and the card group's launches),
     then the last line
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
import warnings

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
#: the same for K2 (it reads the cell-face words)
K2_PLAIN_KEYS = ("owner", "cell_faces", "cell_faces_mask")
#: K1's and K2's blocks and the row widths of their register paths
#: (kThreads, kRowW in csrc/face_geometry.cu and csrc/cell_centres.cu)
K1_THREADS = K2_THREADS = 256
K1_ROW_W, K2_ROW_W = 4, 6
#: K9's block (smk::kBlock in csrc/common.cuh) and its fp32 operations:
#: ~12 a point (the sum added, its norm, three divisions) and ~12 a
#: selected face slot (the area's norm, three divisions, three adds)
K9_THREADS = 256
K9_OPS = 12
#: x of the points of K1's and K2's '/' edge case: a face or cell all of
#: whose points have it sums to less than 2^-60, outside the range in
#: which the kernels divide without a check
TINY_X = 1e-20
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
#: the iterations a dispatch of Smoother.steps with SMOOTHMESH_ITER_BATCH
#: unset
ITER_BATCH = 16
#: the device tables that the face angle adds (K5, K6, the fixed point)
FACE_ANGLE_KEYS = ("edges", "edge_faces", "edge_cells", "edge_cells_mask",
                   "edge_cell_f0", "edge_cell_f1", "edge_cell_words",
                   "point_edges", "point_edges_mask", "pps_signed",
                   "pe_flat")
#: phase 9: the halo's shards at 128^3 and 32^3, the iterations held
#: against the single device, and its tolerances there: frozen counts
#: and the points beyond HALO_POINT_TOL x the coordinate scale, each at
#: most HALO_COUNT_TOL x N; no point beyond HALO_POINT_MAX x the scale;
#: residuals relative
HALO_SHARDS = 4
HALO_ITERS = 8
HALO_COUNT_TOL = 1e-4
HALO_RES_TOL = 1e-3
HALO_POINT_TOL = 1e-5
HALO_POINT_MAX = 1e-4
#: DistSync's and DistPointSync's ranks (gloo, sharing cuda:0)
DIST_WORLD = 2
#: phase 10: the disjoint decomposition's shards at 128^3 and 32^3, and
#: the iterations held against the plain versions on the union and, with
#: the freezes off, against the single device
SHARDED_SHARDS = 4
SHARDED_ITERS = 8
NCCL_QUALITY_REL = 1e-12      # a rank's report against the union's
NCCL_TIMEOUT_S = 300
#: phase 11: float64 on the card (the plain versions, no kernel): the
#: iterations of the 32^3 runs against the CPU and of the 64^3
#: decompositions against the single device; the card against the CPU:
#: every point within F64_POINT_TOL x the coordinate scale, residuals
#: within F64_RES_TOL relative, the CLI's report within F64_REPORT_REL
#: relative (with an F64_REPORT_ABS floor for the report's values that
#: are float64 residues near 0: the skewness and the cell openness)
F64_ITERS = 8
F64_POINT_TOL = 1e-10
F64_RES_TOL = 1e-10
F64_REPORT_REL = 1e-9
F64_REPORT_ABS = 1e-12
F64_DEC_SIDE = 64


T_START = time.perf_counter()


def wall_clock(what: str) -> None:
    """Print the seconds since the script started, where ``what``
    starts (the phases' share of the command time)."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {what}", flush=True)


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
    """``td`` and the tables K2's and K4's plain versions read that the
    card's path does not stage (K2 reads the cell-face words, K4 the
    packed wedge words)."""
    from smoothmesh_torch.device import to_device

    missing = [k for k in K2_PLAIN_KEYS + K4_PLAIN_KEYS if k not in td]
    return {**td, **(to_device(topo, "cuda", missing) if missing else {})}


def bits_differing(got, want) -> int:
    """float32 values of ``got`` whose bits differ from ``want``'s."""
    return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for g, w in zip(got, want))


def k9_bytes_ops(td, n_points: int) -> tuple:
    """K9's work at its inputs -> (bytes, fp32 operations): every point
    reads its previous normal and is_internal_point and writes its normal
    and is_sharp (26 bytes); a boundary point also reads its point_faces
    row and mask, and the faces its masked slots name their real flag
    and, where selected, their area vector (each face counted once)."""
    bnd = ~td["is_internal_point"]
    rows, mask = td["point_faces"][bnd], td["point_faces_mask"][bnd]
    named = rows[mask].long()
    sel = named[td["face_is_real_boundary"][named]]
    n_rows = int(bnd.sum())
    n_bytes = (26 * n_points + 5 * n_rows * rows.shape[1]
               + int(torch.unique(named).numel())
               + 12 * int(torch.unique(sel).numel()))
    return n_bytes, K9_OPS * (n_points + int(sel.numel()))


def k9_differing(got, want) -> int:
    """Normals (float32) whose bits differ and is_sharp flags that differ
    between two (normals, is_sharp) pairs."""
    return (bits_differing(got[:1], want[:1])
            + int((got[1] != want[1]).sum()))


def exact_stages(stats: dict):
    """The plain stages, holding K1, K2, K4 and K5 bit for bit against
    their plain versions on every iteration's inputs: K1 on the
    iteration's points, K2 on its face geometry, K4 at the iteration's
    thresholds and at TIGHT_FREEZE, K5 on the iteration's face means
    and cell centres (also where the face angle is off), K9 on the
    iteration's normals and area vectors (where the boundary normals
    run).  Counts into ``stats``: K1 and K2 values not bit-equal, K4 mask
    mismatches, K5 values not bit-equal, K5's max abs err, points frozen
    at the tight thresholds, K9 values not bit-equal and is_sharp
    mismatches."""
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch import layers as lay
    from smoothmesh_torch.driver import PLAIN_STAGES, Stages
    from smoothmesh_torch.ops import constraints as con

    seen = {}
    for k in ("k1_bits", "k2_bits", "k4_mismatches", "k4_tight_frozen",
              "k5_bits", "k9_bits", "calls"):
        stats.setdefault(k, 0)
    stats.setdefault("k5_max_abs_err", 0.0)

    def face_geometry(*a):
        seen["fg"] = PLAIN_STAGES.face_geometry(*a)
        stats["k1_bits"] += bits_differing(geo.face_centres_areas(*a),
                                           seen["fg"])
        return seen["fg"]

    def cell_centres_vols(*a):
        out = PLAIN_STAGES.cell_centres_vols(*a)
        stats["k2_bits"] += bits_differing(geo.cell_centres_vols(*a), out)
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

    def point_normals(prev, areas, td, sync=None):
        out = PLAIN_STAGES.point_normals(prev, areas, td, sync)
        stats["k9_bits"] += k9_differing(
            lay.accumulate_point_normals(prev, areas, td, sync), out)
        return out

    return Stages(face_geometry, cell_centres_vols, PLAIN_STAGES.predictor,
                  freeze, PLAIN_STAGES.face_angles_per_point,
                  PLAIN_STAGES.ray_cast, point_normals)


def k1_k2_edge_cases(pts, fp, fm, fn, fg, td, td_p) -> dict:
    """K1 and K2 against their plain versions, bit for bit, on the paths
    the main inputs do not take: rows wider and narrower than the
    register paths' (face and cell rows padded to width 40, face rows
    cut to 3 points, cell rows to 5 faces: the general paths), 2,000
    points moved to x = TINY_X (faces and cells among
    them sum to less than 2^-60, so the kernels redo the division with
    '/'; faces across x collapse, area <= ROOT_VSMALL, and take the
    vertex mean), every area vector negated (negative volumes: '/'
    again) and the first 1,000 cells' area vectors zeroed (|vol| <=
    VSMALL: the centre estimate)."""
    from smoothmesh_torch import geometry as geo

    out = {}

    def k1(name, args, extra=None):
        got = geo.face_centres_areas(*args)
        want = geo.face_centres_areas_plain(*args)
        bits = bits_differing(got, want)
        require(bits == 0, f"K1 ({name}): {bits} values not bit-equal")
        out[f"K1 {name}"] = dict(values_not_bit_equal=bits, **(extra or {}))
        return want

    def k2(name, fg_, words=None, cf=None, cfm=None, extra=None):
        td_k = td if words is None else {**td, "cell_face_words": words}
        tdp = td_p if cf is None else {**td_p, "cell_faces": cf,
                                       "cell_faces_mask": cfm}
        got = geo.cell_centres_vols(fg_, td_k)
        want = geo.cell_centres_vols_plain(fg_, tdp)
        bits = bits_differing(got, want)
        require(bits == 0, f"K2 ({name}): {bits} values not bit-equal")
        out[f"K2 {name}"] = dict(values_not_bit_equal=bits, **(extra or {}))
        return want

    pad = 40 - fp.shape[1]
    k1("face rows padded to width 40", (
        pts, torch.nn.functional.pad(fp, (0, pad)),
        torch.nn.functional.pad(fm, (0, pad)), fn))
    k1("face rows cut to width 3", (
        pts, fp[:, :3].contiguous(), fm[:, :3].contiguous(),
        fn.clamp_max(3)))
    tiny = pts.clone()
    tiny[:2000, 0] = TINY_X
    fg_t = geo.face_centres_areas_plain(tiny, fp, fm, fn)
    slow = ((fg_t.means.abs() < 2.0 ** -60) & (fg_t.means != 0)).any(1)
    flat = (fg_t.areas == 0).all(1)
    require(int(slow.sum()) > 0 and int(flat.sum()) > 0,
            f"K1 (x = {TINY_X}): {int(slow.sum())} faces on the '/' path, "
            f"{int(flat.sum())} degenerate")
    k1(f"2000 points at x = {TINY_X}", (tiny, fp, fm, fn),
       dict(faces_on_the_slow_path=int(slow.sum()),
            degenerate_faces=int(flat.sum())))

    cfw, cf, cfm = (td["cell_face_words"], td_p["cell_faces"],
                    td_p["cell_faces_mask"])
    pad = 40 - cfw.shape[1]
    k2("cell rows padded to width 40", fg,
       torch.nn.functional.pad(cfw, (0, pad), value=-1),
       torch.nn.functional.pad(cf, (0, pad)),
       torch.nn.functional.pad(cfm, (0, pad)))
    k2("cell rows cut to width 5", fg, cfw[:, :5].contiguous(),
       cf[:, :5].contiguous(), cfm[:, :5].contiguous())
    cc_t, _ = geo.cell_centres_vols_plain(fg_t, td_p)
    slow = ((cc_t.abs() < 2.0 ** -60) & (cc_t != 0)).any(1)
    require(int(slow.sum()) > 0, f"K2 (x = {TINY_X}): no cell on the '/' "
            "path")
    k2(f"the faces of 2000 points at x = {TINY_X}", fg_t,
       extra=dict(cells_on_the_slow_path=int(slow.sum())))
    neg = geo.FaceGeometry(fg.centres, -fg.areas, fg.means)
    _, vol = k2("every area vector negated", neg)
    require(bool((vol < 0).all()), "K2: negated areas left a positive volume")
    zero = fg.areas.clone()
    zero[cf[:1000][cfm[:1000]].long()] = 0.0
    _, vol = k2("the first 1000 cells' area vectors zeroed",
                geo.FaceGeometry(fg.centres, zero, fg.means))
    require(bool((vol[:1000] == 0).all()), "K2: a zeroed cell has a volume")
    for k, v in out.items():
        print(f"{k}: bit-equal to its plain version ({v})", flush=True)
    return out


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

    # K9 on the first iteration's inputs
    (prev9, areas9, _, _), got9 = rec["point_normals"]
    want9 = lay.accumulate_point_normals_plain(prev9, areas9, td)
    k9_first = k9_differing(got9, want9)
    require(k9_first == 0, f"K9 at {MAIN_SIDE}^3 (first iteration's "
            f"inputs): {k9_first} values or flags differ (held bit for bit)")
    k9_ms = device_ms(lambda: lay.accumulate_point_normals(
        prev9, areas9, td), 20)
    k9_work = k9_bytes_ops(td, N)
    k9_b_ms, k9_b_by = bound(*k9_work)
    regs9, smem9, spill9 = resources_of(kernels.POINT_NORMALS,
                                        "point_normals_kernel")
    k9_launch = dict(blocks=-(-N // K9_THREADS), threads=K9_THREADS,
                     registers=regs9, static_shared_bytes=smem9,
                     spilled_bytes=spill9)
    print(f"K9 point_normals at {MAIN_SIDE}^3 (first iteration's inputs): "
          f"bit-equal to the plain version ({int(want9[1].sum())} sharp, "
          f"{int((~td['is_internal_point']).sum())} boundary points of "
          f"{N}); kernel {k9_ms:.4f} ms, bound {k9_b_ms:.4f} ms ({k9_b_by},"
          f" {k9_work[0] / 1e6:.1f} MB); launch {k9_launch['blocks']} "
          f"blocks of {K9_THREADS} threads, one point a thread; {regs9} "
          f"registers, {smem9} bytes shared, {spill9} bytes spilled on "
          f"{smi}", flush=True)
    del got9, want9

    # the boundary stages in plain PyTorch (K8 inside the projection)
    pts, fg = sb.points, rec["face_geometry"][1]
    prop = rec["predictor"][1][0]
    max_step = p.max_step_length * sb._scale
    normals, sharp = lay.accumulate_point_normals_plain(sb.normals,
                                                        fg.areas, td)

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
        ("normals", lambda: lay.accumulate_point_normals_plain(
            sb.normals, fg.areas, td)),
        ("layer blend", blend), ("boundary projection", project),
        ("prismatic projection", prismatic))}
    print("boundary stages (plain PyTorch, first iteration's inputs, "
          "device ms): " + ", ".join(f"{k} {v:.4f}"
                                     for k, v in stage_ms.items())
          + f"; {sum(stage_ms.values()):.4f} in all, of which K8 "
          f"{ms:.4f}; K9 {k9_ms:.4f} in place of the plain normals",
          flush=True)
    del rec, prop, prop_l, prop_b, normals, sharp, fg, got, want
    del prev9, areas9

    # the path itself
    top = rows.cpu().numpy()

    def dome_err():
        q = sb.denormalize()[top]
        return float(np.abs(q[:, 2] - dome_z(np.clip(q[:, 0], 0, 1),
                                             np.clip(q[:, 1], 0, 1))).max())

    err_before = dome_err()
    run = batched_against_one_by_one(
        sb, MAIN_ITERS, f"boundary path at {MAIN_SIDE}^3", smi,
        {k: 0 if k is kernels.TABLE_GATHER else MAIN_ITERS
         for k in kernels.ALL})
    steps, launches, t_run = run["steps"], run["launches"], run["t_run"]
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
    _, vol = geo.cell_centres_vols(fgn, td)
    vmin = float(vol.min())
    require(vmin > 0, f"cell volume {vmin} at the end of the boundary path")
    # K9 on the state the batched iterations left
    after = (lay.accumulate_point_normals(sb.normals, fgn.areas, td),
             lay.accumulate_point_normals_plain(sb.normals, fgn.areas, td))
    k9_after = k9_differing(*after)
    require(k9_after == 0, f"K9 at {MAIN_SIDE}^3 after {MAIN_ITERS} "
            f"batched iterations: {k9_after} values or flags differ")
    print(f"K9 at {MAIN_SIDE}^3 after {MAIN_ITERS} batched iterations: "
          f"bit-equal to the plain version ({int(after[1][1].sum())} sharp)",
          flush=True)
    del after
    walls = [r.wall_ms for r in steps]
    iter_ms = float(np.mean(walls))
    print(f"boundary path (layers + boundary smoothing), batched: "
          f"{MAIN_ITERS} iterations in {t_run:.2f} s; {iter_ms:.3f} "
          f"ms/iteration (median"
          f" {np.median(walls):.3f}, max {max(walls):.3f} at iteration "
          f"{int(np.argmax(walls)) + 1} of {len(walls)}), "
          f"{N / (iter_ms / 1e3):,.0f} point-updates/s on {smi}; nFrozen "
          f"{steps[0].n_frozen} -> {steps[-1].n_frozen}, ray misses "
          f"{sum(r.n_ray_miss for r in steps)} in all; largest |z - dome|"
          f" over the free top points {err_before:.6g} -> {err_after:.6g};"
          f" peak device memory {run['peak_gb']:.2f} GB; min cell "
          f"volume {vmin:.4g} (normalized units)", flush=True)
    return dict(record=dict(
        name=kernels.RAYCAST.name, route="cuda",
        source=f"smoothmesh_torch/csrc/{kernels.RAYCAST.source}",
        replaces=kernels.RAYCAST.replaces, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bytes=work[0], ops=work[1], rays_differing=n_differ,
        random_soup_rays_differing=r_differ, edge_cases=edges,
        launch=launch), launches=launches, k3_share_test_points=n_share,
        ms_one=run["ms_one"], ms_batched=run["ms_batched"],
        k9_record=dict(
            name=kernels.POINT_NORMALS.name, route="cuda",
            source=f"smoothmesh_torch/csrc/{kernels.POINT_NORMALS.source}",
            replaces=kernels.POINT_NORMALS.replaces, max_abs_err=0.0,
            ms=k9_ms, plain_ms=stage_ms["normals"], bound_ms=k9_b_ms,
            bound_by=k9_b_by, library_ms=None, bytes=k9_work[0],
            ops=k9_work[1], values_differing_first=k9_first,
            values_differing_after=k9_after, launch=k9_launch))

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


@contextlib.contextmanager
def setup_timers():
    """Time the host set-up's parts: the spatial reorder, the topology
    compile and the three word packings -> {part: seconds}."""
    from smoothmesh_torch import device, driver

    timers = {}
    with contextlib.ExitStack() as stack:
        for mod, name, key in (
                (driver, "permute_mesh", "reorder"),
                (driver, "compile_topology", "topology compile (native)"),
                (device, "pack_wedges", "pack_wedges"),
                (device, "pack_edge_cells", "pack_edge_cells"),
                (device, "pack_cell_faces", "pack_cell_faces")):
            timers[key] = 0.0
            stack.enter_context(timed(timers, mod, name, key))
        yield timers


@contextlib.contextmanager
def host_reads_and_replays():
    """Count the host synchronizations (torch's sync debug mode "warn"
    warns at each) and the CUDA-graph replays, each replay run under
    "error" (any synchronization in it raises) -> a dict whose
    "syncs" and "replays" hold the counts after the block."""
    from smoothmesh_torch import kernels

    seen = {"syncs": 0, "replays": 0}
    orig = kernels.Graph.replay

    def replay(self):
        outer = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            orig(self)
        finally:
            torch.cuda.set_sync_debug_mode(outer)
        seen["replays"] += 1

    prev = torch.cuda.get_sync_debug_mode()
    kernels.Graph.replay = replay
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield seen
            finally:
                torch.cuda.set_sync_debug_mode(prev)
            # the mode's own notice ("... does not yet detect all
            # synchronizing operations") is not a synchronization
            where = [f"{os.path.basename(w.filename)}:{w.lineno}"
                     for w in caught if "called a synchronizing CUDA "
                     "operation" in str(w.message)]
            seen["syncs"], seen["where"] = len(where), where
    finally:
        kernels.Graph.replay = orig


def same_runs(a, b) -> bool:
    return [(r.iteration, r.residual, r.n_frozen, r.n_ray_miss)
            for r in a] == [(r.iteration, r.residual, r.n_frozen,
                             r.n_ray_miss) for r in b]


def batched_against_one_by_one(sm, n: int, label: str, smi: str,
                               want_launches: dict) -> dict:
    """Phases 4 and 5: ``sm.steps(n)`` one iteration a dispatch, then
    from the same start in batches of ITER_BATCH (CUDA-graph replays):
    bit-equal points and normals, equal results, two host reads for
    n = 32, the replays free of synchronizations, each kernel launched
    ``want_launches[kernel]`` times in both runs -> the batched run's
    results and launches, the times and the memory."""
    from smoothmesh_torch import kernels

    require(sm.iter_batch == ITER_BATCH, f"iter_batch {sm.iter_batch}: "
            "SMOOTHMESH_ITER_BATCH is set")
    start = (sm.points.clone(), sm.normals.clone(), sm._iteration)
    sm.iter_batch = 1
    kernels.reset_launches()
    wall_clock(f"{label}: one by one")
    t0 = time.perf_counter()
    one = sm.steps(n)
    t_one = time.perf_counter() - t0
    wall_clock(f"{label}: capture")
    launches_one = {k: k.launches for k in kernels.ALL}
    pts_one, nrm_one = sm.points, sm.normals
    sm.points, sm.normals = start[0].clone(), start[1].clone()
    sm._iteration = start[2]
    sm.iter_batch = ITER_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_capture = sm.prepare_batch()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    kernels.reset_launches()
    wall_clock(f"{label}: batched")
    with host_reads_and_replays() as seen:
        t0 = time.perf_counter()
        batched = sm.steps(n)
        t_batched = time.perf_counter() - t0
        wall_clock(f"{label}: batched, host reads counted")
    wall_clock(f"{label}: checks")
    launches = {k: k.launches for k in kernels.ALL}
    peak = torch.cuda.max_memory_allocated()
    require(len(one) == len(batched) == n, f"{label}: {len(one)} and "
            f"{len(batched)} iterations ran")
    require(same_runs(one, batched), f"{label}: the batched results "
            "differ from the one-by-one ones")
    require(torch.equal(pts_one, sm.points)
            and torch.equal(nrm_one, sm.normals),
            f"{label}: the batched points or normals are not bit-equal "
            "to the one-by-one ones "
            f"({bits_differing([sm.points], [pts_one])} values differ)")
    want_reads = -(-n // ITER_BATCH)
    require(seen["syncs"] == want_reads and seen["replays"] == n
            and sm.face_angle_stops == 0,
            f"{label}: {seen['syncs']} host reads (want {want_reads}; at "
            f"{', '.join(seen['where'])}), "
            f"{seen['replays']} replays, {sm.face_angle_stops} face-angle "
            "stops")
    for run, counts in (("one by one", launches_one), ("batched", launches)):
        for k, c in counts.items():
            require(c == want_launches[k], f"{label} ({run}): {k.name} "
                    f"launched {c} times in {n} iterations")
    ms_one = [r.wall_ms for r in one]
    ms_b = [r.wall_ms for r in batched]
    print(f"{label}, steps({n}): one iteration a dispatch {t_one:.3f} s, "
          f"median {np.median(ms_one):.4f} ms/iteration (mean "
          f"{np.mean(ms_one):.4f}); in batches of {ITER_BATCH} "
          f"{t_batched:.3f} s, {np.median(ms_b):.4f} ms/iteration (batch "
          f"walls over their iterations: "
          f"{', '.join(f'{w:.4f}' for w in sorted(set(ms_b)))}); graph "
          f"capture (with its warm-up iteration) {t_capture:.3f} s; "
          f"{seen['syncs']} host reads, {seen['replays']} replays under "
          f"sync debug 'error'; bit-equal; peak device memory over the "
          f"capture and the batched run {peak / 1e9:.2f} GB, reserved "
          f"after the capture {reserved / 1e9:.2f} GB; on {smi}",
          flush=True)
    return dict(steps=batched, launches=launches, launches_one=launches_one,
                ms_one=float(np.median(ms_one)),
                ms_batched=float(np.median(ms_b)), capture_s=t_capture,
                peak_gb=peak / 1e9, t_run=t_batched)


def small_batched_against_one_by_one(sk, n: int, label: str) -> tuple:
    """Phase 6: ``sk.steps(n)`` in batches, then one iteration a
    dispatch from the same start: bit-equal -> (the batched results,
    its face-angle stops); sk keeps the batched state."""
    start = (sk.points.clone(), sk.normals.clone(), sk._iteration)
    stops = sk.face_angle_stops
    batched = sk.steps(n)
    stops = sk.face_angle_stops - stops
    state = (sk.points, sk.normals, sk._iteration)
    sk.points, sk.normals = start[0].clone(), start[1].clone()
    sk._iteration, sk.iter_batch = start[2], 1
    one = sk.steps(n)
    require(same_runs(one, batched) and torch.equal(sk.points, state[0])
            and torch.equal(sk.normals, state[1]),
            f"{label}: batched and one by one differ")
    sk.points, sk.normals, sk._iteration = state
    sk.iter_batch = ITER_BATCH
    print(f"{label}: steps({n}) in batches of {ITER_BATCH} bit-equal to one "
          f"iteration a dispatch, {stops} face-angle stop(s)", flush=True)
    return batched, stops


def native_tables_check(sm, smi: str) -> None:
    """Phase 2: the Smoother's (native) topology left-packed, and the
    numpy path's compile of the same mesh timed and held to it: equal
    edge counts and shapes, equal row counts in every table whose rows
    are points, faces or cells (the native path only orders edges and
    row entries by first appearance)."""
    from smoothmesh_torch.mesh.topology import (compile_topology,
                                                rows_not_left_packed)

    topo = sm.topo
    bad = rows_not_left_packed(topo)
    require(not bad, f"native tables not left-packed: {bad}")
    t0 = time.perf_counter()
    ref = compile_topology(sm.mesh_internal, use_native=False)
    t_numpy = time.perf_counter() - t0
    require(ref.n_edges == topo.n_edges, f"{topo.n_edges} edges (native) "
            f"vs {ref.n_edges} (numpy)")
    for f in dataclasses.fields(topo):
        a, b = getattr(topo, f.name), getattr(ref, f.name)
        if isinstance(a, np.ndarray):
            require(a.shape == b.shape, f"{f.name}: {a.shape} (native) vs "
                    f"{b.shape} (numpy)")
    for name in ("face_mask", "point_points_mask", "point_cells_mask",
                 "point_faces_mask", "point_edges_mask", "cell_faces_mask"):
        require(np.array_equal(getattr(topo, name).sum(axis=1),
                               getattr(ref, name).sum(axis=1)),
                f"{name}: row counts differ between the two paths")
    require(np.array_equal(np.sort(topo.point_points, axis=1),
                           np.sort(ref.point_points, axis=1)),
            "point_points differ between the two paths")
    print(f"topology at {MAIN_SIDE}^3: the numpy path {t_numpy:.2f} s "
          f"(host clock; the native one in the set-up split above); native "
          f"rows left-packed, {topo.n_edges} edges and the row counts equal "
          f"on both paths; host of {smi}", flush=True)


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
            parts = stack.enter_context(setup_timers())
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
    print("CLI set-up split: " + ", ".join(f"{k} {v:.2f} s"
                                           for k, v in parts.items())
          + f", the rest {split['setup'] - sum(parts.values()):.2f} s "
          "(upload, mesh stats, layer maps, boundary classification)",
          flush=True)
    return dict(launches=launches, wall_s=t_cli, split_s=split,
                setup_split_s=parts, report=reports[0])


def halo_compare(label: str, got, want, n: int, got_pts, want_pts,
                 scale: float) -> dict:
    """Phase 9: a halo run against the single-device run of the same
    start: frozen counts within HALO_COUNT_TOL * n, residuals within
    HALO_RES_TOL relative, all but HALO_COUNT_TOL * n points within
    HALO_POINT_TOL * ``scale`` (the coordinate scale) and every point
    within HALO_POINT_MAX * ``scale`` -> the largest differences and
    the count of points bit-equal."""
    require(len(got) == len(want), f"{label}: {len(got)} and {len(want)} "
            "iterations ran")
    d_frozen = max(abs(a.n_frozen - b.n_frozen) for a, b in zip(got, want))
    d_res = max(abs(a.residual - b.residual) / max(abs(b.residual), 1e-30)
                for a, b in zip(got, want))
    dist = np.linalg.norm(got_pts - want_pts, axis=1)
    far = int((dist > HALO_POINT_TOL * scale).sum())
    require(d_frozen <= HALO_COUNT_TOL * n and d_res <= HALO_RES_TOL
            and far <= HALO_COUNT_TOL * n
            and float(dist.max()) <= HALO_POINT_MAX * scale,
            f"{label}: frozen counts {d_frozen} apart, residuals "
            f"{d_res:.3g} relative, {far} points beyond "
            f"{HALO_POINT_TOL} x {scale:.4g}, the farthest "
            f"{float(dist.max()):.3g}")
    return dict(frozen=d_frozen, residual_rel=d_res, far_points=far,
                max_point_diff=float(dist.max()),
                points_bit_equal=int((got_pts == want_pts).all(1).sum()))


def halo_phase(mesh, mesh_int, topo, orders, smi: str) -> dict:
    """Phase 9: the halo decomposition (smoothmesh_torch.parallel) ->
    its launches at 128^3 (K1-K6 in the batched steps, K7 in its
    quality report) and in the 32^3 boundary run (K8), and its
    figures."""
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch import kernels
    from smoothmesh_torch.device import to_device
    from smoothmesh_torch.driver import Smoother, iteration_body
    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.ranks import Job, run_ranks
    from smoothmesh_torch.params import SmoothingParams
    from smoothmesh_torch.quality import (CUDA_QUALITY_TD_KEYS,
                                          quality_report)
    from smoothmesh_torch.testcases import bench_dome_geometry

    out = {}
    N = mesh.n_points
    params = SmoothingParams(centroidal_iters=MAIN_ITERS, rel_tol=0.0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hs = HaloSmoother(mesh, params, n_shards=HALO_SHARDS, device="cuda")
    t_setup = time.perf_counter() - t0
    U = hs.topo.n_points
    n_pairs = int(hs.sync.rows.numel())
    print(f"halo at {MAIN_SIDE}^3, {HALO_SHARDS} shards (UnionSync): union "
          f"{U} points = {U / N:.4f} N, {hs.topo.n_cells} cells, "
          f"{hs.topo.n_faces} faces, {hs.topo.n_edges} edges; "
          f"{hs.sync.n_slots} shared points in {n_pairs} (point, holder) "
          f"rows; set-up {t_setup:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in hs.setup_times.items())
          + " (the compiles are inside the shard build)", flush=True)
    out.update(union_over_n=U / N, setup_s=t_setup,
               setup_parts=dict(hs.setup_times), shared_points=hs.sync.n_slots)
    start = (hs.points.clone(), hs.normals.clone())

    wall_clock("phase 9: against the single device")
    # -- against the single-device run, 8 iterations
    single = Smoother(mesh_int, dataclasses.replace(
        params, centroidal_iters=HALO_ITERS), topo=topo, device="cuda")
    want = single.steps(HALO_ITERS)
    want_pts = single.denormalize()[orders.point_new]
    single_centre = (single._center, single._scale)
    del single
    torch.cuda.empty_cache()
    got = hs.steps(HALO_ITERS)
    got_pts = hs.denormalize()
    out["vs_single"] = halo_compare(
        f"halo {MAIN_SIDE}^3 against the single device", got, want, N,
        got_pts, want_pts, float(np.abs(want_pts).max()))
    fg = geo.face_centres_areas(hs.points, hs.td["face_points"],
                                hs.td["face_mask"], hs.td["face_npoints"])
    vmin = float(geo.cell_centres_vols(fg, hs.td)[1].min())
    require(vmin > 0, f"halo {MAIN_SIDE}^3: cell volume {vmin}")
    del fg
    print(f"halo {MAIN_SIDE}^3 x {HALO_ITERS} against the single device "
          f"from the same start: {out['vs_single']}; frozen "
          f"{[r.n_frozen for r in got]} vs {[r.n_frozen for r in want]}; "
          f"min cell volume {vmin:.4g}", flush=True)

    # -- again from the single device's centring (its mean over its own
    # point order rounds otherwise than the halo's): what is left apart
    # is the shards' own stencil orders
    centre = hs._center
    require(single_centre[1] == hs._scale, f"halo {MAIN_SIDE}^3: scale "
            f"{hs._scale} against the single device's {single_centre[1]}")
    hs.points = hs._tensor((hs.union.points - single_centre[0]) * hs._scale,
                           hs.dtype)
    hs.normals = start[1].clone()
    hs._iteration = 0
    hs._center = single_centre[0]
    got_c = hs.steps(HALO_ITERS)
    pts_c = hs.denormalize()
    hs._center = centre
    out["vs_single_same_centre"] = halo_compare(
        f"halo {MAIN_SIDE}^3 from the single device's centring", got_c, want,
        N, pts_c, want_pts, float(np.abs(want_pts).max()))
    print(f"halo {MAIN_SIDE}^3 x {HALO_ITERS} against the single device, "
          f"from its centring (differs from the halo's by "
          f"{np.abs(single_centre[0] - centre).max():.3g}): "
          f"{out['vs_single_same_centre']}", flush=True)
    del got_c, pts_c

    wall_clock("phase 9: plain versions on the union")
    # -- the same 8 iterations through the plain versions on the union
    td_p = with_plain_tables(hs.td, hs.topo)
    pts_p = start[0].clone()
    exact = {}
    for i, r in enumerate(got):
        pts_p, _, res_p, nf_p, _, _ = iteration_body(
            pts_p, td_p, hs.params, hs._scale, exact_stages(exact),
            sync=hs.sync, owned=hs.owned)
        res_p, nf_p = float(res_p), int(nf_p)
        where = f"halo {MAIN_SIDE}^3 plain, iteration {i + 1}"
        require(abs(r.residual - res_p) < 2e-3, f"{where}: residual "
                f"{r.residual} (kernels) vs {res_p} (plain)")
        require(abs(r.n_frozen - nf_p) <= 0.1 * nf_p + 10, f"{where}: "
                f"nFrozen {r.n_frozen} (kernels) vs {nf_p} (plain)")
    require(exact["calls"] == HALO_ITERS and exact["k1_bits"] == 0
            and exact["k2_bits"] == 0 and exact["k4_mismatches"] == 0
            and exact["k5_bits"] == 0,
            f"halo {MAIN_SIDE}^3: K1, K2, K4 and K5 against their plain "
            f"versions on each iteration's inputs: {exact}")
    print(f"halo {MAIN_SIDE}^3 x {HALO_ITERS} through the plain versions "
          f"on the union: agree (last residual {got[-1].residual:.6g} vs "
          f"{res_p:.6g}, nFrozen {got[-1].n_frozen} vs {nf_p}); K1, K2, K5 "
          f"bit-equal and K4 without a mismatch on every iteration's "
          f"inputs: {exact}", flush=True)
    del td_p, pts_p
    out["plain_exact"] = exact

    wall_clock("phase 9: batched against one by one")
    # -- steps(32) batched against one iteration a dispatch
    hs.points, hs.normals = start[0].clone(), start[1].clone()
    hs._iteration = 0
    torch.cuda.synchronize()
    out["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9
    print(f"halo {MAIN_SIDE}^3: {out['allocated_before_gb']:.3f} GB "
          f"allocated before steps(32) (device topology "
          f"{nbytes(*hs.td.values()) / 1e9:.3f} GB)", flush=True)
    run = batched_against_one_by_one(
        hs, MAIN_ITERS, f"halo {MAIN_SIDE}^3, {HALO_SHARDS} shards", smi,
        {k: (0 if k in (kernels.RAYCAST, kernels.TABLE_GATHER,
                        kernels.POINT_NORMALS)
             else MAIN_ITERS) for k in kernels.ALL})
    out.update(ms_batched=run["ms_batched"], ms_one=run["ms_one"],
               peak_gb=run["peak_gb"], capture_s=run["capture_s"])
    launches = dict(run["launches"])

    # -- the exchanges' device time an iteration: one consensus of the
    # proposal, the two ORs of the freeze mask
    sync, owned = hs.sync, hs.owned
    prop = hs.points + 0.25
    frozen = hs.points[:, 0] > 0

    def exchanges():
        sync.consensus(prop)
        f = sync.or_(frozen & owned)
        sync.or_(f)

    wall_clock("phase 9: the exchanges' time")
    eager_ms = device_ms(exchanges, 20)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        exchanges()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        exchanges()
    x_ms = device_ms(graph.replay, 20)
    del graph
    out.update(exchange_ms=x_ms, exchange_eager_ms=eager_ms,
               exchange_share=x_ms / run["ms_batched"])
    print(f"halo {MAIN_SIDE}^3: the exchanges (one consensus, two ORs) "
          f"{x_ms:.4f} ms of device time an iteration as a graph replay "
          f"({100 * x_ms / run['ms_batched']:.2f}% of the batched "
          f"{run['ms_batched']:.4f} ms/iteration), {eager_ms:.4f} ms "
          f"launched one by one, on {smi}", flush=True)
    del prop, frozen

    wall_clock("phase 9: quality")
    # -- quality() from the claims against the global report
    hs.quality()                               # stages its tables
    kernels.reset_launches()
    t0 = time.perf_counter()
    rep = hs.quality()
    torch.cuda.synchronize()
    q_ms = (time.perf_counter() - t0) * 1e3
    launches[kernels.TABLE_GATHER] = kernels.TABLE_GATHER.launches
    require(kernels.TABLE_GATHER.launches == 1,
            f"halo quality(): K7 launched {kernels.TABLE_GATHER.launches}")
    ext = hs.denormalize()[orders.point_old]   # mesh_int's order
    td_g = to_device(topo, "cuda", CUDA_QUALITY_TD_KEYS)
    rep0 = quality_report(torch.tensor((ext - hs._center) * hs._scale,
                                       dtype=torch.float32, device=hs.device),
                          td_g)
    s = hs._scale
    for k in ("min_edge_length", "max_edge_length"):
        rep0[k] /= s
    for k in ("min_volume", "max_volume", "total_volume",
              "min_pyramid_volume"):
        rep0[k] /= s ** 3
    bad = [k for k, v in rep0.items()
           if (rep[k] != v if isinstance(v, int)
               else abs(rep[k] - v) > 5e-4 * abs(v) + 1e-5)]
    require(not bad, f"halo quality(): {bad} differ from the global "
            f"report: {[(k, rep[k], rep0[k]) for k in bad]}")
    require(rep["n_negative_volumes"] == 0, "halo: negative volumes")
    print(f"halo {MAIN_SIDE}^3 quality() from the claims in {q_ms:.1f} ms: "
          f"equal to the global report (integers equal, the rest within "
          f"5e-4 relative + 1e-5): min face angle "
          f"{rep['min_face_angle_deg']:.4f} deg, max non-orthogonality "
          f"{rep['max_non_ortho_deg']:.4f}", flush=True)
    out["quality_ms"] = q_ms
    del hs, td_g, start, run, sync, owned
    torch.cuda.empty_cache()

    wall_clock("phase 9: 32^3 one shard")
    # -- 32^3, one shard from the single device's centring: the union's
    # build and the hooks change no bit of the single-device run
    small = bench_mesh(SMALL_SIDE)
    p1 = SmoothingParams(centroidal_iters=SMALL_ITERS, rel_tol=0.0)
    s1 = Smoother(small, p1, device="cuda")
    want = s1.steps(SMALL_ITERS)
    h1 = HaloSmoother(small, p1, n_shards=1, device="cuda")
    require(h1._scale == s1._scale, f"halo {SMALL_SIDE}^3, one shard: scale "
            f"{h1._scale} against the single device's {s1._scale}")
    h1.points = h1._tensor((h1.union.points - s1._center) * h1._scale,
                           h1.dtype)
    h1._center = s1._center
    got = h1.steps(SMALL_ITERS)
    require([dataclasses.astuple(r)[:3] for r in got]
            == [dataclasses.astuple(r)[:3] for r in want]
            and np.array_equal(h1.denormalize(), s1.denormalize()),
            f"halo {SMALL_SIDE}^3, one shard, from the single device's "
            f"centring: not bit-equal to it ({got[-1]} vs {want[-1]})")
    print(f"halo {SMALL_SIDE}^3 x {SMALL_ITERS}, one shard from the single "
          f"device's centring: points, residuals and frozen counts "
          f"bit-equal to the single device", flush=True)
    del s1, h1

    wall_clock("phase 9: 32^3 boundary")
    # -- 32^3 boundary configuration, 4 shards against the single device
    bparams = dataclasses.replace(boundary_params(SMALL_ITERS),
                                  max_step_length=SMALL_BND_MAX_STEP)
    geom = bench_dome_geometry()[1:]
    sk = Smoother(small, bparams, device="cuda")
    sk.enable_boundary_smoothing(*geom)
    want = sk.steps(SMALL_ITERS)
    want_pts = sk.denormalize()
    hb = HaloSmoother(small, bparams, n_shards=HALO_SHARDS, device="cuda")
    hb.enable_boundary_smoothing(*geom)
    hb.prepare_batch()
    kernels.reset_launches()
    got = hb.steps(SMALL_ITERS)
    launches_bnd = {k: k.launches for k in kernels.ALL}
    for a, b in zip(got, want):
        require(abs(a.residual - b.residual) < 2e-3
                and abs(a.n_frozen - b.n_frozen) <= 0.1 * b.n_frozen + 10
                and a.n_ray_miss == b.n_ray_miss and a.residual < 1.0,
                f"halo {SMALL_SIDE}^3 boundary, iteration {a.iteration}: "
                f"{a} vs {b}")
    moved = float(np.abs(hb.denormalize() - want_pts).max()) * hb._scale
    require(moved < BND_POINT_TOL, f"halo {SMALL_SIDE}^3 boundary: points "
            f"{moved} apart at the end (normalized units)")
    require(launches_bnd[kernels.RAYCAST] == SMALL_ITERS,
            f"halo {SMALL_SIDE}^3 boundary: K8 launched "
            f"{launches_bnd[kernels.RAYCAST]} times")
    launches[kernels.RAYCAST] = launches_bnd[kernels.RAYCAST]
    print(f"halo {SMALL_SIDE}^3 x {SMALL_ITERS}, boundary configuration "
          f"(max step {SMALL_BND_MAX_STEP}), {HALO_SHARDS} shards against "
          f"the single device: agree (last residual {got[-1].residual:.6g} "
          f"vs {want[-1].residual:.6g}, nFrozen {got[-1].n_frozen} vs "
          f"{want[-1].n_frozen}, ray misses {got[-1].n_ray_miss} vs "
          f"{want[-1].n_ray_miss}; largest point difference {moved:.3g} "
          f"normalized units); launches "
          f"{ {k.name: v for k, v in launches_bnd.items() if v} }",
          flush=True)
    del sk, hb

    wall_clock("phase 9: DistSync")
    # -- DistSync: 2 gloo ranks in 2 processes on cuda:0 against UnionSync
    dparams = SmoothingParams(centroidal_iters=SMALL_ITERS, rel_tol=0.0)
    hu = HaloSmoother(small, dparams, n_shards=DIST_WORLD, device="cuda")
    want = [dataclasses.astuple(r) for r in hu.steps(SMALL_ITERS)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(Job(small, dparams, SMALL_ITERS, backend="gloo"),
                          DIST_WORLD, tmp, timeout_s=300)
        t_dist = time.perf_counter() - t0
    base = hu.union.base[:, 0]
    for rank, r in enumerate(ranks):
        require([x[:3] + x[4:] for x in r["results"]]
                == [x[:3] + x[4:] for x in want],
                f"DistSync rank {rank}: results differ from UnionSync's")
        require(torch.equal(r["points"],
                            hu.points[base[rank]:base[rank + 1]].cpu()),
                f"DistSync rank {rank}: points not bit-equal to UnionSync's")
        require(np.array_equal(r["denormalized"], hu.denormalize()),
                f"DistSync rank {rank}: the global points differ")
    print(f"halo {SMALL_SIDE}^3 x {SMALL_ITERS}, DistSync ({DIST_WORLD} gloo "
          f"ranks in {DIST_WORLD} processes on cuda:0) against UnionSync "
          f"({DIST_WORLD} shards): points, residuals and counts bit-equal "
          f"(last residual {want[-1][1]:.6g}, nFrozen {want[-1][2]}); "
          f"the ranks took {t_dist:.1f} s with their start-up", flush=True)
    out["launches"] = launches
    return out


def holders_identical(sm) -> bool:
    """Phase 10: every holder of a shared point holds its owner's bits."""
    rows = sm.sync.rows
    own = torch.as_tensor(sm.union.owner_rows(), device=rows.device)
    return torch.equal(sm.points[rows], sm.points[own])


def k3_unshared_stage(stats: dict, shared_rows, td_k3):
    """Phase 10: the plain predictor, K3 held beside it on the same
    inputs, on the rows no other shard holds (where K3 is the path's
    result), like a mask: the points beyond FIELD_TOL of the scaled
    error, counted into ``stats``."""
    from smoothmesh_torch.driver import PLAIN_STAGES
    from smoothmesh_torch.ops import smoothing as smo

    stats.setdefault("k3_unshared_beyond", 0)
    stats.setdefault("k3_unshared_scaled_err", 0.0)

    def predictor(points, cell_ctrs, td, *args):
        want = PLAIN_STAGES.predictor(points, cell_ctrs, td, *args)
        got = smo.predictor(points, cell_ctrs, td_k3, *args)
        keep = torch.ones(points.shape[0], dtype=torch.bool,
                          device=points.device)
        keep[shared_rows] = False
        per_pt = torch.maximum((got[0] - want[0]).abs().amax(1),
                               (got[1] - want[1]).abs())[keep]
        per_pt = per_pt / float(want[0].abs().max())
        stats["k3_unshared_beyond"] = max(stats["k3_unshared_beyond"],
                                          int((per_pt > FIELD_TOL).sum()))
        stats["k3_unshared_scaled_err"] = max(
            stats["k3_unshared_scaled_err"], float(per_pt.max()))
        return want

    return predictor


def sharded_phase(mesh, mesh_int, topo, orders, smi: str,
                  single_ms: dict) -> dict:
    """Phase 10: the disjoint decomposition (parallel.sharded) -> its
    launches at 128^3 (K1-K6 in the batched steps) and in the 32^3
    boundary run (K8, and K7 in its quality report), and its figures;
    ``single_ms``: phase 3's kernel times on the single device, beside
    which K1-K6 are timed on the union (the mesh's own point order)."""
    from smoothmesh_torch import cli, kernels
    from smoothmesh_torch.ops import constraints as con
    from smoothmesh_torch.driver import PLAIN_STAGES, Smoother, iteration_body
    from smoothmesh_torch.io.case import FoamCase
    from smoothmesh_torch.io.polymesh import write_polymesh
    from smoothmesh_torch.ops import smoothing as smo
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch.parallel.ranks import Job, run_ranks
    from smoothmesh_torch.parallel.sharded import ShardedSmoother
    from smoothmesh_torch.params import SmoothingParams
    from smoothmesh_torch.testcases import bench_dome_geometry

    out = {}
    N = mesh.n_points
    params = SmoothingParams(centroidal_iters=MAIN_ITERS, rel_tol=0.0)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ss = ShardedSmoother(mesh, params, n_shards=SHARDED_SHARDS,
                         device="cuda")
    t_setup = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 1e9
    U, P = ss.topo.n_points, int(ss.sync.rows.numel())
    n_proc = sum(t.n_faces - t.n_internal_faces for t in ss.shards.topos) \
        - (mesh.n_faces - mesh.n_internal_faces)
    print(f"sharded at {MAIN_SIDE}^3, {SHARDED_SHARDS} shards "
          f"(UnionPointSync): union {U} points = {U / N:.4f} N, "
          f"{ss.topo.n_cells} cells, {ss.topo.n_faces} faces "
          f"({n_proc} processor faces), {ss.topo.n_edges} edges; "
          f"{ss.sync.n_slots} shared points in {P} (point, holder) rows; "
          f"set-up {t_setup:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in ss.setup_times.items())
          + f" (the compiles are inside the shard build); peak device "
          f"memory over the set-up {setup_peak:.2f} GB", flush=True)
    out.update(union_over_n=U / N, setup_s=t_setup,
               setup_parts=dict(ss.setup_times),
               shared_points=ss.sync.n_slots, pair_rows=P,
               processor_faces=n_proc, setup_peak_gb=setup_peak)
    start = (ss.points.clone(), ss.normals.clone())

    wall_clock("phase 10: kernels against the plain versions on the union")
    got = ss.steps(SHARDED_ITERS)
    require(holders_identical(ss), f"sharded {MAIN_SIDE}^3: the holders "
            "of a shared point differ after the kernels' run")
    td_p = with_plain_tables(ss.td, ss.topo)
    exact = {}
    stages = exact_stages(exact)._replace(predictor=k3_unshared_stage(
        exact, ss.sync.rows, ss.td))
    pts_p = start[0].clone()
    for i, r in enumerate(got):
        pts_p, _, res_p, nf_p, _, _ = iteration_body(
            pts_p, td_p, ss.params, ss._scale, stages, sync=ss.sync)
        res_p, nf_p = float(res_p), int(nf_p)
        where = f"sharded {MAIN_SIDE}^3 plain, iteration {i + 1}"
        require(abs(r.residual - res_p) < 2e-3, f"{where}: residual "
                f"{r.residual} (kernels) vs {res_p} (plain)")
        require(abs(r.n_frozen - nf_p) <= 0.1 * nf_p + 10, f"{where}: "
                f"nFrozen {r.n_frozen} (kernels) vs {nf_p} (plain)")
    require(exact["calls"] == SHARDED_ITERS and exact["k1_bits"] == 0
            and exact["k2_bits"] == 0 and exact["k4_mismatches"] == 0
            and exact["k5_bits"] == 0
            and exact["k3_unshared_beyond"] <= MASK_TOL * N,
            f"sharded {MAIN_SIDE}^3: K1, K2, K4, K5 and K3 (unshared rows) "
            f"against their plain versions on each iteration's inputs: "
            f"{exact}")
    print(f"sharded {MAIN_SIDE}^3 x {SHARDED_ITERS} through the kernels "
          f"and through the plain versions on the union: agree (last "
          f"residual {got[-1].residual:.6g} vs {res_p:.6g}, nFrozen "
          f"{got[-1].n_frozen} vs {nf_p}); K1, K2, K5 bit-equal, K4 "
          f"without a mismatch and K3 on the unshared rows within the mask "
          f"criterion on every iteration's inputs: {exact}; the holders "
          f"of every shared point bit-identical", flush=True)
    out["plain_exact"] = exact
    out["frozen"] = [r.n_frozen for r in got]
    del td_p, pts_p

    wall_clock("phase 10: freeze-free against the single device")
    ff = dataclasses.replace(ss.params, centroidal_iters=SHARDED_ITERS,
                             min_edge_length=1e-12 * ss.params.min_edge_length,
                             edge_angle_constraint=False,
                             face_angle_constraint=False)
    single = Smoother(mesh_int, ff, topo=topo, device="cuda")
    want = single.steps(SHARDED_ITERS)
    want_pts = single.denormalize()[orders.point_new]
    del single
    torch.cuda.empty_cache()
    main_params = ss.params
    ss.params = ff
    ss.points, ss.normals = start[0].clone(), start[1].clone()
    ss._iteration = 0
    got_ff = ss.steps(SHARDED_ITERS)
    scale = float(np.abs(want_pts).max())
    dist = np.linalg.norm(ss.denormalize() - want_pts, axis=1)
    moved = float(np.abs(want_pts - mesh.points).max())
    d_res = max(abs(a.residual - b.residual) / max(abs(b.residual), 1e-30)
                for a, b in zip(got_ff, want))
    require(float(dist.max()) <= HALO_POINT_MAX * scale and moved > 0
            and d_res <= HALO_RES_TOL and holders_identical(ss),
            f"sharded {MAIN_SIDE}^3 freeze-free against the single device: "
            f"farthest point {float(dist.max()):.3g} (scale {scale:.4g}), "
            f"residuals {d_res:.3g} relative, holders identical "
            f"{holders_identical(ss)}")
    print(f"sharded {MAIN_SIDE}^3 x {SHARDED_ITERS}, freezes off, against "
          f"the single device from the same points: every point within "
          f"{float(dist.max()):.3g} ({float(dist.max()) / scale:.3g} of the "
          f"coordinate scale; the largest move {moved:.3g}), residuals "
          f"within {d_res:.3g} relative; the holders of every shared point "
          f"bit-identical", flush=True)
    out["freeze_free"] = dict(max_point_diff=float(dist.max()),
                              scale=scale, residual_rel=d_res)
    ss.params = main_params

    wall_clock("phase 10: batched against one by one")
    ss.points, ss.normals = start[0].clone(), start[1].clone()
    ss._iteration = 0
    run = batched_against_one_by_one(
        ss, MAIN_ITERS, f"sharded {MAIN_SIDE}^3, {SHARDED_SHARDS} shards",
        smi, {k: (0 if k in (kernels.RAYCAST, kernels.TABLE_GATHER,
                             kernels.POINT_NORMALS)
                  else MAIN_ITERS) for k in kernels.ALL})
    require(holders_identical(ss), f"sharded {MAIN_SIDE}^3: the holders "
            "differ after steps(32)")
    out.update(ms_batched=run["ms_batched"], ms_one=run["ms_one"],
               peak_gb=run["peak_gb"], capture_s=run["capture_s"])
    launches = dict(run["launches"])

    wall_clock("phase 10: the shared rows' predictor")
    pts, td = ss.points, ss.td
    fg = geo.face_centres_areas(pts, td["face_points"], td["face_mask"],
                                td["face_npoints"])
    cc, _ = geo.cell_centres_vols(fg, td)
    max_step = ss.params.max_step_length * ss._scale
    pargs = (pts, cc, td, max_step, ss.params.rel_step_frac, False)
    prop, _ = smo.predictor(*pargs)
    rows_ms = device_ms(lambda: smo.predict_shared_rows(prop, *pargs,
                                                        ss.sync), 20)
    k3_ms = device_ms(lambda: smo.predictor(*pargs), 20)
    td_p = with_plain_tables(td, ss.topo)
    full_ms = device_ms(lambda: smo.predictor_plain(
        pts, cc, td_p, max_step, ss.params.rel_step_frac, False,
        sync=ss.sync), 5)
    out.update(shared_rows_predictor_ms=rows_ms, k3_union_ms=k3_ms,
               plain_chain_with_exchanges_ms=full_ms)
    p = ss.params
    frozen = torch.zeros(U, dtype=torch.bool, device=pts.device)
    eu = con.edge_face_angles(pts, fg.means, cc, td)
    union_ms = {
        kernels.FACE_GEOMETRY: device_ms(lambda: geo.face_centres_areas(
            pts, td["face_points"], td["face_mask"], td["face_npoints"]),
            20),
        kernels.CELL_CENTRES: device_ms(
            lambda: geo.cell_centres_vols(fg, td), 20),
        kernels.PREDICTOR: k3_ms,
        kernels.FREEZE: device_ms(lambda: con.freeze_constraints(
            pts, prop, td, p.min_edge_length * ss._scale,
            p.total_min_freeze, p.min_angle_rad, p.edge_angle_constraint,
            frozen), 20),
        kernels.FACE_ANGLES: device_ms(
            lambda: con.edge_face_angles(pts, fg.means, cc, td), 20),
        kernels.POINT_FACE_ANGLES: device_ms(
            lambda: con.point_face_angles(eu, td), 20)}
    out["union_kernel_ms"] = {k.name: v for k, v in union_ms.items()}
    print(f"sharded {MAIN_SIDE}^3: K1-K6 on the union (U/N {U / N:.4f}, the "
          "mesh's own point order) against phase 3's single device: "
          + ", ".join(f"{k.name.split()[0]} {v:.4f} ms ({v / single_ms[k]:.3f}"
                      "x)" for k, v in union_ms.items())
          + f"; sums {sum(union_ms.values()):.4f} against "
          f"{sum(single_ms[k] for k in union_ms):.4f} ms", flush=True)
    del eu, frozen
    print(f"sharded {MAIN_SIDE}^3: the shared rows' predictor ({P} rows) "
          f"{rows_ms:.4f} ms of device time launched one by one, K3 over "
          f"the union {k3_ms:.4f} ms, the whole plain chain with the "
          f"exchanges (the fallback) {full_ms:.4f} ms; the batched "
          f"iteration {run['ms_batched']:.4f} ms, on {smi}", flush=True)
    del ss, run, start, fg, cc, prop, td_p, pts, td
    torch.cuda.empty_cache()

    wall_clock("phase 10: 32^3 boundary")
    small = bench_mesh(SMALL_SIDE)
    bparams = dataclasses.replace(boundary_params(SMALL_ITERS),
                                  max_step_length=SMALL_BND_MAX_STEP)
    geom = bench_dome_geometry()[1:]
    sb = ShardedSmoother(small, bparams, n_shards=SHARDED_SHARDS,
                         device="cuda")
    sb.enable_boundary_smoothing(*geom)
    require(sb.layer is not None and sb.bnd is not None,
            "sharded 32^3: layers or boundary smoothing off")
    bstart = (sb.points.clone(), sb.normals.clone())
    sb.prepare_batch()
    kernels.reset_launches()
    got = sb.steps(SMALL_ITERS)
    launches_bnd = {k: k.launches for k in kernels.ALL}
    require(launches_bnd[kernels.RAYCAST] == SMALL_ITERS,
            f"sharded {SMALL_SIDE}^3 boundary: K8 launched "
            f"{launches_bnd[kernels.RAYCAST]} times")
    pts_p, nrm_p = bstart
    td_bp = with_plain_tables(sb.td, sb.topo)
    for a in got:
        pts_p, nrm_p, res_p, nf_p, miss_p, _ = iteration_body(
            pts_p, td_bp, sb.params, sb._scale, PLAIN_STAGES,
            normals=nrm_p, smoothing_surface=sb.smoothing_surface,
            layer=sb.layer, bnd=sb.bnd, sync=sb.sync)
        require(abs(a.residual - float(res_p)) < 2e-3 and a.residual < 1.0
                and abs(a.n_frozen - int(nf_p)) <= 0.1 * int(nf_p) + 10
                and a.n_ray_miss == int(miss_p),
                f"sharded {SMALL_SIDE}^3 boundary, iteration {a.iteration}: "
                f"{a} vs plain {float(res_p)}, {int(nf_p)}, {int(miss_p)}")
    apart = float((sb.points - pts_p).abs().max())
    require(apart < BND_POINT_TOL and holders_identical(sb),
            f"sharded {SMALL_SIDE}^3 boundary: points {apart} apart from "
            "the plain versions' (normalized units)")
    kernels.reset_launches()
    rep = sb.quality()
    launches_q = kernels.TABLE_GATHER.launches
    require(launches_q == 1 and rep["n_negative_volumes"] == 0,
            f"sharded {SMALL_SIDE}^3 quality(): K7 launched {launches_q}, "
            f"{rep['n_negative_volumes']} negative volumes")
    launches[kernels.RAYCAST] = launches_bnd[kernels.RAYCAST]
    launches[kernels.TABLE_GATHER] = launches_q
    print(f"sharded {SMALL_SIDE}^3 x {SMALL_ITERS}, boundary configuration "
          f"(max step {SMALL_BND_MAX_STEP}), {SHARDED_SHARDS} shards, "
          f"through the kernels and through the plain versions on the "
          f"union: agree (last residual {got[-1].residual:.6g}, nFrozen "
          f"{got[-1].n_frozen}, ray misses {got[-1].n_ray_miss}; points "
          f"within {apart:.3g} normalized units); launches "
          f"{ {k.name: v for k, v in launches_bnd.items() if v} }; "
          f"quality(): min face angle {rep['min_face_angle_deg']:.4f} deg, "
          f"no negative volume, K7 one launch", flush=True)
    del sb, pts_p, nrm_p, td_bp

    wall_clock("phase 10: DistPointSync")
    dparams = SmoothingParams(centroidal_iters=SMALL_ITERS, rel_tol=0.0)
    su = ShardedSmoother(small, dparams, n_shards=DIST_WORLD, device="cuda")
    want = [dataclasses.astuple(r) for r in su.steps(SMALL_ITERS)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(Job(small, dparams, SMALL_ITERS,
                              decomposition="disjoint", backend="gloo"),
                          DIST_WORLD, tmp, timeout_s=300)
        t_dist = time.perf_counter() - t0
    base = su.union.base[:, 0]
    for rank, r in enumerate(ranks):
        require([x[:3] + x[4:] for x in r["results"]]
                == [x[:3] + x[4:] for x in want],
                f"DistPointSync rank {rank}: results differ from the "
                "union's")
        require(torch.equal(r["points"],
                            su.points[base[rank]:base[rank + 1]].cpu()),
                f"DistPointSync rank {rank}: points not bit-equal")
        require(np.array_equal(r["denormalized"], su.denormalize()),
                f"DistPointSync rank {rank}: the global points differ")
    print(f"sharded {SMALL_SIDE}^3 x {SMALL_ITERS}, DistPointSync "
          f"({DIST_WORLD} gloo ranks in {DIST_WORLD} processes on cuda:0) "
          f"against UnionPointSync ({DIST_WORLD} shards): points, "
          f"residuals and counts bit-equal (last residual {want[-1][1]:.6g},"
          f" nFrozen {want[-1][2]}); the ranks took {t_dist:.1f} s with "
          f"their start-up", flush=True)
    del su

    wall_clock("phase 10: the CLI's -parallel")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as root:
        os.makedirs(os.path.join(root, "system"))
        with open(os.path.join(root, "system", "controlDict"), "w") as f:
            f.write("deltaT 1;\n")
        write_polymesh(os.path.join(root, "constant", "polyMesh"), small,
                       binary=True)
        args = ["-case", root, "-parallel", "-centroidalIters",
                str(SMALL_ITERS), "-writeFormat", "binary", "-checkMesh"]
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main(args)
        t_cli = time.perf_counter() - t0
        text = text.getvalue()
        require(rc == 0, f"the CLI's -parallel exited with {rc}")
        n_dev = torch.cuda.device_count()
        require(f"Running sharded over {n_dev} shards" in text
                and "Mesh OK." in text,
                "the CLI's -parallel: " + text[-400:])
        back = FoamCase(root).read_mesh(float(SMALL_ITERS)).points
        require(back.shape == (small.n_points, 3)
                and bool(np.isfinite(back).all())
                and float(np.abs(back - small.points).max()) > 0,
                f"the -parallel run's points read back as {back.shape}")
    print(f"CLI -parallel on the {SMALL_SIDE}^3 case (binary, "
          f"{SMALL_ITERS} iterations, -checkMesh): exit 0 in {t_cli:.2f} s, "
          f"{n_dev} shard(s), one a card in this process, Mesh OK, the "
          f"{small.n_points} points read back", flush=True)
    out["cli_parallel_s"] = t_cli
    out["launches"] = launches
    return out


def write_case(root: str, mesh) -> None:
    """An OpenFOAM case of ``mesh`` (binary) in ``root``."""
    from smoothmesh_torch.io.polymesh import write_polymesh

    os.makedirs(os.path.join(root, "system"))
    with open(os.path.join(root, "system", "controlDict"), "w") as f:
        f.write("deltaT 1;\n")
    write_polymesh(os.path.join(root, "constant", "polyMesh"), mesh,
                   binary=True)


def held_steps(sm, n: int) -> tuple:
    """Phase 11: ``sm.step()`` n times -> (the StepResults, each
    iteration's (N,) mask of the points it held where they were: the
    frozen, the fixed and those that did not move, on the host)."""
    results, held = [], []
    for _ in range(n):
        before = sm.points
        results.append(sm.step())
        held.append((sm.points == before).all(1).cpu())
    return results, held


def decomposition_gap(label: str, got, want, got_pts, want_pts,
                      frozen_tol=None) -> dict:
    """Phase 11: a decomposition's run against the single device's from
    the same start: the farthest point in units of the coordinate scale
    (max |x| of the single device's points), the points beyond
    HALO_POINT_TOL of it, residuals relative; held to phase 9's
    HALO_POINT_MAX and HALO_RES_TOL, and frozen counts within
    ``frozen_tol`` where given (the disjoint one counts a shared point
    once a holder)."""
    scale = float(np.abs(want_pts).max())
    dist = np.linalg.norm(got_pts - want_pts, axis=1)
    d_res = max(abs(a.residual - b.residual) / max(abs(b.residual), 1e-300)
                for a, b in zip(got, want))
    d_frozen = max(abs(a.n_frozen - b.n_frozen) for a, b in zip(got, want))
    out = dict(farthest_of_scale=float(dist.max()) / scale,
               beyond_1e5_of_scale=int((dist > HALO_POINT_TOL * scale).sum()),
               residual_rel=d_res, frozen=d_frozen,
               points_bit_equal=int((got_pts == want_pts).all(1).sum()))
    require(len(got) == len(want) and float(dist.max()) <= HALO_POINT_MAX
            * scale and d_res <= HALO_RES_TOL
            and (frozen_tol is None or d_frozen <= frozen_tol),
            f"{label}: {out}")
    return out


def float64_phase(mesh_int, topo, steps32, smi: str) -> dict:
    """Phase 11: float64 on the card, where every wrapper runs its plain
    version (no kernel launches) -> its figures.  ``mesh_int``, ``topo``:
    phase 2's reordered 128^3 mesh and its topology; ``steps32``: phase
    4's float32 StepResults of the default path there."""
    from smoothmesh_torch import cli, kernels
    from smoothmesh_torch.driver import Smoother, decomposition
    from smoothmesh_torch.io.case import FoamCase
    from smoothmesh_torch.mesh.tiling import permute_mesh
    from smoothmesh_torch.mesh.topology import compile_topology
    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother
    from smoothmesh_torch.params import SmoothingParams
    from smoothmesh_torch.testcases import bench_dome_geometry

    f64 = torch.float64
    out = {}
    dome = bench_dome_geometry()[1:]
    torch.cuda.empty_cache()
    kernels.reset_launches()
    for k in kernels.ALL:       # what the last float32 capture recorded
        k.captured = 0

    def no_launches(label: str) -> None:
        launched = {k.name: k.launches + k.captured for k in kernels.ALL
                    if k.launches or k.captured}
        require(not launched, f"{label}: float64 launched {launched}")

    wall_clock(f"phase 11: the card against the CPU at {SMALL_SIDE}^3")
    small = bench_mesh(SMALL_SIDE)
    n_small = small.n_points
    base = SmoothingParams(centroidal_iters=F64_ITERS, rel_tol=0.0)
    configs = (
        ("default", base, None),
        (f"band {TIGHT_BAND}", dataclasses.replace(
            base, min_angle=TIGHT_BAND[0], max_angle=TIGHT_BAND[1]), None),
        (f"boundary, max step {SMALL_BND_MAX_STEP}", dataclasses.replace(
            boundary_params(F64_ITERS), max_step_length=SMALL_BND_MAX_STEP),
         dome))
    out["card_against_cpu"] = {}
    for label, params, geometry in configs:
        runs = {}
        for dev in ("cuda", "cpu"):
            s = Smoother(small, params, dtype=f64, device=dev)
            if geometry is not None:
                s.enable_boundary_smoothing(*geometry)
            if dev == "cuda":
                start = (s.points.clone(), s.normals.clone())
                small_batched_against_one_by_one(
                    s, F64_ITERS, f"float64 {SMALL_SIDE}^3 {label}")
                batched = s.points
                s.points, s.normals = start[0].clone(), start[1].clone()
                s._iteration = 0
            results, held = held_steps(s, F64_ITERS)
            if dev == "cuda":
                require(torch.equal(s.points, batched),
                        f"float64 {SMALL_SIDE}^3 {label}: step() and the "
                        "batched steps differ")
            runs[dev] = (results, held, s.denormalize())
        (rk, hk, pk), (rc, hc, pc) = runs["cuda"], runs["cpu"]
        scale = float(np.abs(pc).max())
        far = float(np.linalg.norm(pk - pc, axis=1).max())
        d_res = max(abs(a.residual - b.residual) / max(abs(b.residual),
                                                       1e-300)
                    for a, b in zip(rk, rc))
        d_frozen = [a.n_frozen - b.n_frozen for a, b in zip(rk, rc)]
        masks = [int((a != b).sum()) for a, b in zip(hk, hc)]
        misses = ([r.n_ray_miss for r in rk], [r.n_ray_miss for r in rc])
        for i, (a, b) in enumerate(zip(hk, hc)):
            for j in torch.nonzero(a != b).squeeze(1)[:5].tolist():
                print(f"  float64 {SMALL_SIDE}^3 {label}, iteration "
                      f"{i + 1}: point {j} held on the card {bool(a[j])}, "
                      f"on the CPU {bool(b[j])}")
        rec = dict(farthest_of_scale=far / scale, residual_rel=d_res,
                   frozen_differences=d_frozen, held_masks_differing=masks,
                   ray_misses=misses[0])
        out["card_against_cpu"][label] = rec
        require(far <= F64_POINT_TOL * scale and d_res <= F64_RES_TOL
                and misses[0] == misses[1]
                and max(masks) <= MASK_TOL * n_small
                and max(map(abs, d_frozen)) <= MASK_TOL * n_small,
                f"float64 {SMALL_SIDE}^3 {label}, the card against the "
                f"CPU: {rec}")
        print(f"float64 {SMALL_SIDE}^3 x {F64_ITERS}, {label}: the card "
              f"against the CPU, the farthest point {far / scale:.3g} of "
              f"the coordinate scale, residuals within {d_res:.3g} "
              f"relative, frozen counts {rk[-1].n_frozen} vs "
              f"{rc[-1].n_frozen} (differences {d_frozen}), held masks "
              f"differing {masks}, ray misses {misses[0]} vs {misses[1]}",
              flush=True)
    no_launches(f"{SMALL_SIDE}^3 runs")

    wall_clock(f"phase 11: the default path at {MAIN_SIDE}^3")
    N = topo.n_points
    t0 = time.perf_counter()
    sm = Smoother(mesh_int, SmoothingParams(centroidal_iters=MAIN_ITERS,
                                            rel_tol=0.0),
                  dtype=f64, topo=topo, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    run = batched_against_one_by_one(
        sm, MAIN_ITERS, f"float64 default path at {MAIN_SIDE}^3", smi,
        {k: 0 for k in kernels.ALL})
    for a, b in zip(run["steps"], steps32):
        require(math.isfinite(a.residual)
                and abs(a.residual - b.residual) < 2e-3
                and abs(a.n_frozen - b.n_frozen) <= 0.1 * b.n_frozen + 10,
                f"float64 default path, iteration {a.iteration}: residual "
                f"{a.residual}, nFrozen {a.n_frozen} against float32's "
                f"{b.residual}, {b.n_frozen}")
    last, last32 = run["steps"][-1], steps32[-1]
    out["default_128"] = dict(
        ms_batched=run["ms_batched"], ms_one=run["ms_one"],
        capture_s=run["capture_s"], peak_gb=run["peak_gb"],
        setup_s=t_setup, residual=last.residual, n_frozen=last.n_frozen,
        residual_f32=last32.residual, n_frozen_f32=last32.n_frozen)
    print(f"float64 default path at {MAIN_SIDE}^3: set-up on the compiled "
          f"topology {t_setup:.2f} s; {run['ms_batched']:.3f} ms/iteration "
          f"batched, {run['ms_one']:.3f} one by one, capture "
          f"{run['capture_s']:.3f} s, peak {run['peak_gb']:.2f} GB; against "
          f"phase 4's float32 kernels: last residual {last.residual:.6g} "
          f"vs {last32.residual:.6g}, nFrozen {last.n_frozen} vs "
          f"{last32.n_frozen} (every iteration within 2e-3 and 10% + 10);"
          f" {N / (run['ms_batched'] / 1e3):,.0f} point-updates/s on "
          f"{smi}", flush=True)
    del sm, run
    torch.cuda.empty_cache()

    wall_clock(f"phase 11: the boundary path at {MAIN_SIDE}^3")
    t0 = time.perf_counter()
    sb = Smoother(mesh_int, boundary_params(F64_ITERS), dtype=f64,
                  topo=topo, device="cuda")
    sb.enable_boundary_smoothing(*dome)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t_capture = sb.prepare_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rb = sb.steps(F64_ITERS)
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    require(len(rb) == F64_ITERS
            and all(math.isfinite(r.residual) for r in rb),
            f"float64 boundary path at {MAIN_SIDE}^3: {rb}")
    out["boundary_128"] = dict(
        ms_batched=t_run * 1e3 / F64_ITERS, capture_s=t_capture,
        peak_gb=peak, setup_s=t_setup, residual=rb[-1].residual,
        n_frozen=rb[-1].n_frozen, n_ray_miss=rb[-1].n_ray_miss)
    print(f"float64 boundary path at {MAIN_SIDE}^3: set-up with the "
          f"classification {t_setup:.2f} s, capture {t_capture:.3f} s, "
          f"steps({F64_ITERS}) batched {t_run * 1e3 / F64_ITERS:.3f} "
          f"ms/iteration, peak device memory over the capture and the run "
          f"{peak:.2f} GB; last residual {rb[-1].residual:.6g}, nFrozen "
          f"{rb[-1].n_frozen}, ray misses {rb[-1].n_ray_miss} on {smi}",
          flush=True)
    del sb
    torch.cuda.empty_cache()
    no_launches(f"{MAIN_SIDE}^3 runs")

    wall_clock(f"phase 11: the decompositions at {F64_DEC_SIDE}^3")
    mesh_d = bench_mesh(F64_DEC_SIDE)
    mesh_d_int, orders_d = permute_mesh(mesh_d)
    topo_d = compile_topology(mesh_d_int)
    n_d = mesh_d.n_points
    params = SmoothingParams(centroidal_iters=F64_ITERS, rel_tol=0.0)

    def decompositions(dtype) -> dict:
        single = Smoother(mesh_d_int, params, dtype=dtype, topo=topo_d,
                          device="cuda")
        start = (single.points.clone(), single.normals.clone())
        want = single.steps(F64_ITERS)
        want_pts = single.denormalize()[orders_d.point_new]
        ff = dataclasses.replace(
            single.params,
            min_edge_length=1e-12 * single.params.min_edge_length,
            edge_angle_constraint=False, face_angle_constraint=False)
        single.points, single.normals = start[0].clone(), start[1].clone()
        single._iteration, single.params = 0, ff
        want_ff = single.steps(F64_ITERS)
        want_ff_pts = single.denormalize()[orders_d.point_new]
        del single
        name = str(dtype).split(".")[1]
        hs = HaloSmoother(mesh_d, params, n_shards=HALO_SHARDS,
                          dtype=dtype, device="cuda")
        got = hs.steps(F64_ITERS)
        rec = {"halo": decomposition_gap(
            f"{name} halo at {F64_DEC_SIDE}^3", got, want, hs.denormalize(),
            want_pts, HALO_COUNT_TOL * n_d)}
        del hs
        # float64 takes the disjoint one by the rule, float32 is told to
        require(decomposition("cuda", dtype, None if dtype == f64
                              else False) == "disjoint",
                f"{name}: the rule takes the halo")
        ss = ShardedSmoother(mesh_d, ff, n_shards=SHARDED_SHARDS,
                             dtype=dtype, device="cuda")
        got = ss.steps(F64_ITERS)
        require(holders_identical(ss), f"{name} disjoint at "
                f"{F64_DEC_SIDE}^3: the holders differ")
        rec["disjoint_freeze_free"] = decomposition_gap(
            f"{name} disjoint at {F64_DEC_SIDE}^3", got, want_ff,
            ss.denormalize(), want_ff_pts)
        del ss
        torch.cuda.empty_cache()
        for k, r in rec.items():
            print(f"{name} {k} at {F64_DEC_SIDE}^3, {HALO_SHARDS} shards x "
                  f"{F64_ITERS} against the single device: the farthest "
                  f"point {r['farthest_of_scale']:.3g} of the coordinate "
                  f"scale, {r['beyond_1e5_of_scale']} of {n_d} beyond 1e-5 "
                  f"of it, {r['points_bit_equal']} bit-equal; residuals "
                  f"within {r['residual_rel']:.3g} relative, frozen counts "
                  f"{r['frozen']} apart (the disjoint one counts a shared "
                  "point once a holder)", flush=True)
        return rec

    out["decompositions_float64"] = decompositions(f64)
    no_launches(f"{F64_DEC_SIDE}^3 decompositions")

    wall_clock("phase 11: the CLI")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_f64_") as root:
        reports, texts, written = {}, {}, {}
        for how, extra in (("cuda", ["-device", "cuda"]),
                           ("cpu", ["-device", "cpu"]),
                           ("cuda -parallel", ["-device", "cuda",
                                               "-parallel"])):
            case = os.path.join(root, how.replace(" ", ""))
            write_case(case, small)
            args = ["-case", case, "-dtype", "float64", *extra,
                    "-centroidalIters", str(F64_ITERS), "-checkMesh",
                    "-writeFormat", "binary"]
            kept, timers = [], {}
            text = io.StringIO()
            t0 = time.perf_counter()
            with timed(timers, Smoother, "quality", "report", kept), \
                    contextlib.redirect_stdout(text):
                rc = cli.main(args)
            t_cli = time.perf_counter() - t0
            texts[how] = text.getvalue()
            require(rc == 0 and "Mesh OK." in texts[how],
                    f"the float64 CLI ({how}) exited with {rc}: "
                    + texts[how][-400:])
            written[how] = FoamCase(case).read_mesh(float(F64_ITERS)).points
            if kept:
                reports[how] = kept[0]
            print(f"CLI -dtype float64 {' '.join(extra)} -checkMesh on the "
                  f"{SMALL_SIDE}^3 case: exit 0 in {t_cli:.2f} s", flush=True)
    rep_k, rep_c = reports["cuda"], reports["cpu"]
    bad = [k for k, v in rep_c.items()
           if (rep_k[k] != v if isinstance(v, int) else
               abs(rep_k[k] - v) > F64_REPORT_REL * abs(v) + F64_REPORT_ABS)]
    worst, worst_key = max(
        ((abs(rep_k[k] - v) / abs(v), k) for k, v in rep_c.items()
         if not isinstance(v, int) and v != 0), default=(0.0, None))
    scale = float(np.abs(written["cpu"]).max())
    far = {how: float(np.linalg.norm(written[how] - written["cpu"],
                                     axis=1).max()) / scale
           for how in ("cuda", "cuda -parallel")}
    require(not bad and far["cuda"] <= F64_POINT_TOL,
            f"the float64 CLI, the card against the CPU: report keys {bad} "
            f"differ, written points {far['cuda']:.3g} of the scale apart")
    out["cli"] = dict(report_worst_rel=worst, report_worst_key=worst_key,
                      written_farthest_of_scale=far)
    print(f"CLI -dtype float64 on the card against the CPU: the report's "
          f"{len(rep_c)} keys agree (integers equal, the largest relative "
          f"difference {worst:.3g}, of {worst_key}: card "
          f"{rep_k.get(worst_key)!r}, CPU {rep_c.get(worst_key)!r}), the "
          f"written points within "
          f"{far['cuda']:.3g} of the coordinate scale (-parallel: "
          f"{far['cuda -parallel']:.3g})", flush=True)
    no_launches("the float64 CLI")
    out["launches_float64"] = {k.name: k.launches for k in kernels.ALL}

    wall_clock("phase 11: float32 after float64, float16 refused")
    s32 = Smoother(small, base, device="cuda")
    kernels.reset_launches()
    s32.step()
    launched = {k: k.launches for k in kernels.ALL}
    require(all(n == (0 if k in (kernels.TABLE_GATHER, kernels.RAYCAST,
                                 kernels.POINT_NORMALS)
                      else 1) for k, n in launched.items()),
            f"a float32 step() launched {launched}")
    del s32
    try:
        Smoother(small, base, dtype=torch.float16, device="cuda")
    except TypeError as e:
        refused = str(e)
    else:
        refused = None
    require(refused is not None, "a float16 smoother on cuda was accepted")
    print(f"float32 step() after the float64 runs: K1-K6 launched once "
          f"each, K7, K8 and K9 none; float16 on cuda: TypeError({refused!r})",
          flush=True)
    out["decompositions_float32"] = decompositions(torch.float32)
    return out


def quality_worst_rel(got: dict, want: dict) -> float:
    """The largest relative difference between two quality reports (0
    where every value is equal)."""
    worst = 0.0
    for k, b in want.items():
        a = got[k]
        if a != b:
            worst = max(worst, abs(a - b) / abs(b) if b else math.inf)
    return worst


def start_ranks(pool, mesh, params, n: int, geometry, job_kw: dict,
                world: int, workdir: str, device: str = "cuda"):
    """Phase 12: ``world`` ranks (``run_ranks``; under NCCL on ``cuda``,
    rank r on cuda:r; gloo on the CPU, a rehearsal) running ``n`` steps,
    started in ``pool`` -> the future of their outputs."""
    from smoothmesh_torch.parallel.ranks import Job, run_ranks

    job = Job(mesh, params, n, device=device, geometry=geometry,
              backend="nccl" if device == "cuda" else "gloo", **job_kw)
    return pool.submit(run_ranks, job, world, workdir, NCCL_TIMEOUT_S)


def prepared_union(cls, mesh, params, world: int, geometry,
                   device: str = "cuda"):
    """Phase 12: ``cls`` with ``world`` shards in this process, its batch
    captured -> (the smoother, the seconds of its set-up)."""
    t0 = time.perf_counter()
    un = cls(mesh, params, n_shards=world, device=device)
    if geometry is not None:
        un.enable_boundary_smoothing(*geometry)
    un.prepare_batch()
    return un, time.perf_counter() - t0


def held_against_union(label: str, ranks, un, n: int, boundary: bool,
                       smi: str, device: str = "cuda") -> dict:
    """Phase 12: the ranks' outputs (``start_ranks``, ended) against the
    union ``un`` (``prepared_union``), which steps ``n`` times now, with
    no rank running.  Required: each rank under NCCL on its own card,
    the results and each rank's union rows bit-equal, ``denormalize()``
    bit-equal, ``quality()`` within 1e-12 relative at world 1 (within
    Q_REL_TOL above it, where the ranks' parts are summed in another
    order, in float32), every kernel of the run launched in rank 0
    (K1-K6 n times or more, K7 for the report, K8 n times with boundary
    smoothing) -> the figures, with rank 0's launches.  On the CPU (a
    rehearsal under gloo) no launch is required."""
    from smoothmesh_torch import kernels

    on_card = device == "cuda"
    backend = "nccl" if on_card else "gloo"
    world = len(ranks)
    results = un.steps(n)
    want = [dataclasses.astuple(r) for r in results]
    den, rep = un.denormalize(), un.quality()
    base = un.union.base[:, 0]
    worst = 0.0
    q_tol = NCCL_QUALITY_REL if world == 1 else Q_REL_TOL
    for rank, r in enumerate(ranks):
        where = f"{label}, {backend} rank {rank} of {world}"
        card = f"cuda:{rank}" if on_card else "cpu"
        require(r["backend"] == backend and r["device"] == card,
                f"{where}: ran under {r['backend']} on {r['device']}")
        require([x[:3] + x[4:] for x in r["results"]]
                == [x[:3] + x[4:] for x in want],
                f"{where}: results differ from the union's")
        require(torch.equal(r["points"],
                            un.points[base[rank]:base[rank + 1]].cpu()),
                f"{where}: points not bit-equal to the union's")
        require(np.array_equal(r["denormalized"], den),
                f"{where}: denormalize() not bit-equal")
        w = quality_worst_rel(r["quality"], rep)
        require(w <= q_tol, f"{where}: quality() {w:.3g} relative from "
                f"the union's (at most {q_tol})")
        worst = max(worst, w)
    launched = ranks[0]["launches"]
    want_n = {k.name: n for k in kernels.ALL[:6]}
    want_n[kernels.TABLE_GATHER.name] = 1
    if boundary:
        want_n[kernels.RAYCAST.name] = n
    for name, m in want_n.items():
        require(launched[name] >= m or not on_card, f"{label}: {name} "
                f"launched {launched[name]} times in rank 0, expected {m}")
    # a batch's wall over its iterations: the first batch of a rank
    # also holds its first calls (the NCCL communicator, the kernels'
    # libraries loaded), the last one is the steady state
    walls = [x[3] for x in ranks[0]["results"]]
    fig = dict(world=world, ms_first_batch_ranks=walls[0],
               ms_last_batch_ranks=walls[-1],
               ms_last_batch_union=results[-1].wall_ms,
               quality_worst_rel=worst,
               rank0_setup_s=ranks[0]["setup_times"],
               launches_rank0=launched)
    print(f"{label}, {world} {backend} rank(s) on {device} against "
          f"{type(un).__name__}(n_shards={world}) in this process: "
          f"results, points and denormalize() bit-equal, quality() within "
          f"{worst:.3g} relative; {n} iterations in batches of "
          f"{un.iter_batch}: {walls[-1]:.3f} ms/iteration in the ranks' "
          f"last batch (eager: the exchanges are not captured; the first "
          f"batch, with the rank's first calls, {walls[0]:.3f}), "
          f"{results[-1].wall_ms:.3f} in this process (graph replays); "
          f"rank 0 launched {launched} on {smi}", flush=True)
    return fig


def ranks_against_union(label: str, cls, mesh, params, n: int, geometry,
                        job_kw: dict, world: int, workdir: str, pool,
                        smi: str, device: str = "cuda") -> dict:
    """``start_ranks``, ``prepared_union`` meanwhile, then
    ``held_against_union``."""
    fut = start_ranks(pool, mesh, params, n, geometry, job_kw, world,
                      workdir, device)
    un, _ = prepared_union(cls, mesh, params, world, geometry, device)
    return held_against_union(label, fut.result(), un, n,
                              geometry is not None, smi, device)


def nccl_refusal(mesh, n_cards: int, workdir: str) -> str:
    """Phase 12: one NCCL rank more than there are cards -> the
    refusal's message.  ``run_ranks`` must raise, each rank failing in
    ``join`` before it joins the group, with a message that names the
    ranks and the cards."""
    from smoothmesh_torch.parallel.ranks import Job, run_ranks
    from smoothmesh_torch.params import SmoothingParams

    world = n_cards + 1
    try:
        run_ranks(Job(mesh, SmoothingParams(centroidal_iters=1), 1,
                      backend="nccl"), world, workdir, timeout_s=120)
    except RuntimeError as e:
        msg = str(e)
    else:
        raise RuntimeError(f"chip_smoke: {world} NCCL ranks on {n_cards} "
                           "card(s) ran; they must be refused")
    require(f"{world} NCCL ranks on this machine need a card each, and it "
            f"has {n_cards} card(s)" in msg and "in join" in msg,
            f"the refusal of {world} NCCL ranks: {msg[-800:]}")
    return msg.strip().splitlines()[-1]


def nccl_cli(mesh, workdir: str, device: str = "cuda") -> dict:
    """Phase 12: the CLI under torchrun's environment (RANK 0,
    WORLD_SIZE 1, LOCAL_RANK 0, MASTER_ADDR localhost, a free
    MASTER_PORT) with -device cuda -parallel, in a subprocess, against
    the in-process -parallel at one shard on the same case: exit 0,
    NCCL named in its log, the written points equal.  ``device="cpu"``
    rehearses it under gloo on the CPU."""
    import socket
    import unittest.mock

    from smoothmesh_torch import cli
    from smoothmesh_torch.io.case import FoamCase

    roots = [os.path.join(workdir, name) for name in ("torchrun", "one")]
    for root in roots:
        write_case(root, mesh)
    args = ["-parallel", "-device", device, "-centroidalIters",
            str(SMALL_ITERS), "-writeFormat", "binary"]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "smoothmesh_torch.cli", "-case", roots[0],
         *args], env=env, cwd=here, capture_output=True, text=True,
        timeout=NCCL_TIMEOUT_S)
    t_sub = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    require(proc.returncode == 0,
            f"the CLI under torchrun's environment exited with "
            f"{proc.returncode}: {log[-1500:]}")
    line = ("Running sharded over 1 shards (torch.distributed ranks, "
            + ("nccl)" if device == "cuda" else "gloo)"))
    require(line in log, f"the CLI under torchrun's environment: no "
            f"'{line}' in {log[-800:]}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text), unittest.mock.patch.object(
            torch.cuda, "device_count", return_value=1):
        rc = cli.main(["-case", roots[1], *args])
    here_line = ("Running sharded over 1 shards ("
                 + ("1 cards in this process)" if device == "cuda"
                    else "one process on cpu)"))
    require(rc == 0 and here_line in text.getvalue(),
            f"the in-process -parallel at one shard: {rc}, "
            f"{text.getvalue()[-400:]}")
    got, want = (FoamCase(r).read_mesh(float(SMALL_ITERS)).points
                 for r in roots)
    require(got.shape == (mesh.n_points, 3) and np.array_equal(got, want),
            "the CLI under torchrun's environment wrote other points than "
            "the in-process -parallel")
    print(f"CLI -device {device} -parallel under torchrun's environment "
          f"(RANK 0, WORLD_SIZE 1, LOCAL_RANK 0): exit 0 in {t_sub:.1f} s "
          f"with its start-up, '{line}', the {mesh.n_points} written points "
          f"equal to the in-process -parallel's at one shard", flush=True)
    return dict(subprocess_s=t_sub)


def nccl_phase(mesh, smi: str, device: str = "cuda") -> dict:
    """Phase 12: the decompositions one rank a card over NCCL -> the
    figures and the launches of the world-1 runs' rank 0, summed.
    ``device="cpu"`` rehearses it under gloo on the CPU, the refusal
    (which only NCCL makes) left out."""
    import concurrent.futures

    import torch.distributed as dist

    from smoothmesh_torch import kernels
    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother
    from smoothmesh_torch.params import SmoothingParams
    from smoothmesh_torch.testcases import bench_dome_geometry

    n_cards = torch.cuda.device_count()
    version = ".".join(map(str, torch.cuda.nccl.version()))
    print(f"NCCL {version}, torch.distributed.is_nccl_available() "
          f"{dist.is_nccl_available()}, {n_cards} card(s): {smi}",
          flush=True)
    require(dist.is_nccl_available() or device == "cpu",
            "this torch has no NCCL backend")
    out = dict(nccl_version=version, cards=n_cards)
    params = SmoothingParams(centroidal_iters=MAIN_ITERS, rel_tol=0.0)
    small = bench_mesh(SMALL_SIDE)
    bparams = dataclasses.replace(boundary_params(SMALL_ITERS),
                                  max_step_length=SMALL_BND_MAX_STEP)
    runs = (
        (f"halo {MAIN_SIDE}^3", HaloSmoother, mesh, params, MAIN_ITERS,
         None, {}),
        (f"disjoint {MAIN_SIDE}^3", ShardedSmoother, mesh, params,
         MAIN_ITERS, None, dict(decomposition="disjoint")),
        (f"halo {SMALL_SIDE}^3 boundary", HaloSmoother, small, bparams,
         SMALL_ITERS, bench_dome_geometry()[1:], {}))
    launches = {k: 0 for k in kernels.ALL}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(4) as pool:
        # the refusal needs no card time: it runs beside the first run
        if device == "cuda":
            refusal = pool.submit(nccl_refusal, small, n_cards,
                                  os.path.join(tmp, "refusal"))

        def start(i):
            _, _, m, prm, n, geom, kw = runs[i]
            return start_ranks(pool, m, prm, n, geom, kw, 1,
                               os.path.join(tmp, f"run{i}"), device)

        # each run's ranks start before its union is set up here, and
        # the next run's when this one's union is set up: the host
        # builds overlap, and a rank steps while the next one builds
        # (on the host), never beside another run's steps
        futs = {0: start(0)}
        for i, (label, cls, m, prm, n, geom, _) in enumerate(runs):
            wall_clock(f"phase 12: {label}, world 1")
            un, t_setup = prepared_union(cls, m, prm, 1, geom, device)
            if i + 1 < len(runs):
                futs[i + 1] = start(i + 1)
            ranks = futs[i].result()
            fig = out[label] = held_against_union(
                label, ranks, un, n, geom is not None, smi, device)
            fig["union_setup_s"] = t_setup
            del un
            torch.cuda.empty_cache()
            for k in kernels.ALL:
                launches[k] += fig["launches_rank0"][k.name]
        if device == "cuda":
            wall_clock("phase 12: the refusal")
            out["refusal"] = refusal.result()
            print(f"{n_cards + 1} NCCL ranks on {n_cards} card(s) refused "
                  f"before any collective: {out['refusal']}", flush=True)
        wall_clock("phase 12: the CLI under torchrun's environment")
        out["cli"] = nccl_cli(small, os.path.join(tmp, "cli"), device)
        if n_cards >= 2:
            wall_clock("phase 12: two cards")
            out["two_cards"] = ranks_against_union(
                f"halo {MAIN_SIDE}^3", HaloSmoother, mesh, params,
                MAIN_ITERS, None, {}, 2, os.path.join(tmp, "two"), pool,
                smi)
        else:
            out["two_cards"] = None
            print("two NCCL ranks on two cards: not run, this machine has "
                  f"{n_cards} card (NCCL refuses two ranks on one card)",
                  flush=True)
    out["launches"] = launches
    return out


def memo_shards(classes):
    """Phase 13: each class's host shard build memoized for the phase
    (keyed by the mesh and the shard count): the card group and the
    union it is held against start from the same shards, built once."""
    import unittest.mock

    from smoothmesh_torch.tracing import Trace

    stack = contextlib.ExitStack()
    for cls in classes:
        build, cache = cls._shards_of, {}

        def memo(mesh, n_shards, trace, _build=build, _cache=cache):
            key = (id(mesh), n_shards)
            if key not in _cache:
                built = Trace()
                _cache[key] = (mesh, _build(mesh, n_shards, built), built)
            trace.merge(_cache[key][2])
            return _cache[key][1]

        stack.enter_context(unittest.mock.patch.object(
            cls, "_shards_of", staticmethod(memo)))
    return stack


def card_holders_identical(cs, un) -> bool:
    """Phase 13: every holder of a shared point holds its owner's bits,
    in the group's points (the union's layout, read through the union's
    tables)."""
    rows = un.sync.rows
    own = torch.as_tensor(un.union.owner_rows(), device=rows.device)
    pts = cs.points.to(rows.device)
    return torch.equal(pts[rows], pts[own])


def cards_against_union(label: str, cls, mesh, params, n: int, geometry,
                        devices, smi: str, report: bool) -> dict:
    """Phase 13: ``cls(..., devices=devices)`` (one shard a device, one
    host thread each, in this process) against ``cls`` with as many
    shards on devices[0] (the union, its batch captured), each stepping
    ``n`` times from the same start.  Required: results, points,
    ``denormalize()`` bit-equal; the holders of a shared point
    bit-identical; each member's kernel launches equal to the union's
    (one launch over all its shards an iteration, the same batches and
    reruns) and the members' counts summing to the total; with
    ``report``, ``quality()`` within NCCL_QUALITY_REL relative (the
    disjoint one's, the global report) or Q_REL_TOL (the halo's, whose
    float32 parts are summed a member at a time, as the ranks sum them),
    K7 launched once by each halo member, by rank 0 alone in the
    disjoint one -> the figures (``launches``: the group's, steps and
    report)."""
    from smoothmesh_torch import kernels
    from smoothmesh_torch.parallel.sharded import ShardedSmoother

    world = len(devices)
    dev0 = devices[0]
    t0 = time.perf_counter()
    un = cls(mesh, params, n_shards=world, device=dev0)
    if geometry is not None:
        un.enable_boundary_smoothing(*geometry)
    un.prepare_batch()
    t_union = time.perf_counter() - t0
    kernels.reset_launches()
    want = un.steps(n)
    want_launches = {k.name: k.launches for k in kernels.ALL}
    t0 = time.perf_counter()
    cs = cls(mesh, params, devices=devices)
    if geometry is not None:
        cs.enable_boundary_smoothing(*geometry)
    t_cards = time.perf_counter() - t0
    kernels.reset_launches()
    got = cs.steps(n)
    total = {k.name: k.launches for k in kernels.ALL}
    members = {r: {k.name: k.member_launches.get(r, 0) for k in kernels.ALL}
               for r in range(world)} if world > 1 else {0: total}
    row = lambda r: dataclasses.astuple(r)[:3] + dataclasses.astuple(r)[4:]
    where = f"{label}, {world} member(s) on {[str(d) for d in devices]}"
    require([row(r) for r in got] == [row(r) for r in want],
            f"{where}: results differ from the union's")
    require(torch.equal(cs.points.cpu(), un.points.cpu()),
            f"{where}: points not bit-equal to the union's")
    require(np.array_equal(cs.denormalize(), un.denormalize()),
            f"{where}: denormalize() not bit-equal")
    require(card_holders_identical(cs, un), f"{where}: the holders of a "
            "shared point differ")
    on_card = dev0.type == "cuda"
    for r, counts in members.items():
        require(counts == want_launches or not on_card,
                f"{where}: member {r} launched {counts}, the union "
                f"{want_launches}")
    require(all(total[k] == sum(m[k] for m in members.values())
                for k in total), f"{where}: the members' launches "
            f"{members} do not sum to the total {total}")
    worst = None
    if report:
        if isinstance(un, ShardedSmoother):
            # one global topology for both reports
            un.quality()
            cs.members[0]._report_td = un._report_td
        kernels.reset_launches()
        rep = cs.quality()
        q_launches = {k.name: k.launches for k in kernels.ALL if k.launches}
        # the halo's members report their claims each, the disjoint
        # decomposition's rank 0 the global report
        gather = kernels.TABLE_GATHER
        for r in range(world):
            mine = 1 if r == 0 or not isinstance(un, ShardedSmoother) else 0
            require(gather.member_launches.get(r, 0) == mine or world == 1
                    or not on_card, f"{where}: member {r} launched "
                    f"{gather.name} {gather.member_launches.get(r, 0)} "
                    f"times in the report, expected {mine}")
        for k in kernels.ALL:
            total[k.name] += k.launches
        worst = quality_worst_rel(rep, un.quality())
        # the disjoint report is one global report of the same points;
        # the halo's sums float32 parts a member at a time, as the ranks
        # do (phase 12), where the union's is one part
        q_tol = (NCCL_QUALITY_REL if world == 1
                 or isinstance(un, ShardedSmoother) else Q_REL_TOL)
        require(worst <= q_tol, f"{where}: quality() {worst:.3g} "
                f"relative from the union's (at most {q_tol})")
    fig = dict(world=world, devices=[str(d) for d in devices],
               ms_last_batch_cards=got[-1].wall_ms,
               ms_first_batch_cards=got[0].wall_ms,
               ms_last_batch_union=want[-1].wall_ms,
               setup_s_cards=t_cards, setup_s_union=t_union,
               quality_worst_rel=worst, launches_members=members)
    print(f"{where} in this process against {cls.__name__}(n_shards="
          f"{world}) on {dev0}: results, points and denormalize() "
          f"bit-equal, holders identical"
          + (f", quality() within {worst:.3g} relative" if report else "")
          + f"; {n} iterations in batches of {un.iter_batch}: "
          f"{got[-1].wall_ms:.3f} ms/iteration in the group's last batch "
          f"(eager; its first {got[0].wall_ms:.3f}), "
          f"{want[-1].wall_ms:.3f} for the union (graph replays); set-up "
          f"{t_cards:.2f} s (the union {t_union:.2f} s, shards built once "
          f"for both); each member launched "
          + "; ".join(f"{r}: " + ", ".join(
              f"{k.split()[0]} {v}" for k, v in c.items() if v)
                      for r, c in members.items())
          + (f"; the report launched {q_launches}" if report else "")
          + f" on {smi}", flush=True)
    del cs, un
    if on_card:
        torch.cuda.empty_cache()
    fig["launches"] = total
    return fig


def cards_cli(mesh, workdir: str, n_cards: int, device: str = "cuda"
              ) -> dict:
    """Phase 13: the CLI with -device cuda -parallel in a subprocess with
    no RANK in its environment: exit 0, its log naming the cards in
    this process and their count, the written points equal to the
    disjoint union's at that many shards in this process.
    ``device="cpu"`` rehearses it (one shard, "one process on cpu")."""
    from smoothmesh_torch.io.case import FoamCase
    from smoothmesh_torch.parallel.sharded import ShardedSmoother
    from smoothmesh_torch.params import SmoothingParams

    root = os.path.join(workdir, "case")
    write_case(root, mesh)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = here
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "smoothmesh_torch.cli", "-case", root,
         "-parallel", "-device", device, "-centroidalIters",
         str(SMALL_ITERS), "-writeFormat", "binary"], env=env, cwd=here,
        capture_output=True, text=True, timeout=NCCL_TIMEOUT_S)
    t_sub = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    require(proc.returncode == 0, f"the CLI's -parallel without a launcher "
            f"exited with {proc.returncode}: {log[-1500:]}")
    n = n_cards if device == "cuda" else 1
    line = (f"Running sharded over {n} shards ("
            + (f"{n} cards in this process)" if device == "cuda"
               else "one process on cpu)"))
    require(line in log, f"the CLI's -parallel without a launcher: no "
            f"'{line}' in {log[-800:]}")
    case = FoamCase(root)
    un = ShardedSmoother(case.read_mesh(0.0), SmoothingParams(
        centroidal_iters=SMALL_ITERS), n_shards=n, device=device)
    un.steps(SMALL_ITERS)
    got = case.read_mesh(float(SMALL_ITERS)).points
    require(np.array_equal(got, un.denormalize()),
            "the CLI's -parallel without a launcher wrote other points "
            f"than ShardedSmoother(n_shards={n}) in this process")
    print(f"CLI -device {device} -parallel without a launcher (no RANK): "
          f"exit 0 in {t_sub:.1f} s with its start-up, '{line}', the "
          f"{mesh.n_points} written points equal to ShardedSmoother("
          f"n_shards={n})'s in this process", flush=True)
    return dict(subprocess_s=t_sub)


def cards_phase(mesh, smi: str, device: str = "cuda") -> dict:
    """Phase 13: the decompositions over several devices in one process,
    one host thread a device (``devices=``) -> the figures and the
    launches of the group's runs, summed.  ``device="cpu"`` rehearses it
    on the CPU (the members there share the one CPU device)."""
    from smoothmesh_torch import kernels
    from smoothmesh_torch.driver import Smoother
    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother
    from smoothmesh_torch.params import SmoothingParams
    from smoothmesh_torch.testcases import bench_dome_geometry

    on_card = device == "cuda"
    n_cards = torch.cuda.device_count()
    peers = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
             for a in range(n_cards) for b in range(n_cards) if a != b}
    print(f"{n_cards} card(s), peer access between cards {peers or 'n/a'}: "
          f"{smi}", flush=True)
    out = dict(cards=n_cards, peer_access=peers)
    params = SmoothingParams(centroidal_iters=MAIN_ITERS, rel_tol=0.0)
    small = bench_mesh(SMALL_SIDE)
    bparams = dataclasses.replace(boundary_params(SMALL_ITERS),
                                  max_step_length=SMALL_BND_MAX_STEP)
    geometry = bench_dome_geometry()[1:]
    one = [torch.device(device, 0) if on_card else torch.device("cpu")]
    runs = [(f"halo {MAIN_SIDE}^3", HaloSmoother, mesh, params, MAIN_ITERS,
             None, one, False),
            (f"disjoint {MAIN_SIDE}^3", ShardedSmoother, mesh, params,
             MAIN_ITERS, None, one, False),
            (f"halo {MAIN_SIDE}^3", HaloSmoother, mesh, params, MAIN_ITERS,
             None, one * 2, True),
            (f"disjoint {MAIN_SIDE}^3", ShardedSmoother, mesh, params,
             MAIN_ITERS, None, one * 2, True),
            (f"halo {SMALL_SIDE}^3 boundary", HaloSmoother, small, bparams,
             SMALL_ITERS, geometry, one * 2, True)]
    if on_card:
        for world in (2, 4):
            if n_cards >= world:
                cards = [torch.device("cuda", i) for i in range(world)]
                runs += [(f"halo {MAIN_SIDE}^3", HaloSmoother, mesh, params,
                          MAIN_ITERS, None, cards, False),
                         (f"disjoint {MAIN_SIDE}^3", ShardedSmoother, mesh,
                          params, MAIN_ITERS, None, cards, False)]
    launches = {k.name: 0 for k in kernels.ALL}
    figs = []
    with memo_shards((HaloSmoother, ShardedSmoother)):
        for label, cls, m, prm, n, geom, devs, report in runs:
            wall_clock(f"phase 13: {label}, {len(devs)} member(s) on "
                       f"{', '.join(map(str, devs))}")
            fig = cards_against_union(label, cls, m, prm, n, geom, devs,
                                      smi, report)
            fig["label"] = label
            for name, c in fig.pop("launches").items():
                launches[name] += c
            figs.append(fig)
    out["runs"] = figs
    if n_cards < 2:
        print("several cards: not run, this machine has "
              f"{n_cards} card (world 2 ran with both members on cuda:0, "
              "each on its own stream: no copy between cards)",
              flush=True)
    if on_card:
        wall_clock("phase 13: the refusal")
        try:
            Smoother(small, SmoothingParams(centroidal_iters=1),
                     n_devices=n_cards + 1)
        except ValueError as e:
            msg = str(e)
        else:
            raise RuntimeError(f"chip_smoke: Smoother(n_devices="
                               f"{n_cards + 1}) on {n_cards} card(s) ran; "
                               "it must be refused")
        want = (f"n_devices={n_cards + 1} puts one shard on each of "
                f"{n_cards + 1} cards, and this machine has {n_cards}")
        require(want in msg, f"the refusal: {msg}")
        out["refusal"] = msg
        print(f"Smoother(n_devices={n_cards + 1}) refused before any "
              f"build: {msg}", flush=True)
    wall_clock("phase 13: the CLI without a launcher")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as tmp:
        out["cli"] = cards_cli(small, tmp, n_cards, device)
    out["launches"] = launches
    return out


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
    from smoothmesh_torch import kernels, native
    from smoothmesh_torch.driver import PLAIN_STAGES, Smoother, iteration_body
    from smoothmesh_torch.ops import constraints as con
    from smoothmesh_torch.ops import smoothing as smo
    from smoothmesh_torch.params import SmoothingParams

    wall_clock("phase 1")
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
    t0 = time.perf_counter()
    native.MESHCOMPILER.load()
    print(f"native topology compiler: {time.perf_counter() - t0:.2f} s, "
          f"{native.MESHCOMPILER.builds} compile(s) now "
          f"({native.MESHCOMPILER.library_path().name})", flush=True)
    for k in kernels.ALL:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k.source}: {line.strip()}")

    wall_clock("phase 2")
    # -- 2. the main path's mesh --------------------------------------------
    t0 = time.perf_counter()
    mesh = bench_mesh(MAIN_SIDE)
    t_mesh = time.perf_counter() - t0
    params = SmoothingParams(centroidal_iters=MAIN_ITERS, rel_tol=0.0)
    t0 = time.perf_counter()
    with setup_timers() as t_parts:
        sm = Smoother(mesh, params, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    topo, td, N = sm.topo, sm.td, sm.topo.n_points
    print(f"mesh: {MAIN_SIDE}^3 hex, {N} points, {topo.n_cells} cells, "
          f"{topo.n_faces} faces; generated in {t_mesh:.1f} s, "
          f"Smoother set up in {t_setup:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in t_parts.items())
          + f", the rest {t_setup - sum(t_parts.values()):.2f} s",
          flush=True)
    native_tables_check(sm, smi)
    fa_bytes = nbytes(*(td[k] for k in FACE_ANGLE_KEYS))
    print(f"device topology: {nbytes(*td.values()) / 1e9:.3f} GB, of "
          f"which the face angle's tables {fa_bytes / 1e9:.3f} GB "
          f"({topo.n_edges} edges)", flush=True)

    wall_clock("phase 3")
    # -- 3. each kernel against its plain version ---------------------------
    p = sm.params
    max_step = p.max_step_length * sm._scale
    min_edge = p.min_edge_length * sm._scale
    pts = sm.points
    fp, fm, fn = td["face_points"], td["face_mask"], td["face_npoints"]
    pc, pcm = td["point_cells"], td["point_cells_mask"]
    pp, ppm = td["point_points"], td["point_points_mask"]
    td_p = with_plain_tables(td, topo)  # + K2's, K4's plain versions' tables
    own, cf, cfm = td_p["owner"], td_p["cell_faces"], td_p["cell_faces_mask"]
    cfw = td["cell_face_words"]
    pfm, wpv, wnx = (td_p["point_faces_mask"], td_p["wedge_prev"],
                     td_p["wedge_next"])
    words = td["wedge_words"]
    intern = td["is_internal_point"]
    none = torch.zeros(N, dtype=torch.bool, device=sm.device)

    fg_p = geo.face_centres_areas_plain(pts, fp, fm, fn)
    cc_p, vol_p = geo.cell_centres_vols_plain(fg_p, td_p)
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
         check_exact, fg_p,
         (nbytes(pts, fp, fn) + 3 * nbytes(fg_p.centres), 40 * n_fv)),
        (lambda: geo.cell_centres_vols(fg_p, td),
         lambda: geo.cell_centres_vols_plain(fg_p, td_p),
         check_exact, (cc_p, vol_p),
         (nbytes(fg_p.centres, fg_p.areas, cfw, cc_p, vol_p), 28 * n_cf)),
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
    # the byte bounds on the unpacked tables the words replace: owner,
    # cell_faces and cell_faces_mask (one 4-byte word a slot against 5
    # bytes and a 4-byte owner a face); wedge_prev, wedge_next and
    # point_faces_mask; edge_cell_f0, edge_cell_f1 and edge_cells_mask
    # (9 bytes a slot against one 2-byte word)
    for k, old_bytes in (
            (kernels.CELL_CENTRES, nbytes(fg_p.centres, fg_p.areas, own, cf,
                                          cfm, cc_p, vol_p)),
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
    # K1 and K2: the path the main inputs take (template <bool kRow>:
    # the register path for rows of exactly its width, else the general)
    for k, name, threads, width, row_w, rows, unit in (
            (kernels.FACE_GEOMETRY, "face_geometry_kernel", K1_THREADS,
             fp.shape[1], K1_ROW_W, topo.n_faces, "face"),
            (kernels.CELL_CENTRES, "cell_centres_kernel", K2_THREADS,
             cfw.shape[1], K2_ROW_W, topo.n_cells, "cell")):
        regs, smem, spill = resources_of(
            k, f"{name}ILb{int(width == row_w)}E")
        results[k]["launch"] = dict(
            blocks=-(-rows // threads), threads=threads,
            path="register row" if width == row_w else "general",
            row_width=width, registers=regs, static_shared_bytes=smem,
            spilled_bytes=spill)
        print(f"{k.name} launch at {MAIN_SIDE}^3: {-(-rows // threads)} "
              f"blocks of {threads} threads, one {unit} a thread, rows of "
              f"{width} ({results[k]['launch']['path']} path); {regs} "
              f"registers, {smem} bytes static shared, {spill} bytes "
              "spilled", flush=True)
    edge_cases = k1_k2_edge_cases(pts, fp, fm, fn, fg_p, td, td_p)
    for k, tag in ((kernels.FACE_GEOMETRY, "K1"),
                   (kernels.CELL_CENTRES, "K2")):
        results[k]["edge_cases"] = {n: v for n, v in edge_cases.items()
                                    if n.startswith(tag)}
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
    results[kernels.TABLE_GATHER] = gather_phase(td_p, cc_p, fg_p, smi)

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
    del td_p, pfm, wpv, wnx, own, cf, cfm

    wall_clock("phase 4")
    # -- 4. the default path through the user's entry point ------------------
    main = batched_against_one_by_one(
        sm, MAIN_ITERS, f"default path at {MAIN_SIDE}^3", smi,
        {k: (0 if k in (kernels.RAYCAST, kernels.TABLE_GATHER,
                        kernels.POINT_NORMALS)
             else MAIN_ITERS) for k in kernels.ALL})
    steps, launches, t_run = main["steps"], main["launches"], main["t_run"]
    for r in steps:
        require(math.isfinite(r.residual), f"residual {r.residual}")
        require(0 <= r.n_frozen <= N, f"nFrozenPoints {r.n_frozen}")
    for r in (steps[0], steps[1], steps[-1]):
        print(f"Smoothing iteration={r.iteration} "
              f"nFrozenPoints={r.n_frozen} residual={r.residual:.6g}")
    fg = geo.face_centres_areas(sm.points, fp, fm, fn)
    _, vol = geo.cell_centres_vols(fg, td)
    vmin = float(vol.min())
    require(vmin > 0, f"cell volume {vmin} at the end")
    walls = [r.wall_ms for r in steps]
    iter_ms = float(np.mean(walls))
    print(f"default path (face angle on), batched: {MAIN_ITERS} iterations "
          f"in {t_run:.2f} s; {iter_ms:.3f} ms/iteration (median "
          f"{np.median(walls):.3f}, max {max(walls):.3f} at iteration "
          f"{int(np.argmax(walls)) + 1} of {len(walls)}), "
          f"{N / (iter_ms / 1e3):,.0f} point-updates/s on {smi}; "
          f"peak device memory {main['peak_gb']:.2f} GB; min cell volume "
          f"{vmin:.4g} (normalized units)", flush=True)
    del fg, vol
    quality = quality_phase(sm, smi)
    mesh_int, orders = sm.mesh_internal, sm._orders
    del sm, td, pts

    wall_clock("phase 5")
    # -- 5. the boundary path on the same mesh and topology -------------------
    bnd = boundary_path(topo, mesh_int, smi)
    results[kernels.RAYCAST] = bnd["record"]
    results[kernels.POINT_NORMALS] = bnd["k9_record"]
    results[kernels.PREDICTOR]["share_test_points_boundary"] = \
        bnd["k3_share_test_points"]

    wall_clock("phase 6")
    # -- 6. 32^3: kernels against plain versions over 8 iterations ----------
    small = bench_mesh(SMALL_SIDE)
    configs = [("face angle off", dict(face_angle_constraint=False)),
               ("default band", {})]
    configs += [(f"band {lo, hi}", dict(min_angle=lo, max_angle=hi))
                for lo, hi in (TIGHT_BAND, TIGHTER_BAND)]
    small_exact, fa_stops = {}, {}
    for label, kw in configs:
        sk = Smoother(small, SmoothingParams(
            centroidal_iters=SMALL_ITERS, rel_tol=0.0, **kw), device="cuda")
        n_bnd = int((~sk.td["is_internal_point"]).sum())
        pts_p = sk.points.clone()
        rk, fa_stops[label] = small_batched_against_one_by_one(
            sk, SMALL_ITERS, f"{SMALL_SIDE}^3 {label}")
        td_p = with_plain_tables(sk.td, sk.topo)
        exact = small_exact[label] = {}
        for i, r in enumerate(rk):
            pts_p, _, res_p, nf_p, _, _ = iteration_body(
                pts_p, td_p, sk.params, sk._scale, exact_stages(exact))
            res_p, nf_p = float(res_p), int(nf_p)
            where = f"{SMALL_SIDE}^3 {label}, iteration {i + 1}"
            require(abs(r.residual - res_p) < 2e-3,
                    f"{where}: residual {r.residual} (kernels) vs {res_p} "
                    "(plain)")
            require(abs(r.n_frozen - nf_p) <= 0.1 * nf_p + 10,
                    f"{where}: nFrozen {r.n_frozen} (kernels) vs {nf_p} "
                    "(plain)")
        require(exact["calls"] == SMALL_ITERS and exact["k1_bits"] == 0
                and exact["k2_bits"] == 0 and exact["k4_mismatches"] == 0
                and exact["k5_bits"] == 0 and exact["k4_tight_frozen"] > 0,
                f"{SMALL_SIDE}^3 {label}: K1, K2, K4 and K5 against their "
                f"plain versions on each iteration's inputs: {exact}")
        print(f"{SMALL_SIDE}^3 x {SMALL_ITERS}, {label}: kernels and plain "
              f"versions agree (last residual {rk[-1].residual:.6g} vs "
              f"{res_p:.6g}, nFrozen {rk[-1].n_frozen} vs {nf_p}, of "
              f"which {n_bnd} boundary points); on each iteration's "
              f"inputs K1 {exact['k1_bits']} and K2 {exact['k2_bits']} "
              f"values not bit-equal, K4 {exact['k4_mismatches']} mask "
              "mismatches at the "
              f"main and tight thresholds ({exact['k4_tight_frozen']} "
              f"frozen at the tight ones in all), K5 "
              f"{exact['k5_bits']} values not bit-equal, max abs err "
              f"{exact['k5_max_abs_err']:.3g}", flush=True)
    require(rk[-1].n_frozen > n_bnd,
            f"{SMALL_SIDE}^3, band {TIGHTER_BAND}: no internal point froze")
    for band in (TIGHT_BAND, TIGHTER_BAND):
        require(fa_stops[f"band {band}"] == 1, f"{SMALL_SIDE}^3 band "
                f"{band}: {fa_stops[f'band {band}']} face-angle stops")

    from smoothmesh_torch.testcases import bench_dome_geometry

    sk = Smoother(small, dataclasses.replace(
        boundary_params(SMALL_ITERS), max_step_length=SMALL_BND_MAX_STEP),
        device="cuda")
    sk.enable_boundary_smoothing(*bench_dome_geometry()[1:])
    pts_p, nrm_p = sk.points.clone(), sk.normals.clone()
    rk, _ = small_batched_against_one_by_one(
        sk, SMALL_ITERS, f"{SMALL_SIDE}^3 boundary path")
    td_p = with_plain_tables(sk.td, sk.topo)
    exact = small_exact["boundary path"] = {}
    for i, r in enumerate(rk):
        pts_p, nrm_p, res_p, nf_p, nm_p, _ = iteration_body(
            pts_p, td_p, sk.params, sk._scale, exact_stages(exact),
            normals=nrm_p, smoothing_surface=sk.smoothing_surface,
            layer=sk.layer, bnd=sk.bnd)
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
    require(exact["calls"] == SMALL_ITERS and exact["k1_bits"] == 0
            and exact["k2_bits"] == 0 and exact["k4_mismatches"] == 0
            and exact["k5_bits"] == 0 and exact["k9_bits"] == 0,
            f"{SMALL_SIDE}^3 boundary path: K1, K2, K4, K5 and K9 against "
            f"their plain versions on each iteration's inputs: {exact}")
    print(f"{SMALL_SIDE}^3 x {SMALL_ITERS}, boundary path (layers + boundary"
          f" smoothing, max step {SMALL_BND_MAX_STEP}): kernels and plain "
          f"versions agree (last residual {rk[-1].residual:.6g} vs "
          f"{res_p:.6g}, nFrozen {rk[-1].n_frozen} vs {nf_p}, ray misses "
          f"{rk[-1].n_ray_miss} vs {nm_p}; largest point difference at the "
          f"end {moved:.3g} < {BND_POINT_TOL}, normalized units); on each "
          f"iteration's inputs K1 {exact['k1_bits']}, K2 {exact['k2_bits']}"
          f" and K5 {exact['k5_bits']} values not bit-equal, K4 "
          f"{exact['k4_mismatches']} mask mismatches, K9 "
          f"{exact['k9_bits']} values or flags", flush=True)

    wall_clock("phase 7")
    # -- 7. the CLI at full size ------------------------------------------
    del small, sk, pts_p, nrm_p, td_p
    torch.cuda.empty_cache()
    cli = cli_phase(mesh, smi)

    wall_clock("phase 9")
    # -- 9. the halo decomposition ------------------------------------------
    torch.cuda.empty_cache()
    halo = halo_phase(mesh, mesh_int, topo, orders, smi)

    wall_clock("phase 10")
    # -- 10. the disjoint decomposition -------------------------------------
    torch.cuda.empty_cache()
    sharded = sharded_phase(mesh, mesh_int, topo, orders, smi,
                            {k: r["ms"] for k, r in results.items()})

    wall_clock("phase 11")
    # -- 11. float64 on the card ---------------------------------------------
    float64 = float64_phase(mesh_int, topo, steps, smi)

    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother

    # phase 12's unions at one shard and phase 13's at one shard start
    # from the same host shard builds
    with memo_shards((HaloSmoother, ShardedSmoother)):
        wall_clock("phase 12")
        # -- 12. the decompositions one rank a card over NCCL ----------------
        torch.cuda.empty_cache()
        nccl = nccl_phase(mesh, smi)

        wall_clock("phase 13")
        # -- 13. the decompositions over several devices in one process ----
        torch.cuda.empty_cache()
        cards = cards_phase(mesh, smi)

    wall_clock("phase 8")
    # -- 8. the record ----------------------------------------------------
    main_path = {kernels.RAYCAST: bnd["launches"],
                 kernels.POINT_NORMALS: bnd["launches"],
                 kernels.TABLE_GATHER: cli["launches"]}
    for k in results:
        results[k]["launches"] = main_path.get(k, launches)[k]
        results[k]["launches_default_path"] = launches[k]
        results[k]["launches_boundary_path"] = bnd["launches"][k]
        results[k]["launches_cli"] = cli["launches"][k]
        results[k]["launches_halo"] = halo["launches"][k]
        results[k]["launches_sharded"] = sharded["launches"][k]
        results[k]["launches_nccl"] = nccl["launches"][k]
        results[k]["launches_cards"] = cards["launches"][k.name]
    for k in (kernels.FACE_GEOMETRY, kernels.CELL_CENTRES, kernels.FREEZE,
              kernels.FACE_ANGLES):
        results[k]["small_runs_exact"] = small_exact
    results[kernels.TABLE_GATHER]["quality_report_ms"] = quality["ms"]
    results[kernels.TABLE_GATHER]["quality_report_plain_ms"] = \
        quality["plain_ms"]
    print(json.dumps({"halo": {k: v for k, v in halo.items()
                               if k != "launches"}}))
    print(json.dumps({"sharded": {k: v for k, v in sharded.items()
                                  if k != "launches"}}))
    print(json.dumps({"float64": float64}))
    print(json.dumps({"nccl": {k: v for k, v in nccl.items()
                               if k != "launches"}}))
    print(json.dumps({"cards": {k: v for k, v in cards.items()
                                if k != "launches"}}))
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
