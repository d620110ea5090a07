"""Command-line interface mirroring the reference ``smoothMesh`` CLI.

All 19 application options of the reference (src/smoothMesh.C:1637-1784)
plus the standard OpenFOAM flags it inherits (-case, -time, -overwrite,
-parallel), and the options of the JAX package's CLI (-dtype,
-profileDir, -checkMesh, -allowRayMiss, -writeFormat), with the same
defaults and printed text.  Accepts OpenFOAM-style single-dash long
options (``-centroidalIters 50``) as well as double-dash GNU style.

One option more: ``-device`` (default ``cuda``) names the torch device,
as choosing a JAX platform does for the JAX package.  ``-device cpu``
runs the kernels' plain PyTorch versions; without it, a machine with no
CUDA device raises.  On ``cuda``, ``-dtype float64`` runs the plain
versions on the card (no kernel), as the JAX CLI's ``-dtype float64``
runs XLA on its device and no Pallas kernel.

``-parallel`` runs the disjoint domain decomposition
(``parallel.sharded.ShardedSmoother``), as the JAX CLI does, over all
the shards available (:func:`parallel_shards`): one a rank where the
process is a ``torch.distributed`` rank (``torchrun --nproc-per-node
N``: on ``cuda`` NCCL, each rank on its own card ``cuda:LOCAL_RANK``;
on ``cpu`` gloo; rank 0 prints and writes), else one a card on
``cuda``, on all the machine's cards in this process, one host thread a
card (``ShardedSmoother(devices=)``, as the JAX CLI's ShardedSmoother
takes ``jax.devices()``), else one on ``cpu``.

Patch list options accept the reference syntax: a bare word
(``-layerPatches walls``) or a parenthesized list with regexes
(``-layerPatches '( stator "rotor.*" )'``), see src/smoothMesh.C:1747-1763.

Run as ``python -m smoothmesh_torch.cli -case DIR ...`` or
``smoothmesh-torch -case DIR ...``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch

from smoothmesh_torch.device import resolve_device
from smoothmesh_torch.io.case import FoamCase
from smoothmesh_torch.mesh.topology import boundary_point_mask
from smoothmesh_torch.params import SmoothingParams

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parse_patch_list(spec: str) -> List[str]:
    spec = spec.strip()
    if spec.startswith("(") and spec.endswith(")"):
        spec = spec[1:-1]
    return [tok.strip('"') for tok in spec.split()]


def _bool(v: str) -> bool:
    return v.lower() in ("1", "true", "yes", "on")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="smoothmesh-torch",
        description="Move internal mesh points to increase mesh quality "
        "(PyTorch + CUDA reimplementation of smoothMesh)",
        prefix_chars="-",
    )
    a = ap.add_argument
    a("-case", "--case", default=".", help="case directory")
    a("-time", "--time", default=None,
      help="Specify the time (default is latest)")
    a("-overwrite", "--overwrite", action="store_true")
    a("-parallel", "--parallel", action="store_true",
      help="run the disjoint domain decomposition over all available "
      "shards: the torch.distributed ranks (torchrun; NCCL on cuda, one "
      "card a rank, gloo on cpu), else the CUDA devices (in this process, "
      "one shard a card), else one")
    a("-centroidalIters", "--centroidalIters", type=int, default=1000)
    a("-maxStepLength", "--maxStepLength", type=float, default=None)
    a("-relStepFrac", "--relStepFrac", type=float, default=0.5)
    a("-edgeAngleConstraint", "--edgeAngleConstraint", type=_bool,
      default=True)
    a("-faceAngleConstraint", "--faceAngleConstraint", type=_bool,
      default=True)
    a("-minEdgeLength", "--minEdgeLength", type=float, default=None)
    a("-totalMinFreeze", "--totalMinFreeze", type=_bool, default=False)
    a("-minAngle", "--minAngle", type=float, default=35.0)
    a("-maxAngle", "--maxAngle", type=float, default=160.0)
    a("-layerMaxBlendingFraction", "--layerMaxBlendingFraction", type=float,
      default=0.3)
    a("-layerEdgeLength", "--layerEdgeLength", type=float, default=None)
    a("-layerExpansionRatio", "--layerExpansionRatio", type=float,
      default=1.3)
    a("-minLayers", "--minLayers", type=int, default=1)
    a("-maxLayers", "--maxLayers", type=int, default=4)
    a("-layerPatches", "--layerPatches", default=None)
    a("-smoothingPatches", "--smoothingPatches", default=None)
    a("-internalSmoothingBlendingFraction",
      "--internalSmoothingBlendingFraction", type=float, default=0.0)
    a("-relTol", "--relTol", type=float, default=0.02)
    a("-writeInterval", "--writeInterval", type=int, default=None)
    a("-dtype", "--dtype", default=None,
      help="coordinate dtype on the device (float32/float64): on cuda "
      "float32 runs the CUDA kernels, float64 their plain PyTorch "
      "versions on the card")
    a("-profileDir", "--profileDir", default=None,
      help="capture a torch.profiler trace of the smoothing loop")
    a("-checkMesh", "--checkMesh", action="store_true",
      help="print a checkMesh-style quality report after smoothing")
    a("-allowRayMiss", "--allowRayMiss", action="store_true",
      help="freeze boundary points whose surface-snap ray cast finds no "
      "intersection instead of aborting (the reference aborts, "
      "bPS.C:933-940)")
    a("-writeFormat", "--writeFormat", default="ascii",
      choices=("ascii", "binary"),
      help="polyMesh output format (OpenFOAM writeFormat equivalent; "
      "binary meshes are also READ transparently)")
    a("-device", "--device", default="cuda",
      help="torch device: cuda (the CUDA kernels in float32) or cpu "
      "(their plain PyTorch versions)")
    return ap


def parallel_shards(device: torch.device) -> Tuple[int, bool,
                                                  torch.device]:
    """``-parallel``'s shard count, whether this process is one
    ``torch.distributed`` rank of them, and the device it runs on: the
    world size where the environment names this process's ``RANK`` and
    the ``WORLD_SIZE`` (as ``torchrun`` does; the process group is
    joined here at ``MASTER_ADDR``:``MASTER_PORT`` unless it is
    already, by ``parallel.ranks.join``'s rule: NCCL on the card
    ``cuda:LOCAL_RANK`` on ``cuda``, gloo on ``cpu``), else on ``cuda``
    the machine's cards, ``torch.cuda.device_count()``, one shard a card
    in this process, else 1."""
    import torch.distributed as dist

    from smoothmesh_torch.parallel.ranks import join

    env = os.environ
    if dist.is_initialized():
        return dist.get_world_size(), True, device
    if "RANK" in env and "WORLD_SIZE" in env:
        addr = env.get("MASTER_ADDR", "localhost")
        device = join(device, int(env["RANK"]), int(env["WORLD_SIZE"]),
                      init_method=f"tcp://{addr}:{env['MASTER_PORT']}")
        return dist.get_world_size(), True, device
    if device.type == "cuda":
        return torch.cuda.device_count(), False, device
    return 1, False, device


def main(argv: Sequence[str] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.dtype is not None and args.dtype not in DTYPES:
        print(f"FATAL: -dtype {args.dtype}: expected one of "
              f"{', '.join(DTYPES)}", file=sys.stderr)
        return 1
    device = resolve_device(args.device)
    if not args.parallel:
        return _smooth(args, device, None, False)
    import torch.distributed as dist

    joined = not dist.is_initialized()
    n_shards, distributed, device = parallel_shards(device)
    joined = joined and distributed
    try:
        if not distributed or dist.get_rank() == 0:
            return _smooth(args, device, n_shards, distributed)
        # another rank: the same run, collectives included, printing and
        # writing nothing
        with contextlib.redirect_stdout(io.StringIO()):
            return _smooth(args, device, n_shards, distributed)
    finally:
        if joined:
            dist.destroy_process_group()


def _smooth(args, device: torch.device, n_shards, distributed: bool) -> int:
    """The run of :func:`main` from the parsed options; ``n_shards``:
    None on one device, else -parallel's shard count (over the ranks
    with ``distributed``, where only rank 0 writes)."""
    case = FoamCase(args.case)
    delta_t = case.delta_t()
    if delta_t < 1e-30:
        print(f"FATAL: Time step (deltaT) value {delta_t} specified in "
              "controlDict is too small", file=sys.stderr)
        return 1

    if args.time is None:
        t0 = case.latest_time()
    elif args.time == "constant":
        t0 = 0.0
    else:
        t0 = float(args.time)

    params = SmoothingParams(
        centroidal_iters=args.centroidalIters,
        rel_tol=args.relTol,
        min_edge_length=args.minEdgeLength,
        max_step_length=args.maxStepLength,
        rel_step_frac=args.relStepFrac,
        total_min_freeze=args.totalMinFreeze,
        edge_angle_constraint=args.edgeAngleConstraint,
        face_angle_constraint=args.faceAngleConstraint,
        min_angle=args.minAngle,
        max_angle=args.maxAngle,
        layer_max_blending_fraction=args.layerMaxBlendingFraction,
        layer_edge_length=args.layerEdgeLength,
        layer_expansion_ratio=args.layerExpansionRatio,
        min_layers=args.minLayers,
        max_layers=args.maxLayers,
        layer_patches=(parse_patch_list(args.layerPatches)
                       if args.layerPatches else ()),
        smoothing_patches=(parse_patch_list(args.smoothingPatches)
                           if args.smoothingPatches else (".*",)),
        internal_smoothing_blending_fraction=(
            args.internalSmoothingBlendingFraction),
        write_interval=args.writeInterval,
        ray_miss_fatal=not args.allowRayMiss,
    )

    mesh = case.read_mesh(t0)

    from smoothmesh_torch.driver import Smoother

    dtype = DTYPES[args.dtype] if args.dtype else None
    try:
        if n_shards is None:
            smoother = Smoother(mesh, params, dtype=dtype, device=device)
            to_ext = smoother.to_external_point_field
        else:
            from smoothmesh_torch.parallel.sharded import ShardedSmoother

            if distributed:
                how = ("torch.distributed ranks, "
                       f"{torch.distributed.get_backend()}")
                where = dict(n_shards=n_shards, device=device,
                             distributed=True)
            elif device.type == "cuda":
                how = f"{n_shards} cards in this process"
                where = dict(devices=[torch.device("cuda", i)
                                      for i in range(n_shards)])
            else:
                how = f"one process on {device}"
                where = dict(n_shards=n_shards, device=device)
            print(f"Running sharded over {n_shards} shards ({how})")
            smoother = ShardedSmoother(mesh, params, dtype=dtype, **where)
            # its boundary classification is in the mesh's point order
            to_ext = np.asarray
    except TypeError as e:      # a dtype the device does not run
        print(f"FATAL: {e}", file=sys.stderr)
        return 1
    writes = not distributed or torch.distributed.get_rank() == 0
    p = smoother.params

    layer_ids = smoother.topo.patch_ids_matching(p.layer_patches)
    if len(layer_ids):
        print(f"Patches for boundary layer treatment: {args.layerPatches}")
    else:
        print("Patches for boundary layer treatment: none")
    if args.smoothingPatches:
        print("Patches for boundary point smoothing: "
              f"{args.smoothingPatches}")
    else:
        print('Patches for boundary point smoothing: (".*")')
    print()
    print("Applying following parameter values in smoothing:")
    print(f"    centroidalIters        {p.centroidal_iters}")
    print(f"    relTol                 {p.rel_tol}")
    print(f"    minEdgeLength          {p.min_edge_length:.6g}")
    print(f"    maxStepLength          {p.max_step_length:.6g}")
    print(f"    relStepFrac            {p.rel_step_frac}")
    print(f"    totalMinFreeze         {int(p.total_min_freeze)}")
    if p.edge_angle_constraint:
        print("    edgeAngleConstraint    true")
        print(f"    minAngle               {p.min_angle}")
    else:
        print("    edgeAngleConstraint    false (edge min angle quality "
              "constraint is NOT applied)")
    if p.face_angle_constraint:
        print("    faceAngleConstraint    true")
        print(f"    minAngle               {p.min_angle}")
        print(f"    maxAngle               {p.max_angle}")
    else:
        print("    faceAngleConstraint    false (face angle quality "
              "constraints are NOT applied)")
    if p.layer_max_blending_fraction > 1e-15 and len(layer_ids):
        print(f"    layerMaxBlendingFraction {p.layer_max_blending_fraction}")
        print(f"    layerEdgeLength          {p.layer_edge_length:.6g}")
        print(f"    layerExpansionRatio      {p.layer_expansion_ratio}")
        print(f"    minLayers                {p.min_layers}")
        print(f"    maxLayers                {p.max_layers}")
    else:
        print("    layerMaxBlendingFraction 0 (boundary layer treatment "
              "is NOT applied)")
    warn = p.warn_step_length()
    if warn:
        print(warn)

    # Boundary point smoothing prerequisites (reference
    # src/smoothMesh.C:2079-2098): targetSurfaces.obj plus either
    # initEdges.obj or checkpointed classification, and smoothing patches
    from smoothmesh_torch.io.obj import read_obj_edges, read_obj_surface

    surf_file = case.geometry_file("targetSurfaces.obj")
    init_file = case.geometry_file("initEdges.obj")
    target_file = case.geometry_file("targetEdges.obj")
    n_pts = mesh.n_points
    ck_c = case.read_label_io_list("isCornerPoint", t0, n_pts)
    ck_f = case.read_label_io_list("isFeatureEdgePoint", t0, n_pts)
    have_ckpt = (
        (ck_c is not None and (ck_c == 1).any())
        or (ck_f is not None and (ck_f == 1).any())
    )
    smoothing_ids = smoother.topo.patch_ids_matching(
        smoother.params.smoothing_patches)
    boundary_setup = None
    if surf_file and (init_file or have_ckpt) and len(smoothing_ids):
        sv, st = read_obj_surface(surf_file)
        iv, ie = read_obj_edges(init_file or target_file)
        if target_file:
            tv, te = read_obj_edges(target_file)
        else:
            tv, te = iv, ie
            print("WARNING: Initial feature edges will be used also as "
                  "target edges")
        boundary_setup = smoother.enable_boundary_smoothing(
            sv, st, iv, ie, tv, te,
            checkpoint_corner=ck_c if have_ckpt else None,
            checkpoint_feature=ck_f if have_ckpt else None)
        print("Enabled boundary point smoothing")
        print("Boundary point classification summary:")
        print(f"- Detected number of corner points: "
              f"{int(boundary_setup.is_corner.sum())}")
        print(f"- Detected number of feature edge points: "
              f"{int(boundary_setup.is_feature_edge.sum())}")
        print(f"- Detected number of smoothing surface points: "
              f"{int(boundary_setup.is_smoothing_surface.sum())}")
        print(f"- Detected number of frozen surface points: "
              f"{int(boundary_setup.is_frozen_surface.sum())}")
    else:
        print("Boundary point smoothing is disabled. Missing "
              "smoothingPatches, or one or both of files:")
        print("constant/geometry/targetSurfaces.obj")
        print("constant/geometry/initEdges.obj")
    print()

    n_total = mesh.n_points
    n_internal = n_total - int(boundary_point_mask(mesh).sum())
    print(f"Mesh includes a total of {n_total} points:")
    print(f"  - {n_internal} internal (non-boundary) points")
    print(f"  - {n_total - n_internal} boundary points")
    print(f"Mesh minimum edge length = {smoother.stats.min_edge_length:.6g}")
    print(f"Mesh maximum edge length = {smoother.stats.max_edge_length:.6g}")
    print(f"Distance tolerance = {p.distance_tolerance:.6g}")
    print()

    def on_write(iteration: int, pts: np.ndarray) -> None:
        if not writes:
            return
        t = t0 + iteration * delta_t
        out = case.write_mesh(mesh, pts, t, overwrite=args.overwrite,
                              binary=args.writeFormat == "binary")
        if boundary_setup is not None:
            # AUTO_WRITE of classification checkpoints (reference
            # src/smoothMesh.C:2039-2077)
            case.write_label_io_list(
                "isCornerPoint", t,
                to_ext(boundary_setup.is_corner).astype(np.int64))
            case.write_label_io_list(
                "isFeatureEdgePoint", t,
                to_ext(boundary_setup.is_feature_edge).astype(np.int64))
        print(f"Writing new mesh to time {t:g} ({out})")
        print()

    smoother.run(on_write=on_write, profile_dir=args.profileDir)

    if args.checkMesh:
        rep = smoother.quality()
        ok = (rep["n_negative_volumes"] == 0
              and rep["max_non_ortho_deg"] < 70.0
              and rep["max_skewness"] < 4.0)
        print()
        print("Mesh quality report (checkMesh equivalent):")
        for k, v in rep.items():
            print(f"    {k:22s} {v:.6g}" if isinstance(v, float)
                  else f"    {k:22s} {v}")
        print("    Mesh OK." if ok else "    *** Mesh quality check FAILED")
    print()
    print("End")
    return 0


if __name__ == "__main__":
    sys.exit(main())
