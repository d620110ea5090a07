"""Time the default cell of a checkout of the port, so that two
checkouts can be compared in alternation on one card (H100).

The default cell is chip_smoke.py's main path: the 128^3 graded,
perturbed bench mesh (its "top"/"rest" patches), spatially reordered,
the default parameters (face angle on, boundary points fixed),
``Smoother.steps``.  After 4 warm-up iterations (in a checkout with the
batched ``steps``, they also capture its CUDA graph) it runs ``--reps``
times ``steps(--iters)`` and prints, for each, the median and mean of
the iterations' wall times (as ``StepResult`` records them: one host
read each, or a batch's wall time over its iterations) and the peak
device memory, with the device topology's size and the checkout's
``iter_batch`` (``SMOOTHMESH_ITER_BATCH``; 1 where the checkout has no
batched ``steps``), then one JSON line with the card's name and power
limit.

With ``--boundary`` it times the boundary cell instead: the same mesh
in bench.py's boundary configuration (layers and boundary smoothing on
the top patch, min angle 15, ray misses frozen, the k = 64 dome as
target surface; chip_smoke.boundary_params).

``--root`` is the checkout whose ``smoothmesh_torch`` is timed (default:
this repository).  ``--topo`` names a pickle of the compiled topology:
written when missing, read otherwise, so every checkout runs on one
identical topology and the compile is paid once.

Run from the repository root on a machine with a CUDA card, for example
parent (P) and change (C) in the order P C C P:
    python experiments/torch_default_cell.py --root PARENT --topo T.pkl
    python experiments/torch_default_cell.py --topo T.pkl
and the change one iteration a dispatch:
    SMOOTHMESH_ITER_BATCH=1 python experiments/torch_default_cell.py ...
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_PATCHES = {"top": ["zmax"],
               "rest": ["xmin", "xmax", "ymin", "ymax", "zmin"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--topo", required=True)
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--boundary", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from smoothmesh_torch import kernels
    from smoothmesh_torch.driver import Smoother
    from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
    from smoothmesh_torch.mesh.tiling import permute_mesh
    from smoothmesh_torch.mesh.topology import compile_topology
    from smoothmesh_torch.params import SmoothingParams

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kernels.build_all()
    base = hex_block(n=(args.side,) * 3, grading=(2.0, 1.0, 0.5),
                     patches=TOP_PATCHES)
    min_spacing = min(np.diff(np.unique(base.points[:, a])).min()
                      for a in range(3))
    mesh, _ = permute_mesh(perturb(base, amplitude=0.25 * min_spacing,
                                   seed=3))
    if os.path.exists(args.topo):
        with open(args.topo, "rb") as f:
            topo = pickle.load(f)
    else:
        topo = compile_topology(mesh)
        with open(args.topo, "wb") as f:
            pickle.dump(topo, f, protocol=pickle.HIGHEST_PROTOCOL)
    if args.boundary:
        from smoothmesh_torch.testcases import bench_dome_geometry

        params = SmoothingParams(rel_tol=0.0, smoothing_patches=("top",),
                                 layer_patches=("top",), min_angle=15.0,
                                 ray_miss_fatal=False)
    else:
        params = SmoothingParams(rel_tol=0.0)
    sm = Smoother(mesh, params, topo=topo, device="cuda")
    if args.boundary:
        sm.enable_boundary_smoothing(*bench_dome_geometry()[1:])
    cell = "boundary" if args.boundary else "default"
    batch = getattr(sm, "iter_batch", 1)
    topo_gb = sum(t.numel() * t.element_size() for t in sm.td.values()) / 1e9
    sm.steps(4)
    torch.cuda.synchronize()
    reps = []
    for _ in range(args.reps):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        walls = [r.wall_ms for r in sm.steps(args.iters)]
        reps.append({"median_ms": float(np.median(walls)),
                     "mean_ms": float(np.mean(walls)),
                     "seconds": time.perf_counter() - t0,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        print(f"{root}, {cell} cell, iter_batch {batch}: {args.iters} "
              f"iterations, median "
              f"{reps[-1]['median_ms']:.4f} ms, mean "
              f"{reps[-1]['mean_ms']:.4f} ms, peak device memory "
              f"{reps[-1]['peak_gb']:.3f} GB, device topology "
              f"{topo_gb:.3f} GB on {smi}", flush=True)
    print(json.dumps({"root": root, "cell": cell, "card": smi,
                      "iter_batch": batch,
                      "iters": args.iters, "topology_gb": topo_gb,
                      "reps": reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
