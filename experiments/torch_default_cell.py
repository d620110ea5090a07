"""Time the default cell of a checkout of the port, so that two
checkouts can be compared in alternation on one card (H100).

The default cell is chip_smoke.py's main path: the 128^3 graded,
perturbed bench mesh (its "top"/"rest" patches), spatially reordered,
the default parameters (face angle on, boundary points fixed),
``Smoother.steps``.  After 4 warm-up iterations it runs ``--reps``
times ``steps(--iters)`` and prints, for each, the median and mean of
the iterations' wall times (one host read each, as ``StepResult``
records them), then one JSON line with the card's name and power limit.

``--root`` is the checkout whose ``smoothmesh_torch`` is timed (default:
this repository).  ``--topo`` names a pickle of the compiled topology:
written when missing, read otherwise, so every checkout runs on one
identical topology and the compile is paid once.

Run from the repository root on a machine with a CUDA card, for example
parent (P) and change (C) in the order P C C P:
    python experiments/torch_default_cell.py --root PARENT --topo T.pkl
    python experiments/torch_default_cell.py --topo T.pkl
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
    sm = Smoother(mesh, SmoothingParams(rel_tol=0.0), topo=topo,
                  device="cuda")
    sm.steps(4)
    torch.cuda.synchronize()
    reps = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        walls = [r.wall_ms for r in sm.steps(args.iters)]
        reps.append({"median_ms": float(np.median(walls)),
                     "mean_ms": float(np.mean(walls)),
                     "seconds": time.perf_counter() - t0})
        print(f"{root}: {args.iters} iterations, median "
              f"{reps[-1]['median_ms']:.4f} ms, mean "
              f"{reps[-1]['mean_ms']:.4f} ms on {smi}", flush=True)
    print(json.dumps({"root": root, "card": smi, "iters": args.iters,
                      "reps": reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
