"""tc1 on the disjoint decomposition in 3 shards (CPU, float64).

tests/test_testcases.py's test_case_sharded_runs_and_mesh_valid[tc1-3]
runs the JAX package's ShardedSmoother on tc1 in 3 shards and checks
the quality report: no negative volume, max non-orthogonality below
tc1's 85 degrees, max skewness below 4.  It is red in the JAX package.
This script prints tc1's points that no face references, then runs the
same configuration through the port's ShardedSmoother and its
single-device Smoother and prints the report's checked keys and which
fail, or the error a run raises; with --jax also through the JAX
ShardedSmoother.

Run from the repository root:  python experiments/torch_sharded_tc1.py [--jax]
"""

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from smoothmesh_torch import testcases as ttc  # noqa: E402
from smoothmesh_torch.driver import Smoother  # noqa: E402
from smoothmesh_torch.parallel.sharded import ShardedSmoother  # noqa: E402

KEYS = ("n_negative_volumes", "max_non_ortho_deg", "max_skewness",
        "avg_non_ortho_deg")


def verdict(name, rep, limit_non_ortho, seconds, res):
    fails = [k for k, bad in (
        ("n_negative_volumes", rep["n_negative_volumes"] != 0),
        ("max_non_ortho_deg", rep["max_non_ortho_deg"] >= limit_non_ortho),
        ("max_skewness", rep["max_skewness"] >= 4.0)) if bad]
    print(f"{name}: " + ", ".join(f"{k} {rep[k]:.6g}" for k in KEYS)
          + f"; final residual {res:.6g}; {seconds:.1f} s; "
          + (f"FAILS {fails}" if fails else "passes the three checks"),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", action="store_true",
                    help="also run the JAX ShardedSmoother")
    args = ap.parse_args()
    torch.set_num_threads(4)
    tc = ttc.ALL["tc1"]()
    used = np.zeros(tc.mesh.n_points, dtype=bool)
    used[tc.mesh.face_flat] = True
    print(f"tc1: {tc.mesh.n_points} points, {tc.mesh.n_cells} cells, "
          f"{int((~used).sum())} points in no face "
          f"({np.where(~used)[0].tolist()}); limit on max "
          f"non-orthogonality {tc.max_non_ortho}", flush=True)
    runs = [("port ShardedSmoother, 3 shards", lambda: ShardedSmoother(
                tc.mesh, tc.params, n_shards=3, device="cpu",
                dtype=torch.float64)),
            ("port Smoother, one device", lambda: Smoother(
                tc.mesh, tc.params, device="cpu", dtype=torch.float64))]
    if args.jax:
        import jax

        jax.config.update("jax_enable_x64", True)
        from smoothmesh_tpu import testcases as jtc
        from smoothmesh_tpu.parallel.sharded import (ShardedSmoother as
                                                     JaxSharded)

        jt = jtc.ALL["tc1"]()
        runs.append(("JAX ShardedSmoother, 3 devices", lambda: JaxSharded(
            jt.mesh, jt.params, devices=jax.devices()[:3],
            dtype=np.float64)))
    for name, make in runs:
        t0 = time.perf_counter()
        try:
            sm = make()
        except ValueError as e:
            print(f"{name}: raises ValueError: {e}", flush=True)
            continue
        res = sm.run(log=None)
        verdict(name, sm.quality(), tc.max_non_ortho,
                time.perf_counter() - t0, res.residual)


if __name__ == "__main__":
    main()
