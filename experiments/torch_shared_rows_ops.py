"""The PyTorch operations of the disjoint decomposition's shared rows.

Counts the ATen operations one call of
``ops.smoothing.predict_shared_rows`` dispatches (the plain chain that
recomputes the rows of the points on the cuts after K3), by name, and
those of each exchange it makes, on a perturbed hex block in 4 shards
(CPU, float32).  On the card each operation that is not a view is one
kernel launch, so these counts are the chain's launches an iteration
(the views, ``select`` and ``unsqueeze``, launch nothing).

Run from the repository root:
    python experiments/torch_shared_rows_ops.py [--side 12] [--shards 4]
"""

import argparse
import os
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from smoothmesh_torch import geometry as geo  # noqa: E402
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb  # noqa: E402
from smoothmesh_torch.ops import smoothing as smo  # noqa: E402
from smoothmesh_torch.parallel.sharded import ShardedSmoother  # noqa: E402
from smoothmesh_torch.params import SmoothingParams  # noqa: E402

VIEWS = {"aten::select", "aten::unsqueeze", "aten::unbind", "aten::view",
         "aten::reshape", "aten::expand", "aten::slice", "aten::as_strided",
         "aten::alias", "aten::squeeze", "aten::flatten"}


def top_level_ops(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return Counter(e.name for e in prof.events()
                   if e.name.startswith("aten::") and e.cpu_parent is None)


def report(name, ops):
    launches = sum(n for k, n in ops.items() if k not in VIEWS)
    print(f"{name}: {sum(ops.values())} operations, {launches} not views; "
          + ", ".join(f"{k[6:]} {n}" for k, n in ops.most_common(12)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=12)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(1)
    mesh = perturb(hex_block(n=(args.side,) * 3), 0.02, seed=1)
    ss = ShardedSmoother(mesh, SmoothingParams(), n_shards=args.shards,
                         device="cpu")
    pts, td, sync = ss.points, ss.td, ss.sync
    fg = geo.face_centres_areas(pts, td["face_points"], td["face_mask"],
                                td["face_npoints"])
    cc, _ = geo.cell_centres_vols(fg, td)
    pargs = (pts, cc, td, 0.3, 0.5, False)
    prop, _ = smo.predictor(*pargs)
    print(f"{args.side}^3 hex in {args.shards} shards: {sync.rows.numel()} "
          f"shared rows of {pts.shape[0]}")
    report("predict_shared_rows",
           top_level_ops(lambda: smo.predict_shared_rows(prop, *pargs, sync)))
    v = pts[sync.rows]
    for name, fn in (
            ("pair_sum (3-vectors)", lambda: sync.pair_sum(v)),
            ("pair_min_mag_sqr", lambda: sync.pair_min_mag_sqr(v)),
            ("pair_closest_points", lambda: sync.pair_closest_points(
                v, v + 1, v + 2, torch.zeros(len(v), dtype=torch.bool))),
            ("pair_consensus", lambda: sync.pair_consensus(v)),
            ("or_ (the freezes)", lambda: sync.or_(pts[:, 0] > 0))):
        report(name, top_level_ops(fn))


if __name__ == "__main__":
    main()
