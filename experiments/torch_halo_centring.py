"""Where the port's halo smoother parts from its single-device smoother.

On bench.py's mesh (graded hex, perturbed by 0.25 x the minimum
spacing, seed 3) at ``--side``, with the default parameters, runs
``--iters`` iterations of the single-device ``Smoother`` and of the
``HaloSmoother`` in ``--shards`` shards, three ways:

- the halo from its own centring (the mean of the mesh's points in the
  mesh's order; the single device takes the mean in its reordered
  points' order, which rounds otherwise);
- the halo from the single device's centring;
- one shard from the single device's centring.

For each it prints the points beyond 1e-5 x the coordinate scale, the
largest point difference over that scale, the points bit-equal, the
largest relative residual difference and the largest frozen-count
difference.

    python experiments/torch_halo_centring.py --device cpu --side 24
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from smoothmesh_torch.driver import Smoother  # noqa: E402
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb  # noqa: E402
from smoothmesh_torch.parallel.halo import HaloSmoother  # noqa: E402
from smoothmesh_torch.params import SmoothingParams  # noqa: E402


def bench_mesh(side: int):
    base = hex_block(n=(side, side, side), grading=(2.0, 1.0, 0.5))
    min_spacing = min(np.diff(np.unique(base.points[:, a])).min()
                      for a in range(3))
    return perturb(base, amplitude=0.25 * min_spacing, seed=3)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--side", type=int, default=24)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--iters", type=int, default=8)
    a = ap.parse_args()
    torch.set_num_threads(2)
    mesh = bench_mesh(a.side)
    params = SmoothingParams(centroidal_iters=a.iters, rel_tol=0.0)
    single = Smoother(mesh, params, device=a.device)
    want = single.steps(a.iters)
    want_pts = single.denormalize()
    scale = float(np.abs(want_pts).max())

    def report(label, hs, centre):
        if centre is not None:
            hs.points = hs._tensor((hs.union.points - centre) * hs._scale,
                                   hs.dtype)
            hs._center = centre
        got = hs.steps(a.iters)
        pts = hs.denormalize()
        dist = np.linalg.norm(pts - want_pts, axis=1)
        d_res = max(abs(g.residual - w.residual) / abs(w.residual)
                    for g, w in zip(got, want))
        d_frozen = max(abs(g.n_frozen - w.n_frozen)
                       for g, w in zip(got, want))
        print(f"{label}: {int((dist > 1e-5 * scale).sum())} points beyond "
              f"1e-5 of the scale, the farthest {dist.max() / scale:.4g}; "
              f"{int((pts == want_pts).all(1).sum())} of {len(pts)} points "
              f"bit-equal; residuals {d_res:.4g} relative; frozen counts "
              f"{d_frozen} apart", flush=True)

    halo = HaloSmoother(mesh, params, n_shards=a.shards, device=a.device)
    print(f"{a.side}^3, {a.shards} shards, {a.iters} iterations on "
          f"{single.device}: centrings differ by "
          f"{np.abs(halo._center - single._center).max():.3g}, scales "
          f"{'equal' if halo._scale == single._scale else 'differ'}")
    report("halo, its own centring", halo, None)
    halo._iteration = 0
    report("halo, the single device's centring", halo, single._center)
    one = HaloSmoother(mesh, params, n_shards=1, device=a.device)
    report("one shard, the single device's centring", one, single._center)


if __name__ == "__main__":
    main()
