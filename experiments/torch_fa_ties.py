"""Exact ties in the face-angle fixed point (CPU, float64).

On the first iteration of the mesh of tests/test_torch_driver.py
(hex 10x8x8, perturbed 0.06, seed 7, reordered by the port's Smoother),
at the default 35/160 band and at 60/120, prints the number of points
frozen by:

  - the stack oracle (tests/oracle.face_angle_freeze);
  - the port's fixed point in angle space (one arithmetic path for the
    current and the substituted angles, no guard);
  - the same with the current angles moved inward by 1e-13 rad;
  - the port's fixed point as the driver runs it (u space, current
    angles from the plain K5/K6, 1e-5 u guard);
  - the JAX XLA function as the JAX XLA driver calls it (angle space,
    its own current angles, no guard).

Run from the repository root:  python experiments/torch_fa_ties.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import oracle  # noqa: E402
from smoothmesh_tpu.device import to_device as jax_to_device  # noqa: E402
from smoothmesh_tpu.ops import constraints as jcon  # noqa: E402
from smoothmesh_torch import geometry as geo  # noqa: E402
from smoothmesh_torch.device import to_device  # noqa: E402
from smoothmesh_torch.driver import Smoother  # noqa: E402
from smoothmesh_torch.mesh import blockmesh  # noqa: E402
from smoothmesh_torch.ops import constraints as con  # noqa: E402
from smoothmesh_torch.ops import smoothing as smo  # noqa: E402
from smoothmesh_torch.params import SmoothingParams  # noqa: E402


def main():
    for band in ((35.0, 160.0), (60.0, 120.0)):
        mesh = blockmesh.perturb(blockmesh.hex_block(n=(10, 8, 8)),
                                 amplitude=0.06, seed=7)
        sm = Smoother(mesh, SmoothingParams(min_angle=band[0],
                                            max_angle=band[1]),
                      device="cpu", dtype=torch.float64)
        p, pts = sm.params, sm.points
        td = to_device(sm.topo, "cpu")
        lo, hi = p.min_angle_rad, p.max_angle_rad
        cc = geo.cell_centres(pts, td)
        prop, _ = smo.predictor(pts, cc, td, p.max_step_length * sm._scale,
                                p.rel_step_frac, False)
        frozen = con.freeze_constraints(
            pts, prop, td, p.min_edge_length * sm._scale,
            p.total_min_freeze, lo, True,
            torch.zeros(len(pts), dtype=torch.bool))

        ref = oracle.face_angle_freeze(sm.topo, pts.numpy(), cc.numpy(),
                                       prop.numpy(), *band, frozen.numpy())
        angle = con.restrict_face_angle_deterioration(
            pts, cc, prop, td, lo, hi, frozen)
        cur_min, cur_max = con.current_face_angles_per_point(pts, cc, td)
        nudged = con.restrict_face_angle_deterioration(
            pts, cc, prop, td, lo, hi, frozen,
            cur_minmax=(cur_min + 1e-13, cur_max - 1e-13))
        fg = geo.face_centres_areas(pts, td["face_points"], td["face_mask"],
                                    td["face_npoints"])
        guarded = con.restrict_face_angle_deterioration(
            pts, cc, prop, td, lo, hi, frozen, fc_base=fg.means,
            cur_minmax=con.face_angles_per_point(pts, fg.means, cc, td),
            u_space=True)

        def j(t):
            return jnp.asarray(t.numpy())

        xla = jcon.restrict_face_angle_deterioration(
            j(pts), j(cc), j(prop), jax_to_device(sm.topo), lo, hi,
            j(frozen))
        print(f"band {band}: {int(frozen.sum())} frozen by K4; frozen "
              f"after the fixed point: oracle {int(ref.sum())}, port "
              f"angle space {int(angle.sum())}, with the current angles "
              f"moved 1e-13 rad inward {int(nudged.sum())}, port as the "
              f"driver runs it {int(guarded.sum())} "
              f"({int((guarded.numpy() != ref).sum())} differ from the "
              f"oracle), JAX XLA {int(jnp.sum(xla))}", flush=True)


if __name__ == "__main__":
    main()
