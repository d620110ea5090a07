"""The smoothing driver: one iteration + the convergence loop.

Reimplements the reference's main iteration (src/smoothMesh.C:2257-2437)
for one device, internal points, no boundary-layer treatment and no
boundary smoothing:

  face geometry (K1) -> cell centres (K2) -> predictor (K3: centroidal,
  aspect-ratio blend, step limiter) -> edge-shortening / edge-angle
  freezes (K4) -> current face angles per point (K5, K6) -> the
  face-angle fixed point -> revert frozen and boundary points -> residual

Coordinates are internally normalized (centred, scaled so the minimum
edge length is 1) so float32 stays accurate at any absolute mesh scale;
length-valued parameters are scaled along.  Each iteration reads back
two scalars (the residual and the frozen count), exactly the
information the reference prints.

The face-angle step is the JAX driver's tile-engine branch
(``smoothmesh_tpu/driver.py:321-327``) on every device: the fixed point
in u space, with the current angles from K5/K6 (their plain versions on
the CPU) and its 1e-5 u guard against last-bit noise.  Not its XLA
branch (``:246-249``, angle space, no guard): that one compares the
current and the substituted angles from two arithmetic paths, so where
a substitution leaves an edge unchanged its decision follows last-bit
noise (see tests/test_torch_driver.py).  Boundary-layer blending and
boundary smoothing raise ``NotImplementedError`` naming the slice of
the port that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from smoothmesh_torch import geometry as geo
from smoothmesh_torch.device import resolve_device, to_device
from smoothmesh_torch.io.polymesh import PolyMesh
from smoothmesh_torch.mesh.tiling import MeshOrders, permute_mesh
from smoothmesh_torch.mesh.topology import MeshTopology, compile_topology
from smoothmesh_torch.ops import constraints, smoothing
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.quality import mesh_stats


@dataclasses.dataclass
class StepResult:
    iteration: int
    residual: float
    n_frozen: int
    wall_ms: float = 0.0


class Stages(NamedTuple):
    """The per-iteration stages that hold a kernel."""

    face_geometry: Callable
    cell_centres_vols: Callable
    predictor: Callable
    freeze_constraints: Callable
    face_angles_per_point: Callable


#: The wrappers: plain versions on CPU tensors, kernels on CUDA tensors.
KERNEL_STAGES = Stages(geo.face_centres_areas, geo.cell_centres_vols,
                       smoothing.predictor, constraints.freeze_constraints,
                       constraints.face_angles_per_point)
#: The plain PyTorch versions on any device (the card's reference run).
PLAIN_STAGES = Stages(geo.face_centres_areas_plain,
                      geo.cell_centres_vols_plain,
                      smoothing.predictor_plain,
                      constraints.freeze_constraints_plain,
                      constraints.face_angles_per_point_plain)

#: The device-topology tables one iteration reads (the face-angle
#: fixed point reads point_edges_side folded into pe_flat).
TD_KEYS = frozenset({
    "face_points", "face_mask", "face_npoints", "owner", "cell_faces",
    "cell_faces_mask", "point_cells", "point_cells_mask", "point_points",
    "point_points_mask", "point_faces_mask", "wedge_prev", "wedge_next",
    "is_internal_point", "point_valid",
    # the face angle
    "edges", "edge_faces", "edge_cells", "edge_cells_mask", "edge_cell_f0",
    "edge_cell_f1", "point_edges", "point_edges_mask", "pps_signed",
    "pe_flat",
})


def iteration_body(points, td, params: SmoothingParams, scale: float,
                   stages: Stages = KERNEL_STAGES):
    """One smoothing iteration (reference src/smoothMesh.C:2257-2437)
    -> (new points, residual, frozen count), both scalars as tensors.

    Length-valued parameters are pre-scaled by the driver's coordinate
    normalization factor ``scale``.
    """
    p = params
    min_edge = p.min_edge_length * scale
    max_step = p.max_step_length * scale

    fg = stages.face_geometry(points, td["face_points"], td["face_mask"],
                              td["face_npoints"])
    cell_ctrs, _ = stages.cell_centres_vols(
        fg, td["owner"], td["cell_faces"], td["cell_faces_mask"])
    prop, _ = stages.predictor(points, cell_ctrs, td, max_step,
                               p.rel_step_frac, False)
    frozen = stages.freeze_constraints(
        points, prop, td, min_edge, p.total_min_freeze, p.min_angle_rad,
        p.edge_angle_constraint,
        torch.zeros(points.shape[0], dtype=torch.bool, device=points.device))
    if p.face_angle_constraint:
        # as the JAX driver's tile branch (smoothmesh_tpu/driver.py:321-327)
        cur = stages.face_angles_per_point(points, fg.means, cell_ctrs, td)
        frozen = constraints.restrict_face_angle_deterioration(
            points, cell_ctrs, prop, td, p.min_angle_rad, p.max_angle_rad,
            frozen, fc_base=fg.means, cur_minmax=cur, u_space=True)

    # boundary points stay put: no boundary smoothing in this slice
    revert = frozen | ~td["is_internal_point"]
    new_points = torch.where(revert[:, None], points, prop)
    n_frozen = (revert & td["point_valid"]).sum()
    res = smoothing.calculate_residual(points, new_points, max_step)
    return new_points, res, n_frozen


def check_supported(params: SmoothingParams, topo: MeshTopology) -> None:
    """Raise NotImplementedError for what the port cannot run yet."""
    if (len(topo.patch_ids_matching(params.layer_patches))
            and params.layer_max_blending_fraction > 1e-15):
        raise NotImplementedError(
            "boundary-layer blending (layer_patches) arrives with slice 4 "
            "of the PyTorch port")


class Smoother:
    """Single-device smoothing engine for one mesh.

    Parameters
    ----------
    mesh: the polyMesh to smooth (topology fixed, points move).
    params: smoothing options; derived defaults are resolved here from
        the initial mesh stats (reference src/smoothMesh.C:1854-1921).
    dtype: coordinate dtype (default float32; the kernels take
        float32, the plain CPU versions any float dtype).
    topo: a precompiled topology of ``mesh``; without one the mesh is
        spatially reordered (``permute_mesh``) and compiled here.
    device: ``"cuda"`` by default; ``"cpu"`` runs the plain versions.
    """

    def __init__(self, mesh: PolyMesh, params: SmoothingParams,
                 dtype=None, topo: Optional[MeshTopology] = None,
                 device=None):
        device = resolve_device(device)
        orders = None
        mesh_int = mesh
        if topo is None:
            mesh_int, orders = permute_mesh(mesh)
            topo = compile_topology(mesh_int)
        stats = mesh_stats(mesh_int.points, topo.edges)
        center = mesh_int.points.mean(axis=0)
        scale = 1.0 / max(stats.min_edge_length, 1e-300)
        self.mesh = mesh
        self._setup(topo, (mesh_int.points - center) * scale,
                    params.resolve(stats.min_edge_length), center, scale,
                    device, dtype, orders)

    def _setup(self, topo: MeshTopology, points: np.ndarray,
               params: SmoothingParams, center, scale: float, device,
               dtype, orders: Optional[MeshOrders]) -> None:
        """Device state from host state; ``points`` are internal
        (normalized) coordinates and ``params`` are resolved."""
        check_supported(params, topo)
        device = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        if device.type == "cuda" and dtype != torch.float32:
            raise TypeError("the CUDA kernels take float32 coordinates")
        self.device = device
        self.dtype = dtype
        self.topo = topo
        self.params = params
        self._orders = orders
        self._center = np.asarray(center, dtype=np.float64)
        self._scale = float(scale)
        self.td = to_device(topo, device, TD_KEYS)
        self.points = torch.tensor(np.asarray(points), dtype=dtype,
                                   device=device)
        self._iteration = 0

    def enable_boundary_smoothing(self, *args, **kwargs):
        raise NotImplementedError(
            "boundary point smoothing (target surfaces) arrives with "
            "slice 5 of the PyTorch port")

    # -- coordinate transforms ---------------------------------------------
    def denormalize(self, pts=None) -> np.ndarray:
        """Internal points -> external coordinates, original point order."""
        q = (self.points if pts is None else torch.as_tensor(pts))
        q = q.detach().to("cpu", torch.float64).numpy()
        q = q / self._scale + self._center
        if self._orders is not None:
            q = q[self._orders.point_new]          # back to original order
        return q

    # -- the iteration loop ------------------------------------------------
    def step(self) -> StepResult:
        t0 = time.perf_counter()
        new_points, res, n_frozen = iteration_body(
            self.points, self.td, self.params, self._scale)
        res, n_frozen = torch.stack(
            [res.double(), n_frozen.double()]).tolist()   # host sync
        wall = (time.perf_counter() - t0) * 1e3
        self.points = new_points
        self._iteration += 1
        return StepResult(self._iteration, res, int(n_frozen), wall)

    def steps(self, n: int) -> "list[StepResult]":
        """Run up to ``n`` iterations, stopping after the first one whose
        residual is below ``rel_tol``."""
        out = []
        for _ in range(n):
            r = self.step()
            out.append(r)
            if r.residual < self.params.rel_tol:
                break
        return out

    def run(self, log: Optional[Callable[[str], None]] = print,
            on_write: Optional[Callable[[int, np.ndarray], None]] = None
            ) -> StepResult:
        """The full iteration loop with convergence + periodic writes
        (reference src/smoothMesh.C:2257-2437)."""
        p = self.params
        t0 = time.time()
        result = StepResult(0, float("inf"), 0)
        iter_ms = []
        total = p.centroidal_iters
        done = 0
        while done < total:
            # stop each window at the next write boundary so on_write
            # observes the exact intermediate state
            n = total - done
            if on_write and p.write_interval > 0:
                boundary = ((done // p.write_interval) + 1) \
                    * p.write_interval
                n = min(n, boundary - done)
            rs = self.steps(n)
            for r in rs:
                iter_ms.append(r.wall_ms)
                if log:
                    log(f"Smoothing iteration={r.iteration} "
                        f"nFrozenPoints={r.n_frozen} "
                        f"residual={r.residual:.6g}")
            if rs:
                result = rs[-1]
            done += len(rs)
            stop = result.residual < p.rel_tol
            if stop and log:
                log("Residual reached relTol, stopping.")
            if done >= total and not stop and log:
                log("Maximum centroidalIters reached, stopping.")
            if on_write and (stop or done >= total
                             or (p.write_interval > 0
                                 and done % p.write_interval == 0
                                 and done > 1)):
                on_write(result.iteration, self.denormalize())
            if stop or not rs:
                break
        if log:
            # the first iteration carries the kernels' first-use build
            steady = iter_ms[1:] or iter_ms
            if steady:
                mean_ms = sum(steady) / len(steady)
                rate = self.topo.n_points / (mean_ms / 1e3)
                log(f"Performance: {mean_ms:.3f} ms/iteration, "
                    f"{rate:,.0f} point-updates/s on {self.device}")
            log(f"ClockTime = {time.time() - t0:.1f} s.")
        return result
