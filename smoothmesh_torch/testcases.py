"""Boundary-smoothing testcases: meshes, parameters and target geometry.

Copies of the JAX package's boundary testcases (the reference's
testcase4, testcase5 and testcase7 patterns: a block whose top patch
morphs onto a dome-shaped target surface, with its border ring as the
edge mesh) and of the boundary-mode target of its benchmark:

  tc4   boundary smoothing (full OBJ trio) + layers
  tc5   boundary smoothing + layers on ("top"), small target surface
  tc7   targetEdges morphing: feature edges move to a shrunk ring
  bench_dome_geometry   the k = 64 dome (7,938 triangles) and its
        128-edge border ring over the unit top face

A geometry tuple is ``(surf_vertices, surf_tris, init_edge_points,
init_edges, target_edge_points, target_edges)``, the arguments of
:meth:`smoothmesh_torch.driver.Smoother.enable_boundary_smoothing`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from smoothmesh_torch.io.polymesh import PolyMesh
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.params import SmoothingParams

#: the patches of the boundary testcases: the top face and the rest
TOP_PATCHES = {"top": ["zmax"],
               "rest": ["xmin", "xmax", "ymin", "ymax", "zmin"]}


@dataclasses.dataclass
class TestCase:
    name: str
    mesh: PolyMesh
    params: SmoothingParams
    geometry: Optional[Tuple] = None


def _dome(amp: float, k: int, kb: int):
    """A dome z = 1 + amp sin(pi x) sin(pi y) over [0, 1]^2, flat out to
    [-0.2, 1.2]^2, as k x k vertices in 2 (k-1)^2 triangles, and the
    unit square's border at z = 1 as 4 (kb - 1) edges (each side's
    kb points separate, so the four corner vertices have valence 1)."""
    def dome_z(x, y):
        return 1.0 + amp * np.sin(np.pi * x) * np.sin(np.pi * y)

    xs = np.linspace(-0.2, 1.2, k)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = dome_z(np.clip(X, 0, 1), np.clip(Y, 0, 1))
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    tris = []
    for i in range(k - 1):
        for j in range(k - 1):
            a = i * k + j
            tris.append((a, a + k, a + 1))
            tris.append((a + 1, a + k, a + k + 1))
    corners = [(0, 0), (1, 0), (1, 1), (0, 1)]
    bpts, bedges = [], []
    for s in range(4):
        x0, y0 = corners[s]
        x1, y1 = corners[(s + 1) % 4]
        base = len(bpts)
        for t in np.linspace(0, 1, kb):
            bpts.append((x0 + t * (x1 - x0), y0 + t * (y1 - y0), 1.0))
        for i in range(kb - 1):
            bedges.append((base + i, base + i + 1))
    return dome_z, V, np.array(tris), np.array(bpts), np.array(bedges)


def dome_geometry(amp: float = 0.25):
    """The testcases' dome (k = 24) -> (dome_z, V, tris, bpts, bedges)."""
    return _dome(amp, 24, 13)


def bench_dome_geometry():
    """The benchmark's boundary-mode target (amplitude 0.1, k = 64:
    7,938 triangles; a 128-edge border ring) -> (dome_z, V, tris, bpts,
    bedges)."""
    return _dome(0.1, 64, 33)


def tc4() -> TestCase:
    """Boundary smoothing (full OBJ trio) + layer treatment: planar
    block morphs onto a curved target (testcase4 pattern)."""
    m = hex_block(n=(8, 8, 5), patches=TOP_PATCHES)
    _, V, tris, bpts, bedges = dome_geometry()
    return TestCase(
        "tc4", m,
        SmoothingParams(centroidal_iters=80, rel_tol=0.005,
                        smoothing_patches=("top",), min_angle=15.0,
                        layer_patches=("top",),
                        layer_max_blending_fraction=0.3),
        geometry=(V, tris, bpts, bedges, bpts, bedges))


def tc5() -> TestCase:
    """Boundary smoothing + layers on ("top"), small target surface."""
    m = perturb(hex_block(n=(6, 6, 6), patches=TOP_PATCHES), 0.02, seed=5)
    _, V, tris, bpts, bedges = dome_geometry(amp=0.12)
    return TestCase(
        "tc5", m,
        SmoothingParams(centroidal_iters=60, rel_tol=0.01,
                        smoothing_patches=("top",), min_angle=15.0,
                        layer_patches=("top",), max_layers=3),
        geometry=(V, tris, bpts, bedges, bpts, bedges))


def tc7() -> TestCase:
    """targetEdges morphing: feature edges move to a different target
    than the initial edges (boundary morph, testcase7 pattern)."""
    m = hex_block(n=(8, 8, 4), patches=TOP_PATCHES)
    _, V, tris, bpts, bedges = dome_geometry(amp=0.15)
    # target edges: the border ring shrunk towards the centre by 10%
    tpts = bpts.copy()
    tpts[:, :2] = 0.5 + (tpts[:, :2] - 0.5) * 0.9
    return TestCase(
        "tc7", m,
        SmoothingParams(centroidal_iters=80, rel_tol=0.005,
                        smoothing_patches=("top",), min_angle=15.0),
        geometry=(V, tris, bpts, bedges, tpts, bedges))


ALL: Dict[str, Callable[[], TestCase]] = {"tc4": tc4, "tc5": tc5,
                                         "tc7": tc7}
