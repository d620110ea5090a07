"""Smoothing parameters with the reference's derived defaults.

Mirrors the option resolution of smoothMesh (reference
src/smoothMesh.C:1854-1921): several defaults are *derived* from the
initial mesh statistics rather than constants:

  - ``min_edge_length``  defaults to 0.5 x (global minimum edge length)
  - ``max_step_length``  defaults to 0.3 x min_edge_length
  - ``layer_edge_length`` defaults to min_edge_length
  - ``write_interval``   defaults to centroidal_iters
  - ``distance_tolerance`` = 1e-4 x min(mesh min edge, layer_edge_length)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

# Tolerances (reference src/smoothMeshCommon.H:20-21)
REL_TOL = 1e-4
ABS_TOL = 1e-6


@dataclasses.dataclass
class SmoothingParams:
    """User-facing smoothing options (reference src/smoothMesh.C:1637-1784).

    ``None`` values mean "derive the default from the mesh" — call
    :meth:`resolve` with the mesh's global minimum edge length to obtain
    a fully-populated instance.
    """

    centroidal_iters: int = 1000
    rel_tol: float = 0.02
    min_edge_length: Optional[float] = None
    max_step_length: Optional[float] = None
    rel_step_frac: float = 0.5
    total_min_freeze: bool = False
    edge_angle_constraint: bool = True
    face_angle_constraint: bool = True
    min_angle: float = 35.0          # degrees
    max_angle: float = 160.0         # degrees
    layer_max_blending_fraction: float = 0.3
    layer_edge_length: Optional[float] = None
    layer_expansion_ratio: float = 1.3
    min_layers: int = 1
    max_layers: int = 4
    layer_patches: Sequence[str] = ()       # patch names / regexes
    smoothing_patches: Sequence[str] = (".*",)
    internal_smoothing_blending_fraction: float = 0.0
    write_interval: Optional[int] = None
    # Ray-cast no-hit policy: the reference aborts with a diagnostic
    # when a smoothing-surface point finds no targetSurfaces
    # intersection within the maximum search radius (bPS.C:933-940).
    # False freezes the point in place instead.
    ray_miss_fatal: bool = True

    # Derived at resolve() time
    distance_tolerance: Optional[float] = None

    def resolve(self, mesh_min_edge_length: float) -> "SmoothingParams":
        """Fill in derived defaults (reference src/smoothMesh.C:1861-1921)."""
        p = dataclasses.replace(self)
        if p.min_edge_length is None:
            p.min_edge_length = 0.5 * mesh_min_edge_length
        if p.max_step_length is None:
            p.max_step_length = 0.3 * p.min_edge_length
        if p.layer_edge_length is None:
            p.layer_edge_length = p.min_edge_length
        if p.write_interval is None:
            p.write_interval = p.centroidal_iters
        p.distance_tolerance = REL_TOL * min(
            mesh_min_edge_length, p.layer_edge_length
        )
        return p

    @property
    def min_angle_rad(self) -> float:
        return math.pi * self.min_angle / 180.0

    @property
    def max_angle_rad(self) -> float:
        return math.pi * self.max_angle / 180.0

    def warn_step_length(self) -> Optional[str]:
        """Stability warning (reference src/smoothMesh.C:1867-1872)."""
        if (
            self.max_step_length is not None
            and self.min_edge_length is not None
            and self.max_step_length > 0.5 * self.min_edge_length
        ):
            return (
                "WARNING: The maximum allowed step length is more than half "
                "of the minimum edge length! This may cause unstability in "
                "smoothing."
            )
        return None
