"""OpenFOAM case directory handling: time directories, controlDict,
mesh instances and classification checkpoints.

Replaces the reference's ``Time``/``IOobject`` usage:
  - time selection / latest-time restart (reference src/smoothMesh.C:1792-1812)
  - mesh write to time directories at write interval (:2416-2431)
  - ``isCornerPoint``/``isFeatureEdgePoint`` labelIOList checkpoints with
    READ_IF_PRESENT / AUTO_WRITE semantics (:2039-2077)
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import numpy as np

from smoothmesh_torch.io import foamfile as ff
from smoothmesh_torch.io.polymesh import PolyMesh, read_polymesh, write_polymesh


def _is_time_dir(name: str) -> bool:
    try:
        float(name)
        return True
    except ValueError:
        return False


def _fmt_time(t: float) -> str:
    """Format a time value like OpenFOAM (general format, no trailing .0)."""
    if t == int(t):
        return str(int(t))
    return f"{t:.12g}"


class FoamCase:
    """A minimal OpenFOAM case: system/, constant/, numeric time dirs."""

    def __init__(self, root: str = "."):
        self.root = os.path.abspath(root)

    # -- time handling ------------------------------------------------------
    def time_dirs(self) -> List[float]:
        out = []
        for name in os.listdir(self.root):
            if _is_time_dir(name) and os.path.isdir(os.path.join(self.root, name)):
                out.append(float(name))
        return sorted(out)

    def latest_time(self) -> float:
        times = self.time_dirs()
        return times[-1] if times else 0.0

    def delta_t(self) -> float:
        """deltaT from system/controlDict (reference src/smoothMesh.C:1806)."""
        path = os.path.join(self.root, "system", "controlDict")
        if not os.path.exists(path):
            return 1.0
        body = ff.strip_comments(open(path).read())
        m = re.search(r"\bdeltaT\s+([-\d.eE+]+)\s*;", body)
        return float(m.group(1)) if m else 1.0

    # -- mesh instances -----------------------------------------------------
    def find_mesh_dir(self, time: Optional[float] = None) -> str:
        """Latest polyMesh instance at or before ``time`` (OpenFOAM rule)."""
        candidates: List[Tuple[float, str]] = []
        for t in self.time_dirs():
            if time is not None and t > time + 1e-12:
                continue
            d = os.path.join(self.root, _fmt_time(t), "polyMesh")
            if os.path.exists(os.path.join(d, "faces")):
                candidates.append((t, d))
            # Mesh copied under <time>/constant/polyMesh (testcase8 style)
            d2 = os.path.join(self.root, _fmt_time(t), "constant", "polyMesh")
            if os.path.exists(os.path.join(d2, "faces")):
                candidates.append((t, d2))
        if candidates:
            return max(candidates, key=lambda c: c[0])[1]
        d = os.path.join(self.root, "constant", "polyMesh")
        if os.path.exists(os.path.join(d, "faces")):
            return d
        raise FileNotFoundError(f"no polyMesh found in case {self.root}")

    def find_points_file(self, time: Optional[float] = None) -> str:
        """Latest ``points`` instance at or before ``time``.

        OpenFOAM meshes move by writing only ``points`` into new time
        dirs while faces/owner stay at the original instance.
        """
        best: Optional[Tuple[float, str]] = None
        for t in self.time_dirs():
            if time is not None and t > time + 1e-12:
                continue
            for sub in ("polyMesh", os.path.join("constant", "polyMesh")):
                p = os.path.join(self.root, _fmt_time(t), sub, "points")
                if os.path.exists(p) and (best is None or t >= best[0]):
                    best = (t, p)
        if best is not None:
            return best[1]
        return os.path.join(self.root, "constant", "polyMesh", "points")

    def read_mesh(self, time: Optional[float] = None) -> PolyMesh:
        mesh_dir = self.find_mesh_dir(time)
        mesh = read_polymesh(mesh_dir)
        pts_file = self.find_points_file(time)
        if os.path.abspath(pts_file) != os.path.abspath(
            os.path.join(mesh_dir, "points")
        ):
            mesh.points = ff.parse_vector_field(ff.load_body(pts_file))
        return mesh

    def write_mesh(self, mesh: PolyMesh, points: np.ndarray, time: float,
                   overwrite: bool = False, binary: bool = False) -> str:
        """Write smoothed points (full mesh on first write of an instance)."""
        if overwrite:
            out_dir = os.path.join(self.root, "constant", "polyMesh")
        else:
            out_dir = os.path.join(self.root, _fmt_time(time), "polyMesh")
        write_polymesh(out_dir, mesh, points=points, binary=binary)
        return out_dir

    # -- classification checkpoints ----------------------------------------
    def read_label_io_list(self, name: str, time: float,
                           n: int) -> Optional[np.ndarray]:
        """READ_IF_PRESENT: look in the time dir, then constant/polyMesh."""
        for d in (
            os.path.join(self.root, _fmt_time(time), "polyMesh"),
            os.path.join(self.root, _fmt_time(time)),
            os.path.join(self.root, "constant", "polyMesh"),
        ):
            path = os.path.join(d, name)
            if os.path.exists(path):
                data = ff.parse_label_list(ff.load_body(path))
                if len(data) == n:
                    return data
        return None

    def write_label_io_list(self, name: str, time: float,
                            data: np.ndarray) -> None:
        d = os.path.join(self.root, _fmt_time(time), "polyMesh")
        ff.write_label_list(os.path.join(d, name), "labelList", name,
                            f"{_fmt_time(time)}/polyMesh", data)

    # -- boundary smoothing geometry files ----------------------------------
    def geometry_file(self, name: str) -> Optional[str]:
        p = os.path.join(self.root, "constant", "geometry", name)
        return p if os.path.exists(p) else None
