"""OpenFOAM polyMesh reader/writer (host side).

The polyMesh directory holds five files: ``points`` (vectorField),
``faces`` (faceList), ``owner``/``neighbour`` (labelLists) and
``boundary`` (polyBoundaryMesh).  This module loads them into a
:class:`PolyMesh` — the raw topology the mesh compiler
(:mod:`smoothmesh_torch.mesh.topology`) turns into padded device arrays.

Replaces the reference's OpenFOAM L0 substrate (see SURVEY.md L0;
reference src/smoothMesh.C:1814-1818 mesh load, :2416-2431 write).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from smoothmesh_torch.io import foamfile as ff


@dataclasses.dataclass
class Patch:
    name: str
    type: str
    n_faces: int
    start_face: int

    @property
    def is_processor(self) -> bool:
        return self.type == "processor"

    @property
    def is_empty(self) -> bool:
        return self.type == "empty"


@dataclasses.dataclass
class PolyMesh:
    """Raw polyMesh topology: points + faces + owner/neighbour + patches.

    ``face_flat``/``face_offsets`` form a ragged face->point list;
    ``owner`` has one entry per face, ``neighbour`` one per *internal*
    face (faces ``0..len(neighbour)-1`` are internal, the rest boundary,
    ordered by patch).
    """

    points: np.ndarray          # (N, 3) float64
    face_flat: np.ndarray       # (sum face sizes,) int64
    face_offsets: np.ndarray    # (F+1,) int64
    owner: np.ndarray           # (F,) int64
    neighbour: np.ndarray       # (F_internal,) int64
    patches: List[Patch]

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def n_faces(self) -> int:
        return len(self.face_offsets) - 1

    @property
    def n_internal_faces(self) -> int:
        return len(self.neighbour)

    @property
    def n_cells(self) -> int:
        m = int(self.owner.max()) if len(self.owner) else -1
        if len(self.neighbour):
            m = max(m, int(self.neighbour.max()))
        return m + 1

    def face_points(self, i: int) -> np.ndarray:
        return self.face_flat[self.face_offsets[i]: self.face_offsets[i + 1]]

    def validate(self) -> None:
        f = self.n_faces
        if len(self.owner) != f:
            raise ValueError("owner size != number of faces")
        if self.n_internal_faces > f:
            raise ValueError("more internal faces than faces")
        total = sum(p.n_faces for p in self.patches)
        if self.n_internal_faces + total != f:
            raise ValueError(
                f"patch faces ({total}) + internal ({self.n_internal_faces})"
                f" != faces ({f})"
            )
        for p in self.patches:
            if p.start_face < self.n_internal_faces and p.n_faces > 0:
                raise ValueError(f"patch {p.name} overlaps internal faces")
        if self.face_flat.min(initial=0) < 0 or (
            len(self.face_flat)
            and self.face_flat.max() >= self.n_points
        ):
            raise ValueError("face point label out of range")


def read_polymesh(mesh_dir: str) -> PolyMesh:
    """Read a polyMesh directory; ascii and binary formats both load
    (binary via the faceCompactIOList/raw-list readers in foamfile)."""
    points = ff.read_vector_field_file(os.path.join(mesh_dir, "points"))
    face_flat, face_offsets = ff.read_face_list_file(
        os.path.join(mesh_dir, "faces")
    )
    owner = ff.read_label_list_file(os.path.join(mesh_dir, "owner"))
    neighbour = ff.read_label_list_file(
        os.path.join(mesh_dir, "neighbour")
    )
    raw_patches = ff.parse_boundary(ff.load_body(os.path.join(mesh_dir, "boundary")))
    patches = [
        Patch(
            name=p["name"],
            type=p.get("type", "patch"),
            n_faces=int(p["nFaces"]),
            start_face=int(p["startFace"]),
        )
        for p in raw_patches
    ]
    mesh = PolyMesh(points, face_flat, face_offsets, owner, neighbour, patches)
    mesh.validate()
    return mesh


def write_polymesh(mesh_dir: str, mesh: PolyMesh,
                   points: Optional[np.ndarray] = None,
                   binary: bool = False) -> None:
    """Write a full polyMesh directory (or just new points if unchanged).

    Point precision matches the reference's forced >=10 digits
    (reference src/smoothMesh.C:2425).  ``binary=True`` writes the
    OpenFOAM binary format (raw lists + faceCompactIOList faces).
    """
    pts = mesh.points if points is None else points
    loc = os.path.basename(os.path.dirname(mesh_dir)) or "constant"
    loc = f"{loc}/polyMesh"
    ff.write_vector_field(os.path.join(mesh_dir, "points"),
                          "vectorField", "points", loc, pts,
                          binary=binary)
    ff.write_face_list(os.path.join(mesh_dir, "faces"),
                       "faceList", "faces", loc,
                       mesh.face_flat, mesh.face_offsets, binary=binary)
    ff.write_label_list(os.path.join(mesh_dir, "owner"),
                        "labelList", "owner", loc, mesh.owner,
                        binary=binary)
    ff.write_label_list(os.path.join(mesh_dir, "neighbour"),
                        "labelList", "neighbour", loc, mesh.neighbour,
                        binary=binary)
    ff.write_boundary(
        os.path.join(mesh_dir, "boundary"), loc,
        [
            {
                "name": p.name,
                "type": p.type,
                "nFaces": str(p.n_faces),
                "startFace": str(p.start_face),
            }
            for p in mesh.patches
        ],
    )


def write_points_only(mesh_dir: str, points: np.ndarray) -> None:
    loc = "polyMesh"
    ff.write_vector_field(os.path.join(mesh_dir, "points"),
                          "vectorField", "points", loc, points)
