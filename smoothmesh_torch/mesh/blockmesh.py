"""blockMesh-style structured hex mesh generation.

The reference's testcases generate their input meshes with OpenFOAM's
``blockMesh`` (reference testcase*/system/blockMeshDict, run via
``run_serial`` scripts).  This module provides an equivalent standalone
generator for single graded hex blocks, producing a
:class:`~smoothmesh_torch.io.polymesh.PolyMesh` with OpenFOAM face
ordering (internal faces upper-triangular by owner then neighbour,
boundary faces grouped by patch, outward owner normals).

Supports simple grading (one expansion ratio per axis) and blockMesh
multi-grading ``[(lengthFrac, cellFrac, expansion), ...]`` — enough to
reproduce the graded cube of testcase8 (testcase8/system/blockMeshDict).
Deliberately mesh distortion helpers (:func:`perturb`) create the
low-quality inputs the smoother is tested against.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from smoothmesh_torch.io.polymesh import Patch, PolyMesh

GradingSpec = Union[float, Sequence[Tuple[float, float, float]]]


def _segment_coords(n: int, expansion: float) -> np.ndarray:
    """Normalized coordinates (0..1) of n+1 points with geometric grading.

    ``expansion`` is the blockMesh convention: size(last cell)/size(first).
    """
    if n <= 0:
        raise ValueError("segment needs at least one cell")
    if n == 1 or abs(expansion - 1.0) < 1e-12:
        return np.linspace(0.0, 1.0, n + 1)
    k = expansion ** (1.0 / (n - 1))
    sizes = k ** np.arange(n)
    coords = np.concatenate([[0.0], np.cumsum(sizes)])
    return coords / coords[-1]


def _axis_coords(n: int, grading: GradingSpec) -> np.ndarray:
    """Normalized axis coordinates (0..1), simple or multi-grading."""
    if isinstance(grading, (int, float)):
        return _segment_coords(n, float(grading))
    segs = [s for s in grading if s[0] > 0 and s[1] > 0]  # drop spacer rows
    if not segs:
        return np.linspace(0.0, 1.0, n + 1)
    lf = np.array([s[0] for s in segs], dtype=np.float64)
    cf = np.array([s[1] for s in segs], dtype=np.float64)
    lf = lf / lf.sum()
    cf = cf / cf.sum()
    # Integer cell counts per segment summing to n (each active segment
    # keeps at least one cell)
    counts = np.maximum(np.floor(cf * n + 0.5).astype(int), 1)
    while counts.sum() > n:
        cand = np.where(counts > 1)[0]
        counts[cand[np.argmax(counts[cand])]] -= 1
    while counts.sum() < n:
        counts[int(np.argmax(cf - counts / n))] += 1
    coords = [np.array([0.0])]
    x0 = 0.0
    for i, s in enumerate(segs):
        seg = _segment_coords(counts[i], float(s[2]))
        coords.append(x0 + lf[i] * seg[1:])
        x0 += lf[i]
    out = np.concatenate(coords)
    out[-1] = 1.0
    return out


def hex_block(
    p_min: Sequence[float] = (0.0, 0.0, 0.0),
    p_max: Sequence[float] = (1.0, 1.0, 1.0),
    n: Sequence[int] = (3, 3, 3),
    grading: Sequence[GradingSpec] = (1.0, 1.0, 1.0),
    patches: Union[str, Dict[str, Sequence[str]], None] = "walls",
    scale: float = 1.0,
) -> PolyMesh:
    """Generate a single hex block mesh.

    ``patches`` is either a single patch name covering all six sides
    (like testcase8's ``default`` patch) or an ordered mapping
    ``{name: [sides...]}`` with sides from
    {xmin, xmax, ymin, ymax, zmin, zmax}.
    """
    nx, ny, nz = (int(v) for v in n)
    xs = np.asarray(p_min[0] + (p_max[0] - p_min[0]) * _axis_coords(nx, grading[0]))
    ys = np.asarray(p_min[1] + (p_max[1] - p_min[1]) * _axis_coords(ny, grading[1]))
    zs = np.asarray(p_min[2] + (p_max[2] - p_min[2]) * _axis_coords(nz, grading[2]))

    # Points: index p = i + (nx+1)*(j + (ny+1)*k)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack(
        [X.ravel(order="F"), Y.ravel(order="F"), Z.ravel(order="F")], axis=1
    )
    # order='F' on meshgrid(ij) ravels i fastest: p = i + (nx+1)*(j + (ny+1)*k)
    pts = pts * scale

    def P(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    def C(i, j, k):
        return i + nx * (j + ny * k)

    # Internal faces, fully vectorized: for each cell in index order,
    # upper neighbours in increasing cell-id order (+x, +y, +z) —
    # OpenFOAM upper-triangular ordering.
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    # cell-index order: i fastest -> sort by C = i + nx*(j + ny*k)
    I = I.transpose(2, 1, 0).ravel()
    J = J.transpose(2, 1, 0).ravel()
    K = K.transpose(2, 1, 0).ravel()

    def quad_x(i, j, k):
        return np.stack([P(i + 1, j, k), P(i + 1, j + 1, k),
                         P(i + 1, j + 1, k + 1), P(i + 1, j, k + 1)], axis=1)

    def quad_y(i, j, k):
        return np.stack([P(i, j + 1, k), P(i, j + 1, k + 1),
                         P(i + 1, j + 1, k + 1), P(i + 1, j + 1, k)], axis=1)

    def quad_z(i, j, k):
        return np.stack([P(i, j, k + 1), P(i + 1, j, k + 1),
                         P(i + 1, j + 1, k + 1), P(i, j + 1, k + 1)], axis=1)

    has_x = I + 1 < nx
    has_y = J + 1 < ny
    has_z = K + 1 < nz
    per_cell = has_x.astype(int) + has_y.astype(int) + has_z.astype(int)
    n_internal = int(per_cell.sum())
    int_faces = np.zeros((n_internal, 4), dtype=np.int64)
    int_owner = np.zeros(n_internal, dtype=np.int64)
    int_neigh = np.zeros(n_internal, dtype=np.int64)
    # slot offsets: cells in order, +x before +y before +z
    base = np.zeros(len(I), dtype=np.int64)
    np.cumsum(per_cell[:-1], out=base[1:])
    cids = C(I, J, K)
    pos = base.copy()
    for has, quad, nb in (
        (has_x, quad_x, lambda i, j, k: C(i + 1, j, k)),
        (has_y, quad_y, lambda i, j, k: C(i, j + 1, k)),
        (has_z, quad_z, lambda i, j, k: C(i, j, k + 1)),
    ):
        sel = has
        slots = pos[sel]
        int_faces[slots] = quad(I[sel], J[sel], K[sel])
        int_owner[slots] = cids[sel]
        int_neigh[slots] = nb(I[sel], J[sel], K[sel])
        pos = pos + sel.astype(np.int64)

    face_blocks: List[np.ndarray] = [int_faces]
    owner_blocks: List[np.ndarray] = [int_owner]
    neighbour = int_neigh
    n_faces_so_far = n_internal

    def side_faces(side: str):
        """Vectorized boundary quads + owner cells for one block side."""
        if side in ("xmin", "xmax"):
            j, k = np.meshgrid(np.arange(ny), np.arange(nz), indexing="ij")
            j = j.ravel(order="F")
            k = k.ravel(order="F")
            if side == "xmin":
                quads = np.stack([P(0, j, k), P(0, j, k + 1),
                                  P(0, j + 1, k + 1), P(0, j + 1, k)], axis=1)
                own = C(0, j, k)
            else:
                quads = np.stack([P(nx, j, k), P(nx, j + 1, k),
                                  P(nx, j + 1, k + 1), P(nx, j, k + 1)],
                                 axis=1)
                own = C(nx - 1, j, k)
        elif side in ("ymin", "ymax"):
            i, k = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
            i = i.ravel(order="F")
            k = k.ravel(order="F")
            if side == "ymin":
                quads = np.stack([P(i, 0, k), P(i + 1, 0, k),
                                  P(i + 1, 0, k + 1), P(i, 0, k + 1)], axis=1)
                own = C(i, 0, k)
            else:
                quads = np.stack([P(i, ny, k), P(i, ny, k + 1),
                                  P(i + 1, ny, k + 1), P(i + 1, ny, k)],
                                 axis=1)
                own = C(i, ny - 1, k)
        elif side in ("zmin", "zmax"):
            i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
            i = i.ravel(order="F")
            j = j.ravel(order="F")
            if side == "zmin":
                quads = np.stack([P(i, j, 0), P(i, j + 1, 0),
                                  P(i + 1, j + 1, 0), P(i + 1, j, 0)], axis=1)
                own = C(i, j, 0)
            else:
                quads = np.stack([P(i, j, nz), P(i + 1, j, nz),
                                  P(i + 1, j + 1, nz), P(i, j + 1, nz)],
                                 axis=1)
                own = C(i, j, nz - 1)
        else:
            raise ValueError(f"unknown side {side}")
        return quads, own

    all_sides = ["xmin", "xmax", "ymin", "ymax", "zmin", "zmax"]
    if patches is None or isinstance(patches, str):
        name = patches or "walls"
        patch_map: Dict[str, Sequence[str]] = {name: all_sides}
    else:
        patch_map = dict(patches)
        covered = [s for sides in patch_map.values() for s in sides]
        if sorted(covered) != sorted(all_sides):
            raise ValueError("patches must cover all six sides exactly once")

    patch_list: List[Patch] = []
    for name, sides in patch_map.items():
        start = n_faces_so_far
        for side in sides:
            quads, own = side_faces(side)
            face_blocks.append(quads)
            owner_blocks.append(own)
            n_faces_so_far += len(quads)
        patch_list.append(Patch(name=name, type="wall",
                                n_faces=n_faces_so_far - start,
                                start_face=start))

    all_faces = np.concatenate(face_blocks, axis=0)
    face_flat = all_faces.reshape(-1).astype(np.int64)
    face_offsets = np.arange(len(all_faces) + 1, dtype=np.int64) * 4
    mesh = PolyMesh(
        points=pts,
        face_flat=face_flat,
        face_offsets=face_offsets,
        owner=np.concatenate(owner_blocks).astype(np.int64),
        neighbour=neighbour.astype(np.int64),
        patches=patch_list,
    )
    mesh.validate()
    return mesh


def perturb(mesh: PolyMesh, amplitude: float, seed: int = 0,
            boundary: bool = False) -> PolyMesh:
    """Randomly displace mesh points to create a low-quality input.

    Internal points only by default (boundary stays fixed so the
    smoother's boundary handling is unaffected).  Displacement is
    uniform in [-amplitude, amplitude] per component.
    """
    from smoothmesh_torch.mesh.topology import boundary_point_mask

    rng = np.random.default_rng(seed)
    disp = rng.uniform(-amplitude, amplitude, size=mesh.points.shape)
    if not boundary:
        mask = ~boundary_point_mask(mesh)
        disp = disp * mask[:, None]
    out = PolyMesh(
        points=mesh.points + disp,
        face_flat=mesh.face_flat,
        face_offsets=mesh.face_offsets,
        owner=mesh.owner,
        neighbour=mesh.neighbour,
        patches=mesh.patches,
    )
    return out


def prism_block(
    n: Sequence[int] = (3, 3, 3),
    p_min: Sequence[float] = (0.0, 0.0, 0.0),
    p_max: Sequence[float] = (1.0, 1.0, 1.0),
) -> PolyMesh:
    """Triangular-prism mesh: each hex of a uniform block split in two
    along the xy diagonal.  Produces mixed face sizes (triangles +
    quads) and 5-faced cells — exercises the polyhedral paths that a
    pure hex mesh cannot (ragged perimeters, 3-point faces, wedge
    tables on triangles).
    """
    nx, ny, nz = (int(v) for v in n)
    xs = np.linspace(p_min[0], p_max[0], nx + 1)
    ys = np.linspace(p_min[1], p_max[1], ny + 1)
    zs = np.linspace(p_min[2], p_max[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(order="F"), Y.ravel(order="F"),
                    Z.ravel(order="F")], axis=1)

    def P(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    def A(i, j, k):  # prism on the (a,b,c) side (b-c edge at x+)
        return 2 * (i + nx * (j + ny * k))

    def B(i, j, k):  # prism on the (a,c,d) side
        return A(i, j, k) + 1

    faces = []      # list of point tuples
    owner = []
    neighbour = []

    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                a0, b0 = P(i, j, k), P(i + 1, j, k)
                c0, d0 = P(i + 1, j + 1, k), P(i, j + 1, k)
                a1, b1 = P(i, j, k + 1), P(i + 1, j, k + 1)
                c1, d1 = P(i + 1, j + 1, k + 1), P(i, j + 1, k + 1)
                # diagonal quad between the two prisms (normal A -> B)
                faces.append((a0, a1, c1, c0))
                owner.append(A(i, j, k))
                neighbour.append(B(i, j, k))
                # x+ quad: A(i,j) -> B(i+1,j)
                if i + 1 < nx:
                    faces.append((b0, c0, c1, b1))
                    owner.append(A(i, j, k))
                    neighbour.append(B(i + 1, j, k))
                # y+ quad: B(i,j) -> A(i,j+1)
                if j + 1 < ny:
                    faces.append((d0, d1, c1, c0))
                    owner.append(B(i, j, k))
                    neighbour.append(A(i, j + 1, k))
                # z+ triangles: A -> A above, B -> B above
                if k + 1 < nz:
                    faces.append((a1, b1, c1))
                    owner.append(A(i, j, k))
                    neighbour.append(A(i, j, k + 1))
                    faces.append((a1, c1, d1))
                    owner.append(B(i, j, k))
                    neighbour.append(B(i, j, k + 1))

    n_internal = len(faces)
    start = n_internal

    # single boundary patch covering all sides, outward normals
    for k in range(nz):
        for j in range(ny):
            faces.append((P(0, j, k), P(0, j, k + 1),
                          P(0, j + 1, k + 1), P(0, j + 1, k)))
            owner.append(B(0, j, k))
            faces.append((P(nx, j, k), P(nx, j + 1, k),
                          P(nx, j + 1, k + 1), P(nx, j, k + 1)))
            owner.append(A(nx - 1, j, k))
    for k in range(nz):
        for i in range(nx):
            faces.append((P(i, 0, k), P(i + 1, 0, k),
                          P(i + 1, 0, k + 1), P(i, 0, k + 1)))
            owner.append(A(i, 0, k))
            faces.append((P(i, ny, k), P(i, ny, k + 1),
                          P(i + 1, ny, k + 1), P(i + 1, ny, k)))
            owner.append(B(i, ny - 1, k))
    for j in range(ny):
        for i in range(nx):
            faces.append((P(i, j, 0), P(i + 1, j + 1, 0), P(i + 1, j, 0)))
            owner.append(A(i, j, 0))
            faces.append((P(i, j, 0), P(i, j + 1, 0), P(i + 1, j + 1, 0)))
            owner.append(B(i, j, 0))
            faces.append((P(i, j, nz), P(i + 1, j, nz),
                          P(i + 1, j + 1, nz)))
            owner.append(A(i, j, nz - 1))
            faces.append((P(i, j, nz), P(i + 1, j + 1, nz),
                          P(i, j + 1, nz)))
            owner.append(B(i, j, nz - 1))

    patch = Patch(name="walls", type="wall",
                  n_faces=len(faces) - start, start_face=start)
    face_flat = np.array([p for f in faces for p in f], dtype=np.int64)
    offsets = np.zeros(len(faces) + 1, dtype=np.int64)
    np.cumsum([len(f) for f in faces], out=offsets[1:])
    mesh = PolyMesh(points=pts, face_flat=face_flat, face_offsets=offsets,
                    owner=np.array(owner, dtype=np.int64),
                    neighbour=np.array(neighbour, dtype=np.int64),
                    patches=[patch])
    mesh.validate()
    return mesh
