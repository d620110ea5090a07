"""The benchmark's inputs, made from a configuration, a traffic mix and
a seed: the configuration's mesh, its interior perturbation and the
dome target.  Frozen numpy copies of the recipes (blockMesh-style graded
hex with OpenFOAM face order, uniform interior perturbation, the k x k
dome with its border ring), independent of the program, so that a
change to the program's own generators cannot change what is measured.

A configuration names its mesh recipe with ``mesh``: the module
``benchmark/recipes/<mesh>.py``, which defines ``build(config) -> mesh``
and ``spacing(mesh) -> float``, the unit of the mix's
``perturbation``.  Without the key the mesh is the hex block
(:func:`hex_block`, unit :func:`min_spacing`).  Adding a recipe adds a
file.

A mesh is a dict of numpy arrays: ``points`` (N, 3) float64,
``face_flat``/``face_offsets`` (ragged faces), ``owner``,
``neighbour`` (internal faces first) and ``patches``, a list of
``(name, n_faces, start_face)``.
"""

from __future__ import annotations

import numpy as np

SIDES = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")


def axis_coords(n: int, expansion: float) -> np.ndarray:
    """n + 1 coordinates on [0, 1], geometric grading with last cell /
    first cell = ``expansion`` (blockMesh's simple grading)."""
    if n == 1 or abs(expansion - 1.0) < 1e-12:
        return np.linspace(0.0, 1.0, n + 1)
    sizes = (expansion ** (1.0 / (n - 1))) ** np.arange(n)
    coords = np.concatenate([[0.0], np.cumsum(sizes)])
    return coords / coords[-1]


def hex_block(n, grading, patches) -> dict:
    """A graded hex block on the unit cube: points numbered i fastest,
    internal faces in cell order (+x, +y, +z of each cell, owner the
    lower cell), then the patches' faces in the order given
    (``patches``: {name: [sides]}), outward normals."""
    nx, ny, nz = (int(v) for v in n)
    xs, ys, zs = (axis_coords(m, g) for m, g in zip((nx, ny, nz), grading))
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(order="F"), Y.ravel(order="F"),
                    Z.ravel(order="F")], axis=1)

    def P(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    def C(i, j, k):
        return i + nx * (j + ny * k)

    K, J, I = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()      # cell order, i fastest
    quads = {
        "x": lambda i, j, k: (P(i + 1, j, k), P(i + 1, j + 1, k),
                              P(i + 1, j + 1, k + 1), P(i + 1, j, k + 1)),
        "y": lambda i, j, k: (P(i, j + 1, k), P(i, j + 1, k + 1),
                              P(i + 1, j + 1, k + 1), P(i + 1, j + 1, k)),
        "z": lambda i, j, k: (P(i, j, k + 1), P(i + 1, j, k + 1),
                              P(i + 1, j + 1, k + 1), P(i, j + 1, k + 1)),
    }
    step = {"x": (1, 0, 0), "y": (0, 1, 0), "z": (0, 0, 1)}
    has = {"x": I + 1 < nx, "y": J + 1 < ny, "z": K + 1 < nz}
    # each cell's upper faces, +x before +y before +z, cells in order
    rows, keys = [], []
    for a, ax in enumerate("xyz"):
        s = has[ax]
        i, j, k = I[s], J[s], K[s]
        di, dj, dk = step[ax]
        rows.append(np.stack([np.stack(quads[ax](i, j, k), 1),
                              np.stack([C(i, j, k), C(i + di, j + dj, k + dk),
                                        np.zeros_like(i), np.zeros_like(i)],
                                       1)], 1))
        keys.append(C(i, j, k) * 3 + a)
    order = np.argsort(np.concatenate(keys), kind="stable")
    internal = np.concatenate(rows)[order]
    faces = [internal[:, 0]]
    owner = [internal[:, 1, 0]]
    neighbour = internal[:, 1, 1]

    def side(name):
        a, b = np.meshgrid(*(np.arange(m) for m, s in
                             zip((nx, ny, nz), "xyz") if s != name[0]),
                           indexing="ij")
        a, b = a.ravel(order="F"), b.ravel(order="F")
        if name == "xmin":
            return (np.stack([P(0, a, b), P(0, a, b + 1), P(0, a + 1, b + 1),
                              P(0, a + 1, b)], 1), C(0, a, b))
        if name == "xmax":
            return (np.stack([P(nx, a, b), P(nx, a + 1, b),
                              P(nx, a + 1, b + 1), P(nx, a, b + 1)], 1),
                    C(nx - 1, a, b))
        if name == "ymin":
            return (np.stack([P(a, 0, b), P(a + 1, 0, b), P(a + 1, 0, b + 1),
                              P(a, 0, b + 1)], 1), C(a, 0, b))
        if name == "ymax":
            return (np.stack([P(a, ny, b), P(a, ny, b + 1),
                              P(a + 1, ny, b + 1), P(a + 1, ny, b)], 1),
                    C(a, ny - 1, b))
        if name == "zmin":
            return (np.stack([P(a, b, 0), P(a, b + 1, 0), P(a + 1, b + 1, 0),
                              P(a + 1, b, 0)], 1), C(a, b, 0))
        return (np.stack([P(a, b, nz), P(a + 1, b, nz), P(a + 1, b + 1, nz),
                          P(a, b + 1, nz)], 1), C(a, b, nz - 1))

    covered = sorted(s for sides in patches.values() for s in sides)
    if covered != sorted(SIDES):
        raise ValueError("patches must cover the six sides once each")
    plist, start = [], len(internal)
    for name, sides in patches.items():
        count = 0
        for s in sides:
            q, o = side(s)
            faces.append(q)
            owner.append(o)
            count += len(q)
        plist.append((name, count, start))
        start += count
    faces = np.concatenate(faces).astype(np.int64)
    return dict(points=pts, face_flat=faces.ravel(),
                face_offsets=np.arange(len(faces) + 1, dtype=np.int64) * 4,
                owner=np.concatenate(owner).astype(np.int64),
                neighbour=neighbour.astype(np.int64), patches=plist)


def boundary_points(mesh: dict) -> np.ndarray:
    """(N,) bool: points on a boundary face."""
    first = len(mesh["neighbour"])
    mask = np.zeros(len(mesh["points"]), dtype=bool)
    mask[mesh["face_flat"][mesh["face_offsets"][first]:]] = True
    return mask


def min_spacing(mesh: dict) -> float:
    """The smallest spacing of the block's axis coordinates."""
    return min(float(np.diff(np.unique(mesh["points"][:, a])).min())
               for a in range(3))


def perturb(mesh: dict, amplitude: float, seed: int) -> dict:
    """Interior points displaced uniformly in [-amplitude, amplitude]
    per component, drawn from ``seed``; boundary points stay."""
    rng = np.random.default_rng(seed)
    disp = rng.uniform(-amplitude, amplitude, size=mesh["points"].shape)
    disp[boundary_points(mesh)] = 0.0
    return dict(mesh, points=mesh["points"] + disp)


def dome(amp: float, k: int, kb: int):
    """The target surface z = 1 + amp sin(pi x) sin(pi y) over [0, 1]^2,
    flat out to [-0.2, 1.2]^2, as k x k vertices in 2 (k-1)^2 triangles,
    and the unit square's border at z = 1 as 4 (kb - 1) edges (each
    side's kb points separate) -> (vertices, triangles, ring points,
    ring edges)."""
    xs = np.linspace(-0.2, 1.2, k)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = 1.0 + amp * np.sin(np.pi * np.clip(X, 0, 1)) \
        * np.sin(np.pi * np.clip(Y, 0, 1))
    V = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    i, j = np.meshgrid(np.arange(k - 1), np.arange(k - 1), indexing="ij")
    a = (i * k + j).ravel()
    tris = np.stack([np.stack([a, a + k, a + 1], 1),
                     np.stack([a + 1, a + k, a + k + 1], 1)], 1).reshape(-1, 3)
    corners = [(0, 0), (1, 0), (1, 1), (0, 1)]
    t = np.linspace(0, 1, kb)
    bpts, bedges = [], []
    for s in range(4):
        (x0, y0), (x1, y1) = corners[s], corners[(s + 1) % 4]
        base = s * kb
        bpts.append(np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0),
                              np.ones(kb)], 1))
        bedges.append(np.stack([base + np.arange(kb - 1),
                                base + np.arange(1, kb)], 1))
    return V, tris, np.concatenate(bpts), np.concatenate(bedges)


def path(mix: dict) -> str:
    """The mix's path through the iteration: ``boundary`` (boundary
    smoothing), ``layers`` (layer patches, no boundary smoothing) or
    ``internal``."""
    if mix.get("boundary_smoothing"):
        return "boundary"
    if mix["params"].get("layer_patches"):
        return "layers"
    return "internal"


def target(config: dict, mix: dict):
    """The boundary path's target (the dome), or None where the mix
    smooths no boundary."""
    if path(mix) != "boundary":
        return None
    return dome(**config["target"]["dome"])


def recipe(config: dict):
    """The mesh recipe (module) a configuration names with ``mesh``."""
    from harness.cells import HERE, load_module

    return load_module(HERE / "recipes" / f"{config['mesh']}.py")


def make_mesh(config: dict, mix: dict, seed: int) -> dict:
    """The configuration's mesh, its interior perturbed as the mix says
    from the seed."""
    if "mesh" in config:
        rec = recipe(config)
        base = rec.build(config)
        unit = rec.spacing(base)
    else:
        side = int(config["cells_per_side"])
        base = hex_block((side, side, side), config["grading"],
                         config["patches"])
        unit = min_spacing(base)
    return perturb(base, float(mix["perturbation"]) * unit, seed)
