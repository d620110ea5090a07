"""Prism layers: the extrusion and patches of upstream testcase1's
pipeline (extrude2DMesh, then topoSet and createPatch;
testcase/run_serial, system/extrude2DMeshDict, system/topoSetDict,
system/createPatchDict), a frozen numpy copy independent of the
program, over a synthetic surface.

The surface is not upstream's: testcase1 extrudes its
MeshedSurface.obj, which this repository does not hold.  It is a
triangulated square of ``k`` x ``k`` vertices in the plane
y = ``base_y`` over ``square`` ([[x0, x1], [z0, z1]]), each vertex off
the square's border moved in the plane by up to ``jitter`` of the
spacing (per axis, uniform, from the recipe's own generator seeded by
``jitter_seed``, so the mesh does not depend on the run's seed).  The
grid cells of each of ``holes`` ([i0, j0, i1, j1]: i0 <= i < i1,
j0 <= j < j1) are left out, and so are the vertices no triangle keeps.
The triangles are extruded along ``direction`` into ``layers`` layers
of prisms of equal thickness over ``thickness``, as the port's
``mesh/extrude.py`` extrudes testcase1.  Each boundary face goes to the
first of ``patch_boxes`` ([name, [lo], [hi]]) that holds its centre
(topoSet's boxToFace, createPatch), the rest, with the holes' walls, to
``defaultFaces``.

Size: a triangulation of V vertices, T triangles and E edges (Eb on
its border, Ei inside) in L layers gives V (L + 1) points, T L prisms,
Ei L + T (L - 1) + 2 T + Eb L faces (triangles of 3 points, quads of 4)
and E (L + 1) + V L edges.  At k = 362 with one hole of 91 x 91 grid
cells (the port's synthetic square for testcase1, scaled: V 122,944,
T 244,080, E 367,024, Eb 1,808) and 15 layers:
1,967,104 points, 3,661,200 prisms, 9,410,640 faces, 7,716,544 edges.
"""

import numpy as np

DEFAULT_PATCH = "defaultFaces"


def triangulation(config: dict) -> tuple:
    """The square's vertices (V, 3) and triangles (T, 3): two a grid
    cell, cells in row order, holes left out."""
    k = int(config["k"])
    (x0, x1), (z0, z1) = config["square"]
    X, Z = np.meshgrid(np.linspace(x0, x1, k), np.linspace(z0, z1, k),
                       indexing="ij")
    rng = np.random.default_rng(int(config["jitter_seed"]))
    step = np.array([(x1 - x0) / (k - 1), (z1 - z0) / (k - 1)])
    jit = rng.uniform(-1.0, 1.0, size=(k, k, 2)) * (config["jitter"] * step)
    jit[0, :] = jit[-1, :] = jit[:, 0] = jit[:, -1] = 0.0
    verts = np.stack([X + jit[..., 0], np.full_like(X, config["base_y"]),
                      Z + jit[..., 1]], axis=-1).reshape(-1, 3)
    keep = np.ones((k - 1, k - 1), dtype=bool)
    for i0, j0, i1, j1 in config.get("holes", []):
        keep[i0:i1, j0:j1] = False
    i, j = np.nonzero(keep)
    a = i * k + j
    tris = np.stack([np.stack([a, a + 1, a + k], 1),
                     np.stack([a + 1, a + k + 1, a + k], 1)],
                    1).reshape(-1, 3)
    used = np.zeros(k * k, dtype=bool)
    used[tris] = True
    renumber = np.cumsum(used) - 1
    return verts[used], renumber[tris]


def extrude(verts, tris, direction, thickness: float, layers: int,
            patch_boxes) -> dict:
    """extrude2DMesh, topoSet and createPatch: the surface's triangles
    (oriented counter-clockwise seen from ``direction``) extruded into
    prisms -> a mesh dict.  Points layer by layer; faces: the internal
    quads (interior edges in order, layers fastest), the internal
    triangles (triangles in order, layers fastest), then the boundary
    faces (each triangle's front and back cap, then the quads of the
    border edges) sorted by patch, stably."""
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64).copy()
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    V, T, K = len(verts), len(tris), int(layers)
    n_t = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                   verts[tris[:, 2]] - verts[tris[:, 0]])
    flip = n_t @ d < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    height = np.arange(K + 1) * (thickness / K)
    pts = (verts[None, :, :] + height[:, None, None]
           * d[None, None, :]).reshape(-1, 3)

    # directed edges of the triangles, each paired with its reverse
    de = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    de_tri = np.tile(np.arange(T), 3)
    key = de[:, 0] * V + de[:, 1]
    rkey = de[:, 1] * V + de[:, 0]
    order = np.argsort(key, kind="stable")
    rpos = np.minimum(np.searchsorted(key[order], rkey), len(key) - 1)
    has_twin = key[order][rpos] == rkey
    twin_tri = np.where(has_twin, de_tri[order][rpos], -1)
    interior = np.nonzero(has_twin & (de_tri < twin_tri))[0]
    border = np.nonzero(~has_twin)[0]

    ks = np.arange(K)

    def side_quads(e):
        a, b = de[e, 0][:, None], de[e, 1][:, None]
        q = np.stack([ks * V + a, ks * V + b, (ks + 1) * V + b,
                      (ks + 1) * V + a], -1)
        return q.reshape(-1, 4), (ks * T + de_tri[e][:, None]).ravel()

    q_int, q_own = side_quads(interior)
    q_nei = (ks * T + twin_tri[interior][:, None]).ravel()
    up = np.arange(1, K)
    t_int = (up[None, :, None] * V + tris[:, None, :]).reshape(-1, 3)
    t_own = (np.arange(T)[:, None] + (up - 1)[None, :] * T).ravel()
    t_nei = t_own + T

    # boundary faces, padded to 4 with -1: caps (front, outward against
    # the direction, and back, each triangle in turn), then border quads
    caps = np.stack([tris[:, [0, 2, 1]], K * V + tris], 1).reshape(-1, 3)
    cap_own = np.stack([np.arange(T), (K - 1) * T + np.arange(T)],
                       1).ravel()
    q_bnd, q_bnd_own = side_quads(border)
    bfaces = np.concatenate([np.pad(caps, ((0, 0), (0, 1)),
                                    constant_values=-1), q_bnd])
    bown = np.concatenate([cap_own, q_bnd_own])
    bcount = np.concatenate([np.full(len(caps), 3), np.full(len(q_bnd), 4)])

    P = np.where((bfaces >= 0)[..., None], pts[bfaces.clip(0)], 0.0)
    centres = (P[:, 0] + P[:, 1] + P[:, 2] + P[:, 3]) / bcount[:, None]
    assign = np.full(len(bfaces), len(patch_boxes), dtype=np.int64)
    for i, (_, lo, hi) in enumerate(patch_boxes):
        inside = np.all((centres >= np.asarray(lo))
                        & (centres <= np.asarray(hi)), axis=1)
        assign = np.where((assign == len(patch_boxes)) & inside, i, assign)
    order_b = np.argsort(assign, kind="stable")

    n_int = len(q_int) + len(t_int)
    patches, start = [], n_int
    names = [box[0] for box in patch_boxes] + [DEFAULT_PATCH]
    for i, name in enumerate(names):
        n = int((assign == i).sum())
        if n == 0 and i == len(patch_boxes):
            continue
        patches.append((name, n, start))
        start += n

    bsorted = bfaces[order_b]
    flat = np.concatenate([q_int.ravel(), t_int.ravel(),
                           bsorted[bsorted >= 0]])
    counts = np.concatenate([np.full(len(q_int), 4), np.full(len(t_int), 3),
                             bcount[order_b]])
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return dict(points=pts, face_flat=flat.astype(np.int64),
                face_offsets=offsets,
                owner=np.concatenate([q_own, t_own, bown[order_b]])
                .astype(np.int64),
                neighbour=np.concatenate([q_nei, t_nei]).astype(np.int64),
                patches=patches)


def build(config: dict) -> dict:
    verts, tris = triangulation(config)
    return extrude(verts, tris, config["direction"], config["thickness"],
                   config["layers"], config.get("patch_boxes", ()))


def spacing(mesh: dict) -> float:
    """The mesh's minimum edge length (over the faces' perimeters)."""
    flat, offs = mesh["face_flat"], mesh["face_offsets"]
    counts = np.diff(offs)
    face = np.repeat(np.arange(len(counts)), counts)
    slot = np.arange(len(flat)) - offs[face]
    nxt = flat[offs[face] + (slot + 1) % counts[face]]
    pts = mesh["points"]
    return float(np.linalg.norm(pts[flat] - pts[nxt], axis=1).min())
