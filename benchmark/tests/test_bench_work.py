"""The work counts on a 2 x 2 x 2 block against counts made by hand."""

import torch

from harness import inputs, reftopo, work
from harness.cells import Cell

CONFIG = {"cells_per_side": 2, "grading": [1.0, 1.0, 1.0],
          "patches": {"walls": list(inputs.SIDES)}}
MIX = {"perturbation": 0.0, "params": {}}


def shapes():
    mesh = inputs.make_mesh(CONFIG, MIX, 0)
    return work.shapes(mesh, reftopo.build(mesh, "cpu"), CONFIG, MIX)


def test_shapes_by_hand():
    # 3^3 points, 2^3 cells; 12 internal + 24 boundary quads; 54 lattice
    # edges; each cell: 8 points, 6 faces, 12 edges
    assert shapes() == dict(N=27, F=36, C=8, E=54, M=144, PC=64, PP=108,
                            CF=48, EC=96, rays=0, tris=0)


def test_prism_shapes_by_hand():
    """2 x 2 grid cells (8 triangles, 16 edges, 8 on the border) in 2
    layers of prisms: general padded rows, faces of 3 and of 4 points
    in rows of 4, cells of 5 faces."""
    cfg = {"mesh": "prism_layers", "k": 3, "square": [[0.0, 1.0], [0.0, 1.0]],
           "base_y": 0.0, "jitter": 0.0, "jitter_seed": 0,
           "direction": [0.0, 1.0, 0.0], "thickness": 1.0, "layers": 2}
    mesh = inputs.make_mesh(cfg, MIX, 0)
    T = reftopo.build(mesh, "cpu")
    assert T["face_points"].shape[1] == 4 and T["cell_faces"].shape[1] == 5
    # faces: 8 x 2 inner quads, 8 inner triangles, 16 caps, 8 x 2 border
    # quads; edges: 16 x 3 in the layers' planes, 9 x 2 across them; a
    # prism: 6 points, 5 faces, 9 edges
    assert work.shapes(mesh, T, cfg, MIX) == dict(
        N=27, F=56, C=16, E=66, M=16 * 4 + 8 * 3 + 16 * 3 + 16 * 4,
        PC=16 * 6, PP=2 * 66, CF=16 * 5, EC=16 * 9, rays=0, tris=0)


def test_stage_counts_by_hand():
    w = work.stage_works(Cell.stages(), shapes())
    # every id here fits one byte
    assert w["k1_face_geometry"] == (12 * 27 + 144 + 36 + 36 * 36,
                                     40 * 144 + 10 * 36)
    assert w["k2_cell_centres"] == (24 * 36 + 48 + 8 + 36 + 12 * 8,
                                    28 * 48 + 10 * 8)
    assert w["k6_point_face_angles"] == (8 * 54 + 2 * 54 + 27 + 8 * 27,
                                         4 * 54)
    assert "k8_raycast" not in w          # no rays without boundary


def test_index_bytes():
    assert [work.index_bytes(n) for n in (1, 256, 257, 65536, 65537,
                                          2146689, 2 ** 24 + 1)] \
        == [1, 1, 2, 2, 3, 3, 4]


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == 1.0
    assert work.least_seconds(0, 67e12) == 1.0


def test_rays_are_the_free_top_points():
    cfg = dict(CONFIG, cells_per_side=4,
               patches={"top": ["zmax"],
                        "rest": ["xmin", "xmax", "ymin", "ymax", "zmin"]})
    mesh = inputs.make_mesh(cfg, MIX, 0)
    mix = {"params": {"smoothing_patches": ["top"]}}
    assert work.smoothing_surface_interior(mesh, mix) == 9
    assert torch.is_tensor(reftopo.build(mesh, "cpu")["edges"])
