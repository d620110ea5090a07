"""The plain reference against the port in float64 on the CPU, and the
benchmark's inputs against the port's own generators."""

import numpy as np
import pytest
import torch

from harness import check, inputs, reference, refboundary, reftopo
from harness.cells import Cell
from conftest import CONFIGS, TC1_BOXES, cell_with_mix
from harness.program import Program

#: (cell, traffic mix[, configuration]): the internal smoother's path,
#: and the layer path (layers without boundary smoothing) on the block's
#: top and on the prism mesh's hole walls
CASES = [("hex128.default", None), ("hex128.default", "stress"),
         ("hex128_top.boundary", "layers_top"),
         ("hex128_top.boundary", "layers_def", "prism")]


def small_config(c):
    if "mesh" in c.config:
        return c.config
    return dict(c.config, cells_per_side=6)


def assert_follows_step_by_step(sm, T, B, p, h, steps):
    """The port's ``steps(1)``, one at a time, among the boundary
    reference's candidates from the port's own points and normals, and
    its normals equal to the reference's, at the start and after each
    iteration (float64)."""
    normals = sm.to_external_point_field(sm.normals.numpy())
    assert np.abs(normals - B["normals_init"].numpy()).max() < 1e-12
    for _ in range(steps):
        x = torch.as_tensor(sm.denormalize())
        cands, revert, n_ref = refboundary.iteration(
            x, torch.as_tensor(normals), T, B, p)
        sm.steps(1)
        after = torch.as_tensor(sm.denormalize())
        normals = sm.to_external_point_field(sm.normals.numpy())
        gap = torch.where(revert, reference.norm(after - x),
                          reference.norm(cands - after).amin(0)) / h
        assert float(gap.max()) < 1e-9
        assert np.abs(normals - n_ref.numpy()).max() < 1e-12
        assert bool((~revert).any())


@pytest.mark.parametrize("case", CASES,
                         ids=lambda case: "-".join(map(str, case)))
def test_reference_agrees_with_the_port_in_float64(case):
    c = cell_with_mix(*case)
    cfg = small_config(c)
    if inputs.path(c.mix) == "layers":
        # the port as a run drives it, the configuration in float64
        prog = Program(dict(cfg, dtype="float64"), c.mix, 17, "cpu")
        prog.setup()
        T = reftopo.build(prog.mesh, "cpu")
        h = reference.min_edge_length(torch.as_tensor(prog.mesh["points"]),
                                      T)
        p = reference.resolve(c.mix["params"], h)
        B = refboundary.setup(prog.mesh, T, p, None, "cpu")
        assert "smoothing" not in B and bool(B["layer"].any())
        assert_follows_step_by_step(prog.sm, T, B, p, h, 8)
        # the layer path's judge holds it with no point off
        segs, _ = check.read_program(prog, c.mix, 24, 17)
        cmp = check.judge(prog.mesh, cfg, c.mix, segs, T, "cpu")
        assert cmp["points_off"] == 0 and cmp["normals_gap"] < 1e-12
        assert sum(len(s["steps"]) for s in segs) == 24
        return
    prog = Program(cfg, c.mix, 17, "cpu")
    from smoothmesh_torch.driver import Smoother

    sm = Smoother(prog.polymesh(), prog.params(), device="cpu",
                  dtype=torch.float64)
    x0 = sm.denormalize()
    sm.steps(8)
    T = reftopo.build(prog.mesh, "cpu")
    h = reference.min_edge_length(torch.as_tensor(prog.mesh["points"]), T)
    p = reference.resolve(c.mix["params"], h)
    ref, res = check.follow(x0, T, p, 8, torch.float64, "cpu")
    assert len(res) == 8
    gap = check.gaps(sm.denormalize(), ref, h)
    assert gap.max() < 1e-9
    assert (gap > 0).any() or np.abs(ref - x0).max() > 0


def test_boundary_reference_agrees_with_the_port_in_float64():
    from smoothmesh_torch.driver import Smoother

    c = Cell("hex128_top.boundary")
    prog = Program(dict(c.config, cells_per_side=6), c.mix, 19, "cpu")
    sm = Smoother(prog.polymesh(), prog.params(), device="cpu",
                  dtype=torch.float64)
    sm.enable_boundary_smoothing(*inputs.dome(**c.config["target"]["dome"]))
    T = reftopo.build(prog.mesh, "cpu")
    h = reference.min_edge_length(torch.as_tensor(prog.mesh["points"]), T)
    p = reference.resolve(c.mix["params"], h)
    B = refboundary.setup(prog.mesh, T, p,
                          inputs.dome(**c.config["target"]["dome"]), "cpu")
    assert_follows_step_by_step(sm, T, B, p, h, 4)


def test_inputs_match_the_ports_generators():
    from smoothmesh_torch.mesh.blockmesh import hex_block
    from smoothmesh_torch.testcases import TOP_PATCHES, bench_dome_geometry

    ours = inputs.hex_block((5, 4, 3), (2.0, 1.0, 0.5), TOP_PATCHES)
    theirs = hex_block(n=(5, 4, 3), grading=(2.0, 1.0, 0.5),
                       patches=TOP_PATCHES)
    np.testing.assert_array_equal(ours["points"], theirs.points)
    for k in ("face_flat", "face_offsets", "owner", "neighbour"):
        np.testing.assert_array_equal(ours[k], getattr(theirs, k))
    assert ours["patches"] == [(p.name, p.n_faces, p.start_face)
                               for p in theirs.patches]
    for a, b in zip(inputs.dome(0.1, 64, 33), bench_dome_geometry()[1:]):
        np.testing.assert_array_equal(a, b)


def test_perturbation_is_drawn_from_the_seed():
    cfg = {"cells_per_side": 4, "grading": [1, 1, 1],
           "patches": {"w": list(inputs.SIDES)}}
    mix = {"perturbation": 0.25}
    a = inputs.make_mesh(cfg, mix, 2 ** 31 + 5)["points"]
    b = inputs.make_mesh(cfg, mix, 2 ** 31 + 5)["points"]
    c = inputs.make_mesh(cfg, mix, 2 ** 31 + 6)["points"]
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    bnd = inputs.boundary_points(inputs.make_mesh(cfg, mix, 1))
    base = inputs.hex_block((4, 4, 4), (1, 1, 1), {"w": list(inputs.SIDES)})
    assert np.array_equal(a[bnd], base["points"][bnd])


@pytest.mark.parametrize("seed", [2 ** 31 + 7, 3])
@pytest.mark.parametrize("cell", ["hex128.default", "hex128_top.boundary"])
def test_make_mesh_is_the_hex_block_as_before(cell, seed):
    """A configuration without ``mesh`` gives the arrays that the hex
    block and the perturbation gave when ``make_mesh`` called them
    itself."""
    c = Cell(cell)
    cfg = dict(c.config, cells_per_side=5)
    base = inputs.hex_block((5, 5, 5), cfg["grading"], cfg["patches"])
    want = inputs.perturb(
        base, float(c.mix["perturbation"]) * inputs.min_spacing(base), seed)
    got = inputs.make_mesh(cfg, c.mix, seed)
    assert got.keys() == want.keys()
    for k in ("points", "face_flat", "face_offsets", "owner", "neighbour"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["patches"] == want["patches"]


def test_prism_recipe_matches_the_ports_extrusion():
    from smoothmesh_torch.mesh.extrude import extrude_triangulation

    cfg = CONFIGS["prism"]
    rec = inputs.recipe(cfg)
    verts, tris = rec.triangulation(cfg)
    assert len(verts) == 9 * 9 - 1          # the hole's inner vertex
    ours = rec.build(cfg)
    theirs = extrude_triangulation(
        verts, tris, direction=cfg["direction"],
        thickness=cfg["thickness"], n_layers=cfg["layers"],
        patch_boxes=[(n, tuple(lo), tuple(hi)) for n, lo, hi in TC1_BOXES])
    for k in ("points", "face_flat", "face_offsets", "owner", "neighbour"):
        np.testing.assert_array_equal(ours[k], getattr(theirs, k))
    assert ours["patches"] == [(p.name, p.n_faces, p.start_face)
                               for p in theirs.patches]
    assert ours["patches"][-1][0] == "defaultFaces"     # the hole's walls
    assert rec.spacing(ours) == pytest.approx(
        reference.min_edge_length(torch.as_tensor(ours["points"]),
                                  reftopo.build(ours, "cpu")), rel=1e-12)


@pytest.mark.parametrize("holes", [[], [[3, 3, 5, 5]], [[0, 3, 2, 5]]],
                         ids=["none", "inside", "at_the_border"])
def test_prism_cells_are_closed_outward_and_positive(holes):
    cfg = dict(CONFIGS["prism"], holes=holes)
    mesh = inputs.recipe(cfg).build(cfg)
    T = reftopo.build(mesh, "cpu")         # raises unless each cell edge
    x = torch.as_tensor(mesh["points"])    # is held by two of its faces
    fc, fa, _ = reference.face_geometry(x, T)
    cf, m = T["cell_faces"].clamp_min(0), T["cf_mask"]
    assert bool((m.sum(1) == 5).all())
    sign = (T["cell_sign"] * m).to(x.dtype)[..., None]
    closed = (sign * fa[cf]).sum(1)
    assert float(reference.norm(closed).max()) < 1e-12 * float(
        reference.norm(fa).max())
    vol = (sign[..., 0] * reference.dot(fc[cf], fa[cf])).sum(1) / 3.0
    assert bool((vol > 0).all())
    cc = reference.cell_centres(fc, fa, T)
    own, nei = T["owner"], T["neighbour"]
    assert bool((reference.dot(fa, fc - cc[own]) > 0).all())
    inner = nei >= 0
    assert bool((reference.dot(fa[inner], cc[nei[inner]] - fc[inner])
                 > 0).all())
    heights = np.unique(np.round(mesh["points"][:, 1], 12))
    np.testing.assert_allclose(np.diff(heights),
                               cfg["thickness"] / cfg["layers"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_config_dtype_reaches_the_smoother(dtype):
    c = Cell("hex128.default")
    prog = Program(dict(c.config, cells_per_side=3, dtype=dtype), c.mix, 5,
                   "cpu")
    prog.setup()
    assert prog.sm.dtype == getattr(torch, dtype)
    assert prog.sm.points.dtype == getattr(torch, dtype)
