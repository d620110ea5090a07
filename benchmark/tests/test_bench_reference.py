"""The plain reference against the port in float64 on the CPU, and the
benchmark's inputs against the port's own generators."""

import numpy as np
import pytest
import torch

from harness import check, inputs, reference, reftopo
from harness.cells import Cell
from conftest import cell_with_mix
from harness.program import Program

#: (cell, traffic mix) pairs of the internal smoother's path
CASES = [("hex128.default", None), ("hex128.default", "stress")]


@pytest.mark.parametrize("cell,traffic", CASES)
def test_reference_agrees_with_the_port_in_float64(cell, traffic):
    c = cell_with_mix(cell, traffic)
    prog = Program(dict(c.config, cells_per_side=6), c.mix, 17, "cpu")
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
    from harness import refboundary
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
    normals = sm.to_external_point_field(sm.normals.numpy())
    assert np.abs(normals - B["normals_init"].numpy()).max() < 1e-12
    for _ in range(4):
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
