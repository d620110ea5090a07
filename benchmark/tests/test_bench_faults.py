"""Runs on the CPU at a small size, with the chip check skipped and the
timed path broken underneath: each fault has to turn ``correct`` false,
and the control (the reference in bfloat16 in the program's place) has
to fail the limit."""

import pytest
import torch

import calibrate
import run
from conftest import cell_with_mix

SIDE = 6
#: (cell, traffic mix or None[, configuration]): the layer path (layers
#: without boundary smoothing) on the block's top and on the prism
#: mesh's hole walls
CELLS = [("hex128.default", None), ("hex128_top.boundary", None),
         ("hex128.default", "stress"), ("hex128_top.boundary", "layers_top"),
         ("hex128_top.boundary", "layers_def", "prism")]
LAYER_CELLS = [CELLS[1], CELLS[3], CELLS[4]]


def small(cell):
    """The cell (:data:`CELLS`) with jobs of at most 48 iterations, a
    hex block cut to SIDE cells a side (a recipe's mesh as its test
    configuration has it)."""
    c = cell_with_mix(*cell)
    job = dict(c.mix["job"], iterations=min(48, c.mix["job"]["iterations"]))
    c.mix = dict(c.mix, job=job)
    if "mesh" in c.config:
        return c, c.config
    return c, dict(c.config, cells_per_side=SIDE)


def unchanged(real):
    """A step that returns its state unchanged."""
    def body(points, *a, **kw):
        return real(points, *a, **kw)._replace(points=points)
    return body


def half_left_out(real):
    """Half of the points' updates left out."""
    def body(points, *a, **kw):
        it = real(points, *a, **kw)
        keep = torch.arange(points.shape[0]) % 2 == 0
        return it._replace(points=torch.where(keep[:, None], it.points,
                                              points))
    return body


def altered(real):
    """The answer altered where it is produced: each new position moved
    along x by a tenth of the minimum edge length (1 in the program's
    coordinates)."""
    def body(points, *a, **kw):
        it = real(points, *a, **kw)
        moved = (it.points != points).any(1, keepdim=True)
        shift = torch.tensor([0.1, 0.0, 0.0], dtype=points.dtype)
        return it._replace(points=it.points + moved * shift)
    return body


def one_point_altered(where):
    """One point of the boundary path moved along x by a tenth of the
    minimum edge length in each iteration: on the smoothing patch (as a
    wrong ray hit or projection would) or among the points the layer
    blend moves."""
    def fault(real):
        def body(points, td, *a, **kw):
            it = real(points, td, *a, **kw)
            if where == "surface":
                on = kw["smoothing_surface"]
            else:
                h = kw["layer"]["hops_layer"]
                on = (h >= 1) & (h <= 2) & td["is_internal_point"]
            idx = torch.nonzero(on & (it.points != points).any(1))[:1, 0]
            shift = torch.zeros_like(points)
            shift[idx, 0] = 0.1
            return it._replace(points=it.points + shift)
        return body
    return fault


@pytest.mark.parametrize("cell", CELLS, ids=str)
def test_sound_run_is_correct(cell):
    c, cfg = small(cell)
    result, _ = run.measure(c, 2 ** 31 + 11, 0.2, False, "cpu", cfg)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", CELLS, ids=str)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from smoothmesh_torch import driver

    monkeypatch.setattr(driver, "iteration_body",
                        fault(driver.iteration_body))
    c, cfg = small(cell)
    result, _ = run.measure(c, 2 ** 31 + 12, 0.2, False, "cpu", cfg)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("raising", ["every", "first"])
def test_failed_job_is_not_correct(raising, monkeypatch):
    """A job of the window that raises fails the run: the first alone,
    with later jobs and the check run as usual, or every job, with
    nothing left to compare."""
    from harness.program import Program

    real, jobs = Program.job, []

    def job(self, iterations=None):
        if iterations is None:          # a whole job, as the window runs
            jobs.append(1)
            if raising == "every" or len(jobs) == 1:
                raise RuntimeError("planted")
        return real(self, iterations)

    monkeypatch.setattr(Program, "job", job)
    c, cfg = small(CELLS[0])
    result, _ = run.measure(c, 2 ** 31 + 14, 0.2, False, "cpu", cfg)
    assert result["failed"] > 0
    assert result["checks"]["failed_jobs"]["value"] == result["failed"]
    compared = result["checks"]["points_off_ppm"]["value"]
    assert (compared is None) == (raising == "every")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("where", ["surface", "layer"])
def test_boundary_path_fault_fails_its_number(where, monkeypatch):
    """A fault in one point a step of the boundary path alone fails the
    number over that path's points."""
    from smoothmesh_torch import driver

    monkeypatch.setattr(driver, "iteration_body",
                        one_point_altered(where)(driver.iteration_body))
    c, cfg = small(CELLS[1])
    result, _ = run.measure(c, 2 ** 31 + 15, 0.2, False, "cpu", cfg)
    number = result["checks"][f"{where}_points_off_ppm"]
    assert number["value"] > number["limit"], result["checks"]
    assert not result["correct"]


def blend_left_out(points, prop, *a, **kw):
    """The layer blend returns the predictor's proposal."""
    return prop


def blend_halved(real):
    """The layer blend with half the blending fraction."""
    def blend(points, prop, td, hops, normals, outer, frac, *a, **kw):
        return real(points, prop, td, hops, normals, outer, 0.5 * frac,
                    *a, **kw)
    return blend


@pytest.mark.parametrize("fault", ["left_out", "halved"])
@pytest.mark.parametrize("cell", LAYER_CELLS, ids=str)
def test_layer_blend_fault_fails_its_number(cell, fault, monkeypatch):
    """The program's layer blend broken: the number over the points the
    blend moves fails, with and without boundary smoothing."""
    from smoothmesh_torch import layers

    real = layers.blend_with_orthogonal_points
    monkeypatch.setattr(layers, "blend_with_orthogonal_points",
                        blend_left_out if fault == "left_out"
                        else blend_halved(real))
    c, cfg = small(cell)
    result, _ = run.measure(c, 2 ** 31 + 16, 0.2, False, "cpu", cfg)
    number = result["checks"]["layer_points_off_ppm"]
    assert number["value"] > number["limit"], result["checks"]
    assert not result["correct"]


@pytest.mark.parametrize("cell", CELLS, ids=str)
def test_control_fails_the_limit(cell):
    c, cfg = small(cell)
    r = calibrate.readings(c, 2 ** 31 + 13, True, "cpu", cfg)
    limit = c.mix["check"]["limits"]["points_off_ppm"]
    assert r["program"]["points_off_ppm"] <= limit
    assert r["control"]["points_off_ppm"] > limit
