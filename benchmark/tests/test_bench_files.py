"""Every file the harness finds by name parses and has the shape the
harness reads; nothing under benchmark/ imports JAX or the JAX
package."""

import ast
import json

import pytest
from conftest import BENCH

from harness import inputs
from harness.cells import Cell, load_module
from harness.program import DTYPES

ROOT = BENCH.parent
BENCH_JSON = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "smoothmesh_tpu"}


def test_benchmark_json_keys():
    assert set(BENCH_JSON) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert any(m["name"] == "setup_s" for m in BENCH_JSON["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH_JSON["workloads"]])
def test_cell_files_parse(cell):
    c = Cell(cell)
    if "mesh" in c.config:
        recipe = inputs.recipe(c.config)
        assert callable(recipe.build) and callable(recipe.spacing)
    else:
        assert c.config["cells_per_side"] > 0
    assert c.config["dtype"] in DTYPES
    for key in ("perturbation", "params", "job", "trace", "check"):
        assert key in c.mix
    assert set(c.mix["check"]["limits"]) <= {
        "points_off_ppm", "surface_points_off_ppm", "layer_points_off_ppm",
        "residual_gap", "normals_gap", "rerun_off"}
    names = [m["name"] for m in c.end_to_end() + c.per_layer()]
    for name in names:
        assert callable(Cell.reader(name).read)


@pytest.mark.parametrize("path", sorted((BENCH / "traffic").glob("*.json"))
                         + sorted((BENCH / "configs").glob("*.json")),
                         ids=lambda p: p.name)
def test_data_files_parse(path):
    assert isinstance(json.loads(path.read_text()), dict)


@pytest.mark.parametrize("path", sorted((BENCH / "stages").glob("*.py")),
                         ids=lambda p: p.name)
def test_stage_files_load(path):
    mod = load_module(path)
    assert isinstance(mod.KERNEL, str) and callable(mod.work)


@pytest.mark.parametrize("path", sorted((BENCH / "recipes").glob("*.py")),
                         ids=lambda p: p.name)
def test_recipe_files_load(path):
    mod = load_module(path)
    assert callable(mod.build) and callable(mod.spacing)


@pytest.mark.parametrize("path", sorted((BENCH / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_metric_files_load(path):
    assert callable(load_module(path).read)


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    """Whole top-level names: ``smoothmesh_torch`` begins with the JAX
    package's name and is allowed."""
    assert not set(imported_tops(path)) & FORBIDDEN
