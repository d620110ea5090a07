"""The benchmark's own tests: on the CPU at small sizes, and one on the
card (marked ``chip``, skipped where there is none).

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


#: upstream testcase1's patch boxes (system/topoSetDict), as the port's
#: ``testcases.tc1`` has them
TC1_BOXES = [["side_front", [-10, 0.74, -10], [10, 0.76, 10]],
             ["side_back", [-10, -0.76, -10], [10, -0.74, 10]],
             ["side_left", [-1.01, -10, -10], [-0.99, 10, 10]],
             ["side_right", [0.99, -10, -10], [1.01, 10, 10]],
             ["side_top", [-10, -10, 0.99], [10, 10, 1.01]],
             ["side_bottom", [-10, -10, -1.01], [10, 10, -0.99]]]

#: configurations no cell runs yet, at a test's size: a prism-layer mesh
#: (``recipes/prism_layers.py``, 9 x 9 vertices, one hole, 4 layers)
CONFIGS = {"prism": dict(
    mesh="prism_layers", k=9, square=[[-1.0, 1.0], [-1.0, 1.0]],
    base_y=-0.75, jitter=0.16, jitter_seed=11, holes=[[3, 3, 5, 5]],
    direction=[0.0, 1.0, 0.0], thickness=1.5, layers=4,
    patch_boxes=TC1_BOXES, dtype="float32")}


def layers_mix(patches: list) -> dict:
    """The boundary mix without boundary smoothing: layers on
    ``patches``, minAngle 15, the layer path's limits."""
    import json

    mix = json.loads((BENCH / "traffic" / "boundary.json").read_text())
    del mix["boundary_smoothing"]
    mix["params"] = {"layer_patches": patches, "min_angle": 15.0}
    del mix["check"]["limits"]["surface_points_off_ppm"]
    return mix


#: mixes no file of ``benchmark/traffic`` holds yet
MIXES = {"layers_top": lambda: layers_mix(["top"]),
         "layers_def": lambda: layers_mix(["def.*"])}


def cell_with_mix(cell: str, traffic: str = None, config: str = None):
    """A cell of ``BENCHMARK.json``, optionally with another traffic mix
    (of ``benchmark/traffic``, such as ``stress``, or of :data:`MIXES`)
    and another configuration (of :data:`CONFIGS`): a cell no
    ``BENCHMARK.json`` entry runs yet."""
    import json

    from harness.cells import Cell

    c = Cell(cell)
    if traffic in MIXES:
        c.mix = MIXES[traffic]()
    elif traffic is not None:
        c.mix = json.loads((BENCH / "traffic" / f"{traffic}.json")
                           .read_text())
    if config is not None:
        c.config = dict(CONFIGS[config])
    return c
