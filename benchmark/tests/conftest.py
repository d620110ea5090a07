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


def cell_with_mix(cell: str, traffic: str = None):
    """A cell of ``BENCHMARK.json``, optionally with another traffic mix
    of ``benchmark/traffic`` (a mix no cell runs yet, such as
    ``stress``)."""
    import json

    from harness.cells import Cell

    c = Cell(cell)
    if traffic is not None:
        c.mix = json.loads((BENCH / "traffic" / f"{traffic}.json")
                           .read_text())
    return c
