"""``run.py`` as a check starts it: it fails, and prints no result,
without a card; on a card a short run of the default cell is correct."""

import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH


def start(*args, env=None):
    return subprocess.run(
        [sys.executable, str(BENCH / "run.py"), *args],
        capture_output=True, text=True, cwd=BENCH.parent, timeout=600,
        env=env)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = start("--workload", "hex128.default", "--seed", "1",
                "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_unknown_workload_fails():
    out = start("--workload", "nope", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.chip
def test_default_cell_on_the_card(card):
    out = start("--workload", "hex128.default", "--seed", "3",
                "--seconds", "2", "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
