"""The smoother's spans and counters (smoothmesh_torch.tracing), on the
CPU.

- ``Trace``: counts, totals and longest instances aggregate; a span's
  parent is the span open around it; ``merge`` hands spans over.
- Set-up spans: the ``Smoother``'s parts and the boundary set-up's
  exist once each, none inside another, and their sum stays within the
  wall of the call; the decompositions' ``setup_times`` keep their keys,
  read from ``setup.shard_build`` (with the compiles inside it),
  ``setup.union`` and ``setup.upload``.
- ``host_reads``: one a batch, ``ceil(n / iter_batch)`` for ``steps(n)``
  with no stop; one an iteration one a dispatch, and the face-angle
  fixed point's read beside it.
- ``StepResult.wall_ms``: the batch's reset, replays and read over its
  iterations; a batch built inside ``steps`` is its own span.
- ``time_stages(True)``: points, normals and StepResults bit-equal to
  ``time_stages(False)``, each stage the configuration runs timed once
  a batch, another batch key.

(That the spans are ``smoothmesh::`` ranges of a profiler's trace is
``tests/test_torch_cli.py``'s, on the CLI's ``-profileDir`` trace.)
"""

import dataclasses
import math
import time

import pytest
import torch

from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.parallel.halo import HaloSmoother
from smoothmesh_torch.parallel.sharded import ShardedSmoother
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.tracing import StageClock, Trace

torch.set_num_threads(1)

DEFAULT_STAGES = {"iter.geometry", "iter.predictor", "iter.freeze",
                  "iter.face_angle", "iter.commit"}
BOUNDARY_STAGES = DEFAULT_STAGES | {"iter.normals", "iter.layer_blend",
                                    "iter.boundary_projection"}
SMOOTHER_SETUP = ("setup.reorder", "setup.topology", "setup.stats",
                  "setup.upload", "setup.layer_maps")
BOUNDARY_SETUP = ("setup.boundary.classify", "setup.boundary.tables")


def _hex(**kw):
    return (perturb(hex_block(n=(6, 6, 6)), amplitude=0.05, seed=3),
            SmoothingParams(centroidal_iters=10, rel_tol=0.0, **kw))


def _tc5():
    tc = ttc.tc5()
    return tc.mesh, dataclasses.replace(
        tc.params, centroidal_iters=8, rel_tol=0.0,
        max_step_length=0.25), tc.geometry


def _smoother(mesh, params, batch=4, geometry=None):
    sm = Smoother(mesh, params, device="cpu", dtype=torch.float64)
    if geometry is not None:
        sm.enable_boundary_smoothing(*geometry)
    sm.iter_batch = batch
    return sm


def test_trace_aggregates_nests_and_merges():
    tr = Trace()
    with tr.span("outer"):
        for _ in range(3):
            with tr.span("inner") as s:
                pass
            assert s.end_ns >= s.start_ns
    tr.add("inner", 5.0)
    tr.count("reads")
    tr.count("reads", 2)
    assert tr.spans["outer"].count == 1 and tr.spans["outer"].parent is None
    inner = tr.spans["inner"]
    assert (inner.count, inner.parent, inner.max_s) == (4, "outer", 5.0)
    assert tr.total("inner") >= 5.0 and tr.total("absent") == 0.0
    assert tr.counters == {"reads": 3}
    other = Trace()
    other.add("x", 2.0)
    other.add("x", 3.0)
    other.count("reads", 4)
    tr.merge(other, parent="outer")
    x = tr.spans["x"]
    assert (x.count, x.total_s, x.max_s, x.parent) == (2, 5.0, 3.0, "outer")
    assert tr.counters["reads"] == 7


def test_stage_clock_on_the_host():
    clock = StageClock(torch.device("cpu"))
    for _ in range(2):
        clock.start()
        clock.mark("a")
        clock.mark("b")
        clock.mark("a")
    got = clock.read()
    assert set(got) == {"a", "b"} and min(got.values()) >= 0.0
    clock.start()
    with pytest.raises(RuntimeError, match="stage 'b'"):
        clock.mark("b")


def test_setup_spans_exist_and_fit_the_wall():
    mesh, params, geometry = _tc5()
    t0 = time.perf_counter()
    sm = Smoother(mesh, params, device="cpu", dtype=torch.float64)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    sm.enable_boundary_smoothing(*geometry)
    boundary_wall = time.perf_counter() - t0
    spans = sm.trace.spans
    for name in SMOOTHER_SETUP + BOUNDARY_SETUP:
        assert spans[name].count == 1, name
        assert spans[name].parent is None, name
    assert sum(spans[n].total_s for n in SMOOTHER_SETUP) <= wall
    assert sum(spans[n].total_s for n in BOUNDARY_SETUP) <= boundary_wall
    assert "setup.capture" not in spans
    assert sm.prepare_batch() == spans["setup.capture"].total_s > 0.0
    assert sm.prepare_batch() == 0.0        # built already
    assert spans["setup.capture"].count == 1


@pytest.mark.parametrize("cls", [HaloSmoother, ShardedSmoother])
def test_decomposition_setup_times_read_the_trace(cls):
    mesh, params = _hex()
    sm = cls(mesh, params, n_shards=2, device="cpu", dtype=torch.float64)
    times = sm.setup_times
    assert list(times) == ["compiles", "shard build", "union", "upload"]
    spans = sm.trace.spans
    assert spans["setup.compiles"].count == 2
    assert spans["setup.compiles"].parent == "setup.shard_build"
    assert 0.0 < times["compiles"] <= times["shard build"]
    assert times["union"] > 0.0 and times["upload"] > 0.0
    assert times["upload"] == spans["setup.upload"].total_s


def test_host_reads_one_a_batch():
    mesh, params = _hex()
    sm = _smoother(mesh, params, batch=4)
    for n in (10, 4, 1):
        before = sm.trace.counters.get("host_reads", 0)
        assert len(sm.steps(n)) == n
        assert sm.trace.counters["host_reads"] - before == math.ceil(n / 4)
    assert sm.face_angle_stops == 0
    assert sm.trace.spans["batch.read"].count == 5


@pytest.mark.parametrize("face_angle", [False, True])
def test_host_reads_one_by_one(face_angle):
    mesh, params = _hex(face_angle_constraint=face_angle)
    sm = _smoother(mesh, params, batch=1)
    sm.steps(5)
    # the fixed point reads its band once where no point is in it
    assert sm.trace.counters["host_reads"] == 5 * (2 if face_angle else 1)
    assert sm.trace.spans["batch.read"].count == 5
    assert "batch.reset" not in sm.trace.spans


def test_wall_ms_is_dispatch_to_read():
    mesh, params = _hex()
    sm = _smoother(mesh, params, batch=4)
    t0 = time.perf_counter()
    got = sm.steps(10)                  # the batch is built in here
    outer = time.perf_counter() - t0
    spans = sm.trace.spans
    assert spans["setup.capture"].count == 1
    walls = sum(r.wall_ms for r in got) * 1e-3
    parts = sum(spans[n].total_s for n in ("batch.reset", "batch.replay",
                                           "batch.read"))
    assert parts <= walls <= outer - spans["setup.capture"].total_s
    # one batch's iterations share its wall
    assert got[0].wall_ms == got[3].wall_ms
    assert spans["batch.commit"].count == 3


def _results(rs):
    return [dataclasses.replace(r, wall_ms=0.0) for r in rs]


@pytest.mark.parametrize("case", ["hex", "tc5"])
def test_time_stages_leaves_the_results_bit_equal(case):
    if case == "hex":
        (mesh, params), geometry = _hex(), None
        want_stages = DEFAULT_STAGES
    else:
        mesh, params, geometry = _tc5()
        want_stages = BOUNDARY_STAGES
    off = _smoother(mesh, params, geometry=geometry)
    on = _smoother(mesh, params, geometry=geometry)
    on.steps(1)
    key_off = on._batch.key
    on.time_stages(True)
    off.steps(1)
    want, got = off.steps(6), on.steps(6)
    assert on._batch.key != key_off
    assert on.trace.spans["setup.capture"].count == 2
    assert _results(got) == _results(want)
    assert torch.equal(on.points, off.points)
    assert torch.equal(on.normals, off.normals)
    stages = {n: s for n, s in on.trace.spans.items()
              if n.startswith("iter.")}
    assert set(stages) == want_stages
    assert all(s.count == 2 for s in stages.values())   # a batch each
    assert not any(n.startswith("iter.") for n in off.trace.spans)
    # one a dispatch: a sample an iteration
    on.iter_batch = 1
    on.steps(2)
    assert all(on.trace.spans[n].count == 4 for n in want_stages)
    on.time_stages(False)
    on.iter_batch = 4
    on.steps(2)
    assert all(on.trace.spans[n].count == 4 for n in want_stages)
