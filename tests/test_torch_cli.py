"""The port's command-line interface on a tiny case, on the CPU.

The case: a 6 x 6 x 4 hex block with a ``top`` patch (zmax) and the
``rest``, tc7's dome as ``constant/geometry/targetSurfaces.obj`` with
its border ring as ``initEdges.obj`` and the shrunk ring as
``targetEdges.obj``.  Checked:

- a run with ``-device cpu -dtype float64 -centroidalIters 5
  -writeInterval 2 -checkMesh -profileDir DIR`` exits 0, enables
  boundary smoothing, writes time directories 2, 4 and 5 with the
  classification checkpoints and a profiler trace of the set-up and
  the loop (the smoother's ``smoothmesh::`` spans in it), prints
  the quality report, and writes the points of the
  port's ``Smoother.run`` with the same parameters (to 1e-12; written
  in binary, so no digits are lost);
- the option names and defaults equal the JAX CLI's, apart from
  ``-device``;
- the printed lines up to the loop equal the JAX CLI's on the same case
  (both with ``-centroidalIters 0``, so neither smooths);
- ``-parallel`` runs the disjoint decomposition: in this process on the
  CPU (one shard, the plain CLI's points to 1e-12) and in 2 gloo ranks
  started as ``torchrun`` starts them (rank 0 writes
  ``ShardedSmoother(n_shards=2)``'s points, bit for bit);
- without ``-device`` a machine with no card raises; with a card a
  float64 run is accepted and stages the plain versions' tables (the
  kernels take float32 only, so float64 runs their plain versions on
  the card), and a dtype the CLI does not know is refused before
  anything reaches the card.
"""

import json
import os

import numpy as np
import pytest
import torch

from smoothmesh_tpu import cli as jax_cli
from smoothmesh_torch import cli, driver
from smoothmesh_torch import testcases as tcs
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.io.case import FoamCase
from smoothmesh_torch.io.obj import read_obj_edges, read_obj_surface
from smoothmesh_torch.io.polymesh import write_polymesh
from smoothmesh_torch.mesh.blockmesh import hex_block
from smoothmesh_torch.parallel.sharded import ShardedSmoother
from smoothmesh_torch.params import SmoothingParams

torch.set_num_threads(1)

#: options of the runs besides the case; boundary smoothing on ``top``
OPTS = ["-smoothingPatches", "top", "-minAngle", "15"]


def _write_obj(path, verts, tris=None, edges=None):
    with open(path, "w") as f:
        for v in verts:
            f.write("v %.17g %.17g %.17g\n" % tuple(v))
        for t in () if tris is None else tris:
            f.write("f %d %d %d\n" % tuple(np.asarray(t) + 1))
        for e in () if edges is None else edges:
            f.write("l %d %d\n" % tuple(np.asarray(e) + 1))


def _make_case(root):
    os.makedirs(os.path.join(root, "system"))
    with open(os.path.join(root, "system", "controlDict"), "w") as f:
        f.write("deltaT 1;\n")
    mesh = hex_block(n=(6, 6, 4), patches=tcs.TOP_PATCHES)
    write_polymesh(os.path.join(root, "constant", "polyMesh"), mesh)
    V, tris, bpts, bedges, tpts, tedges = tcs.tc7().geometry
    geo = os.path.join(root, "constant", "geometry")
    os.makedirs(geo)
    _write_obj(os.path.join(geo, "targetSurfaces.obj"), V, tris=tris)
    _write_obj(os.path.join(geo, "initEdges.obj"), bpts, edges=bedges)
    _write_obj(os.path.join(geo, "targetEdges.obj"), tpts, edges=tedges)
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The CLI's run on a fresh case -> (case dir, exit code, stdout)."""
    import contextlib
    import io

    base = tmp_path_factory.mktemp("cli")
    root = _make_case(str(base / "case"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["-case", root, "-device", "cpu", "-dtype", "float64",
                       "-centroidalIters", "5", "-writeInterval", "2",
                       "-checkMesh", "-writeFormat", "binary",
                       "-profileDir", str(base / "trace"), *OPTS])
    return root, rc, out.getvalue()


def test_cli_runs_writes_and_reports(run):
    root, rc, out = run
    assert rc == 0, out
    assert "Enabled boundary point smoothing" in out
    assert "Mesh quality report (checkMesh equivalent):" in out
    assert "    Mesh OK." in out and out.rstrip().endswith("End")
    case = FoamCase(root)
    assert case.time_dirs() == [2.0, 4.0, 5.0]
    n = case.read_mesh(0.0).n_points
    for t in ("2", "4", "5"):
        for name in ("isCornerPoint", "isFeatureEdgePoint"):
            ck = case.read_label_io_list(name, float(t), n)
            assert ck is not None and ck.any(), (t, name)
    for line in ("Writing new mesh to time 2", "Writing new mesh to time 4",
                 "Writing new mesh to time 5", "Smoothing iteration=5 "):
        assert line in out
    traces = os.listdir(os.path.join(os.path.dirname(root), "trace"))
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")


def test_cli_profile_holds_the_smoother_spans(run):
    root, rc, _ = run
    assert rc == 0
    where = os.path.join(os.path.dirname(root), "trace")
    with open(os.path.join(where, os.listdir(where)[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"smoothmesh::" + n for n in (
        "setup.reorder", "setup.topology", "setup.upload",
        "setup.boundary.classify", "setup.capture", "batch.reset",
        "batch.replay", "batch.read")} <= names


def test_cli_points_equal_smoother_run(run):
    root, rc, _ = run
    assert rc == 0
    case = FoamCase(root)
    geo = os.path.join(root, "constant", "geometry")
    sv, st = read_obj_surface(os.path.join(geo, "targetSurfaces.obj"))
    iv, ie = read_obj_edges(os.path.join(geo, "initEdges.obj"))
    tv, te = read_obj_edges(os.path.join(geo, "targetEdges.obj"))
    sm = Smoother(case.read_mesh(0.0), SmoothingParams(
        centroidal_iters=5, write_interval=2, smoothing_patches=("top",),
        min_angle=15.0), device="cpu", dtype=torch.float64)
    sm.enable_boundary_smoothing(sv, st, iv, ie, tv, te)
    written = {}
    sm.run(log=None, on_write=lambda i, pts: written.update({i: pts}))
    assert sorted(written) == [2, 4, 5]
    for i, pts in written.items():
        got = case.read_mesh(float(i)).points
        np.testing.assert_allclose(got, pts, rtol=0, atol=1e-12)
    assert np.abs(written[5] - case.read_mesh(0.0).points).max() > 1e-3


def test_parser_matches_jax():
    def options(ap):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                         getattr(a.type, "__name__", None), a.nargs,
                         type(a).__name__)
                for a in ap._actions if a.dest != "help"}

    got = options(cli.build_parser())
    want = options(jax_cli.build_parser())
    assert got.pop("device") == (("-device", "--device"), "cuda", None,
                                 None, None, "_StoreAction")
    assert got == want
    # the 19 reference options, 4 OpenFOAM flags and 5 of the JAX CLI
    assert len(want) == 28
    assert cli.parse_patch_list('( stator "rotor.*" )') == \
        jax_cli.parse_patch_list('( stator "rotor.*" )')


def _lines_before_loop(text):
    lines = text.splitlines()
    stop = next(i for i, s in enumerate(lines)
                if s.startswith(("ClockTime", "Performance")))
    return lines[:stop]


def test_printed_setup_matches_jax(tmp_path, capsys):
    root = _make_case(str(tmp_path / "case"))
    args = ["-case", root, "-centroidalIters", "0", *OPTS]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert cli.main(args + ["-device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert "Enabled boundary point smoothing" in got
    assert _lines_before_loop(got) == _lines_before_loop(want)
    assert FoamCase(root).time_dirs() == []      # no iteration, no write


PARALLEL_ITERS = 3


def _case_geometry(root):
    geo = os.path.join(root, "constant", "geometry")
    sv, st = read_obj_surface(os.path.join(geo, "targetSurfaces.obj"))
    iv, ie = read_obj_edges(os.path.join(geo, "initEdges.obj"))
    tv, te = read_obj_edges(os.path.join(geo, "targetEdges.obj"))
    return sv, st, iv, ie, tv, te


def test_parallel_runs_in_process(tmp_path, capsys):
    """-parallel on the CPU: one shard (the disjoint decomposition's
    ShardedSmoother), the same points as the plain CLI's to 1e-12."""
    roots = [_make_case(str(tmp_path / name)) for name in ("par", "one")]
    args = ["-device", "cpu", "-dtype", "float64", "-centroidalIters",
            str(PARALLEL_ITERS), "-writeFormat", "binary", "-checkMesh",
            *OPTS]
    assert cli.main(["-case", roots[0], "-parallel", *args]) == 0
    out = capsys.readouterr().out
    assert "Running sharded over 1 shards (one process on cpu)" in out
    assert "Enabled boundary point smoothing" in out and "Mesh OK." in out
    assert cli.main(["-case", roots[1], *args]) == 0
    got, want = (FoamCase(r).read_mesh(float(PARALLEL_ITERS)).points
                 for r in roots)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for name in ("isCornerPoint", "isFeatureEdgePoint"):
        a, b = (FoamCase(r).read_label_io_list(name, float(PARALLEL_ITERS),
                                               len(got)) for r in roots)
        np.testing.assert_array_equal(a, b)
    assert np.abs(got - FoamCase(roots[0]).read_mesh(0.0).points).max() > 1e-3


def test_parallel_runs_in_ranks(tmp_path):
    """-parallel in 2 gloo ranks (started as torchrun starts them, RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT in their environment): rank
    0 writes the points of ShardedSmoother(n_shards=2), bit for bit."""
    import socket
    import subprocess
    import sys

    root = _make_case(str(tmp_path / "case"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="2", OMP_NUM_THREADS="1", PYTHONPATH=repo)
    cmd = [sys.executable, "-m", "smoothmesh_torch.cli", "-case", root,
           "-parallel", "-device", "cpu", "-dtype", "float64",
           "-centroidalIters", str(PARALLEL_ITERS), "-writeFormat",
           "binary", *OPTS]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r)), cwd=repo,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "Running sharded over 2 shards (torch.distributed ranks, " \
        "gloo)" in outs[0]
    assert "Running sharded" not in outs[1]
    case = FoamCase(root)
    assert case.time_dirs() == [float(PARALLEL_ITERS)]
    ss = ShardedSmoother(case.read_mesh(0.0), SmoothingParams(
        centroidal_iters=PARALLEL_ITERS, smoothing_patches=("top",),
        min_angle=15.0), n_shards=2, device="cpu", dtype=torch.float64)
    ss.enable_boundary_smoothing(*_case_geometry(root))
    ss.steps(PARALLEL_ITERS)
    np.testing.assert_array_equal(
        case.read_mesh(float(PARALLEL_ITERS)).points, ss.denormalize())


def test_no_card_raises_and_float64_on_card_is_refused(tmp_path, capsys,
                                                       monkeypatch):
    root = _make_case(str(tmp_path / "case"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-case", root, "-centroidalIters", "1"])
    # with a card, float64 is accepted: the smoother stages the plain
    # versions' tables on it (stopped there, as no card is present)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    staged = []

    class Staged(Exception):
        pass

    def stage(topo, device=None, keys=None):
        staged.append((torch.device(device).type, frozenset(keys)))
        raise Staged

    monkeypatch.setattr(driver, "to_device", stage)
    with pytest.raises(Staged):
        cli.main(["-case", root, "-dtype", "float64",
                  "-centroidalIters", "1"])
    assert staged == [("cuda", driver.TD_KEYS)]
    # a dtype the card does not run is refused before anything reaches it
    rc = cli.main(["-case", root, "-dtype", "float16",
                   "-centroidalIters", "1"])
    assert rc != 0
    assert "float32" in capsys.readouterr().err
    assert FoamCase(root).time_dirs() == []
