"""The port's checkMesh-style report against the JAX package's, and the
testcases validated with it.

- ``quality_report`` / ``check_mesh`` (CPU, float64) against the JAX
  functions (float64) on the same points: tc1 (prisms from extrusion),
  tc6 (split baffles) and a perturbed hex block.  Integer keys and
  ``ok`` equal, float keys to 1e-10 relative; the cell openness, a
  cancellation residue of order 1e-16 on closed cells, to 1e-14
  absolute.  The JAX ``quality_report_parts`` runs under one
  ``jax.jit`` (its ``float``/``int`` conversions deferred to the
  caller), which builds in ~1.3 s here where op by op it takes ~11 s;
  ``check_mesh`` then folds those parts as it always does.
- claimed parts folded with ``combine_quality_parts`` equal the
  unclaimed report;
- ``Smoother.quality()`` (normalized coordinates, scaled back) against
  ``quality_report`` on the denormalized points of tc8 (1e-8 scale);
- the port's runs of the testcases under the criteria of
  ``tests/test_testcases.py``, with the port's ``check_mesh`` as the
  oracle (tc8 with its restart leg).
"""

import builtins
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smoothmesh_tpu import quality as jq
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.mesh.topology import compile_topology as jax_compile
from smoothmesh_torch import quality as tq
from smoothmesh_torch import testcases as tcs
from smoothmesh_torch.device import to_device
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.mesh.topology import compile_topology

torch.set_num_threads(1)

INT_KEYS = ("n_negative_volumes",)
#: absolute tolerance of the cell openness (a cancellation residue)
OPENNESS_ATOL = 1e-14

MESHES = {
    "tc1": lambda: tcs.tc1().mesh,
    "tc6": lambda: tcs.tc6().mesh,
    "hex": lambda: perturb(hex_block(n=(6, 5, 4), grading=(2.0, 1.0, 0.5)),
                           0.05, seed=1),
}


def _assert_reports_match(got, want, rtol, openness_atol=OPENNESS_ATOL):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (bool, int)) or k in INT_KEYS:
            assert g == w and type(g) is type(w), (k, g, w)
        elif k == "max_cell_openness":
            assert abs(g - w) <= openness_atol, (k, g, w)
        else:
            assert abs(g - w) <= rtol * abs(w), (k, g, w)


def _jax_check_mesh(points, jtd):
    """The JAX ``check_mesh``, its parts computed under one jit."""
    with pytest.MonkeyPatch.context() as mp:
        # defer the host conversions so that the parts trace
        mp.setattr(jq, "float", lambda v: v, raising=False)
        mp.setattr(jq, "int", lambda v: v, raising=False)
        parts = jax.jit(jq.quality_report_parts)(points, jtd)
    parts = {k: (builtins.int if k in ("n_internal_faces",
                                       "n_negative_volumes")
                 else builtins.float)(v) for k, v in parts.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "quality_report_parts", lambda p, td: parts)
        return jq.check_mesh(points, jtd)


@functools.lru_cache(maxsize=None)
def _mesh_and_tds(name):
    mesh = MESHES[name]()
    return (mesh, to_device(compile_topology(mesh), "cpu"),
            jax_to_device(jax_compile(mesh, use_native=False)))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_check_mesh_matches_jax_f64(name):
    mesh, td, jtd = _mesh_and_tds(name)
    got = tq.check_mesh(torch.tensor(mesh.points), td)
    want = _jax_check_mesh(jnp.asarray(mesh.points), jtd)
    _assert_reports_match(got, want, 1e-10)
    assert got["ok"] and got["total_volume"] > 0
    # quality_report is check_mesh without the verdict
    rep = tq.quality_report(torch.tensor(mesh.points), td)
    assert rep == {k: v for k, v in got.items() if k != "ok"}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_claimed_parts_fold_to_the_report(name):
    mesh, td, _ = _mesh_and_tds(name)
    pts = torch.tensor(mesh.points)
    whole = tq.quality_report(pts, td)
    rng = np.random.default_rng(0)

    def halves(n):
        a = torch.from_numpy(rng.random(n) < 0.5)
        return a, ~a

    fa, ea, ca = (halves(td[k].shape[0])
                  for k in ("owner", "edges", "cell_faces"))
    parts = [tq.quality_report_parts(pts, td, f, e, c)
             for f, e, c in zip(fa, ea, ca)]
    assert parts[0]["n_internal_faces"] + parts[1]["n_internal_faces"] == \
        int(td["has_neighbour"].sum())
    _assert_reports_match(tq.combine_quality_parts(parts), whole, 1e-12)


def test_smoother_quality_matches_report_on_denormalized_points():
    tc = tcs.tc8()
    sm = Smoother(tc.mesh, tc.params, device="cpu", dtype=torch.float64)
    sm.steps(3)
    got = sm.quality()
    want = tq.quality_report(torch.tensor(sm.denormalize()),
                             to_device(compile_topology(tc.mesh), "cpu"))
    assert 1e-26 < want["min_volume"] < 1e-22      # the 1e-8 scale
    _assert_reports_match(got, want, 1e-8, openness_atol=1e-12)


def _run(tc, mesh=None):
    sm = Smoother(mesh or tc.mesh, tc.params, device="cpu")
    if tc.geometry is not None:
        sm.enable_boundary_smoothing(*tc.geometry)
    return sm, sm.run(log=None)


@pytest.mark.parametrize("name", sorted(tcs.ALL))
def test_case_runs_and_mesh_valid(name):
    """The criteria of tests/test_testcases.py:22-40 on the port's runs
    (float32 on the CPU)."""
    tc = tcs.ALL[name]()
    sm, res = _run(tc)
    td = to_device(sm.topo, "cpu")
    assert np.isfinite(res.residual)
    before = tq.check_mesh(torch.tensor(
        sm.transform(sm.mesh_internal.points)), td)
    rep = tq.check_mesh(sm.points, td)
    assert rep["n_negative_volumes"] == 0, (name, rep)
    assert rep["max_non_ortho_deg"] < tc.max_non_ortho, (name, rep)
    assert rep["max_skewness"] < 4.0, (name, rep)
    if tc.require_improvement:
        assert rep["avg_non_ortho_deg"] < before["avg_non_ortho_deg"], (
            name, before["avg_non_ortho_deg"], rep["avg_non_ortho_deg"])
    if tc.runs > 1:
        # restart path: rebuild on the smoothed mesh and run again
        mesh2 = tc.mesh
        mesh2.points = sm.denormalize()
        _, res2 = _run(tc, mesh2)
        assert np.isfinite(res2.residual)
        # second run starts closer to converged
        assert (res2.iteration <= res.iteration
                or res2.residual <= res.residual)
