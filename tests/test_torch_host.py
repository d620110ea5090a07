"""The PyTorch port's host side against the JAX package's: mesh
generators, spatial reordering, topology compiler, device staging,
mesh stats and parameter resolution — array-equal on a hex and a prism
mesh.  Also: importing the port loads no JAX, and its entry points
refuse to run without a CUDA device unless the caller asks for the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smoothmesh_tpu.device import FA_PACKED_KEYS
from smoothmesh_tpu.device import to_device as jax_to_device
from smoothmesh_tpu.mesh import blockmesh as jbm
from smoothmesh_tpu.mesh.tiling import permute_mesh as jax_permute
from smoothmesh_tpu.mesh.topology import compile_topology as jax_compile
from smoothmesh_tpu.params import SmoothingParams as JaxParams
from smoothmesh_tpu.quality import mesh_stats as jax_mesh_stats
from smoothmesh_torch.device import to_device
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh import blockmesh as tbm
from smoothmesh_torch.mesh.tiling import permute_mesh
from smoothmesh_torch.mesh.topology import compile_topology
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.quality import mesh_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meshes(bm):
    return {
        "hex": bm.perturb(bm.hex_block(n=(14, 12, 10)), 0.05, seed=5),
        "prism": bm.perturb(bm.prism_block(n=(8, 8, 6)), 0.04, seed=6),
    }


JAX_MESHES = _meshes(jbm)
TORCH_MESHES = _meshes(tbm)
KINDS = ["hex", "prism"]


def _assert_mesh_equal(a, b):
    for f in ("points", "face_flat", "face_offsets", "owner", "neighbour"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [dataclasses.astuple(p) for p in a.patches] == \
        [dataclasses.astuple(p) for p in b.patches]


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("kind", KINDS)
def test_generators_match(kind):
    _assert_mesh_equal(TORCH_MESHES[kind], JAX_MESHES[kind])


def test_graded_axis_coords_match():
    for g in (2.0, 0.5, [(0.2, 0.3, 4.0), (0.6, 0.4, 1.0), (0.2, 0.3, 0.25)]):
        np.testing.assert_array_equal(tbm._axis_coords(17, g),
                                      jbm._axis_coords(17, g))


@pytest.mark.parametrize("kind", KINDS)
def test_permute_mesh_matches(kind):
    tm, to = permute_mesh(TORCH_MESHES[kind])
    jm, jo = jax_permute(JAX_MESHES[kind])
    _assert_mesh_equal(tm, jm)
    _assert_fields_equal(to, jo)


@pytest.mark.parametrize("kind", KINDS)
def test_compile_topology_matches(kind):
    tm, _ = permute_mesh(TORCH_MESHES[kind])
    jm, _ = jax_permute(JAX_MESHES[kind])
    _assert_fields_equal(compile_topology(tm),
                         jax_compile(jm, use_native=False))


@pytest.mark.parametrize("kind", KINDS)
def test_to_device_matches(kind):
    topo = compile_topology(TORCH_MESHES[kind])
    td = to_device(topo, "cpu")
    want = jax_to_device(jax_compile(JAX_MESHES[kind], use_native=False))
    # the port stages the two packed tables its fixed point reads
    assert set(td) == set(want) - (FA_PACKED_KEYS
                                   - {"pps_signed", "pe_flat"})
    for k, v in td.items():
        w = np.asarray(want[k])
        assert v.dtype == (torch.bool if w.dtype == np.bool_
                           else torch.int32), k
        assert tuple(v.shape) == w.shape, k
        np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    sub = to_device(topo, "cpu", keys=["point_points", "face_mask"])
    assert set(sub) == {"point_points", "face_mask"}


@pytest.mark.parametrize("kind", KINDS)
def test_mesh_stats_and_resolve_match(kind):
    topo = compile_topology(TORCH_MESHES[kind])
    mesh = TORCH_MESHES[kind]
    st = mesh_stats(mesh.points, topo.edges)
    sj = jax_mesh_stats(mesh.points, topo.edges)
    assert dataclasses.astuple(st) == dataclasses.astuple(sj)
    for kw in ({}, {"min_edge_length": 0.01, "centroidal_iters": 7},
               {"max_step_length": 0.002, "layer_edge_length": 0.3}):
        pt = SmoothingParams(**kw).resolve(st.min_edge_length)
        pj = JaxParams(**kw).resolve(sj.min_edge_length)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
        assert pt.min_angle_rad == pj.min_angle_rad


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import smoothmesh_torch, smoothmesh_torch.driver, "
        "smoothmesh_torch.convert, smoothmesh_torch.io, "
        "smoothmesh_torch.mesh, smoothmesh_torch.ops, "
        "smoothmesh_torch.kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'smoothmesh_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_smoother_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = SmoothingParams(face_angle_constraint=False)
    mesh = tbm.hex_block(n=(3, 3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        Smoother(mesh, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        to_device(compile_topology(mesh))
    Smoother(mesh, params, device="cpu")


def test_wrappers_refuse_other_devices():
    from smoothmesh_torch import geometry as geo

    pts = torch.zeros((4, 3), device="meta")
    fp = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        geo.face_centres_areas(pts, fp, fp.bool(), fp[:, 0])
