"""The port's native topology compiler (``smoothmesh_torch.native``, its
own copy of the C++ builds in ``csrc/host/meshcompiler.cpp``) against
the JAX package's: ``compile_topology(mesh)`` array-equal to the JAX
``compile_topology(mesh, use_native=True)`` and the numpy path
(``use_native=False``) to the JAX numpy path, on the 14x12x10 hex, the
8x8x6 prism and tc1-tc8; every row of the native tables left-packed;
the library built once (a second compile, and a second loader on the
same build directory, build nothing); and a library that cannot be
built raises with the compiler's output rather than falling back."""

import dataclasses

import numpy as np
import pytest
import torch

from smoothmesh_tpu import native as jax_native
from smoothmesh_tpu import testcases as jtc
from smoothmesh_tpu.mesh import blockmesh as jbm
from smoothmesh_tpu.mesh.topology import compile_topology as jax_compile
from smoothmesh_torch import native
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.mesh import blockmesh as tbm
from smoothmesh_torch.mesh.topology import (ROW_MASKS, compile_topology,
                                            rows_not_left_packed)

torch.set_num_threads(1)

KINDS = ["hex", "prism", *ttc.ALL]


def _mesh(kind, bm, tcs):
    if kind == "hex":
        return bm.perturb(bm.hex_block(n=(14, 12, 10)), 0.05, seed=5)
    if kind == "prism":
        return bm.perturb(bm.prism_block(n=(8, 8, 6)), 0.04, seed=6)
    return tcs.ALL[kind]().mesh


def _assert_topologies_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("kind", KINDS)
def test_native_tables_match_jax(kind):
    assert jax_native.available()
    tm, jm = _mesh(kind, tbm, ttc), _mesh(kind, jbm, jtc)
    got = compile_topology(tm)
    _assert_topologies_equal(got, jax_compile(jm, use_native=True))
    assert rows_not_left_packed(got) == []
    # the numpy path stays the JAX numpy path's
    ref = compile_topology(tm, use_native=False)
    _assert_topologies_equal(ref, jax_compile(jm, use_native=False))
    # the two paths differ only in order: edges first-seen against sorted
    assert got.n_edges == ref.n_edges
    np.testing.assert_array_equal(
        np.unique(got.edges, axis=0), ref.edges)


def test_rows_not_left_packed_finds_a_gap():
    topo = compile_topology(_mesh("hex", tbm, ttc))
    assert set(ROW_MASKS) <= {f.name for f in dataclasses.fields(topo)}
    row = np.flatnonzero(topo.point_cells_mask.sum(axis=1) >= 2)[0]
    topo.point_cells_mask[row, 0] = False
    assert rows_not_left_packed(topo) == ["point_cells_mask"]


def test_library_is_built_once(tmp_path, monkeypatch):
    lib = native.HostLibrary(build_dir=tmp_path)
    monkeypatch.setattr(native, "MESHCOMPILER", lib)
    mesh = _mesh("prism", tbm, ttc)
    first = compile_topology(mesh)
    assert lib.builds == 1
    assert [p.name for p in tmp_path.iterdir()] == [lib.library_path().name]
    second = compile_topology(mesh)
    assert lib.builds == 1
    _assert_topologies_equal(first, second)
    # a second run (a new loader on the same directory) builds nothing
    again = native.HostLibrary(build_dir=tmp_path)
    again.load()
    assert again.builds == 0
    assert again.library_path() == lib.library_path()


def test_build_failure_raises(tmp_path, monkeypatch):
    mesh = _mesh("prism", tbm, ttc)
    monkeypatch.setattr(native, "MESHCOMPILER",
                        native.HostLibrary(build_dir=tmp_path))
    monkeypatch.setenv("CXX", str(tmp_path / "missing" / "g++"))
    with pytest.raises(RuntimeError, match="could not run the C.. compiler"):
        compile_topology(mesh)
    assert not list(tmp_path.iterdir())
    # a source the compiler refuses: its diagnostics in the error
    monkeypatch.delenv("CXX")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="(?s)building bad.cpp failed.*"
                       "error"):
        native.HostLibrary(source=bad, build_dir=tmp_path / "b").load()
    # the numpy path needs no library
    monkeypatch.setenv("CXX", str(tmp_path / "missing" / "g++"))
    assert compile_topology(mesh, use_native=False).n_edges > 0
