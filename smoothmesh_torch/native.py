"""ctypes bindings for the topology compiler's host builds.

``csrc/host/meshcompiler.cpp`` does the heavy builds of
:func:`smoothmesh_torch.mesh.topology.compile_topology` in O(M) (M =
face perimeter entries): edge extraction by hashing, and grouping into
padded rows in input order (rows are left-packed, entries in order of
first appearance, not sorted).  It is compiled at first use with
``$CXX`` (default ``g++``) ``-O3 -march=native -shared -fPIC`` into the
git-ignored ``smoothmesh_torch/build/``, as a library named by a hash of
the source, the flags and the compiler's predefined macros for this
host (its version and the CPU features ``-march=native`` selects), so
an edited source or another host's CPU is rebuilt and a second run
builds nothing.  Nothing is built or loaded at import time.

A library that cannot be built or loaded raises ``RuntimeError`` with
the compiler's output: there is no quiet fallback; the numpy path is
``compile_topology(mesh, use_native=False)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

PKG = Path(__file__).resolve().parent
SOURCE = PKG / "csrc" / "host" / "meshcompiler.cpp"
BUILD = PKG / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
#: entry point -> (restype, argtypes)
SIGNATURES = {
    "build_edges": (_I64, [_I32P, _I64P, _I64, _I64, _I32P, _I32P]),
    "group_counts": (None, [_I32P, _I64, _I32P]),
    "group_fill": (None, [_I32P, _I32P, _I64, _I64, _I32P, _I32P, _U8P]),
    "group_fill_dedup": (None, [_I32P, _I32P, _I64, _I64, _I32P, _I32P,
                                _U8P]),
    "edge_cell_face_pairs": (_I64, [_I32P, _U8P, _I32P, _U8P, _I32P, _I32P,
                                    _I64, _I64, _I64, _I32P, _I32P]),
}


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def _run(cmd, what: str) -> subprocess.CompletedProcess:
    """Run the compiler; raise RuntimeError with its output on failure."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              input="", timeout=300)
    except OSError as e:
        raise RuntimeError(f"{what}: could not run the C++ compiler "
                           f"{cmd[0]!r} ($CXX): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({' '.join(map(str, cmd))}):\n"
                           f"{proc.stderr}{proc.stdout}")
    return proc


class HostLibrary:
    """One C++ source built into a shared library at first use."""

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.builds = 0          # compiles run by this object
        self._path = None
        self._lib = None

    def library_path(self) -> Path:
        if self._path is None:
            cxx = compiler()
            macros = _run([cxx, "-march=native", "-dM", "-E", "-x", "c++",
                           "-"], "the C++ compiler's target query").stdout
            h = hashlib.sha1(self.source.read_bytes())
            h.update(" ".join(CXX_FLAGS).encode())
            h.update(macros.encode())
            self._path = (self.build_dir
                          / f"lib{self.source.stem}-{h.hexdigest()[:12]}.so")
        return self._path

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        lib_path = self.library_path()
        if not lib_path.exists():
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            _run([compiler(), *CXX_FLAGS, "-o", str(tmp), str(self.source)],
                 f"building {self.source.name}")
            os.replace(tmp, lib_path)
            self.builds += 1
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            raise RuntimeError(f"loading {lib_path}: {e}") from e
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        self._lib = lib
        return lib


#: the topology compiler's library
MESHCOMPILER = HostLibrary()


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _pu8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def build_edges(flat: np.ndarray, offsets: np.ndarray,
                n_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unique undirected edges + per-perimeter-entry edge ids ->
    (edges (E, 2) as (lo, hi), edge_of_pair (M,)), edges in order of
    first appearance."""
    lib = MESHCOMPILER.load()
    flat = _i32(flat)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    m = int(offsets[-1])
    edge_of_pair = np.empty(m, dtype=np.int32)
    edges_buf = np.empty((m, 2), dtype=np.int32)
    n_edges = lib.build_edges(_p32(flat), _p64(offsets), len(offsets) - 1,
                              n_points, _p32(edge_of_pair), _p32(edges_buf))
    if n_edges < 0:
        raise ValueError("build_edges: face point label out of range")
    return edges_buf[:n_edges].copy(), edge_of_pair


def pad_groups_native(keys: np.ndarray, nrows: int, vals: np.ndarray,
                      dedupe: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(mask, padded) as ``topology.pad_groups`` builds them, but with
    each row's entries in input order (left-packed), in O(M); with
    ``dedupe`` a value already in its row is skipped."""
    lib = MESHCOMPILER.load()
    keys, vals = _i32(keys), _i32(vals)
    m = len(keys)
    counts = np.zeros(nrows, dtype=np.int32)
    lib.group_counts(_p32(keys), m, _p32(counts))
    width = max(int(counts.max(initial=0)), 1)
    out = np.zeros((nrows, width), dtype=np.int32)
    mask = np.zeros((nrows, width), dtype=np.uint8)
    cursor = np.zeros(nrows, dtype=np.int32)
    fill = lib.group_fill_dedup if dedupe else lib.group_fill
    fill(_p32(keys), _p32(vals), m, width, _p32(cursor), _p32(out),
         _pu8(mask))
    # the widest row after dropping duplicates
    used = int(cursor.max(initial=0)) if dedupe else width
    return mask[:, :used].astype(bool), out[:, :used]


def edge_cell_face_pairs(edge_faces, ef_mask, edge_cells, ec_mask, owner,
                         neighbour_full) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(edge, cell slot) face-pair slots -> (f0, f1), (E, wc) each.

    ``neighbour_full`` has -1 for boundary faces.  Raises ValueError on
    the reference's findCellFacePair sanity violation.
    """
    lib = MESHCOMPILER.load()
    edge_faces, edge_cells = _i32(edge_faces), _i32(edge_cells)
    ef_mask = np.ascontiguousarray(ef_mask, dtype=np.uint8)
    ec_mask = np.ascontiguousarray(ec_mask, dtype=np.uint8)
    owner, neighbour_full = _i32(owner), _i32(neighbour_full)
    n_edges, wf = edge_faces.shape
    wc = edge_cells.shape[1]
    f0 = np.zeros((n_edges, wc), dtype=np.int32)
    f1 = np.zeros((n_edges, wc), dtype=np.int32)
    rc = lib.edge_cell_face_pairs(
        _p32(edge_faces), _pu8(ef_mask), _p32(edge_cells), _pu8(ec_mask),
        _p32(owner), _p32(neighbour_full), n_edges, wc, wf, _p32(f0),
        _p32(f1))
    if rc != 0:
        raise ValueError(
            "mesh sanity: edge/cell with != 2 adjacent edge-faces")
    return f0, f1
