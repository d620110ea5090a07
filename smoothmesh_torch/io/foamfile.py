"""Minimal OpenFOAM ASCII FoamFile reader/writer utilities.

Host-side only (never on the device hot path).  Supports the subset of
the OpenFOAM file format needed for polyMesh I/O: comment stripping,
FoamFile headers, scalar/label/vector lists and the boundary dictionary.
This replaces the reference's reliance on the OpenFOAM ``IOobject``
machinery (reference src/smoothMesh.C:1786-1820, 2416-2431) with a
standalone implementation.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import numpy as np

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.DOTALL)


def _parse_floats(s: str) -> np.ndarray:
    """Whitespace-separated floats -> float64 array (fast path fromstring)."""
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return np.fromstring(s, dtype=np.float64, sep=" ")
    except Exception:
        return np.array(s.split(), dtype=np.float64)


def strip_comments(text: str) -> str:
    return _COMMENT_RE.sub(" ", text)


def _strip_header(text: str) -> str:
    """Remove the FoamFile { ... } header block, return the body."""
    m = re.search(r"FoamFile\s*\{", text)
    if m is None:
        return text
    depth = 1
    i = m.end()
    while depth > 0 and i < len(text):
        c = text[i]
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
        i += 1
    return text[:m.start()] + text[i:]


def read_header(path: str) -> Dict[str, str]:
    # latin-1: the header is ASCII, but binary bodies may share the
    # first 64 KiB and must not break the decode
    with open(path, "r", encoding="latin-1") as f:
        text = strip_comments(f.read(65536))
    m = re.search(r"FoamFile\s*\{(.*?)\}", text, re.DOTALL)
    hdr: Dict[str, str] = {}
    if m:
        for line in m.group(1).split(";"):
            parts = line.split(None, 1)
            if len(parts) == 2:
                hdr[parts[0].strip()] = parts[1].strip()
    return hdr


def load_body(path: str) -> str:
    with open(path, "r") as f:
        text = f.read()
    hdr = read_header(path)
    if hdr.get("format", "ascii") == "binary":
        raise NotImplementedError(
            f"binary FoamFile body is not text: {path} (use the "
            "read_*_file functions, which handle both formats)"
        )
    return _strip_header(strip_comments(text))


# ---------------------------------------------------------------------------
# Binary format support (OpenFOAM ``format binary;``)
#
# Binary lists are written as: ASCII decimal count, ``(``, raw
# little-endian element bytes, ``)``.  Element widths come from the
# header's ``arch "LSB;label=32;scalar=64"`` note (defaults match
# OpenFOAM's defaults).  polyMesh ``faces`` in binary are a
# faceCompactIOList: TWO consecutive lists (offsets then flat labels).
# The reference reads these through OpenFOAM IOobject machinery;
# real-world decomposed cases frequently use writeFormat binary.
# ---------------------------------------------------------------------------


def _binary_sizes(arch: str):
    """(label bytes, scalar bytes, endianness prefix) from the header's
    arch note, e.g. ``LSB;label=32;scalar=64``."""
    lm = re.search(r"label\s*=\s*(\d+)", arch)
    sm = re.search(r"scalar\s*=\s*(\d+)", arch)
    label = int(lm.group(1)) // 8 if lm else 4
    scalar = int(sm.group(1)) // 8 if sm else 8
    endian = ">" if "MSB" in arch else "<"
    return label, scalar, endian


def _header_end(data: bytes) -> int:
    """Byte offset just past the FoamFile { ... } header block."""
    m = re.search(rb"FoamFile\s*\{", data)
    if m is None:
        return 0
    depth = 1
    i = m.end()
    while depth > 0 and i < len(data):
        c = data[i: i + 1]
        if c == b"{":
            depth += 1
        elif c == b"}":
            depth -= 1
        i += 1
    return i


class _BinScanner:
    """Sequential scanner over a binary FoamFile body: ASCII counts and
    delimiters interleaved with raw element bytes."""

    def __init__(self, data: bytes, pos: int):
        self.d = data
        self.i = pos

    def _skip(self) -> None:
        d = self.d
        while self.i < len(d):
            c = d[self.i: self.i + 1]
            if c.isspace():
                self.i += 1
            elif d[self.i: self.i + 2] == b"//":
                j = d.find(b"\n", self.i)
                self.i = len(d) if j < 0 else j + 1
            elif d[self.i: self.i + 2] == b"/*":
                j = d.find(b"*/", self.i)
                self.i = len(d) if j < 0 else j + 2
            else:
                break

    def read_count(self) -> int:
        self._skip()
        j = self.i
        while j < len(self.d) and self.d[j: j + 1].isdigit():
            j += 1
        if j == self.i:
            raise ValueError(
                f"expected list count at byte {self.i} of binary FoamFile")
        n = int(self.d[self.i: j])
        self.i = j
        return n

    def expect(self, ch: bytes) -> None:
        self._skip()
        if self.d[self.i: self.i + 1] != ch:
            raise ValueError(
                f"expected {ch!r} at byte {self.i} of binary FoamFile")
        self.i += 1

    def read_list(self, n_elems: int, dtype: np.dtype) -> np.ndarray:
        """One binary list: count already announced as ``n_elems``."""
        self.expect(b"(")
        nbytes = n_elems * dtype.itemsize
        raw = self.d[self.i: self.i + nbytes]
        if len(raw) != nbytes:
            raise ValueError("binary FoamFile truncated")
        self.i += nbytes
        self.expect(b")")
        return np.frombuffer(raw, dtype=dtype)


def _binary_scanner(path: str):
    """(scanner over the body, arch note string).  The arch note is
    read from the raw bytes because the generic header parser splits on
    ``;`` and would truncate the quoted ``LSB;label=..;scalar=..``."""
    with open(path, "rb") as f:
        data = f.read()
    end = _header_end(data)
    m = re.search(rb'arch\s+"([^"]*)"', data[:end])
    arch = m.group(1).decode() if m else ""
    return _BinScanner(data, end), arch


def read_vector_field_file(path: str) -> np.ndarray:
    """Read a vectorField file (ascii or binary) -> (N, 3) float64."""
    hdr = read_header(path)
    if hdr.get("format", "ascii") == "binary":
        sc, arch = _binary_scanner(path)
        _, scalar, endian = _binary_sizes(arch)
        n = sc.read_count()
        vals = sc.read_list(3 * n, np.dtype(f"{endian}f{scalar}"))
        return vals.astype(np.float64).reshape(-1, 3)
    return parse_vector_field(load_body(path))


def read_label_list_file(path: str) -> np.ndarray:
    """Read a labelList file (ascii or binary) -> int64 array."""
    hdr = read_header(path)
    if hdr.get("format", "ascii") == "binary":
        sc, arch = _binary_scanner(path)
        label, _, endian = _binary_sizes(arch)
        n = sc.read_count()
        return sc.read_list(n, np.dtype(f"{endian}i{label}")).astype(
            np.int64)
    return parse_label_list(load_body(path))


def read_face_list_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a polyMesh faces file -> (flat, offsets).

    Handles ascii faceList, ascii faceCompactIOList, and binary
    faceCompactIOList (the form OpenFOAM writes for binary meshes:
    an offsets list followed by a flat label list).
    """
    hdr = read_header(path)
    compact = "Compact" in hdr.get("class", "")
    if hdr.get("format", "ascii") == "binary":
        sc, arch = _binary_scanner(path)
        label, _, endian = _binary_sizes(arch)
        dt = np.dtype(f"{endian}i{label}")
        n_off = sc.read_count()
        offsets = sc.read_list(n_off, dt).astype(np.int64)
        n_flat = sc.read_count()
        flat = sc.read_list(n_flat, dt).astype(np.int64)
        if offsets[-1] != n_flat:
            raise ValueError("faceCompactIOList offsets/flat mismatch")
        return flat, offsets
    body = load_body(path)
    if compact:
        lp = body.index("(")
        rp = body.index(")", lp)
        offsets = _parse_floats(body[lp + 1: rp]).astype(np.int64)
        rest = body[rp + 1:]
        lp = rest.index("(")
        rp = rest.rindex(")")
        flat = _parse_floats(rest[lp + 1: rp]).astype(np.int64)
        return flat, offsets
    return parse_face_list(body)


def parse_scalar_field(body: str) -> np.ndarray:
    """Parse ``N ( v v v ... )`` into a float64 array."""
    lp = body.index("(")
    rp = body.rindex(")")
    vals = _parse_floats(body[lp + 1: rp])
    return vals


def parse_label_list(body: str) -> np.ndarray:
    lp = body.index("(")
    rp = body.rindex(")")
    return _parse_floats(body[lp + 1: rp]).astype(
        np.int64
    )


def parse_vector_field(body: str) -> np.ndarray:
    """Parse ``N ( (x y z) (x y z) ... )`` into an (N, 3) float64 array."""
    lp = body.index("(")
    rp = body.rindex(")")
    inner = body[lp + 1: rp].replace("(", " ").replace(")", " ")
    vals = _parse_floats(inner)
    if vals.size % 3 != 0:
        raise ValueError("vector field token count not divisible by 3")
    return vals.reshape(-1, 3)


def parse_face_list(body: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``N ( k(a b ..) k(a b ..) ... )`` into (flat, offsets).

    ``flat`` concatenates all face point labels; ``offsets`` has length
    N+1 with face i occupying ``flat[offsets[i]:offsets[i+1]]``.
    """
    lp = body.index("(")
    rp = body.rindex(")")
    n_faces = int(body[:lp].split()[-1])
    inner = body[lp + 1: rp].replace("(", " ").replace(")", " ")
    toks = _parse_floats(inner).astype(np.int64)
    # Tokens are [count, p0..p_{count-1}] repeated.  Fast path: uniform
    # face size (hex/tet meshes) — detect by checking the implied stride.
    if n_faces > 0 and toks.size % n_faces == 0:
        stride = toks.size // n_faces
        cand = toks.reshape(n_faces, stride)
        if np.all(cand[:, 0] == stride - 1):
            flat = cand[:, 1:].reshape(-1).copy()
            offsets = np.arange(n_faces + 1, dtype=np.int64) * (stride - 1)
            return flat, offsets
    # General (mixed-size) path.
    counts = np.empty(n_faces, dtype=np.int64)
    pos = 0
    starts = np.empty(n_faces, dtype=np.int64)
    for i in range(n_faces):
        counts[i] = toks[pos]
        starts[i] = pos + 1
        pos += toks[pos] + 1
    if pos != toks.size:
        raise ValueError("face list parse error: trailing tokens")
    offsets = np.zeros(n_faces + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    flat = np.empty(offsets[-1], dtype=np.int64)
    for i in range(n_faces):
        flat[offsets[i]: offsets[i + 1]] = toks[starts[i]: starts[i] + counts[i]]
    return flat, offsets


_DICT_ENTRY_RE = re.compile(r"(\S+)\s*\{([^{}]*)\}", re.DOTALL)


def parse_boundary(body: str) -> List[Dict[str, str]]:
    """Parse the polyMesh ``boundary`` file into a list of patch dicts."""
    lp = body.index("(")
    rp = body.rindex(")")
    inner = body[lp + 1: rp]
    patches = []
    for m in _DICT_ENTRY_RE.finditer(inner):
        name = m.group(1)
        entries: Dict[str, str] = {"name": name}
        for line in m.group(2).split(";"):
            parts = line.split(None, 1)
            if len(parts) == 2:
                entries[parts[0].strip()] = parts[1].strip()
        patches.append(entries)
    return patches


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

_HEADER = """\
/*--------------------------------*- C++ -*----------------------------------*\\
| Generated by smoothmesh_torch                                               |
\\*---------------------------------------------------------------------------*/
FoamFile
{{
    version     2.0;
    format      {format};{arch}
    class       {cls};
    location    "{location}";
    object      {obj};
}}
// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //

"""

_BIN_ARCH = '\n    arch        "LSB;label=32;scalar=64";'


def _open_out(path: str, binary: bool = False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return open(path, "wb" if binary else "w")


def _header(cls: str, obj: str, location: str, binary: bool = False) -> str:
    return _HEADER.format(cls=cls, obj=obj, location=location,
                          format="binary" if binary else "ascii",
                          arch=_BIN_ARCH if binary else "")


def write_vector_field(path: str, cls: str, obj: str, location: str,
                       data: np.ndarray, precision: int = 10,
                       binary: bool = False) -> None:
    """Write an (N, 3) array as ``N ( (x y z) ... )``.

    Points are written with >=10 significant digits, matching the
    reference's precision bump (reference src/smoothMesh.C:2425).
    Binary form: ASCII count, ``(``, raw little-endian f64, ``)``.
    """
    data = np.asarray(data)
    with _open_out(path, binary) as f:
        hdr = _header(cls, obj, location, binary)
        if binary:
            f.write(hdr.encode())
            f.write(f"{len(data)}\n(".encode())
            f.write(np.ascontiguousarray(data, dtype="<f8").tobytes())
            f.write(b")\n")
            return
        f.write(hdr)
        f.write(f"{len(data)}\n(\n")
        fmt = f"({{:.{precision}g}} {{:.{precision}g}} {{:.{precision}g}})\n"
        f.write("".join(fmt.format(*row) for row in data))
        f.write(")\n\n// ************************* //\n")


def write_label_list(path: str, cls: str, obj: str, location: str,
                     data: np.ndarray, note: str = "",
                     binary: bool = False) -> None:
    data = np.asarray(data)
    hdr = _header(cls, obj, location, binary)
    if note:
        hdr = hdr.replace("    object",
                          f'    note        "{note}";\n    object')
    with _open_out(path, binary) as f:
        if binary:
            f.write(hdr.encode())
            f.write(f"{len(data)}\n(".encode())
            f.write(np.ascontiguousarray(data, dtype="<i4").tobytes())
            f.write(b")\n")
            return
        f.write(hdr)
        f.write(f"{len(data)}\n(\n")
        f.write("\n".join(str(int(v)) for v in data))
        f.write("\n)\n\n// ************************* //\n")


def write_face_list(path: str, cls: str, obj: str, location: str,
                    flat: np.ndarray, offsets: np.ndarray,
                    binary: bool = False) -> None:
    flat = np.asarray(flat)
    offsets = np.asarray(offsets)
    if binary:
        # faceCompactIOList: offsets list then flat label list, exactly
        # what OpenFOAM writes for binary meshes.
        with _open_out(path, True) as f:
            f.write(_header("faceCompactList", obj, location, True).encode())
            f.write(f"{len(offsets)}\n(".encode())
            f.write(np.ascontiguousarray(offsets, dtype="<i4").tobytes())
            f.write(b")\n")
            f.write(f"{len(flat)}\n(".encode())
            f.write(np.ascontiguousarray(flat, dtype="<i4").tobytes())
            f.write(b")\n")
        return
    with _open_out(path) as f:
        f.write(_header(cls, obj, location))
        n = len(offsets) - 1
        f.write(f"{n}\n(\n")
        lines = []
        for i in range(n):
            pts = flat[offsets[i]: offsets[i + 1]]
            lines.append(f"{len(pts)}({' '.join(str(int(p)) for p in pts)})")
        f.write("\n".join(lines))
        f.write("\n)\n\n// ************************* //\n")


def write_boundary(path: str, location: str,
                   patches: List[Dict[str, str]]) -> None:
    with _open_out(path) as f:
        f.write(_header("polyBoundaryMesh", "boundary", location))
        f.write(f"{len(patches)}\n(\n")
        for p in patches:
            f.write(f"    {p['name']}\n    {{\n")
            for k in ("type", "inGroups", "nFaces", "startFace"):
                if k in p:
                    f.write(f"        {k}            {p[k]};\n")
            f.write("    }\n")
        f.write(")\n\n// ************************* //\n")
