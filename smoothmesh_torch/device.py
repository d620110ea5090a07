"""Host -> device staging of compiled topology.

Converts a :class:`~smoothmesh_torch.mesh.topology.MeshTopology` into a
flat dict of torch tensors (the "device topology"): int32 index tables
and bool masks, under the same key names as the JAX package's device
topology, consumed by :mod:`smoothmesh_torch.geometry` and
:mod:`smoothmesh_torch.ops`; plus, only where asked for by name, the
packed words of the K2, K4 and K5 kernels (:data:`PACKED_KEYS`).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from smoothmesh_torch.mesh.topology import MeshTopology


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def _fa_packed(topo: MeshTopology) -> Dict[str, np.ndarray]:
    """The face-angle fixed point's packed tables (numpy), as the JAX
    package's ``device._fa_packed`` builds them:

    - ``pps_signed``: point_points with invalid slots as -1;
    - ``pe_flat``: point_edges_side * E + point_edges with invalid
      slots as -1 (E = the edges array's row count).
    """
    e_rows = topo.edges.shape[0]
    if 2 * e_rows >= 2**31:  # flat (side, edge) ids must fit int32
        raise ValueError("mesh too large for int32 flat edge ids")
    pps = np.where(topo.point_points_mask, topo.point_points, -1)
    pef = np.where(topo.point_edges_mask,
                   topo.point_edges_side.astype(np.int64) * e_rows
                   + topo.point_edges, -1)
    return {"pps_signed": pps.astype(np.int32),
            "pe_flat": pef.astype(np.int32)}


#: Packed tables, staged only when ``to_device`` is asked for them:
#: K2's cell-face words (int32, :func:`pack_cell_faces`), K4's wedges
#: and K5's cell slots (int16, :func:`pack_wedges`,
#: :func:`pack_edge_cells`).
PACKED_KEYS = frozenset({"cell_face_words", "wedge_words",
                         "edge_cell_words"})
#: the largest face id a cell-face word holds
MAX_CELL_FACE = (1 << 30) - 1


def pack_cell_faces(owner, cell_faces, cell_faces_mask) -> np.ndarray:
    """K2's cell-face words: per (cell, slot) one int32, the face id with
    bit 30 set where the cell is the face's neighbour (its pyramid's
    sign is -1), and -1 on padded slots.  The JAX tile engine's stage-C
    meta word (``smoothmesh_tpu/ops/tiledstep.py:161-176``: the sign in
    bit 14, the mask in bit 15) at 32 bits, with the face id in place
    of the pool code."""
    cf = np.where(cell_faces_mask, cell_faces, 0).astype(np.int64)
    if cf.size and int(cf.max()) > MAX_CELL_FACE:
        raise ValueError(f"face id {int(cf.max())} >= 2^30: it does not "
                         "fit 30 bits of K2's cell-face word")
    cells = np.arange(cf.shape[0], dtype=np.int64)[:, None]
    neg = np.asarray(owner)[cf] != cells
    return np.where(cell_faces_mask, cf | (neg.astype(np.int64) << 30),
                    -1).astype(np.int32)


def pack_wedges(point_points, point_points_mask, point_faces_mask,
                wedge_prev, wedge_next) -> np.ndarray:
    """K4's wedge words: per (point, face) incidence one int16, the prev
    and next neighbours as slots of the point's ``point_points`` row
    (bits 0-4 and 5-9) and the ``point_faces`` mask (bit 15); invalid
    wedges hold slot 0.  The logic of the JAX tile engine's ``to_slots``
    (``smoothmesh_tpu/ops/tiledstep.py:246-269``), one row slot at a
    time."""
    wp = point_points.shape[1]
    if wp > 32:
        raise ValueError(f"point_points width {wp} > 32: a wedge slot "
                         "does not fit 5 bits of K4's int16 word")
    word = point_faces_mask.astype(np.uint16) << 15
    for shift, tab in ((0, wedge_prev), (5, wedge_next)):
        slot = np.zeros(tab.shape, dtype=np.uint16)
        found = ~point_faces_mask            # invalid wedges keep slot 0
        for s in range(wp):
            hit = ((tab == point_points[:, s:s + 1])
                   & point_points_mask[:, s:s + 1] & ~found)
            slot[hit] = s
            found |= hit
        if not found.all():
            raise ValueError("a wedge neighbour is not in its point's "
                             "point_points row")
        word |= slot << shift
    return word.view(np.int16)


def pack_edge_cells(edge_cell_f0, edge_cell_f1, edge_cells_mask,
                    edge_faces_width: int) -> np.ndarray:
    """K5's cell words: per (edge, cell) slot one int16, the cell's two
    faces as slots of the edge's ``edge_faces`` row (bits 0-6 and 7-13)
    and the ``edge_cells`` mask (bit 15).  The logic of the JAX tile
    engine's stage E (``smoothmesh_tpu/ops/tiledstep.py:583-599``)."""
    if edge_faces_width >= 128:
        raise ValueError(f"edge_faces width {edge_faces_width} >= 128: a "
                         "face slot does not fit 7 bits of K5's int16 word")
    word = (edge_cell_f0.astype(np.uint16)
            | (edge_cell_f1.astype(np.uint16) << 7)
            | (edge_cells_mask.astype(np.uint16) << 15))
    return word.view(np.int16)


def _valid_rows(topo: MeshTopology, entity: str, n: int) -> np.ndarray:
    rows = getattr(topo, f"{entity}_valid_rows", None)
    return np.ones(n, dtype=bool) if rows is None else rows


def to_device(topo: MeshTopology, device=None,
              keys: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """Stage topology arrays (int32 indices, bool masks) on ``device``.

    ``keys``: optional iterable restricting which arrays are staged
    (``Smoother`` stages only the tables its iteration reads); the
    :data:`PACKED_KEYS` (int32 or int16) are staged only when named
    there.
    """
    dev = resolve_device(device)
    keys = None if keys is None else frozenset(keys)
    if keys is None or "face_is_real_boundary" in keys:
        real_patch = np.array(
            [t not in ("processor", "empty") for t in topo.patch_types],
            dtype=bool)
        face_is_real_boundary = np.zeros(topo.n_faces, dtype=bool)
        bnd = topo.face_patch >= 0
        face_is_real_boundary[bnd] = real_patch[topo.face_patch[bnd]]
    else:
        face_is_real_boundary = None

    host = {
        "face_points": topo.face_points,
        "face_points_next": topo.face_points_next,
        "face_mask": topo.face_mask,
        "face_npoints": topo.face_npoints,
        "owner": topo.owner,
        "neighbour": topo.neighbour,
        "has_neighbour": topo.has_neighbour,
        "edges": topo.edges,
        "edge_faces": topo.edge_faces,
        "edge_faces_mask": topo.edge_faces_mask,
        "edge_cells": topo.edge_cells,
        "edge_cells_mask": topo.edge_cells_mask,
        "edge_cell_f0": topo.edge_cell_f0,
        "edge_cell_f1": topo.edge_cell_f1,
        "point_points": topo.point_points,
        "point_points_mask": topo.point_points_mask,
        "point_cells": topo.point_cells,
        "point_cells_mask": topo.point_cells_mask,
        "point_faces": topo.point_faces,
        "point_faces_mask": topo.point_faces_mask,
        "point_edges": topo.point_edges,
        "point_edges_mask": topo.point_edges_mask,
        "point_edges_side": topo.point_edges_side,
        "wedge_prev": topo.wedge_prev,
        "wedge_next": topo.wedge_next,
        "cell_faces": topo.cell_faces,
        "cell_faces_mask": topo.cell_faces_mask,
        "is_internal_point": topo.is_internal_point,
        "face_patch": topo.face_patch,
        "face_is_real_boundary": face_is_real_boundary,
        # Row-validity masks: all True for a plain mesh; a topology
        # padded to common shapes (parallel.halo.pad_topology) carries
        # them as *_valid_rows attributes, False on its padded rows
        "point_valid": _valid_rows(topo, "point", topo.n_points),
        "edge_valid": _valid_rows(topo, "edge", topo.n_edges),
        "cell_valid": _valid_rows(topo, "cell", topo.n_cells),
    }
    if keys is None or keys & {"pps_signed", "pe_flat"}:
        host.update(_fa_packed(topo))
    if keys is not None and "cell_face_words" in keys:
        host["cell_face_words"] = pack_cell_faces(
            topo.owner, topo.cell_faces, topo.cell_faces_mask)
    if keys is not None and "wedge_words" in keys:
        host["wedge_words"] = pack_wedges(
            topo.point_points, topo.point_points_mask, topo.point_faces_mask,
            topo.wedge_prev, topo.wedge_next)
    if keys is not None and "edge_cell_words" in keys:
        host["edge_cell_words"] = pack_edge_cells(
            topo.edge_cell_f0, topo.edge_cell_f1, topo.edge_cells_mask,
            topo.edge_faces.shape[1])
    if keys is not None:
        host = {k: v for k, v in host.items() if k in keys}
    out = {}
    for k, v in host.items():
        v = np.ascontiguousarray(v)
        if v.dtype != np.bool_ and k not in PACKED_KEYS:
            v = v.astype(np.int32, copy=False)
        out[k] = torch.from_numpy(v).to(dev)
    return out
