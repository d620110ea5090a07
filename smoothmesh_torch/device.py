"""Host -> device staging of compiled topology.

Converts a :class:`~smoothmesh_torch.mesh.topology.MeshTopology` into a
flat dict of torch tensors (the "device topology"): int32 index tables
and bool masks, under the same key names as the JAX package's device
topology, consumed by :mod:`smoothmesh_torch.geometry` and
:mod:`smoothmesh_torch.ops`.
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


def to_device(topo: MeshTopology, device=None,
              keys: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """Stage topology arrays (int32 indices, bool masks) on ``device``.

    ``keys``: optional iterable restricting which arrays are staged
    (the driver stages only the tables its iteration reads).
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
        # Row-validity masks: all True for a single-device mesh
        "point_valid": np.ones(topo.n_points, dtype=bool),
        "edge_valid": np.ones(topo.n_edges, dtype=bool),
        "cell_valid": np.ones(topo.n_cells, dtype=bool),
    }
    if keys is None or keys & {"pps_signed", "pe_flat"}:
        host.update(_fa_packed(topo))
    if keys is not None:
        host = {k: v for k, v in host.items() if k in keys}
    out = {}
    for k, v in host.items():
        v = np.ascontiguousarray(v)
        if v.dtype != np.bool_:
            v = v.astype(np.int32, copy=False)
        out[k] = torch.from_numpy(v).to(dev)
    return out
