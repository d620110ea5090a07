"""The reference's own connectivity, built from the faces, the owner
and the neighbour lists alone (plain PyTorch, on any device): padded
rows with -1 where a row is shorter than the widest.

Nothing here is taken from the program: it derives again what a mesh
compiler derives (edges, point-point, point-cell, cell-face, wedge,
edge-face and edge-cell adjacency, and the two faces of each cell at
each edge).
"""

from __future__ import annotations

import torch


def pad_rows(keys: torch.Tensor, n_rows: int, *vals: torch.Tensor):
    """Group ``vals`` by ``keys`` (stable, so entries keep their order)
    into padded (n_rows, width) tables -> (mask, *tables); padding -1."""
    order = torch.argsort(keys, stable=True)
    keys = keys[order]
    counts = torch.bincount(keys, minlength=n_rows)
    width = max(int(counts.max()), 1) if keys.numel() else 1
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(keys.numel(), device=keys.device) - starts[keys]
    mask = torch.zeros((n_rows, width), dtype=torch.bool, device=keys.device)
    mask[keys, slot] = True
    out = [mask]
    for v in vals:
        t = torch.full((n_rows, width) + tuple(v.shape[1:]), -1,
                       dtype=v.dtype, device=v.device)
        t[keys, slot] = v[order]
        out.append(t)
    return tuple(out)


def unique_pairs(a: torch.Tensor, b: torch.Tensor, nb: int):
    """Unique (a, b) pairs of non-negative ints, b < nb."""
    key = torch.unique(a * nb + b)
    return key // nb, key % nb


def build(mesh: dict, device) -> dict:
    """Connectivity of a mesh dict (:mod:`inputs`) on ``device``."""
    dev = torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    flat = torch.as_tensor(mesh["face_flat"], **i64)
    offs = torch.as_tensor(mesh["face_offsets"], **i64)
    owner = torch.as_tensor(mesh["owner"], **i64)
    neigh_int = torch.as_tensor(mesh["neighbour"], **i64)
    n_points = len(mesh["points"])
    n_faces = offs.numel() - 1
    n_int = neigh_int.numel()
    neighbour = torch.full((n_faces,), -1, **i64)
    neighbour[:n_int] = neigh_int
    n_cells = int(torch.maximum(owner.max(), neigh_int.max()
                                if n_int else owner.max())) + 1

    counts = offs[1:] - offs[:-1]
    face = torch.repeat_interleave(torch.arange(n_faces, **i64), counts)
    slot = torch.arange(flat.numel(), **i64) - offs[face]
    nxt = flat[offs[face] + (slot + 1) % counts[face]]
    prv = flat[offs[face] + (slot - 1) % counts[face]]

    # faces as padded rows of points (perimeter order)
    face_mask, face_points, face_next = pad_rows(face, n_faces, flat, nxt)

    # edges: unique unordered perimeter pairs
    lo, hi = torch.minimum(flat, nxt), torch.maximum(flat, nxt)
    ekey, edge_of = torch.unique(lo * n_points + hi, return_inverse=True)
    edges = torch.stack([ekey // n_points, ekey % n_points], 1)
    n_edges = edges.shape[0]

    both = torch.cat([edges[:, 0], edges[:, 1]])
    other = torch.cat([edges[:, 1], edges[:, 0]])
    eids = torch.arange(n_edges, **i64)
    pp_mask, point_points = pad_rows(both, n_points, other)
    pe_mask, point_edges = pad_rows(both, n_points, torch.cat([eids, eids]))

    # cells of each face entry (owner, and neighbour where internal)
    has_n = neighbour[face] >= 0
    e_face = torch.cat([face, face[has_n]])
    e_cell = torch.cat([owner[face], neighbour[face][has_n]])
    e_point = torch.cat([flat, flat[has_n]])
    e_edge = torch.cat([edge_of, edge_of[has_n]])

    pc_p, pc_c = unique_pairs(e_point, e_cell, n_cells)
    pc_mask, point_cells = pad_rows(pc_p, n_points, pc_c)

    f_ids = torch.arange(n_faces, **i64)
    internal_f = neighbour >= 0
    cf_mask, cell_faces, cell_sign = pad_rows(
        torch.cat([owner, neighbour[internal_f]]), n_cells,
        torch.cat([f_ids, f_ids[internal_f]]),
        torch.cat([torch.ones(n_faces, **i64),
                   -torch.ones(int(internal_f.sum()), **i64)]))

    # wedges: each (point, face) incidence with its face neighbours
    pf_mask, point_faces, wedge_prev, wedge_next = pad_rows(
        flat, n_points, face, prv, nxt)

    ef_mask, edge_faces = pad_rows(edge_of, n_edges, face)

    # each (edge, cell): the cell's two faces that hold the edge
    order = torch.argsort(e_edge * n_cells + e_cell, stable=True)
    ee, ec, efc = e_edge[order], e_cell[order], e_face[order]
    if ee.numel() % 2 or not torch.equal(ee[0::2], ee[1::2]) \
            or not torch.equal(ec[0::2], ec[1::2]):
        raise ValueError("an edge of a cell is not held by exactly two of "
                         "its faces")
    ec_mask, edge_cells, edge_cf0, edge_cf1 = pad_rows(
        ee[0::2], n_edges, ec[0::2], efc[0::2], efc[1::2])

    bnd = torch.zeros(n_points, dtype=torch.bool, device=dev)
    bnd[flat[offs[n_int]:]] = True
    return dict(
        n_points=n_points, n_cells=n_cells, n_faces=n_faces,
        n_edges=n_edges, face_points=face_points, face_next=face_next,
        face_mask=face_mask,
        face_npoints=counts, edges=edges, point_points=point_points,
        pp_mask=pp_mask, point_edges=point_edges, pe_mask=pe_mask,
        point_cells=point_cells, pc_mask=pc_mask, cell_faces=cell_faces,
        cf_mask=cf_mask, cell_sign=cell_sign, wedge_prev=wedge_prev,
        wedge_next=wedge_next, pf_mask=pf_mask, point_faces=point_faces,
        edge_faces=edge_faces, ef_mask=ef_mask, edge_cells=edge_cells,
        ec_mask=ec_mask, edge_cf0=edge_cf0, edge_cf1=edge_cf1,
        owner=owner, neighbour=neighbour, internal=~bnd)
