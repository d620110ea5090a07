"""Mesh partitioner for multi-shard smoothing (numpy, host side).

The reference relies on OpenFOAM's offline ``decomposePar`` (scotch) to
split the mesh into per-rank partitions; here :func:`partition_cells`
does it in-process by recursive coordinate bisection of rough cell
centroids into ``n_shards`` balanced cell sets (the JAX package's
``smoothmesh_tpu.parallel.partition``, same results).
"""

from __future__ import annotations

import numpy as np

from smoothmesh_torch.io.polymesh import PolyMesh


def cell_centroids_rough(mesh: PolyMesh) -> np.ndarray:
    """Cheap cell centroids (mean of face-point means) for partitioning."""
    flat = mesh.face_flat
    offs = mesh.face_offsets
    counts = np.diff(offs)
    face_of = np.repeat(np.arange(mesh.n_faces), counts)
    fsum = np.zeros((mesh.n_faces, 3))
    np.add.at(fsum, face_of, mesh.points[flat])
    fmean = fsum / counts[:, None]

    C = mesh.n_cells
    acc = np.zeros((C, 3))
    n = np.zeros(C)
    np.add.at(acc, mesh.owner, fmean)
    np.add.at(n, mesh.owner, 1)
    ni = mesh.neighbour
    np.add.at(acc, ni, fmean[: len(ni)])
    np.add.at(n, ni, 1)
    return acc / n[:, None]


def partition_cells(mesh: PolyMesh, n_shards: int) -> np.ndarray:
    """Recursive coordinate bisection -> (C,) shard ids, balanced."""
    ctr = cell_centroids_rough(mesh)
    C = mesh.n_cells
    shard = np.zeros(C, dtype=np.int64)

    def split(idx: np.ndarray, base: int, k: int) -> None:
        if k <= 1:
            shard[idx] = base
            return
        k1 = k // 2
        axis = int(np.argmax(ctr[idx].max(0) - ctr[idx].min(0)))
        order = np.argsort(ctr[idx, axis], kind="stable")
        n1 = (len(idx) * k1) // k
        split(idx[order[:n1]], base, k1)
        split(idx[order[n1:]], base + k1, k - k1)

    split(np.arange(C), 0, n_shards)
    return shard
