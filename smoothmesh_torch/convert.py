"""Carry a smoother's state across from the JAX package.

:func:`state_from_jax` builds this package's :class:`Smoother` (and
:func:`halo_state_from_jax` and :func:`sharded_state_from_jax` its
``HaloSmoother`` and ``ShardedSmoother``) from plain numpy and Python
values read off a ``smoothmesh_tpu`` smoother, so both can run on from
one identical state.  Nothing here imports the
JAX package: the caller reads its values.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.topology import MeshTopology
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.tracing import Trace


def state_from_jax(points, topo_arrays: Mapping, params: Mapping, center,
                   scale: float, device=None, dtype=None,
                   normals=None, smoothing_surface=None,
                   layer: Optional[Mapping] = None,
                   bnd: Optional[Mapping] = None) -> Smoother:
    """A :class:`Smoother` on ``device`` from the JAX smoother's state.

    points: its internal normalized points (``np.asarray(sm.points)``).
    topo_arrays: its ``MeshTopology`` fields by name (numpy arrays and
        the scalar/tuple fields as they are).
    params: its resolved ``SmoothingParams`` as a dict.
    center, scale: its ``_center`` and ``_scale``.
    normals, smoothing_surface: its boundary point normals (state) and
        smoothing-surface mask, as numpy arrays.
    layer, bnd: its ``layer`` and ``bnd`` dicts with numpy values (or
        None where off); the triangle soup is packed here from
        ``tri_a``/``tri_b``/``tri_c``, and the compaction rows lose
        their padding (the value N).

    The points stay in the topology's order, so ``denormalize()`` maps
    back to external coordinates without reordering.  The smoother has
    no mesh, so boundary smoothing comes with ``bnd`` here and not from
    ``enable_boundary_smoothing``.
    """
    names = {f.name for f in dataclasses.fields(MeshTopology)}
    topo = MeshTopology(**{k: topo_arrays[k] for k in names})
    pfields = {f.name for f in dataclasses.fields(SmoothingParams)}
    resolved = SmoothingParams(**{k: v for k, v in params.items()
                                  if k in pfields})
    sm = Smoother.__new__(Smoother)
    sm.trace = Trace()
    sm.mesh = sm.mesh_internal = sm.stats = None
    sm._setup(topo, np.asarray(points, dtype=np.float64), resolved,
              center, scale, device, dtype, orders=None)
    if sm._will_layer and layer is None:
        raise ValueError(
            "layer_patches match a patch of the mesh, so the JAX "
            "smoother blends layers: pass its layer dict as layer=")
    if normals is not None:
        sm.normals = sm._tensor(normals, sm.dtype)
    if smoothing_surface is not None:
        sm.smoothing_surface = sm._tensor(smoothing_surface, torch.bool)
    if layer is not None:
        sm.layer = {k: sm._tensor(layer[k], torch.int64)
                    for k in ("hops_layer", "outer_map")}
    if bnd is not None:
        n = topo.n_points
        host = dict(bnd)
        for k in ("feat_rows", "surf_rows"):
            rows = np.asarray(host[k])
            host[k] = rows[rows < n]
        sm.bnd = sm._bnd_tables(host)
    if layer is not None or bnd is not None:
        sm._stage_normals_tables()
    return sm


def halo_state_from_jax(mesh, n_shards: int, points, params: Mapping,
                        center, scale: float, device=None, dtype=None,
                        normals=None, smoothing_surface=None,
                        layer: Optional[Mapping] = None,
                        bnd: Optional[Mapping] = None,
                        bnd_rep: Optional[Mapping] = None,
                        distance_tolerance: Optional[float] = None):
    """A :class:`~smoothmesh_torch.parallel.halo.HaloSmoother` on
    ``device`` from a JAX ``HaloSmoother``'s state, to continue its run.

    mesh, n_shards: the mesh and shard count the JAX smoother was built
        with; the shards are built again here (the same shards).
    points: its (D, Npad, 3) internal local points (``sm.points``).
    params: its resolved ``SmoothingParams`` as a dict.
    center, scale: its ``_center`` and ``_scale``.
    normals, smoothing_surface: its (D, Npad, 3) normals and (D, Npad)
        smoothing-surface mask, as numpy arrays.
    layer: its ``layer`` dict (``hops_layer``, ``outer_map``: (D, Npad)
        blocks) or None where off.
    bnd, bnd_rep, distance_tolerance: its ``_bnd_shard`` and
        ``_bnd_rep`` dicts with numpy values and its scaled distance
        tolerance (``_bnd_scalars["distance_tolerance"]``), or None
        where boundary smoothing is off.
    """
    from smoothmesh_torch.parallel.halo import HaloSmoother

    return _union_state_from_jax(
        HaloSmoother, mesh, n_shards, points, params, center, scale,
        device, dtype, normals, smoothing_surface, layer, bnd, bnd_rep,
        distance_tolerance)


def sharded_state_from_jax(mesh, n_shards: int, points, params: Mapping,
                           center, scale: float, device=None, dtype=None,
                           normals=None, smoothing_surface=None,
                           layer: Optional[Mapping] = None,
                           bnd: Optional[Mapping] = None,
                           bnd_rep: Optional[Mapping] = None,
                           distance_tolerance: Optional[float] = None):
    """A :class:`~smoothmesh_torch.parallel.sharded.ShardedSmoother` on
    ``device`` from a JAX ``ShardedSmoother``'s state, to continue its
    run: the arguments of :func:`halo_state_from_jax`, read off the JAX
    class (its ``points``, ``normals`` and ``smoothing_surface`` are
    (D, Npad, ...) blocks; ``layer`` its ``layer`` dict; ``bnd`` and
    ``bnd_rep`` its ``bnd`` dict's per-shard blocks and replicated
    target geometry, ``distance_tolerance`` its ``bnd``'s)."""
    from smoothmesh_torch.parallel.sharded import ShardedSmoother

    return _union_state_from_jax(
        ShardedSmoother, mesh, n_shards, points, params, center, scale,
        device, dtype, normals, smoothing_surface, layer, bnd, bnd_rep,
        distance_tolerance)


def _union_state_from_jax(cls, mesh, n_shards, points, params, center,
                          scale, device, dtype, normals, smoothing_surface,
                          layer, bnd, bnd_rep, distance_tolerance):
    from smoothmesh_torch.device import resolve_device

    pfields = {f.name for f in dataclasses.fields(SmoothingParams)}
    resolved = SmoothingParams(**{k: v for k, v in params.items()
                                  if k in pfields})
    sm = cls.__new__(cls)
    sm.trace = Trace()
    sm.group = None
    sm._build(mesh, n_shards)
    un = sm.union
    sm._start(un.rows(np.asarray(points, dtype=np.float64)), resolved,
              center, scale, resolve_device(device), dtype)
    if sm._will_layer and layer is None:
        raise ValueError(
            "layer_patches match a patch of the mesh, so the JAX "
            "smoother blends layers: pass its layer dict as layer=")
    if normals is not None:
        sm.normals = sm._tensor(un.rows(np.asarray(normals)), sm.dtype)
    if smoothing_surface is not None:
        sm.smoothing_surface = sm._tensor(
            un.rows(np.asarray(smoothing_surface)), torch.bool)
    if layer is not None:
        sm._set_layer({k: np.asarray(v) for k, v in layer.items()})
    if bnd is not None:
        sm._set_boundary({k: np.asarray(v) for k, v in bnd.items()},
                         {k: np.asarray(v) for k, v in bnd_rep.items()},
                         float(distance_tolerance))
    if layer is not None or bnd is not None:
        sm._stage_normals_tables()
    return sm
