"""Carry a smoother's state across from the JAX package.

:func:`state_from_jax` builds this package's :class:`Smoother` from
plain numpy and Python values read off a ``smoothmesh_tpu`` smoother,
so both can run on from one identical state.  Nothing here imports the
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
