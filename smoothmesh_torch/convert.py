"""Carry a smoother's state across from the JAX package.

:func:`state_from_jax` builds this package's :class:`Smoother` from
plain numpy and Python values read off a ``smoothmesh_tpu`` smoother,
so both can run on from one identical state.  Nothing here imports the
JAX package: the caller reads its values.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.mesh.topology import MeshTopology
from smoothmesh_torch.params import SmoothingParams


def state_from_jax(points, topo_arrays: Mapping, params: Mapping, center,
                   scale: float, device=None, dtype=None) -> Smoother:
    """A :class:`Smoother` on ``device`` from the JAX smoother's state.

    points: its internal normalized points (``np.asarray(sm.points)``).
    topo_arrays: its ``MeshTopology`` fields by name (numpy arrays and
        the scalar/tuple fields as they are).
    params: its resolved ``SmoothingParams`` as a dict.
    center, scale: its ``_center`` and ``_scale``.

    The points stay in the topology's order, so ``denormalize()`` maps
    back to external coordinates without reordering.
    """
    names = {f.name for f in dataclasses.fields(MeshTopology)}
    topo = MeshTopology(**{k: topo_arrays[k] for k in names})
    pfields = {f.name for f in dataclasses.fields(SmoothingParams)}
    resolved = SmoothingParams(**{k: v for k, v in params.items()
                                  if k in pfields})
    sm = Smoother.__new__(Smoother)
    sm.mesh = None
    sm._setup(topo, np.asarray(points, dtype=np.float64), resolved,
              center, scale, device, dtype, orders=None)
    return sm
