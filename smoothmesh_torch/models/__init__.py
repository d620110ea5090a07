"""Model registry (the JAX package's ``smoothmesh_tpu.models``).

The framework's "models" are its smoothing engines: the single-device
:class:`~smoothmesh_torch.driver.Smoother` and the disjoint domain
decomposition's
:class:`~smoothmesh_torch.parallel.sharded.ShardedSmoother`.
"""

from smoothmesh_torch.driver import Smoother  # noqa: F401
from smoothmesh_torch.parallel.sharded import ShardedSmoother  # noqa: F401

REGISTRY = {
    "smoother": Smoother,
    "sharded": ShardedSmoother,
}


def get_model(name: str):
    return REGISTRY[name]
