from smoothmesh_torch.mesh.blockmesh import hex_block, perturb, prism_block  # noqa: F401
from smoothmesh_torch.mesh.topology import MeshTopology, compile_topology  # noqa: F401
