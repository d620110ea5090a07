from smoothmesh_torch.io.polymesh import PolyMesh, read_polymesh, write_polymesh  # noqa: F401
from smoothmesh_torch.io.obj import read_obj_surface, read_obj_edges  # noqa: F401
