from smoothmesh_torch.io.polymesh import PolyMesh, read_polymesh, write_polymesh  # noqa: F401
