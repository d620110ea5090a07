from smoothmesh_torch.utils.debug import export_edges_as_stl  # noqa: F401
