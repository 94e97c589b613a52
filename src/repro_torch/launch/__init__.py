"""Launch layer: the meshes of ranks that the sharded path runs on."""
from repro_torch.launch.mesh import (
    Mesh, MeshError, make_host_mesh, make_mesh, resolve_mesh,
)

__all__ = ["Mesh", "MeshError", "make_host_mesh", "make_mesh",
           "resolve_mesh"]
