"""Launch layer: the meshes of ranks that the sharded path runs on.

The drivers are modules run with ``python -m``: ``serve_communities``
(the community service's CLI), ``train`` and ``serve`` (the model
scaffold's trainers and LM server)."""
from repro_torch.launch.mesh import (
    Mesh, MeshError, make_host_mesh, make_mesh, resolve_mesh,
)

__all__ = ["Mesh", "MeshError", "make_host_mesh", "make_mesh",
           "resolve_mesh"]
