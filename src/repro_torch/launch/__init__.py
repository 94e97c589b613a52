"""Launch layer: the meshes of ranks that the sharded path runs on, the
production meshes, and the step builder (:mod:`.steps`).

The drivers are modules run with ``python -m``: ``serve_communities``
(the community service's CLI), ``train`` and ``serve`` (the model
scaffold's trainers and LM server) and ``dryrun`` (every cell traced on
the production meshes over fake ranks, with its H100 roofline)."""
from repro_torch.launch.mesh import (
    Mesh, MeshError, fake_process_group, flat_axes, make_host_mesh,
    make_mesh, make_production_mesh, resolve_mesh,
)

__all__ = ["Mesh", "MeshError", "make_host_mesh", "make_mesh",
           "resolve_mesh", "make_production_mesh", "flat_axes",
           "fake_process_group"]
