"""Multi-device execution (the reference's ``repro.dist``), so far only
the pure mesh-description helpers the facade's specs validate with.
``DeviceMesh`` and the mesh runner come with the port of the mesh runtime
(ROADMAP queue 1, item 11)."""
from repro_torch.dist.mesh import MeshAxes, mesh_str, normalize_mesh, parse_mesh

__all__ = ["MeshAxes", "parse_mesh", "normalize_mesh", "mesh_str"]
