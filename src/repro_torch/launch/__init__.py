"""Launchers of the port: ``python -m repro_torch.launch.solve``, and the
mesh constructors (``launch.mesh``)."""
from .mesh import make_mesh, make_production_mesh

__all__ = ["make_mesh", "make_production_mesh"]
