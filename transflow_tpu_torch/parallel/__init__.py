"""Device layouts of the port: the one-axis ``space`` mesh."""
from .mesh import (SpaceMesh, exchange_rows, make_space_mesh, mesh_device,
                   parse_mesh_spec)
from .multihost import global_mesh_grid

__all__ = ["SpaceMesh", "exchange_rows", "global_mesh_grid",
           "make_space_mesh", "mesh_device", "parse_mesh_spec"]
