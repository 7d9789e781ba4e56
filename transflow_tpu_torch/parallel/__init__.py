"""Device layouts of the port: the ``space`` mesh and the ``(stream,
space)`` mesh."""
from .mesh import (SpaceMesh, StreamMesh, exchange_rows, make_mesh,
                   make_space_mesh, mesh_device, parse_mesh_spec,
                   shard_model_inputs, sharded_scan)
from .multihost import global_mesh_grid

__all__ = ["SpaceMesh", "StreamMesh", "exchange_rows", "global_mesh_grid",
           "make_mesh", "make_space_mesh", "mesh_device", "parse_mesh_spec",
           "shard_model_inputs", "sharded_scan"]
