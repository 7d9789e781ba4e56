"""Device layouts of the port: the ``space`` mesh, the ``(stream,
space)`` mesh, and that mesh across processes (``torch.distributed``)."""
from .mesh import (RemoteRow, SpaceMesh, StreamMesh, exchange_rows,
                   make_mesh, make_space_mesh, mesh_device, parse_mesh_spec,
                   shard_model_inputs, sharded_scan)
from .multihost import global_mesh_grid, initialize, make_global_mesh

__all__ = ["RemoteRow", "SpaceMesh", "StreamMesh", "exchange_rows",
           "global_mesh_grid", "initialize", "make_global_mesh", "make_mesh",
           "make_space_mesh", "mesh_device", "parse_mesh_spec",
           "shard_model_inputs", "sharded_scan"]
