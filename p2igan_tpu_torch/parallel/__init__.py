"""Data parallelism over the mesh's ``data`` axis (one process a device)."""

from .mesh import DataMesh, create_mesh, pad_to_multiple, shard_rows, shutdown

__all__ = ["DataMesh", "create_mesh", "pad_to_multiple", "shard_rows", "shutdown"]
