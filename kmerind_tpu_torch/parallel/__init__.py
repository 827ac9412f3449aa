"""Owner routing of rows between shards, and the shard layout over ranks
(`make_mesh`)."""

from . import distribute, mesh
from .mesh import make_mesh

__all__ = ["distribute", "mesh", "make_mesh"]
