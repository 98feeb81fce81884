"""Data parallelism over ``torch.distributed`` ranks (``mesh.py``) and
its fully sharded form (``fsdp.py``)."""

from .fsdp import FSDP, fully_shard  # noqa: F401
from .mesh import *  # noqa: F401,F403
from .mesh import __all__ as _mesh_all

__all__ = list(_mesh_all) + ["FSDP", "fully_shard"]
