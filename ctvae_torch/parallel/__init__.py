"""Data parallelism over ``torch.distributed`` ranks (``mesh.py``)."""

from .mesh import *  # noqa: F401,F403
from .mesh import __all__  # noqa: F401
