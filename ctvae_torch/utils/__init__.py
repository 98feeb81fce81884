"""Services of the training loop: checkpoints and image files."""

from .checkpoint import CheckpointManager, load_weights_only
from .images import make_grid, save_image, to_uint8

__all__ = ["CheckpointManager", "load_weights_only", "make_grid",
           "save_image", "to_uint8"]
