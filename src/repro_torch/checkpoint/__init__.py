"""The checkpoint format, byte for byte that of the JAX package (canonical
bytes, parts and local files), and checkpoints published and fetched over
the port's Lattica mesh (``lattica_ckpt``)."""

from .serial import (leaf_from_part, params_from_bytes, params_from_parts,
                     params_to_bytes, params_to_parts)
from .lattica_ckpt import (CheckpointRegistry, CheckpointService,
                           checkpoint_delta, fetch_checkpoint, fetch_latest,
                           fetch_latest_from, publish_checkpoint,
                           serve_checkpoints)
from .local import load_local, save_local

__all__ = ["params_to_bytes", "params_from_bytes", "params_to_parts",
           "params_from_parts", "leaf_from_part", "CheckpointRegistry",
           "CheckpointService", "checkpoint_delta", "publish_checkpoint",
           "fetch_checkpoint", "fetch_latest", "fetch_latest_from",
           "serve_checkpoints", "save_local", "load_local"]
