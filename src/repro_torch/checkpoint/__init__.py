"""The checkpoint format: canonical bytes, parts and local files, byte for
byte those of the JAX package.  Publishing over the mesh
(``lattica_ckpt``) waits for the port's copy of the mesh core."""

from .serial import (leaf_from_part, params_from_bytes, params_from_parts,
                     params_to_bytes, params_to_parts)
from .local import load_local, save_local

__all__ = ["params_to_bytes", "params_from_bytes", "params_to_parts",
           "params_from_parts", "leaf_from_part", "save_local", "load_local"]
