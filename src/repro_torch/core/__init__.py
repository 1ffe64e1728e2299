"""Framework-free pieces the port keeps its own copies of."""

from .cid import (CHUNK_SIZE, CID, CODEC_DAG, CODEC_RAW, DAG, ChunkSpec,
                  ManifestEntry, build_dag, build_tree_dag, chunk,
                  dag_reachable, read_dag, reassemble)
from .device import resolve_device
from .safepickle import restricted_loads
from .simnet import Event, Process, Sim, SimError

__all__ = ["CHUNK_SIZE", "CID", "CODEC_DAG", "CODEC_RAW", "DAG", "ChunkSpec",
           "ManifestEntry", "build_dag", "build_tree_dag", "chunk",
           "dag_reachable", "read_dag", "reassemble", "Event", "Process",
           "Sim", "SimError", "resolve_device", "restricted_loads"]
