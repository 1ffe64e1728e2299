"""Serving on the port: the continuous-batching engine, the single-process
generation engine and the shard module they drive."""

from .batch import BatchEngine, KVPool
from .engine import GenerationEngine
from .sharded import ShardModule, plan_shards, split_params

__all__ = ["BatchEngine", "KVPool", "GenerationEngine", "ShardModule",
           "plan_shards", "split_params"]
