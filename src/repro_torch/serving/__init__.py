"""Serving on the port: the continuous-batching engine, the single-process
generation engine, and the serving fleet over the port's mesh (pipeline
shard servers, the shard-aware client, load-aware routing and replicas
spawned under pressure), exporting what ``repro.serving`` exports and the
port's shard module, KV pool and parameter split beside them."""

from .engine import GenerationEngine
from .batch import BatchEngine, KVPool
from .router import LoadAwareRouter, hedged_call
from .pressure import PressureMonitor, load_publisher, publish_serving_plan
from .sharded import (InferenceService, InferenceV2Service, ShardClient,
                      ShardModule, ShardServer, deploy_sharded, plan_shards,
                      serve_fleet, split_params)

__all__ = ["GenerationEngine", "BatchEngine", "LoadAwareRouter",
           "hedged_call", "PressureMonitor", "load_publisher",
           "publish_serving_plan", "ShardClient", "ShardServer",
           "plan_shards", "deploy_sharded", "serve_fleet",
           "InferenceService", "InferenceV2Service", "ShardModule", "KVPool",
           "split_params"]
