"""Model zoo of the port: ``ops_for(cfg)`` returns the entry points that
serving programs against.  The dense and MoE decoders are ported so far.

    init(cfg, generator, device, dtype) -> params
    forward(params, cfg, batch)         -> (logits, aux)
    init_cache(cfg, B, max_len, dtype, device) -> cache
    prefill(params, cfg, batch, c)      -> (logits, cache)
    decode_step(params, cfg, tok, c)    -> (logits, cache)
"""

from dataclasses import dataclass
from typing import Callable

from . import decoder
from .config import ModelConfig


@dataclass(frozen=True)
class ModelOps:
    init: Callable
    forward: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


_DECODER_OPS = ModelOps(
    init=decoder.init_params,
    forward=decoder.forward,
    init_cache=decoder.init_cache,
    prefill=decoder.prefill,
    decode_step=decoder.decode_step,
)


def ops_for(cfg: ModelConfig) -> ModelOps:
    decoder.require_ported(cfg)
    return _DECODER_OPS


__all__ = ["ModelConfig", "ModelOps", "ops_for", "decoder"]
