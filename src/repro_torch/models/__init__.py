"""Model zoo of the port: ``ops_for(cfg)`` returns the entry points that
serving and training program against: the decoder ops for the dense, MoE,
xLSTM (ssm), hybrid and vlm archs, the encoder-decoder ops for audio.

    init(cfg, generator, device, dtype) -> params
    forward(params, cfg, batch)         -> (logits, aux)
    loss_fn(params, cfg, batch)         -> (loss, metrics)
    init_cache(cfg, B, max_len, dtype, device) -> cache
    prefill(params, cfg, batch, c)      -> (logits, cache)
    decode_step(params, cfg, tok, c)    -> (logits, cache)
"""

from dataclasses import dataclass
from typing import Callable

from . import decoder, encdec
from .config import ModelConfig


@dataclass(frozen=True)
class ModelOps:
    init: Callable
    forward: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable


_DECODER_OPS = ModelOps(
    init=decoder.init_params,
    forward=decoder.forward,
    loss_fn=decoder.loss_fn,
    init_cache=decoder.init_cache,
    prefill=decoder.prefill,
    decode_step=decoder.decode_step,
)

_ENCDEC_OPS = ModelOps(
    init=encdec.init_params,
    forward=encdec.forward,
    loss_fn=encdec.loss_fn,
    init_cache=encdec.init_cache,
    prefill=encdec.prefill,
    decode_step=encdec.decode_step,
)


def ops_for(cfg: ModelConfig) -> ModelOps:
    if cfg.arch == "audio":
        return _ENCDEC_OPS
    decoder.require_ported(cfg)
    return _DECODER_OPS


__all__ = ["ModelConfig", "ModelOps", "ops_for", "decoder", "encdec"]
