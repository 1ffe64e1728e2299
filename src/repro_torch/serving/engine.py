"""Single-process generation engine: prefill + greedy/temperature decode."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..models import ModelOps, ops_for
from ..models.config import ModelConfig
from .sharded import params_device


class GenerationEngine:
    def __init__(self, cfg: ModelConfig, params: Any, max_len: int = 4096,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        if params_device(params) != self.device:
            raise ValueError(f"params live on {params_device(params)}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ops: ModelOps = ops_for(cfg)
        self.max_len = max_len
        self.dtype = dtype

    def generate(self, batch: Dict[str, Any], n_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Greedy (``temperature == 0``) or sampled continuation of
        ``batch["tokens"]`` (B, S).  Sampling draws from ``generator``, or
        from a fresh one seeded with ``seed`` on the engine's device."""
        tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=self.device)
        B, S = tokens.shape
        cache = self.ops.init_cache(self.cfg, B, S + n_tokens, self.dtype,
                                    self.device)
        logits, cache = self.ops.prefill(self.params, self.cfg,
                                         {"tokens": tokens}, cache)
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        for i in range(n_tokens):
            if temperature > 0:
                probs = torch.softmax(logits.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            tok = tok.to(torch.int32)
            out.append(tok.cpu().numpy())
            if i + 1 < n_tokens:
                logits, cache = self.ops.decode_step(self.params, self.cfg,
                                                     tok, cache)
        return np.stack(out, axis=1), {"generated": n_tokens * B}
