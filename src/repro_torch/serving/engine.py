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
        from a fresh one seeded with ``seed`` on the engine's device.

        The whole batch goes to ``prefill``: a vlm's ``vision_embeds``
        (B, n_patches, D) and ``positions3`` (3, B, n_patches + S), whose
        patches the cache is sized for, or an encoder-decoder's ``frames``
        (B, enc_seq, d_source)."""
        dev = self.device
        inputs = {k: torch.as_tensor(
            v if isinstance(v, torch.Tensor) else np.asarray(v), device=dev)
            for k, v in batch.items()}
        B, S = inputs["tokens"].shape
        extra = self.cfg.n_patches if self.cfg.arch == "vlm" else 0
        cache = self.ops.init_cache(self.cfg, B, S + extra + n_tokens,
                                    self.dtype, dev)
        logits, cache = self.ops.prefill(self.params, self.cfg, inputs, cache)
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
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
