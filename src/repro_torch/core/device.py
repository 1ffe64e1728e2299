"""Device selection for the port's entry points.

Entry points default to ``"cuda"``.  Asking for the card on a machine
without one raises: the port never quietly runs on the CPU.  Callers that
want the CPU (the tests) say ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain versions on the CPU")
        if dev.index is None:         # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
