"""Training loop: the JAX package's plain local ``Trainer``.

``LatticaSyncTrainer`` and ``ModelSubscriber`` publish into the Lattica mesh
and wait for the port's copy of the mesh core.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from ..models.config import ModelConfig
from .step import TrainState, make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, state: TrainState,
                 schedule: Callable[[int], float],
                 data: Iterator[Dict[str, np.ndarray]], microbatches: int = 1):
        self.cfg = cfg
        self.state = state
        self.data = data
        self.step_fn = make_train_step(cfg, schedule, microbatches=microbatches)
        self.history: List[Dict[str, float]] = []

    def run(self, n_steps: int, log_every: int = 10,
            log: Optional[Callable[[str], None]] = print
            ) -> List[Dict[str, float]]:
        for i in range(n_steps):
            batch = next(self.data)
            self.state, metrics = self.step_fn(self.state, batch)
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = i
            self.history.append(rec)
            if log is not None and (i % log_every == 0 or i == n_steps - 1):
                log(f"step {i:5d}  loss={rec['loss']:.4f}  "
                    f"lr={rec['lr']:.2e}  gnorm={rec['grad_norm']:.2f}")
        return self.history
