from .step import TrainState, make_train_step, train_state_init
from .trainer import Trainer, LatticaSyncTrainer

__all__ = ["TrainState", "make_train_step", "train_state_init",
           "Trainer", "LatticaSyncTrainer"]
