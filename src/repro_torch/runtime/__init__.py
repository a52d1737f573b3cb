"""Runtime: the Program executor and the training loop."""
from .executor import cached_runner, run
from .trainer import Trainer, TrainerConfig

__all__ = ["run", "cached_runner", "Trainer", "TrainerConfig"]
