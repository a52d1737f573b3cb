"""Runtime: the Program executor and the training loop."""
from .executor import disable_graphs, graphed_runner, run
from .trainer import Trainer, TrainerConfig

__all__ = ["run", "graphed_runner", "disable_graphs", "Trainer",
           "TrainerConfig"]
