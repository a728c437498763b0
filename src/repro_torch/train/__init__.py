"""repro_torch.train — train state, the train step, the fault-tolerant loop."""

from .loop import TrainLoop, TrainLoopConfig, build_train_step
from .state import TrainState, make_train_state

__all__ = ["TrainState", "make_train_state", "TrainLoop",
           "TrainLoopConfig", "build_train_step"]
