"""Training slice of the port: optimizers, train state and steps, loop."""

from .experiment import VAEXperiment, install_preemption_handler
from .optimizers import build_lr_schedules, build_optimizers
from .state import (TrainState, create_train_state, make_eval_step,
                    make_multi_train_step, make_train_step)

__all__ = ["TrainState", "VAEXperiment", "build_lr_schedules",
           "build_optimizers", "create_train_state",
           "install_preemption_handler", "make_eval_step",
           "make_multi_train_step", "make_train_step"]
