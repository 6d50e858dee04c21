"""The traced training path: the train step and the fault-tolerant trainer."""

from .train_step import TrainConfig, build_train_step, init_state  # noqa: F401
from .trainer import (  # noqa: F401
    StragglerReport,
    StragglerWatchdog,
    Trainer,
    TrainerConfig,
)
