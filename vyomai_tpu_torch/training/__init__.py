from .trainer import (  # noqa: F401
    MetricLogger, Optimizer, Trainer, TrainState, create_train_state,
    make_optimizer, make_train_step)
