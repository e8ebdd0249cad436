from streamyolo_torch.train.lr import build_lr_schedule, yolox_warm_cos_lr
from streamyolo_torch.train.optimizer import param_groups, sgd_optimizer
from streamyolo_torch.train.step import (
    ModelEMA,
    TrainState,
    create_train_state,
    load_carried_state,
    make_train_step,
)

__all__ = ["ModelEMA", "TrainState", "build_lr_schedule", "create_train_state",
           "load_carried_state", "make_train_step", "param_groups", "sgd_optimizer",
           "yolox_warm_cos_lr"]
