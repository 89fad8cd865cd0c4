from .dia_train import DIATrainConfig, pattern_statistics_sweep, train_dia
from .nms_train import NMSTrainConfig, train_nms
from .optim import StaircaseAdam, clip_each_by_norm_
from .stopper_train import (
    StopperTrainConfig,
    generate_stopper_samples,
    reform_windows,
    stopper_loss,
    train_stopper,
)

__all__ = [
    "DIATrainConfig",
    "train_dia",
    "pattern_statistics_sweep",
    "NMSTrainConfig",
    "train_nms",
    "StaircaseAdam",
    "clip_each_by_norm_",
    "StopperTrainConfig",
    "generate_stopper_samples",
    "reform_windows",
    "stopper_loss",
    "train_stopper",
]
