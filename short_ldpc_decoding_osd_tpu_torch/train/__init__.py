from .nms_train import NMSTrainConfig, train_nms
from .optim import StaircaseAdam, clip_each_by_norm_

__all__ = ["NMSTrainConfig", "train_nms", "StaircaseAdam", "clip_each_by_norm_"]
