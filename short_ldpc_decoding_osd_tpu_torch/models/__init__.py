from . import extras
from .dia import (
    DIA_ALIASES,
    DIA_MODELS,
    ConvBitwise,
    RnnOne,
    RnnTwo,
    StopperFcn,
    canonical_dia_name,
    dia_loss,
    init_flax_,
    make_dia,
    stopper_engine_params,
)

__all__ = [
    "extras",
    "DIA_ALIASES",
    "DIA_MODELS",
    "ConvBitwise",
    "RnnOne",
    "RnnTwo",
    "StopperFcn",
    "canonical_dia_name",
    "dia_loss",
    "init_flax_",
    "make_dia",
    "stopper_engine_params",
]
