from .dia import (
    ConvBitwise,
    StopperFcn,
    canonical_dia_name,
    make_dia,
    stopper_engine_params,
)

__all__ = [
    "ConvBitwise",
    "StopperFcn",
    "canonical_dia_name",
    "make_dia",
    "stopper_engine_params",
]
