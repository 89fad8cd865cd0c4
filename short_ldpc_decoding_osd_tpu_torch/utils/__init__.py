from .dtypes import count_dtype
from .metrics import DecodeStats, wilson_interval
from .profiling import JsonlLogger, Timer, flops_estimate, trace

__all__ = ["DecodeStats", "wilson_interval", "JsonlLogger", "Timer",
           "count_dtype", "flops_estimate", "trace"]
