from .metrics import DecodeStats, wilson_interval
from .profiling import JsonlLogger, Timer

__all__ = ["DecodeStats", "wilson_interval", "JsonlLogger", "Timer"]
