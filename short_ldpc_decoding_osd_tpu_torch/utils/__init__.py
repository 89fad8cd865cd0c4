from .metrics import DecodeStats, wilson_interval

__all__ = ["DecodeStats", "wilson_interval"]
