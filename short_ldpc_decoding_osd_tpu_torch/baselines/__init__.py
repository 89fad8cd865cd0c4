from . import common, conventional, fs_osd, pb_osd
from .conventional import conventional_osd, miracle_fer_floor, miracle_view
from .fs_osd import fs_osd as run_fs_osd
from .pb_osd import pb_osd as run_pb_osd

__all__ = [
    "common",
    "conventional",
    "fs_osd",
    "pb_osd",
    "conventional_osd",
    "miracle_view",
    "miracle_fer_floor",
    "run_fs_osd",
    "run_pb_osd",
]
