"""Frames, failures and training batches split over ranks of
``torch.distributed`` (port of ``short_ldpc_decoding_osd_tpu/parallel/``)."""

from .data_parallel import (
    device_seeds,
    sharded_dl_osd_step,
    sharded_dl_osd_step_from_llr,
    sharded_fused_mc_step,
    sharded_nms_mc_step,
    sharded_nms_train_step,
    sharded_seed_counters,
)
from .mesh import Mesh, init_multihost, make_mesh

__all__ = [
    "device_seeds",
    "sharded_dl_osd_step",
    "sharded_dl_osd_step_from_llr",
    "init_multihost",
    "make_mesh",
    "sharded_fused_mc_step",
    "sharded_nms_mc_step",
    "sharded_nms_train_step",
    "sharded_seed_counters",
]
