"""The Monte-Carlo scaling axis over ``torch.distributed``.

Port of ``short_ldpc_decoding_osd_tpu/parallel/mesh.py``.  JAX builds a
1-D device mesh (the 'mc' axis) and lets XLA insert ``psum``; here one rank
is one process on one device, the mesh is the process group, and the steps
of ``data_parallel`` sum their counters or gradients with
:meth:`Mesh.all_reduce_sum`.  Parameters are replicated: every rank holds
the same values and applies the same update.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks; this process is ``rank`` and runs on
    ``device``.  ``group`` is the process group (None for a world of one)."""

    group: object
    size: int
    rank: int
    device: torch.device
    axis_name: str = "mc"

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place, and return it (the identity
        for a world of one)."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def _rank_device(device) -> torch.device:
    """``device`` with a CUDA index filled in from the current device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, axis_name: str = "mc",
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh over the initialised default process group, or a world of
    one when ``torch.distributed`` is not initialised.

    A rank is one device, so the mesh spans the whole group: ``n_devices``
    (None: the world) must equal the world size.  More raises JAX's
    ``ValueError`` ("requested N devices, only M visible"); fewer raises
    too, where JAX would take the first N devices, because the ranks left
    out would have no step to run (start fewer processes instead).
    ``device`` is this rank's device; a CUDA device without an index is
    the current one (``init_multihost`` sets it from the process id)."""
    dev = _rank_device(device)
    if dist.is_available() and dist.is_initialized():
        group, world, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    else:
        group, world, rank = None, 1, 0
    if n_devices is not None:
        if n_devices > world:
            raise ValueError(
                f"requested {n_devices} devices, only {world} visible")
        if n_devices < world:
            raise ValueError(
                f"requested {n_devices} devices of a world of {world}: a mesh "
                "spans every rank of the process group")
    return Mesh(group=group if world > 1 else None, size=world, rank=rank,
                device=dev, axis_name=axis_name)


def init_multihost(coordinator: str | None = None, num_processes: int = 1,
                   process_id: int = 0, backend: str | None = None,
                   device: str | torch.device = "cuda") -> None:
    """Join the process group of a multi-process run.

    A no-op for a single process (``num_processes <= 1`` or no
    coordinator), as in JAX.  Otherwise ``dist.init_process_group`` over
    ``tcp://{coordinator}`` (``host:port`` of process 0) with this
    process's rank.  The backend is NCCL for a CUDA ``device`` and gloo for
    the CPU unless ``backend`` names one; NCCL that is not available
    raises, and no other backend is taken in its place.  On CUDA the
    process's current device becomes ``process_id % device_count`` (one
    card a process; two gloo processes on one card share it)."""
    if coordinator is None or num_processes <= 1:
        return
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        # before resolve_device makes a context on the current device
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dev = resolve_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("backend 'nccl' requested but this torch has no NCCL")
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
