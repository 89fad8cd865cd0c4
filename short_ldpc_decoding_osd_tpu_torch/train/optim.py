"""The reference's optimizer on ``torch.optim``.

Port of ``short_ldpc_decoding_osd_tpu/train/optim.py``: per-tensor norm
clipping (``clip_each_by_norm``, :10-27, the analogue of looping
``tf.clip_by_norm`` over the gradients, ``ms_decoder_dense.py:321``), then
Adam with a staircase exponential learning-rate decay (``staircase_adam``,
:30-43; ``globalmap.py:99-105``).
"""

from __future__ import annotations

import torch


def clip_each_by_norm_(grads, max_norm: float) -> None:
    """Scale each gradient tensor in place to an L2 norm of at most
    ``max_norm``."""
    with torch.no_grad():
        for g in grads:
            norm = torch.sqrt(torch.sum(torch.square(g)))
            g.mul_(torch.where(norm > max_norm, max_norm / (norm + 1e-30), 1.0))


class StaircaseAdam:
    """Clip each gradient, then an Adam step (b1 0.9, b2 0.999, eps 1e-8,
    as optax's defaults) at ``initial_lr * decay_rate ** (t //
    decay_steps)`` for update t = 0, 1, ..."""

    def __init__(self, params, initial_lr: float, decay_steps: int,
                 decay_rate: float, clip_norm: float):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.adam = torch.optim.Adam(self.params, lr=initial_lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adam, lambda t: decay_rate ** (t // decay_steps))

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=False)

    def step(self) -> None:
        """One update from the gradients accumulated in ``.grad``."""
        clip_each_by_norm_([p.grad for p in self.params if p.grad is not None],
                           self.clip_norm)
        self.adam.step()
        self.schedule.step()

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(),
                "schedule": self.schedule.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.schedule.load_state_dict(state["schedule"])
