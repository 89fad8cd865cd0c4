"""DIA (decoding-information-aggregation) reliability refiner + stopper.

Port of ``short_ldpc_decoding_osd_tpu/models/dia.py:27-84,172-227`` as
``nn.Module``s that own their weights:

* ``ConvBitwise`` — per-bit 1-D CNN over the (T+1)-step trajectory:
  Conv1d(1->8, k3, valid) -> Conv1d(8->4) -> Conv1d(4->2) -> flatten ->
  Linear(1), all linear, no conv biases (``DL_Training_serial/nn_net.py:173-207``).
* ``StopperFcn`` — Linear(w+1, no bias) -> Linear(2, no bias) -> softmax
  (``nn_net.py:136-148``).

Layout: flax flattens the conv output (N, time, channel); a torch
``Conv1d`` yields (N, channel, time), so ``ConvBitwise`` permutes before
flattening and the head weights keep the JAX package's order
(``convert.from_jax_params``).  The RNN refiners (``RnnOne``/``RnnTwo``) are
not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class ConvBitwise(nn.Module):
    """Per-bit CNN over iteration trajectories."""

    def __init__(self, n: int, list_length: int):
        super().__init__()
        self.n = n
        self.list_length = list_length  # T+1
        self.conv1 = nn.Conv1d(1, 8, 3, bias=False)
        self.conv2 = nn.Conv1d(8, 4, 3, bias=False)
        self.conv3 = nn.Conv1d(4, 2, 3, bias=False)
        self.head = nn.Linear(2 * (list_length - 6), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, 1, T+1) per-bit trajectories -> (N,) refined values."""
        x = self.conv3(self.conv2(self.conv1(x)))  # (N, 2, T-5)
        x = x.permute(0, 2, 1).reshape(x.shape[0], -1)  # flax (time, channel)
        return self.head(x)[:, 0]

    def refine(self, trajectories: torch.Tensor) -> torch.Tensor:
        """(B, T+1, n) trajectories -> (B, n) refined reliabilities."""
        batch = trajectories.shape[0]
        per_bit = trajectories.permute(0, 2, 1).reshape(
            batch * self.n, 1, self.list_length)
        return self.forward(per_bit).reshape(batch, self.n)

    @torch.no_grad()
    def effective_filter(self):
        """The fully linear conv stack composed into one (T+1,) tap vector
        and a scalar bias: push the T+1 basis trajectories and the zero
        trajectory through :meth:`forward`."""
        t = self.list_length
        weight = self.conv1.weight
        basis = torch.cat([torch.eye(t, dtype=weight.dtype, device=weight.device),
                           torch.zeros((1, t), dtype=weight.dtype,
                                       device=weight.device)])
        out = self.forward(basis[:, None, :])
        bias = out[t]
        return out[:t] - bias, bias

    @torch.no_grad()
    def refine_fast(self, trajectories: torch.Tensor) -> torch.Tensor:
        """Inference-only refine via the composed filter: a 13-tap f32
        contraction over the iteration axis (elementwise multiply + sum, so
        no TF32 path can truncate the operands), not three convolutions."""
        taps, bias = self.effective_filter()
        return (trajectories * taps[None, :, None]).sum(1) + bias


class StopperFcn(nn.Module):
    """Sliding-window early-termination classifier."""

    def __init__(self, input_width: int):
        super().__init__()
        self.input_width = input_width  # window + 1
        self.dense1 = nn.Linear(input_width, input_width, bias=False)
        self.dense2 = nn.Linear(input_width, 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.dense2(self.dense1(x)), dim=-1)


DIA_MODELS = {"model_cnn": ConvBitwise}

# the reference's CNN/RNN1/RNN2 spellings and the nn_net.py builder names
DIA_ALIASES = {
    "cnn": "model_cnn",
    "rnn_one": "model_rnn1",
    "rnn_two": "model_rnn2",
    "rnn1": "model_rnn1",
    "rnn2": "model_rnn2",
}
_KNOWN = ("model_cnn", "model_rnn1", "model_rnn2")


def canonical_dia_name(kind: str) -> str:
    """Resolve a DIA model name (or alias) to its registry key."""
    name = DIA_ALIASES.get(kind, kind)
    if name not in _KNOWN:
        raise ValueError(
            f"unknown DIA model {kind!r}; expected one of "
            f"{sorted(_KNOWN) + sorted(DIA_ALIASES)}"
        )
    return name


def make_dia(kind: str, n: int, list_length: int) -> nn.Module:
    """Construct a DIA model by reference prefix name (aliases accepted)."""
    kind = canonical_dia_name(kind)
    if kind not in DIA_MODELS:
        raise NotImplementedError(f"{kind} is not ported yet (model_cnn is)")
    if list_length < 7:
        # three valid-padding k=3 convs consume 6 steps (nn_net.py:190-196)
        raise ValueError(
            f"model_cnn needs list_length (BP iterations + 1) >= 7, got "
            f"{list_length}; use >= 6 decoding iterations"
        )
    return DIA_MODELS[kind](n=n, list_length=list_length)


def stopper_engine_params(stopper: StopperFcn) -> dict:
    """The plain {w1, w2} dict (x @ w layout) the OSD engine consumes."""
    return {"w1": stopper.dense1.weight.detach().T.contiguous(),
            "w2": stopper.dense2.weight.detach().T.contiguous()}
