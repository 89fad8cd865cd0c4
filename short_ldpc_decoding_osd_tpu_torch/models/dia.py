"""DIA (decoding-information-aggregation) reliability refiners + stopper.

Port of ``short_ldpc_decoding_osd_tpu/models/dia.py`` as ``nn.Module``s
that own their weights:

* ``ConvBitwise`` — per-bit 1-D CNN over the (T+1)-step trajectory:
  Conv1d(1->8, k3, valid) -> Conv1d(8->4) -> Conv1d(4->2) -> flatten ->
  Linear(1), all linear, no conv biases (``DL_Training_serial/nn_net.py:173-207``).
* ``RnnOne`` — linear GRU(n) -> linear GRU(n) -> Linear(n, no bias) over the
  (B, T+1, n) sequence (``nn_net.py:386-418``).
* ``RnnTwo`` — linear SimpleRNN(n) x2 -> Linear(n, no bias)
  (``nn_net.py:420-453``).
* ``StopperFcn`` — Linear(w+1, no bias) -> Linear(2, no bias) -> softmax
  (``nn_net.py:136-148``).

Layout: flax flattens the conv output (N, time, channel); a torch
``Conv1d`` yields (N, channel, time), so ``ConvBitwise`` permutes before
flattening and the head weights keep the JAX package's order
(``convert.from_jax_params``).  The recurrent cells keep JAX's ``x @ w``
kernels as they are: ``wi`` (d, 3F) and ``wh`` (F, 3F), gates split
(z, r, c).  ``torch.nn.GRU`` cannot stand in: it applies ``tanh`` to the
candidate, orders its gates (r, z, n) and has biases.

Every forward runs in IEEE f32 (``_device.full_f32``).  :func:`init_flax_`
draws flax's initial weights from a seeded generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .._device import full_f32
from .extras import _LSTM, RnnThree, TemperatureLayer, _LayerNorm


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

    @full_f32()
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


class _LinearGRU(nn.Module):
    """GRU with a linear candidate and no biases (JAX ``models/dia.py:87-113``):
    z = sigmoid(x wi_z + h wh_z), r = sigmoid(x wi_r + h wh_r),
    cand = x wi_c + r * (h wh_c), h' = z h + (1 - z) cand."""

    def __init__(self, d: int, features: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(d, 3 * features))
        self.wh = nn.Parameter(torch.zeros(features, 3 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, d) -> (B, T, features), the state after each step."""
        features = self.wh.shape[0]
        gi = x @ self.wi  # every step's input projection at once
        h = x.new_zeros((x.shape[0], features))
        seq = []
        for t in range(x.shape[1]):
            iz, ir, ic = gi[:, t].split(features, dim=-1)
            hz, hr, hc = (h @ self.wh).split(features, dim=-1)
            z = torch.sigmoid(iz + hz)
            r = torch.sigmoid(ir + hr)
            h = z * h + (1.0 - z) * (ic + r * hc)
            seq.append(h)
        return torch.stack(seq, 1)


class _LinearSimpleRNN(nn.Module):
    """SimpleRNN with linear activation and no biases (JAX
    ``models/dia.py:116-133``): h' = x wi + h wh."""

    def __init__(self, d: int, features: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(d, features))
        self.wh = nn.Parameter(torch.zeros(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gi = x @ self.wi
        h = x.new_zeros((x.shape[0], self.wh.shape[0]))
        seq = []
        for t in range(x.shape[1]):
            h = gi[:, t] + h @ self.wh
            seq.append(h)
        return torch.stack(seq, 1)


class _Rnn(nn.Module):
    """Two recurrent layers over the (B, T+1, n) sequence, then a bias-free
    Linear(n) of the last state."""

    cell = None  # the recurrent layer class
    names = ()  # its two layers' names, the JAX package's parameter keys

    def __init__(self, n: int, list_length: int):
        super().__init__()
        self.n = n
        self.list_length = list_length
        for name in self.names:
            setattr(self, name, self.cell(n, n))
        self.head = nn.Linear(n, n, bias=False)

    @full_f32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, second = (getattr(self, name) for name in self.names)
        return self.head(second(first(x))[:, -1])

    def refine(self, trajectories: torch.Tensor) -> torch.Tensor:
        """(B, T+1, n) trajectories -> (B, n) refined reliabilities."""
        return self.forward(trajectories)

    @torch.no_grad()
    def refine_fast(self, trajectories: torch.Tensor) -> torch.Tensor:
        """The same map as :meth:`refine`, without autograd (JAX
        ``refine_fast = refine``)."""
        return self.forward(trajectories)


class RnnOne(_Rnn):
    """GRU x2 over the iteration sequence."""

    cell = _LinearGRU
    names = ("gru1", "gru2")


class RnnTwo(_Rnn):
    """SimpleRNN x2 over the iteration sequence."""

    cell = _LinearSimpleRNN
    names = ("rnn1", "rnn2")


class StopperFcn(nn.Module):
    """Sliding-window early-termination classifier."""

    def __init__(self, input_width: int):
        super().__init__()
        self.input_width = input_width  # window + 1
        self.dense1 = nn.Linear(input_width, input_width, bias=False)
        self.dense2 = nn.Linear(input_width, 2, bias=False)

    @full_f32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.dense2(self.dense1(x)), dim=-1)


DIA_MODELS = {"model_cnn": ConvBitwise, "model_rnn1": RnnOne,
              "model_rnn2": RnnTwo}

# the reference's CNN/RNN1/RNN2 spellings and the nn_net.py builder names
DIA_ALIASES = {
    "cnn": "model_cnn",
    "rnn_one": "model_rnn1",
    "rnn_two": "model_rnn2",
    "rnn1": "model_rnn1",
    "rnn2": "model_rnn2",
}


def canonical_dia_name(kind: str) -> str:
    """Resolve a DIA model name (or alias) to its registry key."""
    name = DIA_ALIASES.get(kind, kind)
    if name not in DIA_MODELS:
        raise ValueError(
            f"unknown DIA model {kind!r}; expected one of "
            f"{sorted(DIA_MODELS) + sorted(DIA_ALIASES)}"
        )
    return name


def make_dia(kind: str, n: int, list_length: int) -> nn.Module:
    """Construct a DIA model by reference prefix name (aliases accepted)."""
    kind = canonical_dia_name(kind)
    if kind == "model_cnn" and list_length < 7:
        # three valid-padding k=3 convs consume 6 steps (nn_net.py:190-196)
        raise ValueError(
            f"model_cnn needs list_length (BP iterations + 1) >= 7, got "
            f"{list_length}; use >= 6 decoding iterations or an RNN refiner"
        )
    return DIA_MODELS[kind](n=n, list_length=list_length)


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """flax ``lecun_normal``: a normal truncated at two standard deviations,
    rescaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_flax_(model: nn.Module, seed: int) -> nn.Module:
    """Draw ``model``'s weights as flax initialises the JAX module (another
    random stream, the same distributions), from a CPU generator seeded
    ``seed``, so the card and the CPU start from the same weights: Conv and
    Dense kernels ``lecun_normal``, biases zero, a recurrent cell's input
    kernel ``glorot_uniform`` and its recurrent kernel ``orthogonal``;
    the extras' ``OptimizedLSTMCell`` gate by gate, input kernels
    ``lecun_normal`` and recurrent kernels ``orthogonal``, biases zero;
    LayerNorm scale 1 and bias 0, ``coefficients`` 0, ``temperature`` 1.
    PyTorch's own defaults (kaiming-uniform, nonzero biases) would train
    another refiner.  Returns ``model``."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = torch.empty(module.weight.shape)
            _lecun_normal_(w, module.weight[0].numel(), gen)
            module.weight.copy_(w)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (_LinearGRU, _LinearSimpleRNN)):
            wi, wh = torch.empty(module.wi.shape), torch.empty(module.wh.shape)
            nn.init.xavier_uniform_(wi, generator=gen)
            nn.init.orthogonal_(wh, generator=gen)
            module.wi.copy_(wi)
            module.wh.copy_(wh)
        elif isinstance(module, _LSTM):
            d, f = module.wi.shape[0], module.features
            for g in range(4):
                wi, wh = torch.empty(d, f), torch.empty(f, f)
                _lecun_normal_(wi, d, gen)
                nn.init.orthogonal_(wh, generator=gen)
                module.wi[:, g * f:(g + 1) * f] = wi
                module.wh[:, g * f:(g + 1) * f] = wh
            module.bh.zero_()
        elif isinstance(module, _LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, RnnThree):
            module.coefficients.zero_()
        elif isinstance(module, TemperatureLayer):
            module.temperature.fill_(1.0)
    return model


def stopper_engine_params(stopper: StopperFcn) -> dict:
    """The plain {w1, w2} dict (x @ w layout) the OSD engine consumes."""
    return {"w1": stopper.dense1.weight.detach().T.contiguous(),
            "w2": stopper.dense2.weight.detach().T.contiguous()}


def dia_loss(refined: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid CE with logits = -refined, summed over every bit of the
    batch (``nn_training.py:293-297``; a sum, not a mean)."""
    logits = -refined
    z = labels.to(logits.dtype)
    return (torch.clamp(logits, min=0.0) - logits * z
            + torch.log1p(torch.exp(-logits.abs()))).sum()
