"""Experimental model variants present (but unused) in the reference.

Port of ``short_ldpc_decoding_osd_tpu/models/extras.py`` (the reference's
``DL_Training_serial/nn_net.py`` architectures its pipeline never builds)
as ``nn.Module``s that own their weights:

* ``SelfAttention`` / ``MultiHeadAttention`` / ``TransformerLayer``
  (``nn_net.py:17-80``): per-head Q/K/V projections, softmax(q k^T / sqrt(d))
  v written out, a post-attention residual + LayerNorm, an FFN + LayerNorm.
* ``TemperatureLayer`` (``nn_net.py:83-94``), ``PredictOutlier``
  (``:96-134``) and :func:`predict_outlier_l2`.
* ``PredictPhase`` versions 0-3 (``nn_net.py:234-384``).
* :func:`neighborhood_trajectories`, ``RnnThree`` + ``ModelRnn2nd``
  (``nn_net.py:455-530``) and ``CnvNn`` (``:532-600``).

Layouts follow the JAX package so the weights carry across
(``convert.extras_state_from_jax``): a ``Linear`` holds a flax Dense kernel
transposed, a ``Conv2d`` a flax Conv kernel (kh, kw, in, out) as (out, in,
kh, kw), the LSTM cell flax's ``OptimizedLSTMCell`` gate kernels in the
``x @ w`` layout.  What flax decides differently from torch is written
out: LayerNorm's epsilon 1e-6 and its variance E[x^2] - E[x]^2; dropout
off unless a call passes ``deterministic=False`` (whatever
``module.training`` says) and then drawn from an explicit
``torch.Generator``; the LSTM's gate order (i, f, g, o) and biases on the
recurrent side only.  Every forward runs in IEEE f32
(``_device.full_f32``).  None of these modules has a kernel: they are
plain PyTorch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .._device import full_f32
from ..codes import tables


def _dropout(x: torch.Tensor, rate: float, deterministic: bool,
             generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: inverted dropout with keep probability
    ``1 - rate``, the mask drawn from ``generator``; the identity when
    ``deterministic`` or ``rate == 0``."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("deterministic=False needs a torch.Generator for the "
                         "dropout mask")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6)``: the variance as
    ``max(E[x^2] - E[x]^2, 0)`` (``use_fast_variance``), then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class SelfAttention(nn.Module):
    """Single-head scaled dot-product self-attention (``nn_net.py:61-80``)
    from ``in_features`` (default ``units``) to ``units``."""

    def __init__(self, units: int, dropout_rate: float = 0.2,
                 in_features: int | None = None):
        super().__init__()
        self.units = units
        self.dropout_rate = dropout_rate
        width = in_features or units
        self.wq = nn.Linear(width, units)
        self.wk = nn.Linear(width, units)
        self.wv = nn.Linear(width, units)

    @full_f32()
    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.units)
        w = _dropout(torch.softmax(scores, dim=-1), self.dropout_rate,
                     deterministic, generator)
        return w @ v


class MultiHeadAttention(nn.Module):
    """``num_heads`` SelfAttention heads of width ``units // num_heads``
    (each with its default dropout 0.2), concatenated, then an output
    projection (``nn_net.py:40-59``)."""

    def __init__(self, units: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        for i in range(num_heads):
            setattr(self, f"head{i}",
                    SelfAttention(units // num_heads, in_features=units))
        self.out = nn.Linear((units // num_heads) * num_heads, units)

    @full_f32()
    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        heads = [getattr(self, f"head{i}")(x, deterministic, generator)
                 for i in range(self.num_heads)]
        return self.out(torch.cat(heads, -1))


class TransformerLayer(nn.Module):
    """Post-LN transformer block: MHA + residual + LN, FFN + residual + LN
    (``nn_net.py:17-38``)."""

    def __init__(self, units: int, num_heads: int, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.mha = MultiHeadAttention(units, num_heads)
        self.norm1 = _LayerNorm(units)
        self.ffn1 = nn.Linear(units, units)
        self.ffn2 = nn.Linear(units, units)
        self.norm2 = _LayerNorm(units)

    @full_f32()
    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        a = self.mha(x, deterministic, generator)
        a = _dropout(a, self.dropout_rate, deterministic, generator)
        x = self.norm1(x + a)
        f = torch.relu(self.ffn1(x))
        f = _dropout(f, self.dropout_rate, deterministic, generator)
        return self.norm2(x + self.ffn2(f))


class TemperatureLayer(nn.Module):
    """Trainable scalar multiplier, init 1.0 (``nn_net.py:83-94``)."""

    def __init__(self):
        super().__init__()
        self.temperature = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.temperature


class PredictOutlier(nn.Module):
    """Heavier 3-layer stopper with a trainable temperature
    (``nn_net.py:96-134``): 2w ReLU -> w ReLU -> temperature ->
    softmax(2), no biases; the live pipeline uses ``dia.StopperFcn``."""

    def __init__(self, input_width: int):
        super().__init__()
        self.input_width = input_width
        self.dense1 = nn.Linear(input_width, 2 * input_width, bias=False)
        self.dense2 = nn.Linear(2 * input_width, input_width, bias=False)
        self.temperature = TemperatureLayer()
        self.out = nn.Linear(input_width, 2, bias=False)

    @full_f32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.dense2(torch.relu(self.dense1(x))))
        return torch.softmax(self.out(self.temperature(x)), dim=-1)


def predict_outlier_l2(model: PredictOutlier, weight: float = 0.01) -> torch.Tensor:
    """L2 penalty on the two hidden kernels (Keras ``regularizers.l2(0.01)``)."""
    return weight * ((model.dense1.weight ** 2).sum()
                     + (model.dense2.weight ** 2).sum())


class PredictPhase(nn.Module):
    """Multi-class phase predictor family (``nn_net.py:234-384``): the
    (2 * decoding_length - 1)-feature profile -> a distribution over
    ``capacity`` phases.  ``version``:
      0: 2c linear -> c linear, /5, softmax
      1: c linear -> Dense(c) softmax head, /10
      2: 4c linear -> c linear, /100, softmax
      3: 4 -> 2 -> softmax(c), no temperature"""

    def __init__(self, decoding_length: int, capacity: int, version: int = 0):
        super().__init__()
        width, c = 2 * decoding_length - 1, capacity
        self.version = version
        if version in (0, 2):
            hidden = (2 if version == 0 else 4) * c
            self.dense1 = nn.Linear(width, hidden, bias=False)
            self.dense2 = nn.Linear(hidden, c, bias=False)
        elif version == 1:
            self.dense1 = nn.Linear(width, c, bias=False)
            self.head = nn.Linear(c, c)
        elif version == 3:
            self.dense1 = nn.Linear(width, 4)
            self.dense2 = nn.Linear(4, 2)
            self.head = nn.Linear(2, c)
        else:
            raise ValueError(f"unknown PredictPhase version {version}")

    @full_f32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.version == 0:
            x = self.dense2(self.dense1(x)) / 5.0
        elif self.version == 1:
            x = self.head(self.dense1(x) / 10.0)
        elif self.version == 2:
            x = self.dense2(self.dense1(x)) / 100.0
        else:
            x = self.head(self.dense2(self.dense1(x)))
        return torch.softmax(x, dim=-1)


def _neighborhood_table(h, device):
    """(n, dv, dc) column gather order and 0/1 mask of one H on ``device``
    (a ``codes.tables`` item): for variable v and its slot-th adjacent row
    r, v's own column first, then r's other members (the reference's
    concat([selected_col, part1, part2]))."""
    m, n = h.shape
    dc = int(h.sum(axis=1).max())
    dv = int(h.sum(axis=0).max())
    order = np.zeros((n, dv, dc), np.int64)
    mask = np.zeros((n, dv, dc), np.float32)
    for v in range(n):
        rows = np.nonzero(h[:, v])[0]
        for slot, r in enumerate(rows[:dv]):
            cols = [v] + [c for c in np.nonzero(h[r])[0] if c != v]
            order[v, slot, : len(cols)] = cols
            mask[v, slot, : len(cols)] = 1.0
    return torch.tensor(order, device=device), torch.tensor(mask, device=device)


def neighborhood_trajectories(h: np.ndarray,
                              trajectories: torch.Tensor) -> torch.Tensor:
    """Per-variable check-neighbourhood views of an iteration trajectory
    (``rnn_three.preprocessing_inputs``, ``nn_net.py:489-512``).

    ``trajectories`` (B, T+1, n) -> (B, n, dv, T+1, dc), dv and dc H's
    largest column and row weights, zero-padded on irregular degrees: one
    static gather from a table built once per H and device, then the mask
    (an exact multiply, as JAX's)."""
    order, mask = tables.get(h, _neighborhood_table, trajectories.device)
    per_var = trajectories[:, :, order] * mask[None, None]
    return per_var.permute(0, 2, 3, 1, 4)  # (B, n, dv, T+1, dc)


def neighborhood_degrees(h: np.ndarray) -> tuple[int, int]:
    """(dv, dc): the widths :func:`neighborhood_trajectories` gives ``h``."""
    h = np.asarray(h) != 0
    return int(h.sum(axis=0).max()), int(h.sum(axis=1).max())


class _LSTM(nn.Module):
    """flax ``nn.RNN(nn.OptimizedLSTMCell(features))`` over (B, T, d):
    gates (i, f, g, o); ``wi`` (d, 4F) the input kernels ``ii, if, ig, io``
    side by side, no bias; ``wh`` (F, 4F) and ``bh`` (4F,) the recurrent
    kernels ``hi, hf, hg, ho`` and their biases; carry zero;
    c' = f c + i g, h' = o tanh(c').  Returns every step's h (B, T, F)."""

    def __init__(self, d: int, features: int):
        super().__init__()
        self.features = features
        self.wi = nn.Parameter(torch.zeros(d, 4 * features))
        self.wh = nn.Parameter(torch.zeros(features, 4 * features))
        self.bh = nn.Parameter(torch.zeros(4 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gi = x @ self.wi  # every step's input projection at once
        h = x.new_zeros((x.shape[0], self.features))
        c = torch.zeros_like(h)
        seq = []
        for t in range(x.shape[1]):
            i, f, g, o = ((h @ self.wh + self.bh) + gi[:, t]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            seq.append(h)
        return torch.stack(seq, 1)


class ModelRnn2nd(nn.Module):
    """Second-stage LSTM reducer (``nn_net.py:514-530``): (B, n, T+1) ->
    an LSTM(list_length) over each variable's sequence -> Dense(1) of the
    last step -> (B, n)."""

    def __init__(self, list_length: int):
        super().__init__()
        self.lstm = _LSTM(1, list_length)
        self.head = nn.Linear(list_length, 1)

    @full_f32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, n, ll = x.shape
        out = self.lstm(x.reshape(batch * n, ll, 1))[:, -1]
        return self.head(out).reshape(batch, n)


def _check_neighborhood(neigh: torch.Tensor, name: str, dc: int,
                        dv: int | None = None):
    if (neigh.dim() != 5 or neigh.shape[4] != dc
            or dv is not None and neigh.shape[2] != dv):
        raise ValueError(f"{name} built for dv {dv or 'any'}, dc {dc} takes "
                         f"(B, n, dv, T+1, dc) input, got {tuple(neigh.shape)}")


class RnnThree(nn.Module):
    """Neighbourhood-LSTM DIA variant (``nn_net.py:455-512``): an LSTM(7)
    over each adjacent check's other-member trajectory, Dense(1) on every
    step, mixed with the variable's own trajectory by learned
    per-iteration ``coefficients``, the mean over the dv slots, then
    ``ModelRnn2nd``.  ``dc`` (CCSDS's 8 by default) sets the LSTM's input
    width dc - 1; any dv is taken.

    As JAX does, the mean counts the zero-padded slots of low-degree
    variables, and the LSTM and head run on those zero slots too, so their
    bias reaches the mean."""

    def __init__(self, n: int, list_length: int, dc: int = 8):
        super().__init__()
        self.n, self.list_length, self.dc = n, list_length, dc
        self.coefficients = nn.Parameter(torch.zeros(list_length))
        self.lstm = _LSTM(dc - 1, 7)
        self.head = nn.Linear(7, 1)
        self.rnn_2nd = ModelRnn2nd(list_length)

    @full_f32()
    def forward(self, neigh: torch.Tensor) -> torch.Tensor:
        """(B, n, dv, T+1, dc) from :func:`neighborhood_trajectories` ->
        (B, n)."""
        _check_neighborhood(neigh, "RnnThree", self.dc)
        batch, n, dv, ll, dc = neigh.shape
        own = neigh[..., 0]
        seq = neigh[..., 1:].reshape(batch * n * dv, ll, dc - 1)
        x = self.head(self.lstm(seq))[..., 0].reshape(batch, n, dv, ll)
        mixed = own + self.coefficients * x
        return self.rnn_2nd(mixed.mean(2))

    def refine(self, h: np.ndarray, trajectories: torch.Tensor) -> torch.Tensor:
        """(B, T+1, n) trajectories -> (B, n) refined reliabilities."""
        return self(neighborhood_trajectories(h, trajectories))


class CnvNn(nn.Module):
    """2-D conv stack over per-variable neighbourhood maps
    (``nn_net.py:532-600``): the (dv * (T+1), dc) map of each variable,
    ``conv1`` VALID with kernel (s, dc) and stride (s, 1), s = dv if dv is
    3 or 5, else 3 (5 for CCSDS), ELU; three SAME (3, 1) convolutions to
    64, 32 and 8 channels, each with ELU; a SAME (3, 1) convolution to one
    channel; the mean of what is left.  ``dv`` and ``dc`` default to
    CCSDS's (5, 8)."""

    def __init__(self, n: int, list_length: int, dv: int = 5, dc: int = 8):
        super().__init__()
        self.n, self.list_length, self.dv, self.dc = n, list_length, dv, dc
        s = dv if dv in (3, 5) else 3
        self.conv1 = nn.Conv2d(1, 32, (s, dc), stride=(s, 1))
        self.conv2 = nn.Conv2d(32, 64, (3, 1), padding=(1, 0))
        self.conv3 = nn.Conv2d(64, 32, (3, 1), padding=(1, 0))
        self.conv4 = nn.Conv2d(32, 8, (3, 1), padding=(1, 0))
        self.conv5 = nn.Conv2d(8, 1, (3, 1), padding=(1, 0))

    @full_f32()
    def forward(self, neigh: torch.Tensor) -> torch.Tensor:
        """(B, n, dv, T+1, dc) -> (B, n)."""
        _check_neighborhood(neigh, "CnvNn", self.dc, self.dv)
        batch, n, dv, ll, dc = neigh.shape
        x = nn.functional.elu(self.conv1(neigh.reshape(batch * n, 1, dv * ll, dc)))
        for conv in (self.conv2, self.conv3, self.conv4):
            x = nn.functional.elu(conv(x))
        x = self.conv5(x)
        return x.reshape(batch * n, -1).mean(-1).reshape(batch, n)

    def refine(self, h: np.ndarray, trajectories: torch.Tensor) -> torch.Tensor:
        """(B, T+1, n) trajectories -> (B, n) refined reliabilities."""
        return self(neighborhood_trajectories(h, trajectories))
