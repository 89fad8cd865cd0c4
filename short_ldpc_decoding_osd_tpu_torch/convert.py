"""Carry the JAX package's trained artifacts across to the port.

The ``runs/<run>/*.pkl`` files were written by the JAX package: their array
leaves pickle as ``jax._src.array._reconstruct_array(fun, args, arr_state,
aval_state)``, where ``fun(*args)`` builds a numpy array and ``arr_state``
is its ``__setstate__`` payload.  :class:`JaxArrayUnpickler` maps exactly
that global to a numpy-only shim and refuses every other ``jax.*`` global,
so the artifacts load on a machine without JAX.

:func:`from_jax_params` turns the numpy trees into the port's objects,
:func:`to_jax_params` turns them back (the port's run directories hold
such plain numpy pickles, no torch or JAX globals), and :func:`load_run`
loads a run directory of either package.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from .codes import Code, get_code
from .models import extras
from .models.dia import StopperFcn, canonical_dia_name, make_dia
from .utils import profiling


def _reconstruct_array(fun, args, arr_state, aval_state):
    """numpy stand-in for ``jax._src.array._reconstruct_array``."""
    del aval_state
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


class JaxArrayUnpickler(pickle.Unpickler):
    """Unpickler for JAX-written parameter pickles, yielding numpy leaves."""

    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _reconstruct_array
        if module == "jax" or module.startswith(("jax.", "jaxlib", "flax")):
            raise pickle.UnpicklingError(
                f"refusing JAX global {module}.{name} in a parameter pickle"
            )
        return super().find_class(module, name)


def load_jax_pickle(path: str):
    """Load a pickle written by the JAX package; arrays come back as numpy.
    Only for the repository's own artifacts: unpickling runs code."""
    with open(path, "rb") as fh:
        return JaxArrayUnpickler(fh).load()


def _t(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` that owns its memory: never a view of
    the caller's array, which may be read-only (an unpickled leaf) and
    must not change when the tensor is updated in place."""
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(device)


def dia_state_from_jax(dia_params: dict, device) -> dict:
    """A DIA tree of the JAX package -> the port module's state dict on
    ``device``; the model follows from the keys (``conv1``: ``model_cnn``,
    ``gru1``: ``model_rnn1``, ``rnn1``: ``model_rnn2``).

    * A flax conv kernel (3, in, out) becomes a torch ``Conv1d`` weight
      (out, in, 3) by ``transpose(2, 1, 0)``; both are VALID
      cross-correlations.  The CNN head kernel (14, 1) already indexes the
      flattened (time, channel) order that ``ConvBitwise.forward`` yields.
    * A recurrent cell's ``wi``/``wh`` keep JAX's ``x @ w`` layout.
    * A Dense ``kernel`` (in, out) becomes a ``Linear`` weight (out, in)."""
    p = dia_params["params"]
    if "conv1" in p:
        state = {f"conv{i}.weight": np.transpose(p[f"conv{i}"]["kernel"],
                                                 (2, 1, 0))
                 for i in (1, 2, 3)}
        state["head.bias"] = p["head"]["bias"]
    else:
        cells = ("gru1", "gru2") if "gru1" in p else ("rnn1", "rnn2")
        state = {f"{c}.{w}": p[c][w] for c in cells for w in ("wi", "wh")}
    state["head.weight"] = np.asarray(p["head"]["kernel"]).T
    return {k: _t(v, device) for k, v in state.items()}


def dia_to_jax(dia_state: dict) -> dict:
    """Inverse of :func:`dia_state_from_jax`: a port DIA state dict (or
    module) -> the JAX package's tree of float32 numpy arrays."""
    if isinstance(dia_state, torch.nn.Module):
        dia_state = dia_state.state_dict()
    s = {k: v.detach().cpu().numpy() for k, v in dia_state.items()}
    if "conv1.weight" in s:
        p = {f"conv{i}": {"kernel": np.ascontiguousarray(
            np.transpose(s[f"conv{i}.weight"], (2, 1, 0)))} for i in (1, 2, 3)}
        p["head"] = {"kernel": np.ascontiguousarray(s["head.weight"].T),
                     "bias": s["head.bias"]}
    else:
        cells = ("gru1", "gru2") if "gru1.wi" in s else ("rnn1", "rnn2")
        p = {c: {w: s[f"{c}.{w}"] for w in ("wi", "wh")} for c in cells}
        p["head"] = {"kernel": np.ascontiguousarray(s["head.weight"].T)}
    return {"params": p}


def stopper_from_jax(stopper_params: dict, device) -> dict:
    """A JAX stopper tree -> the engine's ``{w1, w2}`` tensors on
    ``device``: ``dense1/kernel`` (w+1, w+1) and ``dense2/kernel`` (w+1, 2)
    in the ``x @ w`` layout."""
    s = stopper_params["params"]
    return {"w1": _t(s["dense1"]["kernel"], device),
            "w2": _t(s["dense2"]["kernel"], device)}


def stopper_to_jax(fcn: dict) -> dict:
    """Inverse of :func:`stopper_from_jax`."""
    return {"params": {"dense1": {"kernel": fcn["w1"].detach().cpu().numpy()},
                       "dense2": {"kernel": fcn["w2"].detach().cpu().numpy()}}}


EXTRAS = ("SelfAttention", "MultiHeadAttention", "TransformerLayer",
          "TemperatureLayer", "PredictOutlier", "PredictPhase", "ModelRnn2nd",
          "RnnThree", "CnvNn")
_LSTM_KEY = "OptimizedLSTMCell_0"  # where flax's nn.RNN puts its cell
_GATES = ("i", "f", "g", "o")


def extras_state_from_jax(name: str, params: dict, device) -> dict:
    """A flax tree of ``models.extras`` class ``name`` (one of
    :data:`EXTRAS`) -> the port module's state dict on ``device``.

    * A Dense ``kernel`` (in, out) becomes a ``Linear`` weight (out, in),
      its transpose; a Conv ``kernel`` (kh, kw, in, out) a ``Conv2d``
      weight (out, in, kh, kw).  Biases as they are.
    * A LayerNorm's ``scale`` and ``bias``, ``coefficients`` and
      ``temperature`` as they are.
    * An ``OptimizedLSTMCell_0`` (where ``nn.RNN`` puts the cell, whatever
      the RNN's name) becomes ``lstm``: ``wi`` the input kernels ``ii, if,
      ig, io`` side by side (d, 4F), ``wh`` the recurrent ``hi, hf, hg, ho``
      (F, 4F), ``bh`` their biases (4F,), all in the ``x @ w`` layout."""
    if name not in EXTRAS:
        raise ValueError(f"unknown extras model {name!r}; expected one of {EXTRAS}")
    state = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if key == _LSTM_KEY:
                path = prefix + "lstm."
                state[path + "wi"] = np.concatenate(
                    [val["i" + g]["kernel"] for g in _GATES], 1)
                state[path + "wh"] = np.concatenate(
                    [val["h" + g]["kernel"] for g in _GATES], 1)
                state[path + "bh"] = np.concatenate(
                    [val["h" + g]["bias"] for g in _GATES])
            elif not isinstance(val, dict):
                state[prefix + key] = val
            elif "kernel" in val:
                w = np.asarray(val["kernel"])
                state[prefix + key + ".weight"] = (
                    np.transpose(w, (3, 2, 0, 1)) if w.ndim == 4 else w.T)
                if "bias" in val:
                    state[prefix + key + ".bias"] = val["bias"]
            else:
                walk(val, prefix + key + ".")

    walk(params["params"], "")
    return {k: _t(v, device) for k, v in state.items()}


def extras_to_jax(module: nn.Module) -> dict:
    """Inverse of :func:`extras_state_from_jax`: a ``models.extras`` module
    -> the flax tree of float32 numpy arrays in its exact key layout."""

    def arr(t):
        return np.ascontiguousarray(t.detach().cpu().numpy())

    def tree(mod):
        out = {name: arr(p) for name, p in mod.named_parameters(recurse=False)}
        for name, child in mod.named_children():
            if isinstance(child, extras._LSTM):
                f = child.features
                cell = {}
                for j, g in enumerate(_GATES):
                    cols = slice(j * f, (j + 1) * f)
                    cell["i" + g] = {"kernel": arr(child.wi[:, cols])}
                    cell["h" + g] = {"kernel": arr(child.wh[:, cols]),
                                     "bias": arr(child.bh[cols])}
                out[_LSTM_KEY] = cell
            elif isinstance(child, (nn.Linear, nn.Conv2d)):
                w = arr(child.weight)
                leaf = {"kernel": np.ascontiguousarray(
                    np.transpose(w, (2, 3, 1, 0)) if w.ndim == 4 else w.T)}
                if child.bias is not None:
                    leaf["bias"] = arr(child.bias)
                out[name] = leaf
            else:
                out[name] = tree(child)
        return out

    return {"params": tree(module)}


def nms_to_jax(nms_params: dict) -> dict:
    """NMS parameters (tensors or arrays) -> a dict of float32 numpy arrays."""
    return {k: np.asarray(torch.as_tensor(v).detach().cpu().numpy(), np.float32)
            for k, v in nms_params.items()}


def from_jax_params(nms_params: dict, dia_params: dict, stopper_params: dict,
                    device: str | torch.device = "cuda"):
    """numpy trees -> (nms params dict, DIA state dict, stopper ``{w1, w2}``
    dict) on ``device`` (the card unless ``device="cpu"``): each NMS leaf
    (e.g. ``{"check": (1,)}``) a float32 tensor, the DIA through
    :func:`dia_state_from_jax` (any of the three refiners), the stopper
    through :func:`stopper_from_jax`."""
    device = resolve_device(device)
    nms_t = {k: _t(v, device) for k, v in nms_params.items()}
    return (nms_t, dia_state_from_jax(dia_params, device),
            stopper_from_jax(stopper_params, device))


def to_jax_params(nms_params: dict, dia_state, fcn: dict):
    """Inverse of :func:`from_jax_params`: port parameters -> the JAX
    package's numpy trees (nms dict, DIA tree, stopper tree), float32
    arrays in its exact key layout, so a run directory the port writes is
    one the JAX package reads.  ``dia_state`` is a state dict or module."""
    return nms_to_jax(nms_params), dia_to_jax(dia_state), stopper_to_jax(fcn)


def dia_module(name: str, n: int, list_length: int, dia_state: dict) -> nn.Module:
    """The DIA ``name`` holding ``dia_state``, on its tensors' device, in
    eval mode."""
    device = next(iter(dia_state.values())).device
    dia = make_dia(name, n, list_length).to(device)
    dia.load_state_dict(dia_state)
    return dia.eval()


def stopper_module(fcn: dict) -> StopperFcn:
    """A ``StopperFcn`` holding the engine-layout ``{w1, w2}`` weights."""
    module = StopperFcn(fcn["w1"].shape[0]).to(fcn["w1"].device)
    with torch.no_grad():
        module.dense1.weight.copy_(fcn["w1"].T)
        module.dense2.weight.copy_(fcn["w2"].T)
    return module


def load_run(run_dir: str, device: str | torch.device = "cuda") -> dict:
    """Load a run directory (``config.json``, the three parameter pickles
    and ``decoding_path.json``), written by the JAX package or by the
    port's ``pipeline.recipe``, into port objects.

    Returns ``config``, ``code`` (a :class:`Code`), ``variant``,
    ``num_iterations``, ``nms_params``, ``dia`` (the config's refiner on
    ``device``, eval mode), ``fcn`` and ``path``.  ``device`` is the card
    unless the caller passes ``"cpu"``.  Set-up span ``setup.load_run``,
    closed by the device's synchronisation."""
    device = resolve_device(device)
    with profiling.setup_span("load_run", device):
        return _load_run(run_dir, device)


def _load_run(run_dir: str, device: torch.device) -> dict:
    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = json.load(fh)
    code: Code = get_code(cfg.get("code_name", "ccsds_128_64"))
    iters = int(cfg.get("num_iterations", 12))
    dia_name = canonical_dia_name(cfg.get("dia_model", "model_cnn"))
    nms_np = load_jax_pickle(os.path.join(run_dir, "nms_params.pkl"))
    dia_np = load_jax_pickle(os.path.join(run_dir, f"dia_{dia_name}.pkl"))
    stop_np = load_jax_pickle(os.path.join(run_dir, "stopper_params.pkl"))
    nms_t, dia_state, fcn = from_jax_params(nms_np, dia_np, stop_np, device)
    dia = dia_module(dia_name, code.n, iters + 1, dia_state)
    with open(os.path.join(run_dir, "decoding_path.json")) as fh:
        path = json.load(fh)["path"]
    return {
        "config": cfg,
        "code": code,
        "variant": cfg.get("variant", "NMS-1"),
        "num_iterations": iters,
        "nms_params": nms_t,
        "dia": dia,
        "fcn": fcn,
        "path": path,
    }
