"""Carry the JAX package's trained artifacts across to the port.

The ``runs/<run>/*.pkl`` files were written by the JAX package: their array
leaves pickle as ``jax._src.array._reconstruct_array(fun, args, arr_state,
aval_state)``, where ``fun(*args)`` builds a numpy array and ``arr_state``
is its ``__setstate__`` payload.  :class:`JaxArrayUnpickler` maps exactly
that global to a numpy-only shim and refuses every other ``jax.*`` global,
so the artifacts load on a machine without JAX.

:func:`from_jax_params` turns the numpy trees into the port's objects, and
:func:`load_run` does both for a run directory.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ._device import resolve_device
from .codes import Code, get_code
from .models.dia import ConvBitwise, StopperFcn, canonical_dia_name, make_dia


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
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def from_jax_params(nms_params: dict, dia_params: dict, stopper_params: dict,
                    device: str | torch.device = "cuda"):
    """numpy trees -> (nms params dict, ConvBitwise state dict, stopper
    ``{w1, w2}`` dict) on ``device`` (the card unless ``device="cpu"``).

    * NMS: each leaf (e.g. ``{"check": (1,)}``) becomes a float32 tensor.
    * DIA (``model_cnn``): a flax conv kernel (3, in, out) becomes a torch
      ``Conv1d`` weight (out, in, 3) by ``transpose(2, 1, 0)``; both are
      VALID cross-correlations.  The head kernel (14, 1) already indexes the
      flattened (time, channel) order that ``ConvBitwise.forward`` produces.
    * Stopper: ``dense1/kernel`` (6, 6) and ``dense2/kernel`` (6, 2) in the
      ``x @ w`` layout the OSD engine uses."""
    device = resolve_device(device)
    nms_t = {k: _t(v, device) for k, v in nms_params.items()}
    p = dia_params["params"]
    dia_state = {
        f"conv{i}.weight": _t(np.transpose(p[f"conv{i}"]["kernel"], (2, 1, 0)),
                              device)
        for i in (1, 2, 3)
    }
    dia_state["head.weight"] = _t(np.asarray(p["head"]["kernel"]).T, device)
    dia_state["head.bias"] = _t(p["head"]["bias"], device)
    s = stopper_params["params"]
    fcn = {"w1": _t(s["dense1"]["kernel"], device),
           "w2": _t(s["dense2"]["kernel"], device)}
    return nms_t, dia_state, fcn


def stopper_module(fcn: dict) -> StopperFcn:
    """A ``StopperFcn`` holding the engine-layout ``{w1, w2}`` weights."""
    module = StopperFcn(fcn["w1"].shape[0]).to(fcn["w1"].device)
    with torch.no_grad():
        module.dense1.weight.copy_(fcn["w1"].T)
        module.dense2.weight.copy_(fcn["w2"].T)
    return module


def load_run(run_dir: str, device: str | torch.device = "cuda") -> dict:
    """Load a JAX-package run directory (``config.json``, the three
    parameter pickles and ``decoding_path.json``) into port objects.

    Returns ``config``, ``code`` (a :class:`Code`), ``variant``,
    ``num_iterations``, ``nms_params``, ``dia`` (a ``ConvBitwise`` on
    ``device``, eval mode), ``fcn`` and ``path``.  ``device`` is the card
    unless the caller passes ``"cpu"``."""
    device = resolve_device(device)
    with open(os.path.join(run_dir, "config.json")) as fh:
        cfg = json.load(fh)
    code: Code = get_code(cfg.get("code_name", "ccsds_128_64"))
    iters = int(cfg.get("num_iterations", 12))
    dia_name = canonical_dia_name(cfg.get("dia_model", "model_cnn"))
    nms_np = load_jax_pickle(os.path.join(run_dir, "nms_params.pkl"))
    dia_np = load_jax_pickle(os.path.join(run_dir, f"dia_{dia_name}.pkl"))
    stop_np = load_jax_pickle(os.path.join(run_dir, "stopper_params.pkl"))
    nms_t, dia_state, fcn = from_jax_params(nms_np, dia_np, stop_np, device)
    dia: ConvBitwise = make_dia(dia_name, code.n, iters + 1).to(device)
    dia.load_state_dict(dia_state)
    dia.eval()
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
