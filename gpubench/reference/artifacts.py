"""The run directory's raw files, read by the reference itself.

The parameter pickles were written by the JAX package: each array leaf
pickles as ``jax._src.array._reconstruct_array(fun, args, arr_state,
aval_state)``.  :class:`_Unpickler` maps exactly that global to a numpy shim
and refuses every other JAX global, so the files load without JAX.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np


def _reconstruct_array(fun, args, arr_state, aval_state):
    del aval_state
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _reconstruct_array
        if module == "jax" or module.startswith(("jax.", "jaxlib", "flax")):
            raise pickle.UnpicklingError(f"refusing global {module}.{name}")
        return super().find_class(module, name)


def load_pickle(path: str):
    """A pickle of the repository's run directories, arrays as numpy."""
    with open(path, "rb") as fh:
        return _Unpickler(fh).load()


def softplus_f32(x: float) -> float:
    """softplus of an f32 value, rounded to f32 as the decoders take it
    (``log1p(exp(x))``; above 20 the identity, as ``torch.nn.functional
    .softplus`` computes it)."""
    import torch
    t = torch.tensor([x], dtype=torch.float32)
    return float(torch.nn.functional.softplus(t)[0])


def load_run(root: str, config: dict) -> dict:
    """What the reference needs of a configuration: the parity matrix
    ``h`` (uint8), the decoder's raw parameters ``nms`` (its variant's file
    reads them), the DIA's conv kernels and head, the stopper's two
    kernels and the decoding path."""
    run_dir = os.path.join(root, config["run_dir"])
    with np.load(os.path.join(root, config["parity_file"])) as blob:
        h = blob["h"].astype(np.uint8)
    nms = load_pickle(os.path.join(run_dir, "nms_params.pkl"))
    dia = load_pickle(os.path.join(run_dir, f"dia_{config['dia_model']}.pkl"))
    stop = load_pickle(os.path.join(run_dir, "stopper_params.pkl"))
    with open(os.path.join(run_dir, "decoding_path.json")) as fh:
        path = json.load(fh)["path"]
    p = dia["params"]
    return {
        "h": h,
        "nms": nms,
        "conv": [np.asarray(p[f"conv{i}"]["kernel"], np.float64)
                 for i in (1, 2, 3)],
        "head_kernel": np.asarray(p["head"]["kernel"], np.float64),
        "head_bias": float(np.asarray(p["head"]["bias"]).reshape(-1)[0]),
        "w1": np.asarray(stop["params"]["dense1"]["kernel"], np.float64),
        "w2": np.asarray(stop["params"]["dense2"]["kernel"], np.float64),
        "path": path,
    }
