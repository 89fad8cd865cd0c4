"""Tiny checkpoint store for parameters and optimizer state.

Port of ``short_ldpc_decoding_osd_tpu/utils/checkpoint.py``: a pickle per
step, ``ckpt-{step}.pkl``, with the reference's ``max_to_keep``-style
rotation (``keep``) and a ``latest`` resolver.  The stored tree holds numpy
parameters and the torch optimizer state; every tensor in it is moved to
the CPU before it is pickled.
"""

from __future__ import annotations

import os
import pickle
import re

import torch

_FMT = "ckpt-{step}.pkl"
_PAT = re.compile(r"ckpt-(\d+)\.pkl$")


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         keep: int = 5) -> str:
    """Store ``tree`` as step ``step``; keep the newest ``keep`` steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, _FMT.format(step=step))
    with open(path, "wb") as fh:
        pickle.dump({"step": step, "tree": _to_host(tree),
                     "extra": extra or {}}, fh)
    for old in list_steps(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, _FMT.format(step=old)))
    return path


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_PAT.match, os.listdir(ckpt_dir))
                  if m)


def load(ckpt_dir: str, step: int | str = "latest"):
    """Returns (step, tree, extra), or None if nothing is stored."""
    steps = list_steps(ckpt_dir)
    if not steps:
        return None
    chosen = steps[-1] if step == "latest" else int(step)
    with open(os.path.join(ckpt_dir, _FMT.format(step=chosen)), "rb") as fh:
        blob = pickle.load(fh)
    return blob["step"], blob["tree"], blob["extra"]
