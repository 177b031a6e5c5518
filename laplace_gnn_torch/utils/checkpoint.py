"""Checkpoints of parameters, optimizer states and fitted posteriors.

Counterpart of ``laplace_gnn_tpu/utils/checkpoint.py``: an atomic pickle of
a tree (nested dicts, lists and tuples) whose tensors are stored as numpy
arrays (bfloat16 ones as float32, which numpy lacks), the Laplace flavours'
state dicts, and :class:`TrainCheckpointer`, rolling checkpoints that a
killed run resumes from. No package beyond numpy and torch.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..device import resolve_device


def _map_leaves(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return x


def save_pytree(path: str, tree: Any) -> None:
    """Atomic pickle of ``tree`` with its tensors as numpy arrays."""
    host_tree = _map_leaves(_to_numpy, tree)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(host_tree, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, as_torch: bool = True, device=None) -> Any:
    """The tree saved at ``path``; with ``as_torch`` its arrays become
    tensors on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``). Load only files this program wrote: unpickling
    runs code."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    if as_torch:
        dev = resolve_device(device)
        tree = _map_leaves(
            lambda x: torch.as_tensor(x, device=dev)
            if isinstance(x, np.ndarray) else x, tree)
    return tree


def save_laplace(path: str, la) -> None:
    """Persist a fitted Laplace approximation (its flavour's state dict)."""
    save_pytree(path, la.state_dict())


def load_laplace(path: str, la) -> None:
    """Restore into a new Laplace of the same flavour, on its device."""
    la.load_state_dict(load_pytree(path, device=la._device))


class TrainCheckpointer:
    """Rolling training checkpoints: ``save(step, state)`` keeps the newest
    ``keep``; ``latest()`` loads the most recent one (or None), its tensors
    on ``device``."""

    def __init__(self, directory: str, keep: int = 3, device=None):
        self.directory = directory
        self.keep = keep
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pkl")

    def save(self, step: int, state: Any) -> str:
        path = self._path(step)
        save_pytree(path, {"step": step, "state": state})
        self._gc()
        return path

    def _steps(self) -> list[int]:
        return sorted(int(f[5:13]) for f in os.listdir(self.directory)
                      if f.startswith("ckpt_") and f.endswith(".pkl"))

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            os.unlink(self._path(s))

    def latest(self) -> Optional[dict]:
        steps = self._steps()
        if not steps:
            return None
        return load_pytree(self._path(steps[-1]), device=self.device)
