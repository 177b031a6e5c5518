"""Minimal data loading (counterpart of ``laplace_gnn_tpu/utils/data.py``).

A loader is any iterable of ``(X, y)`` batches or of ``MutableMapping``
batches (the whole mapping is the model input, targets under a
``dict_key_y`` key); :func:`dataset_size` resolves N, preferring an
explicit attribute.
"""

from __future__ import annotations

from collections.abc import MutableMapping
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class ArrayLoader:
    """Batched iterable over (X, y) arrays with a known dataset size; every
    batch is a tensor on ``device`` (``cuda`` unless asked).

    ``X`` may be a ``MutableMapping`` of same-leading-dim arrays; then each
    batch is the sliced mapping. Pass ``y=None`` to yield the bare mapping
    (targets already inside under ``dict_key_y``)."""

    def __init__(self, X, y=None, batch_size: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0, device=None):
        dev = resolve_device(device)
        if isinstance(X, MutableMapping):
            self.X = type(X)({k: _as_tensor(v, dev) for k, v in X.items()})
            self.n = int(next(iter(self.X.values())).shape[0])
        else:
            self.X = _as_tensor(X, dev)
            self.n = int(self.X.shape[0])
        self.y = None if y is None else _as_tensor(y, dev)
        self.device = dev
        self.batch_size = batch_size or self.n
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    @property
    def dataset_size(self) -> int:
        return self.n

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def _slice_x(self, sl):
        if isinstance(self.X, MutableMapping):
            return type(self.X)({k: v[sl] for k, v in self.X.items()})
        return self.X[sl]

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        for i in range(0, self.n, self.batch_size):
            sl = torch.as_tensor(idx[i: i + self.batch_size],
                                 device=self.device)
            if self.y is None:
                yield self._slice_x(sl)
            else:
                yield self._slice_x(sl), self.y[sl]


def batch_size_of(data, dict_key_y: str = "labels") -> int:
    """Leading dimension of one loader batch (tuple or mapping)."""
    if isinstance(data, MutableMapping):
        if dict_key_y in data:
            return int(data[dict_key_y].shape[0])
        return int(next(iter(data.values())).shape[0])
    return int(data[1].shape[0])


def dataset_size(loader, dict_key_y: str = "labels") -> int:
    if hasattr(loader, "dataset_size"):
        return int(loader.dataset_size)
    if hasattr(loader, "dataset"):
        return len(loader.dataset)
    return sum(batch_size_of(b, dict_key_y) for b in loader)
