"""Diagonal SWAG variance (counterpart of
``laplace_gnn_tpu/utils/swag.py``): SGD with momentum and weight decay
from the current solution, the first and second moments of the flat
posterior vector over snapshots, and their difference."""

from __future__ import annotations

import torch

from ..curvature.interface import GGNBackend
from ..curvature.losses import get_loss_fn
from ..utils.pytree import tree_vector


def fit_diagonal_swag_var(model, params: dict, train_loader, likelihood: str,
                          n_snapshots_total: int = 40,
                          snapshot_freq: int = 1,
                          lr: float = 0.01, momentum: float = 0.9,
                          weight_decay: float = 3e-4,
                          min_var: float = 1e-30) -> torch.Tensor:
    """The diagonal SWAG variance of the posterior parameters, clamped at
    ``min_var``: ``n_snapshots_total`` snapshots, one every
    ``snapshot_freq`` epochs of SGD on the summed loss.
    ``torch.optim.SGD(momentum, weight_decay)`` takes the same steps as
    optax's ``chain(add_decayed_weights, sgd(momentum))``."""
    backend = GGNBackend(model, {k: v.detach() for k, v in params.items()},
                         likelihood)
    loss_fn = get_loss_fn(likelihood)
    w = {k: v.clone().requires_grad_(True) for k, v in backend.w.items()}
    opt = torch.optim.SGD(list(w.values()), lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    mean = torch.zeros_like(tree_vector(w)).detach()
    sq_mean = torch.zeros_like(mean)
    n_snapshots, epoch = 0, 0
    while n_snapshots < n_snapshots_total:
        for X, y in train_loader:
            opt.zero_grad()
            loss_fn(backend.model_fn(w, X), y).backward()
            opt.step()
        epoch += 1
        if epoch % snapshot_freq == 0:
            with torch.no_grad():
                theta = tree_vector(w)
                mean = (mean * n_snapshots + theta) / (n_snapshots + 1)
                sq_mean = (sq_mean * n_snapshots + theta ** 2) / (
                    n_snapshots + 1)
            n_snapshots += 1
    return torch.clamp(sq_mean - mean ** 2, min=min_var)
