"""Dense ground-truth curvature oracles for tests (counterpart of
``laplace_gnn_tpu/curvature/oracles.py``).

Everything goes through an autodiff route independent of the matrix-free
operators: ``torch.func.jacrev`` / ``torch.func.hessian`` on the flat
parameter vector, and loss Hessians by ``torch.func.hessian`` on the
outputs, so agreement with the operators is a real cross-check.
"""

from __future__ import annotations

import torch

from ..utils.pytree import tree_unflattener, tree_vector
from .losses import get_loss_fn


def _flat_model_fn(model_fn, w: dict):
    unflatten = tree_unflattener(w)
    theta = tree_vector(w)

    def f(flat, X):
        return model_fn(unflatten(flat), X)

    return f, theta


def functorch_jacobian(model_fn, w: dict, X) -> torch.Tensor:
    """Dense Jacobian (M, C, P) via jacrev on the flat vector."""
    f, theta = _flat_model_fn(model_fn, w)
    return torch.func.jacrev(lambda t: f(t, X))(theta)


def functorch_hessian(model_fn, likelihood: str, w: dict, data
                      ) -> torch.Tensor:
    """Dense Hessian of the total sum-loss."""
    loss_fn = get_loss_fn(likelihood)
    f, theta = _flat_model_fn(model_fn, w)

    def total(t):
        return sum(loss_fn(f(t, X), y) for X, y in data)

    return torch.func.hessian(total)(theta)


def functorch_ggn(model_fn, likelihood: str, w: dict, data) -> torch.Tensor:
    """Dense GGN: sum_n J_n^T H_n J_n with H_n = d^2 loss / d f^2."""
    loss_fn = get_loss_fn(likelihood)
    total = None
    for X, y in data:
        J = functorch_jacobian(model_fn, w, X)          # (M, C, P)
        fx = model_fn(w, X)
        H = torch.func.vmap(torch.func.hessian(
            lambda fi, yi: loss_fn(fi[None], yi[None])))(fx, y)  # (M, C, C)
        G = torch.einsum("mcp,mck,mkq->pq", J, H, J)
        total = G if total is None else total + G
    return total


def functorch_ef(model_fn, likelihood: str, w: dict, data) -> torch.Tensor:
    """Dense empirical Fisher: sum_n g_n g_n^T (raw sum-loss gradients)."""
    loss_fn = get_loss_fn(likelihood)
    f, theta = _flat_model_fn(model_fn, w)
    total = None
    for X, y in data:
        def per_sample(t):
            fx = f(t, X)
            return torch.func.vmap(
                lambda fi, yi: loss_fn(fi[None], yi[None]))(fx, y)

        G = torch.func.jacrev(per_sample)(theta)        # (M, P)
        E = G.T @ G
        total = E if total is None else total + E
    return total


def jacobians_naive(model_fn, w: dict, X) -> torch.Tensor:
    """The naive per-element Jacobian oracle: the same dense Jacobian."""
    return functorch_jacobian(model_fn, w, X)
