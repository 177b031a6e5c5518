"""Adjacency-matrix ops: normalization and the straight-through binarizer.

Counterpart of ``laplace_gnn_tpu/ops/adjacency.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def normalize_adj(adj: torch.Tensor) -> torch.Tensor:
    """D^-1/2 A^T D^-1/2 with D the *row* sums, the reference's convention
    (for symmetric A the textbook normalization)."""
    rowsum = adj.sum(dim=1)
    d = torch.where(rowsum > 0, torch.rsqrt(torch.clamp(rowsum, min=1e-38)),
                    torch.zeros_like(rowsum))
    return d[:, None] * adj.T * d[None, :]


def train_adj_mask(n_nodes: int, train_nodes, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """Ones mask zeroed on the train x train block."""
    mask = torch.ones((n_nodes, n_nodes), device=device, dtype=dtype)
    idx = torch.as_tensor(np.asarray(train_nodes), device=device)
    mask[idx[:, None], idx[None, :]] = 0.0
    return mask


def fill_diagonal(adj: torch.Tensor, value: float) -> torch.Tensor:
    """Out-of-place diagonal fill, differentiable off the diagonal."""
    eye = torch.eye(adj.shape[0], dtype=torch.bool, device=adj.device)
    return torch.where(eye, torch.full_like(adj, value), adj)


def fill_diagonal_any(adj, value: float):
    """fill_diagonal for tensors, keeping numpy inputs in numpy."""
    if isinstance(adj, torch.Tensor):
        return fill_diagonal(adj, value)
    out = np.array(adj, copy=True)
    np.fill_diagonal(out, value)
    return out


class _BinarizeSTE(torch.autograd.Function):
    """Hard threshold forward; the cotangent passes straight through,
    optionally masked and/or sign-taken (reference BinarizeSTE)."""

    @staticmethod
    def forward(x, threshold, mask, sign_grad):
        return (x > threshold).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, mask, sign_grad = inputs
        ctx.sign_grad = sign_grad
        ctx.has_mask = mask is not None
        if mask is not None:
            ctx.save_for_backward(mask)

    @staticmethod
    def backward(ctx, g):
        if ctx.has_mask:
            (mask,) = ctx.saved_tensors
            g = g * mask
        if ctx.sign_grad:
            g = torch.sign(g)
        return g, None, None, None


def binarize_ste(x: torch.Tensor, threshold: float,
                 mask: Optional[torch.Tensor] = None,
                 sign_grad: bool = False) -> torch.Tensor:
    """``(x > threshold)`` with a straight-through gradient into ``x``."""
    return _BinarizeSTE.apply(x, threshold, mask, sign_grad)
