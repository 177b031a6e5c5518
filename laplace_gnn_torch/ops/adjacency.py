"""Adjacency-matrix ops: normalization, symmetrization and powers, the
straight-through binarizer and clip, and GraphSAGE's neighbour sample.

Counterpart of ``laplace_gnn_tpu/ops/adjacency.py``.
"""

from __future__ import annotations

import math
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


def symmetrize_adj(adj: torch.Tensor) -> torch.Tensor:
    """A + A^T clipped at 1 (a tie at 1 splits its gradient, as JAX's
    ``minimum`` does)."""
    s = adj + adj.T
    return torch.minimum(s, torch.ones_like(s))


def power_adj(adj, power: int):
    """A^power by repeated products (a tensor, or a numpy array)."""
    out = adj
    for _ in range(power - 1):
        out = out @ adj
    return out


def preprocess_adj(adj: torch.Tensor) -> torch.Tensor:
    """Self-loops, then the symmetric degree normalization."""
    return normalize_adj(adj + torch.eye(adj.shape[0], dtype=adj.dtype,
                                         device=adj.device))


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
    optionally masked and/or sign-taken (reference BinarizeSTE). Its
    vmap rule is generated, so a vmapped forward (``matmat`` of a GGN
    operator) runs through it."""

    generate_vmap_rule = True

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


class _ClipSTE(torch.autograd.Function):
    """Clamp to [0, 1]; the backward clamps the cotangent to [0, 1] too
    (JAX's ``clip_ste``), with differentiable ops."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.clamp(x, 0.0, 1.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, 0.0, 1.0)


def clip_ste(x: torch.Tensor) -> torch.Tensor:
    return _ClipSTE.apply(x)


def _neigh_uniforms(n: int, generator: torch.Generator, dtype,
                    device) -> torch.Tensor:
    """The (n, n) iid uniforms of one neighbour sample."""
    return torch.rand((n, n), generator=generator, dtype=dtype,
                      device=device)


def sample_neigh_adj(generator: torch.Generator, adj: torch.Tensor,
                     k: Optional[int]) -> torch.Tensor:
    """A 0/1 mask keeping at most ``k`` neighbours of each row.

    Draws iid uniforms, sets non-edges to -inf and keeps what is at or
    above each row's k-th largest value, masked to the edges: in
    distribution, k neighbours without replacement. A row with fewer than
    k edges has -inf as its k-th value and keeps all of them. ``k=None``
    returns ``adj``."""
    if k is None:
        return adj
    scores = _neigh_uniforms(adj.shape[0], generator, adj.dtype, adj.device)
    edge = adj > 0
    scores = torch.where(edge, scores, torch.full_like(scores, -math.inf))
    kth = torch.topk(scores, k, dim=1).values[:, -1:]
    return ((scores >= kth) & edge).to(adj.dtype)
