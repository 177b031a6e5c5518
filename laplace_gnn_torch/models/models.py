"""GCN, STE-GCN and GAT (counterpart of
``laplace_gnn_tpu/models/models.py``; the other models of the zoo are not
ported yet)."""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.module import TapCollector
from ..ops.adjacency import (binarize_ste, fill_diagonal, fill_diagonal_any,
                             normalize_adj, train_adj_mask)
from ..ops.fused_spmm import (StaticNormAdjOp, norm_aggregate,
                              ste_norm_aggregate)
from .base_gnn import BaseGNN
from .layers import GATConv, GCNConv


class FusedAdjOp:
    """Adjacency stand-in whose ``spmm`` runs the fused aggregation (the
    CUDA kernel on the GPU); consumed by ``ops.spmm.aggregate``."""

    def __init__(self, fn):
        self._fn = fn

    def spmm(self, x):
        return self._fn(x)


class GCN(BaseGNN):
    """Normalized-adjacency GCN. ``fused``: False composes PyTorch ops;
    True runs the fused kernel on the live ``adj``; "int8" packs the fixed
    adjacency once at construction (GCN never updates it); "auto" picks
    "int8" from 8192 nodes up, else False."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers,
                 X, init_adj, dropout_p=0.5, act="relu", act_kwargs=None,
                 symmetric: bool = False, fused=False, **kwargs):
        init_adj = fill_diagonal_any(init_adj, 1.0)  # self-loops
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, init_adj, dropout_p, act, act_kwargs,
                         symmetric=symmetric, **kwargs)
        if fused == "auto":
            fused = "int8" if self.init_adj.shape[0] >= 8192 else False
        self.fused = fused
        self._static_op = (StaticNormAdjOp(self.init_adj)
                           if fused == "int8" else None)

    def forward_adj(self, taps: Optional[TapCollector] = None):
        if self.fused == "int8":
            return self._static_op
        adj = self.adj
        if self.fused:
            return FusedAdjOp(lambda s: norm_aggregate(adj, s))
        return normalize_adj(adj)

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GCNConv(in_channels, out_channels, name=name, **kwargs)


class STEGCN(BaseGNN):
    """GCN whose adjacency is a learnable parameter passed through a
    straight-through binarization."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers,
                 X, init_adj, dropout_p=0.5, act="relu", act_kwargs=None,
                 threshold: float = 0.5, train_masked_update: bool = False,
                 train_nodes=None, symmetric: bool = False,
                 sign_grad: bool = False, fused: bool = False, **kwargs):
        init_adj = fill_diagonal_any(init_adj, 1.0)
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, init_adj, dropout_p, act, act_kwargs,
                         symmetric=symmetric, **kwargs)
        self.fused = fused
        self.threshold = threshold
        self.sign_grad = sign_grad
        self.train_masked_update = train_masked_update
        self.grad_adj_mask = None
        if train_masked_update:
            if train_nodes is None:
                raise ValueError("'train_nodes' must be provided to use "
                                 "train_masked_update.")
            mask = train_adj_mask(self.init_adj.shape[0], train_nodes,
                                  self.init_adj.device, self.init_adj.dtype)
            self.grad_adj_mask = torch.where(mask == 0,
                                             torch.full_like(mask, 0.1), mask)

    def full_adj(self, params):
        return (params["adj"] > self.threshold).to(params["adj"].dtype)

    def forward_adj(self, taps: Optional[TapCollector] = None):
        adj = self.adj
        if self.fused:
            if taps is not None and taps.perturbed:
                # Under KFAC tap perturbations the fused op's input s
                # depends on the pullback variable. JAX then differentiates
                # the op's forward rule as plain code in the outer (marglik)
                # derivative, where the threshold has zero gradient, so the
                # JAX package's fused hyperstep gradient w.r.t. adj is
                # exactly zero. Detaching here reproduces that.
                adj = adj.detach()
            return FusedAdjOp(lambda s: ste_norm_aggregate(
                adj, s, self.threshold, self.symmetric, self.sign_grad,
                self.grad_adj_mask))
        if self.symmetric:
            adj = (adj + adj.T) / 2
        adj = binarize_ste(adj, self.threshold, self.grad_adj_mask,
                           self.sign_grad)
        return normalize_adj(fill_diagonal(adj, 1.0))

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GCNConv(in_channels, out_channels, name=name, **kwargs)


class GAT(BaseGNN):
    """Dense multi-head graph attention with self-loops.

    ``heads``, ``concat``, ``row_block``, ``attn_dtype`` and
    ``attention_impl`` go to every :class:`GATConv`; with ``concat`` a
    layer's output channels are split over the heads. ``mask_dtype``
    (e.g. ``torch.int8``) serves the attention ``(adj > 0)`` in that dtype
    instead of the float32 adjacency: exact, since attention reads only
    ``adj > 0`` and GAT never updates its adjacency. The cast runs on every
    forward (an extra read of the N x N adjacency that XLA hoists out of
    the JAX package's loops); caching it is left to later work."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers,
                 X, init_adj, dropout_p=0.5, act="relu", act_kwargs=None,
                 symmetric: bool = False, mask_dtype=None, **kwargs):
        init_adj = fill_diagonal_any(init_adj, 1.0)
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, init_adj, dropout_p, act, act_kwargs,
                         symmetric=symmetric, **kwargs)
        self.mask_dtype = _torch_dtype(mask_dtype)

    def forward_adj(self, taps: Optional[TapCollector] = None):
        if self.mask_dtype is not None:
            return (self.adj > 0).to(self.mask_dtype)
        return self.adj

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        heads = kwargs.pop("heads", 1)
        concat = kwargs.pop("concat", True)
        if concat and out_channels % heads != 0:
            raise ValueError(
                f"Ensure that the number of output channels of 'GATConv' "
                f"(got '{out_channels}') is divisible by the number of heads "
                f"(got '{heads}')")
        if concat:
            out_channels = out_channels // heads
        return GATConv(in_channels, out_channels, heads=heads, concat=concat,
                       name=name, **kwargs)


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    """``None``, a ``torch.dtype`` or its name (``"int8"``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))
