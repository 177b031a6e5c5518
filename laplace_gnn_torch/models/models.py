"""The dense model zoo (counterpart of
``laplace_gnn_tpu/models/models.py``): GCN, GraphSAGE, STE-GCN,
STE-GraphSAGE, LoRA-STE-GCN, GAT and AttSTEGCN.

Parameters whose names contain ``adj`` (the adjacency, LoRA's
``adj_lora_*``, AttSTEGCN's ``adj_W``) are kept out of the Laplace
posterior by that name, and out of the trainer's weight optimizer."""

from __future__ import annotations

from typing import Optional

import math

import torch

from ..nn.module import Linear, TapCollector
from ..ops.adjacency import (binarize_ste, fill_diagonal, fill_diagonal_any,
                             normalize_adj, sample_neigh_adj, train_adj_mask)
from ..ops.fused_spmm import StaticNormAdjOp, SteForms, norm_aggregate
from ..profiling import annotate, count
from .base_gnn import BaseGNN
from .layers import GATConv, GCNConv, GraphSAGEConv


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

    def has_row_route(self) -> bool:
        return not self.fused

    def row_block_adj(self, ax, taps: Optional[TapCollector] = None):
        from ..parallel.sharded import NormalizedRowBlockAdj
        return NormalizedRowBlockAdj(self.adj, ax)

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GCNConv(in_channels, out_channels, name=name, **kwargs)


class GraphSAGE(BaseGNN):
    """Mean-aggregation SAGE on the fixed graph without self-loops; in a
    train-mode forward given a generator, each row keeps a sample of at
    most ``num_sampled_nodes_per_hop`` neighbours."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers,
                 X, init_adj, num_sampled_nodes_per_hop: Optional[int] = None,
                 dropout_p=0.5, act="relu", act_kwargs=None,
                 symmetric: bool = False, **kwargs):
        init_adj = fill_diagonal_any(init_adj, 0.0)
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, init_adj, dropout_p, act, act_kwargs,
                         symmetric=symmetric, **kwargs)
        self.num_sampled_nodes_per_hop = num_sampled_nodes_per_hop

    def forward_adj(self, taps: Optional[TapCollector] = None):
        return self.adj

    def forward(self, x_indices=None, taps: Optional[TapCollector] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, row_axis=None) -> torch.Tensor:
        """A train-mode forward given a generator draws the neighbour
        sample from it first, then the dropout masks, as JAX splits its
        key. It has no row-block route (``row_axis`` is always None)."""
        adj = self.adj
        k = self.num_sampled_nodes_per_hop
        if train and generator is not None and k is not None:
            adj = adj * sample_neigh_adj(generator, adj, k)
        return self._propagate(adj, x_indices, taps, generator, train)

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GraphSAGEConv(in_channels, out_channels, name=name, **kwargs)


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
        # the fused aggregation's a_sym and degrees, one form per adj value
        self.ste_forms = SteForms()
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
            if ((taps is not None and taps.perturbed)
                    or torch._C._are_functorch_transforms_active()):
                # Under an inner vjp (the KFAC pullback, whose taps perturb
                # the op's input, and the curvature's Jacobians) JAX
                # differentiates the fused op's forward rule as plain code
                # in the outer (marglik) derivative, where the threshold has
                # zero gradient, so the JAX package's fused hyperstep
                # gradient w.r.t. adj is exactly zero. Detaching here
                # reproduces that.
                adj = adj.detach()
            return FusedAdjOp(lambda s: self.ste_forms.aggregate(
                adj, s, self.threshold, self.symmetric, self.sign_grad,
                self.grad_adj_mask))
        with annotate("ste.composed"):
            count("ste.composed.forms")
            if self.symmetric:
                adj = (adj + adj.T) / 2
            adj = binarize_ste(adj, self.threshold, self.grad_adj_mask,
                               self.sign_grad)
            return normalize_adj(fill_diagonal(adj, 1.0))

    def form_adj(self, params: dict) -> None:
        if self.fused:
            adj = params["adj"]
            self.ste_forms.form(adj, self.threshold, self.symmetric,
                                adj.dtype)

    def has_row_route(self) -> bool:
        """The composed path only: ``fused=True`` keeps the square
        adjacency, which ``core_spmm`` reads whole."""
        return not self.fused

    def row_block_adj(self, ax, taps: Optional[TapCollector] = None):
        """The normalized STE aggregation from the rank's row block of
        ``adj`` (``parallel.sharded.ste_row_block``)."""
        return _ste_rows(self, self.adj, ax, self.symmetric,
                         self.sign_grad)

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GCNConv(in_channels, out_channels, name=name, **kwargs)


def _ste_rows(model, raw_blk, ax, symmetric, sign_grad=False):
    """The rank's row-block operator of ``normalize_adj(fill_diagonal(
    binarize_ste(raw), 1))`` from its row block of ``raw``, with the STE
    mask's rows."""
    from ..parallel.mesh import rank_rows
    from ..parallel.sharded import ste_row_block
    mask = model.grad_adj_mask
    if mask is not None:
        mask = rank_rows(mask, ax)
    return ste_row_block(raw_blk, ax, model.threshold, mask, sign_grad,
                         symmetric)


class STEGraphSAGE(BaseGNN):
    """SAGE over the straight-through binarized learnable adjacency, which
    it uses without normalization or self-loops, as the JAX package does.
    It takes ``num_sampled_nodes_per_hop`` and, like JAX, never samples."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers,
                 X, init_adj, num_sampled_nodes_per_hop: Optional[int] = None,
                 dropout_p=0.5, act="relu", act_kwargs=None,
                 threshold: float = 0.5, train_masked_update: bool = False,
                 train_nodes=None, symmetric: bool = False,
                 sign_grad: bool = False, **kwargs):
        init_adj = fill_diagonal_any(init_adj, 0.0)
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, init_adj, dropout_p, act, act_kwargs,
                         symmetric=symmetric, **kwargs)
        self.threshold = threshold
        self.sign_grad = sign_grad
        self.num_sampled_nodes_per_hop = num_sampled_nodes_per_hop
        self.grad_adj_mask = _hard_mask(self, train_masked_update,
                                        train_nodes)

    def full_adj(self, params):
        return (params["adj"] > self.threshold).to(params["adj"].dtype)

    def forward_adj(self, taps: Optional[TapCollector] = None):
        adj = self.adj
        if self.symmetric:
            adj = (adj + adj.T) / 2
        return binarize_ste(adj, self.threshold, self.grad_adj_mask,
                            self.sign_grad)

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GraphSAGEConv(in_channels, out_channels, name=name, **kwargs)


class LoRASTEGCN(BaseGNN):
    """STE-GCN whose adjacency update is low-rank:
    ``STE(adj + B @ A * lora_alpha / r)``. The trainer's hypersteps move
    ``adj_lora_A`` (r, N) and ``adj_lora_B`` (N, r), not ``adj``."""

    adj_params = ("adj_lora_A", "adj_lora_B")

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers,
                 X, init_adj, r: int, lora_alpha: float, dropout_p=0.5,
                 act="relu", act_kwargs=None, threshold: float = 0.5,
                 symmetric: bool = False, **kwargs):
        # set before the base draws: _draw reads r
        self.threshold = threshold
        self.r = r
        self.lora_alpha = lora_alpha
        self.scaling = lora_alpha / r
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, init_adj, dropout_p, act, act_kwargs,
                         symmetric=symmetric, **kwargs)

    def _draw(self, generator: torch.Generator) -> dict:
        out = super()._draw(generator)
        n = self.init_adj.shape[0]
        dtype = self._conv_kwargs["dtype"]
        # kaiming_uniform(a=sqrt(5)) on (r, N): bound 1 / sqrt(N)
        bound = 1.0 / math.sqrt(n)
        u = torch.rand((self.r, n), generator=generator, dtype=torch.float64)
        out["adj_lora_A"] = (u * 2 * bound - bound).to(dtype)
        out["adj_lora_B"] = torch.randn((n, self.r), generator=generator,
                                        dtype=torch.float64).to(dtype)
        return out

    def full_adj(self, params):
        return (params["adj"] > self.threshold).to(params["adj"].dtype)

    def forward_adj(self, taps: Optional[TapCollector] = None):
        adj = self.adj + (self.adj_lora_B @ self.adj_lora_A) * self.scaling
        if self.symmetric:
            adj = (adj + adj.T) / 2
        adj = binarize_ste(adj, self.threshold)
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

    def has_row_route(self) -> bool:
        """When every conv takes the row-sharded attention
        (``parallel.make_row_sharded_gat_attention``)."""
        from ..parallel.sharded import RowShardedAttention
        return all(isinstance(c.attention_impl, RowShardedAttention)
                   for c in self.convs)

    def row_block_adj(self, ax, taps: Optional[TapCollector] = None):
        """The rank's row block of the mask, which the row-sharded
        attention reads."""
        return self.forward_adj(taps)

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


class AttSTEGCN(BaseGNN):
    """GCN on an adjacency built by scaled dot-product attention over the
    node features, clipped to [0, 1], then STE-binarized. The projection
    ``adj_W`` (a bias-free ``Linear(in, d_k)``, untapped) is named so that
    the ``adj`` filters keep it out of the posterior and out of both of
    the trainer's optimizers, as in JAX: it is never trained."""

    def __init__(self, in_channels, hidden_channels, out_channels, num_layers,
                 X, init_adj, dropout_p=0.5, act="relu", act_kwargs=None,
                 threshold: float = 0.5, train_masked_update: bool = False,
                 train_nodes=None, symmetric: bool = False, d_k: int = 8,
                 **kwargs):
        self.d_k = d_k                   # set before the base draws adj_W
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, init_adj, dropout_p, act, act_kwargs,
                         symmetric=symmetric, **kwargs)
        self.threshold = threshold
        self.scale = math.sqrt(d_k)
        self.grad_adj_mask = _hard_mask(self, train_masked_update,
                                        train_nodes)
        #: None, or a 'graph' row placement (``parallel.graph_sharding``,
        #: JAX's sharding constraint on the score matrix): each rank then
        #: runs on its row block, building its rows of the score, the STE
        #: and the normalization (``parallel.sharded``)
        self.adj_constraint = None

    def _draw(self, generator: torch.Generator) -> dict:
        out = super()._draw(generator)
        out["adj_W"] = Linear(self.in_channels, self.d_k, bias=False,
                              name="adj_W", generator=generator,
                              dtype=self._conv_kwargs["dtype"])
        return out

    def construct_adj(self) -> torch.Tensor:
        src = self.adj_W(self.X.to(self.adj.dtype))
        return _clip01((src @ src.T) / self.scale)

    def has_row_route(self) -> bool:
        return True

    def row_block_adj(self, ax, taps: Optional[TapCollector] = None):
        """The rank's rows of the score matrix (its rows of the projection
        against every rank's, one all-gather), then the STE-GCN row-block
        aggregation."""
        from ..parallel.collectives import all_gather
        from ..parallel.mesh import rank_rows
        src_blk = self.adj_W(rank_rows(self.X, ax).to(self.adj.dtype))
        src_all = all_gather(src_blk, ax)
        rows = _clip01((src_blk @ src_all.T) / self.scale)      # S[rows, :]
        return _ste_rows(self, rows, ax, self.symmetric)

    def forward_adj(self, taps: Optional[TapCollector] = None):
        adj = self.construct_adj()
        if self.symmetric:
            adj = (adj + adj.T) / 2
        adj = binarize_ste(adj, self.threshold, self.grad_adj_mask)
        return normalize_adj(fill_diagonal(adj, 1.0))

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GCNConv(in_channels, out_channels, name=name, **kwargs)


def _clip01(score: torch.Tensor) -> torch.Tensor:
    """hardtanh(0, 1) with JAX's clip gradient at ties (half a side)."""
    return torch.minimum(torch.maximum(score, score.new_zeros(())),
                         score.new_ones(()))


def _hard_mask(model: BaseGNN, train_masked_update: bool, train_nodes):
    """The 0/1 STE gradient mask of ``train_masked_update`` (zero on the
    train x train block), or None."""
    if not train_masked_update:
        return None
    if train_nodes is None:
        raise ValueError("'train_nodes' must be provided to use "
                         "train_masked_update.")
    return train_adj_mask(model.init_adj.shape[0], train_nodes,
                          model.init_adj.device, model.init_adj.dtype)


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    """``None``, a ``torch.dtype`` or its name (``"int8"``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


MODEL_REGISTRY = {
    "gcn": GCN,
    "stegcn": STEGCN,
    "lorastegcn": LoRASTEGCN,
    "gat": GAT,
    "graphsage": GraphSAGE,
    "stegraphsage": STEGraphSAGE,
    "attstegcn": AttSTEGCN,
}
