"""GNNs over a fixed SparseGraph, the scale path.

Counterpart of ``laplace_gnn_tpu/models/sparse_gnn.py``. The adjacency
lives in a :class:`~laplace_gnn_torch.graph.container.SparseGraph` (the
normalization folded into the edge weights) instead of an N x N parameter;
the taps, KFAC, the Laplace flavours and the marglik see only the dense
layers, so they work unchanged. Parameters are named as the JAX pytree
paths (``convs.<i>.lin.weight``, GAT's ``convs.<i>.att_src``), with no
``adj`` entry.

On a sharded graph (``parallel.HaloAggGraph`` / ``DcnAggGraph``, whose
``row_axis`` the model reads) X is the rank's row block (the graph's
``put``), every layer runs on the rank's rows, and the selected output
rows come out whole on every rank.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from ..graph.container import (FastAggGraph, SparseGraph,
                               ell_aggregate_edge_coeff, ell_edge_slots,
                               ell_gat_attention, ell_gat_layout, gather,
                               segment_sum, _leaky_relu, _torch_dtype)
from ..nn.module import Linear, TapCollector, activation_resolver, dropout
from ..profiling import count, spanned, tracing
from ..utils.pytree import named_leaves
from .base_gnn import BaseGNN, _as_tensor, select_rows
from .layers import GCNConv


class SparseSAGEConv(nn.Module):
    """GraphSAGE over a SparseGraph: ``lin([x, graph.spmm(x)])``. Build the
    graph with ``normalize='row'`` so the SpMM is the mean aggregation."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 name: str = "conv", generator=None, dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.lin = Linear(2 * in_channels, out_channels, bias=bias, name=name,
                          generator=generator, dtype=dtype)
        self.name = name

    def forward(self, graph, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        h = torch.cat([x, graph.spmm(x)], dim=-1)
        return self.lin(h, taps=taps)

    def tap_sites(self) -> list[dict]:
        return [{"name": self.name, "param_path": ("lin",),
                 "has_bias": self.lin.use_bias}]


class SparseGATConv(nn.Module):
    """GAT attention over the edges of a SparseGraph: the edge softmax runs
    over each row's edges (segment max and sum over the dst-sorted edges,
    or the ELL layout's padded axis), so no N x N score matrix is formed.
    The parameters are those of the dense ``GATConv``. Pass a graph with
    self-loops and no normalization."""

    def __init__(self, in_channels: int, out_channels: int, heads: int,
                 negative_slope: float = 0.2, concat: bool = True,
                 bias: bool = True, name: str = "conv", generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.heads = heads
        self.negative_slope = negative_slope
        self.concat = concat
        self.use_bias = bias
        self.name = name
        self.lin = Linear(in_channels, heads * out_channels, bias=False,
                          name=name, generator=generator, dtype=dtype)
        bound = math.sqrt(6.0 / (1 + heads * out_channels))

        def uniform(*shape):
            u = torch.rand(*shape, generator=generator, dtype=torch.float64)
            return (u * 2 * bound - bound).to(dtype)

        self.att_src = nn.Parameter(uniform(1, heads, out_channels))
        self.att_dst = nn.Parameter(uniform(1, heads, out_channels))
        self.bias = (nn.Parameter(torch.zeros(
            out_channels * (heads if concat else 1), dtype=dtype))
            if bias else None)

    def forward(self, graph, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        n = x.shape[0]
        h = self.lin(x, taps=taps).reshape(n, self.heads, self.out_channels)
        a_src = torch.sum(h * self.att_src, dim=-1)                 # (N, H)
        a_dst = torch.sum(h * self.att_dst, dim=-1)
        if tracing():
            g = getattr(graph, "graph", graph)       # unwrap the wrapper
            count("gat.calls")
            count("gat.edge_columns",
                  g.n_edges * self.heads * self.out_channels)
            out = spanned("gat.attention", self._attend, graph, h, a_src,
                          a_dst)
        else:
            out = self._attend(graph, h, a_src, a_dst)
        if self.concat:
            out = out.reshape(n, self.heads * self.out_channels)
        else:
            out = torch.mean(out, dim=1)
        return out + self.bias if self.bias is not None else out

    def _attend(self, graph, h: torch.Tensor, a_src: torch.Tensor,
                a_dst: torch.Tensor) -> torch.Tensor:
        """The edge softmax and the aggregation, (N, H, F)."""
        g = getattr(graph, "graph", graph)           # unwrap FastAggGraph
        if hasattr(graph, "gat_aggregate"):          # a sharded graph
            return graph.gat_aggregate(h, self.att_src, self.att_dst,
                                       self.negative_slope)
        if g.format == "ell" and g.ell_cols is not None:
            # the softmax and the aggregation in the ELL layout: one payload
            # gather per tier, no per-edge work for ELL-resident edges
            layout = getattr(graph, "_gat_layout", None)
            if layout is None:
                layout = ell_gat_layout(g)
                if graph is not g:                   # cache on the wrapper
                    graph._gat_layout = layout
            return ell_gat_attention(g, layout, h, a_src, a_dst,
                                     self.negative_slope)
        return segment_attention(graph, h, a_src, a_dst,
                                 self.negative_slope)

    @staticmethod
    def _aggregate_messages(graph, g, coeff, h):
        """The (E, H, F) message sum, on the multi-level ELL gather path
        with run-time coefficients when the graph has one, in
        ``agg_dtype`` on either path."""
        if g.format == "ell" and g.ell_cols is not None:
            slots = getattr(graph, "_gat_slots", None)
            if slots is None:
                slots = ell_edge_slots(g)
                if graph is not g:                   # cache on the wrapper
                    graph._gat_slots = slots
            return ell_aggregate_edge_coeff(g, slots, coeff, h)
        in_dtype = h.dtype
        agg = _torch_dtype(g.agg_dtype) or in_dtype
        msgs = coeff.to(agg)[:, :, None] * gather(h.to(agg),
                                                  g.segments("src"))
        return segment_sum(msgs, g.segments("dst")).to(in_dtype)

    def tap_sites(self) -> list[dict]:
        # the Linear is the only dense site; the attention vectors and the
        # bias get exact-diagonal blocks under the mixed KFAC
        return [{"name": self.name, "param_path": ("lin",),
                 "has_bias": False, "kfac_incomplete": True}]


def segment_attention(graph, h: torch.Tensor, a_src: torch.Tensor,
                      a_dst: torch.Tensor,
                      negative_slope: float) -> torch.Tensor:
    """GAT's edge softmax over each row's dst-sorted edges and the
    aggregation, ``out[i] = sum_{e: dst_e = i} softmax_e(leaky_relu(
    a_src[src_e] + a_dst[i])) h[src_e]`` for (N, H, F) ``h``."""
    g = getattr(graph, "graph", graph)               # unwrap FastAggGraph
    seg = g.segments("dst")
    scores = _leaky_relu(gather(a_src, g.segments("src"))
                         + gather(a_dst, seg), negative_slope)      # (E, H)
    # the row maxima are a shift that cancels in the softmax
    smax = seg.reduce(scores.detach(), "max")
    ex = torch.exp(scores - seg.gather(smax))
    denom = segment_sum(ex, seg)
    coeff = ex / torch.clamp_min(gather(denom, seg), 1e-16)         # (E, H)
    return SparseGATConv._aggregate_messages(graph, g, coeff, h)


class SparseGCN(nn.Module):
    """GCN over a SparseGraph; the hyperparameters of GCN, parameters
    ``convs.*`` (and ``res.*`` / ``norms.*``), no ``adj``. The graph is
    wrapped in a :class:`FastAggGraph`, whose SpMM runs the sorted / ELL
    aggregation in both directions. Built on ``cuda`` unless the caller
    passes ``device="cpu"``; the graph must live on the same device."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int, X,
                 graph: Union[SparseGraph, FastAggGraph],
                 dropout_p: float = 0.5,
                 act: Union[str, Callable, None] = "relu",
                 act_kwargs: Optional[Dict[str, Any]] = None,
                 norm: Optional[str] = None, res: bool = False,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(graph, SparseGraph):
            graph = FastAggGraph(graph)
        gdev = graph.graph.device
        if gdev.type != dev.type or dev.index not in (None, gdev.index):
            raise ValueError(f"the graph is on {gdev}, the model on {dev}")
        self.graph = graph
        self.register_buffer("X", _as_tensor(X, dtype, dev),
                             persistent=False)
        self.in_channels = in_channels
        self.hidden_channels = hidden_channels
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.dropout_p = dropout_p
        self.act = activation_resolver(act, **(act_kwargs or {}))
        self.norm = norm
        self.use_res = res
        self.n_outputs = out_channels
        widths = [hidden_channels] * (num_layers - 1) + [out_channels]
        self._conv_specs = list(zip([in_channels] + widths[:-1], widths))
        self._conv_kwargs = dict(kwargs, dtype=dtype)
        self._device = dev
        ax = self.row_axis
        if ax is not None and self.X.shape[0] * ax.size != graph.n_nodes:
            raise ValueError(f"X has {self.X.shape[0]} rows: on a graph "
                             f"sharded over {ax.size} ranks a model takes "
                             f"the rank's block of the features (the "
                             f"graph's put)")
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        for attr, module in self._draw(gen).items():
            setattr(self, attr, module.to(dev))
        self.first_tap_static = True
        self.last_layer_closed_form = False

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return GCNConv(in_channels, out_channels, name=name, **kwargs)

    # the parameter draw, the parameter dict, functional application and
    # the KFAC introspection are BaseGNN's, which reads only the fields
    # set above
    _draw = BaseGNN._draw
    params = BaseGNN.params
    apply = BaseGNN.apply
    features = BaseGNN.features
    tap_sites = BaseGNN.tap_sites
    last_layer_path = BaseGNN.last_layer_path
    _require_row_route = BaseGNN._require_row_route

    @property
    def n_nodes(self) -> int:
        return int(self.graph.n_nodes)

    @property
    def row_axis(self):
        """The axis of a sharded graph's row blocks, or None."""
        return getattr(self.graph, "row_axis", None)

    def _row_axis_for(self, adj_constraint):
        if adj_constraint is not None:
            raise ValueError("a sparse model's rows follow its graph: "
                             "build it on a sharded graph instead")
        return self.row_axis

    def has_row_route(self) -> bool:
        return True

    def rank_features(self) -> torch.Tensor:
        return self.X

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Fresh parameters drawn from ``generator`` (seeded with 0 unless
        given) as the constructor draws them."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        fresh = {f"{attr}.{name}": p.detach().to(self._device)
                 for attr, module in self._draw(gen).items()
                 for name, p in module.named_parameters()}
        return dict(named_leaves(fresh))

    def forward(self, x_indices=None, taps: Optional[TapCollector] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, row_axis=None) -> torch.Tensor:
        """Every layer on the whole graph (or the rank's rows of it) in the
        JAX order: conv, ``+ res(x)`` (untapped), norm, act, dropout; then
        the rows ``x_indices``."""
        x = self.X
        for i in range(self.num_layers - 1):
            h = self.convs[i](self.graph, x, taps=taps)
            if self.use_res:
                h = self.res[i](x) + h
            x = self.act(self.norms[i](h, row_axis=row_axis))
            x = (dropout(x, self.dropout_p, train, generator)
                 if row_axis is None else
                 dropout(x, self.dropout_p, train, generator, row_axis))
        x = self.convs[-1](self.graph, x, taps=taps)
        return select_rows(x, x_indices, row_axis)


class SparseSAGE(SparseGCN):
    """GraphSAGE over a SparseGraph: mean aggregation, concat and a Linear
    per layer. Build the graph with ``normalize='row'``. It aggregates
    every neighbour (no per-forward neighbour sample, unlike the dense
    ``GraphSAGE``)."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers, X, graph, **kwargs):
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, graph, **kwargs)
        # the first tap sees [X, agg X]: constant, but not X^T X
        self.first_tap_static = False

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        return SparseSAGEConv(in_channels, out_channels, name=name, **kwargs)


class SparseGCNIIConv(nn.Module):
    """One GCNII layer over a SparseGraph (Chen et al., ICML 2020):
    ``ReLU((1 - theta) S + theta S W^T)`` with the initial residual
    ``S = (1 - alpha) graph.spmm(x) + alpha h0``. The weight is a
    bias-free Linear's (``lin.weight``, (out, in)); the layer is no KFAC
    site. Build the graph with ``normalize='sym'`` and self-loops."""

    def __init__(self, channels: int, alpha: float, theta: float,
                 name: str = "conv", generator=None, dtype=torch.float32):
        super().__init__()
        self.lin = Linear(channels, channels, bias=False, name=name,
                          generator=generator, dtype=dtype)
        self.alpha, self.theta, self.name = alpha, theta, name

    def forward(self, graph, x: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
        if tracing():
            count("gcnii.calls")
            return spanned("gcnii.conv", self._layer, graph, x, h0)
        return self._layer(graph, x, h0)

    def _layer(self, graph, x, h0):
        s = torch.lerp(graph.spmm(x), h0, self.alpha)
        return torch.relu(torch.addmm(s, s, self.lin.weight.T,
                                      beta=1 - self.theta,
                                      alpha=self.theta))

    def tap_sites(self) -> list[dict]:
        return []


class _LinearLayer(nn.Module):
    """A Linear in a model's ``convs`` (parameters ``convs.<i>.lin.*``):
    GCNII's input and output layers, which aggregate nothing."""

    def __init__(self, in_channels: int, out_channels: int, name: str,
                 generator=None, dtype=torch.float32):
        super().__init__()
        self.lin = Linear(in_channels, out_channels, name=name,
                          generator=generator, dtype=dtype)
        self.name = name

    def forward(self, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        return self.lin(x, taps=taps)

    def tap_sites(self) -> list[dict]:
        return [{"name": self.name, "param_path": ("lin",),
                 "has_bias": True}]


class SparseGCNII(SparseGCN):
    """GCNII over a SparseGraph (Chen et al., "Simple and Deep Graph
    Convolutional Networks", ICML 2020): ``H_0 = ReLU(X W_in^T + b_in)``,
    ``num_layers`` :class:`SparseGCNIIConv` layers that each read
    ``H_0``, layer ``l`` with ``theta_l = ln(lamda / l + 1)``, then the
    output Linear. Parameters: ``convs.0.lin.*`` (input), ``convs.<l>.lin.
    weight`` for l = 1..num_layers, ``convs.<num_layers + 1>.lin.*``
    (output). Dropout where the source has it: on X and on each layer's
    input. ``param_groups`` gives the source's two weight decays. The
    KFAC sites are the two Linears': a Kron posterior over every weight
    gives the convs' weights diagonal blocks (the mixed KFAC)."""

    #: the source's weight decays (its ``--wd1`` / ``--wd2`` defaults): the
    #: convs' weights, then the input and output Linears'
    weight_decays = (0.01, 5e-4)

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers, X, graph, alpha: float = 0.1,
                 lamda: float = 0.5, dropout_p: float = 0.6, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, graph, dropout_p=dropout_p,
                         device=device, dtype=dtype, generator=generator,
                         alpha=alpha, lamda=lamda)

    def _draw(self, generator: torch.Generator) -> dict:
        kw = self._conv_kwargs
        hidden, L = self.hidden_channels, self.num_layers
        mk = dict(generator=generator, dtype=kw["dtype"])
        convs = [_LinearLayer(self.in_channels, hidden, "convs.0", **mk)]
        convs += [SparseGCNIIConv(hidden, kw["alpha"],
                                  math.log(kw["lamda"] / l + 1),
                                  name=f"convs.{l}", **mk)
                  for l in range(1, L + 1)]
        convs.append(_LinearLayer(hidden, self.out_channels,
                                  f"convs.{L + 1}", **mk))
        return {"convs": nn.ModuleList(convs)}

    def param_groups(self, params: dict) -> list:
        """``params`` in torch's param-group form with the source's two
        weight decays: the convs' weights, then the input and output
        Linears' weights and biases."""
        dense = ("convs.0.", f"convs.{self.num_layers + 1}.")
        wd_conv, wd_linear = self.weight_decays
        return [{"params": [v for k, v in params.items()
                            if not k.startswith(dense)],
                 "weight_decay": wd_conv},
                {"params": [v for k, v in params.items()
                            if k.startswith(dense)],
                 "weight_decay": wd_linear}]

    def forward(self, x_indices=None, taps: Optional[TapCollector] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, row_axis=None) -> torch.Tensor:
        """The source's order: dropout, the input Linear and ReLU
        (``H_0``); each conv on the dropped-out previous layer and
        ``H_0``; dropout and the output Linear; then the rows
        ``x_indices``."""
        def drop(x):
            return dropout(x, self.dropout_p, train, generator, row_axis)

        h0 = torch.relu(self.convs[0](drop(self.X), taps=taps))
        x = h0
        for conv in self.convs[1:-1]:
            x = conv(self.graph, drop(x), h0)
        x = self.convs[-1](drop(x), taps=taps)
        return select_rows(x, x_indices, row_axis)


class SparseGAT(SparseGCN):
    """GAT over a SparseGraph with a per-edge softmax. Pass a graph with
    self-loops and ``normalize=None``. With ``concat`` each layer's output
    channels are split over the ``heads``, which must divide them. With
    ``mean_output_heads`` the output layer averages its heads instead
    (``out_channels`` a head, the bias after the mean: the GAT paper's
    output layer), whatever ``concat`` says of the hidden layers."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 num_layers, X, graph, heads: int = 1, concat: bool = True,
                 mean_output_heads: bool = False, **kwargs):
        super().__init__(in_channels, hidden_channels, out_channels,
                         num_layers, X, graph, heads=heads, concat=concat,
                         mean_output_heads=mean_output_heads, **kwargs)
        self.first_tap_static = False
        # the plans of the attention's gathers are formed here, outside the
        # curvature's torch.func transforms (a HaloAggGraph has its own)
        g = self.graph.graph
        if hasattr(self.graph, "gat_aggregate"):
            pass
        elif g.format == "ell" and g.ell_cols is not None:
            self.graph._gat_layout = ell_gat_layout(g)
        else:
            g.segments("src")

    def init_conv(self, in_channels, out_channels, name, **kwargs):
        heads = kwargs.pop("heads")
        concat = kwargs.pop("concat")
        if kwargs.pop("mean_output_heads") and \
                name == f"convs.{self.num_layers - 1}":
            concat = False
        if concat and out_channels % heads != 0:
            raise ValueError(
                f"Ensure that the number of output channels of "
                f"'SparseGATConv' (got '{out_channels}') is divisible by the "
                f"number of heads (got '{heads}')")
        return SparseGATConv(in_channels,
                             out_channels // (heads if concat else 1),
                             heads=heads, concat=concat, name=name, **kwargs)
