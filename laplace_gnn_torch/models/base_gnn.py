"""BaseGNN as an ``nn.Module`` applied functionally.

Counterpart of ``laplace_gnn_tpu/models/base_gnn.py``. The model holds the
full node-feature matrix ``X`` (a buffer) and its parameters under the JAX
pytree names:

    adj                   (N, N) adjacency, excluded from the posterior
    convs.<i>.lin.weight  (out, in)
    convs.<i>.lin.bias    (out,)
    res.<i>.weight/.bias  residual Linears of the hidden layers (res=True)
    norms.<i>.weight/.bias  LayerNorm / BatchNorm of the hidden layers,
                          excluded from the posterior

and whatever a model adds (``adj_lora_A`` / ``adj_lora_B``, ``adj_W``).

``apply(params, x_indices)`` runs every layer on the full graph through
``torch.func.functional_call`` over a flat ``{name: tensor}`` dict and
slices the requested output rows at the end.

On a sharded graph (``apply(..., adj_constraint=graph_sharding(mesh))``,
or a :meth:`BaseGNN.placed` clone) a model with a row-block route runs
every layer on its rank's row block: ``params["adj"]`` is the rank's row
block, the whole parameters enter through ``collectives.replicate`` once
(so their gradients sum over the ranks), X's rows are the rank's, and the
selected output rows are gathered whole on every rank
(``collectives.gather_selected``). X stays whole on the model: it is
small beside the N x N adjacency.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..nn.module import (Linear, TapCollector, activation_resolver,
                         dropout, make_norm)
from ..parallel.collectives import gather_selected, replicate
from ..parallel.mesh import rank_rows
from ..utils.pytree import named_leaves


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _shallow_clone(module: nn.Module) -> nn.Module:
    """A new module object that shares the parameters, buffers and
    submodules of ``module``, with registries of its own (so assigning a
    submodule or attribute on the clone leaves ``module`` as it was)."""
    clone = copy.copy(module)
    for key in ("_parameters", "_buffers", "_modules"):
        clone.__dict__[key] = dict(module.__dict__[key])
    # the whole-run programs are keyed by configuration, not by this clone
    clone.__dict__.pop("_program_cache", None)
    return clone


def _plain_attention(impl):
    """``impl`` without a kernel that lacks a forward-mode rule: None for
    "flash", a callable's ``jvp_safe()`` twin where it has one."""
    if impl == "flash":
        return None
    twin = getattr(impl, "jvp_safe", None)
    return twin() if callable(twin) else impl


def _graph_axis(constraint):
    """The graph axis of a row placement, or None (no placement)."""
    if constraint is None:
        return None
    from ..parallel.sharded import graph_axis_of
    ax = graph_axis_of(constraint)
    if ax is None:
        raise ValueError(f"adj_constraint must place rows on the 'graph' "
                         f"axis, got {constraint.spec}")
    return ax


def replicated_params(params: dict, ax, blocks=()) -> dict:
    """``params`` as a sharded forward takes them: every whole leaf
    through ``replicate`` (its gradient sums the ranks'), the leaves named
    in ``blocks`` (row blocks already) as they are."""
    return {k: v if k in blocks else replicate(v, ax)
            for k, v in params.items()}


class BaseGNN(nn.Module):
    # what the trainer's hypersteps step (JAX's ADJ_PARAM_FILTERS)
    adj_params = ("adj",)
    #: None, or a 'graph' row placement (``parallel.graph_sharding``) under
    #: which ``apply`` runs on the rank's row block (JAX's sharding
    #: constraint); ``placed`` sets it on a clone
    adj_constraint = None

    def __init__(self,
                 in_channels: int,
                 hidden_channels: int,
                 out_channels: int,
                 num_layers: int,
                 X,
                 init_adj,
                 dropout_p: float = 0.5,
                 act: Union[str, Callable, None] = "relu",
                 act_kwargs: Optional[Dict[str, Any]] = None,
                 norm: Optional[str] = None,
                 res: bool = False,
                 symmetric: bool = False,
                 device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 **kwargs):
        super().__init__()
        dev = resolve_device(device)
        vals = (init_adj.detach().cpu().numpy()
                if isinstance(init_adj, torch.Tensor) else np.asarray(init_adj))
        if not np.all((vals == 0) | (vals == 1)):
            raise ValueError("init_adj must be binary.")
        init = _as_tensor(vals, dtype, dev)
        if symmetric:  # treat as undirected
            init = torch.clamp(init + init.T, max=1.0)
        self.register_buffer("X", _as_tensor(X, dtype, dev), persistent=False)
        self.register_buffer("init_adj", init, persistent=False)

        self.symmetric = symmetric
        self.in_channels = in_channels
        self.hidden_channels = hidden_channels
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.dropout_p = dropout_p
        self.act = activation_resolver(act, **(act_kwargs or {}))
        self.norm = norm
        self.use_res = res
        self.n_outputs = out_channels

        # (in, out) channels of each conv, kept so init() can draw anew;
        # the hidden layers' residual Linears have the same widths
        widths = [hidden_channels] * (num_layers - 1)
        if out_channels is not None:
            widths.append(out_channels)
        self._conv_specs = list(zip([in_channels] + widths[:-1], widths))
        self._conv_kwargs = dict(kwargs, dtype=dtype)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.adj = nn.Parameter(init.clone())
        for attr, value in self._draw(gen).items():
            setattr(self, attr, nn.Parameter(value.to(dev))
                    if isinstance(value, torch.Tensor) else value.to(dev))

        # the first GCNConv consumes raw X, so its KFAC input covariance
        # X^T X / N is constant and the hyperstep caches its eigenvalues
        from .layers import GCNConv
        self.first_tap_static = isinstance(self.convs[0], GCNConv)

    # --- provided by subclasses -------------------------------------------
    def init_conv(self, in_channels: int, out_channels: int, name: str,
                  **kwargs):
        raise NotImplementedError

    def forward_adj(self, taps: Optional[TapCollector] = None):
        """Effective adjacency (or fused aggregation operator)."""
        raise NotImplementedError

    def _draw(self, generator: torch.Generator) -> dict:
        """Every parameter but ``adj``, drawn anew from ``generator`` in
        the constructor's order, by attribute: modules, or tensors that
        become parameters. Models with parameters of their own extend
        it."""
        dtype = self._conv_kwargs["dtype"]
        out = {"convs": nn.ModuleList([
            self.init_conv(i, o, name=f"convs.{k}", generator=generator,
                           **self._conv_kwargs)
            for k, (i, o) in enumerate(self._conv_specs)])}
        hidden = self._conv_specs[:self.num_layers - 1]
        if self.use_res:
            out["res"] = nn.ModuleList([
                Linear(i, o, name=f"res.{k}", generator=generator,
                       dtype=dtype) for k, (i, o) in enumerate(hidden)])
        out["norms"] = nn.ModuleList([
            make_norm(self.norm, self.hidden_channels, name=f"norms.{k}",
                      dtype=dtype) for k in range(self.num_layers - 1)])
        return out

    # --- params -----------------------------------------------------------
    def params(self) -> dict:
        """The model's own parameters as a flat dict in JAX tree order."""
        return dict(named_leaves(dict(self.named_parameters())))

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Fresh parameters drawn from ``generator`` (seeded with 0 unless
        given) as the constructor draws them, with the initial adjacency;
        the model's own parameters are left as they are (the JAX package's
        ``init(key)``)."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        dev = self.adj.device
        fresh = {}
        for attr, value in self._draw(gen).items():
            if isinstance(value, torch.Tensor):
                fresh[attr] = value.to(dev)
            else:
                fresh.update({f"{attr}.{name}": p.detach().to(dev)
                              for name, p in value.named_parameters()})
        return dict(named_leaves({"adj": self.init_adj.clone(), **fresh}))

    def full_adj(self, params: dict) -> torch.Tensor:
        return params["adj"]

    def form_adj(self, params: dict) -> None:
        """Form anew what the model holds between forwards that follows
        from ``params["adj"]``'s value (nothing here; the fused STE-GCN's
        aggregation inputs). A forward finds a changed value itself; code
        that replays CUDA graphs, which run no Python, calls this wherever
        the adjacency changes."""

    def reset_adj(self, params: dict) -> dict:
        """A new dict whose ``adj`` is a copy of the initial adjacency, in
        ``params["adj"]``'s dtype and on its device."""
        out = dict(params)
        out["adj"] = self.init_adj.to(dtype=params["adj"].dtype,
                                      device=params["adj"].device,
                                      copy=True)
        return out

    def jvp_safe(self) -> "BaseGNN":
        """Clone whose ``attention_impl="flash"`` convs run the plain
        attention instead, sharing every parameter and buffer.

        The flash Function has a kernel for its backward and no forward-mode
        rule, so ``torch.func.jvp`` (the mixed-diagonal KFAC blocks) and a
        second derivative cannot pass through it. Curvature code calls this
        before closing over the model; training and inference keep the
        kernels. Both paths compute the same math. A callable impl is kept,
        unless it offers a plain twin through its own ``jvp_safe()`` (the
        row-sharded flash attention of ``parallel.sharded``), which is then
        taken. Returns ``self`` when nothing needs stripping."""
        plain = [_plain_attention(getattr(c, "attention_impl", None))
                 for c in self.convs]
        if all(p is getattr(c, "attention_impl", None)
               for p, c in zip(plain, self.convs)):
            return self
        convs = []
        for c, impl in zip(self.convs, plain):
            if impl is not getattr(c, "attention_impl", None):
                c = _shallow_clone(c)
                c.attention_impl = impl
            convs.append(c)
        m = _shallow_clone(self)
        m.convs = nn.ModuleList(convs)
        return m

    # --- row blocks ------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return int(self.init_adj.shape[0])

    @property
    def row_axis(self):
        """The axis whose ranks hold this model's row blocks (from its
        ``adj_constraint``), or None: the curvature reads it."""
        return self._row_axis_for(None)

    def _row_axis_for(self, adj_constraint):
        return _graph_axis(adj_constraint if adj_constraint is not None
                           else self.adj_constraint)

    def has_row_route(self) -> bool:
        """True when the model runs on row blocks under a placement."""
        return False

    def row_block_adj(self, ax, taps: Optional[TapCollector] = None):
        """The rank's aggregation operator over row blocks (models with a
        row-block route override it)."""
        raise NotImplementedError

    def _require_row_route(self) -> None:
        if not self.has_row_route():
            raise ValueError(f"{type(self).__name__} has no row-block "
                             f"route: run it unplaced")

    def rank_features(self) -> torch.Tensor:
        """The rows of X this rank works on."""
        ax = self.row_axis
        return self.X if ax is None else rank_rows(self.X, ax)

    def placed(self, adj_constraint) -> "BaseGNN":
        """A clone sharing every parameter and buffer whose ``apply`` runs
        on the rank's row block under ``adj_constraint`` (a
        ``graph_sharding``), for code that calls ``apply`` without one
        (the curvature, the trainers). This model is left as it was."""
        if adj_constraint is not None:
            _graph_axis(adj_constraint)
            self._require_row_route()
        m = _shallow_clone(self)
        m.adj_constraint = adj_constraint
        # the KFAC's constant input covariance sums the rank's rows anew
        m.__dict__.pop("_static_input_cov", None)
        return m

    # --- forward ----------------------------------------------------------
    def forward(self, x_indices=None, taps: Optional[TapCollector] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, row_axis=None) -> torch.Tensor:
        adj = (self.forward_adj(taps) if row_axis is None
               else self.row_block_adj(row_axis, taps))
        return self._propagate(adj, x_indices, taps, generator, train,
                               row_axis)

    def _propagate(self, adj, x_indices, taps, generator, train,
                   row_axis=None):
        """Every layer over ``adj`` in the JAX order: conv, ``+ res(x)``
        (untapped, as in JAX), norm, act, dropout; then the rows
        ``x_indices``. With a ``row_axis`` every layer runs on the rank's
        rows (a BatchNorm's statistics and the dropout mask are those of
        the whole graph) and the selected rows are gathered whole."""
        x = self.X.to(self.adj.dtype)
        if row_axis is not None:           # X is whole on a dense model
            x = rank_rows(x, row_axis)
        for i in range(self.num_layers - 1):
            h = self.convs[i](adj, x, taps=taps)
            if self.use_res:
                h = self.res[i](x) + h
            x = self.act(self.norms[i](h, row_axis=row_axis))
            x = (dropout(x, self.dropout_p, train, generator)
                 if row_axis is None else
                 dropout(x, self.dropout_p, train, generator, row_axis))
        x = self.convs[-1](adj, x, taps=taps)
        return select_rows(x, x_indices, row_axis)

    def apply(self, params: dict, x_indices=None,
              taps: Optional[TapCollector] = None,
              generator: Optional[torch.Generator] = None,
              train: bool = False, adj_constraint=None) -> torch.Tensor:
        """Forward with the parameters taken from ``params``. Under a row
        placement (``adj_constraint``, else the model's own) ``params["
        adj"]`` is the rank's row block and the output rows ``x_indices``
        come out whole on every rank (with ``x_indices=None``, the rank's
        block)."""
        ax = self._row_axis_for(adj_constraint)
        if ax is not None:
            self._require_row_route()
            adj = params.get("adj")
            if adj is not None and adj.shape[0] * ax.size != self.n_nodes:
                raise ValueError(f"adj has {adj.shape[0]} rows: a row "
                                 f"placement takes the rank's block of "
                                 f"{self.n_nodes // ax.size}")
            params = replicated_params(params, ax, blocks=("adj",))
        return functional_call(self, params, (x_indices,),
                               {"taps": taps, "generator": generator,
                                "train": train, "row_axis": ax})

    # --- introspection for Laplace / KFAC ---------------------------------
    # The last Linear's output is aggregated before it becomes the model
    # output, so the closed-form (features x I) last-layer Jacobian is not
    # the model's: last-layer Laplace takes autodiff Jacobians here.
    last_layer_closed_form = False

    def features(self, params: dict, X=None) -> tuple:
        """(the last conv's tap input over the whole graph, the model
        output at ``X``)."""
        taps = TapCollector()
        f = self.apply(params, X, taps=taps)
        last = self.convs[-1].name
        return [a for n, a, _ in taps.records if n == last][-1], f

    def tap_sites(self, params: Optional[dict] = None) -> list[dict]:
        """Every conv's sites, then the residual Linears', as JAX lists
        them. The residual Linears record no tap (JAX applies them
        untapped too), so KFAC raises on a model with ``res=True``."""
        sites = []
        for i, conv in enumerate(self.convs):
            for s in conv.tap_sites():
                sites.append({**s, "param_path": ("convs", i)
                              + s["param_path"]})
        for i, r in enumerate(getattr(self, "res", ())):
            sites.append({"name": r.name, "param_path": ("res", i),
                          "has_bias": r.use_bias})
        return sites

    def last_layer_path(self, params: Optional[dict] = None) -> tuple:
        return ("convs", len(self.convs) - 1, "lin")


def select_rows(x: torch.Tensor, x_indices, row_axis) -> torch.Tensor:
    """``x[x_indices]``; on row blocks the selected rows gathered whole
    on every rank (``x_indices=None``: the rank's block)."""
    if x_indices is None:
        return x
    if row_axis is None:
        return x[x_indices]
    return gather_selected(x, x_indices, row_axis)
