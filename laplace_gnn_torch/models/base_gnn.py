"""BaseGNN as an ``nn.Module`` applied functionally.

Counterpart of ``laplace_gnn_tpu/models/base_gnn.py``. The model holds the
full node-feature matrix ``X`` (a buffer) and its parameters under the JAX
pytree names:

    adj                   (N, N) adjacency, excluded from the posterior
    convs.<i>.lin.weight  (out, in)
    convs.<i>.lin.bias    (out,)

``apply(params, x_indices)`` runs every layer on the full graph through
``torch.func.functional_call`` over a flat ``{name: tensor}`` dict and
slices the requested output rows at the end.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..nn.module import (TapCollector, activation_resolver, dropout,
                         make_norm)
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
    return clone


class BaseGNN(nn.Module):
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
        if res:
            raise NotImplementedError(
                "residual Linear layers are not ported yet (see ROADMAP.md)")
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
        self.n_outputs = out_channels
        self.norms = [make_norm(norm, hidden_channels, name=f"norms.{i}")
                      for i in range(num_layers - 1)]

        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        convs = []
        in_ch = in_channels
        if num_layers > 1:
            convs.append(self.init_conv(in_ch, hidden_channels, name="convs.0",
                                        generator=gen, dtype=dtype, **kwargs))
            in_ch = hidden_channels
        for i in range(num_layers - 2):
            convs.append(self.init_conv(in_ch, hidden_channels,
                                        name=f"convs.{i + 1}", generator=gen,
                                        dtype=dtype, **kwargs))
        if out_channels is not None:
            convs.append(self.init_conv(in_ch, out_channels,
                                        name=f"convs.{len(convs)}",
                                        generator=gen, dtype=dtype, **kwargs))
        self.adj = nn.Parameter(init.clone())
        self.convs = nn.ModuleList(convs).to(dev)

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

    # --- params -----------------------------------------------------------
    def params(self) -> dict:
        """The model's own parameters as a flat dict in JAX tree order."""
        return dict(named_leaves(dict(self.named_parameters())))

    def full_adj(self, params: dict) -> torch.Tensor:
        return params["adj"]

    def jvp_safe(self) -> "BaseGNN":
        """Clone whose ``attention_impl="flash"`` convs run the plain
        attention instead, sharing every parameter and buffer.

        The flash Function has a kernel for its backward and no forward-mode
        rule, so ``torch.func.jvp`` (the mixed-diagonal KFAC blocks) and a
        second derivative cannot pass through it. Curvature code calls this
        before closing over the model; training and inference keep the
        kernels. Both paths compute the same math. Callable impls are kept
        (they are plain PyTorch). Returns ``self`` when nothing needs
        stripping."""
        if not any(getattr(c, "attention_impl", None) == "flash"
                   for c in self.convs):
            return self
        convs = []
        for c in self.convs:
            if getattr(c, "attention_impl", None) == "flash":
                c = _shallow_clone(c)
                c.attention_impl = None
            convs.append(c)
        m = _shallow_clone(self)
        m.convs = nn.ModuleList(convs)
        return m

    # --- forward ----------------------------------------------------------
    def forward(self, x_indices=None, taps: Optional[TapCollector] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> torch.Tensor:
        adj = self.forward_adj(taps)
        x = self.X.to(self.adj.dtype)
        for i in range(self.num_layers - 1):
            x = self.norms[i](self.convs[i](adj, x, taps=taps))
            x = self.act(x)
            x = dropout(x, self.dropout_p, train, generator)
        x = self.convs[-1](adj, x, taps=taps)
        return x if x_indices is None else x[x_indices]

    def apply(self, params: dict, x_indices=None,
              taps: Optional[TapCollector] = None,
              generator: Optional[torch.Generator] = None,
              train: bool = False) -> torch.Tensor:
        """Forward with the parameters taken from ``params``."""
        return functional_call(self, params, (x_indices,),
                               {"taps": taps, "generator": generator,
                                "train": train})

    # --- introspection for Laplace / KFAC ---------------------------------
    def tap_sites(self, params: Optional[dict] = None) -> list[dict]:
        sites = []
        for i, conv in enumerate(self.convs):
            for s in conv.tap_sites():
                sites.append({**s, "param_path": ("convs", i)
                              + s["param_path"]})
        return sites

    def last_layer_path(self, params: Optional[dict] = None) -> tuple:
        return ("convs", len(self.convs) - 1, "lin")
