"""Dense layers with KFAC taps, as ``nn.Module``s.

Counterpart of ``laplace_gnn_tpu/nn/module.py``. Parameters live in
``nn.Module``s whose dotted names follow the JAX pytree paths
(``convs.0.lin.weight``), and models are applied functionally over a flat
``{name: tensor}`` dict (``torch.func.functional_call``), so the adjacency
and any parameter subset can be differentiated the way the JAX package
differentiates a params pytree.

Dense layers route their pre-activation through ``taps.tap(name, a, s)``:
the KFAC input activations ``a`` are read off the tap records, and the
output gradients ``g = dL/ds`` come from differentiating w.r.t. a zero
perturbation ``eps`` added at the tap site (curvature/kfac.py). Weights are
stored ``(out_features, in_features)`` as in ``torch.nn.Linear``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class TapCollector:
    """Records ``(name, a, s)`` triples at dense-layer sites.

    ``eps`` adds a perturbation ``eps[name]`` to the pre-activation.
    ``perturb=True`` creates each missing perturbation as a zero tensor that
    requires grad, so one forward yields both the activations and the
    handles the KFAC pullbacks differentiate against."""

    def __init__(self, eps: Optional[dict] = None, perturb: bool = False):
        self.records: list[tuple[str, torch.Tensor, torch.Tensor]] = []
        self.eps = {} if (perturb and eps is None) else eps
        self.perturb = perturb

    @property
    def perturbed(self) -> bool:
        """True when pre-activations carry perturbations (a KFAC pass)."""
        return self.eps is not None

    def tap(self, name: str, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        if self.perturb and name not in self.eps:
            self.eps[name] = torch.zeros_like(s, requires_grad=True)
        if self.eps is not None and name in self.eps:
            s = s + self.eps[name]
        self.records.append((name, a, s))
        return s


def _tap(taps: Optional[TapCollector], name, a, s):
    return taps.tap(name, a, s) if taps is not None else s


ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "silu": F.silu,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def activation_resolver(act, **kwargs) -> Callable:
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    fn = ACTIVATIONS[act.lower()]
    if kwargs:
        return lambda x: fn(x, **kwargs)
    return fn


class Linear(nn.Module):
    """Dense layer with ``torch.nn.Linear``'s default init:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 name: str = "linear", generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.name = name
        bound = 1.0 / math.sqrt(in_features)

        def uniform(*shape):
            u = torch.rand(*shape, generator=generator, dtype=torch.float64)
            return (u * 2 * bound - bound).to(dtype)

        self.weight = nn.Parameter(uniform(out_features, in_features))
        self.bias = nn.Parameter(uniform(out_features)) if bias else None

    def forward(self, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        s = x @ self.weight.T
        if self.bias is not None:
            s = s + self.bias
        return _tap(taps, self.name, x, s)


class Identity(nn.Module):
    name = "identity"

    def forward(self, x, **_):
        return x


class _Norm(nn.Module):
    """Affine normalization over ``axis`` with the biased variance
    (``jnp.var``'s ddof 0), weight 1 and bias 0 at init."""

    axis: int

    def __init__(self, dim: int, eps: float = 1e-5, name: str = "norm",
                 dtype=torch.float32):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.name = name
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype))

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        mu = torch.mean(x, dim=self.axis, keepdim=True)
        var = torch.var(x, dim=self.axis, keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class LayerNorm(_Norm):
    """Normalization over each row's features."""

    axis = -1


class BatchNorm(_Norm):
    """Normalization over axis 0 with the batch statistics, and no running
    buffers: full-graph training shows every forward the whole graph, so
    the batch statistics are the only statistics there are."""

    axis = 0


def make_norm(norm: Optional[str], dim: int, name: str = "norm",
              dtype=torch.float32) -> nn.Module:
    if norm == "layer":
        return LayerNorm(dim, name=name, dtype=dtype)
    if norm == "batch":
        return BatchNorm(dim, name=name, dtype=dtype)
    if norm in (None, "none"):
        return Identity()
    raise ValueError(f"Unknown normalization type: {norm}")


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; a no-op outside training or without a generator
    (the JAX package skips it when no rng key is given)."""
    if not train or p <= 0.0 or generator is None:
        return x
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    return torch.where(u < 1.0 - p, x / (1.0 - p), torch.zeros_like(x))


def _prefix(path) -> str:
    return ".".join(str(p) for p in path)


def get_subtree(params: dict, path: tuple) -> dict:
    """Entries of a flat ``{dotted name: value}`` dict under ``path``."""
    pre = _prefix(path)
    return {k: v for k, v in params.items()
            if not pre or k == pre or k.startswith(pre + ".")}


def set_subtree(params: dict, path: tuple, value: dict) -> dict:
    """Copy of ``params`` with the entries under ``path`` taken from
    ``value`` (a flat dict of the same full names)."""
    out = dict(params)
    for k in get_subtree(params, path):
        out[k] = value[k]
    return out
