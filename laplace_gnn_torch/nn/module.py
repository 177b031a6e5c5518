"""Dense layers with KFAC taps, as ``nn.Module``s.

Counterpart of ``laplace_gnn_tpu/nn/module.py``. Parameters live in
``nn.Module``s whose dotted names follow the JAX pytree paths
(``convs.0.lin.weight``), and models are applied functionally over a flat
``{name: tensor}`` dict (``torch.func.functional_call``), so the adjacency
and any parameter subset can be differentiated the way the JAX package
differentiates a params pytree.

The library's own models sit here too: ``Conv2d`` (im2col through
``torch.nn.functional.unfold``), ``MLP``, ``CNN`` and the
``DictInputModel`` adapter for mapping batches. Like the GNNs they build
on ``cuda`` unless the caller passes ``device="cpu"``.

Dense layers route their pre-activation through ``taps.tap(name, a, s)``:
the KFAC input activations ``a`` are read off the tap records, and the
output gradients ``g = dL/ds`` come from differentiating w.r.t. a zero
perturbation ``eps`` added at the tap site (curvature/kfac.py). Weights are
stored ``(out_features, in_features)`` as in ``torch.nn.Linear``.
"""

from __future__ import annotations

import math
from collections.abc import MutableMapping
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..device import resolve_device
from ..utils.pytree import named_leaves


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


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2d(nn.Module):
    """2-D convolution with ``torch.nn.Conv2d``'s weight layout
    ``(out_ch, in_ch, kh, kw)`` and default init, NCHW input.

    Computed as im2col: ``unfold`` gives the patches with features in
    (c, kh, kw) order, the row-major order of the flattened weight, and the
    convolution becomes ``patches @ W_flat.T``. The KFAC tap records
    ``(a (B, L, c*kh*kw), s (B, L, out))`` with the L spatial positions as
    the weight-sharing middle axis ('expand' / 'reduce'). Built on
    ``cuda`` unless the caller passes ``device="cpu"``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, bias: bool = True, name: str = "conv",
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.use_bias = bias
        self.name = name
        kh, kw = self.kernel_size
        bound = 1.0 / math.sqrt(in_channels * kh * kw)

        def uniform(*shape):
            u = torch.rand(*shape, generator=generator, dtype=torch.float64)
            return (u * 2 * bound - bound).to(dtype)

        self.weight = nn.Parameter(uniform(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(uniform(out_channels)) if bias else None
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        B, _, H, W = x.shape
        (kh, kw), (sh, sw), (ph, pw) = (self.kernel_size, self.stride,
                                        self.padding)
        Ho = (H + 2 * ph - kh) // sh + 1
        Wo = (W + 2 * pw - kw) // sw + 1
        a = F.unfold(x, (kh, kw), padding=(ph, pw),
                     stride=(sh, sw)).transpose(1, 2)          # (B, L, ckk)
        s = a @ self.weight.reshape(self.out_channels, -1).T   # (B, L, out)
        if self.bias is not None:
            s = s + self.bias
        s = _tap(taps, self.name, a, s)
        return s.transpose(1, 2).reshape(B, self.out_channels, Ho, Wo)


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

    def forward(self, x: torch.Tensor, row_axis=None, **_) -> torch.Tensor:
        if row_axis is not None and self.axis == 0:
            mu, var = _row_block_moments(x, row_axis)
        else:
            mu = torch.mean(x, dim=self.axis, keepdim=True)
            var = torch.var(x, dim=self.axis, keepdim=True, correction=0)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def _row_block_moments(x: torch.Tensor, ax):
    """The mean and biased variance over the rows of every rank's block
    (equal blocks), each rank holding its own: two sums over rows and
    ranks (``all_reduce``: every rank uses them on its own rows)."""
    from ..parallel.collectives import all_reduce
    n = x.shape[0] * ax.size
    mu = all_reduce(torch.sum(x, dim=0, keepdim=True), ax) / n
    var = all_reduce(torch.sum((x - mu) ** 2, dim=0, keepdim=True), ax) / n
    return mu, var


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
            generator: Optional[torch.Generator] = None,
            row_axis=None) -> torch.Tensor:
    """Inverted dropout; a no-op outside training or without a generator
    (the JAX package skips it when no rng key is given). On a rank's row
    block (``row_axis``) the mask is the block's rows of the mask the
    whole graph draws from the same generator, so a sharded step drops
    what the unsharded one does (every rank draws the whole mask: N x d
    uniforms, small beside an N x N adjacency)."""
    if not train or p <= 0.0 or generator is None:
        return x
    shape = tuple(x.shape)
    if row_axis is not None:
        shape = (x.shape[0] * row_axis.size,) + shape[1:]
    u = torch.rand(shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    if row_axis is not None:
        b = x.shape[0]
        u = u[row_axis.index * b:(row_axis.index + 1) * b]
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


class _TapModel(nn.Module):
    """A model of dense layers applied functionally over a flat
    ``{name: tensor}`` dict. Its last Linear's output is the model output,
    so the closed-form last-layer Jacobian (features x I) is exact.
    Subclasses draw their modules in ``_draw`` and name their last layer
    in ``last_layer_path``."""

    last_layer_closed_form = True

    def _setup(self, device, dtype, generator) -> None:
        self._dtype = dtype
        self._device = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        for attr, module in self._draw(gen).items():
            setattr(self, attr, module.to(self._device))

    def _draw(self, generator: torch.Generator) -> dict:
        raise NotImplementedError

    def params(self) -> dict:
        """The model's own parameters as a flat dict in JAX tree order."""
        return dict(named_leaves(dict(self.named_parameters())))

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        """Fresh parameters drawn from ``generator`` (seeded with 0 unless
        given) as the constructor draws them; the model's own are left as
        they are."""
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        fresh = {f"{attr}.{name}": p.detach().to(self._device)
                 for attr, module in self._draw(gen).items()
                 for name, p in module.named_parameters()}
        return dict(named_leaves(fresh))

    def apply(self, params: dict, x, taps: Optional[TapCollector] = None,
              generator: Optional[torch.Generator] = None,
              train: bool = False) -> torch.Tensor:
        """Forward with the parameters taken from ``params``."""
        return functional_call(self, params, (x,), {"taps": taps})

    def features(self, params: dict, X) -> tuple:
        """(the last layer's input activations, the model output), off the
        tap records."""
        taps = TapCollector()
        f = self.apply(params, X, taps=taps)
        last = _prefix(self.last_layer_path(params))
        return [a for n, a, _ in taps.records if n == last][-1], f


class MLP(_TapModel):
    """Linear -> act -> ... -> Linear with a KFAC tap on every Linear;
    parameters ``layers.<i>.weight`` / ``.bias``."""

    def __init__(self, dims: Sequence[int], act: str = "tanh",
                 bias: bool = True, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims = tuple(dims)
        self.act = activation_resolver(act)
        self.use_bias = bias
        self.n_outputs = self.dims[-1]
        self._setup(device, dtype, generator)

    def _draw(self, generator):
        return {"layers": nn.ModuleList([
            Linear(self.dims[i], self.dims[i + 1], bias=self.use_bias,
                   name=f"layers.{i}", generator=generator, dtype=self._dtype)
            for i in range(len(self.dims) - 1)])}

    def forward(self, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            h = layer(h, taps=taps)
            if i < len(self.layers) - 1:
                h = self.act(h)
        return h

    def tap_sites(self, params: Optional[dict] = None) -> list[dict]:
        return [{"name": l.name, "param_path": ("layers", i),
                 "has_bias": l.use_bias} for i, l in enumerate(self.layers)]

    def last_layer_path(self, params: Optional[dict] = None) -> tuple:
        return ("layers", len(self.layers) - 1)


class CNN(_TapModel):
    """Conv2d -> act -> ... -> flatten -> Linear with a KFAC tap on every
    conv and on the head. ``conv_specs``: (in_ch, out_ch, kernel_size)
    triples (stride 1, no padding); ``head_in`` / ``n_outputs`` size the
    head; parameters ``convs.<i>.weight`` / ``.bias`` and ``head.*``."""

    def __init__(self, conv_specs: Sequence[tuple], head_in: int,
                 n_outputs: int, act: str = "relu", bias: bool = True,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_specs = [tuple(c) for c in conv_specs]
        self.head_in = head_in
        self.n_outputs = n_outputs
        self.act = activation_resolver(act)
        self.use_bias = bias
        self._setup(device, dtype, generator)

    def _draw(self, generator):
        convs = nn.ModuleList([
            Conv2d(ci, co, k, bias=self.use_bias, name=f"convs.{i}",
                   generator=generator, dtype=self._dtype,
                   device=self._device)
            for i, (ci, co, k) in enumerate(self.conv_specs)])
        head = Linear(self.head_in, self.n_outputs, bias=self.use_bias,
                      name="head", generator=generator, dtype=self._dtype)
        return {"convs": convs, "head": head}

    def forward(self, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        h = x
        for conv in self.convs:
            h = self.act(conv(h, taps=taps))
        return self.head(h.reshape(h.shape[0], -1), taps=taps)

    def tap_sites(self, params: Optional[dict] = None) -> list[dict]:
        sites = [{"name": c.name, "param_path": ("convs", i),
                  "has_bias": c.use_bias} for i, c in enumerate(self.convs)]
        return sites + [{"name": "head", "param_path": ("head",),
                         "has_bias": self.head.use_bias}]

    def last_layer_path(self, params: Optional[dict] = None) -> tuple:
        return ("head",)


class DictInputModel(nn.Module):
    """Adapter that lets any model take ``MutableMapping`` batches: the
    tensor under ``dict_key_x`` is the wrapped model's input, the other
    keys (the targets) ride along. Plain tensors pass through. Parameters
    are the wrapped model's, under its names."""

    def __init__(self, base, dict_key_x: str = "input_ids"):
        super().__init__()
        self.base = base
        self.dict_key_x = dict_key_x
        self.n_outputs = getattr(base, "n_outputs", None)
        self.last_layer_closed_form = getattr(base, "last_layer_closed_form",
                                              False)

    def _x(self, X):
        return X[self.dict_key_x] if isinstance(X, MutableMapping) else X

    def params(self) -> dict:
        return self.base.params()

    def init(self, generator: Optional[torch.Generator] = None) -> dict:
        return self.base.init(generator)

    def apply(self, params: dict, X, taps: Optional[TapCollector] = None,
              generator: Optional[torch.Generator] = None,
              train: bool = False) -> torch.Tensor:
        return self.base.apply(params, self._x(X), taps=taps,
                               generator=generator, train=train)

    def features(self, params: dict, X) -> tuple:
        return self.base.features(params, self._x(X))

    def tap_sites(self, params: Optional[dict] = None) -> list[dict]:
        return self.base.tap_sites(params)

    def last_layer_path(self, params: Optional[dict] = None) -> tuple:
        return self.base.last_layer_path(params)
