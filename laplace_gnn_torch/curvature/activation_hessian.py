"""Hessian w.r.t. an intermediate activation (counterpart of
``laplace_gnn_tpu/curvature/activation_hessian.py``).

The tap mechanism's zero perturbation ``eps`` is the activation handle:
the Hessian of the loss w.r.t. the pre-activation of a tap site is the
``torch.func.jvp`` of ``torch.func.grad`` w.r.t. ``eps``, at 0.
"""

from __future__ import annotations

import torch

from ..nn.module import TapCollector
from .base import LinearOperator
from .losses import get_loss_fn


def activation_shapes(model, params: dict, X) -> dict:
    """Map of tap-site name -> pre-activation shape."""
    taps = TapCollector()
    with torch.no_grad():
        model.apply(params, X, taps=taps)
    return {name: s.shape for name, a, s in taps.records}


class ActivationHessianOperator(LinearOperator):
    """Hessian of the (sum) loss w.r.t. the pre-activation of one tap site,
    as a matrix-free operator on the flattened activation."""

    def __init__(self, model, params: dict, likelihood: str, site: str, X,
                 y):
        loss_fn = get_loss_fn(likelihood)
        shapes = activation_shapes(model, params, X)
        if site not in shapes:
            raise ValueError(
                f"Unknown activation site {site!r}; available: "
                f"{sorted(shapes)}")
        shape = shapes[site]
        leaf = next(iter(params.values()))
        super().__init__((shape.numel(), shape.numel()), leaf.dtype,
                         leaf.device)
        self._shape_act = shape

        def loss_of_eps(eps_flat):
            taps = TapCollector({site: eps_flat.reshape(shape)})
            return loss_fn(model.apply(params, X, taps=taps), y)

        self._grad = torch.func.grad(loss_of_eps)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros(self.shape[0], dtype=self.dtype,
                           device=self.device)
        return torch.func.jvp(self._grad, (zero,), (v,))[1]
