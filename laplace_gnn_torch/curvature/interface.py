"""Curvature backends (counterpart of
``laplace_gnn_tpu/curvature/interface.py``; the KFAC path only so far).

A backend is built from (model, params, likelihood); the posterior subset
``w`` excludes parameters named ``adj``/``norms``, optionally restricted
to the last layer.
"""

from __future__ import annotations

import torch

from ..utils.pytree import DEFAULT_EXCLUDE, merge_split, tree_size, tree_vector
from .kfac import compute_kfac_factors, posterior_split
from .losses import get_loss_fn, likelihood_factor


class CurvatureBackend:
    def __init__(self, model, params: dict, likelihood: str,
                 last_layer: bool = False, exclude=DEFAULT_EXCLUDE):
        self.model = model
        self.likelihood = likelihood
        self.lossfunc = get_loss_fn(likelihood)
        self.factor = likelihood_factor(likelihood)
        self.last_layer = last_layer
        self.exclude = tuple(exclude)
        self.set_params(params)

    def set_params(self, params: dict) -> None:
        self.params = params
        self.w, self.frozen, _ = posterior_split(
            self.model, params, self.exclude, self.last_layer)
        self.n_params_full = tree_size(self.w)

    @property
    def n_params(self) -> int:
        return self.n_params_full

    def mean_vector(self) -> torch.Tensor:
        return tree_vector(self.w)

    def model_fn(self, w: dict, X) -> torch.Tensor:
        return self.model.apply(merge_split(w, self.frozen), X)

    def loss(self, X, y) -> torch.Tensor:
        """factor * sum-loss on one batch."""
        return self.factor * self.lossfunc(self.model_fn(self.w, X), y)

    def kron(self, X, y, N: int, **kwargs):
        raise NotImplementedError

    def _kron(self, X, y, N: int, fisher_type: str = "type-2",
              kfac_approx: str = "expand", mixed_diag: bool = True):
        """Factors on this batch times the likelihood factor, and the loss
        from the same forward. ``mixed_diag`` (on by default): parameters
        outside the Linear tap sites get exact-diagonal blocks."""
        kron, out = compute_kfac_factors(
            self.model, self.params, X, y, likelihood=self.likelihood,
            fisher_type=fisher_type,
            kfac_approx=kfac_approx, exclude=self.exclude,
            last_layer=self.last_layer, N=N, return_output=True,
            mixed_diag=mixed_diag)
        kron = kron * self.factor
        loss = self.factor * self.lossfunc(out, y)
        return loss, kron


class GGNBackend(CurvatureBackend):
    """GGN / type-2 Fisher backend (MC Fisher is not ported yet)."""

    def kron(self, X, y, N, **kw):
        return self._kron(X, y, N, **kw)
