"""Curvature backends (counterpart of
``laplace_gnn_tpu/curvature/interface.py``; the KFAC path and the
Jacobians of the GLM predictive so far).

A backend is built from (model, params, likelihood); the posterior subset
``w`` excludes parameters named ``adj``/``norms``, optionally restricted
to the last layer.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.pytree import (DEFAULT_EXCLUDE, merge_split, named_leaves,
                            tree_size, tree_vector)
from .kfac import compute_kfac_factors, posterior_split
from .losses import get_loss_fn, likelihood_factor


class CurvatureBackend:
    def __init__(self, model, params: dict, likelihood: str,
                 last_layer: bool = False, exclude=DEFAULT_EXCLUDE,
                 jac_chunk_size: Optional[int] = None):
        self.model = model
        self.likelihood = likelihood
        self.lossfunc = get_loss_fn(likelihood)
        self.factor = likelihood_factor(likelihood)
        self.last_layer = last_layer
        self.exclude = tuple(exclude)
        self.jac_chunk_size = jac_chunk_size
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

    def jacobians(self, X, chunk_size: Optional[int] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(Js (M, C, P), f (M, C)) w.r.t. the flat posterior vector.

        One ``torch.func.vjp`` of the model, whose pullback runs under
        ``torch.func.vmap`` over one-hot output cotangents: the M * C rows
        of a chunk are one batched backward pass (through the ``core``
        kernel, its vmap rule folds them into the feature axis, so a chunk
        is one launch per aggregation). ``chunk_size`` samples (C rows
        each) per pass bounds the peak memory; None (the default, unless
        the constructor's ``jac_chunk_size`` is set) runs all M at once."""
        names = [n for n, _ in named_leaves(self.w)]

        def f(*leaves):
            return self.model_fn(dict(zip(names, leaves)), X)

        out, pullback = torch.func.vjp(f, *(self.w[n] for n in names))
        M, C = out.shape
        chunk_size = (chunk_size if chunk_size is not None
                      else self.jac_chunk_size)
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        chunk = M if chunk_size is None else min(chunk_size, M)
        rows_of = torch.func.vmap(pullback)
        cls = torch.arange(C, device=out.device)
        Js = []
        for m0 in range(0, M, chunk):
            ms = torch.arange(m0, min(m0 + chunk, M), device=out.device)
            b = ms.shape[0]
            cot = torch.zeros((b, C, M, C), dtype=out.dtype, device=out.device)
            cot[torch.arange(b, device=out.device)[:, None], cls[None, :],
                ms[:, None], cls[None, :]] = 1.0
            grads = rows_of(cot.reshape(b * C, M, C))
            Js.append(torch.cat([g.reshape(b * C, -1) for g in grads],
                                dim=1).reshape(b, C, -1))
        return torch.cat(Js), out.detach()

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

    def _jacs(self, X):
        """The GLM predictive's Jacobians. The closed-form last-layer
        Jacobians wait with the last-layer flavours (ROADMAP Queue 1 item
        14), so a last-layer backend takes the generic ones."""
        return self.jacobians(X)

    def kron(self, X, y, N, **kw):
        return self._kron(X, y, N, **kw)
