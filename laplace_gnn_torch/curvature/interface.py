"""Curvature backends (counterpart of
``laplace_gnn_tpu/curvature/interface.py``): the GGN / Fisher, empirical
Fisher and exact-Hessian backends, each with ``full``, ``diag`` and (but
the Hessian) ``kron``, and the Jacobians of the GLM predictive.

A backend is built from (model, params, likelihood); the posterior subset
``w`` excludes parameters named ``adj``/``norms``, optionally restricted
to the last layer, and ``subnetwork_indices`` may select entries of its
flat vector (subnetwork Laplace): then Jacobians, gradients, the diagonal
and the Hessian are over those entries only. On a model whose last
Linear's output is the model output (``last_layer_closed_form``), the
last-layer Jacobians are the closed form ``[I, I (x) phi]``. Both are
the span ``laplace.jacobians`` (``profiling.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.module import _prefix
from ..profiling import annotate
from ..utils.pytree import (DEFAULT_EXCLUDE, merge_split, named_leaves,
                            tree_size, tree_vector)
from .kfac import _fold_seed, compute_kfac_factors, posterior_split
from .losses import (get_loss_fn, likelihood_factor, loss_hessian,
                     sample_labels)


def _middle_draw(m: int, likelihood: str, f: torch.Tensor) -> torch.Tensor:
    """The m-th draw of the stochastic GGN middle at ``f``: standard
    normals (M, C) for regression, else class indices (M,) drawn from
    softmax(f). Seeded from 0 whatever the backend's seed, as in JAX."""
    g = torch.Generator().manual_seed(_fold_seed(0, m))
    if likelihood == "regression":
        return torch.randn(f.shape, generator=g, dtype=torch.float64).to(
            f.device, f.dtype)
    return sample_labels(g, "classification", f)


class CurvatureBackend:
    def __init__(self, model, params: dict, likelihood: str,
                 last_layer: bool = False,
                 subnetwork_indices: Optional[torch.Tensor] = None,
                 exclude=DEFAULT_EXCLUDE,
                 jac_chunk_size: Optional[int] = None):
        self.model = model
        self.likelihood = likelihood
        self.lossfunc = get_loss_fn(likelihood)
        self.factor = likelihood_factor(likelihood)
        self.last_layer = last_layer
        self.subnetwork_indices = subnetwork_indices
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
        if self.subnetwork_indices is not None:
            return int(len(self.subnetwork_indices))
        return self.n_params_full

    def _subnet(self, t: torch.Tensor) -> torch.Tensor:
        """``t``'s last axis at the subnetwork indices (all of it when
        there are none)."""
        if self.subnetwork_indices is None:
            return t
        return t[..., self.subnetwork_indices]

    def mean_vector(self) -> torch.Tensor:
        return self._subnet(tree_vector(self.w))

    def model_fn(self, w: dict, X) -> torch.Tensor:
        return self.model.apply(merge_split(w, self.frozen), X)

    def loss(self, X, y) -> torch.Tensor:
        """factor * sum-loss on one batch."""
        return self.factor * self.lossfunc(self.model_fn(self.w, X), y)

    def _jacobian_rows(self, X):
        """(f (M, C), rows): one ``torch.func.vjp`` of the model, and
        ``rows(m0, m1)``, the Jacobian rows (m1 - m0, C, P) of samples
        m0..m1 w.r.t. the flat posterior vector. Their pullbacks run under
        ``torch.func.vmap`` over one-hot output cotangents, as one batched
        backward pass (through the ``core`` kernel, its vmap rule folds them
        into the feature axis: one launch per aggregation)."""
        names = [n for n, _ in named_leaves(self.w)]

        def f(*leaves):
            return self.model_fn(dict(zip(names, leaves)), X)

        out, pullback = torch.func.vjp(f, *(self.w[n] for n in names))
        M, C = out.shape
        rows_of = torch.func.vmap(pullback)
        cls = torch.arange(C, device=out.device)
        # a device tensor, not a Python 1.0: a scalar would be copied from
        # the host at each call, which a CUDA-graph capture refuses
        one = torch.ones((), dtype=out.dtype, device=out.device)

        def rows(m0, m1):
            ms = torch.arange(m0, m1, device=out.device)
            b = ms.shape[0]
            cot = torch.zeros((b, C, M, C), dtype=out.dtype, device=out.device)
            cot[torch.arange(b, device=out.device)[:, None], cls[None, :],
                ms[:, None], cls[None, :]] = one
            grads = rows_of(cot.reshape(b * C, M, C))
            return torch.cat([g.reshape(b * C, -1) for g in grads],
                             dim=1).reshape(b, C, -1)

        return out, rows

    def _chunk(self, M: int, chunk_size: Optional[int]) -> int:
        chunk_size = (chunk_size if chunk_size is not None
                      else self.jac_chunk_size)
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        return M if chunk_size is None else min(chunk_size, M)

    @annotate("laplace.jacobians")
    def jacobians(self, X, chunk_size: Optional[int] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """(Js (M, C, P), f (M, C)) w.r.t. the flat posterior vector.

        ``chunk_size`` samples (C rows each) per vmapped pass bounds the
        peak memory; None (the default, unless the constructor's
        ``jac_chunk_size`` is set) runs all M at once. f is the model
        output of the same forward, differentiable like the Jacobians."""
        out, rows = self._jacobian_rows(X)
        M = out.shape[0]
        chunk = self._chunk(M, chunk_size)
        return torch.cat([self._subnet(rows(m0, min(m0 + chunk, M)))
                          for m0 in range(0, M, chunk)]), out

    @annotate("laplace.jacobians")
    def last_layer_jacobians(self, X) -> tuple[torch.Tensor, torch.Tensor]:
        """(Js (M, C, P_ll), f (M, C)) of the last layer in closed form from
        its input features phi: f = phi W^T + b, so d f_c / d b = e_c and
        d f_c / d W[c', d] = delta(c, c') phi_d. Bias block first, then the
        weight, in the posterior's leaf order."""
        phi, f = self.model.features(self.params, X)
        M, C = f.shape
        if phi.shape[0] != M:
            # e.g. a reward model whose last layer sees each pair's two
            # rows; JAX fails here on the reshape
            raise ValueError(
                f"the closed-form last-layer Jacobians need one feature row "
                f"per output row; got {phi.shape[0]} for {M}")
        eye = torch.eye(C, dtype=f.dtype, device=f.device)
        Jw = torch.einsum("ck,md->mckd", eye, phi).reshape(M, C, -1)
        ll = _prefix(self.model.last_layer_path(self.params))
        if f"{ll}.bias" in self.w:
            return torch.cat([eye.expand(M, C, C), Jw], dim=-1), f
        return Jw, f

    def gradients(self, X, y) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-sample gradients Gs (M, P) of the raw sum-loss and the total
        raw loss (no likelihood factor): one vjp of the per-sample losses,
        its pullback vmapped over one-hot cotangents."""
        names = [n for n, _ in named_leaves(self.w)]

        def per_sample_losses(*leaves):
            f = self.model_fn(dict(zip(names, leaves)), X)
            return torch.func.vmap(
                lambda fi, yi: self.lossfunc(fi[None], yi[None]))(f, y)

        losses, pullback = torch.func.vjp(per_sample_losses,
                                          *(self.w[n] for n in names))
        eye = torch.eye(losses.shape[0], dtype=losses.dtype,
                        device=losses.device)
        grads = torch.func.vmap(pullback)(eye)
        Gs = torch.cat([g.reshape(eye.shape[0], -1) for g in grads], dim=1)
        return self._subnet(Gs), torch.sum(losses)

    def full(self, X, y, N: Optional[int] = None):
        raise NotImplementedError

    def diag(self, X, y, N: Optional[int] = None):
        raise NotImplementedError

    def kron(self, X, y, N: int, **kwargs):
        raise NotImplementedError

    _kron_fisher_type: str = "type-2"

    def _kron(self, X, y, N: int, fisher_type: Optional[str] = None,
              mc_samples: int = 1, kfac_approx: str = "expand", seed: int = 0,
              column_chunk: Optional[int] = None, mixed_diag: bool = True,
              sketch_size: int = 8, diag_probes: Optional[int] = None,
              probe_batch: Optional[int] = None):
        """Factors on this batch times the likelihood factor, and the loss
        from the same forward. ``mixed_diag`` (on by default): parameters
        outside the Linear tap sites get diagonal blocks."""
        kron, out = compute_kfac_factors(
            self.model, self.params, X, y, likelihood=self.likelihood,
            fisher_type=fisher_type or self._kron_fisher_type,
            mc_samples=mc_samples, kfac_approx=kfac_approx,
            exclude=self.exclude, last_layer=self.last_layer, N=N, seed=seed,
            return_output=True, column_chunk=column_chunk,
            mixed_diag=mixed_diag, sketch_size=sketch_size,
            diag_probes=diag_probes, probe_batch=probe_batch)
        kron = kron * self.factor
        loss = self.factor * self.lossfunc(out, y)
        return loss, kron


class GGNBackend(CurvatureBackend):
    """GGN / type-2 Fisher backend. ``stochastic=True`` takes the MC Fisher
    (``mc_samples`` draws); ``fisher_type`` sets the Kron flavour directly
    (e.g. 'type-2-sketch' with ``sketch_size``), and the other options go
    to :func:`compute_kfac_factors`, so the Laplace classes reach every
    flavour through ``backend_kwargs``."""

    def __init__(self, *args, stochastic: bool = False, mc_samples: int = 1,
                 fisher_type: Optional[str] = None, sketch_size: int = 8,
                 column_chunk: Optional[int] = None,
                 diag_probes: Optional[int] = None,
                 probe_batch: Optional[int] = None,
                 seed: int = 0, **kwargs):
        self.stochastic = stochastic
        self.mc_samples = mc_samples
        self.fisher_type = fisher_type
        self.sketch_size = sketch_size
        self.column_chunk = column_chunk
        self.diag_probes = diag_probes
        self.probe_batch = probe_batch
        self.seed = seed
        super().__init__(*args, **kwargs)

    @property
    def _kron_fisher_type(self):
        if self.fisher_type is not None:
            return self.fisher_type
        return "mc" if self.stochastic else "type-2"

    def _functional_middle(self, f):
        """Middle matrix (M, C, C): the exact loss Hessian for
        classification, None (identity) for regression, or the MC mean of
        outer products of sampled output gradients when stochastic."""
        if self.stochastic:
            F = torch.zeros(f.shape + f.shape[-1:], dtype=f.dtype,
                            device=f.device)
            for m in range(self.mc_samples):
                draw = _middle_draw(m, self.likelihood, f)
                if self.likelihood == "regression":
                    g = -draw                               # f - N(f, 1)
                else:
                    p = torch.softmax(f, dim=-1)
                    g = p - torch.nn.functional.one_hot(
                        draw, f.shape[-1]).to(f.dtype)
                F = F + torch.einsum("bc,bk->bck", g, g) / self.mc_samples
            return F
        if self.likelihood == "regression":
            return None
        return loss_hessian(self.likelihood, f)

    @property
    def _closed_form(self) -> bool:
        return self.last_layer and getattr(self.model,
                                           "last_layer_closed_form", False)

    def _jacs(self, X):
        """The GLM predictive's Jacobians: the closed form on a last layer
        that allows it, else autodiff."""
        if self._closed_form:
            return self.last_layer_jacobians(X)
        return self.jacobians(X)

    def full(self, X, y, N=None):
        Js, f = self._jacs(X)
        H_lik = self._functional_middle(f)
        if H_lik is None:
            H = torch.einsum("bcp,bcq->pq", Js, Js)
        else:
            H = torch.einsum("bcp,bck,bkq->pq", Js, H_lik, Js)
        return self.factor * self.lossfunc(f, y), H

    def diag(self, X, y, N=None, row_chunk: Optional[int] = None):
        """GGN / Fisher diagonal with bounded memory: ``row_chunk`` samples
        (C Jacobian rows each) per vmapped pass, the diagonal summed over
        the passes, so the whole (M, C, P) stack never exists. The default
        chunk keeps a pass's rows near 256 MB (``jac_chunk_size`` if set).
        A closed-form last layer takes its Jacobians in one piece."""
        if self._closed_form:
            Js, f = self.last_layer_jacobians(X)
            H_lik = self._functional_middle(f)
            h = (torch.einsum("bcp,bcp->p", Js, Js) if H_lik is None else
                 torch.einsum("bcp,bck,bkp->p", Js, H_lik, Js))
            return self.factor * self.lossfunc(f, y), h
        f, rows = self._jacobian_rows(X)
        M, C = f.shape
        if row_chunk is None:
            row_chunk = self.jac_chunk_size
        if row_chunk is None:
            row_chunk = max(1, 2 ** 28 // max(1, C * tree_size(self.w) * 4))
        chunk = self._chunk(M, row_chunk)
        H_lik = self._functional_middle(f)
        h = None
        for m0 in range(0, M, chunk):
            Js = self._subnet(rows(m0, min(m0 + chunk, M)))
            hc = (torch.einsum("bcp,bcp->p", Js, Js) if H_lik is None else
                  torch.einsum("bcp,bck,bkp->p", Js, H_lik[m0:m0 + chunk], Js))
            h = hc if h is None else h + hc
        return self.factor * self.lossfunc(f, y), h

    def kron(self, X, y, N, **kw):
        kw.setdefault("mc_samples", self.mc_samples)
        kw.setdefault("sketch_size", self.sketch_size)
        kw.setdefault("column_chunk", self.column_chunk)
        kw.setdefault("diag_probes", self.diag_probes)
        kw.setdefault("probe_batch", self.probe_batch)
        kw.setdefault("seed", self.seed)
        return self._kron(X, y, N, **kw)


class EFBackend(CurvatureBackend):
    """Empirical Fisher backend: outer products of per-sample gradients."""

    _kron_fisher_type = "empirical"

    def full(self, X, y, N=None):
        Gs, loss = self.gradients(X, y)
        return self.factor * loss, self.factor * (Gs.T @ Gs)

    def diag(self, X, y, N=None):
        Gs, loss = self.gradients(X, y)
        return self.factor * loss, self.factor * torch.sum(Gs * Gs, dim=0)

    def kron(self, X, y, N, **kw):
        return self._kron(X, y, N, **kw)


class HessianBackend(CurvatureBackend):
    """Exact-Hessian backend. The Hessian is reverse over reverse
    (``jacrev`` of ``jacrev``): the fused aggregation has a differentiable
    backward and no forward-mode rule."""

    def full(self, X, y, N=None):
        names = [n for n, _ in named_leaves(self.w)]
        shapes = [self.w[n].shape for n in names]
        sizes = [self.w[n].numel() for n in names]

        def total_loss(flat_w):
            w_ = dict(zip(names, (p.reshape(s) for p, s in zip(
                torch.split(flat_w, sizes), shapes))))
            return self.lossfunc(self.model_fn(w_, X), y)

        theta = tree_vector(self.w)
        idx = self.subnetwork_indices
        if idx is None:
            H = torch.func.jacrev(torch.func.jacrev(total_loss))(theta)
        else:
            def sub_loss(sub):
                return total_loss(theta.index_copy(0, idx, sub))

            H = torch.func.jacrev(torch.func.jacrev(sub_loss))(theta[idx])
        return self.loss(X, y), self.factor * H

    def diag(self, X, y, N=None):
        loss, H = self.full(X, y)
        return loss, torch.diagonal(H)


BACKEND_REGISTRY = {
    "ggn": GGNBackend,
    "ef": EFBackend,
    "hessian": HessianBackend,
}
