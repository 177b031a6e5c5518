"""Last-layer Laplace (counterpart of
``laplace_gnn_tpu/laplace/lllaplace.py``): the Full, Kron and Diag
flavours with the posterior restricted to the last layer's parameters.

The backend narrows its posterior to ``model.last_layer_path``. Where the
last Linear's output is the model output (MLP, CNN) the Jacobians are the
closed form ``[I, I (x) phi]`` from the features; on a GNN the last
Linear's output is aggregated first, so the Jacobians are autodiff ones
(through the fused kernel where the model runs it)."""

from __future__ import annotations

import torch

from .flavors import DiagLaplace, FullLaplace, KronLaplace


class _LLMixin:
    def _backend_extra(self) -> dict:
        return {"last_layer": True}


class FullLLLaplace(_LLMixin, FullLaplace):
    _key = ("last_layer", "full")


class KronLLLaplace(_LLMixin, KronLaplace):
    _key = ("last_layer", "kron")


class DiagLLLaplace(_LLMixin, DiagLaplace):
    _key = ("last_layer", "diag")

    def functional_variance_fast(self, X) -> tuple:
        """(f, var): the diagonal of the output variance from the features,
        with no Jacobians, var[c] = sum_d phi_d^2 sigma2_w[c, d] +
        sigma2_b[c]. As in JAX it reads the features the closed form
        would: on a GNN those are the last conv's input over the whole
        graph, so var has a row per node of the graph."""
        phi, f = self.model.features(self.backend.params, X)
        sigma2 = self.posterior_variance
        C, D = f.shape[-1], phi.shape[-1]
        if self.n_params == C * D + C:
            s_b, s_w = sigma2[:C], sigma2[C:].reshape(C, D)
            return f, phi ** 2 @ s_w.T + s_b[None, :]
        return f, phi ** 2 @ sigma2.reshape(C, D).T
