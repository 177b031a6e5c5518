"""Predictive link approximations of the GLM predictive: probit, Laplace
bridge (plain and normalized) and MC sampling of the linearized predictive
(counterpart of ``laplace_gnn_tpu/laplace/predictive.py``).

The MC link draws from a ``torch.Generator``, or takes the standard normal
draws ``eps`` (K, n_samples) from the caller, which is how a test feeds
both packages the same noise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.linalg import normal_samples


def probit_predictive(f_mu: torch.Tensor, f_var: torch.Tensor
                      ) -> torch.Tensor:
    """Softmax of the variance-scaled mean. f_mu (B, C); f_var (B, C, C)."""
    kappa = 1.0 / torch.sqrt(1.0 + math.pi / 8 *
                             torch.diagonal(f_var, dim1=-2, dim2=-1))
    return torch.softmax(kappa * f_mu, dim=-1)


def bridge_predictive(f_mu: torch.Tensor, f_var: torch.Tensor,
                      norm: bool = False) -> torch.Tensor:
    """Laplace bridge to a Dirichlet; ``norm`` adds the variance
    correction (``bridge_norm``)."""
    # zero-mean correction
    sum_var_rows = torch.sum(f_var, dim=-1)                       # (B, C)
    total_var = torch.sum(f_var, dim=(-1, -2))[:, None]           # (B, 1)
    f_mu = f_mu - sum_var_rows * torch.sum(f_mu, dim=-1,
                                           keepdim=True) / total_var
    f_var = f_var - torch.einsum("bi,bj->bij", torch.sum(f_var, dim=-1),
                                 torch.sum(f_var, dim=-2)) / total_var[..., None]

    K = f_mu.shape[-1]
    f_var_diag = torch.diagonal(f_var, dim1=-2, dim2=-1)
    if norm:
        f_var_diag_mean = torch.mean(f_var_diag, dim=1) / math.sqrt(K / 2.0)
        f_mu = f_mu / torch.sqrt(f_var_diag_mean)[:, None]
        f_var_diag = f_var_diag / f_var_diag_mean[:, None]

    sum_exp = torch.sum(torch.exp(-f_mu), dim=1)[:, None]
    alpha = (1.0 - 2.0 / K + torch.exp(f_mu) / K ** 2 * sum_exp) / f_var_diag
    out = alpha / torch.sum(alpha, dim=1)[:, None]
    return torch.nan_to_num(out, nan=1.0)


def mc_predictive(f_mu: torch.Tensor, f_var: torch.Tensor, n_samples: int,
                  likelihood: str = "classification",
                  diagonal_output: bool = False,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample the linearized predictive and average the softmax."""
    if diagonal_output and f_var.dim() == 3:
        f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
    samples = normal_samples(f_mu, f_var, n_samples, generator, eps)
    if likelihood == "regression":
        return samples
    return torch.mean(torch.softmax(samples, dim=-1), dim=0)


def glm_classification_predictive(f_mu, f_var, link_approx: str,
                                  n_samples: int = 100,
                                  diagonal_output: bool = False,
                                  generator: Optional[torch.Generator] = None,
                                  eps: Optional[torch.Tensor] = None):
    if link_approx == "mc":
        return mc_predictive(f_mu, f_var, n_samples,
                             diagonal_output=diagonal_output,
                             generator=generator, eps=eps)
    if link_approx == "probit":
        return probit_predictive(f_mu, f_var)
    if link_approx == "bridge":
        return bridge_predictive(f_mu, f_var, norm=False)
    if link_approx == "bridge_norm":
        return bridge_predictive(f_mu, f_var, norm=True)
    raise ValueError(
        "Prediction path invalid. Check the likelihood, pred_type, "
        "link_approx combination!")
