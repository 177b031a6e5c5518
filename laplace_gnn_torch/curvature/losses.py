"""Sum-reduced losses and their closed-form output-space Hessians.

Counterpart of ``laplace_gnn_tpu/curvature/losses.py``:
  - CE:        H = diag(p) - p p^T,   sqrt S = diag(sqrt p) - p sqrt(p)^T
  - MSE (sum): H = 2 I,               sqrt S = sqrt(2) I
with the likelihood factor 1.0 (classification) or 0.5 (regression); also
the Hessian's products and diagonal, the sum BCE on logits, and label
draws from the predictive (MC Fisher).
"""

from __future__ import annotations

import math

import torch

CLASSIFICATION = "classification"
REGRESSION = "regression"
REWARD_MODELING = "reward_modeling"


def cross_entropy_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum-reduced cross entropy over integer labels; f (M, C), y (M,)."""
    logp = torch.log_softmax(f, dim=-1)
    return -torch.sum(torch.gather(logp, 1, y[:, None].long()))


def mse_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum((f - y) ** 2)


def get_loss_fn(likelihood: str):
    if likelihood in (CLASSIFICATION, REWARD_MODELING):
        return cross_entropy_sum
    if likelihood == REGRESSION:
        return mse_sum
    raise ValueError(f"Unknown likelihood {likelihood!r}")


def likelihood_factor(likelihood: str) -> float:
    return 0.5 if likelihood == REGRESSION else 1.0


def loss_hessian(likelihood: str, f: torch.Tensor) -> torch.Tensor:
    """Per-sample loss Hessians, f (M, C) -> (M, C, C)."""
    M, C = f.shape
    eye = torch.eye(C, dtype=f.dtype, device=f.device)
    if likelihood == REGRESSION:
        return (2.0 * eye).expand(M, C, C).clone()
    p = torch.softmax(f, dim=-1)
    return torch.diag_embed(p) - p[:, :, None] * p[:, None, :]


def loss_hessian_sqrt(likelihood: str, f: torch.Tensor) -> torch.Tensor:
    """Per-sample S with S S^T = H_loss; f (M, C) -> (M, C, C).

    sqrt(p) is taken as exp(log_softmax / 2): once a logit saturates and p
    underflows to 0, the derivative of a plain sqrt(p) is inf * 0 = NaN and
    would poison the hyperstep's gradient through the KFAC factors."""
    M, C = f.shape
    if likelihood == REGRESSION:
        eye = torch.eye(C, dtype=f.dtype, device=f.device)
        return (math.sqrt(2.0) * eye).expand(M, C, C).clone()
    p = torch.softmax(f, dim=-1)
    sp = torch.exp(0.5 * torch.log_softmax(f, dim=-1))
    return torch.diag_embed(sp) - p[:, :, None] * sp[:, None, :]


def bce_with_logits_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum-reduced binary cross entropy on logits, in the stable form."""
    return torch.sum(torch.clamp(f, min=0) - f * y
                     + torch.log1p(torch.exp(-torch.abs(f))))


def loss_hessian_mvp(likelihood: str, f: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """H_loss(f) @ v per sample; f, v (M, C) -> (M, C)."""
    if likelihood == REGRESSION:
        return 2.0 * v
    p = torch.softmax(f, dim=-1)
    return p * v - p * torch.sum(p * v, dim=-1, keepdim=True)


def loss_hessian_diag(likelihood: str, f: torch.Tensor) -> torch.Tensor:
    """Diagonal of the per-sample loss Hessians, (M, C)."""
    if likelihood == REGRESSION:
        return 2.0 * torch.ones_like(f)
    p = torch.softmax(f, dim=-1)
    return p * (1.0 - p)


def sample_labels(generator: torch.Generator, likelihood: str,
                  f: torch.Tensor) -> torch.Tensor:
    """Would-be labels drawn from the model's predictive at ``f`` (MC
    Fisher): y ~ N(f, 1/2) for regression (the sum-MSE gradient then has
    covariance 2 I, the GGN middle), else one class index per row, drawn
    from softmax(f). The draws come from ``generator`` (a CPU generator
    gives the same draws for inputs on any device) and land on f's
    device."""
    f = f.detach()
    if likelihood == REGRESSION:
        z = torch.randn(f.shape, generator=generator, dtype=torch.float64,
                        device=generator.device)
        return f + z.to(f.device, f.dtype) / math.sqrt(2.0)
    u = torch.rand((f.shape[0], 1), generator=generator, dtype=torch.float64,
                   device=generator.device).to(f.device)
    cdf = torch.cumsum(torch.softmax(f.to(torch.float64), dim=-1), dim=-1)
    return torch.clamp(torch.sum(cdf < u, dim=-1), max=f.shape[-1] - 1)
