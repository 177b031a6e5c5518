"""Evaluation metrics: NLL, MSE, accuracy, Brier score and ECE on
predicted probabilities (numpy), the streaming NLL, the offline
validation of a fitted Laplace and the prior-precision helpers (the
port's own copy of ``laplace_gnn_tpu/utils/metrics.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def nll_loss(probs: np.ndarray, targets: np.ndarray,
             ignore_index: int = -100, eps: float = 1e-12) -> float:
    """Mean negative log likelihood of predicted *probabilities* (the log is
    taken here; ``ignore_index`` targets are dropped)."""
    probs = np.asarray(probs).reshape(-1, probs.shape[-1])
    targets = np.asarray(targets).reshape(-1)
    keep = targets != ignore_index
    probs, targets = probs[keep], targets[keep]
    p = probs[np.arange(len(targets)), targets]
    return float(-np.mean(np.log(np.clip(p, eps, None))))


def mse_loss(preds: np.ndarray, targets: np.ndarray) -> float:
    return float(np.mean((np.asarray(preds) - np.asarray(targets)) ** 2))


def accuracy(probs: np.ndarray, targets: np.ndarray) -> float:
    return float(np.mean(np.argmax(probs, axis=-1) == np.asarray(targets)))


def brier_score(probs: np.ndarray, targets: np.ndarray) -> float:
    probs = np.asarray(probs)
    onehot = np.eye(probs.shape[-1])[np.asarray(targets)]
    return float(np.mean(np.sum((probs - onehot) ** 2, axis=-1)))


def expected_calibration_error(probs: np.ndarray, targets: np.ndarray,
                               n_bins: int = 15) -> float:
    """Standard ECE with equal-width confidence bins."""
    probs = np.asarray(probs)
    targets = np.asarray(targets)
    conf = probs.max(axis=-1)
    pred = probs.argmax(axis=-1)
    correct = (pred == targets).astype(float)
    bins = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    n = len(conf)
    for i in range(n_bins):
        mask = (conf > bins[i]) & (conf <= bins[i + 1])
        if mask.sum() == 0:
            continue
        ece += mask.sum() / n * abs(correct[mask].mean() - conf[mask].mean())
    return float(ece)


class RunningNLLMetric:
    """Streaming NLL of predicted probabilities over batches."""

    def __init__(self, ignore_index: int = -100):
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self._sum = 0.0
        self._count = 0

    def update(self, probs, targets):
        probs = np.asarray(probs).reshape(-1, np.shape(probs)[-1])
        targets = np.asarray(targets).reshape(-1)
        keep = targets != self.ignore_index
        probs, targets = probs[keep], targets[keep]
        p = probs[np.arange(len(targets)), targets]
        self._sum += float(-np.sum(np.log(np.clip(p, 1e-12, None))))
        self._count += len(targets)

    def compute(self) -> float:
        return self._sum / max(self._count, 1)

    def __call__(self, probs, targets) -> float:
        self.update(probs, targets)
        return self.compute()


def validate(la, val_loader, loss, pred_type: str = None,
             link_approx: str = "probit", n_samples: int = 100) -> float:
    """``loss`` of a fitted Laplace's predictive (``fitting=True``) over
    ``val_loader``. ``pred_type`` defaults to the flavour's own: "gp" for
    a functional Laplace, else "glm"."""
    if pred_type is None:
        pred_type = "gp" if getattr(la, "_key", ("", ""))[1] == "gp" else "glm"
    return la._validate(val_loader, loss, pred_type, link_approx, n_samples)


def expand_prior_precision(prior_prec, la) -> torch.Tensor:
    """A scalar, layerwise or diagonal prior precision expanded to the flat
    posterior vector of ``la``."""
    return la._expand_prior_precision(la._scalar(prior_prec))


def fix_prior_prec_structure(prior_prec_init, prior_structure: str,
                             n_layers: int, n_params: int,
                             dtype=torch.float64, device=None
                             ) -> torch.Tensor:
    """The initial prior-precision vector of a structure: one value
    (scalar), one per layer (layerwise) or one per parameter (diag), on
    ``device`` (``cuda`` unless asked)."""
    device = resolve_device(device)
    if prior_structure == "scalar":
        return torch.atleast_1d(torch.as_tensor(prior_prec_init, dtype=dtype,
                                                device=device))
    if prior_structure == "layerwise":
        return torch.full((n_layers,), prior_prec_init, dtype=dtype,
                          device=device)
    if prior_structure == "diag":
        return torch.full((n_params,), prior_prec_init, dtype=dtype,
                          device=device)
    raise ValueError(f"Invalid prior structure {prior_structure}.")
