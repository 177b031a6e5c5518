"""Evaluation metrics: NLL, accuracy, Brier score and ECE on predicted
probabilities (numpy; the port's own copy of
``laplace_gnn_tpu/utils/metrics.py:14-88``).

``validate`` and the prior-precision helpers wait with
``optimize_prior_precision`` (ROADMAP Queue 1 item 14(a)).
"""

from __future__ import annotations

import numpy as np


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
