"""Predictive-quality evaluation: accuracy, NLL, ECE and Brier score of the
MAP and the Bayesian predictives (counterpart of
``laplace_gnn_tpu/training/evaluate.py``). Spans (``profiling.py``):
``eval.map``, ``eval.predictive`` and ``eval.metrics``."""

from __future__ import annotations

import numpy as np
import torch

from ..profiling import annotate, count
from ..utils.metrics import (accuracy, brier_score,
                             expected_calibration_error, nll_loss)
from .marglik_gnn import _as_index


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        count("host_sync")
        return x.detach().cpu().numpy()
    return np.asarray(x)


@annotate("eval.map")
def evaluate_map(model, params: dict, indices, labels) -> dict:
    """Metrics of the softmax MAP predictive."""
    dev = params["adj"].device
    with torch.no_grad():
        f = model.apply({k: v.detach() for k, v in params.items()},
                        _as_index(indices, dev))
        probs = torch.softmax(f, dim=-1)
    return _metrics(_numpy(probs), _numpy(labels))


@annotate("eval.predictive")
def evaluate_predictive(la, indices, labels, pred_type: str = "glm",
                        link_approx: str = "probit",
                        n_samples: int = 100) -> dict:
    """Metrics of the Bayesian posterior predictive of a fitted Laplace."""
    p = la(_as_index(indices, la.mean.device), pred_type=pred_type,
           link_approx=link_approx, n_samples=n_samples)
    if isinstance(p, tuple):
        raise ValueError("evaluate_predictive expects a classification "
                         "posterior predictive.")
    return _metrics(_numpy(p), _numpy(labels))


def validate(la, loader, pred_type: str = "glm",
             link_approx: str = "probit", n_samples: int = 100) -> dict:
    """Batched predictive evaluation over a loader of (X, y) batches."""
    probs, targets = [], []
    for X, y in loader:
        p = la(X, pred_type=pred_type, link_approx=link_approx,
               n_samples=n_samples)
        if isinstance(p, tuple):
            p = p[0]
        probs.append(_numpy(p))
        targets.append(_numpy(y))
    return _metrics(np.concatenate(probs), np.concatenate(targets))


@annotate("eval.metrics")
def _metrics(probs: np.ndarray, labels: np.ndarray) -> dict:
    return {
        "acc": accuracy(probs, labels),
        "nll": nll_loss(probs, labels),
        "ece": expected_calibration_error(probs, labels),
        "brier": brier_score(probs, labels),
    }
