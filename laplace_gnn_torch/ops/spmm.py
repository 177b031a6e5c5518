"""Neighborhood aggregation, the single entry point of the model zoo.

Counterpart of ``laplace_gnn_tpu/ops/spmm.py``.
"""

from __future__ import annotations

import torch


def aggregate(adj, x: torch.Tensor) -> torch.Tensor:
    """``out[i] = sum_j adj[i, j] * x[j]``. ``adj`` is a dense (N, N) tensor
    or an operator with ``.spmm(x)`` (the fused kernel path)."""
    if hasattr(adj, "spmm"):
        return adj.spmm(x)
    return adj @ x
