"""Dense symmetric eigen-solvers for the Laplace stack.

Counterpart of ``laplace_gnn_tpu/ops/linalg.py``. Eigenvalues are clamped
at zero with ``torch.maximum`` rather than ``torch.clamp``: at an exact tie
``maximum`` splits the gradient in halves, as ``jnp.clip`` does, where
``clamp`` passes all of it.
"""

from __future__ import annotations

import torch


def clip_min0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with JAX's gradient at ties (half to each side)."""
    return torch.maximum(x, x.new_zeros(()))


def symeig(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues clamped at 0, eigenvectors), NaNs zeroed; ascending."""
    M = 0.5 * (M + M.T)
    L, W = torch.linalg.eigh(M)
    return torch.nan_to_num(clip_min0(L)), torch.nan_to_num(W)


def _same_size_groups(mats) -> dict:
    groups: dict = {}
    for i, m in enumerate(mats):
        groups.setdefault(int(m.shape[0]), []).append(i)
    return groups


def batched_eigvalsh(mats) -> list:
    """Eigenvalues of several symmetric matrices; same-size matrices share
    one batched ``eigvalsh`` call. Ascending, one vector per input."""
    mats = list(mats)
    out: list = [None] * len(mats)
    for _, idxs in _same_size_groups(mats).items():
        if len(idxs) == 1:
            out[idxs[0]] = torch.linalg.eigvalsh(mats[idxs[0]])
        else:
            lams = torch.linalg.eigvalsh(torch.stack([mats[i] for i in idxs]))
            for t, i in enumerate(idxs):
                out[i] = lams[t]
    return out


def batched_symeig(mats) -> list:
    """Like :func:`batched_eigvalsh` with eigenvectors, under
    :func:`symeig`'s clamp and NaN post-conditions."""
    mats = [0.5 * (m + m.T) for m in mats]
    out: list = [None] * len(mats)
    for _, idxs in _same_size_groups(mats).items():
        L, W = torch.linalg.eigh(torch.stack([mats[i] for i in idxs]))
        for t, i in enumerate(idxs):
            out[i] = (torch.nan_to_num(clip_min0(L[t])),
                      torch.nan_to_num(W[t]))
    return out
