"""Dense symmetric eigen-solvers for the Laplace stack.

Counterpart of ``laplace_gnn_tpu/ops/linalg.py``. Eigenvalues are clamped
at zero with ``torch.maximum`` rather than ``torch.clamp``: at an exact tie
``maximum`` splits the gradient in halves, as ``jnp.clip`` does, where
``clamp`` passes all of it.

torch's eigensolvers check their result's ``info`` on the host, so each
call makes the host wait for the device: each counts ``host_sync``
(``profiling.py``); the batched ones run under the span ``eigh`` and
count ``eigh.calls`` (one per same-size group) and ``eigh.matrices``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..profiling import annotate, count, tracing


def clip_min0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with JAX's gradient at ties (half to each side)."""
    return torch.maximum(x, x.new_zeros(()))


def symeig(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues clamped at 0, eigenvectors), NaNs zeroed; ascending."""
    M = 0.5 * (M + M.T)
    count("host_sync")
    L, W = torch.linalg.eigh(M)
    return torch.nan_to_num(clip_min0(L)), torch.nan_to_num(W)


def safe_symeig(M: torch.Tensor, jitter: float = 0.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`symeig` of ``M + jitter I``, the jitter taken off the
    eigenvalues again (and clamped at 0)."""
    if jitter:
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        L, W = symeig(M + jitter * eye)
        return clip_min0(L - jitter), W
    return symeig(M)


def kron(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kronecker product A (x) B."""
    return torch.kron(A, B)


def block_diag(blocks) -> torch.Tensor:
    """Dense block-diagonal matrix of ``blocks``."""
    return torch.block_diag(*blocks)


def diagonal_add_scalar(X: torch.Tensor, value) -> torch.Tensor:
    """``X + value I`` (a new tensor)."""
    return X + value * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)


def cho_solve_psd(M: torch.Tensor, B: torch.Tensor,
                  jitter: float = 0.0) -> torch.Tensor:
    """``M^{-1} B`` for a symmetric positive (semi)definite ``M``, through
    the Cholesky factor of ``M + jitter I``."""
    L = torch.linalg.cholesky(diagonal_add_scalar(M, jitter) if jitter
                              else M)
    if B.dim() == 1:
        return torch.cholesky_solve(B[:, None], L)[:, 0]
    return torch.cholesky_solve(B, L)


def _same_size_groups(mats) -> dict:
    groups: dict = {}
    for i, m in enumerate(mats):
        groups.setdefault(int(m.shape[0]), []).append(i)
    return groups


def _count_eigh(n_matrices: int) -> None:
    count("eigh.calls")
    count("eigh.matrices", n_matrices)
    count("host_sync")


@annotate("eigh")
def batched_eigvalsh(mats) -> list:
    """Eigenvalues of several symmetric matrices; same-size matrices share
    one batched ``eigvalsh`` call. Ascending, one vector per input."""
    mats = list(mats)
    out: list = [None] * len(mats)
    for _, idxs in _same_size_groups(mats).items():
        if tracing():
            _count_eigh(len(idxs))
        if len(idxs) == 1:
            out[idxs[0]] = torch.linalg.eigvalsh(mats[idxs[0]])
        else:
            lams = torch.linalg.eigvalsh(torch.stack([mats[i] for i in idxs]))
            for t, i in enumerate(idxs):
                out[i] = lams[t]
    return out


def _standard_normals(shape: tuple, generator: Optional[torch.Generator],
                      dtype, device) -> torch.Tensor:
    """Standard normal draws: :func:`normal_samples`' and the Laplace
    flavours' ``sample``'s, in one place a test can replace."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def normal_samples(mean: torch.Tensor, var: torch.Tensor, n_samples: int,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Samples from batched Normals with diagonal or full covariance.

    mean (B, K); var (B, K) diagonal or (B, K, K) full. The standard normal
    draws ``eps`` (K, n_samples) come from ``generator``, or are passed in
    (the same noise for both packages in a test). Returns
    (n_samples, B, K)."""
    B, K = mean.shape
    if eps is None:
        eps = _standard_normals((K, n_samples), generator, mean.dtype,
                                mean.device)
    if mean.shape == var.shape:                       # diagonal
        scaled = torch.sqrt(var)[..., None] * eps[None]
    elif var.shape == (B, K, K):                      # full covariance
        scaled = torch.linalg.cholesky(var) @ eps[None]
    else:
        raise ValueError("Invalid input shapes.")
    return torch.permute(mean[..., None] + scaled, (2, 0, 1))


def invsqrt_precision(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular ``S`` with ``S S^T = M^{-1}`` for a precision
    matrix ``M``, as torch.distributions' ``_precision_to_scale_tril``
    forms it: the Cholesky factor of the flipped matrix, then a triangular
    solve. The flipped matrix is freed before the solve (at P = 23063 in
    f32 each P x P matrix is 2.13 GB)."""
    Lf = torch.linalg.cholesky(torch.flip(M, (-2, -1)))
    L_inv = torch.flip(Lf, (-2, -1)).mT
    del Lf
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.solve_triangular(L_inv, eye, upper=False)


@annotate("eigh")
def batched_symeig(mats) -> list:
    """Like :func:`batched_eigvalsh` with eigenvectors, under
    :func:`symeig`'s clamp and NaN post-conditions."""
    mats = [0.5 * (m + m.T) for m in mats]
    out: list = [None] * len(mats)
    for _, idxs in _same_size_groups(mats).items():
        if tracing():
            _count_eigh(len(idxs))
        L, W = torch.linalg.eigh(torch.stack([mats[i] for i in idxs]))
        for t, i in enumerate(idxs):
            out[i] = (torch.nan_to_num(clip_min0(L[t])),
                      torch.nan_to_num(W[t]))
    return out
