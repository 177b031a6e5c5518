"""Stochastic trace / diagonal / norm estimators (counterpart of
``laplace_gnn_tpu/curvature/estimators.py``): Hutchinson's trace, Hutch++,
Hutchinson's diagonal and the squared Frobenius norm, in one call or as
incremental one-probe samplers, with Rademacher or normal probes. Probes
are batched through ``matmat``.

JAX's ``key`` arguments become integer ``seed``s (0 by default): Hutch++'s
``jax.random.split`` takes folds 0 and 1 of the seed, and a sampler's
``fold_in(key, counter)`` the counter's fold (``kfac._fold_seed``). Every
probe comes from :func:`_probes`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from .kfac import _fold_seed


def _probes(seed: int, shape, distribution: str, dtype, device
            ) -> torch.Tensor:
    """Rademacher or standard normal probes of ``shape`` from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    if distribution == "rademacher":
        z = torch.randint(0, 2, tuple(shape), generator=g) * 2 - 1
    else:
        z = torch.randn(tuple(shape), generator=g, dtype=torch.float64)
    return z.to(device=device, dtype=dtype)


def random_probes(seed: int, shape, distribution: str = "rademacher",
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """Probes of ``shape`` from ``seed`` on ``device`` (``cuda`` unless
    the caller passes ``device="cpu"``)."""
    if distribution not in ("rademacher", "normal"):
        raise ValueError(f"Unknown probe distribution {distribution!r}")
    return _probes(seed, shape, distribution, dtype, resolve_device(device))


def _op_probes(op, seed, shape, distribution="rademacher"):
    return random_probes(seed, shape, distribution, op.dtype, op.device)


def hutchinson_trace(op, n_samples: int = 64, seed: int = 0,
                     distribution: str = "rademacher") -> torch.Tensor:
    """tr(A) ~ mean_s v_s^T A v_s."""
    V = _op_probes(op, seed, (op.shape[1], n_samples), distribution)
    AV = op.matmat(V)
    return torch.mean(torch.sum(V * AV, dim=0))


def hutchpp_trace(op, n_samples: int = 64, seed: int = 0
                  ) -> torch.Tensor:
    """Hutch++: low-rank deflation + Hutchinson on the residual
    (Meyer et al. 2020)."""
    k = max(n_samples // 3, 1)
    S = _op_probes(op, _fold_seed(seed, 0), (op.shape[1], k))
    Q, _ = torch.linalg.qr(op.matmat(S))
    # exact trace on the captured subspace
    t_low = torch.trace(Q.T @ op.matmat(Q))
    # Hutchinson on the deflated remainder
    G = _op_probes(op, _fold_seed(seed, 1), (op.shape[1], k))
    G = G - Q @ (Q.T @ G)
    t_rest = torch.trace(G.T @ op.matmat(G)) / k
    return t_low + t_rest


def hutchinson_diag(op, n_samples: int = 128, seed: int = 0,
                    distribution: str = "rademacher") -> torch.Tensor:
    """diag(A) ~ mean_s v_s * (A v_s)."""
    V = _op_probes(op, seed, (op.shape[1], n_samples), distribution)
    AV = op.matmat(V)
    return torch.mean(V * AV, dim=1)


def hutchinson_squared_fro(op, n_samples: int = 64,
                           seed: int = 0) -> torch.Tensor:
    """||A||_F^2 ~ mean_s ||A v_s||^2."""
    V = _op_probes(op, seed, (op.shape[1], n_samples))
    AV = op.matmat(V)
    return torch.mean(torch.sum(AV * AV, dim=0))


class _SampleEstimator:
    """Incremental estimator base: each ``sample()`` draws one fresh probe
    (the seed folded with a counter), so callers can average running
    samples."""

    def __init__(self, op, seed: int = 0):
        if len(op.shape) != 2 or op.shape[0] != op.shape[1]:
            raise ValueError(f"A must be square. Got shape {op.shape}.")
        self._op = op
        self._seed = seed
        self._counter = 0

    def _next_seed(self) -> int:
        s = _fold_seed(self._seed, self._counter)
        self._counter += 1
        return s

    def _probe(self, shape, distribution: str) -> torch.Tensor:
        return _op_probes(self._op, self._next_seed(), shape, distribution)


class HutchinsonTraceEstimator(_SampleEstimator):
    """One-probe trace samples: a = v^T A v (Hutchinson 1989)."""

    def sample(self, distribution: str = "rademacher") -> torch.Tensor:
        v = self._probe((self._op.shape[1],), distribution)
        return torch.dot(v, self._op.matvec(v))


class HutchPPTraceEstimator(_SampleEstimator):
    """Hutch++ incremental sampling: exact trace on a cached low-rank
    subspace + Hutchinson samples on the deflated residual."""

    def __init__(self, op, basis_dim: Optional[int] = None,
                 basis_distribution: str = "rademacher",
                 seed: int = 0):
        super().__init__(op, seed=seed)
        dim = op.shape[1]
        self._basis_dim = (basis_dim if basis_dim is not None
                           else min(max(dim // 100, 1), 10))
        if self._basis_dim > dim:
            raise ValueError(
                f"Basis dimension must be at most {dim}. "
                f"Got {self._basis_dim}.")
        self._basis_distribution = basis_distribution
        self._Q = None
        self._tr_QT_A_Q = None

    def maybe_compute_and_cache_subspace(self) -> None:
        """Build Q = qr(A S) and tr(Q^T A Q) once, lazily."""
        if self._Q is not None:
            return
        S = self._probe((self._op.shape[1], self._basis_dim),
                        self._basis_distribution)
        Q, _ = torch.linalg.qr(self._op.matmat(S))
        self._Q = Q
        self._tr_QT_A_Q = torch.trace(Q.T @ self._op.matmat(Q))

    def sample(self, distribution: str = "rademacher") -> torch.Tensor:
        self.maybe_compute_and_cache_subspace()
        v = self._probe((self._op.shape[1],), distribution)
        v = v - self._Q @ (self._Q.T @ v)
        return self._tr_QT_A_Q + torch.dot(v, self._op.matvec(v))


class HutchinsonDiagonalEstimator(_SampleEstimator):
    """One-probe diagonal samples: d = v * (A v)."""

    def sample(self, distribution: str = "rademacher") -> torch.Tensor:
        v = self._probe((self._op.shape[1],), distribution)
        return v * self._op.matvec(v)


class HutchinsonSquaredFrobeniusNormEstimator(_SampleEstimator):
    """One-probe ||A||_F^2 samples: ||A v||^2."""

    def sample(self, distribution: str = "rademacher") -> torch.Tensor:
        v = self._probe((self._op.shape[1],), distribution)
        Av = self._op.matvec(v)
        return torch.dot(Av, Av)
