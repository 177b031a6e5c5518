"""Lanczos spectral tools for matrix-free operators (counterpart of
``laplace_gnn_tpu/curvature/spectrum.py``).

``lanczos_tridiag`` / ``lanczos_eigh`` run Lanczos with full
reorthogonalization (LowRank Laplace's eigensolver); ``fast_lanczos`` runs
the three-term recurrence alone (Papyan 2020) as a Python loop, where JAX
may trace a ``lax.scan`` of the same steps. The density functions are
numpy, as in JAX. JAX's ``key`` arguments (``PRNGKey(0)`` when None)
become integer ``seed``s (0 by default), folded by ``kfac._fold_seed``
where JAX folds its key; every start vector comes from
:func:`_start_vector`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .kfac import _fold_seed

_BOUNDARY_STREAM = 2 ** 31 - 1   # the fold JAX gives the boundaries' key


def _start_vector(seed: int, P: int, dtype, device) -> torch.Tensor:
    """Lanczos start vector: P standard normals from ``seed``, drawn in
    float64 on the CPU so that every device and dtype starts alike."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(P, generator=g, dtype=torch.float64).to(device, dtype)


def _tridiagonal(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    T = torch.diag(alphas)
    if betas.shape[0] > 0:
        T = T + torch.diag(betas, 1) + torch.diag(betas, -1)
    return T


def lanczos_tridiag(op, k: int, seed: int = 0,
                    v0: Optional[torch.Tensor] = None):
    """k-step Lanczos with full reorthogonalization.

    Returns (alphas (k,), betas (k-1,), Q (P, k))."""
    P = op.shape[1]
    if v0 is None:
        v0 = _start_vector(seed, P, op.dtype, op.device)
    q = v0 / torch.linalg.norm(v0)
    Q = [q]
    alphas, betas = [], []
    for j in range(k):
        w = op.matvec(Q[j])
        alpha = torch.dot(Q[j], w)
        alphas.append(alpha)
        w = w - alpha * Q[j]
        if j > 0:
            w = w - betas[-1] * Q[j - 1]
        # full reorthogonalization
        Qm = torch.stack(Q, dim=1)
        w = w - Qm @ (Qm.T @ w)
        beta = torch.linalg.norm(w)
        if j < k - 1:
            betas.append(beta)
            Q.append(torch.where(beta > 1e-12,
                                 w / torch.clamp(beta, min=1e-30),
                                 torch.zeros_like(w)))
    return (torch.stack(alphas),
            torch.stack(betas) if betas else torch.zeros(
                0, dtype=op.dtype, device=op.device),
            torch.stack(Q, dim=1))


def lanczos_eigh(op, k: int, seed: int = 0):
    """Top-k approximate eigenpairs (evals (k,) ascending, evecs (P, k))."""
    alphas, betas, Q = lanczos_tridiag(op, k, seed=seed)
    evals, S = torch.linalg.eigh(_tridiagonal(alphas, betas))
    return evals, Q @ S


def fast_lanczos(op, ncv: int, seed: int = 0):
    """Lanczos without reorthogonalization (Papyan 2020 algorithm 2): the
    three-term recurrence carries only (v, v_prev).

    Returns (evals, evecs) of the tridiagonal T; ``evecs[:, i]`` is the
    normalized eigenvector of ``evals[i]``."""
    v = _start_vector(seed, op.shape[1], op.dtype, op.device)
    v = v / torch.linalg.norm(v)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((), dtype=v.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(ncv):
        w = op.matvec(v) - beta_prev * v_prev
        alpha = torch.dot(w, v)
        w = w - alpha * v
        beta = torch.linalg.norm(w)
        v_next = torch.where(beta > 1e-30, w / torch.clamp(beta, min=1e-30),
                             torch.zeros_like(w))
        v, v_prev, beta_prev = v_next, v, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.linalg.eigh(_tridiagonal(torch.stack(alphas),
                                          torch.stack(betas)[:-1]))


def _boundary_ncv(tol: float, dim: int, ncv) -> int:
    """Lanczos depth from the requested relative accuracy: extreme Ritz
    values converge geometrically, so ~2/sqrt(tol) iterations suffice for
    well-separated extremes (tol=1e-2 -> 20). An explicit ``ncv`` wins."""
    if ncv is not None:
        return min(ncv, dim)
    if tol <= 0:
        return min(128, dim)
    return min(dim, max(8, int(math.ceil(2.0 / math.sqrt(tol)))))


def approximate_boundaries(op, tol: float = 1e-2, boundaries=None,
                           seed: int = 0, ncv: Optional[int] = None):
    """Estimate (lambda_min, lambda_max) of a symmetric operator from the
    extreme Ritz values of Lanczos with reorthogonalization (``tol`` sets
    the depth unless ``ncv`` is given). ``boundaries`` may pin one or both
    ends: (lo, None), (None, hi), (lo, hi), or None."""
    lo, hi = (None, None) if boundaries is None else boundaries
    if lo is None or hi is None:
        k = _boundary_ncv(tol, op.shape[1], ncv)
        evals, _ = lanczos_eigh(op, k, seed=seed)
        lo = float(evals[0]) if lo is None else lo
        hi = float(evals[-1]) if hi is None else hi
    return lo, hi


def approximate_boundaries_abs(op, tol: float = 1e-2, boundaries=None,
                               seed: int = 0, ncv: Optional[int] = None):
    """Estimate (lambda_min, lambda_max) of |A|. min|lambda| is taken over
    the Ritz values of A, which converge to the spectrum's extremes: for an
    indefinite operator with interior small-magnitude eigenvalues it
    overestimates the lower boundary. Pin ``boundaries=(lo, None)`` when
    the true min|lambda| is known."""
    lo, hi = (None, None) if boundaries is None else boundaries
    if lo is None or hi is None:
        k = _boundary_ncv(tol, op.shape[1], ncv)
        evals, _ = lanczos_eigh(op, k, seed=seed)
        aevals = torch.abs(evals)
        lo = float(aevals.min()) if lo is None else lo
        hi = float(aevals.max()) if hi is None else hi
    return abs(lo), abs(hi)


def _gaussian_pdf(x, mu, sigma):
    return np.exp(-0.5 * ((x - mu) / sigma) ** 2) / (sigma
                                                     * np.sqrt(2 * np.pi))


def _numpy(lanczos_iter):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a) for a in lanczos_iter)


def lanczos_approximate_spectrum_from_iter(lanczos_iter, boundaries,
                                           num_points: int, kappa: float,
                                           margin: float):
    """Gaussian-bump density from one Lanczos quadrature on the
    [-1, 1]-normalized spectrum."""
    evals, evecs = _numpy(lanczos_iter)
    lo, hi = boundaries
    pad = margin * (hi - lo)
    lo, hi = lo - pad, hi + pad
    c, d = (hi + lo) / 2, (hi - lo) / 2
    grid_norm = np.linspace(-1, 1, num_points, endpoint=True)
    nodes = (evals - c) / d
    weights = evecs[0, :] ** 2 / d
    ncv = evals.shape[0]
    sigma = 2 / (ncv - 1) / np.sqrt(8 * np.log(kappa))
    density = (weights[:, None]
               * _gaussian_pdf(grid_norm[None, :], nodes[:, None],
                               sigma)).sum(0)
    return np.linspace(lo, hi, num_points, endpoint=True), density


def lanczos_approximate_spectrum(op, ncv: int, num_points: int = 1024,
                                 num_repeats: int = 1, kappa: float = 3.0,
                                 boundaries=None, margin: float = 0.05,
                                 boundaries_tol: float = 1e-2, seed: int = 0):
    """Approximate spectral density p(lambda) of a symmetric operator
    (Papyan 2020's LanczosApproxSpec)."""
    boundaries = approximate_boundaries(
        op, tol=boundaries_tol, boundaries=boundaries,
        seed=_fold_seed(seed, _BOUNDARY_STREAM))
    density = np.zeros(num_points)
    for n in range(num_repeats):
        it = fast_lanczos(op, ncv, seed=_fold_seed(seed, n))
        grid, d = lanczos_approximate_spectrum_from_iter(
            it, boundaries, num_points, kappa, margin)
        density = (1 - 1 / (n + 1)) * density + d / (n + 1)
    return grid, density


def lanczos_approximate_log_spectrum_from_iter(lanczos_iter, boundaries,
                                               num_points: int, kappa: float,
                                               margin: float,
                                               epsilon: float):
    """Density of log(|A| + eps I) from one Lanczos quadrature."""
    evals, evecs = _numpy(lanczos_iter)
    log_lo, log_hi = (np.log(b + epsilon) for b in boundaries)
    pad = margin * (log_hi - log_lo)
    log_lo, log_hi = log_lo - pad, log_hi + pad
    c, d = (log_hi + log_lo) / 2, (log_hi - log_lo) / 2
    grid_norm = np.linspace(-1, 1, num_points, endpoint=True)
    grid_out = np.exp(grid_norm * d + c)
    nodes = (np.log(np.abs(evals) + epsilon) - c) / d
    weights = evecs[0, :] ** 2
    ncv = evals.shape[0]
    sigma = 2 / (ncv - 1) / np.sqrt(8 * np.log(kappa))
    density = (weights[:, None]
               * _gaussian_pdf(grid_norm[None, :], nodes[:, None],
                               sigma)).sum(0) / (d * grid_out)
    return grid_out, density


def lanczos_approximate_log_spectrum(op, ncv: int, num_points: int = 1024,
                                     num_repeats: int = 1,
                                     kappa: float = 1.04, boundaries=None,
                                     margin: float = 0.05,
                                     boundaries_tol: float = 1e-2,
                                     epsilon: float = 1e-5, seed: int = 0):
    """Approximate spectral density of log(|A| + eps I)."""
    boundaries = approximate_boundaries_abs(
        op, tol=boundaries_tol, boundaries=boundaries,
        seed=_fold_seed(seed, _BOUNDARY_STREAM))
    density = np.zeros(num_points)
    for n in range(num_repeats):
        it = fast_lanczos(op, ncv, seed=_fold_seed(seed, n))
        grid, d = lanczos_approximate_log_spectrum_from_iter(
            it, boundaries, num_points, kappa, margin, epsilon)
        density = (1 - 1 / (n + 1)) * density + d / (n + 1)
    return grid, density


class _LanczosSpectrumCached:
    """Caches Lanczos quadratures so densities can be re-smoothed with
    other hyperparameters without re-running matvecs."""

    def __init__(self, op, ncv: int, seed: int = 0):
        self._op = op
        self._ncv = ncv
        self._seed = seed
        self._iters = []

    def _get_lanczos_iters(self, num_iters: int):
        while len(self._iters) < num_iters:
            self._iters.append(fast_lanczos(
                self._op, self._ncv,
                seed=_fold_seed(self._seed, len(self._iters))))
        return self._iters[:num_iters]


class LanczosApproximateSpectrumCached(_LanczosSpectrumCached):
    def __init__(self, op, ncv: int, boundaries=None,
                 boundaries_tol: float = 1e-2, seed: int = 0):
        super().__init__(op, ncv, seed=seed)
        self._boundaries = approximate_boundaries(
            op, tol=boundaries_tol, boundaries=boundaries,
            seed=_fold_seed(self._seed, _BOUNDARY_STREAM))

    def approximate_spectrum(self, num_repeats: int = 1,
                             num_points: int = 1024, kappa: float = 3.0,
                             margin: float = 0.05):
        spectra = [lanczos_approximate_spectrum_from_iter(
            it, self._boundaries, num_points, kappa, margin)
            for it in self._get_lanczos_iters(num_repeats)]
        grid = spectra[0][0]
        return grid, sum(s[1] for s in spectra) / num_repeats


class LanczosApproximateLogSpectrumCached(_LanczosSpectrumCached):
    def __init__(self, op, ncv: int, boundaries=None,
                 boundaries_tol: float = 1e-2, seed: int = 0):
        super().__init__(op, ncv, seed=seed)
        self._boundaries = approximate_boundaries_abs(
            op, tol=boundaries_tol, boundaries=boundaries,
            seed=_fold_seed(self._seed, _BOUNDARY_STREAM))

    def approximate_log_spectrum(self, num_repeats: int = 1,
                                 num_points: int = 1024, kappa: float = 3.0,
                                 margin: float = 0.05,
                                 epsilon: float = 1e-5):
        # kappa defaults to 3.0 here and to 1.04 in the one-shot
        # lanczos_approximate_log_spectrum, as in the JAX package
        spectra = [lanczos_approximate_log_spectrum_from_iter(
            it, self._boundaries, num_points, kappa, margin, epsilon)
            for it in self._get_lanczos_iters(num_repeats)]
        grid = spectra[0][0]
        return grid, sum(s[1] for s in spectra) / num_repeats


def lanczos_spectrum(op, k: int = 64, n_probes: int = 4, seed: int = 0,
                     n_bins: int = 100, margin: float = 0.05):
    """Smoothed spectral density estimate over the [min, max] Ritz value
    range, averaged over ``n_probes`` random starts. Returns
    (grid, density)."""
    all_nodes, all_weights = [], []
    for i in range(n_probes):
        alphas, betas, _ = lanczos_tridiag(op, k, seed=_fold_seed(seed, i))
        evals, S = torch.linalg.eigh(_tridiagonal(alphas, betas))
        all_nodes.append(evals.detach().cpu().numpy())
        all_weights.append((S[0, :] ** 2).detach().cpu().numpy())
    nodes = np.concatenate(all_nodes)
    weights = np.concatenate(all_weights) / n_probes
    lo, hi = nodes.min(), nodes.max()
    span = max(hi - lo, 1e-12)
    lo, hi = lo - margin * span, hi + margin * span
    grid = np.linspace(lo, hi, n_bins)
    sigma = (hi - lo) / n_bins * 2
    density = np.zeros(n_bins)
    for n, w in zip(nodes, weights):
        density += w * np.exp(-0.5 * ((grid - n) / sigma) ** 2) \
            / (sigma * np.sqrt(2 * np.pi))
    return grid, density
