"""Inverse linear operators: CG, LSMR, Neumann, KFAC-inverse (counterpart
of ``laplace_gnn_tpu/curvature/inverse.py``).

:func:`cg` runs the recurrence of ``jax.scipy.sparse.linalg.cg`` (its
stopping test ``r.r > max(tol^2 b.b, atol^2)``, its ``maxiter``), so its
iterates and iteration count are JAX's. :func:`lsmr` is the Fong &
Saunders (2011) Golub-Kahan recurrence; JAX's ``lax.while_loop`` becomes a
Python ``while`` with the same condition. The KFAC inverse takes plain,
heuristic (Martens-Grosse pi) or exact damping.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..laplace.kron import Kron
from .base import LinearOperator


def cg(matvec, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       tol: float = 1e-5, atol: float = 0.0, maxiter: Optional[int] = None):
    """Conjugate gradients for A x = b with A symmetric positive definite:
    the iteration of ``jax.scipy.sparse.linalg.cg`` (no preconditioner).
    Returns (x, the number of iterations run)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if maxiter is None:
        maxiter = 10 * b.numel()
    atol2 = max(tol ** 2 * float(torch.dot(b, b)), atol ** 2)
    r = b - matvec(x)
    p = r
    gamma = torch.dot(r, r)
    k = 0
    while float(gamma) > atol2 and k < maxiter:
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = torch.dot(r, r)
        p = r + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    return x, k


class CGInverseOperator(LinearOperator):
    """A^-1 v via conjugate gradients."""

    def __init__(self, op: LinearOperator, tol: float = 1e-5,
                 maxiter: Optional[int] = None, damping: float = 0.0):
        super().__init__(op.shape, op.dtype, op.device)
        self.op = op
        self.tol = tol
        self.maxiter = maxiter or op.shape[0]
        self.damping = damping

    def set_cg_hyperparameters(self, tol: Optional[float] = None,
                               maxiter: Optional[int] = None,
                               damping: Optional[float] = None) -> None:
        if tol is not None:
            self.tol = tol
        if maxiter is not None:
            self.maxiter = maxiter
        if damping is not None:
            self.damping = damping

    def _mv(self, x):
        if self.damping == 0:
            return self.op.matvec(x)
        return self.op.matvec(x) + self.damping * x

    def matvec(self, v):
        return cg(self._mv, v, tol=self.tol, maxiter=self.maxiter)[0]


def _sym_ortho(a, b):
    r = torch.hypot(a, b)
    safe = torch.where(r > 0, r, torch.ones_like(r))
    return (torch.where(r > 0, a / safe, torch.ones_like(r)),
            torch.where(r > 0, b / safe, torch.zeros_like(r)), r)


def lsmr(matvec, rmatvec, b: torch.Tensor, damp: float = 0.0,
         atol: float = 1e-6, maxiter: int = 100):
    """Solve min_x ||A x - b||^2 + damp^2 ||x||^2 by LSMR with the
    ||A^T r|| = |zetabar| stopping rule. Returns (x, iterations)."""
    one = torch.ones((), dtype=b.dtype, device=b.device)
    damp = one * damp
    u = b
    beta0 = torch.linalg.norm(u)
    u = u / torch.where(beta0 > 0, beta0, one)
    v = rmatvec(u)
    alpha0 = torch.linalg.norm(v)
    v = v / torch.where(alpha0 > 0, alpha0, one)
    x = torch.zeros_like(v)
    alpha, alphabar, zetabar = alpha0, alpha0, alpha0 * beta0
    rho, rhobar, cbar, sbar = one, one, one, 0 * one
    h, hbar = v, torch.zeros_like(v)
    tol = float(atol * alpha0 * beta0)
    k = 0
    while k < maxiter and float(torch.abs(zetabar)) > tol:
        u = matvec(v) - alpha * u
        beta = torch.linalg.norm(u)
        u = u / torch.where(beta > 0, beta, one)
        v = rmatvec(u) - beta * v
        alpha = torch.linalg.norm(v)
        v = v / torch.where(alpha > 0, alpha, one)

        _, _, alphahat = _sym_ortho(alphabar, damp)
        rho_old, rhobar_old = rho, rhobar
        c, sn, rho = _sym_ortho(alphahat, beta)
        thetanew = sn * alpha
        alphabar = c * alpha
        thetabar = sbar * rho
        cbar, sbar, rhobar = _sym_ortho(cbar * rho, thetanew)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar
        hbar = h - (thetabar * rho / (rho_old * rhobar_old)) * hbar
        x = x + (zeta / (rho * rhobar)) * hbar
        h = v - (thetanew / rho) * h
        k += 1
    return x, k


class LSMRInverseOperator(LinearOperator):
    """A^+ v via LSMR: works for rectangular or singular operators where CG
    does not apply, with Tikhonov ``damp``: min ||A x - v||^2 +
    damp^2 ||x||^2."""

    def __init__(self, op: LinearOperator, damp: float = 0.0,
                 atol: float = 1e-8, maxiter: Optional[int] = None):
        super().__init__((op.shape[1], op.shape[0]), op.dtype, op.device)
        self.op = op
        self.damp = damp
        self.atol = atol
        self.maxiter = maxiter or 4 * max(op.shape)

    def set_lsmr_hyperparameters(self, damp: Optional[float] = None,
                                 atol: Optional[float] = None,
                                 maxiter: Optional[int] = None) -> None:
        if damp is not None:
            self.damp = damp
        if atol is not None:
            self.atol = atol
        if maxiter is not None:
            self.maxiter = maxiter

    def matvec(self, v):
        x, _ = lsmr(self.op.matvec, self.op.rmatvec, v, damp=self.damp,
                    atol=self.atol, maxiter=self.maxiter)
        return x

    def matvec_with_info(self, v):
        """(x, {"iterations": k, "residual_norm": normr}), where normr is
        the damped residual sqrt(||Ax - v||^2 + damp^2 ||x||^2), what LSMR
        minimizes."""
        x, k = lsmr(self.op.matvec, self.op.rmatvec, v, damp=self.damp,
                    atol=self.atol, maxiter=self.maxiter)
        r = self.op.matvec(x) - v
        normr = torch.sqrt(torch.sum(r * r)
                           + self.damp ** 2 * torch.sum(x * x))
        return x, {"iterations": k, "residual_norm": normr}


class NeumannInverseOperator(LinearOperator):
    """Truncated Neumann series A^-1 ~ scale * sum_k (I - scale*A)^k."""

    def __init__(self, op: LinearOperator, num_terms: int = 100,
                 scale: float = 1.0, check_nan: bool = True):
        super().__init__(op.shape, op.dtype, op.device)
        self.op = op
        self.num_terms = num_terms
        self.scale = scale
        self.check_nan = check_nan

    def set_neumann_hyperparameters(self, num_terms: Optional[int] = None,
                                    scale: Optional[float] = None,
                                    check_nan: Optional[bool] = None) -> None:
        if num_terms is not None:
            self.num_terms = num_terms
        if scale is not None:
            self.scale = scale
        if check_nan is not None:
            self.check_nan = check_nan

    def matvec(self, v):
        result, term = v, v
        for _ in range(self.num_terms):
            term = term - self.scale * self.op.matvec(term)
            result = result + term
        out = self.scale * result
        if self.check_nan and bool(torch.any(~torch.isfinite(out))):
            raise ValueError(
                "Output of Neumann series contains NaNs or Infs. Is the "
                "scale suitable (spectral radius of I - scale*A < 1)?")
        return out


def _eye_like(F: torch.Tensor) -> torch.Tensor:
    return torch.eye(F.shape[0], dtype=F.dtype, device=F.device)


def kfac_inverse_factors(kron: Kron, damping: float = 0.0,
                         damping_method: str = "plain",
                         exponent: float = -1.0) -> list:
    """Invert KFAC factors per block with optional damping.

    damping_method:
      - 'plain':      (G + sqrt(d) I)^-1 (x) (A + sqrt(d) I)^-1
      - 'heuristic':  Martens & Grosse pi-corrected split
                      pi = sqrt(tr(G)/dim(G) / (tr(A)/dim(A)))
      - 'exact':      eigendecompose and invert (l_G l_A + d)^-1 exactly.

    Returns per-group lists for :class:`KFACInverseOperator`."""
    if damping_method not in ("plain", "heuristic", "exact"):
        raise ValueError(f"Unknown damping method {damping_method!r}")

    inv_groups = []
    for group in kron.kfacs:
        if len(group) == 1:
            F = group[0]
            inv_groups.append([_mat_pow(F + damping * _eye_like(F),
                                        exponent)])
            continue
        G, A = group
        if damping_method == "exact":
            lG, QG = torch.linalg.eigh(G)
            lA, QA = torch.linalg.eigh(A)
            leff = (torch.outer(lG, lA) + damping) ** exponent
            # not a Kronecker product: kept in the two eigenbases
            inv_groups.append([QG, lG, QA, lA, leff])
            continue
        if damping_method == "heuristic" and damping > 0:
            trG = torch.trace(G) / G.shape[0]
            trA = torch.trace(A) / A.shape[0]
            pi = torch.sqrt(torch.clamp(trG, min=1e-30)
                            / torch.clamp(trA, min=1e-30))
            dG, dA = damping ** 0.5 * pi, damping ** 0.5 / pi
        else:
            dG = dA = damping ** 0.5 if damping > 0 else 0.0
        inv_groups.append([_mat_pow(G + dG * _eye_like(G), exponent),
                           _mat_pow(A + dA * _eye_like(A), exponent)])
    return inv_groups


def _mat_pow(M: torch.Tensor, exponent: float) -> torch.Tensor:
    if exponent == -1.0:
        return torch.linalg.inv(M)
    l, Q = torch.linalg.eigh(M)
    return (Q * torch.clamp(l, min=1e-30) ** exponent) @ Q.T


class KFACInverseOperator:
    """Apply the (damped) KFAC inverse to vectors shaped like the flat
    posterior vector."""

    def __init__(self, kron: Kron, damping: float = 0.0,
                 damping_method: str = "plain"):
        self.kron = kron
        self.damping_method = damping_method
        self.damping = damping
        self._cache = kfac_inverse_factors(kron, damping, damping_method)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        out, cur = [], 0
        for group in self._cache:
            if len(group) == 1:
                F = group[0]
                p = F.shape[0]
                out.append(F @ v[cur: cur + p])
                cur += p
            elif len(group) == 2:
                Gi, Ai = group
                po, pi = Gi.shape[0], Ai.shape[0]
                Wp = v[cur: cur + po * pi].reshape(po, pi)
                out.append((Gi @ Wp @ Ai.T).reshape(-1))
                cur += po * pi
            else:  # exact eigen path
                QG, lG, QA, lA, leff = group
                po, pi = QG.shape[0], QA.shape[0]
                Wp = v[cur: cur + po * pi].reshape(po, pi)
                Wp = QG @ ((QG.T @ Wp @ QA) * leff) @ QA.T
                out.append(Wp.reshape(-1))
                cur += po * pi
        return torch.cat(out)

    def state_dict(self) -> dict:
        """The source Kron factors (detached copies) and the damping; the
        inverse cache is rebuilt on load."""
        return {
            "kfacs": [[f.detach().clone() for f in group]
                      for group in self.kron.kfacs],
            "damping": self.damping,
            "damping_method": self.damping_method,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "KFACInverseOperator":
        kron = Kron([[torch.as_tensor(f) for f in group]
                     for group in state["kfacs"]])
        return cls(kron, damping=state["damping"],
                   damping_method=state["damping_method"])

    def load_state_dict(self, state: dict) -> None:
        new = self.from_state_dict(state)
        self.kron = new.kron
        self.damping = new.damping
        self.damping_method = new.damping_method
        self._cache = new._cache
