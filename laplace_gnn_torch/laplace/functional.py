"""GP (functional) Laplace (counterpart of
``laplace_gnn_tpu/laplace/functional.py``): the GGN Laplace as a Gaussian
process with kernel K = gamma^2 J J^T over a subset of the data.

``fit`` draws ``n_subset`` points with ``numpy.random.default_rng(seed)``
(the JAX package's draw), takes their Jacobians J_M (M, C, P) once, the
diagonal of the likelihood Hessian Lambda (1 for regression, p (1 - p)
for classification) and the Cholesky factor of gamma^2 K_MM +
Lambda^-1 (the reciprocal of a zero Lambda becomes 10, as in JAX), with
gamma^2 = (n_subset / N) / prior precision. ``independent_outputs`` keeps
one M x M kernel per output instead of the joint MC x MC one. The prior
is a scalar. ``FunctionalLLLaplace`` restricts the Jacobians to the last
layer (the closed form where the model allows it).

Reward modeling fits as classification and predicts as regression, where
the test-time output width (1, a reward) may differ from the fit's (2, a
pair)."""

from __future__ import annotations

import copy
import math
import warnings
from typing import Optional

import numpy as np
import torch

from ..ops.linalg import normal_samples
from ..utils.data import dataset_size
from .base import BaseLaplace
from .enums import Likelihood, LinkApprox, PredType
from .predictive import glm_classification_predictive


def _lower_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


def _slogdet(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.slogdet(A)[1]


class FunctionalLaplace(BaseLaplace):
    _key = ("all", "gp")

    def __init__(self, model, params, likelihood: str, n_subset: int,
                 independent_outputs: bool = False, seed: int = 0, **kwargs):
        self._check_prior_precision(kwargs.get("prior_precision", 1.0))
        super().__init__(model, params, likelihood, **kwargs)
        self.n_subset = n_subset
        self.independent_outputs = independent_outputs
        self.seed = seed
        self.K_MM = None          # (MC, MC), or a list of C (M, M)
        self.Sigma_inv = None     # Cholesky factor of gamma^2 K_MM + L^-1
        self.L = None             # Lambda at the subset, (MC,) or C (M,)
        self.mu = None            # the scatter term's mean
        self._J_M = None          # (M, C, P)
        self._prior_factor_sod = None
        self.mean = self.backend.mean_vector()
        self._fitted = False

    @staticmethod
    def _check_prior_precision(prior_precision) -> None:
        pp = torch.atleast_1d(torch.as_tensor(prior_precision))
        if pp.dim() > 1 or pp.shape[0] != 1:
            raise ValueError("Only isotropic priors supported in "
                             "FunctionalLaplace")

    @BaseLaplace.prior_precision.setter
    def prior_precision(self, prior_precision) -> None:
        BaseLaplace.prior_precision.fset(self, prior_precision)
        if self._prior_precision.shape[0] != 1:
            raise ValueError("Only isotropic priors supported in "
                             "FunctionalLaplace")

    @property
    def gp_kernel_prior_variance(self) -> torch.Tensor:
        return self._prior_factor_sod / self.prior_precision[0]

    def _jacobians(self, X):
        return self.backend.jacobians(X)

    def _eye(self, n: int) -> torch.Tensor:
        return torch.eye(n, dtype=self._dtype, device=self._device)

    # -- fit ---------------------------------------------------------------
    def fit(self, train_loader) -> None:
        """The subset's Jacobians, kernel, Lambda and scatter mean from a
        loader of (X, y) batches."""
        N = dataset_size(train_loader)
        self.n_data = N
        if self.n_subset > N:
            raise ValueError("`n_subset` must be less than or equal to the "
                             "original number of data points.")
        Xs, ys = zip(*[(X, y) for X, y in train_loader])
        idx = np.random.default_rng(self.seed).choice(N, self.n_subset,
                                                      replace=False)
        X_all, y_all = torch.cat(Xs), torch.cat(ys)
        sel = torch.as_tensor(idx, device=X_all.device)
        X_M, y_M = X_all[sel], y_all[sel.to(y_all.device)]
        self._X_M, self._y_M = X_M, y_M
        self._prior_factor_sod = self.n_subset / self.n_data

        Js, f = self._jacobians(X_M)
        Js, f = Js.detach(), f.detach()
        self._J_M = Js
        self.n_outputs = f.shape[-1]
        M, C = f.shape
        if (self.likelihood == Likelihood.REGRESSION.value
                and self.n_outputs > 1 and self.independent_outputs):
            warnings.warn(
                "Using FunctionalLaplace with the diagonal approximation of "
                "a GP kernel is not recommended in the case of multivariate "
                "regression. Predictive variance will likely be "
                "overestimated.")
        with torch.no_grad():
            self.loss = self.backend.loss(X_M, y_M)

        if self.likelihood == Likelihood.REGRESSION.value:
            L_diag = torch.ones((M, C), dtype=f.dtype, device=f.device)
        else:
            p = torch.softmax(f, dim=-1)
            L_diag = p * (1 - p)
        if self.independent_outputs:
            self.L = [L_diag[:, c] for c in range(C)]
            self.K_MM = [Js[:, c, :] @ Js[:, c, :].T for c in range(C)]
        else:
            self.L = L_diag.reshape(-1)
            Jf = Js.reshape(M * C, -1)
            self.K_MM = Jf @ Jf.T

        shift = torch.einsum("bcp,p->bc", Js, self.prior_mean - self.mean)
        if self.likelihood == Likelihood.REGRESSION.value:
            self.mu = y_M - (f + shift)
        else:
            self.mu = -shift
        self._build_Sigma_inv()
        self._fitted = True

    def _noise_diag(self, L: torch.Tensor) -> torch.Tensor:
        return torch.diag(torch.nan_to_num(1.0 / (self._H_factor * L),
                                           posinf=10.0))

    def _build_Sigma_inv(self) -> None:
        gamma2 = self.gp_kernel_prior_variance
        if self.independent_outputs:
            self.Sigma_inv = [
                torch.linalg.cholesky(gamma2 * K + self._noise_diag(L))
                for K, L in zip(self.K_MM, self.L)]
        else:
            self.Sigma_inv = torch.linalg.cholesky(
                gamma2 * self.K_MM + self._noise_diag(self.L))

    # -- predictive --------------------------------------------------------
    def _glm_predictive_distribution(self, X, joint: bool = False):
        Js, f_mu = self._jacobians(X)
        Js, f_mu = Js.detach(), f_mu.detach()
        f_var = (self.functional_covariance(Js) if joint
                 else self.functional_variance(Js))
        if joint:
            f_mu = f_mu.reshape(-1)
        return f_mu, f_var

    def functional_variance(self, Js_star: torch.Tensor) -> torch.Tensor:
        """k_** - K_*M (gamma^2 K_MM + Lambda^-1)^-1 K_M*, (B, C, C)."""
        gamma2 = self.gp_kernel_prior_variance
        J_M = self._J_M
        if self.independent_outputs:
            var = []
            for c in range(self.n_outputs):
                k_ss = gamma2 * torch.sum(Js_star[:, c, :] ** 2, dim=-1)
                K_sM = gamma2 * Js_star[:, c, :] @ J_M[:, c, :].T
                v = _lower_solve(self.Sigma_inv[c], K_sM.T).T
                var.append(k_ss - torch.sum(v * v, dim=-1))
            return torch.diag_embed(torch.stack(var, dim=-1))
        K_ss = gamma2 * torch.einsum("bcp,bep->bce", Js_star, Js_star)
        M, C, _ = J_M.shape
        # the test-time output width may differ from the fit's C (reward
        # modeling fits (B, 2) pairs and predicts (B, 1) rewards)
        B, Cs, _ = Js_star.shape
        K_sM = gamma2 * torch.einsum("bcp,mep->bmec", Js_star,
                                     J_M).reshape(B, M * C, Cs)
        v = _lower_solve(self.Sigma_inv, K_sM)
        return K_ss - torch.einsum("bcm,bcn->bmn", v, v)

    def functional_covariance(self, Js_star: torch.Tensor) -> torch.Tensor:
        """The joint covariance over every test point and output,
        (BC, BC)."""
        gamma2 = self.gp_kernel_prior_variance
        J_M = self._J_M
        B, C, _ = Js_star.shape
        if self.independent_outputs:
            covs = []
            for c in range(C):
                k_ss = gamma2 * Js_star[:, c, :] @ Js_star[:, c, :].T
                K_sM = gamma2 * Js_star[:, c, :] @ J_M[:, c, :].T
                v = _lower_solve(self.Sigma_inv[c], K_sM.T).T
                covs.append(k_ss - v @ v.T)
            f_var = torch.diag_embed(torch.stack(covs, dim=-1))
        else:
            K_ss = gamma2 * torch.einsum("acp,bep->abce", Js_star, Js_star)
            M = J_M.shape[0]
            K_sM = gamma2 * torch.einsum("bcp,mep->bmec", Js_star,
                                         J_M).reshape(B, M * C, C)
            v = _lower_solve(self.Sigma_inv, K_sM)
            f_var = K_ss - torch.einsum("acm,bcn->abmn", v, v)
        return f_var.permute(0, 2, 1, 3).reshape(B * C, B * C)

    def __call__(self, x, pred_type: str = PredType.GP.value,
                 joint: bool = False,
                 link_approx: str = LinkApprox.PROBIT.value,
                 n_samples: int = 100, diagonal_output: bool = False,
                 generator: Optional[torch.Generator] = None,
                 fitting: bool = False):
        if pred_type != PredType.GP.value:
            raise ValueError("Only gp supported as prediction type.")
        if not self._fitted:
            raise RuntimeError("Functional Laplace has not been fitted to "
                               "any iterable of (feature, target) pairs.")
        generator = generator if generator is not None else self.generator
        likelihood = self.likelihood
        if likelihood == Likelihood.REWARD_MODELING.value:
            likelihood = (Likelihood.CLASSIFICATION.value if fitting
                          else Likelihood.REGRESSION.value)
        f_mu, f_var = self._glm_predictive_distribution(
            x, joint=joint and likelihood == Likelihood.REGRESSION.value)
        if likelihood == Likelihood.REGRESSION.value:
            if diagonal_output and not joint:
                f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
            return f_mu, f_var
        return glm_classification_predictive(
            f_mu, f_var, link_approx, n_samples, diagonal_output,
            generator=generator)

    def predictive_samples(self, x, pred_type: str = PredType.GP.value,
                           n_samples: int = 100,
                           diagonal_output: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """(n_samples, B, C) samples of the GP predictive, softmaxed for
        classification."""
        if pred_type != PredType.GP.value:
            raise ValueError("Only gp supported as prediction type.")
        generator = generator if generator is not None else self.generator
        f_mu, f_var = self._glm_predictive_distribution(x)
        if diagonal_output:
            f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
        fs = normal_samples(f_mu, f_var, n_samples, generator)
        if self.likelihood == Likelihood.CLASSIFICATION.value:
            fs = torch.softmax(fs, dim=-1)
        return fs

    # -- marglik -----------------------------------------------------------
    @property
    def log_det_ratio(self) -> torch.Tensor:
        gamma2 = self.gp_kernel_prior_variance
        if self.likelihood == Likelihood.REGRESSION.value:
            Ks = self.K_MM if self.independent_outputs else [self.K_MM]
            return sum(_slogdet(gamma2 * K + self.sigma_noise ** 2
                                * self._eye(K.shape[0])) for K in Ks)
        pairs = (zip(self.K_MM, self.L) if self.independent_outputs
                 else [(self.K_MM, self.L)])
        out = 0.0
        for K, L in pairs:
            W = torch.sqrt(self._H_factor * L)
            out = out + _slogdet(W[:, None] * gamma2 * K * W[None, :]
                                 + self._eye(K.shape[0]))
        return out

    @property
    def scatter(self) -> torch.Tensor:
        """mu^T (gamma^2 K_MM + noise I)^-1 mu, the noise 1e-5 for
        classification. The subset kernel is singular wherever the
        Jacobians have fewer columns than MC rows (a last layer), so in
        float32 its rounding outweighs the 1e-5: the factor is formed in
        float64 (an MC x MC matrix) and the result cast back."""
        noise = (self.sigma_noise ** 2
                 if self.likelihood == Likelihood.REGRESSION.value else 1e-5)
        gamma2 = self.gp_kernel_prior_variance
        pairs = ([(K, self.mu[:, c]) for c, K in enumerate(self.K_MM)]
                 if self.independent_outputs
                 else [(self.K_MM, self.mu.reshape(-1))])
        out = 0.0
        for K, mu in pairs:
            eye = self._eye(K.shape[0]).double()
            chol = torch.linalg.cholesky(gamma2 * K.double() + noise * eye)
            t = _lower_solve(chol, mu.double()[:, None])[:, 0]
            out = out + t @ t
        return out.to(self._dtype)

    def log_marginal_likelihood(self, prior_precision=None, sigma_noise=None):
        if prior_precision is not None:
            self.prior_precision = prior_precision
            self._build_Sigma_inv()
        if sigma_noise is not None:
            if self.likelihood != Likelihood.REGRESSION.value:
                raise ValueError("Can only change sigma_noise for "
                                 "regression.")
            self.sigma_noise = sigma_noise
            self._build_Sigma_inv()
        return self.log_likelihood - 0.5 * (self.log_det_ratio + self.scatter)

    def _pure_log_marglik(self, prior_precision, sigma_noise):
        """The log marglik at ``prior_precision`` and ``sigma_noise``,
        differentiable in both, on a shallow copy."""
        la = copy.copy(self)
        la._prior_precision = torch.atleast_1d(prior_precision)
        la._sigma_noise = torch.as_tensor(sigma_noise)
        return la.log_likelihood - 0.5 * (la.log_det_ratio + la.scatter)

    def optimize_prior_precision(self, pred_type: str = PredType.GP.value,
                                 **kwargs) -> None:
        """Scalar prior only. As in JAX, a grid search scores each value
        with the Cholesky factor of the fit-time prior; the factor is
        rebuilt once the prior is chosen."""
        if pred_type != PredType.GP.value:
            raise ValueError("Only gp pred_type is supported.")
        if kwargs.get("prior_structure", "scalar") != "scalar":
            raise ValueError("Only isotropic priors supported in "
                             "FunctionalLaplace")
        if kwargs.get("method", "marglik") == "marglik":
            warnings.warn(
                "Use of method='marglik' in case of FunctionalLaplace is "
                "discouraged, rather use method='gridsearch'.")
        super().optimize_prior_precision(pred_type=pred_type, **kwargs)
        self._build_Sigma_inv()

    @property
    def log_likelihood(self) -> torch.Tensor:
        factor = -self._H_factor
        if self.likelihood == Likelihood.REGRESSION.value:
            c = (self.n_subset * self.n_outputs
                 * torch.log(self.sigma_noise * math.sqrt(2 * math.pi)))
            return factor * self.loss - c
        return factor * self.loss


class FunctionalLLLaplace(FunctionalLaplace):
    """GP Laplace over the last layer."""

    _key = ("last_layer", "gp")

    def _backend_extra(self) -> dict:
        return {"last_layer": True}

    def _jacobians(self, X):
        return self.backend._jacs(X)
