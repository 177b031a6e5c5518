"""Parametric Laplace flavours (counterpart of
``laplace_gnn_tpu/laplace/flavors.py``): full, Kronecker-factored,
low-rank and diagonal posterior precision. Each ``fit`` is the span
``laplace.fit`` (``profiling.py``), around the base class's.

Each flavour's ``sample`` draws its standard normals through
``ops/linalg.py::_standard_normals``, which a test replaces to feed both
packages the same noise."""

from __future__ import annotations

from typing import Optional

import torch

from ..curvature.operators import GGNOperator
from ..curvature.spectrum import lanczos_eigh
from ..ops import linalg
from ..profiling import annotate
from ..utils.data import dataset_size
from .base import ParametricLaplace
from .kron import Kron, KronDecomposed


class FullLaplace(ParametricLaplace):
    """Dense P x P posterior precision. The posterior scale (a lower
    Cholesky-type factor of the covariance) is formed on first use and
    kept until the fit or a prior changes."""

    _key = ("all", "full")

    def __init__(self, model, params, likelihood, **kwargs):
        self._posterior_scale = None
        super().__init__(model, params, likelihood, **kwargs)

    def _init_H(self) -> None:
        self.H = torch.zeros((self.n_params, self.n_params),
                             dtype=self._dtype, device=self._device)

    def _curv_closure(self, X, y, N: int, batch_idx: int = 0):
        loss, H = self.backend.full(X, y, N=N)
        return loss.detach(), H.detach()

    @annotate("laplace.fit")
    def fit(self, train_loader, override: bool = True) -> None:
        self._posterior_scale = None
        super().fit(train_loader, override=override)

    @property
    def posterior_precision(self) -> torch.Tensor:
        self._check_H_init()
        P = self._H_factor * self.H
        P.diagonal().add_(self.prior_precision_diag)   # no second P x P
        return P

    @property
    def posterior_scale(self) -> torch.Tensor:
        if self._posterior_scale is None:
            self._posterior_scale = linalg.invsqrt_precision(
                self.posterior_precision)
        return self._posterior_scale

    @property
    def posterior_covariance(self) -> torch.Tensor:
        scale = self.posterior_scale
        return scale @ scale.T

    @property
    def log_det_posterior_precision(self) -> torch.Tensor:
        return torch.linalg.slogdet(self.posterior_precision)[1]

    def square_norm(self, value):
        delta = value - self.mean
        return delta @ self.posterior_precision @ delta

    def functional_variance(self, Js):
        return torch.einsum("ncp,pq,nkq->nck", Js, self.posterior_covariance,
                            Js)

    def functional_covariance(self, Js):
        n, c, p = Js.shape
        Js = Js.reshape(n * c, p)
        return torch.einsum("np,pq,mq->nm", Js, self.posterior_covariance,
                            Js)

    def sample(self, n_samples: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        generator = generator if generator is not None else self.generator
        eps = linalg._standard_normals((n_samples, self.n_params), generator,
                                       self.mean.dtype, self.mean.device)
        return self.mean[None, :] + eps @ self.posterior_scale


class KronLaplace(ParametricLaplace):
    """Kronecker-factored posterior precision.

    ``H`` holds the eigendecomposed factors after fit; the raw accumulated
    factors stay in ``H_facs`` for online updates."""

    _key = ("all", "kron")

    def __init__(self, model, params, likelihood, damping: bool = False,
                 **kwargs):
        self.damping = damping
        self.H_facs: Optional[Kron] = None
        super().__init__(model, params, likelihood, **kwargs)

    def _init_H(self) -> None:
        # the first batch's factors define the block structure, which keeps
        # the exact-diagonal blocks of non-Linear posterior parameters (GAT
        # attention vectors) where zero [B, A] factors would not
        self.H = None

    def _check_H_init(self):
        if getattr(self, "H_facs", None) is None:
            raise AttributeError("Laplace not fitted. Run fit() first.")

    def _curv_closure(self, X, y, N: int, batch_idx: int = 0):
        # detached: the tap perturbations of the KFAC pass would otherwise
        # keep the whole forward graph alive behind the loss and A factors.
        # The batch index is folded into the seed, as in JAX, so the sketch
        # and MC noise of a multi-batch fit is independent across batches
        seed = getattr(self.backend, "seed", 0) + batch_idx
        loss, kron = self.backend.kron(X, y, N=N, seed=seed)
        return loss.detach(), Kron([[f.detach() for f in g]
                                    for g in kron.kfacs])

    @staticmethod
    def _rescale_factors(kron: Kron, factor) -> Kron:
        """Scale only the A factor of two-factor groups."""
        return Kron([[g[0], g[1] * factor] if len(g) == 2 else [g[0]]
                     for g in kron.kfacs])

    @annotate("laplace.fit")
    def fit(self, train_loader, override: bool = True) -> None:
        if override:
            self.H_facs = None
        if self.H_facs is not None:
            n_data_old = self.n_data
            n_data_new = dataset_size(train_loader)
            self._init_H()
            self.H_facs = self._rescale_factors(
                self.H_facs, n_data_old / (n_data_old + n_data_new))

        super().fit(train_loader, override=override)

        if self.H_facs is None:
            self.H_facs = self.H
        else:
            self.H = self._rescale_factors(
                self.H, n_data_new / (n_data_new + n_data_old))
            self.H_facs = self.H_facs + self.H
        # decompose for inference; keep H_facs for further accumulation
        self.H = self.H_facs.decompose(damping=self.damping)

    @property
    def posterior_precision(self) -> KronDecomposed:
        self._check_H_init()
        return self.H * self._H_factor + self.prior_precision

    @property
    def log_det_posterior_precision(self) -> torch.Tensor:
        if isinstance(self.H, Kron):  # not decomposed: the prior alone
            return torch.sum(torch.log(self.prior_precision_diag))
        return self.posterior_precision.logdet()

    def square_norm(self, value):
        delta = value - self.mean
        if isinstance(self.H, Kron):
            return (delta * self.prior_precision_diag) @ delta
        return delta @ self.posterior_precision.bmm(delta, exponent=1)

    def functional_variance(self, Js):
        return self.posterior_precision.inv_square_form(Js)

    def functional_covariance(self, Js):
        n, c, p = Js.shape
        return self.posterior_precision.inv_square_form(
            Js.reshape(1, n * c, p))[0]

    def sample(self, n_samples: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        generator = generator if generator is not None else self.generator
        eps = linalg._standard_normals((n_samples, self.n_params), generator,
                                       self.mean.dtype, self.mean.device)
        samples = self.posterior_precision.bmm(eps, exponent=-0.5)
        return self.mean[None, :] + samples.reshape(n_samples, self.n_params)

    @ParametricLaplace.prior_precision.setter
    def prior_precision(self, prior_precision) -> None:
        ParametricLaplace.prior_precision.fset(self, prior_precision)
        if self._prior_precision.shape[0] not in (1, self.n_layers):
            raise ValueError("Prior precision for Kron either scalar or "
                             "per-layer.")

    def _H_for_state(self):
        return self.H_facs.kfacs

    def _load_H(self, H) -> None:
        self.H_facs = Kron(H)
        self.H = self.H_facs.decompose(damping=self.damping)


class LowRankLaplace(ParametricLaplace):
    """Low-rank GGN eigendecomposition plus the prior: H ~ V diag(l) V^T
    from Lanczos on the matrix-free GGN operator; the Woodbury identity
    gives the covariance. The Lanczos start vector is drawn with a seed
    taken from the Laplace object's generator, where JAX splits its key.

    The GGN products are forward-over-reverse, so, as in JAX, the fit
    raises on a model whose fused aggregation has no forward-mode rule
    (``STEGCN(fused=True)``). ``posterior_covariance``,
    ``functional_variance`` and ``sample`` form the dense P x P
    covariance, as JAX's do."""

    _key = ("all", "lowrank")

    def __init__(self, model, params, likelihood, rank: int = 10, **kwargs):
        self.rank = rank
        super().__init__(model, params, likelihood, **kwargs)

    def _init_H(self) -> None:
        self.H = None

    @annotate("laplace.fit")
    def fit(self, train_loader, override: bool = True) -> None:
        if not override:
            raise ValueError("LowRank LA does not support updating.")
        self.mean = self.backend.mean_vector()
        data = [self._unpack_batch(d) for d in train_loader]
        N = dataset_size(train_loader, dict_key_y=self.dict_key_y)
        op = GGNOperator(self.backend.model_fn, self.likelihood,
                         self.backend.w, data)
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator,
                                 device=self.generator.device))
        evals, evecs = lanczos_eigh(op, k=min(self.rank, self.n_params),
                                    seed=seed)
        order = torch.argsort(evals, descending=True)
        evals, evecs = evals[order].detach(), evecs[:, order].detach()
        keep = evals > 1e-10
        self.H = (evecs[:, keep], evals[keep] * self.factor_correction())

        with torch.no_grad():
            self.loss = sum(self.backend.loss(X, y) for X, y in data)
            self.n_outputs = self.backend.model_fn(
                self.backend.w, data[0][0]).shape[-1]
        self.n_data = N

    def factor_correction(self):
        # GGNOperator works on the raw sum-loss; apply the likelihood factor
        return self.backend.factor if self.likelihood == "regression" else 1.0

    @property
    def V(self) -> torch.Tensor:
        return self.H[0]

    @property
    def Kinv(self) -> torch.Tensor:
        """(diag(l)^-1 + V^T P0^-1 V)^-1, the Woodbury core."""
        V, l = self.H
        inner = torch.diag(1.0 / (l * self._H_factor)) \
            + V.T @ (V / self.prior_precision_diag[:, None])
        return torch.linalg.inv(inner)

    @property
    def posterior_precision(self):
        self._check_H_init()
        V, l = self.H
        return V, l * self._H_factor, self.prior_precision_diag

    @property
    def posterior_covariance(self) -> torch.Tensor:
        """P0^-1 - P0^-1 V Kinv V^T P0^-1 (Woodbury)."""
        V, l, p0 = self.posterior_precision
        A = V / p0[:, None]
        return torch.diag(1.0 / p0) - A @ self.Kinv @ A.T

    @property
    def log_det_posterior_precision(self) -> torch.Tensor:
        V, l, p0 = self.posterior_precision
        inner = torch.eye(V.shape[1], dtype=V.dtype, device=V.device) \
            + (V * l[None, :]).T @ (V / p0[:, None])
        return torch.linalg.slogdet(inner)[1] + torch.sum(torch.log(p0))

    def square_norm(self, value):
        delta = value - self.mean
        V, l, p0 = self.posterior_precision
        return delta @ (p0 * delta) + (delta @ V) @ ((delta @ V) * l)

    def functional_variance(self, Js):
        return torch.einsum("ncp,pq,nkq->nck", Js, self.posterior_covariance,
                            Js)

    def functional_covariance(self, Js):
        n, c, p = Js.shape
        Js = Js.reshape(n * c, p)
        return Js @ self.posterior_covariance @ Js.T

    def sample(self, n_samples: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        generator = generator if generator is not None else self.generator
        cov = self.posterior_covariance
        scale = torch.linalg.cholesky(
            cov + 1e-10 * torch.eye(cov.shape[0], dtype=cov.dtype,
                                    device=cov.device))
        eps = linalg._standard_normals((n_samples, self.n_params), generator,
                                       self.mean.dtype, self.mean.device)
        return self.mean[None, :] + eps @ scale.T

    def _H_for_state(self):
        return {"V": self.H[0], "l": self.H[1]}

    def _load_H(self, H) -> None:
        self.H = (H["V"], H["l"])


class DiagLaplace(ParametricLaplace):
    """Diagonal posterior precision."""

    _key = ("all", "diag")

    def _init_H(self) -> None:
        self.H = torch.zeros(self.n_params, dtype=self._dtype,
                             device=self._device)

    def _curv_closure(self, X, y, N: int, batch_idx: int = 0):
        loss, H = self.backend.diag(X, y, N=N)
        return loss.detach(), H.detach()

    @property
    def posterior_precision(self) -> torch.Tensor:
        self._check_H_init()
        return self._H_factor * self.H + self.prior_precision_diag

    @property
    def posterior_scale(self) -> torch.Tensor:
        return 1.0 / torch.sqrt(self.posterior_precision)

    @property
    def posterior_variance(self) -> torch.Tensor:
        return 1.0 / self.posterior_precision

    @property
    def log_det_posterior_precision(self) -> torch.Tensor:
        return torch.sum(torch.log(self.posterior_precision))

    def square_norm(self, value):
        delta = value - self.mean
        return delta @ (delta * self.posterior_precision)

    def functional_variance(self, Js):
        return torch.einsum("ncp,p,nkp->nck", Js, self.posterior_variance, Js)

    def functional_covariance(self, Js):
        n, c, p = Js.shape
        Js = Js.reshape(n * c, p)
        return torch.einsum("np,p,mp->nm", Js, self.posterior_variance, Js)

    def sample(self, n_samples: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        generator = generator if generator is not None else self.generator
        eps = linalg._standard_normals((n_samples, self.n_params), generator,
                                       self.mean.dtype, self.mean.device)
        return self.mean[None, :] + eps * self.posterior_scale[None, :]
