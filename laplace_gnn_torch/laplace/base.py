"""BaseLaplace / ParametricLaplace (counterpart of
``laplace_gnn_tpu/laplace/base.py``).

A Laplace object holds the posterior over the parameters that the backend
selects (everything but ``adj``/``norms``): it fits the curvature on a
loader, gives the log marginal likelihood, and predicts with the GLM
(linearized) or the NN (sampled-weights) predictive.

As in the JAX package, the curvature backend gets ``model.jvp_safe()``
(the flash attention Function has no forward-mode rule) while predictions
run ``self.model``, which keeps the kernels. The parameters are held
detached. Random draws come from a ``torch.Generator`` (seeded with 0
unless one is passed), where JAX splits a key.

The prior precision is tuned by the marginal likelihood (Adam on its log,
optax's ``adam`` step for step) or by a grid search on a validation
loader; ``state_dict`` / ``load_state_dict`` carry a fitted posterior.

Spans (``profiling.py``): ``laplace.fit``, ``laplace.log_marglik``,
``laplace.tune_prior`` (its steps: ``laplace.log_marglik``,
``laplace.tune_prior.grad`` and ``laplace.tune_prior.adam``; counted as
``laplace.tune_prior.steps``) and ``laplace.predictive`` (its parts:
``laplace.jacobians``, ``laplace.variance``, ``laplace.samples``).
"""

from __future__ import annotations

import copy
import math
from collections.abc import MutableMapping
from typing import Callable, Optional

import numpy as np
import torch

from ..curvature.interface import CurvatureBackend, GGNBackend
from ..ops.linalg import normal_samples
from ..profiling import annotate, count
from ..utils.data import dataset_size
from ..utils.metrics import fix_prior_prec_structure, mse_loss, nll_loss
from ..utils.pytree import DEFAULT_EXCLUDE, merge_split, named_leaves
from .enums import (LinkApprox, Likelihood, PredType, PriorStructure,
                    TuningMethod)
from .predictive import glm_classification_predictive


def _map_tensors(fn, tree):
    """``fn`` on a tensor, or on each tensor of nested lists and dicts."""
    if isinstance(tree, (list, tuple)):
        return [_map_tensors(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, t) for k, t in tree.items()}
    return fn(tree)


class BaseLaplace:
    def __init__(self, model, params, likelihood: str,
                 sigma_noise: float = 1.0,
                 prior_precision: float = 1.0,
                 prior_mean: float = 0.0,
                 temperature: float = 1.0,
                 enable_backprop: bool = False,
                 dict_key_x: str = "input_ids",
                 dict_key_y: str = "labels",
                 backend: Optional[type] = None,
                 backend_kwargs: Optional[dict] = None,
                 exclude=DEFAULT_EXCLUDE,
                 generator: Optional[torch.Generator] = None):
        if likelihood not in [e.value for e in Likelihood]:
            raise ValueError(f"Invalid likelihood type {likelihood}")
        self.model = model
        self.dict_key_x = dict_key_x
        self.dict_key_y = dict_key_y
        # reward modeling fits as classification and predicts as regression
        self.likelihood = likelihood
        self.enable_backprop = enable_backprop

        fit_likelihood = (Likelihood.CLASSIFICATION.value
                          if likelihood == Likelihood.REWARD_MODELING.value
                          else likelihood)
        backend_cls = backend or self._default_backend()
        curv_model = model.jvp_safe() if hasattr(model, "jvp_safe") else model
        params = {k: v.detach() for k, v in params.items()}
        self.backend: CurvatureBackend = backend_cls(
            curv_model, params, fit_likelihood, exclude=exclude,
            **self._backend_extra(), **(backend_kwargs or {}))

        theta = self.backend.mean_vector()
        self._dtype, self._device = theta.dtype, theta.device
        self.n_params = self.backend.n_params
        self.n_layers = len(self.backend.w)
        self.prior_precision = prior_precision
        self.prior_mean = prior_mean
        self.sigma_noise = sigma_noise
        self.temperature = temperature

        self.loss = self._scalar(0.0)
        self.n_data: int = 0
        self.n_outputs: Optional[int] = getattr(model, "n_outputs", None)
        self.generator = (generator if generator is not None else
                          torch.Generator(device=self._device).manual_seed(0))

    def _scalar(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self._dtype, device=self._device)

    def _default_backend(self):
        return GGNBackend

    def _backend_extra(self) -> dict:
        """Backend options of a flavour (``last_layer``,
        ``subnetwork_indices``)."""
        return {}

    @property
    def params(self):
        return self.backend.params

    # -- priors ------------------------------------------------------------
    @property
    def prior_precision(self) -> torch.Tensor:
        return self._prior_precision

    @prior_precision.setter
    def prior_precision(self, prior_precision) -> None:
        self._posterior_scale = None
        pp = torch.atleast_1d(self._scalar(prior_precision))
        if pp.dim() > 1:
            raise ValueError("Prior precision needs to be at most "
                             "one-dimensional tensor.")
        if pp.shape[0] not in (1, self.n_layers, self.n_params):
            raise ValueError("Prior precision needs to be a scalar, "
                             "per-layer, or diagonal.")
        self._prior_precision = pp

    @property
    def prior_mean(self) -> torch.Tensor:
        return self._prior_mean

    @prior_mean.setter
    def prior_mean(self, prior_mean) -> None:
        pm = self._scalar(prior_mean)
        if pm.dim() > 1:
            raise ValueError("Invalid shape of prior mean.")
        self._prior_mean = pm

    @property
    def sigma_noise(self) -> torch.Tensor:
        return self._sigma_noise

    @sigma_noise.setter
    def sigma_noise(self, sigma_noise) -> None:
        self._posterior_scale = None
        sn = self._scalar(sigma_noise)
        if sn.dim() == 1:
            if sn.shape[0] > 1:
                raise ValueError("Only homoscedastic output noise supported.")
            sn = sn[0]
        elif sn.dim() > 1:
            raise ValueError("Sigma noise needs to be scalar or "
                             "1-dimensional.")
        self._sigma_noise = sn

    @property
    def _H_factor(self) -> torch.Tensor:
        """1 / sigma^2 / temperature."""
        return 1.0 / (self.sigma_noise ** 2) / self.temperature

    @property
    def prior_precision_diag(self) -> torch.Tensor:
        """Scalar, per-layer or diagonal prior expanded to the diagonal."""
        return self._expand_prior_precision(self.prior_precision)

    def _expand_prior_precision(self, pp: torch.Tensor) -> torch.Tensor:
        pp = torch.atleast_1d(pp)
        if pp.shape[0] == 1:
            return pp[0] * torch.ones(self.n_params, dtype=pp.dtype,
                                      device=pp.device)
        if pp.shape[0] == self.n_params:
            return pp
        if pp.shape[0] == self.n_layers:
            sizes = [int(v.numel()) for _, v in named_leaves(self.backend.w)]
            return torch.repeat_interleave(
                pp, torch.as_tensor(sizes, device=pp.device))
        raise ValueError("Mismatch of prior and model. Diagonal, scalar, "
                         "or per-layer prior.")

    @property
    def log_likelihood(self) -> torch.Tensor:
        factor = -self._H_factor
        if self.likelihood == Likelihood.REGRESSION.value:
            c = (self.n_data * self.n_outputs
                 * torch.log(self.sigma_noise * math.sqrt(2 * math.pi)))
            return factor * self.loss - c
        return factor * self.loss

    # -- interface ---------------------------------------------------------
    def fit(self, train_loader) -> None:
        raise NotImplementedError

    def log_marginal_likelihood(self, prior_precision=None, sigma_noise=None):
        raise NotImplementedError

    def predictive(self, x, pred_type, link_approx, n_samples):
        return self(x, pred_type=pred_type, link_approx=link_approx,
                    n_samples=n_samples)

    # -- prior-precision tuning --------------------------------------------
    @annotate("laplace.tune_prior")
    def optimize_prior_precision(self,
                                 pred_type: str = PredType.GLM.value,
                                 method: str = TuningMethod.MARGLIK.value,
                                 n_steps: int = 100,
                                 lr: float = 1e-1,
                                 init_prior_prec: float = 1.0,
                                 prior_structure: str =
                                 PriorStructure.SCALAR.value,
                                 val_loader=None,
                                 loss: Optional[Callable] = None,
                                 log_prior_prec_min: float = -4.0,
                                 log_prior_prec_max: float = 4.0,
                                 grid_size: int = 100,
                                 link_approx: str = LinkApprox.PROBIT.value,
                                 n_samples: int = 100,
                                 verbose: bool = False,
                                 progress_bar: bool = False) -> None:
        """``method="marglik"``: ``n_steps`` of Adam (``lr``) on the log
        prior precision of ``prior_structure`` (scalar, layerwise or diag)
        against the -log marglik. ``method="gridsearch"``: the prior
        precision of ``logspace(min, max, grid_size)`` whose predictive
        scores best on ``val_loader`` (NLL, or MSE for regression, unless
        ``loss`` is given)."""
        if method == TuningMethod.MARGLIK.value:
            init = torch.atleast_1d(self._scalar(init_prior_prec))
            if init.shape[0] == 1:
                count("host_sync")
                init = fix_prior_prec_structure(
                    float(init[0]), prior_structure, self.n_layers,
                    self.n_params, self._dtype, self._device)
            log_pp = torch.log(init).requires_grad_(True)
            opt = torch.optim.Adam([log_pp], lr=lr)
            count("laplace.tune_prior.steps", n_steps)
            for _ in range(n_steps):
                with torch.enable_grad():
                    with annotate("laplace.log_marglik"):
                        neg = -self._pure_log_marglik(torch.exp(log_pp),
                                                      self.sigma_noise)
                    with annotate("laplace.tune_prior.grad"):
                        (log_pp.grad,) = torch.autograd.grad(neg, log_pp)
                with annotate("laplace.tune_prior.adam"):
                    opt.step()
            self.prior_precision = torch.exp(log_pp.detach())
        elif method == TuningMethod.GRIDSEARCH.value:
            if val_loader is None:
                raise ValueError("gridsearch requires a validation set "
                                 "DataLoader")
            interval = torch.logspace(log_prior_prec_min, log_prior_prec_max,
                                      grid_size, dtype=self._dtype,
                                      device=self._device)
            self.prior_precision = self._gridsearch(
                loss, interval, val_loader, pred_type=pred_type,
                link_approx=link_approx, n_samples=n_samples)
        else:
            raise ValueError("For now only marglik and gridsearch is "
                             "implemented.")
        if verbose:
            print(f"Optimized prior precision is {self.prior_precision}.")

    def _pure_log_marglik(self, prior_precision, sigma_noise):
        raise NotImplementedError

    def _gridsearch(self, loss, interval, val_loader, pred_type, link_approx,
                    n_samples):
        """The grid value with the least validation loss. A prior whose
        posterior cannot be factorised (``torch.linalg.LinAlgError``) or
        whose loss is not finite scores inf; any other error ends the
        search (JAX's scores every exception inf)."""
        if loss is None:
            # _validate predicts with fitting=True, so reward modeling
            # scores as classification
            loss = (mse_loss if self.likelihood == Likelihood.REGRESSION.value
                    else nll_loss)
        results, prior_precs = [], []
        for prior_prec in interval:
            self.prior_precision = prior_prec
            try:
                result = self._validate(val_loader, loss, pred_type,
                                        link_approx, n_samples)
            except torch.linalg.LinAlgError:
                result = math.inf
            if not math.isfinite(result):
                result = math.inf
            results.append(result)
            prior_precs.append(prior_prec)
        return prior_precs[int(np.argmin(results))]

    def _unpack_batch(self, data):
        """(X, y) from a loader batch: a (X, y) tuple, or a mapping that is
        the whole model input with the targets under ``dict_key_y``."""
        if isinstance(data, MutableMapping):
            return data, data[self.dict_key_y]
        X, y = data
        return X, y

    def _validate(self, val_loader, loss, pred_type, link_approx,
                  n_samples) -> float:
        """``loss`` of the predictive (``fitting=True``) over
        ``val_loader``, on numpy arrays."""
        outs, targets = [], []
        for data in val_loader:
            X, y = self._unpack_batch(data)
            pred = self(X, pred_type=pred_type, link_approx=link_approx,
                        n_samples=n_samples, fitting=True)
            if isinstance(pred, tuple):
                pred = pred[0]
            count("host_sync", 1 + isinstance(y, torch.Tensor))
            outs.append(pred.detach().cpu().numpy())
            targets.append(y.detach().cpu().numpy()
                           if isinstance(y, torch.Tensor) else np.asarray(y))
        return float(loss(np.concatenate(outs), np.concatenate(targets)))


class ParametricLaplace(BaseLaplace):
    """Gaussian posterior over a parameter subset."""

    def __init__(self, model, params, likelihood: str, **kwargs):
        super().__init__(model, params, likelihood, **kwargs)
        if not hasattr(self, "H"):
            self._init_H()
        self.mean: torch.Tensor = self.backend.mean_vector()

    def _init_H(self) -> None:
        raise NotImplementedError

    def _check_H_init(self) -> None:
        if getattr(self, "H", None) is None:
            raise AttributeError("Laplace not fitted. Run fit() first.")

    def _curv_closure(self, X, y, N: int, batch_idx: int = 0):
        raise NotImplementedError

    @annotate("laplace.fit")
    def fit(self, train_loader, override: bool = True) -> None:
        if override:
            self._init_H()
            self.loss = self._scalar(0.0)
            self.n_data = 0

        self.mean = self.backend.mean_vector()
        N = dataset_size(train_loader, dict_key_y=self.dict_key_y)
        for i, data in enumerate(train_loader):
            X, y = self._unpack_batch(data)
            if i == 0:
                with torch.no_grad():
                    out = self.backend.model_fn(self.backend.w, X)
                self.n_outputs = out.shape[-1]
            loss_batch, H_batch = self._curv_closure(X, y, N=N, batch_idx=i)
            self.loss = self.loss + loss_batch
            self.H = H_batch if self.H is None else self.H + H_batch
        self.n_data += N

    # -- marglik terms ------------------------------------------------------
    @property
    def scatter(self) -> torch.Tensor:
        """(theta_MAP - m0)^T P_0 (theta_MAP - m0)."""
        delta = self.mean - self.prior_mean
        return (delta * self.prior_precision_diag) @ delta

    @property
    def log_det_prior_precision(self) -> torch.Tensor:
        return torch.sum(torch.log(self.prior_precision_diag))

    @property
    def log_det_posterior_precision(self) -> torch.Tensor:
        raise NotImplementedError

    @property
    def log_det_ratio(self) -> torch.Tensor:
        return self.log_det_posterior_precision - self.log_det_prior_precision

    def square_norm(self, value: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_prob(self, value: torch.Tensor, normalized: bool = True):
        if not normalized:
            return -self.square_norm(value) / 2
        return (-self.n_params / 2 * math.log(2 * math.pi)
                + self.log_det_posterior_precision / 2
                - self.square_norm(value) / 2)

    @annotate("laplace.log_marglik")
    def log_marginal_likelihood(self, prior_precision=None, sigma_noise=None):
        """loglik - 0.5 * (log_det_ratio + scatter)."""
        if prior_precision is not None:
            self.prior_precision = prior_precision
        if sigma_noise is not None:
            if self.likelihood != Likelihood.REGRESSION.value:
                raise ValueError("Can only change sigma_noise for regression.")
            self.sigma_noise = sigma_noise
        return self.log_likelihood - 0.5 * (self.log_det_ratio + self.scatter)

    def _pure_log_marglik(self, prior_precision, sigma_noise):
        """The log marglik at ``prior_precision`` and ``sigma_noise``,
        differentiable in both, evaluated on a shallow copy so that the
        fitted object is left as it was."""
        la = copy.copy(self)
        la._prior_precision = torch.atleast_1d(prior_precision)
        la._sigma_noise = torch.as_tensor(sigma_noise)
        return la.log_likelihood - 0.5 * (la.log_det_ratio + la.scatter)

    # -- predictive ---------------------------------------------------------
    def functional_variance(self, Js: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def functional_covariance(self, Js: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _glm_predictive_distribution(self, X, joint: bool = False):
        Js, f_mu = self.backend._jacs(X)
        with annotate("laplace.variance"):
            f_var = (self.functional_covariance(Js) if joint
                     else self.functional_variance(Js))
        return f_mu, f_var

    def _unflatten(self, s: torch.Tensor) -> dict:
        """A flat posterior vector as the backend's ``{name: tensor}``."""
        w, cur = {}, 0
        for name, leaf in named_leaves(self.backend.w):
            w[name] = s[cur: cur + leaf.numel()].reshape(leaf.shape)
            cur += leaf.numel()
        return w

    @torch.no_grad()
    @annotate("laplace.samples")
    def _nn_predictive_samples(self, X, n_samples: int = 100,
                               generator: Optional[torch.Generator] = None,
                               likelihood: Optional[str] = None,
                               samples: Optional[torch.Tensor] = None):
        """The model's outputs at ``n_samples`` posterior weight samples
        (passed in as ``samples`` (n, P), or drawn), softmaxed for
        classification: (n, M, C). Runs ``self.model`` (kernels and all)."""
        likelihood = likelihood if likelihood is not None else self.likelihood
        if samples is None:
            samples = self.sample(n_samples, generator=generator)
        fs = torch.stack([
            self.model.apply(merge_split(self._unflatten(s),
                                         self.backend.frozen), X)
            for s in samples])
        if likelihood == Likelihood.CLASSIFICATION.value:
            fs = torch.softmax(fs, dim=-1)
        return fs

    @annotate("laplace.predictive")
    def __call__(self, x, pred_type: str = PredType.GLM.value,
                 joint: bool = False,
                 link_approx: str = LinkApprox.PROBIT.value,
                 n_samples: int = 100,
                 diagonal_output: bool = False,
                 generator: Optional[torch.Generator] = None,
                 fitting: bool = False):
        """Posterior predictive on ``x``. ``fitting`` only matters for
        reward modeling: classification while fitting, regression (reward
        mean and variance) at prediction time."""
        if pred_type not in (PredType.GLM.value, PredType.NN.value):
            raise ValueError("Only glm and nn supported as prediction types.")
        if link_approx not in [la.value for la in LinkApprox]:
            raise ValueError(f"Unsupported link approximation {link_approx}.")
        if pred_type == PredType.NN.value and link_approx != LinkApprox.MC.value:
            raise ValueError("Only mc link approximation is supported for nn "
                             "prediction type.")
        generator = generator if generator is not None else self.generator

        likelihood = self.likelihood
        if likelihood == Likelihood.REWARD_MODELING.value:
            likelihood = (Likelihood.CLASSIFICATION.value if fitting
                          else Likelihood.REGRESSION.value)

        if pred_type == PredType.GLM.value:
            f_mu, f_var = self._glm_predictive_distribution(
                x, joint=joint and likelihood == Likelihood.REGRESSION.value)
            if likelihood == Likelihood.REGRESSION.value:
                if diagonal_output and not joint:
                    f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
                return f_mu, f_var
            return glm_classification_predictive(
                f_mu, f_var, link_approx, n_samples, diagonal_output,
                generator=generator)
        fs = self._nn_predictive_samples(x, n_samples, generator=generator,
                                         likelihood=likelihood)
        if likelihood == Likelihood.REGRESSION.value:
            return torch.mean(fs, dim=0), torch.var(fs, dim=0,
                                                    unbiased=False)
        return torch.mean(fs, dim=0)

    def sample(self, n_samples: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    @annotate("laplace.predictive")
    def predictive_samples(self, x, pred_type: str = PredType.GLM.value,
                           n_samples: int = 100,
                           diagonal_output: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        """(n_samples, B, C) samples of the posterior predictive on ``x``,
        softmaxed for classification: of the linearized predictive
        (``"glm"``), or the model at posterior weight samples (``"nn"``)."""
        if pred_type not in (PredType.GLM.value, PredType.NN.value):
            raise ValueError("Only glm and nn supported as prediction "
                             "types.")
        generator = generator if generator is not None else self.generator
        if pred_type == PredType.GLM.value:
            f_mu, f_var = self._glm_predictive_distribution(x)
            if diagonal_output:
                f_var = torch.diagonal(f_var, dim1=-2, dim2=-1)
            fs = normal_samples(f_mu, f_var, n_samples, generator)
            if self.likelihood == Likelihood.CLASSIFICATION.value:
                fs = torch.softmax(fs, dim=-1)
            return fs
        return self._nn_predictive_samples(x, n_samples, generator=generator)

    # -- serialization ------------------------------------------------------
    def state_dict(self) -> dict:
        """The fitted posterior: detached copies of its tensors (on their
        device), the bookkeeping, and the class name."""
        self._check_H_init()

        def keep(t):
            return t.detach().clone()

        return {
            "mean": keep(self.mean),
            "H": _map_tensors(keep, self._H_for_state()),
            "loss": float(self.loss),
            "prior_mean": keep(self.prior_mean),
            "prior_precision": keep(self.prior_precision),
            "sigma_noise": keep(self.sigma_noise),
            "n_data": self.n_data,
            "n_outputs": self.n_outputs,
            "likelihood": self.likelihood,
            "temperature": self.temperature,
            "cls_name": type(self).__name__,
        }

    def _H_for_state(self):
        return self.H

    def load_state_dict(self, state_dict: dict) -> None:
        if state_dict["cls_name"] != type(self).__name__:
            raise ValueError("Loading a wrong Laplace type. Make sure to use "
                             f"{state_dict['cls_name']}.")
        if state_dict["likelihood"] != self.likelihood:
            raise ValueError("Loading Laplace with a wrong likelihood.")

        def to_here(t):
            return torch.as_tensor(t, dtype=self._dtype, device=self._device)

        self.mean = to_here(state_dict["mean"])
        self._load_H(_map_tensors(to_here, state_dict["H"]))
        self.loss = self._scalar(state_dict["loss"])
        self.prior_mean = state_dict["prior_mean"]
        self.prior_precision = state_dict["prior_precision"]
        self.sigma_noise = state_dict["sigma_noise"]
        self.n_data = state_dict["n_data"]
        self.n_outputs = state_dict["n_outputs"]
        self.temperature = state_dict["temperature"]

    def _load_H(self, H) -> None:
        self.H = H
