"""Subnetwork Laplace and the subnetwork selections (counterpart of
``laplace_gnn_tpu/laplace/subnet.py``).

A subnetwork is a set of indices into the flat posterior vector (JAX's
tree order, ``utils/pytree.py::named_leaves``); the posterior covers those
entries and every other parameter stays at its MAP value. The masks pick
the indices: the top scores (random, magnitude, a diagonal Laplace's or
SWAG's variance), or whole parameters or modules by name, or the last
layer. ``RandomSubnetMask`` draws its scores through
:func:`_uniform_scores`, which a test can replace."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..curvature.interface import EFBackend, GGNBackend
from ..ops import linalg
from ..utils.pytree import named_leaves, tree_vector
from .base import ParametricLaplace
from .flavors import DiagLaplace, FullLaplace


def _uniform_scores(seed: int, n: int, dtype, device) -> torch.Tensor:
    """U(0, 1) scores of ``RandomSubnetMask``, from a CPU generator."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=g, dtype=torch.float64).to(device, dtype)


# -- masks -------------------------------------------------------------------

class SubnetMask:
    """Selects indices of the flat posterior vector; ``select`` once."""

    def __init__(self, model, params: dict):
        self.model = model
        self.params = params
        self._indices = None

    @property
    def indices(self) -> torch.Tensor:
        if self._indices is None:
            raise AttributeError("Subnetwork mask not selected. Run select().")
        return self._indices

    def select(self, train_loader=None) -> torch.Tensor:
        """The sorted indices of the mask's entries."""
        if self._indices is not None:
            raise ValueError("Subnetwork mask already selected.")
        mask = torch.as_tensor(self.get_subnet_mask(train_loader)).bool()
        self._indices = torch.nonzero(mask.reshape(-1))[:, 0]
        return self._indices

    def get_subnet_mask(self, train_loader) -> torch.Tensor:
        raise NotImplementedError

    def _backend(self) -> GGNBackend:
        return GGNBackend(self.model, {k: v.detach() for k, v in
                                       self.params.items()},
                          "classification")

    def _leaf_mask(self, hit) -> torch.Tensor:
        """The flat mask that is ``hit(name)`` over each posterior leaf."""
        backend = self._backend()
        dev = next(iter(backend.w.values())).device
        return torch.cat([torch.full((leaf.numel(),), bool(hit(n)),
                                     device=dev)
                          for n, leaf in named_leaves(backend.w)])


class ScoreBasedSubnetMask(SubnetMask):
    """The ``n_params_subnet`` entries of the largest score."""

    def __init__(self, model, params, n_params_subnet: int):
        super().__init__(model, params)
        if n_params_subnet is None:
            raise ValueError("Need to pass number of subnetwork parameters.")
        self.n_params_subnet = n_params_subnet

    def compute_param_scores(self, train_loader) -> torch.Tensor:
        raise NotImplementedError

    def get_subnet_mask(self, train_loader) -> torch.Tensor:
        theta = tree_vector(self._backend().w)
        if self.n_params_subnet > theta.shape[0]:
            raise ValueError(
                f"Subnetwork ({self.n_params_subnet}) cannot be larger than "
                f"model ({theta.shape[0]}).")
        scores = self.compute_param_scores(train_loader).reshape(-1)
        if scores.shape != theta.shape:
            raise ValueError("Parameter scores need to be of same shape as "
                             "parameter vector.")
        idx = torch.argsort(scores, stable=True)[-self.n_params_subnet:]
        mask = torch.zeros(theta.shape, dtype=torch.bool,
                           device=theta.device)
        mask[idx] = True
        return mask


class RandomSubnetMask(ScoreBasedSubnetMask):
    def __init__(self, model, params, n_params_subnet, seed: int = 0):
        super().__init__(model, params, n_params_subnet)
        self.seed = seed

    def compute_param_scores(self, train_loader):
        theta = tree_vector(self._backend().w)
        return _uniform_scores(self.seed, theta.shape[0], theta.dtype,
                               theta.device)


class LargestMagnitudeSubnetMask(ScoreBasedSubnetMask):
    def compute_param_scores(self, train_loader):
        return torch.abs(tree_vector(self._backend().w))


class LargestVarianceDiagLaplaceSubnetMask(ScoreBasedSubnetMask):
    """Scores: the posterior variance of a diagonal Laplace fit (the one
    passed in, or a fresh ``DiagLaplace``) on ``train_loader``."""

    def __init__(self, model, params, n_params_subnet,
                 diag_laplace_model: Optional[DiagLaplace] = None,
                 likelihood: str = "classification"):
        super().__init__(model, params, n_params_subnet)
        self.diag_laplace_model = diag_laplace_model
        self.likelihood = likelihood

    def compute_param_scores(self, train_loader):
        if train_loader is None:
            raise ValueError("Need to pass train loader for subnet "
                             "selection.")
        la = self.diag_laplace_model or DiagLaplace(
            self.model, self.params, self.likelihood)
        la.fit(train_loader)
        return la.posterior_variance


class LargestVarianceSWAGSubnetMask(ScoreBasedSubnetMask):
    """Scores: the diagonal SWAG variance (``utils/swag.py``)."""

    def __init__(self, model, params, n_params_subnet,
                 likelihood: str = "classification", swag_n_snapshots=40,
                 swag_snapshot_freq=1, swag_lr=0.01):
        super().__init__(model, params, n_params_subnet)
        self.likelihood = likelihood
        self.swag_n_snapshots = swag_n_snapshots
        self.swag_snapshot_freq = swag_snapshot_freq
        self.swag_lr = swag_lr

    def compute_param_scores(self, train_loader):
        if train_loader is None:
            raise ValueError("Need to pass train loader for subnet "
                             "selection.")
        from ..utils.swag import fit_diagonal_swag_var
        return fit_diagonal_swag_var(
            self.model, self.params, train_loader, self.likelihood,
            n_snapshots_total=self.swag_n_snapshots,
            snapshot_freq=self.swag_snapshot_freq, lr=self.swag_lr)


class ParamNameSubnetMask(SubnetMask):
    """Whole parameters by dotted name."""

    def __init__(self, model, params, parameter_names: list[str]):
        super().__init__(model, params)
        self._names = list(parameter_names)

    def get_subnet_mask(self, train_loader):
        missing = set(self._names) - set(self._backend().w)
        if missing:
            raise ValueError(f"Parameters {sorted(missing)} do not exist in "
                             "model.")
        return self._leaf_mask(lambda n: n in self._names)


def _under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


class ModuleNameSubnetMask(ParamNameSubnetMask):
    """Whole modules by name prefix."""

    def get_subnet_mask(self, train_loader):
        names = list(self._backend().w)
        missing = {p for p in self._names
                   if not any(_under(n, p) for n in names)}
        if missing:
            raise ValueError(f"Modules {sorted(missing)} do not exist in "
                             "model.")
        return self._leaf_mask(lambda n: any(_under(n, p)
                                             for p in self._names))


class LastLayerSubnetMask(SubnetMask):
    """Every parameter of the model's last layer."""

    def get_subnet_mask(self, train_loader):
        prefix = ".".join(str(p) for p in
                          self.model.last_layer_path(self.params))
        return self._leaf_mask(lambda n: _under(n, prefix))


# -- flavours ----------------------------------------------------------------

class SubnetLaplace(ParametricLaplace):
    """Posterior over ``subnetwork_indices`` of the flat posterior vector;
    the other parameters stay at their MAP values. GGN and EF backends
    only. The prior is scalar or per index."""

    def __init__(self, model, params, likelihood, subnetwork_indices,
                 backend=None, **kwargs):
        backend = backend or GGNBackend
        if backend not in (GGNBackend, EFBackend):
            raise ValueError("SubnetLaplace can only be used with GGN and "
                             "EF backends.")
        self._subnet_indices_input = subnetwork_indices
        self._subnet_device = next(iter(params.values())).device
        super().__init__(model, params, likelihood, backend=backend, **kwargs)
        self.n_params_subnet = self.n_params

    def _backend_extra(self) -> dict:
        return {"subnetwork_indices": self._validate_indices(
            self._subnet_indices_input)}

    def _validate_indices(self, idx) -> torch.Tensor:
        idx = (idx.detach().cpu() if isinstance(idx, torch.Tensor)
               else torch.as_tensor(np.array(idx)))
        if idx.dim() != 1 or idx.shape[0] == 0:
            raise ValueError("Subnetwork indices must be non-empty "
                             "1-dimensional.")
        if idx.dtype.is_floating_point or idx.dtype.is_complex or \
                idx.dtype == torch.bool:
            raise ValueError("Subnetwork indices must be integer.")
        if len(torch.unique(idx)) != idx.shape[0]:
            raise ValueError("Subnetwork indices must not contain "
                             "duplicates.")
        return idx.to(device=self._subnet_device, dtype=torch.long)

    @property
    def subnetwork_indices(self) -> torch.Tensor:
        return self.backend.subnetwork_indices

    @property
    def prior_precision_diag(self) -> torch.Tensor:
        pp = self.prior_precision
        if pp.shape[0] == 1:
            return pp[0] * torch.ones(self.n_params_subnet, dtype=pp.dtype,
                                      device=pp.device)
        if pp.shape[0] == self.n_params_subnet:
            return pp
        raise ValueError("Mismatch of prior and model. Diagonal or scalar "
                         "prior.")

    def assemble_full_samples(self, subnet_samples: torch.Tensor
                              ) -> torch.Tensor:
        """(n, P_full): the MAP vector with each subnet sample in place."""
        theta = tree_vector(self.backend.w)
        full = theta[None, :].repeat(subnet_samples.shape[0], 1)
        full[:, self.subnetwork_indices] = subnet_samples
        return full

    def _subnet_normals(self, n_samples, generator) -> torch.Tensor:
        generator = generator if generator is not None else self.generator
        return linalg._standard_normals((n_samples, self.n_params_subnet),
                                        generator, self.mean.dtype,
                                        self.mean.device)


class FullSubnetLaplace(SubnetLaplace, FullLaplace):
    _key = ("subnetwork", "full")

    def sample(self, n_samples: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        eps = self._subnet_normals(n_samples, generator)
        return self.assemble_full_samples(
            self.mean[None, :] + eps @ self.posterior_scale)


class DiagSubnetLaplace(SubnetLaplace, DiagLaplace):
    _key = ("subnetwork", "diag")

    def sample(self, n_samples: int = 100,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        eps = self._subnet_normals(n_samples, generator)
        return self.assemble_full_samples(
            self.mean[None, :] + eps * self.posterior_scale[None])
