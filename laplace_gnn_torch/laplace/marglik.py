"""Online marginal-likelihood training (Immer et al. 2021; counterpart of
``laplace_gnn_tpu/laplace/marglik.py``).

The weights take Adam or SGD steps on the prior-regularised loss; every
``marglik_frequency`` epochs after burn-in a fresh ``Laplace(...,
"all", hessian_structure)`` is fitted and the hyperparameters (log prior
precision, log sigma noise) take ``n_hypersteps`` Adam steps on its
negative log marginal likelihood. The weights with the best marglik are
kept, and the Laplace approximation is refitted on them at the end.
``torch.optim.Adam`` and ``torch.optim.SGD`` take the steps of optax's
``adam`` and ``sgd``; ``optimizer_kwargs`` are the torch optimizer's
(``lr`` apart), and a callable ``scheduler`` gives the learning rate of
step t (from 0), as an optax schedule does."""

from __future__ import annotations

import logging
import math
from collections.abc import MutableMapping
from typing import Optional

import torch

from ..curvature.losses import get_loss_fn, likelihood_factor
from ..device import resolve_device
from ..utils.data import dataset_size
from ..utils.pytree import (merge_split, named_leaves, posterior_mask,
                            split_by_mask, tree_vector)
from .dispatch import Laplace
from .enums import Likelihood, PriorStructure

logger = logging.getLogger(__name__)


def marglik_training(model, params: dict, train_loader,
                     likelihood: str = Likelihood.CLASSIFICATION.value,
                     hessian_structure: str = "kron",
                     backend=None,
                     optimizer: str = "adam",
                     optimizer_kwargs: Optional[dict] = None,
                     scheduler=None,
                     n_epochs: int = 300,
                     lr_hyp: float = 1e-1,
                     prior_structure: str = PriorStructure.LAYERWISE.value,
                     n_epochs_burnin: int = 0,
                     n_hypersteps: int = 10,
                     marglik_frequency: int = 1,
                     prior_prec_init: float = 1.0,
                     sigma_noise_init: float = 1.0,
                     temperature: float = 1.0,
                     fix_sigma_noise: bool = False,
                     enable_backprop: bool = False,
                     dict_key_x: str = "input_ids",
                     dict_key_y: str = "labels",
                     seed: int = 0,
                     progress_bar: bool = False,
                     device=None):
    """Returns (la, params, margliks, losses): the Laplace approximation
    refitted on the best-marglik weights, those parameters (a new flat
    dict), the log marglik after each round of hypersteps and the summed
    batch loss of each epoch. ``params`` must live on ``device`` (``cuda``
    unless asked) and is not modified."""
    dev = resolve_device(device)
    for k, v in params.items():
        if v.device.type != dev.type:
            raise ValueError(f"param {k!r} is on {v.device}, not {dev}")
    loss_fn = get_loss_fn(likelihood)
    factor = likelihood_factor(likelihood)
    regression = likelihood == Likelihood.REGRESSION.value
    N = dataset_size(train_loader, dict_key_y=dict_key_y)

    def unpack(data):
        if isinstance(data, MutableMapping):
            return data, data[dict_key_y]
        return data

    w0, frozen = split_by_mask({k: v.detach() for k, v in params.items()},
                               posterior_mask(params))
    sizes = [int(v.numel()) for _, v in named_leaves(w0)]
    n_params = sum(sizes)
    like = next(iter(w0.values()))
    dtype = like.dtype

    hyper_n = {PriorStructure.SCALAR.value: 1,
               PriorStructure.LAYERWISE.value: len(sizes),
               PriorStructure.DIAG.value: n_params}[prior_structure]
    log_prior_prec = torch.full((hyper_n,), math.log(prior_prec_init),
                                dtype=dtype, device=dev, requires_grad=True)
    log_sigma = torch.tensor(math.log(sigma_noise_init), dtype=dtype,
                             device=dev, requires_grad=True)

    w = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    opt_kwargs = dict(optimizer_kwargs or {})
    lr = opt_kwargs.pop("lr", 1e-3)
    opt_cls = {"adam": torch.optim.Adam,
               "sgd": torch.optim.SGD}.get(optimizer.lower())
    if opt_cls is None:
        raise ValueError(f"Optimizer {optimizer} not supported.")
    opt = opt_cls(list(w.values()), lr=lr, **opt_kwargs)
    hyper_opt = torch.optim.Adam([log_prior_prec, log_sigma], lr=lr_hyp)
    size_t = torch.as_tensor(sizes, device=dev)

    def expand_prior(pp_log):
        pp = torch.exp(pp_log)
        if pp.shape[0] == 1:
            return pp[0] * torch.ones(n_params, dtype=dtype, device=dev)
        if pp.shape[0] == n_params:
            return pp
        return torch.repeat_interleave(pp, size_t)

    crit_factor = temperature * (2 * factor)
    n_steps = 0

    def train_step(X, y) -> float:
        nonlocal n_steps
        delta = expand_prior(log_prior_prec.detach())
        sigma2 = torch.exp(2 * log_sigma.detach())
        f = model.apply(merge_split(w, frozen), X)
        base = loss_fn(f, y) / y.shape[0]
        if regression:
            base = loss_fn(f, y) / (2 * sigma2) / y.shape[0]
        theta = tree_vector(w)
        loss = base + 0.5 * ((delta * theta) @ theta) / N / crit_factor
        opt.zero_grad()
        loss.backward()
        if callable(scheduler):
            for group in opt.param_groups:
                group["lr"] = float(scheduler(n_steps))
        opt.step()
        n_steps += 1
        return float(loss.detach())

    def fresh_laplace(weights, prior_prec, sigma):
        return Laplace(model, merge_split(weights, frozen), likelihood,
                       subset_of_weights="all",
                       hessian_structure=hessian_structure,
                       sigma_noise=sigma, prior_precision=prior_prec,
                       dict_key_x=dict_key_x, dict_key_y=dict_key_y,
                       temperature=temperature, backend=backend)

    def snapshot():
        return {k: v.detach().clone() for k, v in w.items()}

    best = {"marglik": math.inf, "w": snapshot(),
            "pp": torch.exp(log_prior_prec.detach()),
            "sigma": torch.exp(log_sigma.detach())}
    margliks, losses = [], []
    one = torch.ones((), dtype=dtype, device=dev)
    for epoch in range(1, n_epochs + 1):
        epoch_loss = 0.0
        for data in train_loader:
            X, y = unpack(data)
            epoch_loss += train_step(X, y)
        losses.append(epoch_loss)

        if epoch < n_epochs_burnin or epoch % marglik_frequency != 0:
            continue

        sigma = torch.exp(log_sigma.detach()) if regression else 1.0
        la = fresh_laplace(snapshot(), torch.exp(log_prior_prec.detach()),
                           sigma)
        la.fit(train_loader)
        hypers = [log_prior_prec, log_sigma]
        for _ in range(n_hypersteps):
            sig = (torch.exp(log_sigma) if regression and not fix_sigma_noise
                   else one)
            neg = -la._pure_log_marglik(torch.exp(log_prior_prec), sig)
            grads = torch.autograd.grad(neg, hypers, allow_unused=True)
            for h, g in zip(hypers, grads):
                h.grad = torch.zeros_like(h) if g is None else g
            hyper_opt.step()
        marglik = -float(neg.detach())
        margliks.append(marglik)

        if -marglik < best["marglik"]:
            best = {"marglik": -marglik, "w": snapshot(),
                    "pp": torch.exp(log_prior_prec.detach()),
                    "sigma": torch.exp(log_sigma.detach())}
            if progress_bar:
                logger.info(f"MARGLIK[epoch={epoch}]: marglik optimization. "
                            f"MargLik={-marglik:.2f}. Saving new best model.")

    sigma = best["sigma"] if regression else 1.0
    la = fresh_laplace(best["w"], best["pp"], sigma)
    la.fit(train_loader)
    return la, merge_split(best["w"], frozen), margliks, losses
