"""KFAC Kronecker factors through tap sites.

Counterpart of ``laplace_gnn_tpu/curvature/kfac.py`` for the type-2 Fisher
with ``kfac_approx="expand"``. One forward runs the model with a
``TapCollector`` that adds a zero perturbation ``eps`` to every dense
layer's pre-activation; differentiating the output w.r.t. ``eps`` with
each column of the loss-Hessian square root as cotangent gives the
per-layer output gradients, so

    A = a^T a / N                 (input covariance)
    B = sum_c g_c^T g_c           (type-2 backward covariance)

When any parameter requires grad, every pullback runs with
``create_graph=True``: the factors stay differentiable w.r.t. anything the
forward depends on, which is what the marglik hyperstep differentiates.
The C pullback columns run one ``torch.autograd.grad`` call each (C = 7 on
Cora), where the JAX package vmaps them into the aggregation's feature
axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..laplace.kron import Kron
from ..nn.module import TapCollector, get_subtree, set_subtree
from ..utils.pytree import (DEFAULT_EXCLUDE, merge_split, named_leaves,
                            posterior_mask, split_by_mask)
from .losses import loss_hessian_sqrt

FISHER_TYPES = ("type-2",)
KFAC_APPROX = ("expand",)


def _posterior_sites(model, params, exclude, last_layer):
    """Tap sites covering the posterior, and the posterior mask."""
    mask = posterior_mask(params, exclude)
    sites = model.tap_sites(params)
    if last_layer:
        ll = tuple(model.last_layer_path(params))
        sites = [s for s in sites if tuple(s["param_path"]) in (ll, ll[:-1])]
    sites = [s for s in sites
             if any(get_subtree(mask, s["param_path"]).values())]
    return sites, mask


def _cov(g: torch.Tensor, kfac_approx: str = "expand") -> torch.Tensor:
    """g^T g over all leading (expanded) dimensions."""
    g2 = g.reshape(-1, g.shape[-1])
    return g2.T @ g2


def _owning_site(leaf_name: str, site_by_prefix, sites):
    parts = leaf_name.split(".")
    for k in range(len(parts), 0, -1):
        c = tuple(int(p) if p.isdigit() else p for p in parts[:k])
        if c in site_by_prefix:
            return site_by_prefix[c]
    raise NotImplementedError(
        f"Posterior parameter {leaf_name!r} belongs to no KFAC tap site "
        f"(sites: {[s['name'] for s in sites]}); mixed-structure KFAC is not "
        f"ported yet.")


def posterior_split(model, params, exclude=DEFAULT_EXCLUDE,
                    last_layer: bool = False):
    """(posterior params w, frozen params, tap sites)."""
    sites, mask = _posterior_sites(model, params, exclude, last_layer)
    if last_layer:
        ll_path = model.last_layer_path(params)
        ll_mask = {k: False for k in mask}
        mask = set_subtree(ll_mask, ll_path, get_subtree(mask, ll_path))
    w, frozen = split_by_mask(params, mask)
    return w, frozen, sites


def compute_kfac_factors(model, params, X, y, likelihood: str,
                         fisher_type: str = "type-2",
                         kfac_approx: str = "expand",
                         exclude=DEFAULT_EXCLUDE, last_layer: bool = False,
                         N: Optional[int] = None,
                         return_output: bool = False):
    """KFAC factors of one batch (X, y), A normalized by ``N`` (the dataset
    size). ``return_output=True`` also returns the forward's model output,
    which callers reuse for the loss."""
    if fisher_type not in FISHER_TYPES:
        raise NotImplementedError(
            f"fisher_type {fisher_type!r} is not ported yet; ported: "
            f"{FISHER_TYPES}")
    if kfac_approx not in KFAC_APPROX:
        raise NotImplementedError(
            f"kfac_approx {kfac_approx!r} is not ported yet")

    w, frozen, sites = posterior_split(model, params, exclude, last_layer)
    site_names = [s["name"] for s in sites]
    if N is None:
        N = y.shape[0]

    taps = TapCollector(perturb=True)
    out = model.apply(merge_split(w, frozen), X, taps=taps)
    acts = {name: a for name, a, _ in taps.records if name in site_names}
    eps = [taps.eps[name] for name in site_names]

    # type-2: the columns of the loss-Hessian square root are the
    # cotangents; B sums the per-site g^T g over them
    S = loss_hessian_sqrt(likelihood, out)                   # (M, C, C)
    # the pullbacks need a graph of their own only when the caller will
    # differentiate the factors (some parameter requires grad)
    create_graph = any(v.requires_grad for v in params.values())
    B: dict = {}
    for c in range(S.shape[-1]):
        gs = torch.autograd.grad(out, eps, grad_outputs=S[:, :, c],
                                 create_graph=create_graph,
                                 retain_graph=True)
        for name, g in zip(site_names, gs):
            cov = _cov(g, kfac_approx)
            B[name] = cov if name not in B else B[name] + cov

    A = {}
    for name in site_names:
        a2 = acts[name].reshape(-1, acts[name].shape[-1])
        A[name] = (a2.T @ a2) / N

    site_by_prefix = {tuple(s["param_path"]): s for s in sites}
    kfacs = []
    for leaf_name, leaf in named_leaves(w):
        name = _owning_site(leaf_name, site_by_prefix, sites)["name"]
        kfacs.append([B[name]] if leaf.dim() == 1 else [B[name], A[name]])
    kron = Kron(kfacs)
    if return_output:
        return kron, out
    return kron
