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

With ``mixed_diag=True`` posterior parameters outside every Linear site
(GAT attention vectors and biases) get exact curvature-diagonal blocks
from forward-mode tangent passes instead of Kron blocks.
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
DIAG_CHUNK = 16          # tangent directions per vmap of the diagonal blocks


def _posterior_sites(model, params, exclude, last_layer,
                     allow_incomplete: bool = False):
    """Tap sites covering the posterior, and the posterior mask. Raises
    when a site marks its layer ``kfac_incomplete`` (posterior parameters
    outside its Linear, e.g. GAT attention vectors) unless
    ``allow_incomplete``: callers then cover those parameters with
    exact-diagonal blocks (``mixed_diag``)."""
    mask = posterior_mask(params, exclude)
    sites = model.tap_sites(params)
    if last_layer:
        ll = tuple(model.last_layer_path(params))
        sites = [s for s in sites if tuple(s["param_path"]) in (ll, ll[:-1])]
    sites = [s for s in sites
             if any(get_subtree(mask, s["param_path"]).values())]
    if not allow_incomplete and any(s.get("kfac_incomplete") for s in sites):
        raise ValueError(
            "KFAC is only defined for models whose posterior parameters all "
            "belong to dense (Linear) layers; found non-Linear posterior "
            "parameters (e.g. GAT attention vectors). Pass mixed_diag=True "
            "for Kron-for-Linear + exact-diag-for-the-rest.")
    return sites, mask


def _mixed_diag_blocks(model, w, frozen, X, out, uncovered, likelihood):
    """Exact type-2 curvature diagonal of the posterior leaves outside
    every tap site, ``{leaf name: (numel,) diagonal}``. For the unit
    direction e_p of such a parameter,

        diag[p] = sum_{m,k} (sum_c R[m, c, k] (J e_p)[m, c])^2,

    R the per-sample loss-Hessian square root. One forward-mode tangent
    pass (``torch.func.jvp``) per direction, ``DIAG_CHUNK`` directions at a
    time under ``torch.func.vmap``: peak memory is ``DIAG_CHUNK`` tangent
    passes, not one per parameter. The model must be jvp-capable
    (``jvp_safe``)."""
    names = [n for n, _ in uncovered]
    sizes = [int(leaf.numel()) for _, leaf in uncovered]
    offs = [0]
    for sz in sizes:
        offs.append(offs[-1] + sz)
    P_u = offs[-1]
    R = loss_hessian_sqrt(likelihood, out)                   # (M, C, C)

    def f_only(w_):
        return model.apply(merge_split(w_, frozen), X)

    def one(e):
        tangent = {k: torch.zeros_like(v) for k, v in w.items()}
        for n, o, sz in zip(names, offs[:-1], sizes):
            tangent[n] = e[o:o + sz].reshape(w[n].shape)
        _, td = torch.func.jvp(f_only, (w,), (tangent,))      # (M, C)
        q = torch.einsum("mck,mc->mk", R, td)
        return torch.sum(q * q)

    eye = torch.eye(P_u, dtype=out.dtype, device=out.device)
    diag = torch.cat([torch.func.vmap(one)(eye[i:i + DIAG_CHUNK])
                      for i in range(0, P_u, DIAG_CHUNK)])
    return {n: diag[o:o + sz] for n, o, sz in zip(names, offs[:-1], sizes)}


def _cov(g: torch.Tensor, kfac_approx: str = "expand") -> torch.Tensor:
    """g^T g over all leading (expanded) dimensions."""
    g2 = g.reshape(-1, g.shape[-1])
    return g2.T @ g2


def _owning_site(leaf_name: str, site_by_prefix, sites, strict: bool = True):
    """The tap site whose Linear holds ``leaf_name``; None when there is
    none and not ``strict``."""
    parts = leaf_name.split(".")
    for k in range(len(parts), 0, -1):
        c = tuple(int(p) if p.isdigit() else p for p in parts[:k])
        if c in site_by_prefix:
            return site_by_prefix[c]
    if not strict:
        return None
    raise ValueError(
        f"Posterior parameter {leaf_name!r} does not belong to any KFAC tap "
        f"site; KFAC requires all posterior parameters to live in dense "
        f"layers (sites: {[s['name'] for s in sites]}).")


def posterior_split(model, params, exclude=DEFAULT_EXCLUDE,
                    last_layer: bool = False, allow_incomplete: bool = True):
    """(posterior params w, frozen params, tap sites)."""
    sites, mask = _posterior_sites(model, params, exclude, last_layer,
                                   allow_incomplete)
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
                         return_output: bool = False,
                         mixed_diag: bool = False,
                         diag_probes: Optional[int] = None,
                         probe_batch: Optional[int] = None):
    """KFAC factors of one batch (X, y), A normalized by ``N`` (the dataset
    size). ``return_output=True`` also returns the forward's model output,
    which callers reuse for the loss.

    ``mixed_diag=True``: posterior parameters outside every Linear tap
    site (GAT attention vectors and biases) get exact curvature-diagonal
    blocks (:func:`_mixed_diag_blocks`) in their slots instead of
    raising."""
    if fisher_type not in FISHER_TYPES:
        raise NotImplementedError(
            f"fisher_type {fisher_type!r} is not ported yet; ported: "
            f"{FISHER_TYPES}")
    if kfac_approx not in KFAC_APPROX:
        raise NotImplementedError(
            f"kfac_approx {kfac_approx!r} is not ported yet")
    if diag_probes is not None or probe_batch is not None:
        raise NotImplementedError(
            "Hutchinson diag_probes/probe_batch are not ported yet; the "
            "mixed-diagonal blocks are exact")

    w, frozen, sites = posterior_split(model, params, exclude, last_layer,
                                       allow_incomplete=mixed_diag)
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
    kfacs, uncovered, slots = [], [], []
    for leaf_name, leaf in named_leaves(w):
        site = _owning_site(leaf_name, site_by_prefix, sites,
                            strict=not mixed_diag)
        if site is None:                     # exact-diagonal block
            uncovered.append((leaf_name, leaf))
            slots.append(len(kfacs))
            kfacs.append(None)
            continue
        name = site["name"]
        kfacs.append([B[name]] if leaf.dim() == 1 else [B[name], A[name]])
    if uncovered:
        diags = _mixed_diag_blocks(
            model, w, frozen, X, out if create_graph else out.detach(),
            uncovered, likelihood)
        for slot, (leaf_name, _) in zip(slots, uncovered):
            kfacs[slot] = [diags[leaf_name]]
    kron = Kron(kfacs)
    if return_output:
        return kron, out
    return kron
