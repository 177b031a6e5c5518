"""Graph-structure-learning marglik training (the flagship workload).

Counterpart of ``laplace_gnn_tpu/training/marglik_gnn.py``: Adam on the
weights (everything but ``adj``), SGD(+momentum) on the adjacency, burn-in,
then every ``marglik_frequency`` epochs ``n_hypersteps`` updates of the
adjacency on the negative log marginal likelihood of a freshly fit KFAC
Laplace approximation, with marglik- and valloss-based early stopping.

One hyperstep is :func:`make_neg_marglik_fn`'s function and its gradient
w.r.t. ``params["adj"]``: KFAC factors (curvature/kfac.py), eigenvalue
log-determinants, marglik, then ``torch.autograd.grad``.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..curvature.interface import GGNBackend
from ..curvature.kfac import _owning_site, _posterior_sites
from ..curvature.losses import cross_entropy_sum, likelihood_factor
from ..device import resolve_device
from ..graph.data import adj_to_edge_index
from ..graph.homophily import avg_local_homophilies, global_homophily
from ..ops.linalg import batched_eigvalsh, clip_min0
from ..utils.pytree import named_leaves

PATIENCE = 20

NO_ADJ_UPDATE_MODELS = ("gcn", "gat", "graphsage")


def make_neg_marglik_fn(model, likelihood: str, hessian_structure: str,
                        subset_of_weights: str, N: int,
                        prior_precision: float = 1.0,
                        temperature: float = 1.0,
                        sigma_noise: float = 1.0,
                        cache_static_factors: bool = True,
                        fisher_type: str = "type-2"):
    """-log marglik of a freshly fit KFAC Laplace approximation as a
    function of the full params dict; gradients flow into ``params["adj"]``
    through the KFAC factors.

    ``cache_static_factors``: the first GCNConv's KFAC input covariance
    A0 = X^T X / N is constant in every parameter, so its eigenvalues
    (an F x F eigendecomposition, F = 1433 on Cora) are computed once here
    and only they enter the per-hyperstep log-determinant."""
    if hessian_structure != "kron":
        raise NotImplementedError(
            f"hessian_structure {hessian_structure!r} is not ported yet")
    # the curvature runs forward-mode tangent passes (mixed-diagonal blocks
    # of GAT's attention parameters), which the flash kernels' Function
    # cannot take: use the clone with the plain attention (same math)
    model = model.jvp_safe() if hasattr(model, "jvp_safe") else model
    H_factor = 1.0 / (sigma_noise ** 2) / temperature

    static_A_eigvals: dict = {}
    if (cache_static_factors and getattr(model, "first_tap_static", False)
            and subset_of_weights == "all"):
        X = model.X
        lam = torch.linalg.eigvalsh((X.T @ X) / N)
        site0 = model.tap_sites(None)[0]["name"]
        # the backend returns `kron * factor`, which scales a len-2 group's
        # A by sqrt(factor); bake that in so the cache is exact
        static_A_eigvals[site0] = clip_min0(lam) * math.sqrt(
            likelihood_factor(likelihood))

    shared_b = likelihood_factor(likelihood) == 1.0

    def _kron_logdet(kron, group_sites, prior_prec):
        """log det(H_factor * (B (x) A) + delta I), block by block; all
        factor eigendecompositions run in one batched call per size, and a
        layer's B shared by its weight and bias blocks is decomposed once."""
        sqrt_f = math.sqrt(H_factor)
        tasks, task_idx = [], {}

        def key(site_name, role, glen):
            return (site_name, role) if shared_b else (site_name, role, glen)

        def add(site_name, role, f, glen):
            k = key(site_name, role, glen)
            if k not in task_idx:
                task_idx[k] = len(tasks)
                tasks.append(f)

        for group, site_name in zip(kron.kfacs, group_sites):
            if site_name is None:          # exact-diagonal block
                continue
            if len(group) == 1:
                add(site_name, "B", group[0], 1)
            else:
                add(site_name, "B", group[0], 2)
                if site_name not in static_A_eigvals:
                    add(site_name, "A", group[1], 2)
        eigs = batched_eigvalsh(tasks)

        def lam_of(site_name, role, glen):
            return clip_min0(eigs[task_idx[key(site_name, role, glen)]])

        out = 0.0
        for group, site_name in zip(kron.kfacs, group_sites):
            if len(group) == 1:
                # an exact-diagonal block is its own eigenvalues
                lb = (clip_min0(group[0]) if site_name is None
                      else lam_of(site_name, "B", 1))
                out = out + torch.sum(torch.log(H_factor * lb + prior_prec))
            else:
                lb = lam_of(site_name, "B", 2)
                la = (static_A_eigvals[site_name]
                      if site_name in static_A_eigvals
                      else lam_of(site_name, "A", 2))
                out = out + torch.sum(torch.log(
                    torch.outer(sqrt_f * lb, sqrt_f * la) + prior_prec))
        return out

    def _group_sites(backend):
        """Owning tap-site name per Kron block (posterior-leaf order); None
        for an exact-diagonal block (no Linear site)."""
        sites, _ = _posterior_sites(model, backend.params, backend.exclude,
                                    backend.last_layer, allow_incomplete=True)
        by_prefix = {tuple(s["param_path"]): s for s in sites}
        out = []
        for name, _ in named_leaves(backend.w):
            site = _owning_site(name, by_prefix, sites, strict=False)
            out.append(None if site is None else site["name"])
        return out

    def fn(params, X, y):
        backend = GGNBackend(model, params, likelihood,
                             last_layer=(subset_of_weights == "last_layer"))
        loss, H = backend.kron(X, y, N=N, fisher_type=fisher_type)
        loglik = -H_factor * loss
        if likelihood == "regression":
            n_outputs = y.shape[-1] if y.dim() > 1 else 1
            loglik = loglik - N * n_outputs * math.log(
                sigma_noise * math.sqrt(2 * math.pi))
        theta = backend.mean_vector()
        prior_diag = prior_precision * torch.ones_like(theta)
        logdet_prior = torch.sum(torch.log(prior_diag))
        scatter = torch.sum(theta ** 2 * prior_diag)
        logdet_post = _kron_logdet(H, _group_sites(backend), prior_precision)
        marglik = loglik - 0.5 * (logdet_post - logdet_prior + scatter)
        return -marglik

    return fn


def _ce_mean(f, yy):
    return cross_entropy_sum(f, yy) / yy.shape[0]


def _accuracy(f, yy):
    return torch.mean((torch.argmax(f, dim=1) == yy).to(f.dtype))


class TrainingPrograms:
    """The optimizers and step functions of the eager marglik loop, bound
    to one params dict of leaf tensors that they update in place.

    The two optimizers match optax as the JAX package uses it:
    ``add_decayed_weights(wd)`` before ``adam`` is Adam with the L2 term in
    the gradient (``torch.optim.Adam(weight_decay=wd)``), and
    ``sgd(lr, momentum)`` is SGD with ``dampening=0``. Each touches only its
    own parameters: the weights (every name without ``adj``) and
    ``adj``."""

    def __init__(self, model, params: dict, *, lr, weight_decay, lr_adj,
                 weight_decay_adj, momentum_adj, grad_norm,
                 hessian_structure, subset_of_weights, prior_precision, N,
                 fisher_type="type-2"):
        self.model = model
        self.params = params
        self.grad_norm = grad_norm
        self.weight_names = [k for k in params if "adj" not in k]
        self.weight_opt = torch.optim.Adam(
            [params[k] for k in self.weight_names], lr=lr,
            weight_decay=weight_decay)
        self.adj_opt = torch.optim.SGD(
            [params["adj"]], lr=lr_adj,
            momentum=momentum_adj or 0.0, dampening=0.0,
            weight_decay=weight_decay_adj)
        self.neg_marglik_fn = make_neg_marglik_fn(
            model, "classification", hessian_structure, subset_of_weights, N,
            prior_precision, fisher_type=fisher_type)

    def _detached(self) -> dict:
        return {k: v.detach() for k, v in self.params.items()}

    def train_step(self, idx, yy, generator=None):
        """One Adam step on the weights in train mode (dropout on);
        returns (loss, accuracy) as 0-d tensors. The adjacency enters
        detached: this optimizer never updates it, so its N x N gradient
        (which the JAX program computes and zeroes) is not formed."""
        p = {k: v if k in self.weight_names else v.detach()
             for k, v in self.params.items()}
        f = self.model.apply(p, idx, generator=generator, train=True)
        loss = _ce_mean(f, yy)
        weights = [self.params[k] for k in self.weight_names]
        for p, g in zip(weights, torch.autograd.grad(loss, weights)):
            p.grad = g
        self.weight_opt.step()
        return loss.detach(), _accuracy(f.detach(), yy)

    def hyperstep(self, idx, yy):
        """One SGD step on the adjacency along d(-log marglik)/d adj;
        returns the -log marglik before the step."""
        nm = self.neg_marglik_fn(self.params, idx, yy)
        adj = self.params["adj"]
        g = None
        if nm.requires_grad:   # False when no path reaches any parameter
            (g,) = torch.autograd.grad(nm, adj, allow_unused=True)
        if g is None:          # adj unreachable: the fused op's zero grad
            g = torch.zeros_like(adj)
        if self.grad_norm:
            gnorm = torch.sqrt(torch.sum(g ** 2))
            g = g * torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0)
        adj.grad = g
        self.adj_opt.step()
        return nm.detach()

    def neg_marglik_eval(self, idx, yy):
        with torch.enable_grad():
            return self.neg_marglik_fn(self._detached(), idx, yy).detach()

    @torch.no_grad()
    def val_metrics(self, vidx, vy):
        f = self.model.apply(self._detached(), vidx)
        return _ce_mean(f, vy), _accuracy(f, vy)


def _as_index(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


def marglik_optimization(model, params: dict,
                         train_indices, train_labels,
                         val_indices=None, val_labels=None,
                         y=None,
                         stop_criterion: str = "marglik",
                         lr: float = 0.01,
                         lr_adj: float = 0.1,
                         weight_decay: float = 0.5,
                         weight_decay_adj: float = 0.0,
                         momentum_adj: float = 0.0,
                         n_epochs: int = 100,
                         n_hypersteps: int = 20,
                         n_epochs_burnin: int = 40,
                         n_hyper_stop: Optional[int] = None,
                         marglik_frequency: int = 20,
                         subset_of_weights: str = "all",
                         hessian_structure: str = "kron",
                         prior_precision: float = 1.0,
                         grad_norm: bool = False,
                         early_stop: bool = False,
                         model_type: str = "stegcn",
                         fisher_type: str = "type-2",
                         learned_graphs_dir: Optional[str] = None,
                         verbose: bool = True,
                         log_every: int = 20,
                         device=None):
    """Returns (results, params, losses, val_losses, neg_margliks) where
    results is {'marglik': {'params', 'epoch'}, 'valloss': {'params',
    'epoch'}}. ``params`` (a flat dict on ``device``) is copied, not
    modified. Dropout draws from a ``torch.Generator`` seeded with 0."""
    dev = resolve_device(device)
    if stop_criterion == "valloss" and val_indices is None:
        raise ValueError("Validation mask is required for val loss stopping "
                         "criterion")
    if "adj" not in params:
        raise ValueError("Expected 'adj' in model parameters")
    for k, v in params.items():
        if v.device.type != dev.type:
            raise ValueError(f"param {k!r} is on {v.device}, not {dev}")
    if learned_graphs_dir is not None:
        os.makedirs(learned_graphs_dir, exist_ok=True)

    train_indices = _as_index(train_indices, dev)
    train_labels = _as_index(train_labels, dev)
    if val_indices is not None:
        val_indices = _as_index(val_indices, dev)
        val_labels = _as_index(val_labels, dev)
    y_np = np.asarray(y) if y is not None else None

    no_adj_update = model_type in NO_ADJ_UPDATE_MODELS
    n_hyper_stop = n_hyper_stop if n_hyper_stop is not None else n_epochs
    N = int(train_labels.shape[0])

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    progs = TrainingPrograms(
        model, params, lr=lr, weight_decay=weight_decay, lr_adj=lr_adj,
        weight_decay_adj=weight_decay_adj, momentum_adj=momentum_adj,
        grad_norm=grad_norm, hessian_structure=hessian_structure,
        subset_of_weights=subset_of_weights, prior_precision=prior_precision,
        N=N, fisher_type=fisher_type)

    tr_np = train_indices.cpu().numpy()
    eval_indices = (np.setdiff1d(np.arange(len(y_np)), tr_np)
                    if y_np is not None else None)

    def learned_adj():
        return model.full_adj(params).detach().cpu().numpy()

    def print_graph_stats():
        if not verbose or y_np is None:
            return
        _adj = learned_adj()
        gh, trh, evh = avg_local_homophilies(_adj, tr_np, eval_indices, y_np)
        print(f"Homophily global, local train, local eval:"
              f"{gh:.3f}, {trh:.3f}, {evh:.3f}")
        print(f"Num edges: {_adj.sum()} "
              f"(train {_adj[tr_np, :].sum()}, "
              f"eval {_adj[eval_indices, :].sum()})")

    def snapshot():
        return {k: v.detach().clone() for k, v in params.items()}

    print_graph_stats()
    losses, val_losses, neg_margliks = [], [], []
    best_neg_marglik, best_valloss = np.inf, np.inf
    best_marglik_params, best_valloss_params = None, None
    best_marglik_epoch = best_valloss_epoch = 0
    marglik_patience = val_patience = 0
    generator = torch.Generator(device=dev).manual_seed(0)

    for epoch in range(1, n_epochs + 1):
        loss, acc = progs.train_step(train_indices, train_labels, generator)

        if (epoch < n_hyper_stop and not no_adj_update
                and (epoch % marglik_frequency) == 0
                and epoch >= n_epochs_burnin):
            for _ in range(n_hypersteps):
                nm = progs.hyperstep(train_indices, train_labels)
            if learned_graphs_dir is not None:
                _adj = learned_adj()
                h = global_homophily(_adj, y_np) if y_np is not None else None
                with open(os.path.join(learned_graphs_dir,
                                       f"epoch_{epoch}.pkl"), "wb") as f:
                    pickle.dump({"edge_index": adj_to_edge_index(_adj),
                                 "marglik": -float(nm),
                                 "num_edges": float(_adj.sum()),
                                 "homophily": h, "epoch": epoch}, f)
                np.save(os.path.join(learned_graphs_dir, "latest_adj.npy"),
                        _adj)
            print_graph_stats()

        nm = float(progs.neg_marglik_eval(train_indices, train_labels))
        loss_f = float(loss)
        if val_indices is not None:
            vl, va = (float(m) for m in progs.val_metrics(val_indices,
                                                          val_labels))
            val_losses.append(vl)
        else:
            vl = va = np.nan
        losses.append(loss_f)
        neg_margliks.append(nm)

        if ("ste" not in model_type) or epoch > n_epochs_burnin:
            if not early_stop or marglik_patience < PATIENCE:
                if nm < best_neg_marglik:
                    best_neg_marglik = nm
                    best_marglik_params = snapshot()
                    best_marglik_epoch = epoch
                    marglik_patience = 0
                else:
                    marglik_patience += 1
            if val_indices is not None and (not early_stop
                                            or val_patience < PATIENCE):
                if vl < best_valloss:
                    best_valloss = vl
                    best_valloss_params = snapshot()
                    best_valloss_epoch = epoch
                    val_patience = 0
                else:
                    val_patience += 1
            if early_stop and marglik_patience == PATIENCE:
                if verbose:
                    print("Early stopping on marginal likelihood. No more "
                          "graph update.")
                no_adj_update = True
                marglik_patience += 1

        if verbose and epoch % log_every == 0:
            print(f"Epoch {epoch}: Loss={loss_f:.3f}, "
                  f"Perf={float(acc):.3f}, Marglik={-nm:.3}, "
                  f"Val Loss={vl:.3f}, Val Acc={va:.3f}")

    results = {
        "marglik": {"params": best_marglik_params,
                    "epoch": best_marglik_epoch},
        "valloss": {"params": best_valloss_params,
                    "epoch": best_valloss_epoch},
    }
    return results, snapshot(), losses, val_losses, neg_margliks


def mean_eval(model, params: dict, indices, labels):
    """MAP loss and accuracy (percent) on the given nodes."""
    dev = params["adj"].device
    idx = _as_index(indices, dev)
    labels = _as_index(labels, dev)
    with torch.no_grad():
        f = model.apply({k: v.detach() for k, v in params.items()}, idx)
        loss = float(cross_entropy_sum(f, labels) / labels.shape[0])
        acc = float(_accuracy(f, labels)) * 100
    return loss, acc
