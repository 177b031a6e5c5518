"""Graph-structure-learning marglik training (the flagship workload).

Counterpart of ``laplace_gnn_tpu/training/marglik_gnn.py``: Adam on the
weights (every name without ``adj``), SGD(+momentum) on the model's
``adj_params`` (JAX's ``ADJ_PARAM_FILTERS``), burn-in,
then every ``marglik_frequency`` epochs ``n_hypersteps`` updates of the
adjacency on the negative log marginal likelihood of a freshly fit KFAC
Laplace approximation, with marglik- and valloss-based early stopping.

One hyperstep is :func:`make_neg_marglik_fn`'s function and its gradient
w.r.t. the adjacency parameters: KFAC factors (curvature/kfac.py), eigenvalue
log-determinants, marglik, then ``torch.autograd.grad``.

:func:`marglik_optimization` is the eager loop, which reads every epoch's
metrics on the host; :func:`marglik_optimization_scan` is the whole run
with its state on the device, replayed from CUDA graphs on a GPU and
cached on the model per configuration.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..curvature.interface import GGNBackend
from ..curvature.kfac import (_owning_site, _posterior_sites,
                              _static_input_cov)
from ..curvature.losses import cross_entropy_sum, likelihood_factor
from ..device import resolve_device
from ..graph.data import adj_to_edge_index
from ..graph.homophily import avg_local_homophilies, global_homophily
from ..laplace.dispatch import Laplace
from ..ops.linalg import (SMALL_N, batched_eigvalsh, clip_min0,
                          raise_on_failed_eigensolve,
                          reset_eigensolve_failures)
from ..profiling import annotate, count
from ..utils.data import ArrayLoader
from ..utils.pytree import DEFAULT_EXCLUDE, named_leaves
from .graphs import Step, capture

PATIENCE = 20

NO_ADJ_UPDATE_MODELS = ("gcn", "gat", "graphsage")


def make_neg_marglik_fn(model, likelihood: str, hessian_structure: str,
                        subset_of_weights: str, N: int,
                        prior_precision: float = 1.0,
                        temperature: float = 1.0,
                        sigma_noise: float = 1.0,
                        cache_static_factors: bool = True,
                        fisher_type: str = "type-2",
                        column_chunk=None,
                        sketch_size: int = 8,
                        mc_samples: int = 1,
                        diag_probes=None,
                        probe_batch=None,
                        fisher_seed: int = 0):
    """-log marglik of a freshly fit Laplace approximation as a function of
    the full params dict; gradients flow into ``params["adj"]`` through the
    curvature. ``hessian_structure``: "kron" (KFAC, with the fisher type and
    the estimator options of :func:`compute_kfac_factors`), "diag" or
    "full" (the GGN of ``GGNBackend.diag`` / ``full``).

    ``cache_static_factors`` (kron): the first GCNConv's KFAC input
    covariance A0 = X^T X / N is constant in every parameter, so its
    eigenvalues (an F x F eigendecomposition, F = 1433 on Cora) are
    computed once here and only they enter the per-hyperstep
    log-determinant; the KFAC pass reuses A0 itself, formed once per model
    (``curvature/kfac.py::_static_input_cov``)."""
    # the curvature runs forward-mode tangent passes (mixed-diagonal blocks
    # of GAT's attention parameters), which the flash kernels' Function
    # cannot take: use the clone with the plain attention (same math)
    model = model.jvp_safe() if hasattr(model, "jvp_safe") else model
    H_factor = 1.0 / (sigma_noise ** 2) / temperature

    static_A_eigvals: dict = {}
    if (cache_static_factors and hessian_structure == "kron"
            and getattr(model, "first_tap_static", False)
            and subset_of_weights == "all"):
        (lam,) = batched_eigvalsh([_static_input_cov(
            model, N, "expand", model.X.dtype)])
        site0 = model.tap_sites(None)[0]["name"]
        # the backend returns `kron * factor`, which scales a len-2 group's
        # A by sqrt(factor); bake that in so the cache is exact
        static_A_eigvals[site0] = clip_min0(lam) * math.sqrt(
            likelihood_factor(likelihood))

    shared_b = likelihood_factor(likelihood) == 1.0
    ggn_span = annotate(f"ggn.{hessian_structure}")

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
        """Spans: ``marglik.backend`` (the backend, the prior terms and the
        Kron blocks' sites), ``kfac`` (or ``ggn.diag`` / ``ggn.full``) and
        ``logdet``."""
        with annotate("marglik.backend"):
            backend = GGNBackend(model, params, likelihood,
                                 last_layer=(subset_of_weights
                                             == "last_layer"))
        if hessian_structure == "kron":
            loss, H = backend.kron(X, y, N=N, fisher_type=fisher_type,
                                   column_chunk=column_chunk,
                                   sketch_size=sketch_size,
                                   mc_samples=mc_samples,
                                   diag_probes=diag_probes,
                                   probe_batch=probe_batch, seed=fisher_seed)
        else:
            closure = {"diag": backend.diag,
                       "full": backend.full}[hessian_structure]
            with ggn_span:
                loss, H = closure(X, y, N=N)
        with annotate("marglik.backend"):
            loglik = -H_factor * loss
            if likelihood == "regression":
                n_outputs = y.shape[-1] if y.dim() > 1 else 1
                loglik = loglik - N * n_outputs * math.log(
                    sigma_noise * math.sqrt(2 * math.pi))
            theta = backend.mean_vector()
            prior_diag = prior_precision * torch.ones_like(theta)
            logdet_prior = torch.sum(torch.log(prior_diag))
            scatter = torch.sum(theta ** 2 * prior_diag)
            sites = (_group_sites(backend) if hessian_structure == "kron"
                     else None)
        with annotate("logdet"):
            if hessian_structure == "kron":
                logdet_post = _kron_logdet(H, sites, prior_precision)
            elif hessian_structure == "diag":
                logdet_post = torch.sum(torch.log(H_factor * H + prior_diag))
            else:
                logdet_post = torch.linalg.slogdet(
                    H_factor * H + torch.diag(prior_diag))[1]
            marglik = loglik - 0.5 * (logdet_post - logdet_prior + scatter)
        return -marglik

    return fn


def _ce_mean(f, yy):
    return cross_entropy_sum(f, yy) / yy.shape[0]


def _accuracy(f, yy):
    return torch.mean((torch.argmax(f, dim=1) == yy).to(f.dtype))


def _param_group(group: dict, weight_decay: float) -> tuple:
    """(tensors, weight decay) of one of torch's param groups."""
    extra = set(group) - {"params", "weight_decay"}
    if extra:
        raise ValueError(f"DeviceAdam's param groups take 'params' and "
                         f"'weight_decay' only, got {sorted(extra)}")
    return list(group["params"]), group.get("weight_decay", weight_decay)


class DeviceAdam:
    """``torch.optim.Adam``'s update (the L2 term added to the gradient, no
    amsgrad), step for step as its single-tensor loop computes it, with the
    step count a float64 tensor on the parameters' device: every part of
    the update is device work, so a CUDA graph can replay it. (torch's
    ``capturable=True`` Adam keeps the count in the default float dtype,
    whose float32 bias corrections part from the non-capturable update by
    ~1e-7, and refuses CPU tensors.)

    ``params`` is an iterable of tensors, or torch's param-group form: a
    list of dicts, each with its ``params`` and, where it differs from
    ``weight_decay``, its own ``weight_decay``. ``self.params`` lists the
    tensors group by group and ``self.decays`` their weight decays."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        params = list(params)
        groups = ([(params, weight_decay)]
                  if not params or not isinstance(params[0], dict)
                  else [_param_group(g, weight_decay) for g in params])
        self.params = [p for ps, _ in groups for p in ps]
        self.decays = [wd for ps, wd in groups for _ in ps]
        self.lr, self.weight_decay, self.betas, self.eps = (
            lr, weight_decay, betas, eps)
        self.step_count = torch.zeros((), dtype=torch.float64,
                                      device=self.params[0].device)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def reset(self) -> None:
        """Back to the state of a new optimizer, in place."""
        self.step_count.zero_()
        for t in self.exp_avg + self.exp_avg_sq:
            t.zero_()

    @torch.no_grad()
    def step(self) -> None:
        beta1, beta2 = self.betas
        self.step_count += 1
        neg_step_size = -(self.lr / (1 - beta1 ** self.step_count))
        bias_correction2_sqrt = (1 - beta2 ** self.step_count) ** 0.5
        for p, m, v, wd in zip(self.params, self.exp_avg, self.exp_avg_sq,
                               self.decays):
            g = p.grad
            if wd != 0:
                g = g.add(p, alpha=wd)
            m.lerp_(g, 1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            denom = (v.sqrt() / bias_correction2_sqrt).add_(self.eps)
            p.add_(neg_step_size * m / denom)


class TrainingPrograms:
    """The optimizers and step functions of both marglik loops, bound to
    one params dict of leaf tensors that they update in place.

    The two optimizers match optax as the JAX package uses it:
    ``add_decayed_weights(wd)`` before ``adam`` is Adam with the L2 term in
    the gradient (:class:`DeviceAdam`, torch's update with its step count
    on the device, so the eager loop and the whole run compute the same
    numbers), and ``sgd(lr, momentum)`` is SGD with ``dampening=0``. Each
    touches only its own parameters: the weights (every name without
    ``adj``; AttSTEGCN's ``adj_W`` is in neither set, so it is never
    trained, as in JAX) and the model's ``adj_params`` (``adj``, or LoRA's
    ``adj_lora_*``)."""

    def __init__(self, model, params: dict, *, lr, weight_decay, lr_adj,
                 weight_decay_adj, momentum_adj, grad_norm,
                 hessian_structure, subset_of_weights, prior_precision, N,
                 fisher_type="type-2", **curvature):
        self.model = model
        self.params = params
        self.grad_norm = grad_norm
        self.weight_names = [k for k in params if "adj" not in k]
        self.weight_opt = DeviceAdam([params[k] for k in self.weight_names],
                                     lr=lr, weight_decay=weight_decay)
        self.adj_names = list(model.adj_params)
        self.adj_opt = torch.optim.SGD(
            [params[k] for k in self.adj_names], lr=lr_adj,
            momentum=momentum_adj or 0.0, dampening=0.0,
            weight_decay=weight_decay_adj)
        self.neg_marglik_fn = make_neg_marglik_fn(
            model, "classification", hessian_structure, subset_of_weights, N,
            prior_precision, fisher_type=fisher_type, **curvature)

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
        """One SGD step on the adjacency parameters along their
        d(-log marglik); returns the -log marglik before the step.
        ``grad_norm`` rescales the gradient of ``adj`` alone, as JAX does
        (so it leaves LoRA's updates as they are). Spans: the -log
        marglik's, ``hypergrad`` (its gradient, rescaled) and
        ``adj_update`` (the SGD step). It ends with the model's
        ``form_adj`` of the new value."""
        nm = self.neg_marglik_fn(self.params, idx, yy)
        leaves = [self.params[k] for k in self.adj_names]
        with annotate("hypergrad"):
            grads = [None] * len(leaves)
            if nm.requires_grad:   # False when no path reaches a parameter
                grads = torch.autograd.grad(nm, leaves, allow_unused=True)
            for name, p, g in zip(self.adj_names, leaves, grads):
                if g is None:      # unreachable: the fused op's zero grad
                    g = torch.zeros_like(p)
                if self.grad_norm and name == "adj":
                    gnorm = torch.sqrt(torch.sum(g ** 2))
                    g = g * torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12),
                                        max=1.0)
                p.grad = g
        with annotate("adj_update"):
            self.adj_opt.step()
        # the new value's aggregation inputs, formed inside the step so
        # that a captured hyperstep's graph carries the one form
        self.model.form_adj(self.params)
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
                         sketch_size: int = 8,
                         column_chunk: Optional[int] = None,
                         mc_samples: int = 1,
                         diag_probes: Optional[int] = None,
                         probe_batch: Optional[int] = None,
                         fisher_seed: int = 0,
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
        N=N, fisher_type=fisher_type, sketch_size=sketch_size,
        column_chunk=column_chunk, mc_samples=mc_samples,
        diag_probes=diag_probes, probe_batch=probe_batch,
        fisher_seed=fisher_seed)

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
    reset_eigensolve_failures(dev)
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
        raise_on_failed_eigensolve(dev)
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


@annotate("eval.mean")
def mean_eval(model, params: dict, indices, labels):
    """MAP loss and accuracy (percent) on the given nodes (the span
    ``eval.mean``)."""
    dev = params["adj"].device
    idx = _as_index(indices, dev)
    labels = _as_index(labels, dev)
    with torch.no_grad():
        f = model.apply({k: v.detach() for k, v in params.items()}, idx)
        count("host_sync", 2)
        loss = float(cross_entropy_sum(f, labels) / labels.shape[0])
        acc = float(_accuracy(f, labels)) * 100
    return loss, acc


def mc_eval(la, indices, labels, pred_type: str = "nn", n_samples: int = 100,
            diagonal_output: bool = False):
    """Bayesian predictive loss and accuracy (percent) on the given nodes,
    with the MC link (``pred_type="nn"``: posterior weight samples through
    ``la.model``)."""
    dev = la.mean.device
    p = la(_as_index(indices, dev), pred_type=pred_type, link_approx="mc",
           n_samples=n_samples, diagonal_output=diagonal_output)
    p = p.detach().cpu().numpy()
    labels = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor)
                        else labels)
    logp = np.log(np.clip(p, 1e-12, None))
    loss = float(-np.mean(logp[np.arange(len(labels)), labels]))
    acc = float(np.mean(np.argmax(p, axis=1) == labels)) * 100
    return loss, acc


def fit_laplace(model, params: dict, train_indices, train_labels,
                subset_of_weights: str = "all",
                hessian_structure: str = "kron", **kwargs):
    """A fresh Laplace fit on the training nodes (one full batch, on the
    device of ``params``). Models with non-Linear posterior parameters (GAT
    attention vectors) get Kron blocks for their Linear sites and exact
    curvature-diagonal blocks for the rest."""
    dev = params["adj"].device
    la = Laplace(model, params, "classification",
                 subset_of_weights=subset_of_weights,
                 hessian_structure=hessian_structure, **kwargs)
    la.fit(ArrayLoader(_as_index(train_indices, dev),
                       _as_index(train_labels, dev), device=dev))
    return la


# ---------------------------------------------------------------------------
# The whole run: state on the device, steps replayed from CUDA graphs, one
# program per model x static configuration
# ---------------------------------------------------------------------------

def _model_program_cache(model) -> dict:
    return model.__dict__.setdefault("_program_cache", {})


def _static_key(*parts):
    """Hashable cache key, or None when a part is a tensor or unhashable
    (an array prior precision): then the caller builds uncached."""
    if any(isinstance(p, torch.Tensor) for p in parts):
        return None
    try:
        hash(parts)
        return parts
    except TypeError:
        return None


def marglik_optimization_scan(model, params: dict,
                              train_indices, train_labels,
                              val_indices, val_labels,
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
                              sketch_size: int = 8,
                              column_chunk: Optional[int] = None,
                              mc_samples: int = 1,
                              diag_probes: Optional[int] = None,
                              probe_batch: Optional[int] = None,
                              fisher_seed: int = 0,
                              learned_graphs_dir: Optional[str] = None,
                              y=None,
                              device=None):
    """:func:`marglik_optimization` as one program: every epoch, hyperstep
    and the best-model tracking of both stop criteria run on the device,
    and nothing is read back to the host until the run ends. Returns
    (results, final_params, losses, val_losses, neg_margliks), the traces
    as numpy arrays; the same numbers as the eager loop on the same inputs
    (dropout draws from one ``torch.Generator`` seeded with 0, one draw a
    train step).

    All of the state lives on ``device`` (default ``cuda``) for the whole
    run: the parameters, both optimizers' states, the traces, the best
    values, epochs and parameters of both criteria (kept by
    ``torch.where`` selects), the patience counters, the no-more-graph-
    updates flag and the snapshot buffers. The hyper schedule is static, so
    the host loop decides it from the epoch number; with
    ``early_stop=True`` it reads the device's no-more-graph-updates flag
    once at each scheduled hyper phase, where the JAX package's
    ``lax.cond`` decides on the device, with the same results.

    On a GPU the program is built on the first call of a configuration:
    the train step, the validation forward with the tracking, and (when
    their curvature makes no host read, :func:`capture_plan`) the -log
    marglik evaluation and the hyperstep are captured as CUDA graphs
    (``training/graphs.py``) and replayed every epoch. A small eigensolve
    that failed (a non-finite factor) raises at the run's end, where the
    run first reads the device. The program is
    cached on the model under the static configuration (the split's
    shapes included): a later call with any split of the same shapes
    copies it into the program's own tensors and replays.

    ``learned_graphs_dir`` keeps each hyper phase's binarized adjacency on
    the device in a preallocated (phases, N, N) bool buffer and writes the
    eager loop's ``epoch_*.pkl`` / ``latest_adj.npy`` files after the run
    (``marglik`` is the epoch's -log marglik trace entry after its
    hypersteps, as the JAX package's whole run writes it); pass ``y`` (all
    labels) for their homophily."""
    dev = resolve_device(device)
    if "adj" not in params:
        raise ValueError("Expected 'adj' in model parameters")
    for k, v in params.items():
        if v.device.type != dev.type:
            raise ValueError(f"param {k!r} is on {v.device}, not {dev}")
    train_indices = _as_index(train_indices, dev)
    train_labels = _as_index(train_labels, dev)
    val_indices = _as_index(val_indices, dev)
    val_labels = _as_index(val_labels, dev)
    N = int(train_labels.shape[0])
    snapshots = learned_graphs_dir is not None

    run = _build_scan_run(
        model, params, dev=dev, n_val=int(val_labels.shape[0]), lr=lr,
        lr_adj=lr_adj, weight_decay=weight_decay,
        weight_decay_adj=weight_decay_adj, momentum_adj=momentum_adj,
        n_epochs=n_epochs, n_hypersteps=n_hypersteps,
        n_epochs_burnin=n_epochs_burnin, n_hyper_stop=n_hyper_stop,
        marglik_frequency=marglik_frequency,
        subset_of_weights=subset_of_weights,
        hessian_structure=hessian_structure,
        prior_precision=prior_precision, grad_norm=grad_norm,
        early_stop=early_stop, model_type=model_type, N=N,
        fisher_type=fisher_type, sketch_size=sketch_size,
        column_chunk=column_chunk, mc_samples=mc_samples,
        diag_probes=diag_probes, probe_batch=probe_batch,
        fisher_seed=fisher_seed, snapshots=snapshots)
    run(params, train_indices, train_labels, val_indices, val_labels)
    # the first host read of the run, which the reads below wait for too
    raise_on_failed_eigensolve(dev)

    final = run.copy_params(run.params)
    count("host_sync", 2 + len(run.traces))  # the reads below
    if snapshots:
        _write_scan_snapshots(model, learned_graphs_dir, run.snaps,
                              run.traces, final, y)
    results = {
        "marglik": {"params": run.copy_params(run.best["nm_params"]),
                    "epoch": int(run.best["nm_epoch"])},
        "valloss": {"params": run.copy_params(run.best["vl_params"]),
                    "epoch": int(run.best["vl_epoch"])},
    }
    # copies: the program's buffers are the next call's
    traces = {k: v.cpu().numpy().copy() for k, v in run.traces.items()}
    return (results, final, traces["loss"], traces["val_loss"],
            traces["neg_marglik"])


def _host_flag(t: torch.Tensor) -> bool:
    count("host_sync")
    return bool(t)


def _write_scan_snapshots(model, learned_graphs_dir, snaps, traces,
                          params_final, y):
    """The host-side dump of the on-device hyper-phase snapshots, with the
    eager loop's file schema (``edge_index``, ``marglik``, ``num_edges``,
    ``homophily``, ``epoch``, and ``latest_adj.npy``), so
    ``graph/plots.py`` reads both."""
    os.makedirs(learned_graphs_dir, exist_ok=True)
    count("host_sync", 6)       # the five reads below and latest_adj's
    n_snaps = int(snaps["count"])
    adjs = snaps["adj"][:n_snaps].cpu().numpy()
    epochs = snaps["epoch"][:n_snaps].cpu().numpy()
    n_edges = snaps["num_edges"][:n_snaps].cpu().numpy()
    nm_trace = traces["neg_marglik"].cpu().numpy()
    y_np = np.asarray(y) if y is not None else None
    for k in range(n_snaps):
        adj = adjs[k].astype(np.float32)
        epoch = int(epochs[k])
        h = global_homophily(adj, y_np) if y_np is not None else None
        with open(os.path.join(learned_graphs_dir,
                               f"epoch_{epoch}.pkl"), "wb") as f:
            pickle.dump({"edge_index": adj_to_edge_index(adj),
                         "marglik": -float(nm_trace[epoch - 1]),
                         "num_edges": float(n_edges[k]),
                         "homophily": h, "epoch": epoch}, f)
    np.save(os.path.join(learned_graphs_dir, "latest_adj.npy"),
            model.full_adj(params_final).detach().cpu().numpy())


def _build_scan_run(model, params, *, dev, n_val, lr, lr_adj, weight_decay,
                    weight_decay_adj, momentum_adj, n_epochs, n_hypersteps,
                    n_epochs_burnin, n_hyper_stop, marglik_frequency,
                    subset_of_weights, hessian_structure, prior_precision,
                    grad_norm, early_stop, model_type, N,
                    fisher_type="type-2", sketch_size=8, column_chunk=None,
                    mc_samples=1, diag_probes=None, probe_batch=None,
                    fisher_seed=0, snapshots=False) -> "ScanRun":
    """The whole-run program of :func:`marglik_optimization_scan`, cached
    on the model per static configuration, with the split data copied in
    at each call. ``PATIENCE``, the parameters' names, shapes and dtypes,
    the validation size and the device are part of the key."""
    n_hyper_stop = n_hyper_stop if n_hyper_stop is not None else n_epochs
    cfg = dict(lr=lr, lr_adj=lr_adj, weight_decay=weight_decay,
               weight_decay_adj=weight_decay_adj, momentum_adj=momentum_adj,
               n_epochs=n_epochs, n_hypersteps=n_hypersteps,
               n_epochs_burnin=n_epochs_burnin, n_hyper_stop=n_hyper_stop,
               marglik_frequency=marglik_frequency,
               subset_of_weights=subset_of_weights,
               hessian_structure=hessian_structure,
               prior_precision=prior_precision, grad_norm=grad_norm,
               early_stop=early_stop, model_type=model_type, N=N,
               fisher_type=fisher_type, sketch_size=sketch_size,
               column_chunk=column_chunk, mc_samples=mc_samples,
               diag_probes=diag_probes, probe_batch=probe_batch,
               fisher_seed=fisher_seed, snapshots=snapshots)
    key = _static_key("scan", *cfg.values(), PATIENCE,
                      tuple((k, tuple(v.shape), str(v.dtype))
                            for k, v in params.items()), n_val, str(dev))
    cache = _model_program_cache(model)
    if key is not None and key in cache:
        return cache[key]
    run = ScanRun(model, params, dev, n_val, **cfg)
    if key is not None:
        cache[key] = run
    return run


def kron_step_sizes(model, params: dict, subset_of_weights: str) -> list:
    """The sizes of the Kron factors that each -log marglik evaluation and
    hyperstep eigendecompose, from the model's tap sites: each site's B
    (its Linear's out width) and A (its in width), but for the first
    site's A when ``make_neg_marglik_fn`` decomposes it once at the build
    (raw features, all weights)."""
    sites, _ = _posterior_sites(model, params, DEFAULT_EXCLUDE,
                                subset_of_weights == "last_layer",
                                allow_incomplete=True)
    static = (model.tap_sites(None)[0]["name"]
              if getattr(model, "first_tap_static", False)
              and subset_of_weights == "all" else None)
    sizes = []
    for site in sites:
        path = ".".join(map(str, site["param_path"]))
        n_out, n_in = params[path + ".weight"].shape
        sizes += [n_out] if site["name"] == static else [n_out, n_in]
    return sizes


def capture_plan(gpu: bool, model, params: dict, *, hessian_structure: str,
                 subset_of_weights: str, fisher_type: str,
                 column_chunk=None, diag_probes=None, **_) -> dict:
    """Which of the whole run's steps replay from a CUDA graph: on a GPU
    the train and tracking steps always, the -log marglik evaluation and
    the hyperstep when their curvature makes no host read. The diagonal
    GGN makes none. The Kron structure makes none with the type-2 Fisher
    (the sketch and MC draw on the CPU), whole pullbacks (column blocks
    are checkpointed, which reads the RNG state), exact diagonal blocks
    (Hutchinson probes draw on the CPU) and every factor of
    :func:`kron_step_sizes` within the capturable eigensolver's
    ``SMALL_N``. ``full`` decomposes with slogdet, which checks on the
    host. On the CPU nothing is captured."""
    curvature = gpu and (hessian_structure == "diag" or (
        hessian_structure == "kron" and fisher_type == "type-2"
        and column_chunk is None and diag_probes is None
        and max(kron_step_sizes(model, params, subset_of_weights),
                default=0) <= SMALL_N))
    return {"train_step": gpu, "hyperstep": curvature,
            "neg_marglik": curvature, "tracking": gpu}


class ScanRun:
    """The program of one whole-run configuration: its state tensors, its
    steps and, on a GPU, their CUDA graphs.

    ``captured`` says which steps replay from a graph (:func:`capture_plan`).
    On a GPU the train step and the tracking step (the validation forward,
    the trace writes and the best-value selects) are captured; the -log
    marglik evaluation and the hyperstep are captured when their curvature
    makes no host read: the diagonal GGN, and the Kron structure with the
    type-2 Fisher whose every per-step factor fits the small eigensolver
    (``ops/linalg.py::SMALL_N``), which keeps its status on the device.
    (The first layer's A over the raw features is decomposed once, at the
    build, by ``torch.linalg.eigvalsh`` at any size.) The Kron fisher
    types that draw on the CPU (sketch, MC), Full's slogdet and any model
    wider than ``SMALL_N`` stay eager. A capture that fails raises. On
    the CPU every step runs as it is."""

    def __init__(self, model, params, dev, n_val, *, n_epochs, n_hypersteps,
                 n_epochs_burnin, n_hyper_stop, marglik_frequency,
                 early_stop, model_type, N, snapshots, hessian_structure,
                 **cfg):
        self.model = model
        self.n_epochs, self.n_hypersteps = n_epochs, n_hypersteps
        self.early_stop = early_stop
        self.no_adj_update = model_type in NO_ADJ_UPDATE_MODELS
        self.hyper_epochs = [] if self.no_adj_update else [
            e for e in range(1, n_epochs + 1)
            if e < n_hyper_stop and e % marglik_frequency == 0
            and e >= n_epochs_burnin]
        self.is_ste = "ste" in model_type
        self.n_epochs_burnin = n_epochs_burnin

        def zeros(*shape, dtype=None):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        dt = self.params["adj"].dtype
        self.tr_idx = zeros(N, dtype=torch.long)
        self.tr_y = zeros(N, dtype=torch.long)
        self.va_idx = zeros(n_val, dtype=torch.long)
        self.va_y = zeros(n_val, dtype=torch.long)
        self.progs = TrainingPrograms(
            model, self.params, hessian_structure=hessian_structure, N=N,
            **cfg)
        # present from the start, so a captured step never makes it; zero
        # is what torch's first step (buf = g) amounts to
        if self.progs.adj_opt.defaults["momentum"]:
            for k in self.progs.adj_names:
                self.progs.adj_opt.state[self.params[k]][
                    "momentum_buffer"] = torch.zeros_like(self.params[k])
        self.generator = torch.Generator(device=dev)
        self.epoch = zeros(dtype=torch.long)
        self.loss = zeros(dtype=dt)
        self.nm = zeros(dtype=dt)
        self.traces = {k: zeros(n_epochs, dtype=dt)
                       for k in ("loss", "val_loss", "neg_marglik")}
        self.best = {
            "nm": zeros(dtype=dt), "nm_epoch": zeros(dtype=torch.long),
            "nm_params": {k: torch.zeros_like(v)
                          for k, v in self.params.items()},
            "vl": zeros(dtype=dt), "vl_epoch": zeros(dtype=torch.long),
            "vl_params": {k: torch.zeros_like(v)
                          for k, v in self.params.items()},
            "m_pat": zeros(dtype=torch.long),
            "v_pat": zeros(dtype=torch.long),
            "no_adj": zeros(dtype=torch.bool)}
        n_snap = len(self.hyper_epochs) if snapshots else 0
        n_nodes = int(self.params["adj"].shape[0])
        self.snaps = {"adj": zeros(n_snap, n_nodes, n_nodes,
                                   dtype=torch.bool),
                      "epoch": zeros(n_snap, dtype=torch.long),
                      "num_edges": zeros(n_snap, dtype=dt),
                      "count": zeros(dtype=torch.long)}

        gpu = dev.type == "cuda"
        self.captured = capture_plan(gpu, model, self.params,
                                     hessian_structure=hessian_structure,
                                     **cfg)
        self.steps = {k: Step(k, getattr(self, f"_{k}"), self.captured[k])
                      for k in self.captured}
        if gpu:
            # the warm-up runs on these parameters at node 0
            self._load(params, self.tr_idx, self.tr_y, self.va_idx,
                       self.va_y)
            capture(self.steps.values(), generators=(self.generator,))

    # --- the steps: each reads and writes only the tensors above ---------
    def _train_step(self):
        self.epoch += 1
        loss, _ = self.progs.train_step(self.tr_idx, self.tr_y,
                                        self.generator)
        self.loss.copy_(loss)

    def _hyperstep(self):
        self.progs.hyperstep(self.tr_idx, self.tr_y)

    def _neg_marglik(self):
        self.nm.copy_(self.progs.neg_marglik_eval(self.tr_idx, self.tr_y))

    @torch.no_grad()
    def _tracking(self):
        vl, _ = self.progs.val_metrics(self.va_idx, self.va_y)
        i = (self.epoch - 1).view(1)
        for name, v in (("loss", self.loss), ("val_loss", vl),
                        ("neg_marglik", self.nm)):
            self.traces[name].index_copy_(0, i, v.view(1))
        b, nm, epoch = self.best, self.nm, self.epoch
        track = (epoch > self.n_epochs_burnin if self.is_ste
                 else torch.ones_like(b["no_adj"]))
        m_active = track & (b["m_pat"] < PATIENCE if self.early_stop
                            else True)
        v_active = track & (b["v_pat"] < PATIENCE if self.early_stop
                            else True)
        upd_m = m_active & (nm < b["nm"])
        upd_v = v_active & (vl < b["vl"])
        if self.early_stop:
            # the eager loop's order: reset or advance each counter, then
            # halt the graph updates when the marglik patience runs out
            b["m_pat"].copy_(torch.where(m_active, torch.where(
                upd_m, 0, b["m_pat"] + 1), b["m_pat"]))
            b["v_pat"].copy_(torch.where(v_active, torch.where(
                upd_v, 0, b["v_pat"] + 1), b["v_pat"]))
            hit = track & (b["m_pat"] == PATIENCE)
            b["no_adj"].logical_or_(hit)
            b["m_pat"].add_(hit.long())
        for upd, tag, value in ((upd_m, "nm", nm), (upd_v, "vl", vl)):
            b[tag].copy_(torch.where(upd, value, b[tag]))
            b[f"{tag}_epoch"].copy_(torch.where(upd, epoch,
                                                b[f"{tag}_epoch"]))
            for k, p in self.params.items():
                b[f"{tag}_params"][k].copy_(
                    torch.where(upd, p, b[f"{tag}_params"][k]))

    @torch.no_grad()
    def _snapshot(self, k: int, epoch: int):
        adj = self.model.full_adj(self.params)
        self.snaps["adj"][k].copy_(adj > 0)
        self.snaps["epoch"][k].fill_(epoch)
        self.snaps["num_edges"][k].copy_(adj.sum())
        self.snaps["count"].fill_(k + 1)

    # --- a run ------------------------------------------------------------
    @torch.no_grad()
    def _load(self, params, tr_idx, tr_y, va_idx, va_y):
        """Copy a call's inputs in, form what the model derives from the
        adjacency (``form_adj``, before any step reads it) and reset every
        piece of state (the eigensolver's failure flag too)."""
        for k, v in self.params.items():
            v.copy_(params[k])
        self.model.form_adj(self.params)
        reset_eigensolve_failures(self.params["adj"].device)
        for dst, src in ((self.tr_idx, tr_idx), (self.tr_y, tr_y),
                         (self.va_idx, va_idx), (self.va_y, va_y)):
            dst.copy_(src)
        self.progs.weight_opt.reset()
        for state in self.progs.adj_opt.state.values():
            if state.get("momentum_buffer") is not None:
                state["momentum_buffer"].zero_()
        self.generator.manual_seed(0)
        self.epoch.zero_()
        for t in self.traces.values():
            t.zero_()
        b = self.best
        for tag in ("nm", "vl"):
            b[tag].fill_(math.inf)
            b[f"{tag}_epoch"].zero_()
            for k, v in self.params.items():
                b[f"{tag}_params"][k].copy_(v)
        for t in (b["m_pat"], b["v_pat"], b["no_adj"], self.snaps["count"]):
            t.zero_()

    def __call__(self, params, tr_idx, tr_y, va_idx, va_y) -> None:
        self._load(params, tr_idx, tr_y, va_idx, va_y)
        steps, hyper = self.steps, set(self.hyper_epochs)
        n_phases = 0
        for epoch in range(1, self.n_epochs + 1):
            steps["train_step"]()
            # the one host read of the run: at a scheduled hyper phase, and
            # only when the early stop can have halted the graph updates
            if epoch in hyper and not (self.early_stop
                                       and _host_flag(self.best["no_adj"])):
                for _ in range(self.n_hypersteps):
                    steps["hyperstep"]()
                if self.snaps["adj"].shape[0]:
                    self._snapshot(n_phases, epoch)
                n_phases += 1
            steps["neg_marglik"]()
            steps["tracking"]()

    @staticmethod
    def copy_params(params: dict) -> dict:
        return {k: v.detach().clone() for k, v in params.items()}
