"""Plain PyTorch reference of one whole STE-GCN structure-learning run on
the composed route (``fused=False``), whose hypersteps take the
straight-through gradient of the -log marginal likelihood into the
adjacency.

Written from the method's description, not from the program. The model,
the -log marginal likelihood (a Kron Laplace with the type-2 KFAC factors)
and the run's schedule are those of ``stegcn.py``, whose ``Model``,
``neg_log_marglik``, ``ce_mean``, ``weight_names`` and
``initial_adjacency`` this file uses, with ``Aggregation``'s application of
``B`` and ``d``; the forming of ``B`` and ``d`` is its own
(:class:`SteAggregation`):

1. ``a = (adj + adj^T) / 2`` (the configuration's ``symmetric``);
2. ``B = 1[a > threshold]`` in the forward, the cotangent of ``B`` passed
   straight into ``a`` in the backward (the straight-through estimator);
3. the diagonal of ``B`` set to 1, with no gradient there;
4. ``Ahat = D^-1/2 B^T D^-1/2``, ``D`` the row sums of ``B``, applied as
   ``d * (B^T (d * s))`` with ``d = rowsum(B)^-1/2``: differentiable
   through ``B`` and through ``d``.

Each hyperstep's gradient is autograd's d(-log marglik)/d adj through all
of it: the training nodes' loss term, the pullback of the loss-Hessian
square-root columns through ``Ahat^T`` (which the KFAC factors ``B_i =
sum g^T g`` and ``A_i = a^T a / n_train`` are formed from) and the
eigenvalue log-determinants. It is not zero: the hypersteps move the graph
by it, by the weight decay and by the momentum, and an entry that crosses
the threshold changes the graph that the next step aggregates over.

Departures from the source (``gnn/marglik_training.py`` with the
``curvlinops`` type-2 KFAC, which the configuration names):

- the reference computes in float64 (the source in float32), every
  product through ``benchlib.precision.mm`` at the run's modes, as
  ``stegcn.py`` does: its control rounds them one step below the
  configuration's float32 (TF32 operands, float32 sums);
- the eigenvalues are ``torch.linalg.eigvalsh`` on the host, in the
  storage dtype, clamped at zero; the first layer's input factor ``A_0 =
  X^T X / n_train`` is constant in every parameter and decomposed once a
  run (the source forms it at each fit, to the same value);
- dropout draws its uniforms from a ``torch.Generator`` seeded with 0 on
  the run's device, one (N, hidden) draw a hidden layer and train step in
  the configuration's dtype (the source draws from torch's global
  stream); the program draws the same stream;
- no early stop and no best-model tracking: the run's traces and final
  parameters are what is compared.

Besides the traces and the final parameters, a run returns ``closest``:
the least distance of any off-diagonal entry of ``a`` from the threshold
over every value the adjacency takes after a hyperstep (where a float32
program and this reference could binarize an entry differently).

Imports nothing of the program."""

from __future__ import annotations

import math

import torch

from benchlib.precision import mm, storage_dtype
from references.stegcn import (Aggregation, Model, ce_mean,
                               initial_adjacency, neg_log_marglik,
                               weight_names)


class _Straight(torch.autograd.Function):
    """``1[a > threshold]``; the cotangent passes straight into ``a``."""

    @staticmethod
    def forward(ctx, a, threshold):
        return (a > threshold).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def symmetrized(adj: torch.Tensor, symmetric: bool) -> torch.Tensor:
    return (adj + adj.T) / 2 if symmetric else adj


class SteAggregation(Aggregation):
    """``Ahat = D^-1/2 B^T D^-1/2`` of one adjacency parameter with the
    straight-through binarization, applied as ``stegcn.Aggregation``
    applies it (``d * (B^T (d * s))``); differentiable in ``adj`` where
    ``adj`` requires a gradient, through ``B`` and through ``d``."""

    def __init__(self, adj, threshold, symmetric, mode):
        b = _Straight.apply(symmetrized(adj, symmetric), threshold)
        eye = torch.eye(b.shape[0], dtype=torch.bool, device=b.device)
        self.B = torch.where(eye, torch.ones_like(b), b)
        self.d = torch.rsqrt(self.B.sum(dim=1))
        self.mode = mode


def adjacency_gradient(model, W, adj, agg_mode, thr, sym, tr, ytr, prior,
                       static_eigs):
    """d(-log marglik) / d adj by autograd through the STE aggregation."""
    a = adj.detach().requires_grad_(True)
    with torch.enable_grad():
        nm = neg_log_marglik(model, W, SteAggregation(a, thr, sym, agg_mode),
                             tr, ytr, prior, static_eigs)
    (g,) = torch.autograd.grad(nm, a)
    return g.detach()


def closest_to_threshold(adj, thr, sym) -> float:
    """The least |a_ij - threshold| over the off-diagonal entries."""
    gap = (symmetrized(adj, sym) - thr).abs()
    gap.fill_diagonal_(math.inf)
    return float(gap.min())


def whole_run(X, adj_raw, weights0, split, cfg: dict,
              dense_mode: str = "float64", agg_mode: str = "float64",
              device=None):
    """One run from ``weights0`` on ``split`` = (train idx, train labels,
    val idx, val labels). Returns {"loss", "val_loss", "neg_marglik"}
    traces (float64 numpy), the final "params" (weights and "adj") and
    "closest" (the adjacency's closest approach to the threshold after a
    hyperstep; inf in a run without one)."""
    import numpy as np
    dt = storage_dtype(dense_mode)
    dev = device if device is not None else X.device
    L = int(cfg["num_layers"])
    p = float(cfg["dropout"])
    thr, sym = float(cfg["threshold"]), bool(cfg["symmetric"])
    prior = float(cfg["prior_precision"])
    lr, wd = float(cfg["lr"]), float(cfg["weight_decay"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    tr, ytr, va, yva = split
    model = Model(X.to(dev, dt), L, dense_mode)
    adj = initial_adjacency(adj_raw.to(dev, dt), sym)
    W = {k: weights0[k].to(dev, dt).clone() for k in weight_names(L)}
    m_state = {k: torch.zeros_like(v) for k, v in W.items()}
    v_state = {k: torch.zeros_like(v) for k, v in W.items()}
    buf = torch.zeros_like(adj)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = X.shape[0]
    hidden = int(cfg["hidden_channels"])
    draw_dtype = getattr(torch, cfg["dtype"])
    with torch.no_grad():
        A0 = mm(model.X.T, model.X, dense_mode) / tr.shape[0]
        static_eigs = torch.clamp(torch.linalg.eigvalsh(A0.cpu()),
                                  min=0.0).double()
    hyper = {e for e in range(1, cfg["n_epochs"] + 1)
             if e < cfg["n_hyper_stop"] and e % cfg["marglik_frequency"] == 0
             and e >= cfg["n_epochs_burnin"]}
    agg = SteAggregation(adj, thr, sym, agg_mode)
    closest = math.inf
    traces = {"loss": [], "val_loss": [], "neg_marglik": []}
    for epoch in range(1, cfg["n_epochs"] + 1):
        masks = [torch.rand((n, hidden), generator=gen, device=dev,
                            dtype=draw_dtype) < 1.0 - p
                 for _ in range(L - 1)] if p > 0 else None
        Wg = {k: v.clone().requires_grad_(True) for k, v in W.items()}
        f, _, _ = model.forward(Wg, agg, tr, masks, p)
        loss = ce_mean(f, ytr)
        grads = torch.autograd.grad(loss, list(Wg.values()))
        with torch.no_grad():
            for (k, w), g in zip(W.items(), grads):
                g = g + wd * w
                m_state[k].mul_(b1).add_(g, alpha=1 - b1)
                v_state[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = lr / (1 - b1 ** epoch)
                denom = (v_state[k].sqrt() / math.sqrt(1 - b2 ** epoch)
                         ).add_(eps)
                w.sub_(step * m_state[k] / denom)
        traces["loss"].append(float(loss.detach()))
        if epoch in hyper:
            for _ in range(int(cfg["n_hypersteps"])):
                g = adjacency_gradient(model, W, adj, agg_mode, thr, sym, tr,
                                       ytr, prior, static_eigs)
                with torch.no_grad():
                    if cfg["grad_norm"]:
                        gnorm = torch.sqrt(torch.sum(g ** 2))
                        g = g * torch.clamp(
                            1.0 / torch.clamp(gnorm, min=1e-12), max=1.0)
                    d_p = g + float(cfg["weight_decay_adj"]) * adj
                    buf.mul_(float(cfg["momentum_adj"])).add_(d_p)
                    adj.sub_(float(cfg["lr_adj"]) * buf)
                closest = min(closest, closest_to_threshold(adj, thr, sym))
            agg = SteAggregation(adj, thr, sym, agg_mode)
        with torch.no_grad():
            traces["neg_marglik"].append(float(
                neg_log_marglik(model, W, agg, tr, ytr, prior, static_eigs)))
            fv, _, _ = model.forward(W, agg, va)
            traces["val_loss"].append(float(ce_mean(fv, yva)))
    out = {k: np.asarray(v, dtype=np.float64) for k, v in traces.items()}
    out["params"] = {**{k: v.detach() for k, v in W.items()},
                     "adj": adj.detach()}
    out["closest"] = closest
    return out


def binarized(adj: torch.Tensor, threshold: float, symmetric: bool):
    """The 0/1 graph an adjacency parameter aggregates over: ``B`` with
    its diagonal set."""
    b = symmetrized(adj, symmetric) > threshold
    b.fill_diagonal_(True)
    return b
