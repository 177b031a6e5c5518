"""Plain PyTorch reference of full-batch training of a sparse GCN.

Written from the method's description, not from the program: a layer is
``Ahat @ (x W^T + b)`` with ``Ahat = D^-1/2 (A + I) D^-1/2`` over the
undirected graph ``A`` (each edge stored both ways) with every self-loop
added and ``D`` the degrees of ``A + I``; ReLU between layers, no dropout
and no normalization layer. A step is one Adam step (no weight decay) on
the mean cross-entropy of the training nodes over the whole graph.

The aggregation is a sparse CSR product that the reference builds itself
from the edge index; every product runs at the stated precision:
``float64`` for the reference; for its control the dense products at
``tf32`` and the aggregation's operands at ``fp8``, both sums in float32
(one step below the configuration's float32 weights and bfloat16
aggregation). Imports nothing of the program."""

from __future__ import annotations

import math
import warnings

import torch

from benchlib.precision import mm, rounded, storage_dtype


def weight_names(n_layers: int) -> list:
    return [f"convs.{i}.lin.{p}" for i in range(n_layers)
            for p in ("weight", "bias")]


class Aggregation:
    """``Ahat`` as a CSR matrix (it is symmetric, so it is its own
    transpose) at ``value_mode``'s storage, the operand rounded as
    ``value_mode`` reads it."""

    def __init__(self, edge_index, n_nodes: int, value_mode: str):
        dev = edge_index.device
        loops = torch.arange(n_nodes, device=dev)
        src = torch.cat([edge_index[0], loops])
        dst = torch.cat([edge_index[1], loops])
        deg = torch.bincount(dst, minlength=n_nodes).double()
        w = deg[dst].rsqrt() * deg[src].rsqrt()
        self.mode = value_mode
        dt = storage_dtype(value_mode)
        w = rounded(w, value_mode).to(dt)
        order = torch.argsort(dst * n_nodes + src)
        rows = torch.bincount(dst, minlength=n_nodes)
        crow = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                          torch.cumsum(rows, 0)])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # "beta state"
            self.A = torch.sparse_csr_tensor(crow, src[order], w[order],
                                             (n_nodes, n_nodes),
                                             check_invariants=False)

    def __call__(self, x):
        return _Spmm.apply(x, self)


class _Spmm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, agg):
        ctx.agg = agg
        xr = rounded(x, agg.mode).to(agg.A.dtype)
        return (agg.A @ xr).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        agg = ctx.agg
        gr = rounded(g, agg.mode).to(agg.A.dtype)
        return (agg.A @ gr).to(g.dtype), None


def forward(W, X, agg, n_layers, dense_mode, rows):
    x = X
    for i in range(n_layers):
        s = mm(x, W[f"convs.{i}.lin.weight"].T, dense_mode) \
            + W[f"convs.{i}.lin.bias"]
        h = agg(s)
        if i == n_layers - 1:
            return h[rows]
        x = torch.relu(h)
    raise AssertionError("unreachable")


def train_steps(X, edge_index, y, train_idx, weights0, cfg: dict, n_steps,
                dense_mode: str = "float64", agg_mode: str = "float64"):
    """``n_steps`` Adam steps from ``weights0``. Returns the loss of each
    step (before its update), the first step's gradient and the weights
    after the last step, all in float64 on the host."""
    dt = storage_dtype(dense_mode)
    L = int(cfg["num_layers"])
    lr = float(cfg["lr"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    n = X.shape[0]
    agg = Aggregation(edge_index, n, agg_mode)
    Xd = X.to(dt)
    ytr = y[train_idx]
    W = {k: weights0[k].to(dt).clone() for k in weight_names(L)}
    m_state = {k: torch.zeros_like(v) for k, v in W.items()}
    v_state = {k: torch.zeros_like(v) for k, v in W.items()}
    losses, grad1 = [], None
    for step in range(1, n_steps + 1):
        Wg = {k: v.clone().requires_grad_(True) for k, v in W.items()}
        f = forward(Wg, Xd, agg, L, dense_mode, train_idx)
        loss = -torch.gather(torch.log_softmax(f, dim=-1), 1,
                             ytr[:, None]).mean()
        grads = torch.autograd.grad(loss, list(Wg.values()))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: g.detach().double().cpu()
                     for k, g in zip(W, grads)}
        with torch.no_grad():
            for (k, w), g in zip(W.items(), grads):
                m_state[k].mul_(b1).add_(g, alpha=1 - b1)
                v_state[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v_state[k].sqrt() / math.sqrt(1 - b2 ** step)
                         ).add_(eps)
                w.sub_((lr / (1 - b1 ** step)) * m_state[k] / denom)
    return {"losses": losses, "grad1": grad1,
            "params": {k: v.double().cpu() for k, v in W.items()}}


def last_layer_laplace(X, edge_index, y, train_idx, test_idx, weights, cfg,
                       n_samples: int, eps, dense_mode: str = "float64",
                       agg_mode: str = "float64"):
    """A post-hoc last-layer Kron Laplace of the network at ``weights``:

    - the type-2 KFAC factors of the last layer, ``B = sum_k g_k^T g_k``
      over the pullbacks ``g_k = Ahat^T (S_k on the training rows)`` of the
      loss-Hessian square-root columns ``S_k`` (``S = diag(sqrt p) -
      p sqrt(p)^T`` per node) and ``A = phi^T phi / n_train`` over the
      layer's inputs ``phi`` on every node; the bias block is ``B`` alone;
    - the log marginal likelihood ``-loss - (logdet(posterior precision) -
      P log delta + delta |theta|^2) / 2`` with the posterior precision's
      eigenvalues ``l_B (x) l_A + delta`` (and ``l_B + delta`` for the
      bias), eigenvalues clipped at 0;
    - the scalar prior precision ``delta`` tuned by 100 Adam steps
      (learning rate 0.1) on ``log delta`` from 1 against the -log marglik;
    - the MAP softmax on ``test_idx`` and the MC predictive: the mean
      softmax over weight samples ``theta + P^-1/2 eps`` (the symmetric
      inverse square root of the posterior precision, block by block; the
      standard normals ``eps`` (n_samples, P), bias block first, are
      handed in).

    Returns the tuned prior precision, the log marglik there, and both
    predictives, in float64 on the host."""
    dt = storage_dtype(dense_mode)
    L = int(cfg["num_layers"])
    n = X.shape[0]
    agg = Aggregation(edge_index, n, agg_mode)
    W = {k: v.to(dt) for k, v in weights.items()}
    with torch.no_grad():
        x = X.to(dt)
        for i in range(L - 1):
            s = mm(x, W[f"convs.{i}.lin.weight"].T, dense_mode) \
                + W[f"convs.{i}.lin.bias"]
            x = torch.relu(agg(s))
        phi = x
        Wl, bl = W[f"convs.{L - 1}.lin.weight"], W[f"convs.{L - 1}.lin.bias"]
        f_all = agg(mm(phi, Wl.T, dense_mode) + bl)
        f = f_all[train_idx]
        m, C = f.shape
        logp = torch.log_softmax(f, dim=-1)
        p, sp = torch.exp(logp), torch.exp(0.5 * logp)
        S = torch.diag_embed(sp) - p[:, :, None] * sp[:, None, :]   # m,C,K
        full = torch.zeros((n, C * C), dtype=dt, device=X.device)
        full[train_idx] = S.reshape(m, C * C).to(dt)
        G = agg(full).reshape(n, C, C).permute(0, 2, 1).reshape(n * C, C)
        B = mm(G.T, G, dense_mode).double()
        A = (mm(phi.T, phi, dense_mode) / m).double()
        lb, Qb = torch.linalg.eigh(0.5 * (B + B.T))
        la, Qa = torch.linalg.eigh(0.5 * (A + A.T))
        lb, la = torch.clamp(lb, min=0.0), torch.clamp(la, min=0.0)
        loss = -torch.gather(logp, 1, y[train_idx][:, None]).sum().double()
        theta = torch.cat([bl.reshape(-1), Wl.reshape(-1)]).double()
        P = theta.numel()
        grid = torch.outer(lb, la)

    def log_marglik(delta):
        logdet = (torch.log(lb + delta).sum()
                  + torch.log(grid + delta).sum())
        return -loss - 0.5 * (logdet - P * torch.log(delta)
                              + delta * (theta @ theta))

    log_pp = torch.zeros((), dtype=torch.float64, device=X.device,
                         requires_grad=True)
    opt = torch.optim.Adam([log_pp], lr=0.1)
    for _ in range(100):
        (log_pp.grad,) = torch.autograd.grad(-log_marglik(torch.exp(log_pp)),
                                             log_pp)
        opt.step()
    delta = torch.exp(log_pp.detach())
    with torch.no_grad():
        lm = log_marglik(delta)
        probs_map = torch.softmax(f_all[test_idx], dim=-1)
        e = eps.double()
        eb, ew = e[:, :C], e[:, C:].reshape(-1, C, phi.shape[1])
        sb = Qb @ (((lb + delta) ** -0.5)[:, None] * (Qb.T @ eb.T))
        sw = Qb @ ((Qb.T @ ew @ Qa) * (grid + delta) ** -0.5) @ Qa.T
        probs_mc = torch.zeros_like(probs_map, dtype=torch.float64)
        for k in range(e.shape[0]):
            wk = (Wl.double() + sw[k]).to(dt)
            bk = (bl.double() + sb[:, k]).to(dt)
            fk = agg(mm(phi, wk.T, dense_mode) + bk)[test_idx]
            probs_mc += torch.softmax(fk.double(), dim=-1)
        probs_mc /= e.shape[0]
    return {"prior_precision": float(delta), "log_marglik": float(lm),
            "map": probs_map.double().cpu(), "mc": probs_mc.cpu()}
