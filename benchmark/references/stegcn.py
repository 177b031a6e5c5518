"""Plain PyTorch reference of one whole STE-GCN structure-learning run.

Written from the method's description, not from the program: the model is
a GCN whose layer is ``Ahat @ (x W^T + b)``, with ``Ahat = D^-1/2 B^T
D^-1/2``, ``B`` the adjacency parameter (symmetrized) binarized at the
threshold with every self-loop forced to 1 and ``D`` its row degrees;
ReLU and inverted dropout between layers. A run is ``n_epochs`` epochs of

1. one Adam step (L2 weight decay in the gradient) on the mean
   cross-entropy of the training nodes, in train mode;
2. on the scheduled epochs, ``n_hypersteps`` SGD-with-momentum steps of
   the adjacency parameter (weight decay ``weight_decay_adj``) along the
   gradient of the -log marginal likelihood, rescaled to norm at most 1;
3. the -log marginal likelihood of a Kron Laplace approximation with the
   type-2 KFAC factors (the loss-Hessian square-root columns pulled back
   through the network, ``B = sum g^T g`` per layer, ``A = a^T a /
   n_train``; a bias block is ``B`` alone), eigenvalue log-determinants
   and a scalar prior precision;
4. the validation loss in eval mode.

The hypersteps' gradient is taken by autograd: the -log marginal
likelihood above as a function of the adjacency parameter, through the
aggregation as the fused STE-GCN defines it for that derivative. Its
straight-through rule is a first derivative of the fused operation; the
-log marglik reaches the operation only inside the curvature's pullback,
where its forward is differentiated as plain code, so the adjacency enters
through the binarization at the threshold alone, whose derivative is zero.
The gradient therefore comes out zero, and the hypersteps move the
adjacency by the weight decay and the momentum.

Dropout draws its uniforms from a ``torch.Generator`` seeded with 0 on the
run's device, one (N, hidden) draw in the configuration's dtype per hidden
layer and train step, kept where the uniform is below 1 - p: the method's
stated random stream, which both sides draw.

Imports nothing of the program. Every product goes through
``benchlib.precision.mm``: the aggregations ``D^-1/2 (B^T (D^-1/2 s))``
and their transposes at ``agg_mode``, the dense products at
``dense_mode``; both ``float64`` for the reference, and for its control
one step below the configuration (``fp8`` aggregation operands where the
configuration aggregates bfloat16 operands, ``tf32`` dense products where
it computes float32)."""

from __future__ import annotations

import math

import torch

from benchlib.precision import mm, storage_dtype


def weight_names(n_layers: int) -> list:
    return [f"convs.{i}.lin.{p}" for i in range(n_layers)
            for p in ("weight", "bias")]


def initial_adjacency(adj_raw: torch.Tensor, symmetric: bool):
    """The adjacency parameter at the start: the graph (made symmetric
    when the configuration says so) with every self-loop set."""
    a = adj_raw.clone()
    a.fill_diagonal_(1.0)
    if symmetric:
        a = torch.clamp(a + a.T, max=1.0)
    return a


class Aggregation:
    """``Ahat = D^-1/2 B^T D^-1/2`` of one adjacency parameter, applied
    as ``d * (B^T (d * s))`` with ``d = rowsum(B)^-1/2``."""

    def __init__(self, adj, threshold, symmetric, mode):
        a = (adj + adj.T) / 2 if symmetric else adj
        self.B = (a > threshold).to(adj.dtype)
        self.B.fill_diagonal_(1.0)
        self.d = torch.rsqrt(self.B.sum(dim=1))
        self.mode = mode

    def __call__(self, s, rows=None):
        """``(Ahat @ s)[rows]``."""
        bt = self.B.T if rows is None else self.B.T[rows]
        d_out = self.d if rows is None else self.d[rows]
        return d_out[:, None] * mm(bt, self.d[:, None] * s, self.mode)

    def transposed(self, g, rows=None):
        """``Ahat^T @ g`` for ``g`` given on the rows ``rows`` only."""
        b = self.B if rows is None else self.B[:, rows]
        d_in = self.d if rows is None else self.d[rows]
        return self.d[:, None] * mm(b, d_in[:, None] * g, self.mode)


class Model:
    """The reference network."""

    def __init__(self, X, n_layers, dense_mode):
        self.X = X
        self.L = n_layers
        self.mode = dense_mode

    def forward(self, W, agg, rows, masks=None, p=0.0):
        """Output rows ``rows``; the hidden pre-activations and layer
        inputs; ``masks`` (kept entries) apply inverted dropout."""
        x = self.X
        hs, xs = [], []
        for i in range(self.L):
            xs.append(x)
            s = mm(x, W[f"convs.{i}.lin.weight"].T, self.mode) \
                + W[f"convs.{i}.lin.bias"]
            if i == self.L - 1:
                return agg(s, rows), hs, xs
            h = agg(s)
            hs.append(h)
            x = torch.relu(h)
            if masks is not None:
                x = torch.where(masks[i], x / (1.0 - p), torch.zeros_like(x))
        raise AssertionError("unreachable")


def ce_mean(f, y):
    return -torch.gather(torch.log_softmax(f, dim=-1), 1,
                         y[:, None]).mean()


def neg_log_marglik(model, W, agg, tr, ytr, prior, static_eigs):
    """-log marglik of the Kron Laplace at the current weights, a float64
    0-d tensor on the host, differentiable in whatever takes a gradient."""
    mode = model.mode
    f, hs, xs = model.forward(W, agg, tr)
    m, C = f.shape
    logp = torch.log_softmax(f, dim=-1)
    p, sp = torch.exp(logp), torch.exp(0.5 * logp)
    S = torch.diag_embed(sp) - p[:, :, None] * sp[:, None, :]  # m,C,K
    n = agg.B.shape[0]
    # the pullback of each column k: d(out . S[:, :, k]) / d s_L
    G = agg.transposed(S.reshape(m, C * C), tr).reshape(n, C, C)
    G = G.permute(0, 2, 1)                                    # n,K,C
    grads = [None] * model.L
    grads[-1] = G
    for i in range(model.L - 1, 0, -1):
        Wi = W[f"convs.{i}.lin.weight"]                       # out,in
        d = Wi.shape[1]
        P = mm(grads[i].reshape(n * C, -1), Wi, mode).reshape(n, C, d)
        P = P * (hs[i - 1] > 0).to(P.dtype)[:, None, :]
        grads[i - 1] = agg.transposed(P.reshape(n, C * d)).reshape(
            n, C, d)
    eig_in = []
    for i in range(model.L):
        g2 = grads[i].reshape(n * C, -1)
        eig_in.append(mm(g2.T, g2, mode))                      # B_i
        if i > 0:
            eig_in.append(mm(xs[i].T, xs[i], mode) / m)         # A_i
    eigs = [torch.clamp(torch.linalg.eigvalsh(e.cpu()), min=0.0)
            for e in eig_in]
    logdet = torch.zeros((), dtype=torch.float64)
    k = 0
    for i in range(model.L):
        lb = eigs[k].double()
        k += 1
        la = static_eigs if i == 0 else eigs[k].double()
        if i > 0:
            k += 1
        logdet = (logdet + torch.log(lb + prior).sum()
                  + torch.log(torch.outer(lb, la) + prior).sum())
    loss = -torch.gather(logp, 1, ytr[:, None]).sum().double().cpu()
    theta2 = sum((v.double() ** 2).sum().cpu() for v in W.values())
    P = sum(v.numel() for v in W.values())
    return loss + 0.5 * (logdet - P * math.log(prior) + prior * theta2)


def adjacency_gradient(model, W, adj, agg_mode, thr, sym, tr, ytr, prior,
                       static_eigs):
    """d(-log marglik) / d adj by autograd (zero where no differentiable
    path reaches the adjacency)."""
    a = adj.detach().requires_grad_(True)
    with torch.enable_grad():
        nm = neg_log_marglik(model, W, Aggregation(a, thr, sym, agg_mode),
                             tr, ytr, prior, static_eigs)
    if not nm.requires_grad:
        return torch.zeros_like(adj)
    (g,) = torch.autograd.grad(nm, a, allow_unused=True)
    return torch.zeros_like(adj) if g is None else g.detach()


def whole_run(X, adj_raw, weights0, split, cfg: dict,
              dense_mode: str = "float64", agg_mode: str = "float64",
              device=None):
    """One run from ``weights0`` on ``split`` = (train idx, train labels,
    val idx, val labels). Returns {"loss", "val_loss", "neg_marglik"}
    traces (float64 numpy) and the final "params" (weights and "adj")."""
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
    agg = Aggregation(adj, thr, sym, agg_mode)
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
            agg = Aggregation(adj, thr, sym, agg_mode)
        with torch.no_grad():
            traces["neg_marglik"].append(float(
                neg_log_marglik(model, W, agg, tr, ytr, prior, static_eigs)))
            fv, _, _ = model.forward(W, agg, va)
            traces["val_loss"].append(float(ce_mean(fv, yva)))
    out = {k: np.asarray(v, dtype=np.float64) for k, v in traces.items()}
    out["params"] = {**{k: v.detach() for k, v in W.items()},
                     "adj": adj.detach()}
    return out


def kron_evaluation(X, params, y, split, cfg: dict,
                    dense_mode: str = "float64", agg_mode: str = "float64",
                    chunk: int = 250):
    """The post-hoc evaluation of one trained model (``params``: weights
    and adjacency parameter): a Kron Laplace over every weight with the
    type-2 KFAC factors of ``neg_log_marglik`` and the scalar prior
    precision of the configuration, its log marginal likelihood, the
    learned graph's homophily (the share of its edges, self-loops left
    out, between nodes of one label), the MAP cross-entropy and accuracy
    on the validation and test nodes, the MAP softmax on the test nodes and
    the probit predictive there: ``softmax(f / sqrt(1 + pi/8 v))`` with
    ``v`` the diagonal of ``J Sigma J^T``, the Jacobians of the test
    outputs with respect to every weight and ``Sigma`` the Kron
    posterior's covariance, block by block. Returns float64 host values."""
    import numpy as np
    tr, ytr, va, yva, te, yte = split
    dt = storage_dtype(dense_mode)
    dev = X.device
    L = int(cfg["num_layers"])
    if L != 2:
        raise ValueError("the evaluation's Jacobians are written for two "
                         "layers")
    thr, sym = float(cfg["threshold"]), bool(cfg["symmetric"])
    prior = float(cfg["prior_precision"])
    model = Model(X.to(dev, dt), L, dense_mode)
    W = {k: params[k].to(dev, dt) for k in weight_names(L)}
    adj = params["adj"].to(dev, dt)
    agg = Aggregation(adj, thr, sym, agg_mode)
    out = {}
    b = agg.B.clone()
    b.fill_diagonal_(0.0)
    rows, cols = torch.nonzero(b, as_tuple=True)
    out["homophily"] = float((y[rows] == y[cols]).double().mean())
    with torch.no_grad():
        for name, rows_, yy in (("val", va, yva), ("test", te, yte)):
            f, _, _ = model.forward(W, agg, rows_)
            out[f"{name}_loss"] = float(ce_mean(f, yy).double())
            out[f"{name}_acc"] = float(
                (torch.argmax(f, dim=1) == yy).double().mean()) * 100
        n_train = tr.shape[0]
        A0 = mm(model.X.T, model.X, dense_mode) / n_train
        static = torch.clamp(torch.linalg.eigvalsh(A0.cpu()), min=0.0)
        out["log_marglik"] = -float(neg_log_marglik(
            model, W, agg, tr, ytr, prior, static.double()))
        # the posterior's factors, decomposed
        f, hs, xs = model.forward(W, agg, tr)
        m, C = f.shape
        n = X.shape[0]
        logp = torch.log_softmax(f, dim=-1)
        p, sp = torch.exp(logp), torch.exp(0.5 * logp)
        S = torch.diag_embed(sp) - p[:, :, None] * sp[:, None, :]
        G1 = agg.transposed(S.reshape(m, C * C), tr).reshape(n, C, C)
        G1 = G1.permute(0, 2, 1).reshape(n * C, C)
        W1 = W["convs.1.lin.weight"]
        H = W1.shape[1]
        P0 = mm(G1, W1, dense_mode).reshape(n, C, H)
        P0 = P0 * (hs[0] > 0).to(P0.dtype)[:, None, :]
        G0 = agg.transposed(P0.reshape(n, C * H)).reshape(n * C, H)
        facs = {"B1": mm(G1.T, G1, dense_mode),
                "A1": mm(xs[1].T, xs[1], dense_mode) / m,
                "B0": mm(G0.T, G0, dense_mode), "A0": A0}
        eig = {}
        for k, v in facs.items():
            lam, Q = torch.linalg.eigh(0.5 * (v + v.T).double())
            eig[k] = (torch.clamp(lam, min=0.0), Q)
        # the probit predictive on the test nodes
        f_te, _, _ = model.forward(W, agg, te)
        f_te = f_te.double()
        lB1, QB1 = eig["B1"]
        lA1, QA1 = eig["A1"]
        lB0, QB0 = eig["B0"]
        lA0, QA0 = eig["A0"]
        wB1 = QB1 ** 2                                      # (c, p)
        z = agg(xs[1], te).double()                         # (M, H)
        r = agg(torch.ones((n, 1), dtype=dt, device=dev), te).double()
        M1 = 1.0 / (torch.outer(lB1, lA1) + prior)
        var = ((z @ QA1) ** 2 @ M1.T @ wB1.T
               + r ** 2 * (wB1 @ (1.0 / (lB1 + prior)))[None, :])
        M0 = 1.0 / (torch.outer(lB0, lA0) + prior)
        XQ = mm(model.X, QA0.to(dt), dense_mode)            # (n, F)
        mask = (hs[0] > 0).to(dt)                           # (n, H)
        eye = torch.eye(n, dtype=dt, device=dev)
        var0 = []
        for i0 in range(0, te.shape[0], chunk):
            rows_ = te[i0:i0 + chunk]
            k = rows_.shape[0]
            a = agg(eye, rows_)                 # Ahat's rows, (k, n)
            T = (a[:, None, :, None] * W1[None, :, None, :]
                 * mask[None, None])                        # (k, C, n, H)
            T = T.permute(2, 0, 1, 3).reshape(n, k * C * H)
            g0 = agg.transposed(T).reshape(n, k * C, H)     # (n, kC, H)
            G = mm(g0.reshape(n * k * C, H), QB0.to(dt),
                   dense_mode).reshape(n, k * C, H)
            K = mm(G.permute(1, 2, 0).reshape(k * C * H, n), XQ,
                   dense_mode).reshape(k * C, H, -1).double()
            vw = torch.einsum("phf,hf->p", K ** 2, M0)
            jb = G.sum(dim=0).double()                      # (kC, H)
            vb = (jb ** 2) @ (1.0 / (lB0 + prior))
            var0.append((vw + vb).reshape(k, C))
        var = var + torch.cat(var0)
        kappa = 1.0 / torch.sqrt(1.0 + math.pi / 8 * var)
        out["map"] = torch.softmax(f_te, dim=-1).cpu()
        out["probit"] = torch.softmax(kappa * f_te, dim=-1).cpu()
    return {k: (v if isinstance(v, torch.Tensor) else np.float64(v))
            for k, v in out.items()}
