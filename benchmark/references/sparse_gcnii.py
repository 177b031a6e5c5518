"""Plain PyTorch reference of full-batch training of GCNII.

Written from the paper's equations (Chen, Wei, Huang, Ding, Li, "Simple
and Deep Graph Convolutional Networks", ICML 2020, arXiv:2007.02133) and
the defaults of the authors' code (github.com/chennnM/GCNII), not from the
program:

    H_0 = ReLU(X W_in + b_in)
    S_l = (1 - alpha) Ahat H_{l-1} + alpha H_0
    H_l = ReLU((1 - theta_l) S_l + theta_l S_l W_l),   l = 1 .. L,
          theta_l = ln(lamda / l + 1)
    logits = H_L W_out + b_out

with ``Ahat = D^-1/2 (A + I) D^-1/2`` (``sparse_gcn.Aggregation``: every
self-loop added, each edge stored both ways). The weights come under the
program's names in the (out, in) layout of a Linear: ``convs.0.lin.*`` is
``W_in^T`` and ``b_in``, ``convs.<l>.lin.weight`` is ``W_l^T`` (the conv
has no bias) and ``convs.<L + 1>.lin.*`` is ``W_out^T`` and ``b_out``. No
dropout. A step is one Adam step on the mean cross-entropy of the
training nodes with the source's two weight-decay groups, the L2 term
added to the gradient as ``torch.optim.Adam`` adds it: ``wd1`` on the
convs' weights, ``wd2`` on the input and output Linears.

Every product runs at the stated precision: ``float64`` for the
reference; for its control the dense products at ``tf32`` and the
aggregation's operands at ``fp8``, sums in float32 (one step below the
configuration's float32 weights and bfloat16 aggregation). At ogbn-arxiv's
shape in float64 autograd keeps two (N, 256) tensors a layer for the
backward, ~22 GB over 32 layers, which fits the card once the program is
freed. Imports nothing of the program."""

from __future__ import annotations

import importlib.util
import math
import os

import torch

from benchlib.precision import mm, storage_dtype


def _sparse_gcn():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "sparse_gcn.py")
    spec = importlib.util.spec_from_file_location(
        "bench_references_sparse_gcn_for_gcnii", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


Aggregation = _sparse_gcn().Aggregation


def weight_names(n_layers: int) -> list:
    """The input Linear, the ``n_layers`` convs, the output Linear."""
    return (["convs.0.lin.weight", "convs.0.lin.bias"]
            + [f"convs.{l}.lin.weight" for l in range(1, n_layers + 1)]
            + [f"convs.{n_layers + 1}.lin.weight",
               f"convs.{n_layers + 1}.lin.bias"])


def decay_of(name: str, cfg: dict) -> float:
    """``wd1`` for a conv's weight, ``wd2`` for the Linears."""
    L = int(cfg["num_layers"])
    linear = name.startswith(("convs.0.", f"convs.{L + 1}."))
    return float(cfg["wd2"] if linear else cfg["wd1"])


def theta(lamda: float, layer: int) -> float:
    return math.log(lamda / layer + 1)


def forward(W, X, agg, cfg: dict, dense_mode, rows):
    L = int(cfg["num_layers"])
    alpha, lamda = float(cfg["alpha"]), float(cfg["lamda"])
    h0 = torch.relu(mm(X, W["convs.0.lin.weight"].T, dense_mode)
                    + W["convs.0.lin.bias"])
    h = h0
    for l in range(1, L + 1):
        t = theta(lamda, l)
        s = (1 - alpha) * agg(h) + alpha * h0
        h = torch.relu((1 - t) * s
                       + t * mm(s, W[f"convs.{l}.lin.weight"].T, dense_mode))
    out = mm(h, W[f"convs.{L + 1}.lin.weight"].T, dense_mode) \
        + W[f"convs.{L + 1}.lin.bias"]
    return out[rows]


def train_steps(X, edge_index, y, train_idx, weights0, cfg: dict, n_steps,
                dense_mode: str = "float64", agg_mode: str = "float64"):
    """``n_steps`` Adam steps from ``weights0``. Returns the loss of each
    step (before its update), the first step's gradient of the loss (the
    L2 terms not added) and the weights after the last step, all in
    float64 on the host."""
    # float32 products as stated (the control's TF32 is rounded by hand)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = storage_dtype(dense_mode)
    L = int(cfg["num_layers"])
    lr = float(cfg["lr"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    agg = Aggregation(edge_index, X.shape[0], agg_mode)
    Xd = X.to(dt)
    ytr = y[train_idx]
    W = {k: weights0[k].to(dt).clone() for k in weight_names(L)}
    decay = {k: decay_of(k, cfg) for k in W}
    m_state = {k: torch.zeros_like(v) for k, v in W.items()}
    v_state = {k: torch.zeros_like(v) for k, v in W.items()}
    losses, grad1 = [], None
    for step in range(1, n_steps + 1):
        Wg = {k: v.clone().requires_grad_(True) for k, v in W.items()}
        f = forward(Wg, Xd, agg, cfg, dense_mode, train_idx)
        loss = -torch.gather(torch.log_softmax(f, dim=-1), 1,
                             ytr[:, None]).mean()
        grads = torch.autograd.grad(loss, list(Wg.values()))
        del f, Wg
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: g.detach().double().cpu()
                     for k, g in zip(W, grads)}
        with torch.no_grad():
            for (k, w), g in zip(W.items(), grads):
                g = g + decay[k] * w
                m_state[k].mul_(b1).add_(g, alpha=1 - b1)
                v_state[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v_state[k].sqrt() / math.sqrt(1 - b2 ** step)
                         ).add_(eps)
                w.sub_((lr / (1 - b1 ** step)) * m_state[k] / denom)
    return {"losses": losses, "grad1": grad1,
            "params": {k: v.double().cpu() for k, v in W.items()}}
