"""Plain PyTorch reference of full-batch training of a multi-head GAT.

Written from the paper's equations (Velickovic et al., "Graph Attention
Networks", ICLR 2018, arXiv:1710.10903), not from the program. A layer
with H heads of width F maps each node's input ``x_j`` to ``z_j = W x_j``
(one bias-free Linear of H * F outputs, read as H blocks of F) and, for
head k and node i over its in-neighbours N(i) (the graph's edges and a
self-loop on every node),

    e_ij = LeakyReLU_0.2(a_src^k . z_j^k + a_dst^k . z_i^k)
    alpha_ij = softmax over j in N(i) of e_ij
    out_i^k = sum_{j in N(i)} alpha_ij z_j^k.

A hidden layer concatenates its heads and adds its bias and a residual
Linear of its input, then BatchNorm with the batch statistics (biased
variance, eps 1e-5, affine) and ReLU; the output layer averages its heads
(the paper's eq. 6) and adds its bias. A step is one Adam step (no weight
decay) on the mean cross-entropy of the training nodes.

The attention runs over blocks of destination rows of the dst-sorted
edges (``BLOCK_EDGES`` edges at most, whole rows), so its products are
formed a block at a time; autograd keeps each block's gathered rows for
the backward (in float64 ~14 GB a hidden layer at ogbn-arxiv's shape,
which fits the card once the program is freed). Precision: ``float64`` for the
reference; for its control the dense products at ``tf32``
(``precision.mm``) and the aggregation's operands at ``fp8`` (the
gathered ``z`` and ``a_src . z`` scaled per tensor, each block's
coefficients alpha scaled by their largest; scores, softmax and sums in
float32), rounded in the forward with the gradient passed straight
through. Imports nothing of the program."""

from __future__ import annotations

import math

import torch

from benchlib.precision import mm, rounded, storage_dtype

#: the most edges an attention block holds (whole destination rows)
BLOCK_EDGES = 1 << 18


def weight_names(n_layers: int) -> list:
    names = []
    for i in range(n_layers):
        names += [f"convs.{i}.lin.weight", f"convs.{i}.att_src",
                  f"convs.{i}.att_dst", f"convs.{i}.bias"]
    for i in range(n_layers - 1):
        names += [f"res.{i}.weight", f"res.{i}.bias",
                  f"norms.{i}.weight", f"norms.{i}.bias"]
    return names


class Edges:
    """The graph's edges with a self-loop on every node, sorted by
    destination, cut into blocks of whole destination rows."""

    def __init__(self, edge_index, n_nodes: int,
                 block_edges: int = BLOCK_EDGES):
        dev = edge_index.device
        loops = torch.arange(n_nodes, device=dev)
        src = torch.cat([edge_index[0], loops])
        dst = torch.cat([edge_index[1], loops])
        order = torch.argsort(dst * n_nodes + src)
        self.src, self.dst = src[order], dst[order]
        ptr = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         torch.cumsum(torch.bincount(dst, minlength=n_nodes),
                                      0)]).tolist()
        self.blocks = []                     # (r0, r1, e0, e1)
        r0 = 0
        while r0 < n_nodes:
            r1 = r0 + 1
            while r1 < n_nodes and ptr[r1 + 1] - ptr[r0] <= block_edges:
                r1 += 1
            self.blocks.append((r0, r1, ptr[r0], ptr[r1]))
            r0 = r1


def _straight_through(x, mode):
    """``x`` as a product at ``mode`` reads it, with the gradient of
    ``x``."""
    if mode == "float64":
        return x
    return x + (rounded(x, mode) - x).detach()


def attention(z, a_src, a_dst, edges: Edges, agg_mode: str,
              negative_slope: float = 0.2):
    """(N, H, F) ``out_i^k = sum_j alpha_ij z_j^k`` over the blocks, from
    ``z`` (N, H, F) and the per-node scores ``a_src``, ``a_dst`` (N, H)."""
    low = agg_mode != "float64"
    zg = _straight_through(z, agg_mode)
    sg = _straight_through(a_src, agg_mode)
    if low:
        zg, sg, a_dst = zg.float(), sg.float(), a_dst.float()
    out = []
    for r0, r1, e0, e1 in edges.blocks:
        s, d = edges.src[e0:e1], edges.dst[e0:e1] - r0
        e = torch.nn.functional.leaky_relu(sg[s] + a_dst[d + r0],
                                           negative_slope)       # (Eb, H)
        H = e.shape[1]
        # the row maxima are a shift that cancels in the softmax
        m = torch.full((r1 - r0, H), -torch.inf, dtype=e.dtype,
                       device=e.device).scatter_reduce(
            0, d[:, None].expand(-1, H), e.detach(), "amax")
        ex = torch.exp(e - m[d])
        den = torch.zeros_like(m).index_add(0, d, ex)
        alpha = ex / den[d]
        if low:
            alpha = alpha + (rounded(alpha, agg_mode) - alpha).detach()
        out.append(torch.zeros((r1 - r0,) + tuple(z.shape[1:]),
                               dtype=zg.dtype, device=z.device).index_add(
            0, d, alpha[:, :, None] * zg[s]))
    return torch.cat(out).to(z.dtype)


def gat_layer(W, i: int, x, edges, heads: int, last: bool, dense_mode,
              agg_mode, negative_slope):
    n = x.shape[0]
    z = mm(x, W[f"convs.{i}.lin.weight"].T, dense_mode).reshape(n, heads,
                                                                -1)
    a_src = torch.sum(z * W[f"convs.{i}.att_src"], dim=-1)
    a_dst = torch.sum(z * W[f"convs.{i}.att_dst"], dim=-1)
    out = attention(z, a_src, a_dst, edges, agg_mode, negative_slope)
    if last:
        return torch.mean(out, dim=1) + W[f"convs.{i}.bias"]
    h = out.reshape(n, -1) + W[f"convs.{i}.bias"]
    h = h + mm(x, W[f"res.{i}.weight"].T, dense_mode) + W[f"res.{i}.bias"]
    mu = torch.mean(h, dim=0, keepdim=True)
    var = torch.mean((h - mu) ** 2, dim=0, keepdim=True)
    h = (h - mu) / torch.sqrt(var + 1e-5) * W[f"norms.{i}.weight"] \
        + W[f"norms.{i}.bias"]
    return torch.relu(h)


def forward(W, X, edges, cfg: dict, dense_mode, agg_mode, rows):
    L = int(cfg["num_layers"])
    x = X
    for i in range(L):
        x = gat_layer(W, i, x, edges, int(cfg["heads"]), i == L - 1,
                      dense_mode, agg_mode, float(cfg["negative_slope"]))
    return x[rows]


def train_steps(X, edge_index, y, train_idx, weights0, cfg: dict, n_steps,
                dense_mode: str = "float64", agg_mode: str = "float64"):
    """``n_steps`` Adam steps from ``weights0``. Returns the loss of each
    step (before its update), the first step's gradient and the weights
    after the last step, all in float64 on the host."""
    if cfg.get("norm") != "batch" or not cfg.get("res") \
            or cfg.get("output_heads") != "mean":
        raise ValueError("the reference is the published GAT: BatchNorm, "
                         "residual Linears, output heads averaged")
    # float32 products as stated (the control's TF32 is rounded by hand)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = storage_dtype(dense_mode)
    L = int(cfg["num_layers"])
    lr = float(cfg["lr"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    edges = Edges(edge_index, X.shape[0])
    Xd = X.to(dt)
    ytr = y[train_idx]
    W = {k: weights0[k].to(dt).clone() for k in weight_names(L)}
    m_state = {k: torch.zeros_like(v) for k, v in W.items()}
    v_state = {k: torch.zeros_like(v) for k, v in W.items()}
    losses, grad1 = [], None
    for step in range(1, n_steps + 1):
        Wg = {k: v.clone().requires_grad_(True) for k, v in W.items()}
        f = forward(Wg, Xd, edges, cfg, dense_mode, agg_mode, train_idx)
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
                m_state[k].mul_(b1).add_(g, alpha=1 - b1)
                v_state[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v_state[k].sqrt() / math.sqrt(1 - b2 ** step)
                         ).add_(eps)
                w.sub_((lr / (1 - b1 ** step)) * m_state[k] / denom)
    return {"losses": losses, "grad1": grad1,
            "params": {k: v.double().cpu() for k, v in W.items()}}
