"""Operations and bytes of a multi-head GAT epoch, from shapes alone.

As ``counts``: each input byte is read once and each output byte written
once, whatever an implementation reads again, and the operations are the
model's. A layer is given as ``(in_features, heads, width, residual)``:
a bias-free Linear to ``heads * width``, the per-node scores
``a_src . z`` and ``a_dst . z``, the edge softmax over each destination's
stored edges (self-loops included) and the aggregation, plus a residual
Linear of the input where ``residual``."""

from __future__ import annotations

from . import counts


def layers(cfg: dict) -> list:
    """The layers of a configuration: hidden layers of ``heads`` heads of
    ``hidden_channels / heads`` with a residual where ``res``, then the
    output layer of ``heads`` heads of ``n_classes`` (averaged)."""
    heads, hidden = int(cfg["heads"]), int(cfg["hidden_channels"])
    widths = [int(cfg["n_features"])] + [hidden] * (
        int(cfg["num_layers"]) - 1)
    res = bool(cfg.get("res", False))
    return ([(i, heads, hidden // heads, res) for i in widths[:-1]]
            + [(widths[-1], heads, int(cfg["n_classes"]), False)])


def attention_bytes(n_edges: int, n_nodes: int, heads: int, width: int,
                    value_bytes: int, index_bytes: int = 8) -> float:
    """One layer's attention forward: each stored edge's gathered row
    (``heads * width`` features and ``heads`` source scores at
    ``value_bytes``) and its source index, and the float32 (n_nodes,
    heads * width) output and (n_nodes, heads) destination scores once
    each."""
    return (n_edges * ((heads * width + heads) * value_bytes + index_bytes)
            + n_nodes * (heads * width + heads) * 4)


def attention_flops(n_edges: int, heads: int, width: int) -> float:
    """One layer's aggregation forward: 2 E H F."""
    return 2.0 * n_edges * heads * width


def attention_bound_s(n_edges: int, n_nodes: int, layer_list,
                      value_bytes: int, index_bytes: int = 8) -> float:
    """The least time of an epoch's attention, forward and backward, over
    ``layer_list``: each layer's forward bound (``counts.bound_s``) and a
    backward of twice that (it reads the gathered rows and the output
    gradient and writes the gradients of both the rows and the
    coefficients)."""
    return sum(3.0 * counts.bound_s(
        attention_bytes(n_edges, n_nodes, h, f, value_bytes, index_bytes),
        attention_flops(n_edges, h, f))
        for _i, h, f, _r in layer_list)


def epoch_flops(n_nodes: int, n_edges: int, layer_list) -> float:
    """Model operations of one full-batch epoch: per layer, forward the
    Linear (and the residual Linear), the two per-node scores (2 N H F
    each), the edge scores and softmax (5 E H: add, LeakyReLU, shift, exp,
    divide) and the aggregation (2 E H F); backward twice each of these
    but the Linears, whose weight gradient is counted for every layer and
    input gradient past the first. BatchNorm, ReLU, the mean of the output
    heads and the loss are not counted."""
    total = 0.0
    for k, (i, h, f, res) in enumerate(layer_list):
        lin = 2.0 * n_nodes * i * h * f * (2 if res else 1)
        rest = (2 * 2.0 * n_nodes * h * f + 5.0 * n_edges * h
                + attention_flops(n_edges, h, f))
        total += lin + 3 * rest                      # forward, backward
        total += lin * (2 if k > 0 else 1)           # dW, dX past layer 0
    return total
