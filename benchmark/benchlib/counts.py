"""Operations and bytes the algorithms need, from shapes alone.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; the operations are the model's (a dense
product of an (n, n) and an (n, d) matrix is 2 n^2 d). Bounds are the
larger of bytes over the HBM rate and operations over the dense bf16
rate of ``peaks``."""

from __future__ import annotations

from . import peaks


def bound_s(n_bytes: float, n_flops: float) -> float:
    """The least time the card could take: the larger of the two."""
    return max(n_bytes / peaks.HBM_BYTES_PER_S, n_flops / peaks.BF16_FLOPS)


def core_spmm_bound_s(n: int, d: int, a_bytes: int, t_bytes: int) -> float:
    """One ``core_spmm`` launch on an (n, n) adjacency of ``a_bytes`` an
    entry and an (n, d) operand of ``t_bytes``: A, t and the output read
    or written once, 2 n^2 d operations (the port's kernel table)."""
    return bound_s(n * n * a_bytes + 2 * n * d * t_bytes, 2.0 * n * n * d)


def spmm_bound_s(n_edges: int, n_nodes: int, d: int, index_bytes: int,
                 value_bytes: int) -> float:
    """One sparse product over ``n_edges`` stored edges (self-loops
    included) of (n_nodes, d) operands at the aggregation dtype: each
    edge's source index and weight, the input and the output once, and
    2 E d operations."""
    n_bytes = (n_edges * (index_bytes + value_bytes)
               + 2 * n_nodes * d * value_bytes)
    return bound_s(n_bytes, 2.0 * n_edges * d)


def _lin(rows: int, i: int, o: int) -> float:
    return 2.0 * rows * i * o


def stegcn_run_flops(n: int, f: int, h: int, c: int, n_epochs: int,
                     n_hypersteps: int) -> float:
    """Model operations of one whole structure-learning run of a 2-layer
    STE-GCN on a dense (n, n) adjacency: every train step (forward and
    backward to the weights), tracking forward, -log marglik evaluation
    and hyperstep. An evaluation is the tap forward, the pullback of each
    of the c loss-Hessian columns through both layers, and the KFAC sums
    B = sum g^T g and A = a^T a of the second layer (the first layer's A
    is formed once per model). A hyperstep's value is the same work; its
    adjacency gradient is zero through the fused aggregation, so no
    backward runs. The eigensolves are not counted."""
    def agg(d):
        return 2.0 * n * n * d

    forward = _lin(n, f, h) + agg(h) + _lin(n, h, c) + agg(c)
    train = (forward + agg(c) + 2 * _lin(n, h, c) + agg(h)
             + _lin(n, f, h))
    evaluation = (forward + c * (agg(c) + _lin(n, c, h) + agg(h))
                  + _lin(c * n, c, c) + _lin(c * n, h, h) + _lin(n, h, h))
    return (n_epochs * (train + forward + evaluation)
            + n_hypersteps * evaluation)


def gcn_epoch_flops(n_nodes: int, n_edges: int, widths) -> float:
    """Model operations of one full-batch epoch of a sparse GCN whose
    layers map ``widths[i]`` to ``widths[i + 1]`` features: each layer's
    Linear and SpMM forward, and backward the SpMM, the weight gradient
    and (past the first layer) the input gradient."""
    total = 0.0
    for layer, (i, o) in enumerate(zip(widths[:-1], widths[1:])):
        spmm = 2.0 * n_edges * o
        total += _lin(n_nodes, i, o) + spmm                 # forward
        total += spmm + _lin(n_nodes, i, o)                 # dS, dW
        if layer > 0:
            total += _lin(n_nodes, i, o)                    # dX
    return total
