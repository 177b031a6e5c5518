"""Model operations of one whole structure-learning run of the 2-layer
STE-GCN on the composed route (``fused=False``), from shapes alone.

``counts.stegcn_run_flops``' terms (every train step, tracking forward,
-log marglik evaluation and hyperstep value), and in each hyperstep the
outer backward that the fused route does not run: the gradient of the
-log marglik flows back through every product of the evaluation (the
operations of the evaluation again) and, at each (n, n) aggregation it
passes, into the adjacency (the product ``g s^T``, 2 n^2 d for an operand
of d columns). An evaluation aggregates d = h and d = c in the forward
and again in each of the c loss-Hessian columns' pullbacks. The dense
N x N forms of the adjacency (symmetrize, threshold, degrees, scaling)
and the eigensolves are not counted."""

from __future__ import annotations

from . import counts


def adjacency_gradient_flops(n: int, h: int, c: int) -> float:
    """The (n, n) gradient products of one evaluation's backward: one at
    each aggregation of width h and c, in the forward and in each of the
    c pullbacks."""
    return 2.0 * n * n * (h + c) * (1 + c)


def run_flops(n: int, f: int, h: int, c: int, n_epochs: int,
              n_hypersteps: int) -> float:
    evaluation = counts.stegcn_run_flops(n, f, h, c, 0, 1)
    return (counts.stegcn_run_flops(n, f, h, c, n_epochs, n_hypersteps)
            + n_hypersteps * (evaluation
                              + adjacency_gradient_flops(n, h, c)))
