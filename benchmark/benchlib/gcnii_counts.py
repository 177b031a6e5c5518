"""Operations of a GCNII epoch, from shapes alone.

As ``counts``: the operations are the model's. A layer ``l`` of width
``h`` is the SpMM ``Ahat H`` (2 E h), the initial residual ``(1 - alpha)
Ahat H + alpha H_0`` (3 N h) and the identity-mapped product ``(1 -
theta) S + theta S W`` (2 N h^2 and 3 N h); the input Linear maps the
features to ``h``, the output Linear ``h`` to the classes."""

from __future__ import annotations


def _lin(rows: int, i: int, o: int) -> float:
    return 2.0 * rows * i * o


def epoch_flops(n_nodes: int, n_edges: int, n_features: int, hidden: int,
                n_classes: int, n_layers: int) -> float:
    """Model operations of one full-batch epoch: the input Linear
    (forward and weight gradient), each layer forward (SpMM, the two
    mixes, the product) and backward (the transposed SpMM, the weight and
    input gradients of the product, the mixes' gradients: as many
    operations as their forward), and the output Linear (forward, weight
    and input gradients). ReLU and the loss are not counted."""
    n, h = n_nodes, hidden
    spmm = 2.0 * n_edges * h
    mixes = 6.0 * n * h
    layer = (spmm + mixes + _lin(n, h, h)) + (spmm + mixes
                                              + 2 * _lin(n, h, h))
    return (2 * _lin(n, n_features, h) + n_layers * layer
            + 3 * _lin(n, h, n_classes))
