"""Kronecker-factored curvature blocks (counterpart of
``laplace_gnn_tpu/laplace/kron.py``; ``Kron`` only so far).

One group per posterior parameter leaf in JAX tree order (bias before
weight): a bias has ``[B]``, a weight (out, in) has ``[B (out, out),
A (in, in)]`` with row-major (out, in) vec ordering.
"""

from __future__ import annotations

import torch


def _is_scalarish(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dim() == 0 or (x.dim() == 1 and x.shape[0] == 1)
    return isinstance(x, (int, float))


class Kron:
    """List of Kronecker factor groups; each group is [F] or [G, A]."""

    def __init__(self, kfacs: list[list[torch.Tensor]]):
        self.kfacs = kfacs

    def __add__(self, other: "Kron") -> "Kron":
        if not isinstance(other, Kron):
            raise ValueError("Can only add Kron to Kron.")
        return Kron([[a + b for a, b in zip(ga, gb)]
                     for ga, gb in zip(self.kfacs, other.kfacs)])

    def __mul__(self, scalar) -> "Kron":
        """Distribute the scalar over a group as scalar**(1/len(group))."""
        if not _is_scalarish(scalar):
            raise ValueError("Input not valid scalar.")
        return Kron([[scalar ** (1.0 / len(g)) * f for f in g]
                     for g in self.kfacs])

    __radd__ = __add__
    __rmul__ = __mul__

    def __len__(self) -> int:
        return len(self.kfacs)
