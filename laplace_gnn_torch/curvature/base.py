"""Matrix-free linear operators over flattened parameter vectors
(counterpart of ``laplace_gnn_tpu/curvature/base.py``).

Operators are closures over ``torch.func.jvp`` / ``torch.func.vjp`` on a
functional model, accumulated over a list of batches. A parameter dict and
its flat (P,) vector convert through ``tree_vector`` / ``tree_unflattener``
in JAX tree order. ``matmat`` is ``torch.func.vmap`` of ``matvec`` over
columns, as JAX's is ``jax.vmap``. Nothing is compiled: JAX's ``jit``
keyword has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..device import resolve_device
from ..utils.pytree import (named_leaves, tree_add, tree_size,
                            tree_unflattener, tree_vector)


class LinearOperator:
    """Symmetric (unless stated) linear operator on flat parameter space,
    on ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(self, shape: tuple[int, int], dtype=torch.float32,
                 device=None):
        self.shape = shape
        self.dtype = dtype
        self.device = resolve_device(device)

    # -- to implement -----------------------------------------------------
    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmatvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.matvec(v)  # symmetric default

    # -- generic ----------------------------------------------------------
    def matmat(self, V: torch.Tensor) -> torch.Tensor:
        return torch.func.vmap(self.matvec, in_dims=1, out_dims=1)(V)

    def __matmul__(self, other):
        other = torch.as_tensor(other)
        if other.dim() == 1:
            return self.matvec(other)
        return self.matmat(other)

    def to_dense(self) -> torch.Tensor:
        eye = torch.eye(self.shape[1], dtype=self.dtype, device=self.device)
        return self.matmat(eye)

    def trace_exact(self) -> torch.Tensor:
        return torch.trace(self.to_dense())

    def check_deterministic(self, seed: int = 0, rtol: float = 5e-5,
                            atol: float = 1e-6) -> None:
        """Two matvecs on the same probe (standard normals seeded with
        ``seed``) must agree."""
        g = torch.Generator().manual_seed(seed)
        v = torch.randn(self.shape[1], generator=g, dtype=torch.float64).to(
            self.device, self.dtype)
        a, b = self.matvec(v), self.matvec(v)
        if not np.allclose(a.detach().cpu().numpy(), b.detach().cpu().numpy(),
                           rtol=rtol, atol=atol):
            raise RuntimeError("Linear operator is not deterministic.")


class PyTreeOperator(LinearOperator):
    """Operator defined by a dict -> dict matvec over a parameter template."""

    def __init__(self, tree_matvec: Callable[[dict], dict], w_template: dict):
        p = tree_size(w_template)
        leaves = [v for _, v in named_leaves(w_template)]
        dtype = leaves[0].dtype if leaves else torch.float32
        device = leaves[0].device if leaves else None
        super().__init__((p, p), dtype, device)
        self._unflatten = tree_unflattener(w_template)
        self._tree_matvec = tree_matvec
        self.w_template = w_template

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return tree_vector(self._tree_matvec(self._unflatten(v)))


def accumulate_over_batches(per_batch: Callable[[Any, Any], Any],
                            data: Iterable[tuple[Any, Any]]):
    """Sum a dict-valued function over (X, y) batches."""
    total = None
    for X, y in data:
        term = per_batch(X, y)
        total = term if total is None else tree_add(total, term)
    return total
