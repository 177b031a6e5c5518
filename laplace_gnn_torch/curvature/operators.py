"""Curvature matrix-vector products as jvp / vjp closures (counterpart of
``laplace_gnn_tpu/curvature/operators.py``): the exact Hessian, the GGN,
the empirical and the Monte-Carlo Fisher, the Jacobian and its transpose,
and operator algebra (scaled, sum, diagonal shift, submatrix, outer
product, projector).

Products are forward-over-reverse: ``torch.func.jvp`` and
``torch.func.vjp`` where JAX takes ``jax.jvp`` / ``jax.vjp``. So, as in
JAX, a forward-mode product raises on a model whose fused aggregation has
no forward-mode rule (``STEGCN(fused=True)``: ``NotImplementedError``
here, JAX's ``TypeError``); the reverse-mode products (``JacobianOperator.
rmatvec``, ``TransposedJacobianOperator.matvec``) run through the kernel.
The EF and MC-Fisher products compose one jvp and one vjp of the vector of
per-sample losses: ``F v = (dl/dw)^T ((dl/dw) v)``.

``model_fn(w, X) -> (M, C)`` closes over the frozen (non-posterior)
parameters; all losses are sum-reduced.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.pytree import tree_add, tree_size, tree_unflattener, tree_vector
from .base import LinearOperator, PyTreeOperator, accumulate_over_batches
from .kfac import _fold_seed
from .losses import get_loss_fn, loss_hessian_mvp, sample_labels


def _mc_labels(seed: int, likelihood: str, f: torch.Tensor) -> torch.Tensor:
    """The MC Fisher's would-be labels at ``f`` for one (batch, sample)
    seed."""
    return sample_labels(torch.Generator().manual_seed(seed), likelihood, f)


# ---------------------------------------------------------------------------
# Per-batch dict matvecs
# ---------------------------------------------------------------------------

def hvp_tree(loss_of_w: Callable[[dict], torch.Tensor], w: dict,
             v_tree: dict) -> dict:
    """Hessian-vector product via forward-over-reverse."""
    return torch.func.jvp(torch.func.grad(loss_of_w), (w,), (v_tree,))[1]


def ggn_vp_tree(model_fn, likelihood: str, w: dict, X, v_tree: dict) -> dict:
    """GGN-vector product: J^T H_loss(f) J v."""
    f, jv = torch.func.jvp(lambda w_: model_fn(w_, X), (w,), (v_tree,))
    hjv = loss_hessian_mvp(likelihood, f, jv)
    _, pullback = torch.func.vjp(lambda w_: model_fn(w_, X), w)
    return pullback(hjv)[0]


def ef_vp_tree(model_fn, loss_fn, w: dict, X, y, v_tree: dict) -> dict:
    """Empirical-Fisher vector product sum_n g_n g_n^T v via the per-sample
    loss vector l(w): F v = (dl/dw)^T ((dl/dw) v)."""

    def per_sample_losses(w_):
        f = model_fn(w_, X)
        return torch.func.vmap(lambda fi, yi: loss_fn(fi[None], yi[None]))(
            f, y)

    _, t = torch.func.jvp(per_sample_losses, (w,), (v_tree,))
    _, pullback = torch.func.vjp(per_sample_losses, w)
    return pullback(t)[0]


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

class HessianOperator(PyTreeOperator):
    """Exact Hessian of the total (sum over batches) loss."""

    def __init__(self, model_fn, likelihood: str, w: dict, data):
        loss_fn = get_loss_fn(likelihood)
        data = list(data)

        def tree_matvec(v_tree):
            def per_batch(X, y):
                return hvp_tree(lambda w_: loss_fn(model_fn(w_, X), y),
                                w, v_tree)
            return accumulate_over_batches(per_batch, data)

        super().__init__(tree_matvec, w)


class GGNOperator(PyTreeOperator):
    def __init__(self, model_fn, likelihood: str, w: dict, data):
        data = list(data)

        def tree_matvec(v_tree):
            def per_batch(X, y):
                return ggn_vp_tree(model_fn, likelihood, w, X, v_tree)
            return accumulate_over_batches(per_batch, data)

        super().__init__(tree_matvec, w)


class EFOperator(PyTreeOperator):
    def __init__(self, model_fn, likelihood: str, w: dict, data):
        loss_fn = get_loss_fn(likelihood)
        data = list(data)

        def tree_matvec(v_tree):
            def per_batch(X, y):
                return ef_vp_tree(model_fn, loss_fn, w, X, y, v_tree)
            return accumulate_over_batches(per_batch, data)

        super().__init__(tree_matvec, w)


class FisherMCOperator(PyTreeOperator):
    """Monte-Carlo Fisher: EF with labels sampled from the model's
    predictive. Batch ``b`` and sample ``m`` are folded into ``seed``, as
    JAX folds its key. JAX draws the same labels again in every matvec;
    here they are drawn once, when the operator is built (a random draw
    cannot run under ``matmat``'s vmap)."""

    def __init__(self, model_fn, likelihood: str, w: dict, data,
                 mc_samples: int = 1, seed: int = 2147483647):
        loss_fn = get_loss_fn(likelihood)
        data = list(data)
        labels = []
        for b, (X, _) in enumerate(data):
            with torch.no_grad():
                f = model_fn(w, X)
            sb = _fold_seed(seed, b)
            labels.append([_mc_labels(_fold_seed(sb, m), likelihood, f)
                           for m in range(mc_samples)])

        def tree_matvec(v_tree):
            total = None
            for (X, _), y_b in zip(data, labels):
                term = None
                for y_s in y_b:
                    t = ef_vp_tree(model_fn, loss_fn, w, X, y_s, v_tree)
                    term = t if term is None else tree_add(term, t)
                term = {k: v / mc_samples for k, v in term.items()}
                total = term if total is None else tree_add(total, term)
            return total

        super().__init__(tree_matvec, w)


class JacobianOperator(LinearOperator):
    """(sum_b M_b * C) x P Jacobian of the concatenated model outputs."""

    def __init__(self, model_fn, w: dict, data):
        self.data = list(data)
        self._w = w
        self._model_fn = model_fn
        with torch.no_grad():
            outs = [model_fn(w, X) for X, _ in self.data]
        self._out_shapes = [o.shape for o in outs]
        rows = sum(int(o.numel()) for o in outs)
        super().__init__((rows, tree_size(w)), outs[0].dtype, outs[0].device)
        self._unflatten = tree_unflattener(w)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        v_tree = self._unflatten(v)
        outs = []
        for X, _ in self.data:
            _, jv = torch.func.jvp(lambda w_: self._model_fn(w_, X),
                                   (self._w,), (v_tree,))
            outs.append(jv.reshape(-1))
        return torch.cat(outs)

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        total, off = None, 0
        for (X, _), shp in zip(self.data, self._out_shapes):
            n = shp.numel()
            cot = u[off: off + n].reshape(shp)
            off += n
            _, pullback = torch.func.vjp(lambda w_: self._model_fn(w_, X),
                                         self._w)
            term = pullback(cot)[0]
            total = term if total is None else tree_add(total, term)
        return tree_vector(total)


class TransposedJacobianOperator(LinearOperator):
    """P x (N*C) transpose view."""

    def __init__(self, model_fn, w: dict, data):
        self.J = JacobianOperator(model_fn, w, data)
        super().__init__((self.J.shape[1], self.J.shape[0]), self.J.dtype,
                         self.J.device)

    def matvec(self, v):
        return self.J.rmatvec(v)

    def rmatvec(self, u):
        return self.J.matvec(u)


class ScaledOperator(LinearOperator):
    def __init__(self, op: LinearOperator, scale: float):
        super().__init__(op.shape, op.dtype, op.device)
        self.op, self.scale = op, scale

    def matvec(self, v):
        return self.scale * self.op.matvec(v)


class SumOperator(LinearOperator):
    def __init__(self, *ops: LinearOperator):
        super().__init__(ops[0].shape, ops[0].dtype, ops[0].device)
        self.ops = ops

    def matvec(self, v):
        out = self.ops[0].matvec(v)
        for op in self.ops[1:]:
            out = out + op.matvec(v)
        return out


class DiagShiftOperator(LinearOperator):
    """op + diag(shift), e.g. curvature + prior precision."""

    def __init__(self, op: LinearOperator, shift):
        super().__init__(op.shape, op.dtype, op.device)
        self.op = op
        self.shift = torch.as_tensor(shift, dtype=op.dtype, device=op.device)

    def matvec(self, v):
        return self.op.matvec(v) + self.shift * v


class SubmatrixOperator(LinearOperator):
    """Row / column-index view of a base operator."""

    def __init__(self, op: LinearOperator, row_idx, col_idx):
        self.op = op
        super().__init__((0, 0), op.dtype, op.device)
        self.set_submatrix(row_idx, col_idx)

    def set_submatrix(self, row_idx, col_idx) -> None:
        """Re-target the view."""
        self.row_idx = torch.as_tensor(row_idx, device=self.device)
        self.col_idx = torch.as_tensor(col_idx, device=self.device)
        self.shape = (len(self.row_idx), len(self.col_idx))

    def matvec(self, v):
        full = torch.zeros(self.op.shape[1], dtype=self.dtype,
                           device=self.device).index_copy(0, self.col_idx, v)
        return self.op.matvec(full)[self.row_idx]


class OuterProductOperator(LinearOperator):
    """sum_k c_k x_k x_k^T."""

    def __init__(self, X: torch.Tensor, c: Optional[torch.Tensor] = None):
        # X: (K, P) rows are factors
        self.X = X
        self.c = (torch.ones(X.shape[0], dtype=X.dtype, device=X.device)
                  if c is None else torch.as_tensor(c, dtype=X.dtype,
                                                    device=X.device))
        super().__init__((X.shape[1], X.shape[1]), X.dtype, X.device)

    def matvec(self, v):
        return self.X.T @ (self.c * (self.X @ v))


class Projector(OuterProductOperator):
    """Orthogonal projector onto the span of orthonormal rows of X."""
