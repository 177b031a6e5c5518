"""Kronecker-factored curvature blocks: ``Kron`` and ``KronDecomposed``
(counterpart of ``laplace_gnn_tpu/laplace/kron.py``).

One group per posterior parameter leaf in JAX tree order (bias before
weight): a bias has ``[B]``, a weight (out, in) has ``[B (out, out),
A (in, in)]`` with row-major (out, in) vec ordering. A group may also be
one 1-D factor: an exact curvature diagonal (GAT's attention vectors and
biases).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.linalg import batched_symeig


def _is_scalarish(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dim() == 0 or (x.dim() == 1 and x.shape[0] == 1)
    return isinstance(x, (int, float))


def _logdet(F: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.slogdet(F)[1] if F.dim() > 1
            else torch.sum(torch.log(F)))


def _dense(F: torch.Tensor) -> torch.Tensor:
    return F if F.dim() > 1 else torch.diag(F)


def _diag(F: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(F) if F.dim() > 1 else F


def _batched(bmm, W: torch.Tensor, *args) -> torch.Tensor:
    """``bmm`` (which takes (B, K, P)) applied to a (P,), (B, P) or
    (B, K, P) ``W``, in the shape it came."""
    if W.dim() == 1:
        return bmm(W[None, None, :], *args).squeeze()
    if W.dim() == 2:
        return bmm(W[:, None, :], *args).squeeze(1)
    if W.dim() == 3:
        return bmm(W, *args)
    raise ValueError("Invalid shape for W")


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

    def decompose(self, damping: bool = False) -> "KronDecomposed":
        """Eigendecompose every dense factor (same-size factors share one
        batched ``eigh``); a 1-D factor is its own eigenvalues with the
        identity as eigenvectors."""
        dense = [(gi, fi, F) for gi, group in enumerate(self.kfacs)
                 for fi, F in enumerate(group) if F.dim() > 1]
        dense_eigs = batched_symeig([F for _, _, F in dense])
        by_pos = {(gi, fi): lw for (gi, fi, _), lw in zip(dense, dense_eigs)}
        eigvecs, eigvals = [], []
        for gi, group in enumerate(self.kfacs):
            Qs, ls = [], []
            for fi, F in enumerate(group):
                if F.dim() > 1:
                    l, Q = by_pos[(gi, fi)]
                else:
                    l, Q = F, torch.eye(F.shape[0], dtype=F.dtype,
                                        device=F.device)
                Qs.append(Q)
                ls.append(l)
            eigvecs.append(Qs)
            eigvals.append(ls)
        return KronDecomposed(eigvecs, eigvals, damping=damping)

    def _bmm(self, W: torch.Tensor) -> torch.Tensor:
        B, K, P = W.shape
        W = W.reshape(B * K, P)
        cur, out = 0, []
        for group in self.kfacs:
            if len(group) == 1:
                Q = group[0]
                p = Q.shape[0]
                Wp = W[:, cur: cur + p].T
                out.append((Q @ Wp).T if Q.dim() > 1 else (Q[:, None] * Wp).T)
            else:
                Q, H = group
                po, pi = Q.shape[0], H.shape[0]
                p = po * pi
                Wp = W[:, cur: cur + p].reshape(B * K, po, pi)
                QW = Q @ Wp if Q.dim() > 1 else Q[:, None] * Wp
                QWH = QW @ H.T if H.dim() > 1 else QW * H[None, :]
                out.append(QWH.reshape(B * K, p))
            cur += p
        return torch.cat(out, dim=1).reshape(B, K, P)

    def bmm(self, W: torch.Tensor, exponent: float = 1) -> torch.Tensor:
        if exponent != 1:
            raise ValueError("Only supported after decomposition.")
        return _batched(self._bmm, W)

    def logdet(self) -> torch.Tensor:
        out = 0.0
        for group in self.kfacs:
            if len(group) == 1:
                out = out + _logdet(group[0])
            else:
                Q, H = group
                out = out + H.shape[0] * _logdet(Q) + Q.shape[0] * _logdet(H)
        return out

    def diag(self) -> torch.Tensor:
        diags = []
        for group in self.kfacs:
            d = _diag(group[0])
            diags.append(d if len(group) == 1
                         else torch.outer(d, _diag(group[1])).reshape(-1))
        return torch.cat(diags)

    def to_matrix(self) -> torch.Tensor:
        """Dense block-diagonal materialization (tests only)."""
        blocks = []
        for group in self.kfacs:
            F0 = _dense(group[0])
            blocks.append(F0 if len(group) == 1
                          else torch.kron(F0.contiguous(),
                                          _dense(group[1]).contiguous()))
        return torch.block_diag(*blocks)


class KronDecomposed:
    """Eigendecomposed Kron with additive per-block ``deltas`` (prior
    precision) and optional Martens-style damping."""

    def __init__(self, eigenvectors, eigenvalues,
                 deltas: Optional[torch.Tensor] = None, damping: bool = False):
        self.eigenvectors = eigenvectors
        self.eigenvalues = eigenvalues
        if deltas is None:
            l0 = eigenvalues[0][0]
            deltas = torch.zeros(len(eigenvalues), dtype=l0.dtype,
                                 device=l0.device)
        self.deltas = deltas
        self.damping = damping

    def _check_deltas(self, deltas) -> None:
        deltas = torch.as_tensor(deltas)
        if deltas.dim() == 0 or (deltas.dim() == 1
                                 and deltas.shape[0] in (1, len(self))):
            return
        raise ValueError("Invalid shape of delta added to KronDecomposed.")

    def __add__(self, deltas) -> "KronDecomposed":
        self._check_deltas(deltas)
        return KronDecomposed(self.eigenvectors, self.eigenvalues,
                              self.deltas + deltas, self.damping)

    def __mul__(self, scalar) -> "KronDecomposed":
        if not _is_scalarish(scalar):
            raise ValueError("Invalid argument, can only multiply Kron with "
                             "scalar.")
        eigenvalues = [[scalar ** (1.0 / len(ls)) * l for l in ls]
                       for ls in self.eigenvalues]
        return KronDecomposed(self.eigenvectors, eigenvalues, self.deltas,
                              self.damping)

    __radd__ = __add__
    __rmul__ = __mul__

    def __len__(self) -> int:
        return len(self.eigenvalues)

    def _block_eigs(self, ls, delta):
        """Effective eigenvalue grid of one block including the prior."""
        if len(ls) == 1:
            return ls[0] + delta
        l1, l2 = ls
        if self.damping:
            return torch.outer(l1 + torch.sqrt(delta), l2 + torch.sqrt(delta))
        return torch.outer(l1, l2) + delta

    def logdet(self) -> torch.Tensor:
        out = 0.0
        for ls, delta in zip(self.eigenvalues, self.deltas):
            out = out + torch.sum(torch.log(self._block_eigs(ls, delta)))
        return out

    def _bmm(self, W: torch.Tensor, exponent: float = -1) -> torch.Tensor:
        """``self ** exponent @ W`` for W (B, K, P). The products are left
        to ``torch.matmul``, as the JAX package leaves them to XLA."""
        B, K, P = W.shape
        W = W.reshape(B * K, P)
        cur, out = 0, []
        for ls, Qs, delta in zip(self.eigenvalues, self.eigenvectors,
                                 self.deltas):
            leff = self._block_eigs(ls, delta) ** exponent
            if len(ls) == 1:
                Q = Qs[0]
                p = ls[0].shape[0]
                Wp = W[:, cur: cur + p].T
                out.append((Q @ (leff[:, None] * (Q.T @ Wp))).T)
            else:
                Q1, Q2 = Qs
                po, pi = ls[0].shape[0], ls[1].shape[0]
                p = po * pi
                Wp = W[:, cur: cur + p].reshape(B * K, po, pi)
                Wp = (Q1.T @ Wp @ Q2) * leff[None]
                out.append((Q1 @ Wp @ Q2.T).reshape(B * K, p))
            cur += p
        return torch.cat(out, dim=1).reshape(B, K, P)

    def bmm(self, W: torch.Tensor, exponent: float = -1) -> torch.Tensor:
        return _batched(self._bmm, W, exponent)

    def inv_square_form(self, W: torch.Tensor) -> torch.Tensor:
        """W P^{-1} W^T batched: (B, K, P) -> (B, K, K)."""
        return torch.einsum("bkp,blp->bkl", W, self._bmm(W, exponent=-1))

    def diag(self) -> torch.Tensor:
        """Diagonal of the represented matrix (incl. deltas)."""
        diags = []
        for ls, Qs, delta in zip(self.eigenvalues, self.eigenvectors,
                                 self.deltas):
            leff = self._block_eigs(ls, delta)
            if len(ls) == 1:
                Q = Qs[0]
                diags.append(torch.einsum("ij,j,ij->i", Q, leff, Q))
            else:
                Q1, Q2 = Qs
                diags.append((Q1 ** 2 @ leff @ (Q2 ** 2).T).reshape(-1))
        return torch.cat(diags)

    def to_matrix(self, exponent: float = 1) -> torch.Tensor:
        """Dense materialization (tests only)."""
        blocks = []
        for ls, Qs, delta in zip(self.eigenvalues, self.eigenvectors,
                                 self.deltas):
            leff = (self._block_eigs(ls, delta) ** exponent).reshape(-1)
            Q = (Qs[0] if len(ls) == 1 else
                 torch.kron(Qs[0].contiguous(), Qs[1].contiguous()))
            blocks.append(Q @ torch.diag(leff) @ Q.T)
        return torch.block_diag(*blocks)
