"""Dense symmetric eigen-solvers for the Laplace stack.

Counterpart of ``laplace_gnn_tpu/ops/linalg.py``. Eigenvalues are clamped
at zero with ``torch.maximum`` rather than ``torch.clamp``: at an exact tie
``maximum`` splits the gradient in halves, as ``jnp.clip`` does, where
``clamp`` passes all of it.

torch's eigensolvers check their result's ``info`` on the host, so each
call makes the host wait for the device: each counts ``host_sync``
(``profiling.py``); the batched ones run under the span ``eigh`` and
count ``eigh.calls`` (one per same-size group) and ``eigh.matrices``.

:func:`batched_eigvalsh` sends matrices of up to ``SMALL_N`` rows to
:func:`small_eigvalsh`: on a CUDA tensor the hand-written kernels of
``csrc/small_eigh.cu``, which make the host wait for nothing and can be
captured into a CUDA graph. They report a non-finite input or an
unconverged solve in a flag on the device, which
:func:`raise_on_failed_eigensolve` reads where a loop already reads the
device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..profiling import annotate, count, tracing
from .cuda_build import load
from .launches import LaunchCounter

SMALL_N = 128   # the largest matrix csrc/small_eigh.cu takes (MAX_N there)


def clip_min0(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with JAX's gradient at ties (half to each side)."""
    return torch.maximum(x, x.new_zeros(()))


def symeig(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues clamped at 0, eigenvectors), NaNs zeroed; ascending."""
    M = 0.5 * (M + M.T)
    count("host_sync")
    L, W = torch.linalg.eigh(M)
    return torch.nan_to_num(clip_min0(L)), torch.nan_to_num(W)


def safe_symeig(M: torch.Tensor, jitter: float = 0.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`symeig` of ``M + jitter I``, the jitter taken off the
    eigenvalues again (and clamped at 0)."""
    if jitter:
        eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
        L, W = symeig(M + jitter * eye)
        return clip_min0(L - jitter), W
    return symeig(M)


def kron(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Kronecker product A (x) B."""
    return torch.kron(A, B)


def block_diag(blocks) -> torch.Tensor:
    """Dense block-diagonal matrix of ``blocks``."""
    return torch.block_diag(*blocks)


def diagonal_add_scalar(X: torch.Tensor, value) -> torch.Tensor:
    """``X + value I`` (a new tensor)."""
    return X + value * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)


def cho_solve_psd(M: torch.Tensor, B: torch.Tensor,
                  jitter: float = 0.0) -> torch.Tensor:
    """``M^{-1} B`` for a symmetric positive (semi)definite ``M``, through
    the Cholesky factor of ``M + jitter I``."""
    L = torch.linalg.cholesky(diagonal_add_scalar(M, jitter) if jitter
                              else M)
    if B.dim() == 1:
        return torch.cholesky_solve(B[:, None], L)[:, 0]
    return torch.cholesky_solve(B, L)


def _same_size_groups(mats) -> dict:
    groups: dict = {}
    for i, m in enumerate(mats):
        groups.setdefault(int(m.shape[0]), []).append(i)
    return groups


def _count_eigh(n_matrices: int, host_sync: bool = True) -> None:
    count("eigh.calls")
    count("eigh.matrices", n_matrices)
    if host_sync:
        count("host_sync")


# ---------------------------------------------------------------------------
# The small eigensolver: csrc/small_eigh.cu on the card
# ---------------------------------------------------------------------------

_FAILED: dict = {}   # device -> the int32 flag the kernels set on failure


def _device_key(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _failure_flag(device: torch.device) -> torch.Tensor:
    """The device's flag, made at its first solve. That solve must not be
    inside a CUDA graph capture (which would take the flag from the
    graph's private pool): ``training/graphs.py::capture`` calls each
    step before it captures it."""
    flag = _FAILED.get(device)
    if flag is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("small eigensolver: the first solve on "
                               f"{device} is inside a CUDA graph capture")
        flag = _FAILED[device] = torch.zeros(1, dtype=torch.int32,
                                             device=device)
    return flag


def reset_eigensolve_failures(device) -> None:
    """Clear ``device``'s failure flag, on the device (no host wait)."""
    if torch.device(device).type != "cuda":
        return
    flag = _FAILED.get(_device_key(device))
    if flag is not None:
        flag.zero_()


def raise_on_failed_eigensolve(device) -> None:
    """Raise if a kernel solve on ``device`` since the flag was last
    cleared had a non-finite input (its eigenvalues came out NaN) or did
    not converge, where torch's eigensolvers raise at the call. Reads the
    flag (one host read, counted as ``host_sync``), and clears it when it
    raises. Nothing to read on the CPU, where the plain version raises
    itself."""
    if torch.device(device).type != "cuda":
        return
    flag = _FAILED.get(_device_key(device))
    if flag is None:
        return
    count("host_sync")
    bits = int(flag)
    if bits:
        flag.zero_()
        what = [w for b, w in ((1, "a non-finite input"),
                               (2, "an unconverged Jacobi solve"))
                if bits & b]
        raise FloatingPointError(
            f"small eigensolver on {device}: {' and '.join(what)} since "
            "the flag was last cleared")


class SmallEigKernel(LaunchCounter):
    """Wrapper of one entry point of ``csrc/small_eigh.cu`` with a launch
    counter: ``small_eigvalsh`` (eigenvalues, ascending) or ``small_eigh``
    (eigenvalues in the order of the converged diagonal, and their
    vectors). Takes a (B, n, n) f32 or f64 CUDA tensor, 1 <= n <=
    ``SMALL_N``, reads its lower triangle, launches one block a matrix on
    the current stream and allocates only its outputs."""

    source = "laplace_gnn_torch/csrc/small_eigh.cu"

    def __init__(self, name: str, vectors: bool):
        super().__init__()
        self.name = name
        self.vectors = vectors
        self._fn = None

    def _entry(self):
        """The C entry point, built and typed on first use."""
        if self._fn is None:
            fn = getattr(load("small_eigh"), f"{self.name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * (3 if self.vectors else 2)
                           + [ctypes.c_int] * 3
                           + [ctypes.c_void_p, ctypes.c_void_p])
            self._fn = fn
        return self._fn

    def __call__(self, M: torch.Tensor):
        if not M.is_cuda:
            raise ValueError(f"{self.name}: a CUDA tensor, got {M.device}")
        if M.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{self.name}: float32 or float64, got {M.dtype}")
        if M.dim() != 3 or M.shape[1] != M.shape[2]:
            raise ValueError(f"{self.name}: (B, n, n), got {tuple(M.shape)}")
        b, n, _ = M.shape
        if not 1 <= n <= SMALL_N or b > 65535:
            raise ValueError(f"{self.name}: n in [1, {SMALL_N}] and at most "
                             f"65535 matrices, got {tuple(M.shape)}")
        M = M.contiguous()
        vals = torch.empty((b, n), dtype=M.dtype, device=M.device)
        vecs = (torch.empty((b, n, n), dtype=M.dtype, device=M.device)
                if self.vectors else None)
        if b:
            flag = _failure_flag(M.device)
            outs = [vals.data_ptr()] + ([vecs.data_ptr()] if self.vectors
                                        else [])
            rc = self._entry()(
                M.data_ptr(), *outs, b, n, int(M.dtype == torch.float64),
                flag.data_ptr(),
                torch.cuda.current_stream(M.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{self.name} launch failed with CUDA "
                                   f"error {rc}")
            self._counted()
        return (vals, vecs) if self.vectors else vals


eigvalsh_kernel = SmallEigKernel("small_eigvalsh", vectors=False)
eigh_kernel = SmallEigKernel("small_eigh", vectors=True)


def small_eigenvectors(M: torch.Tensor) -> torch.Tensor:
    """Eigenvectors of a (B, n, n) batch, as columns in the order of the
    ascending eigenvalues: the Jacobi kernel on a CUDA tensor (its output
    sorted on the device), ``torch.linalg.eigh`` on a CPU tensor."""
    if M.device.type == "cpu":
        return torch.linalg.eigh(M)[1]
    vals, vecs = eigh_kernel(M)
    order = torch.argsort(vals, dim=-1, stable=True)
    return torch.gather(vecs, -1, order[:, None, :].expand_as(vecs))


class _SmallEigvalsh(torch.autograd.Function):
    """Eigenvalues of a (B, n, n) batch, n <= ``SMALL_N``, ascending: the
    kernel on a CUDA tensor, the plain version (``torch.linalg.eigvalsh``)
    on a CPU tensor. The forward computes values only and saves the input;
    the backward recomputes the eigenvectors (:func:`small_eigenvectors`)
    and returns ``V diag(g) V^T``, ``eigvalsh``'s own gradient."""

    @staticmethod
    def forward(M):
        if M.device.type == "cpu":
            return torch.linalg.eigvalsh(M)
        return eigvalsh_kernel(M)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (M,) = ctx.saved_tensors
        V = small_eigenvectors(M)
        return (V * g[..., None, :]) @ V.mT


def small_eigvalsh(M: torch.Tensor) -> torch.Tensor:
    """Differentiable eigenvalues of a (B, n, n) batch of symmetric
    matrices with n <= ``SMALL_N`` (lower triangle read), ascending."""
    return _SmallEigvalsh.apply(M)


@annotate("eigh")
def batched_eigvalsh(mats) -> list:
    """Eigenvalues of several symmetric matrices; same-size matrices share
    one batched call. Ascending, one vector per input. The size decides
    the solver: up to ``SMALL_N`` rows :func:`small_eigvalsh` (on the card
    a kernel that makes the host wait for nothing), above it
    ``torch.linalg.eigvalsh`` (which checks its result on the host)."""
    mats = list(mats)
    out: list = [None] * len(mats)
    for n, idxs in _same_size_groups(mats).items():
        stacked = torch.stack([mats[i] for i in idxs])
        small = n <= SMALL_N
        if tracing():
            _count_eigh(len(idxs),
                        host_sync=not small or stacked.device.type == "cpu")
        lams = (small_eigvalsh(stacked) if small
                else torch.linalg.eigvalsh(stacked))
        for t, i in enumerate(idxs):
            out[i] = lams[t]
    return out


def _standard_normals(shape: tuple, generator: Optional[torch.Generator],
                      dtype, device) -> torch.Tensor:
    """Standard normal draws: :func:`normal_samples`' and the Laplace
    flavours' ``sample``'s, in one place a test can replace."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device)


def normal_samples(mean: torch.Tensor, var: torch.Tensor, n_samples: int,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Samples from batched Normals with diagonal or full covariance.

    mean (B, K); var (B, K) diagonal or (B, K, K) full. The standard normal
    draws ``eps`` (K, n_samples) come from ``generator``, or are passed in
    (the same noise for both packages in a test). Returns
    (n_samples, B, K)."""
    B, K = mean.shape
    if eps is None:
        eps = _standard_normals((K, n_samples), generator, mean.dtype,
                                mean.device)
    if mean.shape == var.shape:                       # diagonal
        scaled = torch.sqrt(var)[..., None] * eps[None]
    elif var.shape == (B, K, K):                      # full covariance
        scaled = torch.linalg.cholesky(var) @ eps[None]
    else:
        raise ValueError("Invalid input shapes.")
    return torch.permute(mean[..., None] + scaled, (2, 0, 1))


def invsqrt_precision(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangular ``S`` with ``S S^T = M^{-1}`` for a precision
    matrix ``M``, as torch.distributions' ``_precision_to_scale_tril``
    forms it: the Cholesky factor of the flipped matrix, then a triangular
    solve. The flipped matrix is freed before the solve (at P = 23063 in
    f32 each P x P matrix is 2.13 GB)."""
    Lf = torch.linalg.cholesky(torch.flip(M, (-2, -1)))
    L_inv = torch.flip(Lf, (-2, -1)).mT
    del Lf
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.solve_triangular(L_inv, eye, upper=False)


@annotate("eigh")
def batched_symeig(mats) -> list:
    """Like :func:`batched_eigvalsh` with eigenvectors, under
    :func:`symeig`'s clamp and NaN post-conditions."""
    mats = [0.5 * (m + m.T) for m in mats]
    out: list = [None] * len(mats)
    for _, idxs in _same_size_groups(mats).items():
        if tracing():
            _count_eigh(len(idxs))
        L, W = torch.linalg.eigh(torch.stack([mats[i] for i in idxs]))
        for t, i in enumerate(idxs):
            out[i] = (torch.nan_to_num(clip_min0(L[t])),
                      torch.nan_to_num(W[t]))
    return out
