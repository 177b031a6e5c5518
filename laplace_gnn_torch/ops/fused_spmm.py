"""Fused STE-binarize + self-loop + symmetric-normalize + aggregate.

Counterpart of ``laplace_gnn_tpu/ops/pallas_spmm.py``. STE-GCN's layer
aggregation is

    B   = fill_diag(binarize(A_sym, tau), 1)
    out = D^-1/2 B^T D^-1/2 @ s,     D = rowsum(B)

and :func:`ste_norm_aggregate` computes it without materializing B or the
normalized matrix: the O(N) degree scalings stay in PyTorch, and the
O(N^2 d) product

    core(A, t)[i, c] = sum_j bin_diag(A)[j, i] * t[j, c]

is the hand-written CUDA kernel ``csrc/core_spmm.cu`` (which replaces the
Pallas ``_core_kernel``). :data:`core` launches it for CUDA tensors and
takes its plain version :func:`core_reference` only for CPU tensors.

Gradients. The STE backward is the exact composite of ``_ste_bwd`` /
``_norm_bwd``: the degree-normalization term, the masked/sign STE, a zero
gradient on the forced diagonal and the symmetrization. Each backward is
built from differentiable ops (``core`` itself is a differentiable
Function whose t-gradient is the transposed ``core``), recomputing what it
needs from the saved inputs, so the marglik hyperstep can differentiate the
KFAC pullbacks that run through it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .cuda_build import load

BM, BK = 64, 64          # the kernel's row tile and reduction step


def core_reference(adj: torch.Tensor, t: torch.Tensor, threshold: float = 0.5,
                   binarize: bool = True, transpose: bool = False
                   ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``_core_xla``), in t's dtype:
    ``bin_diag(M)^T @ t`` with ``M = adj.T if transpose else adj``."""
    m = adj.T if transpose else adj
    if binarize:
        b = (m > threshold).to(t.dtype)
        b.fill_diagonal_(1.0)
    else:
        b = m.to(t.dtype)
    return b.T @ t


def _col_tile(d: int) -> int:
    return 8 if d <= 8 else 16 if d <= 16 else 32 if d <= 32 else 64


class CoreKernel:
    """Wrapper of the ``core_spmm`` CUDA kernel with a launch counter."""

    name = "core_spmm"
    source = "laplace_gnn_torch/csrc/core_spmm.cu"

    def __init__(self):
        self.launches = 0
        self._sms: dict = {}
        self._fn = None

    def _entry(self):
        """The C entry point, built and typed on first use."""
        if self._fn is None:
            fn = load("core_spmm").core_spmm_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_int] * 4 + [ctypes.c_float]
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            self._fn = fn
        return self._fn

    def __call__(self, adj: torch.Tensor, t: torch.Tensor,
                 threshold: float = 0.5, binarize: bool = True,
                 transpose: bool = False) -> torch.Tensor:
        if adj.device.type == "cpu" and t.device.type == "cpu":
            return core_reference(adj, t, threshold, binarize, transpose)
        if not (adj.is_cuda and t.is_cuda and adj.device == t.device):
            raise ValueError(f"core: adj on {adj.device} and t on {t.device};"
                             " both must be on one CUDA device or the CPU")
        return self._launch(adj, t, threshold, binarize, transpose)

    def split(self, n: int, d: int, device) -> tuple[int, int]:
        """(splits, k_per_split) of the reduction axis: enough blocks for
        about two per SM."""
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
        blocks = math.ceil(n / BM) * math.ceil(d / _col_tile(d))
        splits = max(1, min(math.ceil(2 * self._sms[device] / blocks),
                            math.ceil(n / BK)))
        k = math.ceil(math.ceil(n / splits) / BK) * BK
        return math.ceil(n / k), k

    def _launch(self, adj, t, threshold, binarize, transpose):
        if adj.dtype not in (torch.float32, torch.int8):
            raise TypeError(f"core: adj must be float32 or int8, got {adj.dtype}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"core: t must be float32 or bfloat16, got {t.dtype}")
        if adj.dim() != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"core: adj must be square (N, N), got {tuple(adj.shape)}")
        if t.dim() != 2 or t.shape[0] != adj.shape[0]:
            raise ValueError(f"core: t must be (N, d) with N={adj.shape[0]}, "
                             f"got {tuple(t.shape)}")
        if not (adj.is_contiguous() and t.is_contiguous()):
            raise ValueError("core: adj and t must be contiguous")
        n, d = t.shape
        if n * n >= 2 ** 62 or d >= 2 ** 31:
            raise ValueError("core: shape too large")
        out = torch.zeros((n, d), dtype=torch.float32, device=t.device)
        if n == 0 or d == 0:
            return out.to(t.dtype)
        splits, k = self.split(n, d, t.device)
        # 16-byte loads along A's rows and t's rows where they are aligned
        vec_a = n % 4 == 0 and adj.data_ptr() % 16 == 0
        vec_t = (d % 4 == 0 and t.dtype == torch.float32
                 and t.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = self._entry()(
            adj.data_ptr(), int(adj.dtype == torch.int8), t.data_ptr(),
            int(t.dtype == torch.bfloat16), out.data_ptr(), n, d, splits, k,
            float(threshold), int(binarize), int(transpose), int(vec_a),
            int(vec_t), stream)
        if rc != 0:
            raise RuntimeError(f"core_spmm launch failed with CUDA error {rc}")
        self.launches += 1
        return out if t.dtype == torch.float32 else out.to(t.dtype)


core = CoreKernel()


class _CoreFn(torch.autograd.Function):
    """Differentiable ``core``: its t-gradient is the transposed ``core``;
    a binarized A has no gradient, a raw float A has ``t g^T``."""

    @staticmethod
    def forward(adj, t, threshold, binarize, transpose):
        return core(adj, t.contiguous(), threshold, binarize, transpose)

    @staticmethod
    def setup_context(ctx, inputs, output):
        adj, t, threshold, binarize, transpose = inputs
        ctx.save_for_backward(adj, t)
        ctx.flags = (threshold, binarize, transpose)

    @staticmethod
    def backward(ctx, g):
        adj, t = ctx.saved_tensors
        threshold, binarize, transpose = ctx.flags
        g_t = g_a = None
        if ctx.needs_input_grad[1]:
            g_t = core_fn(adj, g, threshold, binarize, not transpose)
        if ctx.needs_input_grad[0] and not binarize:
            g_a = (g @ t.T if transpose else t @ g.T).to(adj.dtype)
        return g_a, g_t, None, None, None


def core_fn(adj, t, threshold=0.5, binarize=True, transpose=False):
    return _CoreFn.apply(adj, t, threshold, binarize, transpose)


# ---------------------------------------------------------------------------
# STE-GCN: binarize + self-loops + normalize + aggregate
# ---------------------------------------------------------------------------

def _sym(adj, symmetric):
    return ((adj + adj.T) / 2).contiguous() if symmetric else adj.contiguous()


def _ste_degree(a_sym, threshold, dtype):
    """rsqrt of the row degree of bin_diag(a_sym) (self-loop forced)."""
    b = a_sym > threshold
    r = b.sum(dim=1, dtype=dtype) - torch.diagonal(b).to(dtype) + 1.0
    return torch.where(r > 0, torch.rsqrt(torch.clamp(r, min=1e-38)),
                       torch.zeros_like(r))


class _SteNormAggregate(torch.autograd.Function):
    """``a_sym`` and ``d`` come in precomputed and detached: every use of
    them is through the threshold, which has no gradient, so saving them
    (instead of recomputing per backward) loses no derivative path."""

    @staticmethod
    def forward(adj, s, a_sym, d, threshold, symmetric, sign_grad, grad_mask):
        v = core(a_sym, (d[:, None] * s).contiguous(), threshold, True)
        return d[:, None] * v

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, s, a_sym, d, threshold, symmetric, sign_grad, grad_mask = inputs
        ctx.flags = (threshold, symmetric, sign_grad, grad_mask is not None)
        ctx.save_for_backward(s, a_sym, d, grad_mask)

    @staticmethod
    def backward(ctx, g):
        s, a_sym, d, grad_mask = ctx.saved_tensors
        threshold, symmetric, sign_grad, has_mask = ctx.flags
        g_v = d[:, None] * g
        # B @ g_v: the transposed core reads a_sym in place
        Bg = core_fn(a_sym, g_v, threshold, True, True)
        ds = d[:, None] * Bg
        if not ctx.needs_input_grad[0]:
            return None, ds, None, None, None, None, None, None
        # recomputed from s, so the outer derivative sees the path
        t = d[:, None] * s
        v = core_fn(a_sym, t, threshold, True, False)
        # direct term G_B[j, i] = t[j] . g_v[i], plus the degree term
        G_B = t @ g_v.T
        gd = torch.sum(g * v, dim=1) + torch.sum(Bg * s, dim=1)
        zero = torch.zeros_like(d)
        r = torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-38) ** 2, zero)
        gr = torch.where(d > 0, -0.5 * gd * d / torch.clamp(r, min=1e-38),
                         zero)
        G_B = G_B + gr[:, None]
        # the forced diagonal carries no gradient
        eye = torch.eye(G_B.shape[0], dtype=torch.bool, device=G_B.device)
        G_B = torch.where(eye, torch.zeros_like(G_B), G_B)
        if has_mask:
            G_B = G_B * grad_mask
        if sign_grad:
            G_B = torch.sign(G_B)
        if symmetric:
            G_B = (G_B + G_B.T) / 2
        return G_B, ds, None, None, None, None, None, None


def ste_norm_aggregate(adj: torch.Tensor, s: torch.Tensor,
                       threshold: float = 0.5, symmetric: bool = False,
                       sign_grad: bool = False,
                       grad_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``normalize(fill_diag(binarize(sym(adj), threshold), 1)) @ s``,
    fused, with straight-through gradients into ``adj``."""
    with torch.no_grad():
        a_sym = _sym(adj, symmetric)
        d = _ste_degree(a_sym, threshold, s.dtype)
    return _SteNormAggregate.apply(adj, s, a_sym, d, threshold, symmetric,
                                   sign_grad, grad_mask)


# ---------------------------------------------------------------------------
# GCN: normalize + aggregate over an adjacency that already has self-loops
# ---------------------------------------------------------------------------

def _norm_degree(adj):
    r = adj.sum(dim=1)
    d = torch.where(r > 0, torch.rsqrt(torch.clamp(r, min=1e-38)),
                    torch.zeros_like(r))
    return r, d


class _NormAggregate(torch.autograd.Function):

    @staticmethod
    def forward(adj, s):
        _, d = _norm_degree(adj)
        v = core(adj.contiguous(), (d[:, None] * s).contiguous(),
                 binarize=False)
        return d[:, None] * v

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        adj, s = ctx.saved_tensors
        r, d = _norm_degree(adj)
        g_v = d[:, None] * g
        Bg = core_fn(adj, g_v, binarize=False, transpose=True)   # adj @ g_v
        ds = d[:, None] * Bg
        if not ctx.needs_input_grad[0]:
            return None, ds
        t = d[:, None] * s
        v = core_fn(adj, t, binarize=False)
        G_A = t @ g_v.T                                          # exact
        gd = torch.sum(g * v, dim=1) + torch.sum(Bg * s, dim=1)
        gr = torch.where(r > 0, -0.5 * gd * d / torch.clamp(r, min=1e-38),
                         torch.zeros_like(r))
        return G_A + gr[:, None], ds


def norm_aggregate(adj: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``normalize(adj) @ s`` fused (no binarization; exact gradients)."""
    return _NormAggregate.apply(adj, s)


class StaticNormAdjOp:
    """Frozen-graph aggregation with the binary adjacency packed as int8,
    read at one byte per entry by the kernel. The normalization is folded
    into the float32 degree vector, as ``normalize_adj`` does it."""

    def __init__(self, adj: torch.Tensor):
        _, d = _norm_degree(adj)
        self.d = d.to(torch.float32)
        self.adj_i8 = adj.to(torch.int8).contiguous()
        self.n = adj.shape[0]

    def spmm(self, s: torch.Tensor) -> torch.Tensor:
        t = self.d[:, None] * s
        v = core_fn(self.adj_i8, t, binarize=False)
        return self.d[:, None] * v
