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
Pallas ``_core_kernel``), one launch a call; :func:`plan` chooses its tile,
split and copy widths. :data:`core` launches it for CUDA tensors and takes
its plain version :func:`core_reference` only for CPU tensors.

Gradients. The STE backward is the exact composite of ``_ste_bwd`` /
``_norm_bwd``: the degree-normalization term, the masked/sign STE, a zero
gradient on the forced diagonal and the symmetrization. Each backward is
built from differentiable ops (``core`` itself is a differentiable
Function whose t-gradient is the transposed ``core``), recomputing what it
needs from the saved inputs, so the marglik hyperstep can differentiate the
KFAC pullbacks that run through it.

Inputs. ``a_sym`` (the symmetrized adjacency) and ``d`` (the rsqrt degrees)
follow from the adjacency's value alone. :func:`ste_norm_aggregate` forms
them on every call; :class:`SteForms`, which the fused STE-GCN holds,
forms them once per value and hands the same buffers to every call.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Optional

import torch

from ..profiling import _capturing, count
from .cuda_build import Kernel, route, sm_count

BM = 128                  # the kernel's row tile (rows of out)
SKINNY_BN = (8, 32, 64)   # column tiles for d <= 64: t's columns in one tile
WIDE_BN = (128, 256)      # column tiles for wider t: 128 up to d = 128
# the K steps that core_spmm.cu compiles (Layout::BK): skinny tiles take
# 128 bytes of an f32 A's rows and 64 of an int8 A's; wide tiles 16
SKINNY_BK = {torch.float32: 32, torch.int8: 64}
WIDE_BK = 16
# blocks of each column tile that an SM holds at once: a mirror of
# Tile::MIN_BLOCKS in core_spmm.cu, its __launch_bounds__ minimum, for
# which registers are capped and shared memory is sized
BLOCKS_PER_SM = {8: 2, 32: 2, 64: 2, 128: 2, 256: 1}
# the ring depth core_spmm.cu compiles (Layout::STAGES), which owns it;
# reported by the plan, not passed to the kernel
RING_STAGES = {"skinny": 3, "wide": 4}
MAX_SPLIT = 8             # the split's blocks form one portable cluster
MIN_STEPS_PER_SPLIT = 2   # K steps each split keeps at least


def _cdiv(x: int, m: int) -> int:
    return (x + m - 1) // m


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


class Plan(NamedTuple):
    tile: tuple        # (BM, BN, BK): rows of out, columns of out, K step
    stages: int        # depth of the shared-memory ring (reported only)
    split: int         # j ranges, one block each, summed in one cluster
    k_per_split: int   # a multiple of BK; the last range may be shorter
    vec_a: int         # copy width of A in bytes: 16, 8, 4, 2 or 1
    vec_t: int         # copy width of t in bytes: 16, 8, 4 or 2


def _widest(align: int, widths) -> int:
    return next(v for v in widths if align % v == 0)


def plan(n: int, d: int, a_dtype: torch.dtype, t_dtype: torch.dtype,
         a_ptr: int, t_ptr: int, sms: int) -> Plan:
    """How the kernel runs ``core(A, t)`` for an (n, n) A of ``a_dtype`` at
    ``a_ptr`` and an (n, d) t of ``t_dtype`` at ``t_ptr``, on a card of
    ``sms`` streaming multiprocessors (132 on an H100 SXM, 114 on a PCIe
    one).

    - Tile: 128 rows of out; for d <= 64 the smallest skinny column tile
      of ``SKINNY_BN`` that holds every column (A is read once), else a
      wide one: 128 columns up to d = 128, 256 beyond.
    - K step: 128 bytes of an f32 A's rows (32) and 64 of an int8 A's on
      the skinny tiles, 16 on the wide ones (``SKINNY_BK``, ``WIDE_BK``).
    - Split: with fewer tiles than one wave of blocks (``BLOCKS_PER_SM``
      x ``sms``), j is split so the grid fills that wave and no more, at
      most ``MAX_SPLIT`` ways (one cluster, summed in a fixed order) and
      with at least ``MIN_STEPS_PER_SPLIT`` K steps a split.
    - Copy widths: the largest of 16, 8, 4, 2, 1 bytes that divides the
      pointer and the row length in bytes (n elements of A, d of t)."""
    if a_dtype not in (torch.float32, torch.int8):
        raise TypeError(f"core: adj must be float32 or int8, got {a_dtype}")
    if t_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"core: t must be float32 or bfloat16, got {t_dtype}")
    a_es, t_es = a_dtype.itemsize, t_dtype.itemsize
    vec_a = _widest(a_ptr | (n * a_es), (16, 8, 4, 2, 1))
    vec_t = _widest(t_ptr | (d * t_es), (16, 8, 4, 2, 1))
    if vec_a < a_es or vec_t < t_es:
        raise ValueError("core: adj and t must be aligned to their element")
    wide = d > SKINNY_BN[-1]
    bn = (WIDE_BN[0] if d <= WIDE_BN[0] else WIDE_BN[1]) if wide else next(
        b for b in SKINNY_BN if b >= d)
    bk = WIDE_BK if wide else SKINNY_BK[a_dtype]
    k_steps = _cdiv(n, bk)
    tiles = _cdiv(n, BM) * _cdiv(d, bn)
    split = max(1, min(MAX_SPLIT, BLOCKS_PER_SM[bn] * sms // tiles,
                       k_steps // MIN_STEPS_PER_SPLIT))
    k_per_split = _cdiv(k_steps, split) * bk
    return Plan(tile=(BM, bn, bk),
                stages=RING_STAGES["wide" if wide else "skinny"],
                split=_cdiv(n, k_per_split), k_per_split=k_per_split,
                vec_a=vec_a, vec_t=vec_t)


class CoreKernel(Kernel):
    """Wrapper of the ``core_spmm`` CUDA kernel."""

    def __init__(self):
        super().__init__("core_spmm", "core_spmm", "core_spmm_launch",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7
                         + [ctypes.c_float] + [ctypes.c_int] * 2
                         + [ctypes.c_void_p])

    def __call__(self, adj: torch.Tensor, t: torch.Tensor,
                 threshold: float = 0.5, binarize: bool = True,
                 transpose: bool = False) -> torch.Tensor:
        if route("core", adj, t) == "plain":
            return core_reference(adj, t, threshold, binarize, transpose)
        return self._launch(adj, t, threshold, binarize, transpose)

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
        if n * n >= 2 ** 62 or n * d >= 2 ** 62 or d >= 2 ** 31:
            raise ValueError("core: shape too large")
        # written once by the kernel, in t's dtype: no zero fill, no cast
        out = torch.empty((n, d), dtype=t.dtype, device=t.device)
        if n == 0 or d == 0:
            return out
        p = plan(n, d, adj.dtype, t.dtype, adj.data_ptr(), t.data_ptr(),
                 sm_count(t.device))
        self.launch(
            adj.data_ptr(), int(adj.dtype == torch.int8), t.data_ptr(),
            int(t.dtype == torch.bfloat16), out.data_ptr(), n, d, p.tile[1],
            p.split, p.k_per_split, p.vec_a, p.vec_t, float(threshold),
            int(binarize), int(transpose),
            torch.cuda.current_stream(t.device).cuda_stream)
        return out


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

    @staticmethod
    def vmap(info, in_dims, adj, t, threshold, binarize, transpose):
        """A batch of t's is one call with the batch folded into the
        feature axis: (B, N, d) -> (N, B * d). This is how the vmapped
        Jacobian pullbacks (curvature/interface.py) launch the kernel once
        per chunk, as JAX folds its vmapped pullback columns
        (laplace_gnn_tpu/curvature/kfac.py:308-310)."""
        if in_dims[0] is not None:
            raise NotImplementedError("core: vmap over the adjacency")
        tb = t.movedim(in_dims[1], 1)                    # (N, B, d)
        n, b, d = tb.shape
        out = _CoreFn.apply(adj, tb.reshape(n, b * d), threshold, binarize,
                            transpose)
        return out.reshape(n, b, d), 1


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
    fused, with straight-through gradients into ``adj``. Forms ``a_sym``
    and ``d`` afresh on every call (:class:`SteForms` holds them)."""
    count("ste.calls")
    count("ste.forms")
    with torch.no_grad():
        a_sym = _sym(adj, symmetric)
        d = _ste_degree(a_sym, threshold, s.dtype)
    return _SteNormAggregate.apply(adj, s, a_sym, d, threshold, symmetric,
                                   sign_grad, grad_mask)


def _plain(adj: torch.Tensor) -> Optional[torch.Tensor]:
    """``adj``, or the tensor beneath its ``torch.func`` grad wrappers,
    which has its value, storage and version counter; None where there is
    none to read: under a vmap that batches it, for a tensor subclass and
    for an inference tensor (which keeps no version)."""
    F = torch._C._functorch
    while F.is_functorch_wrapped_tensor(adj):
        if not F.is_gradtrackingtensor(adj):
            return None
        adj = F.get_unwrapped(adj)
    if type(adj) not in (torch.Tensor, torch.nn.Parameter) or \
            adj.is_inference():
        return None
    return adj


class _Held:
    """One pair of buffers: ``a_sym`` (None where ``symmetric`` is off and
    the adjacency is its own ``a_sym``) and ``d``, with the value they were
    last formed from: the adjacency's storage (a weak reference, so a new
    tensor at a freed address is a miss) and its ``key``. ``captured``:
    formed while a stream captured, so the buffers hold that value only
    once the graph replays, and only a capture may read them."""

    __slots__ = ("a_sym", "d", "storage", "key", "captured")

    def __init__(self, a_sym, d):
        self.a_sym, self.d = a_sym, d
        self.storage, self.key, self.captured = None, None, False

    def holds(self, adj, key) -> bool:
        return (self.storage is not None
                and self.storage() is adj.untyped_storage()
                and self.key == key
                and (not self.captured or _capturing()))


class SteForms:
    """``a_sym`` and ``d``, the inputs that :func:`ste_norm_aggregate`
    forms from its adjacency, held from one aggregation to the next.

    They change only with the adjacency's value, so each value is formed
    once: :meth:`aggregate` reads the held forms while the adjacency's
    storage and version counter (which ``.detach()`` shares, and every
    in-place edit bumps) are those they were formed from, and forms anew
    otherwise, by the same code as :func:`ste_norm_aggregate`. Each form
    is written into the same buffers (``copy_``), one pair per shape,
    dtypes, device and ``symmetric``, made at the first form outside a
    CUDA graph capture; so a graph captured against them reads each value
    that :meth:`form` writes. A replay runs no Python and reads no key:
    code that replays graphs calls :meth:`form` wherever the adjacency
    changes (``training/marglik_gnn.py::ScanRun``)."""

    def __init__(self):
        self._held: dict = {}

    def aggregate(self, adj, s, threshold: float = 0.5,
                  symmetric: bool = False, sign_grad: bool = False,
                  grad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:func:`ste_norm_aggregate` on the held forms of ``adj``."""
        plain = _plain(adj)
        if plain is None:
            return ste_norm_aggregate(adj, s, threshold, symmetric,
                                      sign_grad, grad_mask)
        count("ste.calls")
        held = self._held.get(_slot(plain, s.dtype, symmetric))
        if held is None or not held.holds(plain,
                                          _key(plain, threshold)):
            held = self.form(plain, threshold, symmetric, s.dtype)
        a_sym = held.a_sym
        if a_sym is None:
            with torch.no_grad():
                a_sym = _sym(adj, False)
        return _SteNormAggregate.apply(adj, s, a_sym, held.d, threshold,
                                       symmetric, sign_grad, grad_mask)

    def form(self, adj, threshold: float, symmetric: bool,
             dtype: torch.dtype) -> _Held:
        """Form ``adj``'s ``a_sym`` and its degrees in ``dtype`` now, into
        the held buffers where they exist. Outside a capture that makes
        them; inside one, with none made yet, the forms are the graph's
        own and nothing is held."""
        count("ste.forms")
        plain = _plain(adj)
        if plain is None:
            raise TypeError("SteForms.form takes an adjacency whose storage "
                            "and version can be read")
        with torch.no_grad(), torch._C._DisableFuncTorch():
            a_sym = _sym(plain, symmetric)
            d = _ste_degree(a_sym, threshold, dtype)
            slot = _slot(plain, dtype, symmetric)
            held = self._held.get(slot)
            if held is None:
                held = _Held(a_sym if symmetric else None, d)
                if _capturing():
                    return held
                self._held[slot] = held
            else:
                if symmetric:
                    held.a_sym.copy_(a_sym)
                held.d.copy_(d)
        held.storage = weakref.ref(plain.untyped_storage())
        held.key = _key(plain, threshold)
        held.captured = _capturing()
        return held


def _slot(adj, dtype, symmetric) -> tuple:
    return (tuple(adj.shape), adj.dtype, adj.device, dtype, symmetric)


def _key(adj, threshold) -> tuple:
    return (adj.storage_offset(), tuple(adj.stride()), adj._version,
            threshold)


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
