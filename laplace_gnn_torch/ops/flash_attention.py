"""Fused masked GAT attention: online-softmax forward and flash backward.

Counterpart of ``laplace_gnn_tpu/ops/pallas_attention.py``. The forward
computes, for target rows i and source columns j,

    s[i, j, h] = leaky_relu(alpha_src[j, h] + alpha_dst[i, h])  where adj[i, j] > 0
    m[h, i]    = max(max_j s[i, j, h], -1e30)
    l[h, i]    = sum_j exp(s[i, j, h] - m[h, i])
    out[i, h]  = sum_j exp(s[i, j, h] - m[h, i]) h[j, h] / l[h, i]  (0 where l = 0)

and keeps the statistics ``(m, l)`` for the backward, which recomputes the
normalized weights ``p = exp(act - m) / l`` and forms

    dp = g h^T,   ds = p (dp - D),   D = rowsum(g * out),
    dz = ds leaky'(z),   d_alpha_src = sum_i dz,   d_alpha_dst = sum_j dz,
    d_h = p^T g.

Both directions are hand-written CUDA kernels (``csrc/flash_attention.cu``)
that replace the Pallas ``_flash_kernel`` and ``_flash_bwd_kernel``. The
wrappers :data:`flash_fwd` and :data:`flash_bwd` launch them for CUDA
tensors and take the plain versions :func:`flash_fwd_reference` and
:func:`flash_bwd_reference` only for CPU tensors. The plain versions work
in blocks of target rows, so they never hold an (N, N, H) tensor.

``adj`` may cover only R <= N target rows (a row shard: ``adj`` (R, N),
``alpha_dst`` (R, H)); sources always span ``alpha_src`` and ``h``. It is
read only through ``adj > 0`` (float32 or int8), so it gets no gradient.
``attn_dtype="bfloat16"`` rounds the operands of the two ``p``/``h``/``g``
contractions to bf16, with float32 sums; the softmax stays in float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import load

NEG_BIG = -1e30          # floor of the running max, as in the TPU kernel
ROW_BLOCK = 256          # target rows per block of the plain versions
THREADS = 256            # threads per block of both kernels
MAX_F = 64               # widest per-head feature axis the kernels take


def _attn_dtype(attn_dtype) -> Optional[torch.dtype]:
    if attn_dtype is None:
        return None
    if attn_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"attn_dtype must be None or 'bfloat16', got "
                     f"{attn_dtype!r}")


def _round(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back (no-op for None)."""
    return x if dtype is None else x.to(dtype).to(x.dtype)


def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z >= 0, z, slope * z)


def _bwd_stats(g: torch.Tensor, out: torch.Tensor, l: torch.Tensor):
    """(D, linv), both (H, R): the softmax correction D = rowsum(g * out)
    and the inverse denominator, 0 where l = 0 (rows with no neighbour get
    all-zero gradients)."""
    D = torch.sum(g * out, dim=-1).T.contiguous()
    linv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, torch.ones_like(l)),
                       torch.zeros_like(l))
    return D, linv.contiguous()


def flash_fwd_reference(alpha_src, alpha_dst, adj, h, negative_slope=0.2,
                        attn_dtype=None, row_block: int = ROW_BLOCK):
    """Plain PyTorch version of the forward kernel: ``(out (R, H, F),
    m (H, R), l (H, R))`` in ``h``'s dtype."""
    cd = _attn_dtype(attn_dtype)
    R = adj.shape[0]
    H, F = h.shape[1], h.shape[2]
    out = h.new_empty((R, H, F))
    m = h.new_empty((H, R))
    l = h.new_empty((H, R))
    hc = _round(h, cd)
    for r0 in range(0, R, row_block):
        r1 = min(R, r0 + row_block)
        valid = (adj[r0:r1] > 0)[:, :, None]                    # (b, N, 1)
        s = _leaky(alpha_src[None] + alpha_dst[r0:r1, None], negative_slope)
        s = torch.where(valid, s, torch.full_like(s, float("-inf")))
        mb = torch.clamp(torch.amax(s, dim=1), min=NEG_BIG)     # (b, H)
        p = torch.exp(s - mb[:, None])                          # masked -> 0
        lb = torch.sum(p, dim=1)
        acc = torch.einsum("bjh,jhf->bhf", _round(p, cd), hc)
        out[r0:r1] = acc / torch.where(lb == 0, torch.ones_like(lb),
                                       lb)[..., None]
        m[:, r0:r1] = mb.T
        l[:, r0:r1] = lb.T
    return out, m, l


def flash_bwd_reference(alpha_src, alpha_dst, adj, h, g, out, m, l,
                        negative_slope=0.2, attn_dtype=None,
                        row_block: int = ROW_BLOCK):
    """Plain PyTorch version of the backward kernel, with ``D`` and
    ``linv`` formed as the wrapper forms them: ``(d_alpha_src (N, H),
    d_alpha_dst (R, H), d_h (N, H, F))``."""
    cd = _attn_dtype(attn_dtype)
    R = adj.shape[0]
    D, linv = _bwd_stats(g, out, l)
    g_asrc = torch.zeros_like(alpha_src)
    g_adst = torch.zeros_like(alpha_dst)
    g_h = torch.zeros_like(h)
    hc, gc = _round(h, cd), _round(g, cd)
    for r0 in range(0, R, row_block):
        r1 = min(R, r0 + row_block)
        valid = (adj[r0:r1] > 0)[:, :, None]
        z = alpha_src[None] + alpha_dst[r0:r1, None]            # (b, N, H)
        act = _leaky(z, negative_slope)
        dact = torch.where(z >= 0, torch.ones_like(z),
                           torch.full_like(z, negative_slope))
        # the exponent is -inf on invalid entries before exp
        e = torch.exp(torch.where(valid, act - m[:, r0:r1].T[:, None],
                                  torch.full_like(act, float("-inf"))))
        p = e * linv[:, r0:r1].T[:, None]
        dp = torch.einsum("bhf,jhf->bjh", gc[r0:r1], hc)
        dz = p * (dp - D[:, r0:r1].T[:, None]) * dact
        g_adst[r0:r1] = torch.sum(dz, dim=1)
        g_asrc += torch.sum(dz, dim=0)
        g_h += torch.einsum("bjh,bhf->jhf", _round(p, cd), gc[r0:r1])
    return g_asrc, g_adst, g_h


def _check(name, alpha_src, alpha_dst, adj, h, extra=()):
    """Validate what the CUDA kernels take; returns (n, R, H, F)."""
    tensors = (alpha_src, alpha_dst, adj, h) + tuple(extra)
    dev = h.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}; all "
                         "must be on one CUDA device or all on the CPU")
    for t in (alpha_src, alpha_dst, h) + tuple(extra):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: scores, values and gradients must be "
                            f"float32, got {t.dtype}")
    if adj.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"{name}: adj must be float32 or int8, got "
                        f"{adj.dtype}")
    if h.dim() != 3:
        raise ValueError(f"{name}: h must be (N, H, F), got {tuple(h.shape)}")
    n, H, F = h.shape
    R = adj.shape[0]
    if (adj.dim() != 2 or adj.shape[1] != n
            or tuple(alpha_src.shape) != (n, H)
            or tuple(alpha_dst.shape) != (R, H)):
        raise ValueError(
            f"{name}: expected alpha_src ({n}, {H}), alpha_dst (R, {H}), "
            f"adj (R, {n}); got {tuple(alpha_src.shape)}, "
            f"{tuple(alpha_dst.shape)}, {tuple(adj.shape)}")
    if not 1 <= F <= MAX_F or H > THREADS:
        raise ValueError(f"{name}: the kernels take 1 <= F <= {MAX_F} and "
                         f"H <= {THREADS}, got F={F}, H={H}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all tensors must be contiguous")
    if R * n >= 2 ** 62 or max(n, R) * H * F >= 2 ** 31:
        raise ValueError(f"{name}: shape too large")
    return n, R, H, F


def _vec(adj: torch.Tensor, n: int) -> int:
    """1 when every adjacency row can be read with 16-byte loads."""
    per16 = 16 // adj.element_size()
    return int(n % per16 == 0 and adj.data_ptr() % 16 == 0)


class _FlashKernel:
    """Shared part of the two wrappers: the library entry and a launch
    counter that only the launch itself increments."""

    source = "laplace_gnn_torch/csrc/flash_attention.cu"
    symbol = ""
    n_ptr = 0

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = getattr(load("flash_attention"), self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * self.n_ptr + [ctypes.c_int] * 5
                           + [ctypes.c_float] + [ctypes.c_int] * 2
                           + [ctypes.c_void_p])
            self._fn = fn
        return self._fn

    def _run(self, ptrs, adj, n, R, H, F, slope, cd, device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = self._entry()(*ptrs, int(adj.dtype == torch.int8), n, R, H, F,
                           float(slope), int(cd is not None), _vec(adj, n),
                           stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error "
                               f"{rc}")
        self.launches += 1


class FlashForwardKernel(_FlashKernel):
    """Wrapper of the forward kernel ``flash_fwd_kernel``."""

    name = "flash_fwd"
    symbol = "flash_fwd_launch"
    n_ptr = 7

    def __call__(self, alpha_src, alpha_dst, adj, h, negative_slope=0.2,
                 attn_dtype=None):
        cd = _attn_dtype(attn_dtype)
        if all(t.device.type == "cpu" for t in (alpha_src, alpha_dst, adj, h)):
            return flash_fwd_reference(alpha_src, alpha_dst, adj, h,
                                       negative_slope, cd)
        n, R, H, F = _check(self.name, alpha_src, alpha_dst, adj, h)
        out = h.new_zeros((R, H, F))
        m = h.new_full((H, R), NEG_BIG)
        l = h.new_zeros((H, R))
        if R and n:
            self._run([t.data_ptr() for t in (alpha_src, alpha_dst, adj, h,
                                              out, m, l)],
                      adj, n, R, H, F, negative_slope, cd, h.device)
        return out, m, l


class FlashBackwardKernel(_FlashKernel):
    """Wrapper of the backward kernel ``flash_bwd_kernel``. ``D`` and
    ``linv`` are formed here, in PyTorch, as the JAX package forms them
    outside Pallas; ``d_alpha_dst`` is summed in the kernel with float32
    atomics, so its summation order changes from run to run."""

    name = "flash_bwd"
    symbol = "flash_bwd_launch"
    n_ptr = 11

    def __call__(self, alpha_src, alpha_dst, adj, h, g, out, m, l,
                 negative_slope=0.2, attn_dtype=None):
        cd = _attn_dtype(attn_dtype)
        tensors = (alpha_src, alpha_dst, adj, h, g, out, m, l)
        if all(t.device.type == "cpu" for t in tensors):
            return flash_bwd_reference(alpha_src, alpha_dst, adj, h, g, out,
                                       m, l, negative_slope, cd)
        n, R, H, F = _check(self.name, alpha_src, alpha_dst, adj, h,
                            (g, out, m, l))
        if (tuple(g.shape) != (R, H, F) or tuple(out.shape) != (R, H, F)
                or tuple(m.shape) != (H, R) or tuple(l.shape) != (H, R)):
            raise ValueError(f"{self.name}: g and out must be ({R}, {H}, "
                             f"{F}) and m, l ({H}, {R})")
        D, linv = _bwd_stats(g, out, l)
        g_asrc = torch.zeros_like(alpha_src)
        g_adst = torch.zeros_like(alpha_dst)     # the kernel adds into it
        g_h = torch.zeros_like(h)
        if R and n:
            self._run([t.data_ptr() for t in (alpha_src, alpha_dst, adj, h,
                                              g, m, linv, D, g_asrc, g_adst,
                                              g_h)],
                      adj, n, R, H, F, negative_slope, cd, h.device)
        return g_asrc, g_adst, g_h


flash_fwd = FlashForwardKernel()
flash_bwd = FlashBackwardKernel()


class FlashMaskedAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. It
    returns ``(out, m, l)``; the statistics are not differentiable.

    The backward kernel has no derivative of its own (nor has the Pallas
    backward in JAX), so a backward with ``create_graph=True`` raises
    instead of returning a wrong second derivative; curvature code runs
    on ``model.jvp_safe()``, which routes around this Function."""

    @staticmethod
    def forward(alpha_src, alpha_dst, adj, h, negative_slope, attn_dtype):
        return flash_fwd(alpha_src, alpha_dst, adj, h, negative_slope,
                         attn_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        alpha_src, alpha_dst, adj, h, negative_slope, attn_dtype = inputs
        out, m, l = output
        ctx.mark_non_differentiable(m, l)
        ctx.save_for_backward(alpha_src, alpha_dst, adj, h, out, m, l)
        ctx.flags = (negative_slope, attn_dtype)

    @staticmethod
    def backward(ctx, g, _g_m, _g_l):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "flash_masked_attention has no second derivative (its "
                "backward is a kernel); differentiate model.jvp_safe(), "
                "which runs the plain attention, instead")
        alpha_src, alpha_dst, adj, h, out, m, l = ctx.saved_tensors
        negative_slope, attn_dtype = ctx.flags
        g_as, g_ad, g_h = flash_bwd(alpha_src, alpha_dst, adj, h,
                                    g.contiguous(), out, m, l,
                                    negative_slope, attn_dtype)
        # adj enters only through adj > 0: a structural zero gradient
        return g_as, g_ad, None, g_h, None, None


def flash_masked_attention(alpha_src: torch.Tensor, alpha_dst: torch.Tensor,
                           adj: torch.Tensor, h: torch.Tensor,
                           negative_slope: float = 0.2,
                           attn_dtype=None) -> torch.Tensor:
    """Fused masked GAT attention, ``(R, H, F)``; the signature of
    ``GATConv``'s ``attention_impl`` hook. Forward and backward are the
    CUDA kernels on the GPU and their plain versions on the CPU."""
    out, _, _ = FlashMaskedAttention.apply(
        alpha_src.contiguous(), alpha_dst.contiguous(), adj.contiguous(),
        h.contiguous(), negative_slope, attn_dtype)
    return out
