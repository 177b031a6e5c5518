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
from typing import NamedTuple, Optional

import torch

from .cuda_build import Kernel, route, sm_count

NEG_BIG = -1e30          # floor of the running max, as in the TPU kernel
ROW_BLOCK = 256          # target rows per block of the plain versions
THREADS = 256            # threads of a backward block; a forward one at most
MAX_F = 64               # widest per-head feature axis the kernels take
MAX_SPLIT = 8            # a split's blocks form one portable cluster
# mirrors of what csrc/flash_attention.cu compiles, which owns them:
FWD_MAX_ROWS = 8         # target rows a forward block, at most
FWD_ROW_BYTES = 1024     # bytes of each adjacency row in a forward tile
BWD_MAX_COLS = 128       # source columns a backward block, at most
BWD_TILE_ROWS = {torch.float32: 64, torch.int8: 128}   # rows a bwd tile
RING_STAGES = 3          # depth of the adjacency ring, both kernels
# features a kernel instance is compiled for (the smallest that covers F)
F_BLOCKS = (1, 8, 16, 32, 64)
# (column, head) pairs a backward thread accumulates, by compiled F
BWD_PAIRS = {1: 4, 8: 4, 16: 2, 32: 1, 64: 1}
# blocks of 256 threads an SM holds (the kernels' __launch_bounds__
# minimum), by F; a forward block of fewer threads fits that many times
# more, as far as its shared memory allows (~3 KB a row: 64 // rows)
BLOCKS_PER_SM = {1: 2, 8: 2, 16: 2, 32: 1, 64: 1}


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
    """Validate what the CUDA kernels take, on one CUDA device; returns
    (n, R, H, F)."""
    tensors = (alpha_src, alpha_dst, adj, h) + tuple(extra)
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


class Plan(NamedTuple):
    block: int        # target rows (forward) or source columns (backward)
    tile: tuple       # (rows, columns) of an adjacency tile in the ring
    split: int        # ranges of the walked axis, one block each
    per_split: int    # columns (fwd) or rows (bwd) a range; whole tiles
    vec: int          # copy width of the adjacency in bytes: 16 .. 1
    stages: int       # depth of the ring (reported only)


def _cdiv(x: int, m: int) -> int:
    return (x + m - 1) // m


def _pow2_floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def f_block(f: int) -> int:
    """The compiled feature width that covers ``f``."""
    return next(b for b in F_BLOCKS if b >= f)


def plan(n: int, r: int, heads: int, f: int, adj_dtype: torch.dtype,
         adj_ptr: int, sms: int, backward: bool) -> Plan:
    """How a kernel walks the (r, n) adjacency of ``adj_dtype`` at
    ``adj_ptr`` for ``heads`` heads of ``f`` features, on a card of ``sms``
    streaming multiprocessors (132 on an H100 SXM, 114 on a PCIe one).

    - Forward: a block owns ``block`` target rows x every head (one thread
      a (row, head) pair: the largest power of two <= 8 that fits 256
      threads, 64 threads at 8 heads, or half that when the smaller
      blocks still fill a wave: more, smaller blocks an SM hide the
      edges' gathers better at N = 16384, fewer are faster at 2708) and
      walks the source axis in tiles of 1 KB of each row (256 f32 or 1024
      int8 columns).
    - Backward: a block of 256 threads owns ``block`` source columns x
      every head, 128 columns (512 bytes of an f32 row) unless the heads
      and the compiled feature width leave fewer (``BWD_PAIRS`` pairs a
      thread), and walks the target axis in tiles of 64 (f32) or 128
      (int8) rows.
    - Split: when the blocks fill less than one wave (the blocks an SM
      holds x ``sms``), the walked axis is split into S <= ``MAX_SPLIT``
      ranges of whole tiles, so the grid fills that wave and no more; the
      S partials are summed in a fixed order (the forward's in one
      cluster, the backward's by its reduce kernel).
    - Copy width: the largest of 16, 8, 4, 2, 1 bytes that divides the
      pointer and the row length in bytes (and, backward, the block's
      columns in bytes, where a block starts)."""
    if adj_dtype not in (torch.float32, torch.int8):
        raise TypeError(f"flash: adj must be float32 or int8, got "
                        f"{adj_dtype}")
    if not (1 <= f <= MAX_F and 1 <= heads <= THREADS and n >= 1 and r >= 1):
        raise ValueError(f"flash: the kernels take 1 <= F <= {MAX_F}, "
                         f"1 <= H <= {THREADS} and N, R >= 1; got F={f}, "
                         f"H={heads}, N={n}, R={r}")
    es = adj_dtype.itemsize
    fb = f_block(f)
    if backward:
        wave = BLOCKS_PER_SM[fb] * sms
        block = _pow2_floor(min(BWD_MAX_COLS,
                                THREADS * BWD_PAIRS[fb] // heads))
        tile = (BWD_TILE_ROWS[adj_dtype], block)
        blocks, walked, step = _cdiv(n, block), r, tile[0]
    else:
        def wave_of(rows):
            return min(64 // rows, BLOCKS_PER_SM[fb] * THREADS
                       // fwd_threads(rows, heads)) * sms
        block = _pow2_floor(min(FWD_MAX_ROWS, THREADS // heads))
        if block > 1 and _cdiv(r, block // 2) >= wave_of(block // 2):
            block //= 2
        wave = wave_of(block)
        tile = (block, FWD_ROW_BYTES // es)
        blocks, walked, step = _cdiv(r, block), n, tile[1]
    # a backward block's rows start block * es bytes after the previous one
    align = adj_ptr | (n * es) | (block * es if backward else 0)
    vec = next(v for v in (16, 8, 4, 2, 1) if align % v == 0)
    if vec < es:
        raise ValueError("flash: adj must be aligned to its element")
    tiles = _cdiv(walked, step)
    split = max(1, min(MAX_SPLIT, tiles, wave // blocks))
    per_split = _cdiv(tiles, split) * step
    return Plan(block=block, tile=tile, split=_cdiv(walked, per_split),
                per_split=per_split, vec=vec, stages=RING_STAGES)


def fwd_threads(rows: int, heads: int) -> int:
    """Threads of a forward block: its (row, head) pairs in whole warps."""
    return _cdiv(rows * heads, 32) * 32


def bwd_workspace(p: Plan, n: int, r: int, heads: int, f: int) -> int:
    """Floats of the backward's workspace: one (R, H) partial of d_a_dst a
    block of source columns, and with a split target axis, the S partials
    of d_a_src (N, H) and d_x (N, H, F)."""
    floats = _cdiv(n, p.block) * r * heads
    if p.split > 1:
        floats += p.split * n * heads * (f + 1)
    return floats


def _argtypes(n_ptr: int) -> list:
    """The entry points' C signature: ``n_ptr`` tensors, then
    :func:`_scalars`, then the stream."""
    return ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _scalars(adj, n, R, H, F, slope, cd, p: Plan, device) -> tuple:
    """The arguments after the tensors, in both entry points' order."""
    return (int(adj.dtype == torch.int8), n, R, H, F, float(slope),
            int(cd is not None), p.block, p.split, p.per_split, p.vec,
            torch.cuda.current_stream(device).cuda_stream)


class FlashForwardKernel(Kernel):
    """Wrapper of the forward kernel ``flash_fwd_kernel``: one launch a
    call. With a split source axis the S partials of each (row, head) are
    merged in rank order inside one thread-block cluster, so every output
    is written once (``torch.empty``, no fill) and two calls give the same
    bits."""

    def __init__(self):
        super().__init__("flash_fwd", "flash_attention", "flash_fwd_launch",
                         _argtypes(7))

    def __call__(self, alpha_src, alpha_dst, adj, h, negative_slope=0.2,
                 attn_dtype=None):
        cd = _attn_dtype(attn_dtype)
        if route(self.name, alpha_src, alpha_dst, adj, h) == "plain":
            return flash_fwd_reference(alpha_src, alpha_dst, adj, h,
                                       negative_slope, cd)
        n, R, H, F = _check(self.name, alpha_src, alpha_dst, adj, h)
        out = torch.empty((R, H, F), dtype=h.dtype, device=h.device)
        m = torch.empty((H, R), dtype=h.dtype, device=h.device)
        l = torch.empty((H, R), dtype=h.dtype, device=h.device)
        if R:
            p = plan(n, R, H, F, adj.dtype, adj.data_ptr(),
                     sm_count(adj.device), backward=False)
            self.launch(*(t.data_ptr() for t in (alpha_src, alpha_dst, adj,
                                                  h, out, m, l)),
                        *_scalars(adj, n, R, H, F, negative_slope, cd, p,
                                  h.device))
        return out, m, l


class FlashBackwardKernel(Kernel):
    """Wrapper of the backward kernel ``flash_bwd_kernel``. ``D`` and
    ``linv`` are formed here, in PyTorch, as the JAX package forms them
    outside Pallas. It is bound by reading the adjacency once, like the
    forward. Nothing is summed with atomics: ``d_alpha_dst`` is written as
    one partial a block of source columns into a workspace, and with a
    split target axis so are the partials of ``d_alpha_src`` and ``d_h``;
    a second small kernel sums each over its blocks in order. One counted
    launch is two device launches; every output and the workspace come
    from ``torch.empty``, and two calls give the same bits."""

    def __init__(self):
        super().__init__("flash_bwd", "flash_attention", "flash_bwd_launch",
                         _argtypes(12))

    def __call__(self, alpha_src, alpha_dst, adj, h, g, out, m, l,
                 negative_slope=0.2, attn_dtype=None):
        cd = _attn_dtype(attn_dtype)
        if route(self.name, alpha_src, alpha_dst, adj, h, g, out, m,
                 l) == "plain":
            return flash_bwd_reference(alpha_src, alpha_dst, adj, h, g, out,
                                       m, l, negative_slope, cd)
        n, R, H, F = _check(self.name, alpha_src, alpha_dst, adj, h,
                            (g, out, m, l))
        if (tuple(g.shape) != (R, H, F) or tuple(out.shape) != (R, H, F)
                or tuple(m.shape) != (H, R) or tuple(l.shape) != (H, R)):
            raise ValueError(f"{self.name}: g and out must be ({R}, {H}, "
                             f"{F}) and m, l ({H}, {R})")
        D, linv = _bwd_stats(g, out, l)
        g_asrc = torch.empty_like(alpha_src)
        g_adst = torch.empty_like(alpha_dst)
        g_h = torch.empty_like(h)
        if R:
            p = plan(n, R, H, F, adj.dtype, adj.data_ptr(),
                     sm_count(adj.device), backward=True)
            ws = torch.empty(bwd_workspace(p, n, R, H, F), dtype=h.dtype,
                             device=h.device)
            self.launch(*(t.data_ptr() for t in (alpha_src, alpha_dst, adj,
                                                  h, g, m, linv, D, g_asrc,
                                                  g_adst, g_h, ws)),
                        *_scalars(adj, n, R, H, F, negative_slope, cd, p,
                                  h.device))
        else:
            g_asrc.zero_()
            g_h.zero_()
        return g_asrc, g_adst, g_h


flash_fwd = FlashForwardKernel()
flash_bwd = FlashBackwardKernel()


class FlashMaskedAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. It
    returns ``(out, m, l)``; the statistics are not differentiable.

    Both kernels are bound by reading the adjacency once (1.07 GB of
    float32 at N = 16384); both sum in a fixed order (a split's partials
    merged in rank order, per-block partials of d_alpha_dst reduced in
    order, no atomics), so the forward and the gradients repeat to the
    bit on one card.

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
