"""Blocked matrix product (counterpart of
``laplace_gnn_tpu/ops/pallas_matmul.py``).

:data:`matmul` computes ``a (M, K) @ b (K, N)`` with an f32 accumulator and
the output in ``a.dtype``. For CUDA tensors it launches the hand-written
kernel ``csrc/matmul.cu`` (which replaces the Pallas ``_matmul_kernel``):
bf16 on ``mma.sync`` tensor cores, f32 as 3xTF32, fed by a ``cp.async``
ring, with split-K for the skinny products. :func:`plan` chooses its tile,
ring depth, split and copy width. For CPU tensors it takes the plain
version :func:`matmul_reference`.

No path of the package calls it, as no path of the JAX package calls the
Pallas kernel: products that JAX leaves to XLA (``ops/spmm.py::aggregate``,
``KronDecomposed._bmm``) stay ``torch.matmul``. It is held against its
plain version and timed against cuBLAS by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import Kernel, route, sm_count

# the kernel's output tiles (BM, BN): wide, skinny (N <= 64) and narrow
WIDE, SKINNY, NARROW = (128, 128), (128, 64), (64, 64)
STEP_BYTES = 128          # the kernel's K step: 128 bytes of a row of a
# blocks of each tile that an SM holds at once: a mirror of Tile::MIN_BLOCKS
# in matmul.cu, its __launch_bounds__ minimum, for which registers are
# capped and the ring is sized (a static_assert in Layout holds the ring
# to it)
BLOCKS_PER_SM = {WIDE: 1, SKINNY: 2, NARROW: 3}
# the ring depth matmul.cu compiles for each tile (Layout::STAGES), which
# owns it; reported by the plan, not passed to the kernel
RING_STAGES = {WIDE: 3, SKINNY: 4, NARROW: 4}
# split-K fills one wave, at most two blocks an SM: more partial sums cost
# more than the extra blocks gain on the small products of chip_smoke.py
SPLIT_BLOCKS_PER_SM = 2
MAX_SPLIT = 16
MIN_STEPS_PER_SPLIT = 2   # K steps each split keeps at least


def _round_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _cdiv(x: int, m: int) -> int:
    return (x + m - 1) // m


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: upcast to at least f32, multiply, cast to
    ``a.dtype``."""
    ct = torch.promote_types(a.dtype, torch.float32)
    return (a.to(ct) @ b.to(ct)).to(a.dtype)


class Plan(NamedTuple):
    tile: tuple        # (BM, BN, BK); BK: 32 f32 or 64 bf16 (128 bytes)
    stages: int        # depth of the shared-memory ring (reported only)
    split: int         # K ranges, one block each; > 1 adds a reduce kernel
    vec: int           # copy width in bytes: 16, 8, 4 (cp.async) or 2
    k_per_split: int   # a multiple of BK; the last range may be shorter


def plan(M: int, N: int, K: int, dtype: torch.dtype, a_ptr: int, b_ptr: int,
         sms: int, bm: int = 512, bn: int = 256) -> Plan:
    """How the kernel runs ``(M, K) @ (K, N)`` in ``dtype`` for operands at
    the addresses ``a_ptr`` and ``b_ptr`` on a card of ``sms`` streaming
    multiprocessors (132 on an H100 SXM, 114 on a PCIe one).

    - Tile: as the JAX signature's hints clamp, ``bm`` to ``round_to(M, 8)``
      and ``bn`` to ``N``; with a clamped ``bm`` of at least 128, the
      128 x 128 tile when the clamped ``bn`` is more than 64 and the
      128 x 64 one otherwise; else the 64 x 64 tile. A 128-row tile whose
      grid would not reach half the SMs gives way to the 64 x 64 one:
      small products are latency-bound, and its four times more tiles need
      fewer partial sums.
    - Ring depth (``RING_STAGES``, fixed by the kernel): the deepest of
      which ``BLOCKS_PER_SM`` blocks fit an SM: 3 stages of the 128 x 128
      tile (105 KB), 4 of the others.
    - Split: with output tiles for at most half of one wave (the blocks
      that the card holds at once, ``BLOCKS_PER_SM`` x ``sms``, but at
      most ``SPLIT_BLOCKS_PER_SM`` an SM), K is split so the grid fills
      that wave and no more, at most ``MAX_SPLIT`` ways and with at least
      ``MIN_STEPS_PER_SPLIT`` K steps a split. A grid past one wave would
      leave its last wave partly idle.
    - Copy width: the largest of 16, 8, 4 bytes that divides both pointers
      and both row lengths in bytes; 2 (register loads) for a bf16 row of
      odd length."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul: no kernel for {dtype}")
    f32 = dtype == torch.float32
    es = 4 if f32 else 2
    tile = NARROW
    if min(bm, _round_to(M, 8)) >= 128:
        tile = WIDE if min(bn, N) > 64 else SKINNY
        if _cdiv(M, tile[0]) * _cdiv(N, tile[1]) < sms // 2:
            tile = NARROW
    align = a_ptr | b_ptr | (K * es) | (N * es)
    vec = next(v for v in (16, 8, 4, 2) if align % v == 0)
    if vec < es:
        raise ValueError("matmul: f32 operands must be 4-byte aligned")
    bk = STEP_BYTES // es
    k_steps = _cdiv(K, bk)
    tiles = _cdiv(M, tile[0]) * _cdiv(N, tile[1])
    wave = min(BLOCKS_PER_SM[tile], SPLIT_BLOCKS_PER_SM) * sms
    split = max(1, min(wave // tiles, MAX_SPLIT,
                       k_steps // MIN_STEPS_PER_SPLIT))
    k_per_split = _cdiv(k_steps, split) * bk
    return Plan(tile=(*tile, bk), stages=RING_STAGES[tile],
                split=_cdiv(K, k_per_split), vec=vec,
                k_per_split=k_per_split)


class MatmulKernel(Kernel):
    """Wrapper of the ``matmul`` CUDA kernel: one counted launch a call,
    also when a split-K reduce follows as a second device launch."""

    def __init__(self):
        super().__init__("matmul", "matmul", "matmul_launch",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                         + [ctypes.c_void_p])

    def __call__(self, a: torch.Tensor, b: torch.Tensor, bm: int = 512,
                 bn: int = 256, bk: int = 512) -> torch.Tensor:
        """``a @ b``. The block sizes are the JAX signature's tiling hints:
        ``bm`` and ``bn`` choose the kernel's tile (see :func:`plan`);
        ``bk`` is checked and otherwise unused, since the kernel's K step
        is fixed by its shared-memory ring and ragged edges are zero-filled
        copies, not padding."""
        if min(bm, bn, bk) < 1:
            raise ValueError(f"matmul: block sizes must be >= 1, got "
                             f"{(bm, bn, bk)}")
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)} do not chain")
        if route("matmul", a, b) == "plain":
            return matmul_reference(a, b)
        return self._launch(a, b, bm, bn)

    def _launch(self, a, b, bm, bn):
        if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
            raise TypeError(f"matmul: a and b must both be float32 or both "
                            f"bfloat16, got {a.dtype} and {b.dtype}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("matmul: a and b must be contiguous")
        (M, K), N = a.shape, b.shape[1]
        if max(M, N, K) >= 2 ** 31:
            raise ValueError("matmul: shape too large")
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
        if M == 0 or N == 0:
            return out
        if K == 0:
            return out.zero_()
        p = plan(M, N, K, a.dtype, a.data_ptr(), b.data_ptr(),
                 sm_count(a.device), bm, bn)
        ws = (torch.empty((p.split, M, N), dtype=torch.float32,
                          device=a.device) if p.split > 1 else None)
        self.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    0 if ws is None else ws.data_ptr(), M, N, K,
                    int(a.dtype == torch.bfloat16), p.tile[0], p.tile[1],
                    p.vec, p.split, p.k_per_split,
                    torch.cuda.current_stream(a.device).cuda_stream)
        return out


matmul = MatmulKernel()
