"""Blocked matrix product (counterpart of
``laplace_gnn_tpu/ops/pallas_matmul.py``).

:data:`matmul` computes ``a (M, K) @ b (K, N)`` with an f32 accumulator and
the output in ``a.dtype``. For CUDA tensors it launches the hand-written
kernel ``csrc/matmul.cu`` (which replaces the Pallas ``_matmul_kernel``);
for CPU tensors it takes the plain version :func:`matmul_reference`.

No path of the package calls it, as no path of the JAX package calls the
Pallas kernel: products that JAX leaves to XLA (``ops/spmm.py::aggregate``,
``KronDecomposed._bmm``) stay ``torch.matmul``. It is held against its
plain version and timed against cuBLAS by ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import load

WIDE_TILE = 128           # the kernel's two output tiles: 128 x 128, 64 x 64


def _round_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: upcast to at least f32, multiply, cast to
    ``a.dtype``."""
    ct = torch.promote_types(a.dtype, torch.float32)
    return (a.to(ct) @ b.to(ct)).to(a.dtype)


class MatmulKernel:
    """Wrapper of the ``matmul`` CUDA kernel with a launch counter."""

    name = "matmul"
    source = "laplace_gnn_torch/csrc/matmul.cu"

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _entry(self):
        """The C entry point, built and typed on first use."""
        if self._fn is None:
            fn = load("matmul").matmul_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            self._fn = fn
        return self._fn

    def __call__(self, a: torch.Tensor, b: torch.Tensor, bm: int = 512,
                 bn: int = 256, bk: int = 512) -> torch.Tensor:
        """``a @ b``. The block sizes are the JAX signature's tiling hints.
        As there, ``bm`` is first clamped to ``round_to(M, 8)`` and ``bn`` to
        ``N``; the kernel then takes its 128 x 128 output tile when the
        clamped ``bm`` is at least 128 and the clamped ``bn`` more than 64,
        and its 64 x 64 tile otherwise. ``bk`` is checked
        and otherwise unused: the kernel's K step is fixed by its shared
        memory staging (8 for the wide tile, 16 for the narrow one), and
        ragged edges are guarded loads, not padding."""
        if min(bm, bn, bk) < 1:
            raise ValueError(f"matmul: block sizes must be >= 1, got "
                             f"{(bm, bn, bk)}")
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)} do not chain")
        if a.device.type == "cpu" and b.device.type == "cpu":
            return matmul_reference(a, b)
        if not (a.is_cuda and b.is_cuda and a.device == b.device):
            raise ValueError(f"matmul: a on {a.device} and b on {b.device}; "
                             "both must be on one CUDA device or the CPU")
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
        wide = (min(bm, _round_to(M, 8)) >= WIDE_TILE
                and min(bn, N) > WIDE_TILE // 2)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = self._entry()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
                           K, int(a.dtype == torch.bfloat16), int(wide),
                           stream)
        if rc != 0:
            raise RuntimeError(f"matmul launch failed with CUDA error {rc}")
        self.launches += 1
        return out


matmul = MatmulKernel()
