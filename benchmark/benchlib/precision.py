"""Products at a stated precision, for the plain references and their
controls: ``float64``; ``tf32`` (float32 storage, each product's operands
rounded to TF32's 10-bit mantissa as the tensor cores round them, sums in
float32); ``fp8`` (operands scaled per tensor to float8_e4m3fn's range,
cast to it and back, sums in float32). The rounding is explicit, so a
control reads the same on the card and on the CPU."""

from __future__ import annotations

import torch

MODES = ("float64", "tf32", "fp8")


def storage_dtype(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
    return torch.float64 if mode == "float64" else torch.float32


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) at 10 mantissa
    bits; finite values only."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & -8192
    return i.view(torch.float32)


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` through float8_e4m3fn with one scale for the tensor
    that maps its largest magnitude to the format's largest, 448, as fp8
    products are fed."""
    amax = torch.clamp(x.abs().max(), min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def rounded(x: torch.Tensor, mode: str) -> torch.Tensor:
    """An operand as a product at ``mode`` reads it."""
    if mode == "tf32":
        return to_tf32(x.float())
    if mode == "fp8":
        return to_fp8(x.float())
    return x.to(storage_dtype(mode))


class _RoundedMM(torch.autograd.Function):
    """A product whose forward and backward products all round their
    operands at ``mode``."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return rounded(a, mode) @ rounded(b, mode)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        m = ctx.mode
        ga = rounded(g, m) @ rounded(b, m).T if ctx.needs_input_grad[0] \
            else None
        gb = rounded(a, m).T @ rounded(g, m) if ctx.needs_input_grad[1] \
            else None
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` at ``mode``, differentiable."""
    if mode in ("tf32", "fp8"):
        return _RoundedMM.apply(a, b, mode)
    return a @ b
