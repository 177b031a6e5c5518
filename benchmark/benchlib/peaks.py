"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W reaches less; the run reports ``nvidia-smi``'s ``power.limit``
beside every result, and every share is taken against these figures."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12          # dense bf16 / fp16 tensor-core rate
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12           # outside the tensor cores


def card_power_limit() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` reads them, or a
    note that it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"
