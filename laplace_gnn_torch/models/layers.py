"""Dense message-passing layers (counterpart of
``laplace_gnn_tpu/models/layers.py``; GCNConv only so far)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.module import Linear, TapCollector
from ..ops.spmm import aggregate


class GCNConv(nn.Module):
    """``out = adj @ lin(x)``; the Linear is the layer's KFAC tap site."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 name: str = "conv", generator=None, dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.lin = Linear(in_channels, out_channels, bias=bias, name=name,
                          generator=generator, dtype=dtype)
        self.name = name

    def forward(self, adj, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        return aggregate(adj, self.lin(x, taps=taps))

    def tap_sites(self) -> list[dict]:
        return [{"name": self.name, "param_path": ("lin",),
                 "has_bias": self.lin.use_bias}]
