"""Dense message-passing layers (counterpart of
``laplace_gnn_tpu/models/layers.py``): GCNConv, GraphSAGEConv and
GATConv."""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn.module import Linear, TapCollector
from ..ops.flash_attention import (_attn_dtype, _round,
                                   flash_masked_attention)
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


class GraphSAGEConv(nn.Module):
    """``lin([x, mean_agg(adj, x)])``: row-normalised mean aggregation, a
    concat, then a ``Linear(2 * in, out)``, the layer's KFAC tap site."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 name: str = "conv", generator=None, dtype=torch.float32):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.lin = Linear(2 * in_channels, out_channels, bias=bias, name=name,
                          generator=generator, dtype=dtype)
        self.name = name

    @staticmethod
    def mean_agg(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``x``'s mean over each row's neighbours; a row sum of 0 counts
        as 1."""
        row_sum = torch.sum(adj, dim=1, keepdim=True)
        row_sum = torch.where(row_sum == 0, torch.ones_like(row_sum),
                              row_sum)
        return aggregate(adj / row_sum, x)

    def forward(self, adj, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        h = torch.cat([x, self.mean_agg(adj, x)], dim=-1)
        return self.lin(h, taps=taps)

    def tap_sites(self) -> list[dict]:
        return [{"name": self.name, "param_path": ("lin",),
                 "has_bias": self.lin.use_bias}]


def _masked_attention_dense(alpha_src, alpha_dst, adj, h, negative_slope,
                            attn_dtype=None):
    """``out[i] = sum_j softmax_j(leaky_relu(a_src[j] + a_dst[i]) |
    adj[i, j] > 0) h[j]``, materializing the (R, N, H) scores. ``adj`` may
    have any dtype (only ``adj > 0`` enters); ``attn_dtype="bfloat16"``
    rounds only the operands of the final contraction, with sums in
    ``h``'s dtype."""
    scores = alpha_src[None, :, :] + alpha_dst[:, None, :]          # (R, N, H)
    scores = torch.where(scores >= 0, scores, negative_slope * scores)
    mask = (adj > 0)[..., None]
    scores = torch.where(mask, scores, torch.full_like(scores, -math.inf))
    smax = torch.amax(scores, dim=1, keepdim=True)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    ex = torch.where(mask, torch.exp(scores - smax), torch.zeros_like(scores))
    denom = torch.sum(ex, dim=1, keepdim=True)
    alpha = ex / torch.where(denom == 0, torch.ones_like(denom), denom)
    cd = _attn_dtype(attn_dtype)
    return torch.einsum("ijh,jhf->ihf", _round(alpha, cd),
                        _round(h, cd))                              # (R, H, F)


def _masked_attention_chunked(alpha_src, alpha_dst, adj, h, negative_slope,
                              block: int, attn_dtype=None):
    """:func:`_masked_attention_dense` over blocks of ``block`` target rows:
    peak attention memory block * N * H instead of R * N * H. Under
    reverse-mode autograd each block is checkpointed (its scores are
    recomputed in the backward instead of stored). Under a ``torch.func``
    transform (the curvature's vjp, jvp and vmap) the blocks run plainly:
    those transforms take no checkpoint (its saved-tensor hooks).
    ``adj``/``alpha_dst`` may cover only R <= N target rows."""
    R = adj.shape[0]
    recompute = (torch.is_grad_enabled()
                 and not torch._C._are_functorch_transforms_active()
                 and any(t.requires_grad for t in (alpha_src, alpha_dst, h)))

    def one_block(a_dst_blk, adj_blk):
        return _masked_attention_dense(alpha_src, a_dst_blk, adj_blk, h,
                                       negative_slope, attn_dtype=attn_dtype)

    outs = []
    for r0 in range(0, R, block):
        args = (alpha_dst[r0:r0 + block], adj[r0:r0 + block])
        outs.append(checkpoint(one_block, *args, use_reentrant=False)
                    if recompute else one_block(*args))
    return torch.cat(outs, dim=0)


class GATConv(nn.Module):
    """Dense multi-head attention with a masked softmax over the adjacency.

    As in the JAX package (and unlike the torch original, whose output
    einsum is an identity map on the target's own features), the layer
    aggregates neighbours: ``out[i] = sum_j alpha[i, j] x[j]``.

    ``attention_impl``: None (dense, or row-blocked above ``AUTO_CHUNK_N``
    nodes or with ``row_block``), ``"flash"`` (the fused kernels of
    ``ops/flash_attention.py``) or a callable with the signature
    ``(alpha_src, alpha_dst, adj, h, negative_slope) -> out``.
    ``attn_dtype`` casts only the aggregation's operands."""

    #: above this many nodes the default path switches to row blocks
    AUTO_CHUNK_N = 4096

    def __init__(self, in_channels: int, out_channels: int, heads: int,
                 negative_slope: float = 0.2, concat: bool = True,
                 bias: bool = True, name: str = "conv",
                 row_block: Optional[int] = None,
                 attn_dtype: Optional[str] = None,
                 attention_impl: Union[None, str, Callable] = None,
                 generator=None, dtype=torch.float32):
        super().__init__()
        if attention_impl not in (None, "flash") and not callable(
                attention_impl):
            raise ValueError(f"attention_impl must be None, 'flash' or a "
                             f"callable, got {attention_impl!r}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.heads = heads
        self.negative_slope = negative_slope
        self.concat = concat
        self.use_bias = bias
        self.name = name
        self.row_block = row_block
        self.attn_dtype = attn_dtype
        self.attention_impl = attention_impl
        self.lin = Linear(in_channels, heads * out_channels, bias=False,
                          name=name, generator=generator, dtype=dtype)
        # xavier-uniform attention vectors, zero bias
        bound = math.sqrt(6.0 / (1 + heads * out_channels))

        def uniform(*shape):
            u = torch.rand(*shape, generator=generator, dtype=torch.float64)
            return (u * 2 * bound - bound).to(dtype)

        self.att_src = nn.Parameter(uniform(1, heads, out_channels))
        self.att_dst = nn.Parameter(uniform(1, heads, out_channels))
        self.bias = (nn.Parameter(torch.zeros(
            out_channels * (heads if concat else 1), dtype=dtype))
            if bias else None)

    def forward(self, adj, x: torch.Tensor,
                taps: Optional[TapCollector] = None) -> torch.Tensor:
        n = x.shape[0]
        h = self.lin(x, taps=taps).reshape(n, self.heads, self.out_channels)
        alpha_src = torch.sum(h * self.att_src, dim=-1)              # (N, H)
        alpha_dst = torch.sum(h * self.att_dst, dim=-1)              # (N, H)
        block = self.row_block
        if block is None and n > self.AUTO_CHUNK_N:
            block = 512
        impl = self.attention_impl
        if impl == "flash":
            out = flash_masked_attention(alpha_src, alpha_dst, adj, h,
                                         self.negative_slope, self.attn_dtype)
        elif impl is not None:
            out = impl(alpha_src, alpha_dst, adj, h, self.negative_slope)
        elif block and block < n:
            out = _masked_attention_chunked(alpha_src, alpha_dst, adj, h,
                                            self.negative_slope, block,
                                            attn_dtype=self.attn_dtype)
        else:
            out = _masked_attention_dense(alpha_src, alpha_dst, adj, h,
                                          self.negative_slope,
                                          attn_dtype=self.attn_dtype)
        out = (out.reshape(n, self.heads * self.out_channels) if self.concat
               else torch.mean(out, dim=1))
        return out + self.bias if self.bias is not None else out

    def tap_sites(self) -> list[dict]:
        # the attention vectors and the bias are not Linear weights, so KFAC
        # does not cover them: they get exact-diagonal blocks
        return [{"name": self.name, "param_path": ("lin",), "has_bias": False,
                 "kfac_incomplete": True}]
