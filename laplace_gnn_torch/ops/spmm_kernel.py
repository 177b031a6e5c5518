"""The sparse graph's product over its dst-sorted CSR on the card:

    out[i] = sum_{e: dst_e = i} w_e x[src_e]

for (N, d) ``x``, by the hand-written kernel of ``csrc/spmm.cu`` (replacing
no Pallas kernel: the JAX package's sparse aggregation is plain XLA). Its
plain version is the graph's own aggregation,
:meth:`~laplace_gnn_torch.graph.container.SparseGraph._aggregate`, which
``SparseGraph.spmm`` takes for CPU tensors; ``SparseGraph.spmm`` takes
:func:`spmm` for tensors on one CUDA device.

Precision: ``x`` is rounded to the aggregation dtype (the graph's
``agg_dtype``, bf16 on the sparse CLI, else ``x``'s own), as the plain
version rounds it, and so are the weights; the sums run in float32 (float64
for a float64 operand) and are written straight to ``x``'s dtype, where
the plain version rounds them to the aggregation dtype first. The kernel
sums in a fixed order (no atomics), so two calls give the same bits.

:func:`spmm_csr` is the layout, formed once with the graph on its device:
int32 row offsets and sources of the dst-sorted edges, the weights in each
dtype a call may ask for, and the work items of
:func:`~laplace_gnn_torch.ops.gat_attention.attention_csr` (each row an item
of at most ``CHUNK`` edges, a longer row split into chunks that a second
pass adds in order).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from .cuda_build import Kernel, kernel_only
from .gat_attention import CHUNK, Work, _work

_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


def sums_dtype(op: torch.dtype) -> torch.dtype:
    """The dtype of the sums and the kernel's output for an operand
    dtype."""
    return torch.float64 if op == torch.float64 else torch.float32


@dataclass(frozen=True)
class SpmmCsr:
    """The layout of :func:`spmm` on one device: ``indptr`` (N + 1,) and
    ``src`` (E,) int32 of the dst-sorted edges, ``weights`` the edges'
    weights by dtype (their own first), ``work`` the rows' items."""
    n_nodes: int
    indptr: torch.Tensor
    src: torch.Tensor
    weights: dict
    work: Work

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device


def spmm_csr(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
             n_nodes: int, dst_sorted: bool = True,
             dtypes=()) -> SpmmCsr:
    """The layout of the edges ``src -> dst`` (E,) with ``weights`` (E,),
    on their device; unless ``dst_sorted``, the edges are sorted by ``dst``
    first (stably). ``weights`` are kept in their own dtype and in each of
    ``dtypes``. Form it outside ``torch.func`` transforms."""
    if src.shape[0] >= 2 ** 31 - CHUNK:
        raise ValueError("spmm kernel: at most 2^31 - 65 edges")
    src, dst = src.long(), dst.long()
    if not dst_sorted:
        order = torch.argsort(dst, stable=True)
        src, dst, weights = src[order], dst[order], weights[order]
    indptr = torch.cat([torch.zeros(1, dtype=torch.long, device=src.device),
                        torch.cumsum(torch.bincount(dst, minlength=n_nodes),
                                     0)])
    kept = [weights.dtype] + [d for d in dtypes if d is not None]
    return SpmmCsr(n_nodes=n_nodes, indptr=indptr.int(), src=src.int(),
                   weights={d: weights.to(d).contiguous() for d in kept},
                   work=_work(indptr))


def lanes_for(nvec: int) -> int:
    """The lanes a slab of a row of ``nvec`` 16-byte vectors: the smallest
    power of two that covers it, at most 16. A row wider than 256 bytes is
    walked in 256-byte slabs, every row's first slab before any row's
    second, so the slab of the operand in use stays in the L2: at d = 256
    in bf16 on an ogbn-arxiv-sized graph (an 87 MB operand) that measured
    3.5% faster than one 512-byte pass, and 128-byte slabs 14% slower."""
    lanes = 1
    while lanes < min(nvec, 16):
        lanes *= 2
    return lanes


# One launch: the product over the items, then (where a row is split) the
# merge of its chunks, two kernels on the current stream.
_P, _I = ctypes.c_void_p, ctypes.c_int
spmm_launch = Kernel("spmm", "spmm", "spmm_launch",
                     [_I, _P, _I, _I, _P, _P, _P, _I, _P, _I, _I, _P, _P,
                      _P])


def operand(x: torch.Tensor, op: torch.dtype) -> torch.Tensor:
    """``x`` (N, d) rounded to ``op``, in rows of whole 16-byte vectors
    (zeros past d), contiguous and 16-byte aligned."""
    vec = 16 // op.itemsize
    d = x.shape[1]
    xo = x.to(op)
    if d % vec:
        xo = F.pad(xo, (0, vec - d % vec))
    xo = xo.contiguous()
    if xo.data_ptr() % 16:
        xo = xo.clone()
    return xo


def launch(csr: SpmmCsr, xo: torch.Tensor, w: torch.Tensor, d: int,
           lanes: int) -> torch.Tensor:
    """The kernel on the padded operand ``xo`` from :func:`operand` and the
    weights ``w`` in its dtype, ``lanes`` a slab: (N, d) in the sums'
    dtype."""
    cd = sums_dtype(xo.dtype)
    vec = 16 // xo.element_size()
    n, dp = xo.shape
    work = csr.work
    out = torch.empty((n, d), dtype=cd, device=xo.device)
    ws = torch.empty((max(work.n_slots, 1), dp), dtype=cd, device=xo.device)
    spmm_launch.launch(
        _DTYPES[xo.dtype], xo.data_ptr(), dp // vec, lanes,
        csr.src.data_ptr(), w.data_ptr(), work.items.data_ptr(),
        work.items.shape[0], work.merges.data_ptr(), work.merges.shape[0],
        d, out.data_ptr(), ws.data_ptr(),
        torch.cuda.current_stream(xo.device).cuda_stream)
    return out


def spmm(csr: SpmmCsr, x: torch.Tensor,
         agg: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, d) ``A x`` in ``x``'s dtype over the layout ``csr``, gathered in
    ``agg`` (default: ``x``'s dtype). Raises on CPU tensors and on what the
    kernel does not take."""
    kernel_only("spmm kernel", csr.src, x)
    op = agg or x.dtype
    if op not in _DTYPES:
        raise TypeError(f"spmm kernel: a bfloat16, float32 or float64 "
                        f"operand, got {op}")
    if x.dim() != 2 or x.shape[0] != csr.n_nodes:
        raise ValueError(f"spmm kernel: x of shape (N, d) with N = "
                         f"{csr.n_nodes}, got {tuple(x.shape)}")
    n, d = x.shape
    if d == 0 or n == 0:
        return x.new_zeros((n, d))
    w = csr.weights.get(op)
    if w is None:                       # from the edges' own dtype
        w = next(iter(csr.weights.values())).to(op)
    xo = operand(x, op)
    out = launch(csr, xo, w, d, lanes_for(xo.shape[1] * op.itemsize // 16))
    return out if x.dtype == out.dtype else out.to(x.dtype)
