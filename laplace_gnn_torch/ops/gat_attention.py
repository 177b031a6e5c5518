"""GAT's edge softmax and aggregation over a dst-sorted CSR, forward and
backward:

    out[i] = sum_{e: dst_e = i} softmax_e(leaky_relu(a_src[src_e]
             + a_dst[i])) h[src_e]

for (N, H, F) ``h`` and (N, H) ``a_src``, ``a_dst``. On CUDA tensors the
hand-written kernels of ``csrc/gat_attention.cu`` (replacing no Pallas
kernel: the JAX package's ELL attention is plain XLA), which never write
the gathered (E, H, F) payload; on CPU tensors the plain version below,
the same CSR arithmetic in PyTorch. :func:`gat_attention` is one
``torch.autograd.Function`` with a hand-written backward (no forward-mode
or vmap rule: the callers take the composed body under ``torch.func``
transforms).

Precision, the same on both routes: ``h`` is rounded to the payload dtype
(``agg_dtype``, bf16 on the sparse CLI); scores, exponentials, sums and
every output run in float32, or in float64 for a float64 payload. The
backward rounds ``dout`` to the payload dtype, as the composed version
carries the payload's gradient. The kernels sum in a fixed order (no
atomics), so two calls give the same bits.

:func:`attention_csr` is the layout, built once on the graph's device:
int32 row offsets and sources of the dst-sorted edges, the transposed CSR
(the out-edges of each source: their destinations and dst-sorted edge
ids) and both sides' work items, rows of at most ``CHUNK`` edges, a longer
row split into chunks that a second pass merges in order.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

from .cuda_build import load
from .launches import LaunchCounter

CHUNK = 64           # csrc/gat_attention.cu: most edges a work item
MAX_HEADS = 8        # ... heads
MAX_VECTORS = 256    # ... 16-byte vectors of a payload row
_PAYLOADS = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


def sums_dtype(payload: torch.dtype) -> torch.dtype:
    """The dtype of the scores, sums and outputs for a payload dtype."""
    return torch.float64 if payload == torch.float64 else torch.float32


def padded_width(width: int, payload: torch.dtype) -> int:
    """A head's width rounded up to whole 16-byte vectors of ``payload``."""
    vec = 16 // torch.empty((), dtype=payload).element_size()
    return -(-width // vec) * vec


@dataclass(frozen=True)
class Work:
    """One side's work items: ``items`` (n, 4) int32 rows {row, begin,
    end, slot} (slot -1: the item is the whole row; else its chunk's place
    in the workspace), ``merges`` (m, 4) int32 {row, first slot, chunks, 0}
    for the split rows, ``n_slots`` chunks of split rows in all."""
    items: torch.Tensor
    merges: torch.Tensor
    n_slots: int


def _work(indptr: torch.Tensor) -> Work:
    """Items over the rows of int64 offsets ``indptr`` (n + 1,): each row a
    chunk of at most CHUNK edges, an empty row one empty item."""
    n = indptr.shape[0] - 1
    dev = indptr.device
    deg = indptr[1:] - indptr[:-1]
    chunks = torch.clamp_min((deg + CHUNK - 1) // CHUNK, 1)
    row = torch.repeat_interleave(torch.arange(n, device=dev), chunks)
    first = torch.cumsum(chunks, 0) - chunks
    c = torch.arange(row.shape[0], device=dev) - first[row]
    beg = indptr[row] + c * CHUNK
    end = torch.minimum(beg + CHUNK, indptr[row + 1])
    split = chunks > 1
    taken = torch.where(split, chunks, 0)
    slot0 = torch.cumsum(taken, 0) - taken
    slot = torch.where(split[row], slot0[row] + c, -1)
    rows = torch.nonzero(split).reshape(-1)
    merges = torch.stack([rows, slot0[rows], chunks[rows],
                          torch.zeros_like(rows)], 1)
    return Work(items=torch.stack([row, beg, end, slot], 1).int().contiguous(),
                merges=merges.int().contiguous(),
                n_slots=int(taken.sum()))


@dataclass(frozen=True)
class AttentionCsr:
    """The CSR layout of :func:`gat_attention`, int32 tensors on one
    device: ``src`` / ``dst`` (E,) the dst-sorted edges, ``indptr`` (N + 1,)
    their row offsets, ``fwd`` the rows' work; ``t_dst`` / ``t_eid`` (E,)
    the edges sorted by source (each one's destination and dst-sorted
    index), ``bwd`` the sources' work."""
    n_nodes: int
    src: torch.Tensor
    dst: torch.Tensor
    indptr: torch.Tensor
    fwd: Work
    t_dst: torch.Tensor
    t_eid: torch.Tensor
    bwd: Work

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device


def attention_csr(src: torch.Tensor, dst: torch.Tensor,
                  n_nodes: int) -> AttentionCsr:
    """The layout of the edges ``src -> dst`` (E,), sorted by ``dst``, on
    their device. Form it outside ``torch.func`` transforms."""
    if src.shape[0] >= 2 ** 31 - CHUNK:
        raise ValueError("gat_attention: at most 2^31 - 65 edges")
    if src.shape[0] and not bool((dst[1:] >= dst[:-1]).all()):
        raise ValueError("gat_attention: the edges must be sorted by dst")
    src, dst = src.long(), dst.long()
    zero = torch.zeros(1, dtype=torch.long, device=src.device)
    indptr = torch.cat([zero, torch.cumsum(
        torch.bincount(dst, minlength=n_nodes), 0)])
    perm = torch.argsort(src, stable=True)
    t_indptr = torch.cat([zero, torch.cumsum(
        torch.bincount(src, minlength=n_nodes), 0)])
    return AttentionCsr(n_nodes=n_nodes, src=src.int(), dst=dst.int(),
                        indptr=indptr.int(), fwd=_work(indptr),
                        t_dst=dst[perm].int(), t_eid=perm.int(),
                        bwd=_work(t_indptr))


# -- the plain version (CPU tensors; the card's yardstick) -------------------

def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z >= 0, z, slope * z)


def forward_plain(csr: AttentionCsr, h: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor, slope: float, payload: torch.dtype):
    """(out, lse, x): the attention in the sums' dtype, each row's
    log-sum-exp (N, H) (0 on a row without edges) and the payload ``x``
    (N, H, F) the backward reads. ``a_src``, ``a_dst`` in the sums'
    dtype."""
    cd = sums_dtype(payload)
    n, H, F = h.shape
    src, dst = csr.src.long(), csr.dst.long()
    x = h.to(payload)
    s = _leaky(a_src[src] + a_dst[dst], slope)                   # (E, H)
    m = torch.full((n, H), -torch.inf, dtype=cd, device=h.device)
    m = m.scatter_reduce(0, dst[:, None].expand(-1, H), s, "amax")
    p = torch.exp(s - m[dst])
    den = torch.zeros((n, H), dtype=cd, device=h.device).index_add_(
        0, dst, p)
    lse = torch.where(den > 0, m + torch.log(den), torch.zeros_like(den))
    msgs = p[:, :, None] * x.to(cd)[src]
    out = torch.zeros((n, H, F), dtype=cd, device=h.device).index_add_(
        0, dst, msgs)
    out = out / torch.where(den > 0, den, torch.ones_like(den))[:, :, None]
    return out, lse, x


def backward_plain(csr: AttentionCsr, x: torch.Tensor, a_src: torch.Tensor,
                   a_dst: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                   g: torch.Tensor, slope: float):
    """(dh, da_src, da_dst) in the sums' dtype for the output gradient
    ``g``, from the forward's payload ``x`` and its ``out`` and ``lse``."""
    cd = out.dtype
    n, H, _ = out.shape
    src, dst = csr.src.long(), csr.dst.long()
    gp = g.to(x.dtype).to(cd)
    d = torch.sum(gp * out, dim=-1)                              # (N, H)
    z = a_src[src] + a_dst[dst]
    alpha = torch.exp(_leaky(z, slope) - lse[dst])               # (E, H)
    dalpha = torch.sum(gp[dst] * x.to(cd)[src], dim=-1)
    ds = alpha * (dalpha - d[dst])
    dz = torch.where(z >= 0, ds, slope * ds)
    dh = torch.zeros_like(out).index_add_(0, src, alpha[:, :, None] * gp[dst])
    zeros = torch.zeros((n, H), dtype=cd, device=out.device)
    return dh, zeros.index_add(0, src, dz), zeros.index_add(0, dst, dz)


# -- the kernels -------------------------------------------------------------

class GatKernel(LaunchCounter):
    """Wrapper of one entry point of ``csrc/gat_attention.cu`` with a
    launch counter: ``gat_fwd`` (pack the payload, the rows' pass, the
    split rows' merge) or ``gat_bwd`` (pack the output gradient and D,
    the sources' pass, their merge, the destinations' sums). A launch is
    one call of the entry point, 2 to 4 kernels on the current stream."""

    source = "laplace_gnn_torch/csrc/gat_attention.cu"

    def __init__(self, name: str, argtypes: list):
        super().__init__()
        self.name = name
        self._argtypes = argtypes
        self._fn = None

    def entry(self):
        """The C entry point, built and typed on first use."""
        if self._fn is None:
            fn = getattr(load("gat_attention"), f"{self.name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = self._argtypes
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self.entry()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error "
                               f"{rc}")
        self._counted()


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
gat_fwd = GatKernel("gat_fwd", [_I, _P, _P, _I] + [_P] * 4 + [_I, _P]
                    + [_I] * 5 + [_D] + [_P] * 5)
gat_bwd = GatKernel("gat_bwd", [_I] + [_P] * 12 + [_I, _P] + [_I] * 5
                    + [_D] + [_P] * 7)


def _check(csr: AttentionCsr, h: torch.Tensor, payload: torch.dtype,
           *scores: torch.Tensor) -> int:
    """The payload's code; raises on what the kernels do not take. ``h``
    is (N, H, F), each of ``scores`` (N, H)."""
    for t in (h,) + scores:
        if not t.is_cuda or csr.device != t.device:
            raise ValueError(f"gat_attention kernels: CUDA tensors on the "
                             f"layout's device ({csr.device}), got "
                             f"{t.device}")
    if payload not in _PAYLOADS:
        raise TypeError(f"gat_attention kernels: a bfloat16, float32 or "
                        f"float64 payload, got {payload}")
    if h.dim() != 3 or h.shape[0] != csr.n_nodes:
        raise ValueError(f"gat_attention kernels: h of shape (N, H, F) with "
                         f"N = {csr.n_nodes}, got {tuple(h.shape)}")
    n, H, F = h.shape
    fp = padded_width(F, payload)
    vec = 16 // torch.empty((), dtype=payload).element_size()
    if not 1 <= H <= MAX_HEADS or H * fp // vec > MAX_VECTORS:
        raise ValueError(f"gat_attention kernels: 1 to {MAX_HEADS} heads and "
                         f"at most {MAX_VECTORS * 16} bytes of payload a "
                         f"row, got H = {H}, F = {F} in {payload}")
    if n * H * fp >= 2 ** 31:
        raise ValueError("gat_attention kernels: N * H * F under 2^31")
    for t in scores:
        if tuple(t.shape) != (n, H):
            raise ValueError(f"gat_attention kernels: scores of shape "
                             f"{(n, H)}, got {tuple(t.shape)}")
    return _PAYLOADS[payload]


def _scratch(work: Work, width: int, dtype, device) -> torch.Tensor:
    return torch.empty((max(work.n_slots, 1), width), dtype=dtype,
                       device=device)


def forward_kernel(csr: AttentionCsr, h: torch.Tensor, a_src: torch.Tensor,
                   a_dst: torch.Tensor, slope: float, payload: torch.dtype):
    """:func:`forward_plain` on the card: (out, lse, xp), ``xp`` the
    (N, H, Fp) payload padded to 16-byte rows."""
    code = _check(csr, h, payload, a_src, a_dst)
    cd = sums_dtype(payload)
    n, H, F = h.shape
    fp = padded_width(F, payload)
    hc = h.to(cd).contiguous()
    direct = payload == cd and fp == F
    xp = hc if direct else torch.empty((n, H, fp), dtype=payload,
                                       device=h.device)
    out = torch.empty((n, H, F), dtype=cd, device=h.device)
    lse = torch.empty((n, H), dtype=cd, device=h.device)
    ws_acc = _scratch(csr.fwd, H * fp, cd, h.device)
    ws_ml = _scratch(csr.fwd, 2 * H, cd, h.device)
    a_src, a_dst = a_src.to(cd).contiguous(), a_dst.to(cd).contiguous()
    gat_fwd.launch(
        code, hc.data_ptr(), xp.data_ptr(), int(not direct),
        a_src.data_ptr(), a_dst.data_ptr(), csr.src.data_ptr(),
        csr.fwd.items.data_ptr(), csr.fwd.items.shape[0],
        csr.fwd.merges.data_ptr(), csr.fwd.merges.shape[0], n, H, F, fp,
        float(slope), out.data_ptr(), lse.data_ptr(), ws_acc.data_ptr(),
        ws_ml.data_ptr(), torch.cuda.current_stream(h.device).cuda_stream)
    return out, lse, xp


def backward_kernel(csr: AttentionCsr, xp: torch.Tensor, a_src: torch.Tensor,
                    a_dst: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                    g: torch.Tensor, slope: float):
    """:func:`backward_plain` on the card, from :func:`forward_kernel`'s
    outputs."""
    payload = xp.dtype
    code = _check(csr, g, payload, a_src, a_dst, lse)
    cd = sums_dtype(payload)
    n, H, F = g.shape
    fp = padded_width(F, payload)
    if xp.shape != (n, H, fp) or out.shape != g.shape or out.dtype != cd:
        raise ValueError("gat_attention kernels: the forward's payload and "
                         "output do not match the gradient")
    dev = g.device
    g = g.to(cd).contiguous()
    a_src, a_dst = a_src.to(cd).contiguous(), a_dst.to(cd).contiguous()
    lse, xp, out = lse.to(cd).contiguous(), xp.contiguous(), out.contiguous()
    gp = torch.empty((n, H, fp), dtype=payload, device=dev)
    d = torch.empty((n, H), dtype=cd, device=dev)
    dh = torch.empty((n, H, F), dtype=cd, device=dev)
    da_src = torch.empty((n, H), dtype=cd, device=dev)
    da_dst = torch.empty((n, H), dtype=cd, device=dev)
    dz = torch.empty((max(csr.n_edges, 1), H), dtype=cd, device=dev)
    ws_acc = _scratch(csr.bwd, H * fp, cd, dev)
    ws_a = _scratch(csr.bwd, H, cd, dev)
    gat_bwd.launch(
        code, xp.data_ptr(), g.data_ptr(), out.data_ptr(), gp.data_ptr(),
        d.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(), lse.data_ptr(),
        csr.indptr.data_ptr(), csr.t_dst.data_ptr(), csr.t_eid.data_ptr(),
        csr.bwd.items.data_ptr(), csr.bwd.items.shape[0],
        csr.bwd.merges.data_ptr(), csr.bwd.merges.shape[0], n, H, F, fp,
        float(slope), dh.data_ptr(), da_src.data_ptr(), da_dst.data_ptr(),
        dz.data_ptr(), ws_acc.data_ptr(), ws_a.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    return dh, da_src, da_dst


class _GatAttention(torch.autograd.Function):
    """The attention with its hand-written backward: the kernels on CUDA
    tensors, the plain version on CPU tensors."""

    @staticmethod
    def forward(ctx, h, a_src, a_dst, csr, slope, payload):
        cd = sums_dtype(payload)
        a_s = a_src.to(cd).contiguous()
        a_d = a_dst.to(cd).contiguous()
        run = forward_kernel if h.is_cuda else forward_plain
        out, lse, x = run(csr, h, a_s, a_d, slope, payload)
        ctx.save_for_backward(x, a_s, a_d, out, lse)
        ctx.csr, ctx.slope = csr, slope
        ctx.dtypes = (h.dtype, a_src.dtype, a_dst.dtype)
        return out.to(h.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, a_s, a_d, out, lse = ctx.saved_tensors
        run = backward_kernel if g.is_cuda else backward_plain
        dh, da_src, da_dst = run(ctx.csr, x, a_s, a_d, out, lse, g,
                                 ctx.slope)
        th, ts, td = ctx.dtypes
        return dh.to(th), da_src.to(ts), da_dst.to(td), None, None, None


def gat_attention(csr: AttentionCsr, h: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor, negative_slope: float,
                  payload=None) -> torch.Tensor:
    """(N, H, F) GAT attention over the layout ``csr``, in ``h``'s dtype,
    with ``h`` rounded to ``payload`` (default: its own dtype) where it is
    gathered. Not for use under ``torch.func`` transforms."""
    return _GatAttention.apply(h, a_src, a_dst, csr, float(negative_slope),
                               payload or h.dtype)
