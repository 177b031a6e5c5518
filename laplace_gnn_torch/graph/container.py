"""Sparse graph containers for large-graph aggregation.

Counterpart of ``laplace_gnn_tpu/graph/container.py``. At ogbn-arxiv's
size (169k nodes) a dense adjacency takes 114 GB, so the graph is kept as
COO edges with per-edge weights (the normalization folded in) and served
in two forms:

  - 'segment': ``out[i] = sum_{e: dst_e = i} w_e x[src_e]`` over the
    dst-sorted edges;
  - 'ell': padded neighbour lists, an (N, K) table of each row's first K
    edges, plus up to four compacted levels for the rows that overflow K
    (each lands in the output through an add on its unique rows) and a
    dst-sorted COO remainder.

Every sum has a fixed order, so two calls give the same bits: the weighted
row sums run ``embedding_bag`` (each bag summed in order, no gathered
(E, d) block formed), segment sums ``torch.segment_reduce`` over sorted
items, in two levels where a row has more than SEGMENT_CHUNK items, and
the levels add onto unique rows, so no float atomics decide an order.
:func:`segment_sum` and :func:`gather` are each other's transposes as
``torch.autograd.Function`` s with vmap and forward-mode rules (torch's
``segment_reduce`` has neither, and ``index_select``'s backward adds with
atomics): the GAT attention runs on them. ``FastAggGraph`` wraps the whole
aggregation as one linear Function: its backward is the SpMM of A^T (the
graph itself when it is symmetric), its forward-mode rule the map itself,
and its vmap rule folds the batch into the feature axis; the models use
it, and ``SparseGraph.spmm`` alone is the plain aggregation.

The host-side packing (degrees, the dst sort, the symmetry check, the ELL
pack) runs in C++ (:mod:`laplace_gnn_torch.native`) where it builds, and in
numpy otherwise, with the same arrays. Tensors live on the device the
graph was built for (``cuda`` unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..device import resolve_device
from ..profiling import annotate, count, tracing


def _torch_dtype(name) -> Optional[torch.dtype]:
    if name is None or isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)


#: a row with more items than this is reduced in two levels
SEGMENT_CHUNK = 64


@dataclass(frozen=True)
class Segments:
    """The plan of a segment reduction and of its transpose, a gather.

    Item e belongs to row ``index[e]``. ``items`` lists the items that take
    part, grouped by row in their order (None: all of them, already
    grouped); ``rows`` are the rows that have items and ``lengths`` how
    many each. With ``padded``, the items left out have index ``n`` and
    the gather reads zeros there (the pads of an ELL table). A row with
    more than SEGMENT_CHUNK items is reduced in two levels, over chunks of
    at most that many (``chunk_lengths``) and then over its ``chunks``, so
    a hub's row is not one long serial loop. Every order is fixed."""
    index: torch.Tensor
    n: int
    items: Optional[torch.Tensor]
    rows: torch.Tensor
    lengths: torch.Tensor
    chunk_lengths: Optional[torch.Tensor]
    chunks: Optional[torch.Tensor]
    padded: bool

    @classmethod
    def of(cls, index: torch.Tensor, n: int, is_sorted: bool = False,
           keep: Optional[torch.Tensor] = None) -> "Segments":
        """The plan over ``index`` (E,); ``keep`` (E,) marks the items that
        take part (the others must have index ``n``)."""
        items = None
        if keep is not None:
            pos = torch.nonzero(keep).reshape(-1)
            items = pos[torch.argsort(index[pos], stable=True)]
        elif not is_sorted:
            items = torch.argsort(index, stable=True)
        rows, lengths = torch.unique_consecutive(
            index if items is None else index[items], return_counts=True)
        chunk_lengths = chunks = None
        if lengths.numel() and int(lengths.max()) > SEGMENT_CHUNK:
            chunks = (lengths + SEGMENT_CHUNK - 1) // SEGMENT_CHUNK
            chunk_lengths = torch.full((int(chunks.sum()),), SEGMENT_CHUNK,
                                       dtype=lengths.dtype,
                                       device=lengths.device)
            chunk_lengths[torch.cumsum(chunks, 0) - 1] = \
                lengths - (chunks - 1) * SEGMENT_CHUNK
        return cls(index=index, n=n, items=items, rows=rows, lengths=lengths,
                   chunk_lengths=chunk_lengths, chunks=chunks,
                   padded=keep is not None)

    def reduce(self, x: torch.Tensor, how: str) -> torch.Tensor:
        """(n, ...) sums or maxima of the items of ``x`` (E, ...) per row,
        accumulated in float32 for 16-bit ``x``; 0 or -inf on rows without
        items. Plain: no autograd rule."""
        items = x if self.items is None else x.index_select(0, self.items)
        if x.dtype in (torch.bfloat16, torch.float16):
            items = items.float()
        if self.chunks is not None:
            items = torch.segment_reduce(items, how,
                                         lengths=self.chunk_lengths, axis=0)
        part = torch.segment_reduce(
            items, how, axis=0,
            lengths=self.lengths if self.chunks is None else self.chunks)
        fill = 0.0 if how == "sum" else -torch.inf
        out = torch.full((self.n,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=x.device)
        return out.index_copy_(0, self.rows, part.to(x.dtype))

    def bag_sum(self, x: torch.Tensor, cols: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
        """(len(rows), d): ``sum_e w[e] x[cols[e]]`` over each row's items,
        for 2-D ``x``, without forming the (E, d) products
        (``embedding_bag`` over the chunks, then the chunks' sums). Plain."""
        if self.items is not None:
            cols, w = cols[self.items], w[self.items]
        bags = self.lengths if self.chunks is None else self.chunk_lengths
        part = F.embedding_bag(cols, x, offsets=torch.cumsum(bags, 0) - bags,
                               per_sample_weights=w, mode="sum")
        if self.chunks is None:
            return part
        low = part.dtype in (torch.bfloat16, torch.float16)
        return torch.segment_reduce(part.float() if low else part, "sum",
                                    lengths=self.chunks, axis=0
                                    ).to(part.dtype)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(E, ...) rows ``x[index]``, zeros at the items left out. Plain."""
        if self.padded:
            x = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        return x.index_select(0, self.index)


class _SegmentSumFn(torch.autograd.Function):
    """Linear map (E, ...) -> (n, ...); its transpose is the gather."""

    @staticmethod
    def forward(x, seg):
        return seg.reduce(x, "sum")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.seg = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.seg), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return _SegmentSumFn.apply(x_t, ctx.seg)

    @staticmethod
    def vmap(info, in_dims, x, seg):
        xb = x.movedim(in_dims[0], -1)      # the batch last
        out = _SegmentSumFn.apply(xb.reshape(xb.shape[0], -1), seg)
        return out.reshape((seg.n,) + tuple(xb.shape[1:])), xb.ndim - 1


class _GatherFn(torch.autograd.Function):
    """Linear map (n, ...) -> (E, ...); its transpose is the segment sum,
    so its backward adds rows in a fixed order (``index_select``'s own
    backward adds them with atomics)."""

    @staticmethod
    def forward(x, seg):
        return seg.gather(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.seg = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return segment_sum(g, ctx.seg), None

    @staticmethod
    def jvp(ctx, x_t, _):
        return _GatherFn.apply(x_t, ctx.seg)

    @staticmethod
    def vmap(info, in_dims, x, seg):
        xb = x.movedim(in_dims[0], -1)      # the batch last
        out = _GatherFn.apply(xb.reshape(xb.shape[0], -1), seg)
        return (out.reshape((seg.index.shape[0],) + tuple(xb.shape[1:])),
                xb.ndim - 1)


def segment_sum(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``out[i] = sum_{e: index_e = i} x[e]``, in a fixed order, under every
    transform."""
    return _SegmentSumFn.apply(x, seg)


def gather(x: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``x[index]`` whose backward is the fixed-order segment sum, under
    every transform."""
    return _GatherFn.apply(x, seg)


def _leaky_relu(x, negative_slope):
    return torch.where(x >= 0, x, negative_slope * x)


def _ell_tier(x: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_k vals[r, k] x[cols[r, k]]`` for 2-D ``x``, summed
    over k in order by ``embedding_bag`` without forming the gathered
    (R, K, d) block."""
    return F.embedding_bag(cols, x, per_sample_weights=vals, mode="sum")


@dataclass(frozen=True)
class SparseGraph:
    """COO edges (+ an optional multi-level ELL form), every tensor on one
    device. Index tensors are int64."""
    src: torch.Tensor            # (E,)
    dst: torch.Tensor            # (E,)
    weights: torch.Tensor        # (E,)
    n_nodes: int
    ell_cols: Optional[torch.Tensor] = None     # (N, K) or None
    ell_vals: Optional[torch.Tensor] = None     # (N, K)
    format: str = "segment"
    dst_sorted: bool = False
    rem_src: Optional[torch.Tensor] = None      # overflow edges beyond the
    rem_dst: Optional[torch.Tensor] = None      # levels (dst-sorted)
    rem_w: Optional[torch.Tensor] = None
    # multi-level ELL: (rows (Nl,), cols (Nl, Kl), vals (Nl, Kl)) triples,
    # compacted neighbour lists of the rows whose edges overflow the level
    # before; a power-law graph (ogbn-arxiv's maximum degree is ~13k)
    # would otherwise send a large share of its edges down the segment path
    ell_levels: tuple = ()
    agg_dtype: Optional[str] = None    # e.g. 'bfloat16': gather and sum in
    # this dtype (half the gathered bytes), the result cast back
    symmetric: bool = False            # the weighted adjacency equals its
    # transpose, so the SpMM's backward reuses this graph
    _plans: dict = field(default_factory=dict, init=False, repr=False,
                         compare=False)

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def shape(self):
        return (self.n_nodes, self.n_nodes)

    def __post_init__(self):
        # the SpMM's plans are formed with the graph, outside any torch.func
        # transform: one formed inside a transform would hold its tensors
        self.segments("dst")
        if self.has_remainder():
            self.segments("rem")

    def segments(self, which: str = "dst") -> Segments:
        """The (cached) segment plan over ``dst``, ``src``, or the
        remainder's ``rem_dst`` ("rem") or ``rem_src`` ("rem_src")."""
        if which not in self._plans:
            if torch._C._are_functorch_transforms_active():
                raise RuntimeError(
                    f"form the {which!r} plan outside torch.func transforms "
                    f"(call graph.segments({which!r}) first)")
            index = {"dst": self.dst, "src": self.src, "rem": self.rem_dst,
                     "rem_src": self.rem_src}[which]
            self._plans[which] = Segments.of(
                index, self.n_nodes,
                is_sorted=which == "rem" or (which == "dst"
                                             and self.dst_sorted))
        return self._plans[which]

    def has_remainder(self) -> bool:
        return self.rem_src is not None and self.rem_src.shape[0] > 0

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """``out[i] = sum_{e: dst_e = i} w_e x[src_e]`` for (N, d) ``x``.
        The span ``spmm``; counts ``spmm.calls`` and ``spmm.edge_columns``
        (stored edges times the columns of ``x``: the work done)."""
        if tracing():
            count("spmm.calls")
            count("spmm.edge_columns", self.n_edges * x.shape[1])
        with annotate("spmm"):
            agg = _torch_dtype(self.agg_dtype)
            if agg is not None and x.dtype != agg:
                return self._aggregate(x.to(agg)).to(x.dtype)
            return self._aggregate(x)

    def _aggregate(self, x: torch.Tensor) -> torch.Tensor:
        if self.format == "ell" and self.ell_cols is not None:
            out = _ell_tier(x, self.ell_cols, self.ell_vals.to(x.dtype))
            for rows_l, cols_l, vals_l in self.ell_levels:
                out = out.index_add(0, rows_l,
                                    _ell_tier(x, cols_l, vals_l.to(x.dtype)))
            if self.has_remainder():
                seg = self.segments("rem")
                out = out.index_add(0, seg.rows, seg.bag_sum(
                    x, self.rem_src, self.rem_w.to(x.dtype)))
            return out
        seg = self.segments("dst")
        return x.new_zeros((self.n_nodes, x.shape[1])).index_add_(
            0, seg.rows, seg.bag_sum(x, self.src, self.weights.to(x.dtype)))

    def transpose(self) -> "SparseGraph":
        """The graph of A^T (src and dst swapped), sorted by its dst; an
        ELL graph gets an ELL form of the same K."""
        src, dst, w = _np(self.dst), _np(self.src), _np(self.weights)
        if native.available():
            src, dst, w64, _ = native.sort_by_dst(src, dst, w, self.n_nodes)
            w = w64.astype(w.dtype)
        else:
            order = np.argsort(dst, kind="stable")
            src, dst, w = src[order], dst[order], w[order]
        dev = self.device
        g = SparseGraph(src=_index(src, dev), dst=_index(dst, dev),
                        weights=torch.as_tensor(w, device=dev),
                        n_nodes=self.n_nodes, format="segment",
                        dst_sorted=True, agg_dtype=self.agg_dtype,
                        symmetric=self.symmetric)
        if self.format == "ell" and self.ell_cols is not None:
            g = add_ell_format(g, max_k=int(self.ell_cols.shape[1]))
        return g

    def to_dense(self) -> torch.Tensor:
        adj = torch.zeros(self.shape, dtype=self.weights.dtype,
                          device=self.device)
        return adj.index_put_((self.dst, self.src), self.weights,
                              accumulate=True)

    def __matmul__(self, x):
        return self.spmm(x)


def sparse_from_edge_index(edge_index, n_nodes: int,
                           weights: Optional[np.ndarray] = None,
                           normalize: Optional[str] = "sym",
                           add_self_loops: bool = True,
                           fmt: str = "segment",
                           dtype: torch.dtype = torch.float32,
                           device=None) -> SparseGraph:
    """A SparseGraph from a (2, E) edge index, on ``device`` (``cuda``
    unless the caller passes ``device="cpu"``).

    normalize: 'sym' (D^-1/2 A D^-1/2, as ``ops.adjacency.normalize_adj``
    on the transposed-adjacency convention), 'row' (the mean aggregation
    of ``GraphSAGEConv.mean_agg``), or None.
    """
    dev = resolve_device(device)
    edge_index = _np(edge_index)
    src, dst = edge_index[0].copy(), edge_index[1].copy()
    w = (np.ones(len(src)) if weights is None
         else _np(weights)).astype(np.float64)

    if add_self_loops:
        loops = np.arange(n_nodes)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
        w = np.concatenate([w, np.ones(n_nodes)])

    # aggregate uses adj[i, j] = the weight of edge j -> i, and normalize_adj
    # scales with the dense adjacency's row sums; for the symmetric graphs
    # in use this is deg(dst)^-1/2 * w * deg(src)^-1/2
    use_native = native.available()
    if use_native:
        deg = native.degree(dst, w, n_nodes)
    else:
        deg = np.zeros(n_nodes)
        np.add.at(deg, dst, w)
    if normalize == "sym":
        dinv = np.where(deg > 0, deg ** -0.5, 0.0)
        w = dinv[dst] * w * dinv[src]
    elif normalize == "row":
        dinv = np.where(deg > 0, 1.0 / deg, 0.0)
        w = dinv[dst] * w
    elif normalize is not None:
        raise ValueError(f"Unknown normalization {normalize!r}")

    # dst-major edge order: the segment sums run over sorted items
    if use_native:
        src, dst, w, _ = native.sort_by_dst(src, dst, w, n_nodes)
        # symmetry: sorted (dst, src, w) triples == (src, dst, w)
        symmetric = native.check_symmetric(src, dst, w, n_nodes)
    else:
        order = np.argsort(dst, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        o1 = np.lexsort((src, dst))
        o2 = np.lexsort((dst, src))
        symmetric = bool(
            np.array_equal(src[o1], dst[o2])
            and np.array_equal(dst[o1], src[o2])
            and np.allclose(w[o1], w[o2]))

    g = SparseGraph(src=_index(src, dev), dst=_index(dst, dev),
                    weights=torch.as_tensor(w, dtype=dtype, device=dev),
                    n_nodes=n_nodes, format=fmt, dst_sorted=True,
                    symmetric=symmetric)
    if fmt == "ell":
        g = add_ell_format(g)
    return g


class _SpMMFn(torch.autograd.Function):
    """``x -> A x`` through a :class:`FastAggGraph`, linear in ``x`` (the
    edge weights are constants): backward is the SpMM of A^T, the
    forward-mode rule is the map itself, and a vmapped batch is folded
    into the feature axis (one SpMM over a wider matrix)."""

    @staticmethod
    def forward(x, op, transposed):
        return (op.graph_t if transposed else op.graph).spmm(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.op, ctx.transposed = inputs

    @staticmethod
    def backward(ctx, g):
        return _SpMMFn.apply(g, ctx.op, not ctx.transposed), None, None

    @staticmethod
    def jvp(ctx, x_t, _op, _transposed):
        return _SpMMFn.apply(x_t, ctx.op, ctx.transposed)

    @staticmethod
    def vmap(info, in_dims, x, op, transposed):
        xb = x.movedim(in_dims[0], -1)                  # (N, D, ..., B)
        out = _SpMMFn.apply(xb.reshape(xb.shape[0], -1), op, transposed)
        return out.reshape(xb.shape), xb.ndim - 1


class FastAggGraph:
    """Stand-in for a SparseGraph inside the models: ``spmm`` is the linear
    Function above. ``gT`` defaults to the graph itself when it is
    symmetric, else to its transpose."""

    def __init__(self, g: SparseGraph, gT: Optional[SparseGraph] = None):
        self.graph = g
        self.graph_t = gT if gT is not None else (
            g if g.symmetric else g.transpose())
        self.n_nodes = g.n_nodes
        self.shape = g.shape

    @property
    def n_edges(self) -> int:
        return self.graph.n_edges

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            return _SpMMFn.apply(x[:, None], self, False)[:, 0]
        return _SpMMFn.apply(x, self, False)

    def __matmul__(self, x):
        return self.spmm(x)


def make_spmm(g: SparseGraph, gT: Optional[SparseGraph] = None):
    """The SpMM of ``g`` as a function, with the rules of
    :class:`FastAggGraph`."""
    return FastAggGraph(g, gT).spmm


# -- GAT on the ELL layout ---------------------------------------------------

@dataclass(frozen=True)
class EllEdgeSlots:
    """Which edges (indices into the dst-sorted edge order) land in which
    (row, pos) slot of each ELL tier, so per-edge coefficients computed at
    run time (GAT attention) can be placed in the same layout.
    ``levels`` holds (edge_idx, row, pos) per compacted level;
    ``rem_edge_idx`` the remainder edges in their packed order. int64
    tensors on the graph's device."""
    ell0_edge_idx: torch.Tensor     # (n0,) edges landing in level 0
    ell0_row: torch.Tensor          # (n0,) == dst of those edges
    ell0_pos: torch.Tensor          # (n0,) slot within the row
    levels: tuple                   # ((edge_idx, row, pos), ...)
    rem_edge_idx: torch.Tensor      # (n_rem,)


def ell_edge_slots(g: SparseGraph) -> EllEdgeSlots:
    """The edge -> slot assignment of :func:`add_ell_format` (level 0 takes
    each row's first K edges, each level then packs the dst-sorted tail),
    recomputed on the host."""
    if g.format != "ell" or g.ell_cols is None:
        raise ValueError("graph has no ELL format (use add_ell_format)")
    if not g.dst_sorted:
        raise ValueError("ELL slot mapping requires dst-sorted edges")
    dst = _np(g.dst)
    n = g.n_nodes
    counts = np.bincount(dst, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    e_idx = np.arange(len(dst))
    pos = e_idx - offsets[dst]
    K0 = int(g.ell_cols.shape[1])
    sel = pos < K0
    dev = g.device
    rs_idx, rd = e_idx[~sel], dst[~sel]
    levels = []
    for rows_l, cols_l, _vals_l in g.ell_levels:
        Kl = int(cols_l.shape[1])
        rows_u, start = np.unique(rd, return_index=True)
        counts_l = np.diff(np.append(start, len(rd)))
        if not np.array_equal(rows_u, _np(rows_l)):
            raise AssertionError("ELL level rows mismatch: packing drifted")
        posl = np.arange(len(rd)) - np.repeat(start, counts_l)
        sell = posl < Kl
        row_of_edge = np.repeat(np.arange(len(rows_u)), counts_l)
        levels.append((_index(rs_idx[sell], dev),
                       _index(row_of_edge[sell], dev),
                       _index(posl[sell], dev)))
        rs_idx, rd = rs_idx[~sell], rd[~sell]
    return EllEdgeSlots(ell0_edge_idx=_index(e_idx[sel], dev),
                        ell0_row=_index(dst[sel], dev),
                        ell0_pos=_index(pos[sel], dev),
                        levels=tuple(levels),
                        rem_edge_idx=_index(rs_idx, dev))


def _place(coeff, shape, row, pos, eidx):
    """An all-zero (R, K, H) table with ``coeff[eidx]`` at (row, pos);
    differentiable in ``coeff``."""
    vals = torch.zeros(shape + coeff.shape[1:], dtype=coeff.dtype,
                       device=coeff.device)
    return vals.index_put((row, pos), coeff.index_select(0, eidx))


def ell_aggregate_edge_coeff(g: SparseGraph, slots: EllEdgeSlots,
                             coeff: torch.Tensor,
                             h: torch.Tensor) -> torch.Tensor:
    """``out[i, head] = sum_{e: dst_e = i} coeff[e, head] h[src_e, head]``
    on the multi-level ELL gather path with run-time coefficients.

    ``coeff``: (E, H) in the graph's dst-sorted edge order; ``h``: (N, H,
    F). ``g.agg_dtype`` (bf16) applies to the gathered rows and the
    coefficients; pads carry coefficient 0."""
    n, H, F = h.shape
    in_dtype = h.dtype
    agg = _torch_dtype(g.agg_dtype) or in_dtype
    h2 = h.reshape(n, H * F).to(agg)
    cf = coeff.to(agg)
    K0 = g.ell_cols.shape[1]
    vals0 = _place(cf, (n, K0), slots.ell0_row, slots.ell0_pos,
                   slots.ell0_edge_idx)
    gathered = h2.index_select(0, g.ell_cols.reshape(-1)).view(n, K0, H, F)
    out = torch.einsum("nkh,nkhf->nhf", vals0, gathered)
    for (rows_l, cols_l, _v), (eidx, row_l, pos_l) in zip(g.ell_levels,
                                                          slots.levels):
        nl, Kl = cols_l.shape
        vals_l = _place(cf, (nl, Kl), row_l, pos_l, eidx)
        gl = h2.index_select(0, cols_l.reshape(-1)).view(nl, Kl, H, F)
        out = out.index_add(0, rows_l,
                            torch.einsum("nkh,nkhf->nhf", vals_l, gl))
    if slots.rem_edge_idx.shape[0] > 0:
        msgs = (cf.index_select(0, slots.rem_edge_idx)[:, :, None]
                * h2.view(n, H, F).index_select(0, g.rem_src))
        out = out + segment_sum(msgs, g.segments("rem"))
    return out.to(in_dtype)


def _tier_plan(cols: torch.Tensor, mask: torch.Tensor, n: int) -> Segments:
    """The gather plan of an ELL tier's (R, K) table: pads read zeros, and
    the backward sums the valid slots of each source row."""
    flat = torch.where(mask, cols, n).reshape(-1)
    return Segments.of(flat, n, keep=mask.reshape(-1))


def ell_gat_layout(g: SparseGraph) -> dict:
    """Bool validity masks of each ELL tier for :func:`ell_gat_attention`,
    from the same packing as :func:`ell_edge_slots`, and each tier's
    gather plan."""
    slots = ell_edge_slots(g)
    n, K0 = g.ell_cols.shape
    dev = g.device
    mask0 = torch.zeros((n, K0), dtype=torch.bool, device=dev)
    mask0[slots.ell0_row, slots.ell0_pos] = True
    level_masks = []
    for (rows_l, cols_l, _v), (_e, row_l, pos_l) in zip(g.ell_levels,
                                                        slots.levels):
        ml = torch.zeros(cols_l.shape, dtype=torch.bool, device=dev)
        ml[row_l, pos_l] = True
        level_masks.append(ml)
    return {"mask0": mask0, "level_masks": tuple(level_masks),
            "plan0": _tier_plan(g.ell_cols, mask0, n),
            "level_plans": tuple(_tier_plan(c, m, n) for (_r, c, _v), m
                                 in zip(g.ell_levels, level_masks))}


def ell_gat_attention(g: SparseGraph, layout: dict, h: torch.Tensor,
                      a_src: torch.Tensor, a_dst: torch.Tensor,
                      negative_slope: float) -> torch.Tensor:
    """GAT edge softmax and aggregation in the ELL layout:

        out[i] = sum_{e: dst_e = i}
                 softmax_e(leaky_relu(a_src[src_e] + a_dst[i])) h[src_e]

    ``a_src`` rides on the feature rows, so one (R, K, H*F + H) gather per
    tier fetches the messages and the score material; the masked softmax
    runs over the padded axis (pads score -inf). The levels join through
    adds on their unique rows, the remainder through segment ops.
    ``g.agg_dtype`` (bf16) applies to the gathered payload; the scores,
    exponentials and denominators run in float32, as in the JAX package.
    The row maxima are a shift that cancels in the softmax, so they carry
    no gradient. Every gather with repeated rows goes through a plan
    (:func:`gather`), so the backward sums in a fixed order too."""
    n, H, F = h.shape
    in_dtype = h.dtype
    pd = _torch_dtype(g.agg_dtype) or in_dtype
    f32 = torch.float32
    HF = H * F
    payload = torch.cat([h.reshape(n, HF).to(pd), a_src.to(pd)],
                        dim=1)                                # (N, HF + H)
    a_dst32 = a_dst.to(f32)
    neg_inf = torch.tensor(-torch.inf, dtype=f32, device=h.device)

    def tier(cols, mask, plan, rows=None):
        """(gathered messages (R, K, HF) in pd, masked scores (R, K, H))."""
        R, K = cols.shape
        gp = gather(payload, plan).view(R, K, HF + H)
        ad = a_dst32 if rows is None else a_dst32.index_select(0, rows)
        sc = _leaky_relu(gp[..., HF:].to(f32) + ad[:, None, :],
                         negative_slope)
        return gp[..., :HF], torch.where(mask[:, :, None], sc, neg_inf)

    gh0, sc0 = tier(g.ell_cols, layout["mask0"], layout["plan0"])
    m = torch.amax(sc0.detach(), dim=1)                         # (N, H)
    tiers = []
    for (rows_l, cols_l, _v), mask_l, plan_l in zip(
            g.ell_levels, layout["level_masks"], layout["level_plans"]):
        gh_l, sc_l = tier(cols_l, mask_l, plan_l, rows=rows_l)
        tiers.append((rows_l, gh_l, sc_l))
        m = m.index_copy(0, rows_l, torch.maximum(
            m.index_select(0, rows_l), torch.amax(sc_l.detach(), dim=1)))
    has_rem = g.has_remainder()
    if has_rem:
        seg, seg_src = g.segments("rem"), g.segments("rem_src")
        sc_r = _leaky_relu(gather(a_src.to(f32), seg_src)
                           + gather(a_dst32, seg), negative_slope)  # (Er, H)
        m = torch.maximum(m, seg.reduce(sc_r.detach(), "max"))
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # no edges

    ex0 = torch.exp(sc0 - m[:, None, :])                        # pads: 0
    denom = torch.sum(ex0, dim=1)                               # (N, H)
    exs = []
    for rows_l, _gh, sc_l in tiers:
        ex_l = torch.exp(sc_l - m.index_select(0, rows_l)[:, None, :])
        exs.append(ex_l)
        denom = denom.index_add(0, rows_l, torch.sum(ex_l, dim=1))
    if has_rem:
        ex_r = torch.exp(sc_r - m.index_select(0, g.rem_dst))
        denom = denom + segment_sum(ex_r, seg)
    denom = torch.clamp_min(denom, 1e-16)

    def contract(gh, ex, dn):
        alpha = (ex / dn[:, None, :]).to(pd)                    # (R, K, H)
        R, K = alpha.shape[:2]
        return torch.sum(alpha[..., None] * gh.reshape(R, K, H, F), dim=1)

    out = contract(gh0, ex0, denom)
    for (rows_l, gh_l, _sc), ex_l in zip(tiers, exs):
        out = out.index_add(0, rows_l, contract(
            gh_l, ex_l, denom.index_select(0, rows_l)))
    if has_rem:
        coeff_r = (ex_r / gather(denom, seg)).to(pd)
        msgs = coeff_r[:, :, None] * gather(h.to(pd), seg_src)
        out = out + segment_sum(msgs, seg).to(out.dtype)
    return out.to(in_dtype)


# -- ELL packing (host, numpy) -----------------------------------------------

def _choose_budgeted_k(counts: np.ndarray, pad_budget: float,
                       total: int) -> int:
    """Neighbour-list width minimizing the modelled aggregation cost

        cost(k) = n * k  +  2 * pad_budget * (total - in_ell(k))

    padded gather reads plus overflow edges weighted by their cost on the
    next tier; snapped up to a multiple of 8 above 4. Vectorized through
    the degree histogram's tail cumsum, O(N + max_deg)."""
    ks, in_ell, n = _ell_coverage(counts)
    if ks is None:
        return 1
    cost = n * ks + 2.0 * pad_budget * (total - in_ell)
    k = int(ks[np.argmin(cost)])
    if k > 4:
        k = min(int(-(-k // 8) * 8), int(ks[-1]))
    return k


def _ell_coverage(counts):
    """(ks, in_ell(ks), n_rows) for k = 1..max_deg."""
    max_deg = int(counts.max()) if len(counts) else 0
    if max_deg == 0:
        return None, None, 0
    hist = np.bincount(counts.astype(np.int64), minlength=max_deg + 1)
    tail_rows = np.cumsum(hist[::-1])[::-1]        # rows with degree >= d
    in_ell = np.cumsum(tail_rows[1:])              # edges covered at k=1..
    ks = np.arange(1, max_deg + 1, dtype=np.int64)
    return ks, in_ell, len(counts)


def _max_coverage_k(counts, pad_budget: float) -> int:
    """Largest width whose padding stays within budget, for the overflow
    levels (each level costs fixed launches, so coverage counts most)."""
    ks, in_ell, n = _ell_coverage(counts)
    if ks is None:
        return 1
    ok = n * ks <= pad_budget * in_ell
    if not ok.any():
        return 1
    return int(ks[ok].max())


def _pack_one_level(rs, rd, rw, pad_budget: float):
    """Pack dst-sorted overflow edges into a compacted (Nl, Kl) ELL over
    their destination rows; edges beyond Kl stay as a dst-sorted tail."""
    rows_l, start = np.unique(rd, return_index=True)
    counts_l = np.diff(np.append(start, len(rd)))
    K = _max_coverage_k(counts_l, pad_budget)
    nl = len(rows_l)
    pos = np.arange(len(rd)) - np.repeat(start, counts_l)
    sel = pos < K
    row_of_edge = np.repeat(np.arange(nl), counts_l)
    cols_l = np.zeros((nl, K), np.int32)
    vals_l = np.zeros((nl, K), rw.dtype)
    cols_l[row_of_edge[sel], pos[sel]] = rs[sel]
    vals_l[row_of_edge[sel], pos[sel]] = rw[sel]
    tail = ~sel
    return ((rows_l.astype(np.int32), cols_l, vals_l),
            rs[tail], rd[tail], rw[tail])


def _pack_levels(rs, rd, rw, pad_budget: float, total_edges: int,
                 max_levels: int = 4):
    """Pack overflow edges into up to ``max_levels`` compacted levels,
    stopping once the overflow drops below ~0.5% of the graph; what is
    left is the COO tail."""
    floor = max(min(4096, max(total_edges // 4, 1)), total_edges // 200)
    levels = []
    while len(rs) >= floor and len(levels) < max_levels:
        level, rs, rd, rw = _pack_one_level(rs, rd, rw, pad_budget)
        levels.append(level)
    return levels, rs, rd, rw


def add_ell_format(g: SparseGraph, max_k: Optional[int] = None,
                   pad_budget: float = 1.5) -> SparseGraph:
    """Attach padded neighbour lists (hybrid ELLPACK).

    ``max_k`` bounds the width: each node's first ``max_k`` edges go into
    the (N, K) table, the overflow of high-degree nodes into compacted
    levels and a dst-sorted COO remainder. Without ``max_k``, K minimizes
    the modelled cost of :func:`_choose_budgeted_k`."""
    src = _np(g.src)
    dst = _np(g.dst)
    w = _np(g.weights)
    n = g.n_nodes
    if native.available():
        if g.dst_sorted:   # already dst-major: offsets from one bincount
            counts = np.bincount(dst, minlength=n)
            offsets = np.concatenate([[0], np.cumsum(counts)])
            w64 = np.ascontiguousarray(w, np.float64)
        else:
            src, dst, w64, offsets = native.sort_by_dst(src, dst, w, n)
            counts = np.diff(offsets)
        max_deg = int(counts.max()) if len(counts) else 0
        if max_k is None:
            max_k = _choose_budgeted_k(counts, pad_budget, len(src))
        K = min(max_k, max_deg)
        cols, vals64, rs, rd, rw64 = native.ell_pack(src, w64, offsets, K)
        vals = vals64.astype(w.dtype)
        rw = rw64.astype(w.dtype)
    else:
        order = np.argsort(dst, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        counts = np.bincount(dst, minlength=n)
        max_deg = int(counts.max()) if len(counts) else 0
        if max_k is None:
            max_k = _choose_budgeted_k(counts, pad_budget, len(src))
        K = min(max_k, max_deg)
        cols = np.zeros((n, K), dtype=np.int32)
        vals = np.zeros((n, K), dtype=w.dtype)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(len(dst)) - offsets[dst]
        sel = pos < K
        cols[dst[sel], pos[sel]] = src[sel]
        vals[dst[sel], pos[sel]] = w[sel]
        tail = ~sel
        rs, rd, rw = src[tail], dst[tail].astype(np.int64), w[tail]
    levels, rs, rd, rw = _pack_levels(np.asarray(rs), np.asarray(rd),
                                      np.asarray(rw), pad_budget,
                                      total_edges=len(src))
    dev = g.device
    return dataclasses.replace(
        g, ell_cols=_index(cols, dev),
        ell_vals=torch.as_tensor(vals, device=dev), format="ell",
        rem_src=_index(rs, dev), rem_dst=_index(rd, dev),
        rem_w=torch.as_tensor(np.asarray(rw), device=dev),
        ell_levels=tuple((_index(r, dev), _index(c, dev),
                          torch.as_tensor(v, device=dev))
                         for r, c, v in levels))
