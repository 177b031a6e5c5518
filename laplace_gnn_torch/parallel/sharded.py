"""Partitioned aggregation and sharded training steps over the 'graph' axis.

Counterpart of ``laplace_gnn_tpu/parallel/sharded.py`` on
``torch.distributed``, one process per device. JAX runs each partitioned
aggregation as a ``shard_map`` body whose inputs and outputs are
``P('graph', None)`` row blocks; here each rank runs its body on its own
block. A value placed on the graph axis is the rank's contiguous block of
rows (:meth:`~laplace_gnn_torch.parallel.mesh.NamedSharding.put`): the
features, every activation of a model on a sharded graph, and a dense
adjacency's rows. Every body takes the rank's blocks and returns its
block; it gathers only what JAX's bodies gather inside them (the features
of the all-gather aggregates, ``a_src`` and ``h`` of the row-sharded
attention). The row-wise layers (Linear, activation, residual Linear) run
on the rank's rows as they are, so what a rank holds falls with the
number of ranks. A model gathers whole values only where it needs them:
its selected output rows (``collectives.gather_selected``), and the KFAC
factors, sums over rows and ranks (``curvature/kfac.py``). Every
collective and boundary is a Function with vmap, forward-mode and
differentiable backward rules, so the KFAC pullbacks and the marglik
hyperstep run through the bodies.

Each body is split at its collectives into module functions of the rank's
block and of what it received (:func:`halo_send`, :func:`halo_rows`,
:func:`halo_gat_rows`, :func:`row_attention`, ...): the ``make_*``
closures run pre-collective part, collective, post-collective part, and a
single device can run every rank's post-collective part in turn.

The host-side plans (:func:`partition_sparse_graph`, :func:`halo_widths`,
:func:`build_halo_exchange`, :func:`build_ring_halo_exchange`) are numpy
and equal JAX's arrays. The segment sums are the fixed-order
``segment_sum`` / ``gather`` of :mod:`laplace_gnn_torch.graph.container`,
so two calls give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..graph.container import (FastAggGraph, Segments, SparseGraph,
                               _leaky_relu, gather, segment_sum)
from ..ops.adjacency import binarize_ste
from .collectives import (Axis, Pending, all_gather, all_to_all, mesh_axis,
                          ppermute, reduce_scatter)
from .mesh import graph_sharding, mesh_device, replicated, shard_gnn_params


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _n_parts(mesh) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index("graph")))


def _device(mesh, device) -> torch.device:
    """This rank's device of ``mesh``: ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``) must be of the mesh's type."""
    dev = resolve_device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev.type} on a {mesh.device_type} mesh")
    return mesh_device(mesh)


# -- dense row blocks ---------------------------------------------------------

def sharded_aggregate(mesh, adj_block: torch.Tensor,
                      x_block: torch.Tensor) -> torch.Tensor:
    """Row-partitioned ``adj @ x``: each rank all-gathers the feature
    blocks and multiplies its (N/P, N) row block of ``adj``. Both inputs
    and the result are the rank's row blocks (placed
    ``graph_sharding(mesh)``)."""
    return adj_block @ all_gather(x_block, mesh_axis(mesh))


def ring_rows(adj_blk: torch.Tensor, x_blk: torch.Tensor, ax: Axis,
              block: int) -> torch.Tensor:
    """A rank's rows of ``adj @ x`` with the all-gather as a ring: at step
    s it issues the hop that moves its current chunk one rank on, then
    multiplies the (B, B) panel of the chunk it holds (the chunk of rank
    ``index - s``)."""
    out = None
    cur = x_blk
    pending = Pending()
    for s in range(ax.size):
        owner = (ax.index - s) % ax.size
        # the hop is issued before the product that does not need it, and
        # awaited after it
        nxt = ppermute(cur, ax, 1, pending) if s + 1 < ax.size else cur
        part = adj_blk[:, owner * block:(owner + 1) * block] @ cur
        out = part if out is None else out + part
        pending.wait()
        cur = nxt
    return out


def make_ring_dense_aggregate(mesh, n_nodes: int, device=None):
    """Dense ``adj @ x`` with the all-gather decomposed into a ring of
    ``P - 1`` hops pipelined against per-chunk products
    (:func:`ring_rows`). Returns ``(aggregate_fn, put)``:
    ``aggregate_fn(adj_blk, x_blk)`` with both the rank's row blocks
    (placed ``graph_sharding(mesh)``), and the rank's rows of the product
    out. Differentiable: the cotangent rides the ring back."""
    _device(mesh, device)
    n_parts = _n_parts(mesh)
    if n_nodes % n_parts != 0:
        raise ValueError(f"n_nodes={n_nodes} must divide n_parts={n_parts}")
    block = n_nodes // n_parts

    def aggregate_fn(adj_blk: torch.Tensor,
                     x_blk: torch.Tensor) -> torch.Tensor:
        return ring_rows(adj_blk, x_blk, mesh_axis(mesh), block)

    return aggregate_fn, graph_sharding(mesh).put


# -- the dense STE adjacency by row blocks ------------------------------------

class NormalizedRowBlockAdj:
    """``normalize_adj(A) = D^-1/2 A^T D^-1/2`` (D the row sums) as an
    operator over row blocks, from the rank's row block ``a_blk`` (R, N)
    of A. A row block holds its rows whole, so its degrees are local; the
    rank's columns of the normalized matrix, ``d[:, None] * a_blk.T *
    d_blk[None, :]`` (N, R), take every degree (one all-gather of N
    values), and ``spmm`` reduce-scatters the (N, d) partial products to
    the ranks' row blocks. Nothing of N x N size moves, each rank holds
    N x R entries, and at one rank it computes ``normalize_adj(A) @ x``
    to the bit.

    The other way, the rank's rows of A^T by one all-to-all of its N x R
    entries, times the all-gathered features, was slower on four H100s
    (NVLink, N = 8192: 35.4 against 33.5 ms a Kron hyperstep, 12.9
    against 10.5 ms a train step; ``scripts/probe_row_blocks.py``)."""

    def __init__(self, a_blk: torch.Tensor, ax: Axis):
        rowsum = a_blk.sum(dim=1)
        d_blk = torch.where(rowsum > 0,
                            torch.rsqrt(torch.clamp(rowsum, min=1e-38)),
                            torch.zeros_like(rowsum))
        d = all_gather(d_blk, ax)
        self.cols = d[:, None] * a_blk.T * d_blk[None, :]
        self.ax = ax

    def spmm(self, x_blk: torch.Tensor) -> torch.Tensor:
        return reduce_scatter(self.cols @ x_blk, self.ax)


def transpose_rows(blk: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The rank's row block of A^T from its row block (R, N) of A: one
    all-to-all of the (R, R) tiles, each transposed."""
    r = blk.shape[0]
    tiles = blk.reshape(r, ax.size, r).permute(1, 0, 2)  # q: A[rows, R_q]
    got = all_to_all(tiles, ax)                          # q: A[R_q, rows]
    return got.permute(2, 0, 1).reshape(r, ax.size * r)


def block_diagonal(a_blk: torch.Tensor, ax: Axis,
                   value: float) -> torch.Tensor:
    """``fill_diagonal`` on the rank's row block: the entries (i, index *
    R + i) set to ``value``, out of place."""
    r = a_blk.shape[0]
    eye = torch.zeros(a_blk.shape, dtype=torch.bool, device=a_blk.device)
    own = torch.arange(r, device=a_blk.device)
    eye[own, ax.index * r + own] = True
    return torch.where(eye, torch.full_like(a_blk, value), a_blk)


def ste_row_block(adj_blk: torch.Tensor, ax: Axis, threshold: float,
                  grad_mask: Optional[torch.Tensor] = None,
                  sign_grad: bool = False,
                  symmetric: bool = False) -> NormalizedRowBlockAdj:
    """STE-GCN's composed aggregation, ``normalize_adj(fill_diagonal(
    binarize_ste(A), 1))``, from the rank's row block of the raw
    adjacency, in the unsharded order; ``symmetric`` first averages the
    block with its block of A^T (:func:`transpose_rows`). ``grad_mask``
    is the STE mask's row block."""
    if symmetric:
        adj_blk = (adj_blk + transpose_rows(adj_blk, ax)) / 2
    a = binarize_ste(adj_blk, threshold, grad_mask, sign_grad)
    return NormalizedRowBlockAdj(block_diagonal(a, ax, 1.0), ax)


def graph_axis_of(sharding) -> Optional[Axis]:
    """The graph axis of a row placement (``graph_sharding``), else None."""
    if sharding is None or getattr(sharding, "spec", ())[:1] != ("graph",):
        return None
    return mesh_axis(sharding.mesh)


def make_sharded_train_step(model, mesh, loss_fn, lr: float = 0.01,
                            device=None):
    """A sharded SGD step over a BaseGNN's params dict. Returns ``(step,
    shard_params)``: ``shard_params(params)`` places each leaf and returns
    ``(params, shardings)``; ``step(params, idx, y)`` returns ``(params,
    loss)``.

    JAX places the adjacency's rows on the graph axis and XLA partitions
    the step along them. Here a model with a row-block route (STE-GCN and
    GCN with ``fused=False``, AttSTEGCN, a GAT whose convs take the
    row-sharded attention) takes the placement as an explicit argument,
    ``model.apply(p, idx, adj_constraint=graph_sharding(mesh))``: each
    rank holds its row block of ``adj`` (:func:`shard_gnn_params`), runs
    every layer on its rows, and its gradient in ``adj`` is its block of
    the whole gradient; the weights stay whole, and their gradients are the
    same on every rank. ``fused=True`` keeps the square adjacency whole on
    every rank, because ``core_spmm`` reads it whole: its step is the
    unsharded step, run on every rank, and its ``adj`` placement is
    replicated. The step never changes the model."""
    _device(mesh, device)
    rows = model.has_row_route()
    placement = graph_sharding(mesh) if rows else None

    def step(params: dict, idx, y):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(model.apply(p, idx, adj_constraint=placement), y)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        new = {k: (v - lr * g if g is not None else v).detach()
               for (k, v), g in zip(p.items(), grads)}
        return new, loss.detach()

    def shard_params(params: dict):
        shardings = shard_gnn_params(mesh, params)
        if not rows:
            shardings = {k: replicated(mesh) if s.rows_on else s
                         for k, s in shardings.items()}
        return ({k: shardings[k].put(v) for k, v in params.items()},
                shardings)

    return step, shard_params


# -- edge-partitioned sparse aggregation: host plans --------------------------

def partition_sparse_graph(graph, n_parts: int):
    """Split a SparseGraph's edges by owner of their destination node
    (contiguous node blocks of N/n_parts), padding each rank's edge list to
    a common length with zero-weight edges. Returns numpy arrays (n_parts,
    E_max) for src, local dst, weights, plus the node block size."""
    n = graph.n_nodes
    if n % n_parts != 0:
        raise ValueError(f"n_nodes={n} must divide by n_parts={n_parts} "
                         "(pad the graph first)")
    block = n // n_parts
    src = _np(graph.src)
    dst = _np(graph.dst)
    w = _np(graph.weights)
    owner = dst // block
    e_max = int(max((owner == p).sum() for p in range(n_parts)))
    srcs = np.zeros((n_parts, e_max), dtype=np.int32)
    dsts = np.zeros((n_parts, e_max), dtype=np.int32)
    ws = np.zeros((n_parts, e_max), dtype=w.dtype)
    for p in range(n_parts):
        m = owner == p
        k = int(m.sum())
        srcs[p, :k] = src[m]
        dsts[p, :k] = dst[m] - p * block       # local row index
        ws[p, :k] = w[m]
    return srcs, dsts, ws, block


def _halo_partition(graph, n_parts: int):
    """Shared host-side partition pass for the halo schedules.

    Splits edges by owner of dst into per-rank local/remote sets and
    computes ``needed[p][q]``, the sorted unique sources rank p must
    receive from rank q. Packing of the remote-edge source indices is
    schedule-specific (the flat halo tables differ), so this returns the
    raw pieces plus a packer that takes a ``flat_index(p, q, pos)`` map."""
    n = graph.n_nodes
    if n % n_parts != 0:
        raise ValueError(f"n_nodes={n} must divide by n_parts={n_parts} "
                         "(pad the graph first)")
    block = n // n_parts
    src = _np(graph.src)
    dst = _np(graph.dst)
    w = _np(graph.weights)
    o_src = src // block
    o_dst = dst // block

    needed = [[np.unique(src[(o_dst == p) & (o_src == q)])
               for q in range(n_parts)] for p in range(n_parts)]

    def pack_edges(flat_index, EL_min: int = 0, ER_min: int = 0):
        el = [((o_dst == p) & (o_src == p)).sum() for p in range(n_parts)]
        er = [((o_dst == p) & (o_src != p)).sum() for p in range(n_parts)]
        EL = max(1, int(max(el)), EL_min)
        ER = max(1, int(max(er)), ER_min)
        src_l = np.zeros((n_parts, EL), np.int32)
        dst_l = np.zeros((n_parts, EL), np.int32)
        w_l = np.zeros((n_parts, EL), w.dtype)
        src_r = np.zeros((n_parts, ER), np.int32)
        dst_r = np.zeros((n_parts, ER), np.int32)
        w_r = np.zeros((n_parts, ER), w.dtype)
        m_l = np.zeros((n_parts, EL), bool)
        m_r = np.zeros((n_parts, ER), bool)
        for p in range(n_parts):
            m = (o_dst == p) & (o_src == p)
            k = int(m.sum())
            src_l[p, :k] = src[m] - p * block
            dst_l[p, :k] = dst[m] - p * block
            w_l[p, :k] = w[m]
            m_l[p, :k] = True
            m = (o_dst == p) & (o_src != p)
            k = int(m.sum())
            sq = o_src[m]
            pos = np.empty(k, np.int64)
            for q in range(n_parts):
                mq = sq == q
                if mq.any():
                    pos[mq] = flat_index(
                        p, q, np.searchsorted(needed[p][q], src[m][mq]))
            src_r[p, :k] = pos
            dst_r[p, :k] = dst[m] - p * block
            w_r[p, :k] = w[m]
            m_r[p, :k] = True
        return {"src_l": src_l, "dst_l": dst_l, "w_l": w_l,
                "src_r": src_r, "dst_r": dst_r, "w_r": w_r,
                "m_l": m_l, "m_r": m_r}

    return needed, pack_edges, block


def halo_widths(graph, n_parts: int, allow_pad: bool = False) -> np.ndarray:
    """(n_parts, n_parts) matrix W[p, q] = rows p needs from q, from one
    O(E log E) pass (unique (dst-owner, src) pairs), no plan construction.
    HaloAggGraph's auto schedule prices ring against all_to_all from it.

    ``allow_pad=True`` mirrors what a real run does for node counts that
    do not divide (pad_to_blocks): blocks of ceil(n/n_parts); the padding
    nodes are isolated, so the widths equal those of the padded graph."""
    n = graph.n_nodes
    if n % n_parts != 0:
        if not allow_pad:
            raise ValueError(f"n_nodes={n} must divide by n_parts={n_parts} "
                             "(pad the graph first)")
        block = -(-n // n_parts)
        n = block * n_parts
    else:
        block = n // n_parts
    src = _np(graph.src).astype(np.int64)
    dst = _np(graph.dst).astype(np.int64)
    o_dst = dst // block
    pairs = np.unique(o_dst * n + src)          # distinct (receiver, source)
    W = np.bincount((pairs // n) * n_parts + (pairs % n) // block,
                    minlength=n_parts * n_parts).reshape(n_parts, n_parts)
    np.fill_diagonal(W, 0)
    return W


def build_halo_exchange(graph, n_parts: int, H_min: int = 0,
                        EL_min: int = 0, ER_min: int = 0) -> dict:
    """Host-side halo plan for contiguous node-block partitions (all_to_all
    schedule).

    For each rank p (owner of node block [p*B, (p+1)*B)): local edges have
    both endpoints in block p; remote edges have dst in block p and src
    owned by q != p. ``needed[p][q]`` = sorted unique remote sources p must
    receive from q. Every list is padded to the largest, H, so the exchange
    is one all_to_all of (n_parts, H, d) per rank. ``H_min`` / ``EL_min`` /
    ``ER_min`` force larger paddings, so plans built for edge subsets of
    one graph stack to a common shape.

    Returns a dict of rank-stacked numpy arrays:
      send_idx (n_parts, n_parts, H)  local row q sends to slot (p, k)
      src_l/dst_l/w_l/m_l (n_parts, EL)  local edges, dst block-local
      src_r/dst_r/w_r/m_r (n_parts, ER)  remote edges, src = flat halo index
      block, H
    """
    needed, pack_edges, block = _halo_partition(graph, n_parts)
    H = max(1, H_min,
            max((len(needed[p][q])
                 for p in range(n_parts) for q in range(n_parts)
                 if p != q), default=0))

    send_idx = np.zeros((n_parts, n_parts, H), np.int32)
    for p in range(n_parts):
        for q in range(n_parts):
            if p == q:
                continue
            rows = needed[p][q] - q * block   # local rows on sender q
            send_idx[q, p, :len(rows)] = rows

    plan = pack_edges(lambda p, q, pos: q * H + pos,
                      EL_min=EL_min, ER_min=ER_min)
    plan.update(send_idx=send_idx, block=block, H=H)
    return plan


def build_ring_halo_exchange(graph, n_parts: int) -> dict:
    """Ring-schedule halo plan: at hop distance s, rank q sends to
    p = (q + s) mod n_parts. Buffers are padded per shift (H_s = the most
    rows any rank needs at that distance), not to the worst pair: on a
    locality-ordered graph (rcm_order) only the s = 1 and s = n_parts - 1
    hops carry real rows.

    Returns the arrays of :func:`build_halo_exchange` with a list of
    per-shift send-index arrays (n_parts, H_s); remote srcs index the
    concatenated per-shift halo table (offsets = cumsum of H_s)."""
    needed, pack_edges, block = _halo_partition(graph, n_parts)
    # per-shift widths: at shift s, receiver p gets from q = (p - s) mod n
    H_s = [max(1, max(len(needed[p][(p - s) % n_parts])
                      for p in range(n_parts)))
           for s in range(1, n_parts)]
    offsets_s = np.concatenate([[0], np.cumsum(H_s)])  # into the halo table

    send_idx = []   # one (n_parts, H_s) array per shift: rows q sends
    for s in range(1, n_parts):
        si = np.zeros((n_parts, H_s[s - 1]), np.int32)
        for q in range(n_parts):
            p = (q + s) % n_parts
            rows = needed[p][q] - q * block
            si[q, :len(rows)] = rows
        send_idx.append(si)

    plan = pack_edges(
        lambda p, q, pos: offsets_s[(p - q) % n_parts - 1] + pos)
    plan.update(send_idx=send_idx, H_s=H_s, block=block)
    return plan


# -- edge-partitioned sparse aggregation: a rank's plan and bodies -----------

@dataclass(frozen=True, eq=False)
class EdgeSet:
    """Edges of one rank as gather / segment plans: ``src`` gathers the
    source rows (of the block or of the halo table), ``dst`` sums into the
    block's rows; ``w`` the edge weights."""
    src: Segments
    dst: Segments
    w: torch.Tensor


def _edge_set(src, dst, w, n_src: int, n_dst: int, device):
    """The plans of the real edges (None when there are none)."""
    if len(src) == 0:
        return None
    src_t = torch.as_tensor(np.asarray(src, np.int64), device=device)
    dst_t = torch.as_tensor(np.asarray(dst, np.int64), device=device)
    return EdgeSet(src=Segments.of(src_t, n_src),
                   dst=Segments.of(dst_t, n_dst),
                   w=torch.as_tensor(np.asarray(w), device=device))


@dataclass(frozen=True, eq=False)
class RankPlan:
    """A rank's part of a halo plan on its device: the gather plans of
    its send buffers (one (n_parts * H,) plan for all_to_all, one per
    shift for the ring) and its local and remote edges. The pads of the
    host plan are dropped by its real-edge masks."""
    block: int
    sends: tuple            # ((gather plan, buffer rows), ...)
    local: Optional[EdgeSet]
    remote: Optional[EdgeSet]


def rank_plan(plan: dict, p: int, device) -> RankPlan:
    """Rank ``p``'s :class:`RankPlan` of a host plan from
    :func:`build_halo_exchange` or :func:`build_ring_halo_exchange`."""
    block = int(plan["block"])
    if "H_s" in plan:
        send_rows = [np.asarray(si[p]) for si in plan["send_idx"]]
        n_halo = int(sum(plan["H_s"]))
    else:
        send_rows = [np.asarray(plan["send_idx"][p])]
        n_halo = int(np.asarray(plan["send_idx"]).shape[0]
                     * int(plan["H"]))
    sends = tuple(
        (Segments.of(torch.as_tensor(r.reshape(-1).astype(np.int64),
                                     device=device), block), r.shape)
        for r in send_rows)
    ml, mr = plan["m_l"][p], plan["m_r"][p]
    local = _edge_set(plan["src_l"][p][ml], plan["dst_l"][p][ml],
                      plan["w_l"][p][ml], block, block, device)
    remote = _edge_set(plan["src_r"][p][mr], plan["dst_r"][p][mr],
                       plan["w_r"][p][mr], n_halo, block, device)
    return RankPlan(block=block, sends=sends, local=local, remote=remote)


def halo_send(x_blk: torch.Tensor, plan: RankPlan) -> list:
    """Pre-collective part: the rank's send buffers, rows of its block
    (one (n_parts, H, ...) buffer for all_to_all, one (H_s, ...) per
    shift for the ring)."""
    tail = tuple(x_blk.shape[1:])
    return [gather(x_blk, seg).reshape(tuple(shape) + tail)
            for seg, shape in plan.sends]


class _EdgeSumFn(torch.autograd.Function):
    """``out[dst_e] += w_e x[src_e]`` over an :class:`EdgeSet`, linear in
    ``x``, without forming the (E, d) products (``Segments.bag_sum``: an
    ``embedding_bag`` per row in a fixed order). Its transpose is the same
    sum with src and dst swapped; forward mode is the map itself; a
    vmapped batch folds into the feature axis."""

    @staticmethod
    def forward(x, edges, transposed):
        seg, cols = ((edges.src, edges.dst.index) if transposed
                     else (edges.dst, edges.src.index))
        flat = x.reshape(x.shape[0], -1)
        out = flat.new_zeros((seg.n, flat.shape[1])).index_add_(
            0, seg.rows, seg.bag_sum(flat, cols, edges.w.to(x.dtype)))
        return out.reshape((seg.n,) + tuple(x.shape[1:]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.edges, ctx.transposed = inputs

    @staticmethod
    def backward(ctx, g):
        return _EdgeSumFn.apply(g, ctx.edges, not ctx.transposed), None, None

    @staticmethod
    def jvp(ctx, t, _edges, _transposed):
        return _EdgeSumFn.apply(t, ctx.edges, ctx.transposed)

    @staticmethod
    def vmap(info, in_dims, x, edges, transposed):
        xb = x.movedim(in_dims[0], -1)                  # (n, ..., B)
        return _EdgeSumFn.apply(xb, edges, transposed), xb.ndim - 1


def _edge_sum(x: torch.Tensor, edges: Optional[EdgeSet],
              block: int) -> torch.Tensor:
    if edges is None:
        return x.new_zeros((block,) + tuple(x.shape[1:]))
    return _EdgeSumFn.apply(x, edges, False)


def halo_rows(x_blk: torch.Tensor, halo_flat, plan: RankPlan,
              pending: Optional[Pending] = None) -> torch.Tensor:
    """Post-collective part of the halo SpMM: the rank's rows, the local
    edges' sum (which needs no halo) plus the remote edges' sum over the
    received halo table. ``halo_flat`` is a tensor, or a function that
    gives it once ``pending`` (the exchange, issued before) is awaited
    after the local sum."""
    out = _edge_sum(x_blk, plan.local, plan.block)
    if pending is not None:
        pending.wait()
    if plan.remote is None:
        return out
    halo = halo_flat() if callable(halo_flat) else halo_flat
    return out + _edge_sum(halo, plan.remote, plan.block)


def exchange(bufs: list, ax: Axis, ring: bool, pending: Pending):
    """The collective part, issued into ``pending``: a function that gives
    the received halo rows as one flat table once they have arrived."""
    if ring:
        got = [ppermute(b, ax, s, pending)
               for s, b in enumerate(bufs, start=1)]
        return lambda: torch.cat(got, dim=0)
    got = all_to_all(bufs[0], ax, pending)
    return lambda: got.reshape((-1,) + tuple(got.shape[2:]))


def _local_only_aggregate(mesh, graph):
    """A one-part graph axis: no halo, the plain SpMM."""
    spmm = graph.spmm if not isinstance(graph, SparseGraph) \
        else FastAggGraph(graph).spmm
    return spmm, graph_sharding(mesh).put, halo_stats(graph.n_nodes, 1, 0)


def _halo_aggregate(mesh, plan: dict, ring: bool, device):
    ax = mesh_axis(mesh)
    rp = rank_plan(plan, ax.index, device)

    def aggregate_fn(x_blk: torch.Tensor) -> torch.Tensor:
        pending = Pending()
        halo = exchange(halo_send(x_blk, rp), ax, ring, pending)
        return halo_rows(x_blk, halo, rp, pending)

    return aggregate_fn


def make_sharded_sparse_aggregate(mesh, graph, d_features: int = 0,
                                  device=None):
    """Returns ``(aggregate_fn, put)``: the edge-partitioned SpMM in which
    each rank all-gathers the feature blocks and sums its owned edges (by
    destination) into its node block; ``aggregate_fn`` takes the rank's
    row block and returns it."""
    dev = _device(mesh, device)
    n_parts = _n_parts(mesh)
    srcs, dsts, ws, block = partition_sparse_graph(graph, n_parts)
    ax = mesh_axis(mesh)
    p = ax.index
    k = int((_np(graph.dst) // block == p).sum())    # the real edges
    edges = _edge_set(srcs[p][:k], dsts[p][:k], ws[p][:k], graph.n_nodes,
                      block, dev)

    def aggregate_fn(x_blk: torch.Tensor) -> torch.Tensor:
        return _edge_sum(all_gather(x_blk, ax), edges, block)

    return aggregate_fn, graph_sharding(mesh).put


def halo_stats(n_nodes: int, n_parts: int, crossing: int) -> dict:
    """JAX's stats of a halo aggregate whose halo moves ``crossing`` rows
    per rank and application, against the rows one all-gather of the
    features moves (:func:`make_sharded_sparse_aggregate`); the bodies
    return their rows as blocks, so the halo is all that crosses."""
    allgather = n_nodes * (n_parts - 1) // n_parts
    return {"halo_rows_per_device": crossing,
            "allgather_rows_per_device": allgather,
            "comm_volume_ratio": crossing / max(allgather, 1)}


def make_halo_sparse_aggregate(mesh, graph, d_features: int = 0,
                               device=None):
    """Edge-partitioned SpMM with a halo exchange.

    Per rank and application, (n_parts - 1) * H halo rows cross the link
    (the all_to_all's self-chunk stays local) instead of the
    N * (n_parts - 1) / n_parts rows an all-gather moves
    (:func:`make_sharded_sparse_aggregate`). The all_to_all is issued
    before the local-edge sum. ``aggregate_fn`` takes the rank's row block
    and returns it. Differentiable: the cotangent takes the transposed
    exchange, so the GGN products reuse it.

    Returns ``(aggregate_fn, put, stats)``; ``stats``
    (:func:`halo_stats`) compares the rows that cross with the
    all-gather's."""
    dev = _device(mesh, device)
    n_parts = _n_parts(mesh)
    if n_parts == 1:
        return _local_only_aggregate(mesh, graph)
    plan = build_halo_exchange(graph, n_parts)
    return (_halo_aggregate(mesh, plan, False, dev),
            graph_sharding(mesh).put,
            halo_stats(graph.n_nodes, n_parts, (n_parts - 1) * plan["H"]))


def make_ring_halo_sparse_aggregate(mesh, graph, d_features: int = 0,
                                    device=None):
    """The halo SpMM whose halo rides n_parts - 1 ring hops with per-shift
    buffer sizes. Every hop is issued before the local-edge sum."""
    dev = _device(mesh, device)
    n_parts = _n_parts(mesh)
    if n_parts == 1:
        return _local_only_aggregate(mesh, graph)
    plan = build_ring_halo_exchange(graph, n_parts)
    stats = halo_stats(graph.n_nodes, n_parts, int(sum(plan["H_s"])))
    stats["H_s"] = plan["H_s"]
    return (_halo_aggregate(mesh, plan, True, dev),
            graph_sharding(mesh).put, stats)


class HaloAggGraph:
    """Stand-in for SparseGraph / FastAggGraph inside the sparse models:
    the aggregation runs edge-partitioned over the mesh's 'graph' axis with
    a halo exchange. Build the model with ``HaloAggGraph(mesh, g)`` and its
    forward, backward and KFAC taps run sharded.

    SparseGCN and SparseSAGE aggregate through ``spmm``; SparseGAT routes
    its edge softmax through :meth:`gat_aggregate` (a halo of the
    transformed h rows, the softmax over local and remote edges).
    ``schedule``: "alltoall", "ring" or "auto", which takes the ring when
    it moves less than 0.8 of the all_to_all's rows (priced from
    :func:`halo_widths`). Build the model with the rank's row block of
    the features (``put``): every layer then runs on the rank's rows, the
    aggregations take and return blocks, and the model's :attr:`row_axis`
    tells the model and its curvature that its activations are blocks."""

    def __init__(self, mesh, graph, d_features: int = 0,
                 schedule: str = "auto", device=None):
        self.device = _device(mesh, device)
        self.mesh = mesh
        self.graph = graph
        self.n_nodes = graph.n_nodes
        self.shape = (graph.n_nodes, graph.n_nodes)
        self._gat = None
        if schedule not in ("auto", "alltoall", "ring"):
            raise ValueError(f"Unknown halo schedule {schedule!r}")
        n_parts = _n_parts(mesh)
        if schedule == "auto" and n_parts > 1:
            # rows that cross: the ring pads per shift, all_to_all pads
            # every pair to the widest but keeps its self-chunk local; the
            # one collective wins unless the ring saves 20 %
            W = halo_widths(graph, n_parts)
            H = int(W.max())
            ring_rows = sum(
                max(1, max(int(W[p][(p - s) % n_parts])
                           for p in range(n_parts)))
                for s in range(1, n_parts))
            a2a_rows = (n_parts - 1) * max(1, H)
            schedule = "ring" if ring_rows < 0.8 * a2a_rows else "alltoall"
        elif schedule == "auto":
            schedule = "alltoall"     # degenerate single-part mesh
        self.schedule = schedule
        maker = (make_ring_halo_sparse_aggregate if schedule == "ring"
                 else make_halo_sparse_aggregate)
        self.spmm, self.put, self.stats = maker(mesh, graph, d_features,
                                                device=self.device)

    @property
    def row_axis(self) -> Axis:
        """The axis whose ranks hold the features' row blocks."""
        return mesh_axis(self.mesh, "graph")

    def gat_aggregate(self, h, att_src, att_dst, negative_slope):
        """Halo-partitioned GAT edge-softmax aggregation (built at first
        use, see :func:`make_halo_gat_aggregate`). ``h`` is the rank's
        (B, heads, F) block."""
        if self._gat is None:
            self._gat = make_halo_gat_aggregate(
                self.mesh, self.graph, schedule=self.schedule,
                device=self.device)[0]
        return self._gat(h, att_src, att_dst, negative_slope)


# -- GAT ----------------------------------------------------------------------

def row_attention(a_src: torch.Tensor, a_dst_blk: torch.Tensor,
                  adj_blk: torch.Tensor, h_full: torch.Tensor,
                  negative_slope: float, use_flash: bool = False,
                  row_block: Optional[int] = 512) -> torch.Tensor:
    """Post-collective part of the row-sharded GAT attention: the rank's
    (R, H, F) rows from the gathered ``a_src`` (N, H) and ``h_full`` (N, H,
    F), its ``a_dst_blk`` (R, H) and its (R, N) adjacency rows. With
    ``use_flash`` the flash kernels take the (R, N) row shard; else the
    plain attention, by blocks of ``row_block`` rows."""
    from ..models.layers import (_masked_attention_chunked,
                                 _masked_attention_dense)
    from ..ops.flash_attention import flash_masked_attention
    if use_flash:
        return flash_masked_attention(a_src, a_dst_blk, adj_blk, h_full,
                                      negative_slope)
    if row_block and row_block < adj_blk.shape[0]:
        return _masked_attention_chunked(a_src, a_dst_blk, adj_blk, h_full,
                                         negative_slope, row_block)
    return _masked_attention_dense(a_src, a_dst_blk, adj_blk, h_full,
                                   negative_slope)


class RowShardedAttention:
    """``GATConv.attention_impl`` over a row-partitioned dense adjacency
    (see :func:`make_row_sharded_gat_attention`)."""

    def __init__(self, mesh, row_block: Optional[int] = 512,
                 use_flash: bool = False):
        self.mesh = mesh
        self.row_block = row_block
        self.use_flash = use_flash

    def __call__(self, alpha_src, alpha_dst, adj_blk, h, negative_slope):
        ax = mesh_axis(self.mesh)
        a_src = all_gather(alpha_src, ax)                       # (N, H)
        h_full = all_gather(h, ax)                              # (N, H, F)
        # the adjacency enters only as a mask, with no gradient: its row
        # block never moves
        return row_attention(a_src, alpha_dst, adj_blk.detach(), h_full,
                             negative_slope, self.use_flash, self.row_block)

    def jvp_safe(self) -> "RowShardedAttention":
        """The same sharding with the plain attention: the flash Function
        has no forward-mode rule, and the curvature runs jvp passes."""
        if not self.use_flash:
            return self
        return RowShardedAttention(self.mesh, self.row_block,
                                   use_flash=False)


def make_row_sharded_gat_attention(mesh, row_block: Optional[int] = 512,
                                   use_flash: bool = False,
                                   device=None) -> RowShardedAttention:
    """Row-partitioned dense-adjacency GAT attention, the scaling path of
    dense GAT structure learning (the adjacency is the learnable N x N
    object).

    Each rank holds its (R, N) row block of the adjacency (R = N / P)
    and computes the masked softmax of its R target rows. Only the
    per-node tensors move: one all-gather of alpha_src (N, heads) and one
    of h (N, heads, F), O(N * hidden) bytes against the O(N^2)
    adjacency, which never moves. Within a rank, ``use_flash=True`` runs
    the flash kernels on the (R, N) row shard (``flash_fwd_kernel``, and
    ``flash_bwd_kernel`` + ``flash_bwd_reduce`` in the backward); else the
    plain attention by blocks of ``row_block`` rows.

    Returns an ``attention(alpha_src, alpha_dst, adj, h, negative_slope)``
    taking the rank's row blocks and returning its (R, heads, F) rows, a
    drop-in ``GATConv.attention_impl`` of a GAT run on row blocks
    (``model.placed(graph_sharding(mesh))``). Its ``jvp_safe()`` is the
    plain twin with the same sharding, which ``BaseGNN.jvp_safe`` takes
    for the curvature."""
    _device(mesh, device)
    return RowShardedAttention(mesh, row_block, use_flash)


def halo_gat_rows(h_blk: torch.Tensor, halo_flat: torch.Tensor,
                  plan: RankPlan, att_src: torch.Tensor,
                  att_dst: torch.Tensor,
                  negative_slope: float) -> torch.Tensor:
    """Post-collective part of the halo GAT: the edge softmax of each of
    the rank's rows over its local and remote edges (one shared maximum,
    summed denominators) and the aggregation, (B, heads, F). Only the real
    edges of the plan take part (a real edge may carry weight 0 and still
    counts in a softmax). The scores, exponentials and denominators run in
    float32 at least."""
    sd = torch.promote_types(h_blk.dtype, torch.float32)
    a_src_blk = torch.sum(h_blk * att_src, dim=-1).to(sd)        # (B, heads)
    a_dst_blk = torch.sum(h_blk * att_dst, dim=-1).to(sd)
    a_src_halo = torch.sum(halo_flat * att_src, dim=-1).to(sd)
    sets = []
    for a_src_, feats, edges in ((a_src_blk, h_blk, plan.local),
                                 (a_src_halo, halo_flat, plan.remote)):
        if edges is not None:
            s = _leaky_relu(gather(a_src_, edges.src)
                            + gather(a_dst_blk, edges.dst), negative_slope)
            sets.append((s, feats, edges))
    if not sets:
        return h_blk.new_zeros(h_blk.shape)
    # the row maxima are a shift that cancels in the softmax
    smax = None
    for s, _, e in sets:
        m = e.dst.reduce(s.detach(), "max")
        smax = m if smax is None else torch.maximum(smax, m)
    smax = torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))
    exs = [torch.exp(s - e.dst.gather(smax)) for s, _, e in sets]
    denom = None
    for ex, (_, _, e) in zip(exs, sets):
        part = segment_sum(ex, e.dst)
        denom = part if denom is None else denom + part
    out = None
    for ex, (_, feats, e) in zip(exs, sets):
        coeff = (ex / torch.clamp_min(gather(denom, e.dst), 1e-16)
                 ).to(feats.dtype)
        part = segment_sum(coeff[:, :, None] * gather(feats, e.src), e.dst)
        out = part if out is None else out + part
    return out


def _local_gat(graph):
    """A one-part graph axis: SparseGAT's edge softmax over the graph."""
    from ..models.sparse_gnn import segment_attention
    graph.segments("dst")
    graph.segments("src")     # the plans, formed outside any transform

    def gat_fn(h, att_src, att_dst, negative_slope):
        return segment_attention(graph, h, torch.sum(h * att_src, dim=-1),
                                 torch.sum(h * att_dst, dim=-1),
                                 negative_slope)

    return gat_fn


def make_halo_gat_aggregate(mesh, graph, schedule: str = "alltoall",
                            device=None):
    """Halo-partitioned GAT edge-softmax aggregation.

    GAT needs, per owned edge, the transformed source row h[src] (for the
    logit's a_src term and the message); h = lin(x) is row-wise, so each
    rank transforms its own block and the halo exchange moves h rows as
    the SpMM moves x rows (``schedule``: "alltoall" or "ring"). The edge
    softmax combines the local and remote edges of each destination
    (:func:`halo_gat_rows`); the pads of the plan are dropped by its
    real-edge masks, since a zero weight silences a pad in a sum but
    would still add exp(score) to a softmax denominator.

    Returns ``(gat_fn, put)`` with ``gat_fn(h_blk, att_src, att_dst,
    negative_slope) -> (B, heads, F)``: the rank's block of the (N, heads,
    F) h in, its rows out. att_src / att_dst (1, heads, F) are the values
    the rank computes with: a model passes its parameters through
    ``replicate`` once, at the entry of its ``apply``, so their gradients
    sum over the ranks there. All differentiable."""
    dev = _device(mesh, device)
    n_parts = _n_parts(mesh)
    put = graph_sharding(mesh).put
    if n_parts == 1:
        return _local_gat(graph), put
    ring = schedule == "ring"
    plan = (build_ring_halo_exchange if ring
            else build_halo_exchange)(graph, n_parts)
    ax = mesh_axis(mesh)
    rp = rank_plan(plan, ax.index, dev)

    def gat_fn(h_blk, att_src, att_dst, negative_slope):
        pending = Pending()
        halo = exchange(halo_send(h_blk, rp), ax, ring, pending)
        pending.wait()                 # the softmax needs every edge
        return halo_gat_rows(h_blk, halo(), rp, att_src, att_dst,
                             negative_slope)

    return gat_fn, put
