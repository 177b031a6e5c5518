"""Joining a multi-process run, and the hybrid ('dcn', 'graph', 'model')
mesh across hosts.

Counterpart of ``laplace_gnn_tpu/parallel/distributed.py`` on
``torch.distributed``, one process per device: NCCL between cards, Gloo
between CPU processes.

- :func:`initialize` joins the process group.
- :func:`make_hybrid_mesh` builds a 3-D ``DeviceMesh`` whose 'dcn' axis
  varies slowest by host: the ranks of one dcn slice share a host (their
  'graph' and 'model' collectives ride NVLink), and the slices are joined
  by the network. Its arithmetic is the pure :func:`hybrid_grid`.
- :func:`make_dcn_halo_aggregate` stripes the edges over the 'dcn' slices
  (:func:`stripe_edges`): within a slice the halo bodies of
  :mod:`.sharded` exchange boundary rows over 'graph', each slice sums its
  own edges into a partial row block, and one sum of the (N / n_graph, d)
  partials over 'dcn' is all that crosses hosts.
  :func:`make_dcn_gat_aggregate` does the same for GAT's edge softmax: a
  maximum over 'dcn' of the per-destination maxima (a shift, taken
  constant), then one fused sum of (denominator, numerator).
- :class:`DcnAggGraph` is a graph whose ``spmm`` / ``gat_aggregate`` are
  these, so SparseGCN / SparseSAGE / SparseGAT and the KFAC marglik run on
  it unchanged.

A body's features are the rank's row block over 'graph', the same on every
dcn slice. Each slice's partial depends on it through the slice's own
edges, so the block enters the body through ``replicate`` over 'dcn' (its
cotangent sums the slices') and the partials leave through
``sum_replicated`` (every slice then uses the sum alike): the transposes
JAX's ``shard_map`` gives a value replicated over 'dcn'.
"""

from __future__ import annotations

import os
import socket
import types
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..graph.container import _leaky_relu, gather, segment_sum
from .collectives import (Pending, mesh_axis, pmax_shift, replicate,
                          sum_replicated)
from .mesh import check_group, graph_sharding
from .sharded import (RankPlan, _device, _edge_set, _edge_sum,
                      _halo_partition, _local_only_aggregate, _np,
                      build_halo_exchange, exchange, halo_rows, halo_send,
                      make_halo_gat_aggregate, rank_plan)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> bool:
    """Join the process group (idempotent); True when the run has more
    than one process after the call.

    The arguments default to the environment variables
    ``LAPLACE_GNN_COORDINATOR`` (``host:port`` of process 0, or a
    ``tcp://`` / ``file://`` rendezvous URL),
    ``LAPLACE_GNN_NUM_PROCESSES`` and ``LAPLACE_GNN_PROCESS_ID``. With
    neither an address nor a process count it does nothing and returns
    False. The group uses NCCL on ``cuda`` (the default) and Gloo when the
    caller passes ``device="cpu"``."""
    coordinator_address = coordinator_address or os.environ.get(
        "LAPLACE_GNN_COORDINATOR")
    if num_processes is None and "LAPLACE_GNN_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LAPLACE_GNN_NUM_PROCESSES"])
    if process_id is None and "LAPLACE_GNN_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LAPLACE_GNN_PROCESS_ID"])
    if not dist.is_initialized():
        if coordinator_address is None and num_processes is None:
            return False
        backend = "nccl" if resolve_device(device).type == "cuda" \
            else "gloo"
        if coordinator_address is None:
            init_method = "env://"
        elif "://" in coordinator_address:      # tcp://... or file://...
            init_method = coordinator_address
        else:
            init_method = f"tcp://{coordinator_address}"
        dist.init_process_group(
            backend, init_method=init_method,
            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


# -- the hybrid mesh ----------------------------------------------------------

def hybrid_grid(n_ranks: int, hosts: Sequence[int],
                dcn_parallel: Optional[int] = None, model_parallel: int = 1,
                n_devices: Optional[int] = None) -> np.ndarray:
    """The ranks of a (dcn, graph, model) mesh as an int array of that
    shape, by JAX's arithmetic with hosts for its processes: ``hosts[r]``
    is rank r's host. The ranks are ordered by (host, rank), so 'dcn'
    varies slowest by host; ``dcn_parallel`` defaults to the number of
    hosts. Raises ValueError as JAX's ``make_hybrid_mesh`` does: a device
    limit on several hosts, a dcn size that neither divides nor is divided
    by the hosts, and devices that do not divide by dcn x model; and when
    the mesh would leave out ranks of the run."""
    if len(hosts) != n_ranks:
        raise ValueError(f"{len(hosts)} hosts for {n_ranks} ranks")
    n_hosts = len(set(hosts))
    n = n_ranks
    if n_devices is not None:
        if n_hosts > 1:
            raise ValueError("n_devices limit is single-process only")
        n = n_devices
    if dcn_parallel is None:
        dcn_parallel = n_hosts
    if dcn_parallel % n_hosts != 0 and n_hosts % dcn_parallel != 0:
        raise ValueError(f"dcn_parallel={dcn_parallel} incompatible with "
                         f"{n_hosts} processes")
    if n % (dcn_parallel * model_parallel) != 0:
        raise ValueError(f"{n} devices not divisible by dcn_parallel * "
                         f"model_parallel = {dcn_parallel}*{model_parallel}")
    if n != n_ranks:
        raise ValueError(f"a mesh of {n} devices in a run of {n_ranks} "
                         f"processes: the mesh spans every process")
    graph_parallel = n // (dcn_parallel * model_parallel)
    order = sorted(range(n), key=lambda r: (hosts[r], r))
    return np.asarray(order).reshape(dcn_parallel, graph_parallel,
                                     model_parallel)


def _hosts_of_ranks() -> list:
    """Each rank's host, as the index of its host name in the order the
    ranks first name it (one all-gather of the names)."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    first = {}
    for name in names:
        first.setdefault(name, len(first))
    return [first[name] for name in names]


def make_hybrid_mesh(dcn_parallel: Optional[int] = None,
                     model_parallel: int = 1,
                     axis_names: Sequence[str] = ("dcn", "graph", "model"),
                     n_devices: Optional[int] = None, device=None,
                     allow_fake: bool = False):
    """A 3-D ``DeviceMesh`` ('dcn', 'graph', 'model') over the run's
    processes (:func:`hybrid_grid`): each host's ranks form graph x model
    tiles, and 'dcn' neighbours sit on different hosts. ``dcn_parallel``
    defaults to the number of hosts and, when larger, splits each host's
    ranks further (for tests on one host). Join the process group first
    (:func:`initialize`): NCCL on ``cuda`` (the default), Gloo with
    ``device="cpu"``, a fake group only with ``allow_fake=True``."""
    dev = resolve_device(device)
    check_group(dev, allow_fake)
    grid = hybrid_grid(dist.get_world_size(), _hosts_of_ranks(),
                       dcn_parallel, model_parallel, n_devices)
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.as_tensor(grid),
                      mesh_dim_names=tuple(axis_names))


# -- edge striping and the DCN plans -----------------------------------------

def stripe_edges(graph, n_dcn: int) -> list:
    """Round-robin edge striping: slice k owns edges ``k::n_dcn``.

    Returns n_dcn views (n_nodes / src / dst / weights as numpy arrays)
    over the same node set, the inputs of the per-slice halo plans.
    Striping balances the edge counts and spreads each block's boundary
    over the slices."""
    src, dst, w = _np(graph.src), _np(graph.dst), _np(graph.weights)
    return [types.SimpleNamespace(n_nodes=graph.n_nodes, src=src[k::n_dcn],
                                  dst=dst[k::n_dcn], weights=w[k::n_dcn])
            for k in range(n_dcn)]


def dcn_halo_plans(graph, slices: list, n_graph: int):
    """Each slice's all_to_all halo plan over 'graph', built with the
    paddings H / EL / ER common to the slices (the remote sources index a
    halo table of width H, so H is fixed before packing). Returns (plans,
    H)."""
    block = graph.n_nodes // n_graph
    widths, els, ers = [], [], []
    for s in slices:
        needed, _, _ = _halo_partition(s, n_graph)
        widths.append(max((len(needed[p][q]) for p in range(n_graph)
                           for q in range(n_graph) if p != q), default=0))
        o_src = np.asarray(s.src) // block
        o_dst = np.asarray(s.dst) // block
        els.append(int(max(((o_dst == p) & (o_src == p)).sum()
                           for p in range(n_graph))))
        ers.append(int(max(((o_dst == p) & (o_src != p)).sum()
                           for p in range(n_graph))))
    H = max(1, max(widths))
    EL, ER = max(1, max(els)), max(1, max(ers))
    return [build_halo_exchange(s, n_graph, H_min=H, EL_min=EL, ER_min=ER)
            for s in slices], H


def _mesh_sizes(mesh):
    names = mesh.mesh_dim_names
    return (int(mesh.size(names.index("dcn"))),
            int(mesh.size(names.index("graph"))))


def _stripe_plan(s, n_nodes: int, device) -> RankPlan:
    """A slice's stripe over the whole graph (a one-part graph axis) as a
    plan of local edges: every real edge, at whatever weight."""
    return RankPlan(block=n_nodes, sends=(), remote=None,
                    local=_edge_set(s.src, s.dst, s.weights, n_nodes,
                                    n_nodes, device))


# -- the DCN SpMM -------------------------------------------------------------

def make_dcn_halo_aggregate(mesh, graph, d_features: int = 0, device=None):
    """Edge-striped, halo-exchanged SpMM over a ('dcn', 'graph'[,
    'model']) mesh.

    DCN slice k owns edges ``k::n_dcn``; within the slice the boundary rows
    move over 'graph' (one all_to_all, issued before the local edges' sum
    so that it overlaps). The partial blocks are then summed over 'dcn',
    the only collective that crosses hosts. ``aggregate_fn`` takes the
    rank's row block and returns its rows of the product. Differentiable
    (the transpose is the 'dcn' replication, then the transposed
    exchange), so the GGN / KFAC products reuse the path.

    Returns ``(aggregate_fn, put, stats)`` with JAX's stats keys."""
    dev = _device(mesh, device)
    n_dcn, n_graph = _mesh_sizes(mesh)
    if n_dcn == 1 and n_graph == 1:
        return _local_only_aggregate(mesh, graph)
    slices = stripe_edges(graph, n_dcn)
    if n_graph == 1:
        return _dcn_only_aggregate(mesh, graph, slices, dev)
    plans, H = dcn_halo_plans(graph, slices, n_graph)
    dcn, ax = mesh_axis(mesh, "dcn"), mesh_axis(mesh, "graph")
    rp = rank_plan(plans[dcn.index], ax.index, dev)

    def aggregate_fn(x_blk: torch.Tensor) -> torch.Tensor:
        x_blk = replicate(x_blk, dcn)
        pending = Pending()
        halo = exchange(halo_send(x_blk, rp), ax, False, pending)
        return sum_replicated(halo_rows(x_blk, halo, rp, pending), dcn)

    stats = {"halo_rows_per_device": (n_graph - 1) * H,
             "dcn_psum_rows_per_device": int(plans[0]["block"]),
             "H": H, "n_dcn": n_dcn, "n_graph": n_graph}
    return aggregate_fn, graph_sharding(mesh).put, stats


def _dcn_only_aggregate(mesh, graph, slices: list, device):
    """A one-part graph axis: each dcn slice sums its edge stripe over
    the whole features, then the sum over 'dcn'."""
    dcn = mesh_axis(mesh, "dcn")
    n = graph.n_nodes
    plan = _stripe_plan(slices[dcn.index], n, device)

    def aggregate_fn(x: torch.Tensor) -> torch.Tensor:
        return sum_replicated(_edge_sum(replicate(x, dcn), plan.local, n),
                              dcn)

    stats = {"halo_rows_per_device": 0, "dcn_psum_rows_per_device": n,
             "H": 0, "n_dcn": len(slices), "n_graph": 1}
    return aggregate_fn, graph_sharding(mesh).put, stats


# -- the DCN GAT --------------------------------------------------------------

def dcn_gat_sets(h_blk: torch.Tensor, halo_flat: torch.Tensor,
                 plan: RankPlan, att_src: torch.Tensor,
                 att_dst: torch.Tensor, negative_slope: float):
    """First part of the DCN GAT body: the slice's edge sets of the rank's
    rows (local and remote, each with its scores, sources and plan) and
    their per-destination score maxima (B, heads), -inf where a row has
    no edge in the slice. The scores run in float32 at least."""
    sd = torch.promote_types(h_blk.dtype, torch.float32)
    a_src_blk = torch.sum(h_blk * att_src, dim=-1).to(sd)
    a_dst_blk = torch.sum(h_blk * att_dst, dim=-1).to(sd)
    a_src_halo = torch.sum(halo_flat * att_src, dim=-1).to(sd)
    sets = []
    smax = a_dst_blk.new_full(a_dst_blk.shape, -torch.inf)
    for a_src_, feats, edges in ((a_src_blk, h_blk, plan.local),
                                 (a_src_halo, halo_flat, plan.remote)):
        if edges is not None:
            s = _leaky_relu(gather(a_src_, edges.src)
                            + gather(a_dst_blk, edges.dst), negative_slope)
            sets.append((s, feats, edges))
            smax = torch.maximum(smax, edges.dst.reduce(s.detach(), "max"))
    return sets, smax


def finite_shift(smax: torch.Tensor) -> torch.Tensor:
    """The softmax shift with 0 on rows that have no edge anywhere."""
    return torch.where(torch.isfinite(smax), smax, torch.zeros_like(smax))


def dcn_gat_partial(sets: list, smax: torch.Tensor,
                    h_blk: torch.Tensor) -> torch.Tensor:
    """The slice's partial (denominator, numerator) of each of the rank's
    rows, one (B, heads, 1 + F) tensor, at the global shift ``smax``."""
    b, heads, f = h_blk.shape
    both = smax.new_zeros((b, heads, f + 1))
    for s, feats, e in sets:
        ex = torch.exp(s - e.dst.gather(smax))[:, :, None]
        both = both + segment_sum(torch.cat(
            [ex, ex * gather(feats, e.src).to(smax.dtype)], dim=-1), e.dst)
    return both


def dcn_gat_quotient(both: torch.Tensor, dtype) -> torch.Tensor:
    """numerator / denominator of the summed partials, (B, heads, F)."""
    return (both[..., 1:] / torch.clamp_min(both[..., :1], 1e-16)).to(dtype)


def dcn_gat_rows(h_blk: torch.Tensor, halo_flat: torch.Tensor,
                 plan: RankPlan, att_src: torch.Tensor,
                 att_dst: torch.Tensor, negative_slope: float,
                 dcn) -> torch.Tensor:
    """The DCN GAT body after the halo exchange: the slice's maxima made
    global by a maximum over 'dcn' (a shift that cancels, taken
    constant), the slice's partial denominators and numerators summed
    over 'dcn' in one collective, and the quotient. Every rank takes part
    in both collectives, with or without edges."""
    sets, smax = dcn_gat_sets(h_blk, halo_flat, plan, att_src, att_dst,
                              negative_slope)
    smax = finite_shift(pmax_shift(smax, dcn))
    both = sum_replicated(dcn_gat_partial(sets, smax, h_blk), dcn)
    return dcn_gat_quotient(both, h_blk.dtype)


def make_dcn_gat_aggregate(mesh, graph, device=None):
    """Edge-striped GAT edge softmax over a ('dcn', 'graph'[, 'model'])
    mesh.

    A destination's edges are split over the slices, so neither its
    softmax shift nor its denominator is local to one slice. Each slice
    takes its edges' per-destination score maxima; one maximum over 'dcn'
    makes the shift global (taken constant: the softmax does not depend on
    it, so the gradients stay exact). Each slice then forms its partial
    numerator (B, heads, F) and denominator (B, heads); one fused sum over
    'dcn' completes both, and the quotient is the output
    (:func:`dcn_gat_rows`). Within a slice the boundary h rows move over
    'graph' as the SpMM's do, with the same common paddings. With one dcn
    slice it is :func:`~.sharded.make_halo_gat_aggregate`.

    Returns ``(gat_fn, put)`` with ``gat_fn(h_blk, att_src, att_dst,
    negative_slope) -> (B, heads, F)``: the rank's row block of h in, its
    rows out; att_src / att_dst (1, heads, F) as a model's apply gives
    them (see :func:`~.sharded.make_halo_gat_aggregate`)."""
    dev = _device(mesh, device)
    n_dcn, n_graph = _mesh_sizes(mesh)
    if n_dcn == 1:
        return make_halo_gat_aggregate(mesh, graph, device=dev)
    slices = stripe_edges(graph, n_dcn)
    dcn, ax = mesh_axis(mesh, "dcn"), mesh_axis(mesh, "graph")
    put = graph_sharding(mesh).put
    if n_graph == 1:
        rp = _stripe_plan(slices[dcn.index], graph.n_nodes, dev)
    else:
        plans, _ = dcn_halo_plans(graph, slices, n_graph)
        rp = rank_plan(plans[dcn.index], ax.index, dev)

    def gat_fn(h_blk, att_src, att_dst, negative_slope):
        h_blk, att_src, att_dst = (replicate(t, dcn)
                                   for t in (h_blk, att_src, att_dst))
        if n_graph == 1:
            halo = h_blk[:0]
        else:
            pending = Pending()
            halo = exchange(halo_send(h_blk, rp), ax, False, pending)
            pending.wait()                 # the softmax needs every edge
            halo = halo()
        return dcn_gat_rows(h_blk, halo, rp, att_src, att_dst,
                            negative_slope, dcn)

    return gat_fn, put


class DcnAggGraph:
    """A graph (like :class:`~.sharded.HaloAggGraph`) whose ``spmm`` runs
    edge-striped over 'dcn' with the halo exchange over 'graph'. Build a
    sparse model on it with the rank's row block of the features
    (``put``) and its forward, backward and differentiable KFAC marglik
    run across hosts. SparseGCN / SparseSAGE aggregate through
    :meth:`spmm`; SparseGAT routes its edge softmax through
    :meth:`gat_aggregate` (built at first use, see
    :func:`make_dcn_gat_aggregate`)."""

    def __init__(self, mesh, graph, d_features: int = 0, device=None):
        self.device = _device(mesh, device)
        self.mesh = mesh
        self.graph = graph
        self.n_nodes = graph.n_nodes
        self.shape = (graph.n_nodes, graph.n_nodes)
        self._gat = None
        self.spmm, self.put, self.stats = make_dcn_halo_aggregate(
            mesh, graph, d_features, device=self.device)

    @property
    def row_axis(self):
        """The axis whose ranks hold the features' row blocks."""
        return mesh_axis(self.mesh, "graph")

    def gat_aggregate(self, h, att_src, att_dst, negative_slope):
        """The DCN-striped GAT edge softmax; ``h`` is the rank's (B,
        heads, F) block."""
        if self._gat is None:
            self._gat = make_dcn_gat_aggregate(self.mesh, self.graph,
                                               device=self.device)[0]
        return self._gat(h, att_src, att_dst, negative_slope)
