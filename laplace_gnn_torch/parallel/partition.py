"""Graph partitioning and halo-exchange planning (numpy only).

Counterpart of ``laplace_gnn_tpu/parallel/partition.py``, kept as the
port's own copy: partition nodes into contiguous blocks balanced by degree
(so each rank owns a similar number of edges), and for the sparse path
compute the halo plan, which remote node features each rank needs for its
owned edges. The dense path needs no plan (row blocks + all-gather); the
halo aggregations of :mod:`laplace_gnn_torch.parallel.sharded` fetch only
the boundary features. scipy is imported inside :func:`rcm_order` only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Partition:
    """Contiguous node blocks: rank i owns nodes [offsets[i], offsets[i+1])."""
    offsets: np.ndarray            # (n_parts + 1,)
    perm: np.ndarray               # node permutation applied before blocking

    @property
    def n_parts(self) -> int:
        return len(self.offsets) - 1

    def owner(self, node: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.offsets, node, side="right") - 1


def degree_balanced_partition(adj: np.ndarray, n_parts: int,
                              reorder: bool = False) -> Partition:
    """Split rows into contiguous blocks with (approximately) equal edge
    counts. With ``reorder=True`` nodes are first sorted by degree round-
    robin to smooth skew (cheap METIS-lite; exact METIS is unnecessary for
    the row-block dense kernel)."""
    adj = np.asarray(adj)
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    perm = np.arange(n)
    if reorder:
        order = np.argsort(-deg)
        slots = [[] for _ in range(n_parts)]
        loads = np.zeros(n_parts)
        for node in order:
            k = int(np.argmin(loads))
            slots[k].append(node)
            loads[k] += deg[node]
        perm = np.concatenate([np.array(s, dtype=int) for s in slots])
        deg = deg[perm]
    cum = np.concatenate([[0.0], np.cumsum(deg)])
    total = cum[-1]
    offsets = [0]
    for k in range(1, n_parts):
        target = total * k / n_parts
        offsets.append(int(np.searchsorted(cum, target)))
    offsets.append(n)
    offsets = np.maximum.accumulate(np.array(offsets))
    return Partition(offsets=offsets, perm=perm)


@dataclass
class HaloPlan:
    """Per-rank remote node features needed for the owned edge block."""
    # halo_indices[i]: global node ids rank i must fetch (excl. owned)
    halo_indices: list[np.ndarray]
    # local_cols[i]: for each owned edge (row-major over the local CSR),
    # the column index remapped into [0, n_owned + n_halo)
    n_owned: np.ndarray

    def halo_sizes(self) -> np.ndarray:
        return np.array([len(h) for h in self.halo_indices])


def build_halo_plan(adj: np.ndarray, part: Partition) -> HaloPlan:
    adj = np.asarray(adj)[part.perm][:, part.perm]
    halos, n_owned = [], []
    for i in range(part.n_parts):
        lo, hi = part.offsets[i], part.offsets[i + 1]
        block = adj[lo:hi]
        cols = np.unique(np.nonzero(block)[1])
        halo = cols[(cols < lo) | (cols >= hi)]
        halos.append(halo)
        n_owned.append(hi - lo)
    return HaloPlan(halo_indices=halos, n_owned=np.array(n_owned))


def rcm_order(edge_index, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node ordering from a (2, E) edge index.

    Concentrates edges near the diagonal (small bandwidth), which (a) makes
    aggregation gathers touch nearby feature rows — HBM row-buffer locality
    — and (b) minimizes halo volume for contiguous-block partitions: a node's
    neighbors land in the same or adjacent blocks.

    Returns ``order`` such that new node ``i`` is old node ``order[i]``; use
    :func:`apply_node_order` to remap a graph.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ei = np.asarray(edge_index)
    data = np.ones(ei.shape[1], dtype=np.int8)
    A = sp.csr_matrix((data, (ei[0], ei[1])), shape=(n_nodes, n_nodes))
    A = A + A.T
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def apply_node_order(edge_index, order: np.ndarray,
                     *arrays) -> tuple:
    """Relabel a graph (and per-node arrays such as X, y) under ``order``
    (new i = old order[i]): returns (new_edge_index, *reindexed_arrays)."""
    order = np.asarray(order)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    ei = inv[np.asarray(edge_index)]
    return (ei,) + tuple(np.asarray(a)[order] for a in arrays)


def bandwidth(edge_index) -> int:
    """Max |src - dst| over edges — the locality metric RCM minimizes."""
    ei = np.asarray(edge_index)
    if ei.shape[1] == 0:
        return 0
    return int(np.abs(ei[0] - ei[1]).max())


def partition_efficiency(adj: np.ndarray, part: Partition) -> dict:
    """Diagnostics: edge balance and halo volume per rank."""
    adj = np.asarray(adj)[part.perm][:, part.perm]
    edges = []
    for i in range(part.n_parts):
        lo, hi = part.offsets[i], part.offsets[i + 1]
        edges.append(adj[lo:hi].sum())
    plan = build_halo_plan(np.asarray(adj), Partition(part.offsets,
                                                      np.arange(adj.shape[0])))
    return {
        "edges_per_part": np.array(edges),
        "edge_imbalance": float(np.max(edges) / max(np.mean(edges), 1e-9)),
        "halo_sizes": plan.halo_sizes(),
    }


def edge_balanced_blocks(edge_index, n_nodes: int, n_parts: int
                         ) -> np.ndarray:
    """Contiguous node-block boundaries balancing *owned edges* (edges by
    dst) per rank, via quantiles of the in-degree prefix sum. Returns
    ``offsets`` (n_parts+1,), offsets[0]=0, offsets[-1]=n_nodes.

    Equal-size blocks (N/n_parts) can be badly edge-imbalanced on skewed
    degree distributions — the fleet pads every rank's edge list to the
    maximum, so the slowest (most-edged) rank sets the step time."""
    ei = np.asarray(edge_index)
    deg = np.bincount(ei[1], minlength=n_nodes).astype(np.int64)
    cum = np.cumsum(deg)
    total = cum[-1] if len(cum) else 0
    targets = total * np.arange(1, n_parts) / n_parts
    cuts = np.searchsorted(cum, targets, side="left") + 1
    offsets = np.concatenate([[0], cuts, [n_nodes]])
    # enforce strictly increasing (degenerate distributions)
    for i in range(1, n_parts + 1):
        offsets[i] = min(max(offsets[i], offsets[i - 1] + (i < n_parts)),
                         n_nodes)
    offsets[-1] = n_nodes
    return offsets.astype(np.int64)


def pad_to_blocks(edge_index, offsets: np.ndarray, *node_arrays):
    """Relabel nodes so every block of the variable-width partition
    ``offsets`` becomes a fixed-width block of size max-block, inserting
    isolated ghost nodes as padding. The result composes with all the
    equal-block machinery (shard_map arrays, halo plans) unchanged.

    Returns (new_edge_index, n_new_nodes, node_map, *padded_arrays) where
    ``node_map[i]`` is node i's new id and padded per-node arrays are
    zero-filled on ghosts."""
    offsets = np.asarray(offsets)
    n_parts = len(offsets) - 1
    n_nodes = int(offsets[-1])
    widths = np.diff(offsets)
    B = int(widths.max())
    owner = np.repeat(np.arange(n_parts), widths)
    node_map = owner * B + (np.arange(n_nodes) - offsets[owner])
    ei = node_map[np.asarray(edge_index)]
    n_new = n_parts * B
    out = []
    for a in node_arrays:
        a = np.asarray(a)
        padded = np.zeros((n_new,) + a.shape[1:], a.dtype)
        padded[node_map] = a
        out.append(padded)
    return (ei, n_new, node_map, *out)
