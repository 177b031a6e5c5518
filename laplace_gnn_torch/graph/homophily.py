"""Homophily and interaction metrics of a graph (numpy; counterpart of
``laplace_gnn_tpu/graph/homophily.py``): global and local homophily,
receptive-field degree, interaction bounds, label informativeness, the
test receptive field and the edge difference of two graphs.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..profiling import annotate
from .data import edge_index_to_adj


def _no_diag(adj) -> np.ndarray:
    adj = np.array(adj, copy=True, dtype=float)
    np.fill_diagonal(adj, 0)
    return adj


@annotate("eval.homophily")
def global_homophily(adj, labels) -> float:
    """Fraction of edges connecting same-label nodes (the span
    ``eval.homophily``)."""
    adj = _no_diag(adj)
    labels = np.asarray(labels)
    rows, cols = np.nonzero(adj)
    if len(rows) == 0:
        return 0.0
    return float(np.mean(labels[rows] == labels[cols]))


def local_homophily(adj, nodes, labels) -> dict:
    """Per-node fraction of same-label neighbors."""
    adj = _no_diag(adj)
    labels = np.asarray(labels)
    out = {}
    for u in np.asarray(nodes).tolist():
        neigh = np.nonzero(adj[u])[0]
        out[u] = (float(np.mean(labels[neigh] == labels[u]))
                  if len(neigh) else 0.0)
    return out


def avg_local_homophilies(adj, train_nodes, test_nodes, labels):
    """(global, mean local over train nodes, mean local over test nodes)."""
    g = global_homophily(adj, labels)
    tr = local_homophily(adj, train_nodes, labels)
    te = local_homophily(adj, test_nodes, labels)
    return (g, sum(tr.values()) / len(train_nodes),
            sum(te.values()) / len(test_nodes))


def _normalize(adj: np.ndarray) -> np.ndarray:
    """D^-1/2 A^T D^-1/2 with D the row sums (``ops.normalize_adj`` in
    numpy)."""
    rowsum = adj.sum(axis=1)
    d = np.where(rowsum > 0, 1.0 / np.sqrt(np.maximum(rowsum, 1e-38)), 0.0)
    return d[:, None] * adj.T * d[None, :]


def _undirected(adj) -> np.ndarray:
    adj = np.asarray(adj, dtype=float)
    return ((adj + adj.T) > 0).astype(float)


def avg_receptive_field_degree(adj, nodes, n_layers: int) -> float:
    """Mean number of other nodes within ``n_layers`` hops of ``nodes``."""
    adj = _undirected(adj)
    np.fill_diagonal(adj, 1.0)
    adj = np.linalg.matrix_power(adj, n_layers)
    np.fill_diagonal(adj, 0.0)
    nodes = np.asarray(nodes)
    return float(np.count_nonzero(adj[nodes, :])) / len(nodes)


def interaction_bound(labels, edge_index=None, adj=None, n_layers: int = 2,
                      test_nodes=None):
    """(same-class mass, cross-class mass) of the ``n_layers``-th power of
    the normalized undirected adjacency, over the rows and columns of
    ``test_nodes`` when given (the oversquashing bound)."""
    if edge_index is None and adj is None:
        raise ValueError("Either edge_index or adj must be provided")
    labels = np.asarray(labels)
    if adj is None:
        adj = edge_index_to_adj(edge_index, labels.shape[0])
    norm_adj = np.linalg.matrix_power(_normalize(_undirected(adj)),
                                      n_layers)
    if test_nodes is not None:
        test_nodes = np.asarray(test_nodes)
        keep = np.zeros_like(norm_adj)
        keep[test_nodes, :] = norm_adj[test_nodes, :]
        keep[:, test_nodes] = norm_adj[test_nodes, :].T
        norm_adj = keep
    total = norm_adj.sum()
    same = 0.0
    for c in np.unique(labels):
        nodes = np.nonzero(labels == c)[0]
        same += norm_adj[np.ix_(nodes, nodes)].sum()
    return float(same), float(total - same)


def label_informativeness(labels, edge_index=None, adj=None) -> float:
    """LI = 2 - H(edge label pairs) / H(degree-weighted labels)."""
    labels = np.asarray(labels)
    if adj is None:
        adj = edge_index_to_adj(edge_index, labels.shape[0])
    adj = _undirected(adj)
    np.fill_diagonal(adj, 0)
    total = adj.sum()
    rows, cols = np.nonzero(adj)
    joint = defaultdict(int)
    for i, j in zip(rows, cols):
        joint[tuple(sorted((labels[i], labels[j])))] += 1
    p_joint = np.array([v / total for v in joint.values()])
    deg = adj.sum(axis=1)
    p_c = np.array([deg[labels == c].sum() / total
                    for c in range(labels.max() + 1)])
    p_c = p_c[p_c > 0]
    return float(2 - (p_joint * np.log(p_joint)).sum()
                 / (p_c * np.log(p_c)).sum())


def test_receptive_field(adj, train_nodes, test_nodes, n_layers: int):
    """How many train nodes' ``n_layers``-hop receptive fields hold each
    test node."""
    adj = np.linalg.matrix_power(np.asarray(adj, dtype=float), n_layers)
    adj = (adj > 0).astype(int)
    np.fill_diagonal(adj, 0)
    return adj[np.ix_(np.asarray(train_nodes),
                      np.asarray(test_nodes))].sum(axis=0)


def edge_diff(old_adj, new_adj, labels) -> dict:
    """Added and deleted edges between two graphs, each split into
    intra- and inter-class counts."""
    labels = np.asarray(labels)
    old = set(map(tuple, np.stack(np.nonzero(_no_diag(old_adj))).T.tolist()))
    new = set(map(tuple, np.stack(np.nonzero(_no_diag(new_adj))).T.tolist()))
    deleted, added = old - new, new - old

    def count(edges):
        intra = sum(1 for i, j in edges if labels[i] == labels[j])
        return intra, len(edges) - intra

    d_intra, d_inter = count(deleted)
    a_intra, a_inter = count(added)
    return {"n_del": len(deleted), "del_intra": d_intra,
            "del_inter": d_inter, "n_add": len(added),
            "add_intra": a_intra, "add_inter": a_inter}
