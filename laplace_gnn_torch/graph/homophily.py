"""Homophily metrics of a learned graph (numpy; counterpart of the
global/local homophily functions in ``laplace_gnn_tpu/graph/homophily.py``).
"""

from __future__ import annotations

import numpy as np


def _no_diag(adj) -> np.ndarray:
    adj = np.array(adj, copy=True, dtype=float)
    np.fill_diagonal(adj, 0)
    return adj


def global_homophily(adj, labels) -> float:
    """Fraction of edges connecting same-label nodes."""
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
