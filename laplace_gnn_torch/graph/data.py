"""Dense adjacency <-> edge index (numpy; counterpart of the same two
functions in ``laplace_gnn_tpu/graph/data.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def edge_index_to_adj(edge_index, num_nodes: Optional[int] = None,
                      edge_weight=None) -> np.ndarray:
    """Dense adjacency from a (2, E) edge index."""
    edge_index = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1 if edge_index.size else 0
    adj = np.zeros((num_nodes, num_nodes))
    w = np.ones(edge_index.shape[1]) if edge_weight is None \
        else np.asarray(edge_weight)
    np.add.at(adj, (edge_index[0], edge_index[1]), w)
    return np.minimum(adj, 1.0) if edge_weight is None else adj


def adj_to_edge_index(adj) -> np.ndarray:
    """(2, E) edge index of the off-diagonal nonzeros."""
    adj = np.array(adj, copy=True)
    np.fill_diagonal(adj, 0)
    rows, cols = np.nonzero(adj)
    return np.stack([rows, cols])
