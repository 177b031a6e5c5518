"""Graph data container, dense adjacency <-> edge index, and the k-NN graph
(numpy; counterpart of ``laplace_gnn_tpu/graph/data.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class GraphData:
    x: np.ndarray                      # (N, D) node features
    y: np.ndarray                      # (N,) labels
    edge_index: np.ndarray             # (2, E)
    train_indices: Optional[np.ndarray] = None   # (n_train, n_splits)
    val_indices: Optional[np.ndarray] = None
    test_indices: Optional[np.ndarray] = None
    name: str = ""

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])

    @property
    def num_classes(self) -> int:
        return int(self.y.max()) + 1

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def adjacency(self, dtype=np.float32) -> np.ndarray:
        return edge_index_to_adj(self.edge_index, self.num_nodes).astype(dtype)

    def split(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (self.train_indices[:, i], self.val_indices[:, i],
                self.test_indices[:, i])


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


def knn_indices(X, k: int, row_block: int = 1024) -> np.ndarray:
    """(N, k) indices of each row's k nearest other rows by exact Euclidean
    distance in float64 (self skipped; ties go to the lower index), in
    blocks of ``row_block`` rows so the distance matrix is never N x N."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    sq = np.sum(X * X, axis=1)
    out = np.empty((n, k), dtype=np.int64)
    for r0 in range(0, n, row_block):
        rows = np.arange(r0, min(r0 + row_block, n))
        d2 = sq[rows, None] - 2.0 * (X[rows] @ X.T) + sq[None, :]
        d2[np.arange(len(rows)), rows] = np.inf
        out[rows] = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return out


def get_knn_graph(X, k: int = 3, return_edge_index: bool = False):
    """Symmetrized k-NN graph with self-loops. Exact neighbours in float64
    (no scikit-learn): on data without distance ties the same graph as the
    JAX package's ``NearestNeighbors``."""
    idx = knn_indices(X, k)
    n = idx.shape[0]
    adj = np.zeros((n, n))
    adj[np.repeat(np.arange(n), k), idx.reshape(-1)] = 1.0
    adj = ((adj + adj.T) > 0).astype(float)
    np.fill_diagonal(adj, 1.0)
    if return_edge_index:
        return adj, adj_to_edge_index(adj)
    return adj


def fully_connected_labels(labels) -> np.ndarray:
    """Block-diagonal all-ones per class."""
    labels = np.asarray(labels)
    return (labels[:, None] == labels[None, :]).astype(float)
