"""Analysis figures of learned graphs (counterpart of
``laplace_gnn_tpu/graph/plots.py``). Every plotter takes data, returns the
matplotlib figure and saves it when given a file name:

- the class-sorted adjacency heatmap with class-boundary lines,
- average local homophily against the epoch (with an optional twin loss
  axis),
- intra- and inter-class interaction bounds against the epoch,
- the degree distributions of two graphs side by side.

``get_learned_graphs`` reads the per-hyper-phase snapshots
(``epoch_*.pkl`` with ``edge_index``, ``marglik``, ``num_edges``,
``homophily`` and ``epoch``) that ``learned_graphs_dir`` of the trainers
in ``training/marglik_gnn.py`` writes. matplotlib is imported only when a
figure is drawn.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..ops.adjacency import power_adj
from .data import edge_index_to_adj


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def get_learned_graphs(learned_graphs_dir: str,
                       epoch_num: Optional[int] = None) -> Iterator[tuple]:
    """(file name, snapshot dict) of each saved snapshot, in epoch order,
    or of epoch ``epoch_num`` alone."""
    if epoch_num is not None:
        fns = [os.path.join(learned_graphs_dir, f"epoch_{epoch_num}.pkl")]
    else:
        fns = sorted(
            glob.glob(os.path.join(learned_graphs_dir, "epoch_*.pkl")),
            key=lambda fn: int(os.path.basename(fn)[6:-4]))
    for fn in fns:
        with open(fn, "rb") as f:
            yield fn, pickle.load(f)


def class_sort_order(labels) -> np.ndarray:
    """The node permutation that groups nodes by class (stable)."""
    labels = np.asarray(labels)
    return np.argsort(labels, kind="stable")


def count_type_edges(edge_index, labels) -> tuple[int, int]:
    """(intra-class, inter-class) edge counts."""
    labels = np.asarray(labels)
    ei = np.asarray(edge_index)
    intra = int((labels[ei[0]] == labels[ei[1]]).sum())
    return intra, ei.shape[1] - intra


def plot_adjacency_by_class(edge_index_or_adj, labels, title: str = "",
                            out_fn: Optional[str] = None, power: int = 1,
                            num_nodes: Optional[int] = None):
    """The class-sorted ``power``-th power of the undirected adjacency with
    self-loops, as a heatmap with dashed class-boundary boxes. Takes a
    (2, E) edge index or an (N, N) adjacency."""
    plt = _plt()
    labels = np.asarray(labels)
    arr = np.asarray(edge_index_or_adj)
    if arr.ndim == 2 and arr.shape[0] == 2 and (num_nodes or 0) != 2:
        adj = np.asarray(edge_index_to_adj(arr, num_nodes or labels.shape[0]))
    else:
        adj = arr.astype(float)
    order = class_sort_order(labels)
    adj = ((adj + adj.T) > 0).astype(float)
    np.fill_diagonal(adj, 1.0)
    adj = power_adj(torch.from_numpy(adj), power).numpy()
    adj = adj[np.ix_(order, order)]

    fig, ax = plt.subplots()
    ax.matshow(adj, cmap="viridis")
    # class-boundary boxes
    counts = np.bincount(labels, minlength=labels.max() + 1)
    stops = np.cumsum(counts)
    starts = stops - counts
    for start, stop in zip(starts, stops):
        s, e = start - 0.5, stop - 0.5
        ax.plot([e, e], [s, e], "r--", lw=1)
        ax.plot([s, e], [e, e], "r--", lw=1)
        ax.plot([s, s], [s, e], "r--", lw=1)
        ax.plot([s, e], [s, s], "r--", lw=1)
    ax.set_title(title)
    if out_fn:
        fig.savefig(out_fn)
    return fig


def plot_avg_local_homophily(epochs: Sequence[int],
                             train_local_hs: Sequence[float],
                             test_local_hs: Sequence[float],
                             losses: Optional[dict] = None,
                             out_fn: Optional[str] = None):
    """Average local homophily of train and test nodes against the epoch,
    with the losses on a twin axis when given (``losses`` maps 'epochs',
    'train_loss' and optionally 'val_loss' to sequences)."""
    plt = _plt()
    order = np.argsort(epochs)
    epochs = np.asarray(epochs)[order]
    fig, ax1 = plt.subplots()
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Avg Local Homophily", color="blue")
    ax1.plot(epochs, np.asarray(train_local_hs)[order],
             color="cornflowerblue", label="Train")
    ax1.plot(epochs, np.asarray(test_local_hs)[order],
             color="mediumblue", label="Test")
    ax1.tick_params(axis="y", labelcolor="blue")
    if losses is not None:
        ax2 = ax1.twinx()
        ax2.set_ylabel("Loss", color="red")
        ax2.scatter(losses["epochs"], losses["train_loss"],
                    color="palevioletred", label="Train", s=8)
        if "val_loss" in losses:
            ax2.scatter(losses["epochs"], losses["val_loss"],
                        color="crimson", label="Validation", s=8)
        ax2.tick_params(axis="y", labelcolor="red")
    fig.tight_layout()
    if out_fn:
        fig.savefig(out_fn)
    return fig


def plot_interaction_bounds(epochs: Sequence[int],
                            global_intra: Sequence[float],
                            global_inter: Sequence[float],
                            test_intra: Sequence[float],
                            test_inter: Sequence[float],
                            out_fn: Optional[str] = None):
    """Intra- and inter-class interaction mass, globally and over the test
    nodes, against the epoch."""
    plt = _plt()
    order = np.argsort(epochs)
    epochs = np.asarray(epochs)[order]
    fig, ax = plt.subplots()
    ax.set_xlabel("Epoch")
    ax.set_ylabel(
        r"$||\hat{\mathbf{A}}_{\mathrm{intra/inter}}"
        r"^{n_\mathrm{layers}}||_1$")
    ax.plot(epochs, np.asarray(global_intra)[order], color="blue",
            label="Global Intra")
    ax.plot(epochs, np.asarray(global_inter)[order], color="red",
            label="Global Inter")
    ax.plot(epochs, np.asarray(test_intra)[order], color="blue",
            linestyle="--", label="Test Intra")
    ax.plot(epochs, np.asarray(test_inter)[order], color="red",
            linestyle="--", label="Test Inter")
    ax.legend(loc="upper left")
    if out_fn:
        fig.savefig(out_fn)
    return fig


def plot_degree_distribution(adj1, adj2, labels=("Initial", "Learned"),
                             out_fn: Optional[str] = None):
    """Each node's degree in two graphs, side by side."""
    plt = _plt()
    deg1 = np.asarray(adj1).sum(axis=1)
    deg2 = np.asarray(adj2).sum(axis=1)
    n = deg1.shape[0]
    fig, ax = plt.subplots()
    ax.bar(np.arange(n) - 0.2, deg1, width=0.4, alpha=0.6, label=labels[0])
    ax.bar(np.arange(n) + 0.2, deg2, width=0.4, alpha=0.6, label=labels[1])
    ax.legend()
    ax.set_xlabel("Node")
    ax.set_ylabel("Degree")
    ax.set_title("Degree distribution")
    if out_fn:
        fig.savefig(out_fn)
    return fig
