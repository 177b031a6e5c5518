"""Learned-graph evolution figures from a whole-run training.

The paper workflow (reference gnn/plots/interaction_bounds.py driven by the
per-epoch snapshots of gnn/marglik_training.py:244-253), end to end on the
whole-run loop: `marglik_optimization_scan` keeps the entire training's
state on the device (on a GPU its train and tracking steps replay from
CUDA graphs), captures the binarized adjacency of every hyper phase ON
DEVICE, writes the same `epoch_*.pkl` files afterwards, and `graph.plots`
renders (matplotlib, imported by the plots themselves):

  - class-sorted adjacency heatmaps (initial vs final learned graph),
  - avg-local-homophily vs hyper-phase epoch,
  - intra/inter-class edge mass vs epoch,
  - degree-distribution shift.

Run: python examples/torch/11_learned_graph_evolution.py [outdir] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

# runnable from a clean checkout: the script's directory is on sys.path,
# the repository root is not
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import laplace_gnn_torch.graph as G  # noqa: E402
from laplace_gnn_torch import resolve_device  # noqa: E402
from laplace_gnn_torch.graph.data import edge_index_to_adj  # noqa: E402
from laplace_gnn_torch.graph.plots import (  # noqa: E402
    count_type_edges, get_learned_graphs, plot_adjacency_by_class,
    plot_avg_local_homophily, plot_degree_distribution,
    plot_interaction_bounds)
from laplace_gnn_torch.models import STEGCN  # noqa: E402
from laplace_gnn_torch.training import marglik_optimization_scan  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("outdir", nargs="?", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = args.outdir or tempfile.mkdtemp(prefix="learned_graphs_")
    snapdir = os.path.join(outdir, "snapshots")

    data = G.load_data("karate", n_rand_splits=1)
    tr, va, _ = data.split(0)
    adj0 = data.adjacency()
    model = STEGCN(data.num_features, 16, data.num_classes, 2,
                   data.x, adj0, dropout_p=0.0, device=dev)
    params = model.init(torch.Generator().manual_seed(0))

    # whole training as one program; snapshots captured on device
    results, params_f, losses, *_ = marglik_optimization_scan(
        model, params, tr, data.y[tr], va, data.y[va],
        lr=0.03, lr_adj=0.2, weight_decay=5e-4, n_epochs=60,
        n_hypersteps=5, n_epochs_burnin=10, marglik_frequency=10,
        model_type="stegcn", learned_graphs_dir=snapdir, y=data.y,
        device=dev)

    y = np.asarray(data.y)
    n = data.num_nodes
    epochs, homs, intras, inters = [], [], [], []
    for _, snap in get_learned_graphs(snapdir):
        epochs.append(snap["epoch"])
        homs.append(snap["homophily"])
        intra, inter = count_type_edges(snap["edge_index"], y)
        intras.append(intra)
        inters.append(inter)
        print(f"epoch {snap['epoch']:3d}: {int(snap['num_edges'])} edges, "
              f"homophily {snap['homophily']:.3f}, marglik "
              f"{snap['marglik']:.2f}")

    last_adj = edge_index_to_adj(
        next(get_learned_graphs(snapdir, epochs[-1]))[1]["edge_index"], n)
    plot_adjacency_by_class(np.asarray(adj0), y, title="Initial graph",
                            out_fn=os.path.join(outdir, "adj_initial.png"))
    plot_adjacency_by_class(np.asarray(last_adj), y, title="Learned graph",
                            out_fn=os.path.join(outdir, "adj_learned.png"))
    plot_avg_local_homophily(
        epochs, homs, homs,
        losses={"epochs": list(range(1, len(losses) + 1)),
                "train_loss": list(losses)},
        out_fn=os.path.join(outdir, "homophily.png"))
    plot_interaction_bounds(epochs, intras, inters, intras, inters,
                            out_fn=os.path.join(outdir, "edge_types.png"))
    plot_degree_distribution(np.asarray(adj0), np.asarray(last_adj),
                             out_fn=os.path.join(outdir, "degrees.png"))
    print(f"figures written to {outdir}")
    return {"outdir": outdir, "epochs": epochs}


if __name__ == "__main__":
    main()
