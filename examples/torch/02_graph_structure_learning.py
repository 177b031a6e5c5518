"""Graph structure learning with STE-GCN + differentiable KFAC marginal
likelihood (the flagship workload; counterpart of running the reference's
gnn/marglik_training.py on a small dataset).

Run: python examples/torch/02_graph_structure_learning.py [--device cpu]
"""

import argparse
import os
import sys

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
from laplace_gnn_torch.models import STEGCN  # noqa: E402
from laplace_gnn_torch.training import (  # noqa: E402
    evaluate_map, evaluate_predictive, fit_laplace, marglik_optimization)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    data = G.load_data("karate", n_rand_splits=1)
    tr, va, te = data.split(0)
    adj = data.adjacency()
    print(f"karate: {data.num_nodes} nodes, {data.num_edges} edges, "
          f"homophily={G.global_homophily(adj, data.y):.3f}")

    model = STEGCN(data.num_features, 16, data.num_classes, 2,
                   data.x, adj, dropout_p=0.0, device=dev)
    params = model.init(torch.Generator().manual_seed(0))

    results, params, losses, val_losses, neg_margliks = marglik_optimization(
        model, params, tr, data.y[tr], va, data.y[va], y=data.y,
        lr=0.03, lr_adj=0.2, weight_decay=5e-4, n_epochs=80,
        n_hypersteps=5, n_epochs_burnin=10, marglik_frequency=10,
        model_type="stegcn", log_every=40, device=dev)

    best = results["valloss"]["params"]
    learned = model.full_adj(best).detach().cpu().numpy()
    print(f"learned graph: {int(learned.sum())} edges, "
          f"homophily={G.global_homophily(learned, data.y):.3f}")

    map_metrics = evaluate_map(model, best, te, data.y[te])
    print("MAP test metrics:   ", map_metrics)
    la = fit_laplace(model, best, tr, data.y[tr])
    bayes_metrics = evaluate_predictive(la, te, data.y[te],
                                        link_approx="probit")
    print("Bayes test metrics: ", bayes_metrics)
    return {"neg_margliks": neg_margliks, "losses": losses,
            "map": map_metrics, "bayes": bayes_metrics}


if __name__ == "__main__":
    main()
