"""Sparse-graph GCN at a scale where dense adjacency is impractical, plus
edge-partitioned aggregation over the ranks of a process group.

Run: python examples/torch/04_sparse_scale.py [--device cpu]

Over a group (one process per device; `parallel.initialize` reads
LAPLACE_GNN_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID, see
examples/torch/10_multihost_launch.py), every rank also runs the
edge-partitioned SpMM on its row block of the features.
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

import torch.distributed as dist  # noqa: E402

import laplace_gnn_torch.graph as G  # noqa: E402
from laplace_gnn_torch import resolve_device  # noqa: E402
from laplace_gnn_torch.graph import sparse_from_edge_index  # noqa: E402
from laplace_gnn_torch.models import SparseGCN  # noqa: E402
from laplace_gnn_torch.parallel import initialize  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    data = G.sbm_dataset(n_nodes=20000, n_classes=8, d_features=64,
                         p_in=0.001, p_out=5e-5)
    g = sparse_from_edge_index(data.edge_index, data.num_nodes,
                               normalize="sym", device=dev)
    print(f"SBM: {data.num_nodes} nodes, {g.n_edges} edges "
          f"(dense adjacency would be "
          f"{data.num_nodes ** 2 * 4 / 1e9:.1f} GB)")

    model = SparseGCN(64, 128, 8, 2, data.x, g, dropout_p=0.0, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    tr = torch.arange(2000, device=dev)
    y = torch.as_tensor(data.y, device=dev)

    for i in range(30):
        p = {k: v.requires_grad_(True) for k, v in params.items()}
        logp = torch.log_softmax(model.apply(p, tr), -1)
        loss = -logp[torch.arange(2000, device=dev), y[tr]].mean()
        grads = torch.autograd.grad(loss, list(p.values()))
        params = {k: (v - 0.5 * g_).detach()
                  for (k, v), g_ in zip(p.items(), grads)}
    print(f"30 steps, final loss {loss.item():.3f}")

    out = None
    own = not dist.is_initialized()
    try:
        # LAPLACE_GNN_* env vars: True when they name two or more ranks
        if (initialize(device=dev)
                and data.num_nodes % dist.get_world_size() == 0):
            from laplace_gnn_torch.parallel import (
                make_mesh, make_sharded_sparse_aggregate)
            world = dist.get_world_size()
            mesh = make_mesh(model_parallel=1, device=dev)
            agg, put = make_sharded_sparse_aggregate(mesh, g, 64, device=dev)
            out = agg(put(torch.as_tensor(data.x, device=dev)))
            shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
            print(f"[rank {dist.get_rank()}/{world}] edge-partitioned "
                  f"aggregation over {shape} mesh: rows "
                  f"{tuple(out.shape)} of ({data.num_nodes}, 64), this "
                  f"rank's block")
    finally:
        if own and dist.is_initialized():
            dist.destroy_process_group()
    return {"loss": loss.item(), "n_edges": int(g.n_edges), "out": out}


if __name__ == "__main__":
    main()
