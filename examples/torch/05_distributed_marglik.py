"""Distributed graph structure learning: the whole pipeline — GNN forward,
backward, and the differentiable-KFAC marginal likelihood — edge-partitioned
over the ranks of a process group with halo exchange.

The graph is RCM-reordered first so contiguous node blocks keep neighbors
together and the halo (boundary rows exchanged between ranks per layer)
stays a small fraction of the all-gather volume.

One process per device, on torch.distributed. A bare run is one rank;
``--spawn P`` starts P ranks (Gloo on the CPU with ``--device cpu``, one
card each with NCCL on ``cuda``); a process launched with the
LAPLACE_GNN_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID variables joins
that group (``parallel.initialize``).

Run: python examples/torch/05_distributed_marglik.py [--device cpu]
     python examples/torch/05_distributed_marglik.py --device cpu --spawn 8

The two moons come from scikit-learn and the RCM order from scipy,
imported by the functions that need them.
"""

import argparse
import os
import subprocess
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

import torch.distributed as dist  # noqa: E402

import laplace_gnn_torch.graph as G  # noqa: E402
from laplace_gnn_torch import resolve_device  # noqa: E402
from laplace_gnn_torch.curvature.losses import cross_entropy_sum  # noqa: E402
from laplace_gnn_torch.graph import sparse_from_edge_index  # noqa: E402
from laplace_gnn_torch.graph.data import get_knn_graph  # noqa: E402
from laplace_gnn_torch.models import SparseGCN  # noqa: E402
from laplace_gnn_torch.parallel import (HaloAggGraph,  # noqa: E402
                                        apply_node_order, initialize,
                                        make_mesh, rcm_order)
from laplace_gnn_torch.training.marglik_gnn import (  # noqa: E402
    make_neg_marglik_fn)


def spawn(n: int, argv: list) -> None:
    """Start ``n`` ranks of this script on a file rendezvous in a temporary
    directory and print each rank's output after it ends."""
    tmp = tempfile.mkdtemp(prefix="laplace_gnn_05_")
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith("LAPLACE_GNN_")}
    procs, logs = [], []
    for pid in range(n):
        env = dict(env_base,
                   LAPLACE_GNN_COORDINATOR=f"file://{tmp}/rendezvous",
                   LAPLACE_GNN_NUM_PROCESSES=str(n),
                   LAPLACE_GNN_PROCESS_ID=str(pid))
        logs.append(open(os.path.join(tmp, f"rank{pid}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv], env=env,
            stdout=logs[-1], stderr=subprocess.STDOUT))
    rc = [p.wait() for p in procs]
    for log in logs:
        log.seek(0)
        print(log.read(), end="")
        log.close()
    if any(rc):
        raise SystemExit(f"worker exit codes: {rc}")


def run(dev, schedule: str) -> dict:
    mesh = make_mesh(model_parallel=1, device=dev)
    rank, world = dist.get_rank(), dist.get_world_size()

    # moons + kNN graph: geometric locality, the setting where RCM +
    # ring-halo exchange pays off (community graphs without geometry keep a
    # large inherent boundary — there HaloAggGraph's auto schedule falls
    # back to the fused all_to_all)
    data = G.moons_dataset(n_samples=1024, noise=0.15, seed=0)
    _, ei = get_knn_graph(np.asarray(data.x), k=8, return_edge_index=True)
    # RCM reorder -> contiguous blocks have local neighborhoods -> small halo
    order = rcm_order(np.asarray(ei, np.int64), data.num_nodes)
    ei, X, y = apply_node_order(np.asarray(ei, np.int64), order,
                                data.x, data.y)
    g = sparse_from_edge_index(ei, data.num_nodes, normalize="sym",
                               device=dev)

    hg = HaloAggGraph(mesh, g, schedule=schedule, device=dev)
    if rank == 0:
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}; "
              f"schedule={hg.schedule}; "
              f"halo comm ratio {hg.stats['comm_volume_ratio']:.2f} "
              f"({hg.stats['halo_rows_per_device']} halo rows vs "
              f"{hg.stats['allgather_rows_per_device']} all-gather rows)")

    Xs = hg.put(torch.as_tensor(X, dtype=torch.float32, device=dev))
    d_in, n_classes = Xs.shape[1], int(np.asarray(y).max()) + 1
    model = SparseGCN(d_in, 64, n_classes, 2, Xs, hg, dropout_p=0.0,
                      device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    y = torch.as_tensor(np.asarray(y), device=dev)
    idx = torch.arange(data.num_nodes, device=dev)

    neg_marglik = make_neg_marglik_fn(model, "classification", "kron",
                                      "all", N=data.num_nodes)

    for i in range(10):
        p = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = cross_entropy_sum(model.apply(p, idx), y) / y.shape[0]
        grads = torch.autograd.grad(loss, list(p.values()))
        params = {k: (v - 0.5 * g_).detach()
                  for (k, v), g_ in zip(p.items(), grads)}
        nm = neg_marglik(params, idx, y)
    with torch.no_grad():
        acc = float((model.apply(params, idx).argmax(-1) == y)
                    .float().mean())
    loss, nm = loss.item(), float(nm)
    print(f"[rank {rank}/{world}] after 10 sharded steps: loss {loss:.6f} "
          f"neg_marglik {nm:.4f} train acc {acc:.3f}")
    assert np.isfinite(loss) and np.isfinite(nm)
    if rank == 0:
        print("distributed marglik pipeline OK")
    return {"loss": loss, "neg_marglik": nm, "accuracy": acc,
            "schedule": hg.schedule}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--spawn", type=int, default=None,
                        help="start this many ranks")
    parser.add_argument("--schedule", default="auto",
                        choices=["auto", "ring", "alltoall"],
                        help="the halo exchange's schedule")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.spawn:
        spawn(args.spawn, ["--device", args.device,
                           "--schedule", args.schedule])
        return None

    own = not dist.is_initialized()
    initialize(device=dev)  # LAPLACE_GNN_* env vars; nothing if unset
    if not dist.is_initialized():   # a bare run: a group of this process
        initialize(f"file://{tempfile.mkdtemp()}/rendezvous", 1, 0,
                   device=dev)
    try:
        return run(dev, args.schedule)
    finally:
        if own:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
