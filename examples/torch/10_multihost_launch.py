"""Multi-host launch flow: the exact steps a real multi-host user follows,
runnable on one machine in both modes.

Single process (the default — no env vars set):

    python examples/torch/10_multihost_launch.py [--device cpu]

Two processes over the documented env-var launch path
(parallel/distributed.py::initialize), two terminals — or let the script
spawn both for you:

    # terminal 1                               # terminal 2
    LAPLACE_GNN_COORDINATOR=localhost:9876 \\   LAPLACE_GNN_COORDINATOR=localhost:9876 \\
    LAPLACE_GNN_NUM_PROCESSES=2 \\              LAPLACE_GNN_NUM_PROCESSES=2 \\
    LAPLACE_GNN_PROCESS_ID=0 \\                 LAPLACE_GNN_PROCESS_ID=1 \\
    python examples/torch/10_multihost_launch.py --dcn 2 --device cpu
                                               (the same in terminal 2)

    # or, self-spawning (Gloo on the CPU, 2 processes of one rank each):
    python examples/torch/10_multihost_launch.py --device cpu --spawn 2

Every process joins the process group (one rank per process and device;
NCCL on ``cuda``, Gloo on the CPU), builds the hybrid ('dcn', 'graph',
'model') mesh — the 'dcn' axis crosses hosts (``--dcn`` sets its size;
the spawned processes take one slice each, as hosts would), the halo
exchange stays within a slice — and runs the differentiable KFAC marglik
of a SparseGCN over the DCN-striped graph. The printed checksums are
replicated scalars: they must be identical across processes AND across
launch modes. They are computed in float64: the 'dcn' slices sum their
stripes of the edges apart and then add the partials, and in float32 that
other order moves the gradient norm in its seventh digit (67.197266 in one
process, 67.197281 in two), below what float64 prints here.

A single process without the variables joins a group of its own (a file
rendezvous in a temporary directory). NCCL takes one process per card,
so two processes on one card run only with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

# runnable from a clean checkout: running the script puts examples/torch/
# (not the repo root) on sys.path, and the --spawn
# children start bare interpreters
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import torch.distributed as dist  # noqa: E402

from laplace_gnn_torch import resolve_device  # noqa: E402
from laplace_gnn_torch.graph.container import (  # noqa: E402
    sparse_from_edge_index)
from laplace_gnn_torch.models import SparseGCN  # noqa: E402
from laplace_gnn_torch.parallel import (DcnAggGraph,  # noqa: E402
                                        initialize, make_hybrid_mesh)
from laplace_gnn_torch.training.marglik_gnn import (  # noqa: E402
    make_neg_marglik_fn)


def compute(mesh, device, params=None):
    """Replicated scalars over the hybrid mesh: the -log marglik of a
    SparseGCN over the DCN-striped graph and the norm of its gradient.
    ``params`` (a flat dict) replaces the weights drawn with seed 1."""
    rng = np.random.default_rng(7)
    n, d, c = 64, 16, 4
    ei = np.stack([rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)])
    f64 = torch.float64
    g = sparse_from_edge_index(ei, n, normalize="sym", dtype=f64,
                               device=device)
    X = torch.as_tensor(rng.standard_normal((n, d)), dtype=f64,
                        device=device)
    y = torch.as_tensor(rng.integers(0, c, n), device=device)

    G = DcnAggGraph(mesh, g, device=device)
    model = SparseGCN(d, 16, c, 2, G.put(X), G, dropout_p=0.0,
                      device=device, dtype=f64)
    if params is None:
        params = model.init(torch.Generator().manual_seed(1))
    nm_fn = make_neg_marglik_fn(model, "classification", "kron", "all", N=n)
    p = {k: v.detach().to(f64).requires_grad_(True)
         for k, v in params.items()}
    nm = nm_fn(p, torch.arange(n, device=device), y)
    grads = torch.autograd.grad(nm, list(p.values()))
    gnorm = torch.sqrt(sum(torch.sum(t * t) for t in grads))
    return float(nm.detach()), float(gnorm)


def run_worker(device, dcn=None):
    """Join the group, build the mesh, print and return the scalars."""
    own = not dist.is_initialized()
    multi = initialize(device=device)  # LAPLACE_GNN_* env vars; False if unset
    if not dist.is_initialized():
        initialize(f"file://{tempfile.mkdtemp()}/rendezvous", 1, 0,
                   device=device)
    try:
        mesh = make_hybrid_mesh(dcn_parallel=dcn, device=device)
        pid, nproc = dist.get_rank(), dist.get_world_size()
        mode = f"process {pid}/{nproc}" if multi else "single process"
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"[{mode}] devices={nproc} mesh={shape}")

        nm, gnorm = compute(mesh, device)
        print(f"[{mode}] neg_marglik={nm:.6f} |grad|={gnorm:.6f}  "
              "(replicated: identical on every process and launch mode)")
    finally:
        if own:
            dist.destroy_process_group()
    return nm, gnorm


def spawn(n: int, device: str) -> None:
    """Start ``n`` processes of this script on a file rendezvous in a
    temporary directory, one 'dcn' slice each, and print each one's output
    after it ends."""
    tmp = tempfile.mkdtemp(prefix="laplace_gnn_10_")
    env_base = {k: v for k, v in os.environ.items()
                if not k.startswith("LAPLACE_GNN_")}
    procs, logs = [], []
    for pid in range(n):
        env = dict(env_base,
                   LAPLACE_GNN_COORDINATOR=f"file://{tmp}/rendezvous",
                   LAPLACE_GNN_NUM_PROCESSES=str(n),
                   LAPLACE_GNN_PROCESS_ID=str(pid))
        logs.append(open(os.path.join(tmp, f"process{pid}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--device", device,
             "--dcn", str(n)], env=env, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    rc = [p.wait() for p in procs]
    for log in logs:
        log.seek(0)
        print(log.read(), end="")
        log.close()
    if any(rc):
        raise SystemExit(f"worker exit codes: {rc}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--spawn", type=int, default=None,
                        help="start this many processes")
    parser.add_argument("--dcn", type=int, default=None,
                        help="the 'dcn' axis' size (default: the hosts)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    if args.spawn:
        return spawn(args.spawn, args.device)
    return run_worker(dev, args.dcn)


if __name__ == "__main__":
    main()
