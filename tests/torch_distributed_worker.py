"""One rank of the hybrid-mesh checks of ``test_torch_distributed.py``.

    python tests/torch_distributed_worker.py RANK WORLD INIT_URL DIR DCN

joins a Gloo group of WORLD CPU processes at INIT_URL, builds the hybrid
('dcn', 'graph', 'model') mesh with DCN slices (graph = WORLD / DCN,
model 1), reads what the test wrote to DIR/inputs.pkl (JAX's parameters),
runs every check of CHECKS through ``laplace_gnn_torch.parallel`` in
float64 and writes its results (numpy; row blocks gathered whole) to
DIR/<DCN>x<GRAPH>_rank<RANK>.pkl. It imports no JAX: the test computes the JAX
side from the same data (the functions here, numpy only).
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np

N, D = 32, 8                    # the aggregates' graph and width
HEADS, F = 2, 4                 # the GAT aggregate's h


# -- data, shared with the test process (numpy only) --------------------------

def agg_edges(n=N, seed=0, e_per_node=6):
    """tests/test_distributed.py's graph: random (src, dst) pairs."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e_per_node * n),
                     rng.integers(0, n, e_per_node * n)])


def agg_inputs():
    """The SpMM's x and the GAT aggregate's h, att_src, att_dst."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, D))
    h = rng.standard_normal((N, HEADS, F))
    return x, h, rng.standard_normal((1, HEADS, F)), \
        rng.standard_normal((1, HEADS, F))


def gat_edges(n=N, seed=11):
    """tests/test_distributed.py's GAT graph (self-loops, no weights)."""
    rng = np.random.default_rng(seed)
    adj = np.minimum((rng.random((n, n)) < 0.2)
                     + (rng.random((n, n)) < 0.2).T, 1).astype(float)
    np.fill_diagonal(adj, 1)
    rows, cols = np.nonzero(adj)
    return np.stack([cols, rows])


def model_data(seed=3, n=N, d=16, c=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), rng.integers(0, c, n)


def gat_model_data(seed=12, n=N, d=8, c=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), rng.integers(0, c, n)


# -- the checks (port side) ---------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _whole(t, mesh):
    from laplace_gnn_torch.parallel.collectives import gather_rows, mesh_axis
    return _np(gather_rows(t.detach(), mesh_axis(mesh, "graph")))


def _marglik(model, params, n, y):
    import torch
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn
    fn = make_neg_marglik_fn(model, "classification", "kron", "all", N=n)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    val = fn(p, torch.arange(n), torch.as_tensor(y))
    grads = torch.autograd.grad(val, list(p.values()))
    return float(val.detach()), {k: _np(g) for k, g in zip(p, grads)}


def check_aggregates(ctx):
    """The DCN SpMM (value, gradient, stats) and the DCN GAT aggregate
    (value, gradients in h and both attention vectors)."""
    import torch
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.parallel import (make_dcn_gat_aggregate,
                                            make_dcn_halo_aggregate)
    from laplace_gnn_torch.parallel.collectives import mesh_axis, replicate
    mesh, dev, f64 = ctx["mesh"], "cpu", torch.float64
    out = {}
    x, h, att_s, att_d = (torch.as_tensor(a) for a in agg_inputs())
    g = sparse_from_edge_index(agg_edges(), N, normalize="sym", dtype=f64,
                               device=dev)
    agg, put, stats = make_dcn_halo_aggregate(mesh, g, D, device=dev)
    v = put(x).requires_grad_(True)
    val = agg(v)
    (gx,) = torch.autograd.grad(torch.sum(torch.sin(val)), v)
    out["spmm"] = (_whole(val, mesh), _whole(gx, mesh))
    out["stats"] = stats
    out["shapes"] = [tuple(t.shape) for t in (v, val, gx)]
    gg = sparse_from_edge_index(gat_edges(), N, normalize=None,
                                add_self_loops=False, dtype=f64, device=dev)
    gat, put = make_dcn_gat_aggregate(mesh, gg, device=dev)
    ax = mesh_axis(mesh, "graph")
    hb = put(h).requires_grad_(True)
    a_s, a_d = (t.clone().requires_grad_(True) for t in (att_s, att_d))
    # the attention vectors enter as a model's apply gives them
    o = gat(hb, replicate(a_s, ax), replicate(a_d, ax), 0.2)
    grads = torch.autograd.grad(torch.sum(torch.sin(o)), (hb, a_s, a_d))
    out["gat"] = (_whole(o, mesh), _whole(grads[0], mesh), _np(grads[1]),
                  _np(grads[2]))
    return out


def check_models(ctx):
    """SparseGCN and SparseGAT on a DcnAggGraph: the forward and the
    Kron -log marglik with its gradient."""
    import torch
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.models import SparseGAT, SparseGCN
    from laplace_gnn_torch.parallel import DcnAggGraph
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    mesh, dev, f64 = ctx["mesh"], "cpu", torch.float64
    out = {}
    X, y = model_data()
    g = sparse_from_edge_index(agg_edges(), N, normalize="sym", dtype=f64,
                               device=dev)
    G = DcnAggGraph(mesh, g, device=dev)
    m = SparseGCN(16, 16, 4, 2, G.put(torch.as_tensor(X)), G,
                  dropout_p=0.0, device=dev, dtype=f64)
    p = params_from_numpy(ctx["inputs"]["gcn"], device=dev)
    out["gcn_forward"] = _np(m.apply(p, torch.arange(N)))
    out["gcn_marglik"] = _marglik(m, p, N, y)
    Xg, yg = gat_model_data()
    gg = sparse_from_edge_index(gat_edges(seed=12), N, normalize=None,
                                add_self_loops=False, dtype=f64, device=dev)
    Gg = DcnAggGraph(mesh, gg, device=dev)
    mg = SparseGAT(8, 8, 3, 2, Gg.put(torch.as_tensor(Xg)), Gg, heads=2,
                   concat=False, dropout_p=0.0, device=dev, dtype=f64)
    pg = params_from_numpy(ctx["inputs"]["gat"], device=dev)
    out["gat_forward"] = _np(mg.apply(pg, torch.arange(N)))
    out["gat_marglik"] = _marglik(mg, pg, N, yg)
    return out


def check_scalars(ctx):
    """``tests/mp_worker.py``'s four scalars of the same program."""
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.models import SparseGCN
    from laplace_gnn_torch.parallel import DcnAggGraph
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    from mp_worker import build_problem
    mesh, dev, f64 = ctx["mesh"], "cpu", torch.float64
    n, d, c, ei, x, X, y, w_check = build_problem()
    g = sparse_from_edge_index(ei, n, normalize="sym", dtype=f64,
                               device=dev)
    G = DcnAggGraph(mesh, g, device=dev)
    o = torch.as_tensor(_whole(G.spmm(G.put(torch.as_tensor(
        x, dtype=f64))), mesh))
    checksum = float(torch.sum(o * torch.as_tensor(w_check, dtype=f64)))
    sq = float(torch.sum(o * o))
    m = SparseGCN(d, 16, c, 2, G.put(torch.as_tensor(X, dtype=f64)), G,
                  dropout_p=0.0, device=dev, dtype=f64)
    p = {k: v.to(f64).requires_grad_(True) for k, v in params_from_numpy(
        ctx["inputs"]["mp"], device=dev).items()}
    fn = make_neg_marglik_fn(m, "classification", "kron", "all", N=n)
    nm = fn(p, torch.arange(n), torch.as_tensor(y))
    grads = torch.autograd.grad(nm, list(p.values()))
    gnorm = float(torch.sqrt(sum(torch.sum(t * t) for t in grads)))
    return {"checksum": checksum, "sq": sq, "neg_marglik": float(nm),
            "grad_norm": gnorm}


CHECKS = {"aggregates": check_aggregates, "models": check_models,
          "scalars": check_scalars}


def main(rank: int, world: int, init: str, out_dir: str, dcn: int) -> None:
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist
    from laplace_gnn_torch.parallel import initialize, make_hybrid_mesh
    initialize(init, world, rank, device="cpu")
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = make_hybrid_mesh(dcn_parallel=dcn, device="cpu")
    ctx = {"inputs": inputs, "mesh": mesh}
    results = {"mesh_shape": tuple(int(mesh.size(i)) for i in range(3)),
               "coordinate": tuple(mesh.get_coordinate())}
    for name, check in CHECKS.items():
        if name == "scalars" and tuple(results["mesh_shape"]) != (2, 2, 1):
            continue
        results[name] = check(ctx)
    name = f"{dcn}x{world // dcn}_rank{rank}.pkl"
    with open(os.path.join(out_dir, name), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         int(sys.argv[5]))
