"""One rank of the sharded-port checks of ``test_torch_sharded.py``.

    python tests/torch_sharded_worker.py RANK WORLD INIT_URL DIR

joins a Gloo group of WORLD CPU processes at INIT_URL, reads the JAX
parameters the test wrote to DIR/inputs.pkl, runs every check of CHECKS
through ``laplace_gnn_torch.parallel`` in float64 and writes its results
(numpy arrays) to DIR/rank<RANK>.pkl. It imports no JAX: the test process
computes the JAX side from the same data (the ``*_data`` functions here,
numpy only) and compares.

Placed values and body outputs are the rank's row blocks: each check
records their shapes (``shapes``) and reports them gathered whole
(``_whole``), so every rank writes the same values, except where a check
reports the rank's own block (``ste_hyperstep``).
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np

N_AGG, D_AGG = 64, 16          # the aggregates' graph and width


# -- data, shared with the test process (numpy only) --------------------------

def agg_graph(seed: int, n: int = N_AGG, p: float = 0.15):
    """A symmetric random graph without self-loops, as (2, E) edges (src,
    dst) with its dense adjacency."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < p).astype(np.float64)
    adj = np.minimum(adj + adj.T, 1)
    np.fill_diagonal(adj, 0)
    rows, cols = np.nonzero(adj)
    return np.stack([cols, rows]), adj


def features(seed: int, n: int, d: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, d))


def banded(n: int = 128):
    """Edges within distance 3 in node order (an RCM-like layout)."""
    rows, cols = [], []
    for i in range(n - 3):
        for off in (1, 2, 3):
            rows += [i, i + off]
            cols += [i + off, i]
    return np.stack([np.array(cols), np.array(rows)])


def skewed(n: int = 100, e: int = 1500, seed: int = 10):
    """Destinations drawn by a 1/(i+1) law: hubs among the first ids."""
    rng = np.random.default_rng(seed)
    w = 1.0 / (np.arange(n) + 1)
    dst = rng.choice(n, e, p=w / w.sum())
    src = rng.integers(0, n, e)
    return np.stack([src, dst]).astype(np.int64)


def gat_graph(seed: int, n: int = 32, p: float = 0.2, zero_every=None):
    """A graph with self-loops for GAT, and its edge weights (every
    ``zero_every``-th real edge at weight 0)."""
    rng = np.random.default_rng(seed)
    adj = np.minimum((rng.random((n, n)) < p)
                     + (rng.random((n, n)) < p).T, 1).astype(float)
    np.fill_diagonal(adj, 1)
    rows, cols = np.nonzero(adj)
    w = np.ones(len(rows))
    if zero_every:
        w[::zero_every] = 0.0
    return np.stack([cols, rows]), w


def dense_gat_data(n=128, d=8, c=4, seed=13):
    """The row-sharded GAT composition's inputs (X, adj, y)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    a = (rng.random((n, n)) < 0.05).astype(np.float64)
    adj = np.minimum(a + a.T, 1.0) * (1 - np.eye(n))
    return X, adj, rng.integers(0, c, n)


def att_data(n=64, d=8, c=4, seed=14):
    """AttSTEGCN's inputs (X, adj, y)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    a = (rng.random((n, n)) < 0.1).astype(np.float64)
    adj = np.minimum(a + a.T, 1.0) * (1 - np.eye(n))
    return X, adj, rng.integers(0, c, n)


def sparse_model_data(seed=3, n=64, d=16, c=4):
    ei, _ = agg_graph(seed, n)
    rng = np.random.default_rng(seed + 100)
    return ei, rng.standard_normal((n, d)), rng.integers(0, c, n)


def step_data(n=32, d=16, c=3, seed=21):
    """The sharded train step's graph, features and labels."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.3).astype(np.float64)
    adj = np.minimum(adj + adj.T, 1.0)
    return rng.standard_normal((n, d)), adj, rng.integers(0, c, n)


STEP_LR, STEP_N = 0.1, 3


def ste_data(n=128, d=16, c=3, seed=22):
    """The composed STE-GCN hyperstep's graph, features and labels."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.08).astype(np.float64)
    adj = np.minimum(adj + adj.T, 1.0)
    return rng.standard_normal((n, d)), adj, rng.integers(0, c, n)


STE_MASKED = 40        # train nodes of the masked STE gradient


def max_saved_numel(root) -> int:
    """The most elements of a tensor that the autograd graph of ``root``
    keeps for its backward (every node's saved tensors)."""
    import torch
    seen, stack, best = set(), [root.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for name in dir(node):
            if not name.startswith("_saved_"):
                continue
            try:
                v = getattr(node, name)
            except Exception:
                continue
            for t in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(t, torch.Tensor):
                    best = max(best, t.numel())
        stack.extend(f for f, _ in node.next_functions)
    return best


# -- the checks (port side) ---------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _whole(t, mesh):
    """The whole value of the ranks' row blocks ``t`` (for the report)."""
    from laplace_gnn_torch.parallel.collectives import gather_rows, mesh_axis
    return _np(gather_rows(t.detach(), mesh_axis(mesh)))


def check_aggregates(ctx):
    import torch
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.parallel import sharded as S
    mesh, dev = ctx["mesh"], "cpu"
    out, shapes = {}, {}
    # dense: the all-gather and the ring formulations, value and gradient
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((32, 32)))
    x = torch.as_tensor(rng.standard_normal((32, 8)))
    agg, put = S.make_ring_dense_aggregate(mesh, 32, device=dev)
    for name, f in (("dense", lambda a, v: S.sharded_aggregate(mesh, a, v)),
                    ("ring_dense", agg)):
        a_, v_ = put(A).requires_grad_(True), put(x).requires_grad_(True)
        val = f(a_, v_)
        # each rank's share of the sum: the collectives' transposes sum
        # the ranks' cotangents
        ga, gv = torch.autograd.grad(torch.sum(torch.sin(val)), (a_, v_))
        shapes[name] = [tuple(t.shape) for t in (a_, v_, val, ga, gv)]
        out[name] = tuple(_whole(t, mesh) for t in (val, ga, gv))
    # sparse: all-gather, both halo schedules
    ei, _ = agg_graph(1)
    g = sparse_from_edge_index(ei, N_AGG, normalize="sym",
                               dtype=torch.float64, device=dev)
    xs = torch.as_tensor(features(2, N_AGG, D_AGG))
    makers = {"allgather": S.make_sharded_sparse_aggregate,
              "alltoall": S.make_halo_sparse_aggregate,
              "ring": S.make_ring_halo_sparse_aggregate}
    for name, maker in makers.items():
        f, put, *stats = maker(mesh, g, D_AGG, device=dev)
        v = put(xs).requires_grad_(True)
        val = f(v)
        (gx,) = torch.autograd.grad(torch.sum(val ** 2), v)
        shapes[f"sparse_{name}"] = [tuple(t.shape) for t in (v, val, gx)]
        out[f"sparse_{name}"] = (_whole(val, mesh), _whole(gx, mesh))
        if stats:
            out[f"stats_{name}"] = {k: v for k, v in stats[0].items()}
    # vmap and jvp through the halo exchange
    f, put, _ = S.make_halo_sparse_aggregate(mesh, g, D_AGG, device=dev)
    xb = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (3, N_AGG, D_AGG)))
    xb_blk = torch.stack([put(b) for b in xb])
    xs_blk = put(xs)
    vm = torch.func.vmap(f)(xb_blk)
    shapes["sparse_vmap"] = [tuple(vm.shape)]
    out["sparse_vmap"] = np.stack([_whole(b, mesh) for b in vm])
    out["sparse_jvp"] = _whole(torch.func.jvp(f, (xs_blk,),
                                              (xb_blk[0],))[1], mesh)
    # two calls, the same bits
    out["same_bits"] = bool(torch.equal(f(xs_blk), f(xs_blk)))
    # the auto schedule on a banded graph, and a bogus one
    gb = sparse_from_edge_index(banded(), 128, normalize="sym",
                                dtype=torch.float64, device=dev)
    hg = S.HaloAggGraph(mesh, gb, device=dev)
    out["auto_schedule"] = hg.schedule
    out["auto_value"] = _whole(hg.spmm(hg.put(torch.as_tensor(
        features(5, 128, 8)))), mesh)
    try:
        S.HaloAggGraph(mesh, gb, schedule="bogus", device=dev)
        out["bogus"] = None
    except ValueError as e:
        out["bogus"] = str(e)
    # a variable-width partition padded to fixed blocks
    from laplace_gnn_torch.parallel import edge_balanced_blocks, pad_to_blocks
    ei_s = skewed()
    X = features(11, 100, 8)
    ei2, n_new, node_map, X2 = pad_to_blocks(
        ei_s, edge_balanced_blocks(ei_s, 100, 4), X)
    g2 = sparse_from_edge_index(ei2, n_new, normalize=None,
                                add_self_loops=False, dtype=torch.float64,
                                device=dev)
    hg2 = S.HaloAggGraph(mesh, g2, device=dev)
    out["padded"] = (_whole(hg2.spmm(hg2.put(torch.as_tensor(X2))), mesh),
                     node_map)
    # a one-part graph axis: the local path
    ei6, _ = agg_graph(6, 32, 0.2)
    g6 = sparse_from_edge_index(ei6, 32, normalize="sym",
                                dtype=torch.float64, device=dev)
    x6 = torch.as_tensor(features(7, 32, 8))
    one = ctx["mesh_one"]
    for name, maker in (("alltoall", S.make_halo_sparse_aggregate),
                        ("ring", S.make_ring_halo_sparse_aggregate)):
        f, put, stats = maker(one, g6, 8, device=dev)
        out[f"one_part_{name}"] = (_np(f(put(x6))),
                                   stats["comm_volume_ratio"])
    hg6 = S.HaloAggGraph(one, g6, device=dev)
    out["one_part_auto"] = _np(hg6.spmm(hg6.put(x6)))
    out["shapes"] = shapes
    return out


def _marglik(model, params, idx, y, n, names=None, mesh=None, **kw):
    """(-log marglik, its gradient w.r.t. ``names``) of the port; with a
    ``mesh``, ``adj`` is the rank's row block and its gradient is
    reported whole."""
    import torch
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn
    fn = make_neg_marglik_fn(model, "classification", "kron", "all", N=n,
                             **kw)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    names = names or [k for k in p if k != "adj"]
    val = fn(p, idx, y)
    grads = torch.autograd.grad(val, [p[k] for k in names],
                                allow_unused=True)
    # a GAT's adjacency enters only as a mask: its gradient is zero
    grads = [g if g is not None else torch.zeros_like(p[k])
             for k, g in zip(names, grads)]
    return float(val.detach()), {
        k: _whole(g, mesh) if (k == "adj" and mesh is not None) else _np(g)
        for k, g in zip(names, grads)}


def check_sparse_models(ctx):
    import torch
    from laplace_gnn_torch.curvature.losses import cross_entropy_sum
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.models import SparseGAT, SparseGCN
    from laplace_gnn_torch.parallel import HaloAggGraph
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    mesh, dev, f64 = ctx["mesh"], "cpu", torch.float64
    out = {}
    ei, X, y = sparse_model_data()
    n = X.shape[0]
    g = sparse_from_edge_index(ei, n, normalize="sym", dtype=f64, device=dev)
    hg = HaloAggGraph(mesh, g, device=dev)
    m = SparseGCN(16, 8, 4, 2, hg.put(torch.as_tensor(X)), hg,
                  dropout_p=0.0, device=dev, dtype=f64)
    params = params_from_numpy(ctx["inputs"]["sparse_gcn"], device=dev)
    idx = torch.arange(n)
    yt = torch.as_tensor(y)
    out["gcn_forward"] = _np(m.apply(params, idx))
    out["shapes"] = {"X": tuple(m.X.shape),
                     "block_out": tuple(m.apply(params).shape)}
    # BatchNorm over the ranks' blocks, and a train-mode forward whose
    # dropout masks are the rows of the unsharded forward's
    mb = SparseGCN(16, 8, 4, 2, hg.put(torch.as_tensor(X)), hg,
                   dropout_p=0.0, norm="batch", device=dev, dtype=f64)
    pb = params_from_numpy(ctx["inputs"]["sparse_gcn_bn"], device=dev)
    pp = {k: v.clone().requires_grad_(True) for k, v in pb.items()}
    fb = mb.apply(pp, idx)
    out["bn_forward"] = _np(fb)
    loss = cross_entropy_sum(fb, yt) / n
    out["bn_grad"] = {k: _np(gk) for k, gk in
                      zip(pp, torch.autograd.grad(loss, list(pp.values())))}
    one = HaloAggGraph(ctx["mesh_one"], g, device=dev)
    drop = {}
    for name, graph in (("sharded", hg), ("whole", one)):
        md = SparseGCN(16, 8, 4, 2, graph.put(torch.as_tensor(X)), graph,
                       dropout_p=0.5, device=dev, dtype=f64)
        drop[name] = md.apply(params, idx, train=True,
                              generator=torch.Generator().manual_seed(5))
    out["dropout"] = {k: _np(v) for k, v in drop.items()}
    out["dropout"]["off"] = _np(m.apply(params, idx))
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = cross_entropy_sum(m.apply(p, idx), yt) / n
    out["gcn_grad"] = {k: _np(gk) for k, gk in
                       zip(p, torch.autograd.grad(loss, list(p.values())))}
    out["gcn_marglik"] = _marglik(m, params, idx, yt, n)
    # SparseGAT over both halo schedules, real edges at weight 0 included
    for name, seed, every, schedule in (("gat", 8, None, "auto"),
                                        ("gat_zero_a2a", 11, 7, "alltoall"),
                                        ("gat_zero_ring", 11, 7, "ring")):
        ei_g, w = gat_graph(seed, p=0.25 if every else 0.2,
                            zero_every=every)
        gg = sparse_from_edge_index(ei_g, 32, weights=w, normalize=None,
                                    add_self_loops=False, dtype=f64,
                                    device=dev)
        hgg = HaloAggGraph(mesh, gg, schedule=schedule, device=dev)
        Xg = features(seed + 50, 32, 8)
        mg = SparseGAT(8, 8, 3, 2, hgg.put(torch.as_tensor(Xg)), hgg,
                       dropout_p=0.0, device=dev, dtype=f64)
        pg = params_from_numpy(ctx["inputs"][name], device=dev)
        out[f"{name}_forward"] = _np(mg.apply(pg, torch.arange(32)))
        if name == "gat":
            # a one-part graph axis: the edge softmax over the whole graph
            h1 = HaloAggGraph(ctx["mesh_one"], gg, device=dev)
            m1 = SparseGAT(8, 8, 3, 2, h1.put(torch.as_tensor(Xg)), h1,
                           dropout_p=0.0, device=dev, dtype=f64)
            out["gat_one_part_forward"] = _np(m1.apply(pg, torch.arange(32)))
            yg = torch.as_tensor(np.random.default_rng(9).integers(0, 3, 32))
            pp = {k: v.clone().requires_grad_(True) for k, v in pg.items()}
            loss = torch.nn.functional.cross_entropy(
                mg.apply(pp, torch.arange(32)), yg)
            out["gat_grad"] = {k: _np(gk) for k, gk in zip(
                pp, torch.autograd.grad(loss, list(pp.values())))}
            out["gat_marglik"] = _marglik(mg, pg, torch.arange(32), yg, 32)
    return out


def _placed(params, mesh):
    """``params`` with ``adj`` as the rank's row block."""
    from laplace_gnn_torch.parallel import graph_sharding
    return {k: graph_sharding(mesh).put(v) if k == "adj" else v
            for k, v in params.items()}


def check_row_sharded_gat(ctx):
    import torch
    from laplace_gnn_torch.models import GAT
    from laplace_gnn_torch.parallel import (graph_sharding,
                                            make_row_sharded_gat_attention)
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    mesh, dev, f64 = ctx["mesh"], "cpu", torch.float64
    X, adj, y = dense_gat_data()
    n = X.shape[0]
    params = _placed(params_from_numpy(ctx["inputs"]["dense_gat"],
                                       device=dev), mesh)
    out = {}
    for flash in (False, True):
        impl = make_row_sharded_gat_attention(mesh, row_block=8,
                                              use_flash=flash, device=dev)
        m = GAT(8, 8, 4, 2, X, adj, heads=2, concat=True, dropout_p=0.0,
                attention_impl=impl, device=dev,
                dtype=f64).placed(graph_sharding(mesh))
        key = "flash" if flash else "plain"
        out[f"{key}_forward"] = _np(m.apply(params, torch.arange(n)))
        out[f"{key}_marglik"] = _marglik(m, params, torch.arange(n),
                                         torch.as_tensor(y), n,
                                         names=list(params), mesh=mesh,
                                         column_chunk=2)
        out[f"{key}_twin_is_plain"] = (
            m.jvp_safe().convs[0].attention_impl.use_flash is False)
        out[f"{key}_shapes"] = {"adj": tuple(params["adj"].shape),
                                "block_out": tuple(m.apply(params).shape)}
    return out


def check_attstegcn(ctx):
    import torch
    from laplace_gnn_torch.models import AttSTEGCN
    from laplace_gnn_torch.parallel import graph_sharding
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    dev, f64 = "cpu", torch.float64
    X, adj, y = att_data()
    n = X.shape[0]
    m = AttSTEGCN(8, 8, 4, 2, X, adj, dropout_p=0.0, device=dev, dtype=f64)
    params = _placed(params_from_numpy(ctx["inputs"]["att"], device=dev),
                     ctx["mesh"])
    m.adj_constraint = graph_sharding(ctx["mesh"])
    return {"marglik": _marglik(m, params, torch.arange(n),
                                torch.as_tensor(y), n,
                                names=["adj_W.weight"])}


def check_ste_hyperstep(ctx):
    """The composed STE-GCN Kron hyperstep on row blocks: its -log
    marglik, this rank's block of d/d adj, and the largest tensor its
    autograd graph keeps (the unsharded hyperstep's beside it)."""
    import torch
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.parallel import graph_sharding
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn
    mesh, dev, f64 = ctx["mesh"], "cpu", torch.float64
    X, adj, y = ste_data()
    n = X.shape[0]
    m = STEGCN(16, 8, 3, 2, X, adj, dropout_p=0.0, device=dev, dtype=f64)
    whole = params_from_numpy(ctx["inputs"]["ste"], device=dev)
    out = {}
    for name, model, params in (
            ("sharded", m.placed(graph_sharding(mesh)),
             _placed(whole, mesh)),
            ("unsharded", m, whole)):
        fn = make_neg_marglik_fn(model, "classification", "kron", "all",
                                 N=n)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        val = fn(p, torch.arange(n), torch.as_tensor(y))
        saved = max_saved_numel(val)
        (g,) = torch.autograd.grad(val, [p["adj"]])
        out[name] = {"neg_marglik": float(val.detach()), "adj_grad": _np(g),
                     "max_saved": saved, "adj_shape": tuple(p["adj"].shape)}
    # symmetric (the block's rows of A^T by one all-to-all) with the STE
    # gradient mask of train_masked_update (its row block)
    ms = STEGCN(16, 8, 3, 2, X, adj, dropout_p=0.0, symmetric=True,
                train_masked_update=True, train_nodes=np.arange(STE_MASKED),
                device=dev, dtype=f64).placed(graph_sharding(mesh))
    fn = make_neg_marglik_fn(ms, "classification", "kron", "all", N=n)
    p = {k: v.clone().requires_grad_(True) for k, v in _placed(
        params_from_numpy(ctx["inputs"]["ste_sym"], device=dev),
        mesh).items()}
    val = fn(p, torch.arange(n), torch.as_tensor(y))
    (g,) = torch.autograd.grad(val, [p["adj"]])
    out["symmetric_masked"] = {"neg_marglik": float(val.detach()),
                               "adj_grad": _np(g)}
    return out


def check_train_step(ctx):
    import torch
    from laplace_gnn_torch.curvature.losses import cross_entropy_sum
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.parallel import make_sharded_train_step
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    dev, f64 = "cpu", torch.float64
    X, adj, y = step_data()
    n = X.shape[0]
    yt, idx = torch.as_tensor(y), torch.arange(n)
    out = {}
    for fused in (False, True):
        m = STEGCN(16, 8, 3, 2, X, adj, dropout_p=0.0, fused=fused,
                   device=dev, dtype=f64)
        step, shard = make_sharded_train_step(
            m, ctx["mesh"], lambda f, t: cross_entropy_sum(f, t) / n,
            lr=STEP_LR, device=dev)
        params, shardings = shard(params_from_numpy(ctx["inputs"]["step"],
                                                    device=dev))
        adj_shape = tuple(params["adj"].shape)
        losses = []
        for _ in range(STEP_N):
            params, loss = step(params, idx, yt)
            losses.append(float(loss))
        out[f"fused={fused}"] = (losses, {
            k: (_whole(v, ctx["mesh"]) if k == "adj" and not fused
                else _np(v)) for k, v in params.items()})
        out[f"specs fused={fused}"] = {k: s.spec
                                       for k, s in shardings.items()}
        out[f"adj_shape fused={fused}"] = adj_shape
    return out


CHECKS = {"aggregates": check_aggregates, "sparse_models": check_sparse_models,
          "row_sharded_gat": check_row_sharded_gat,
          "attstegcn": check_attstegcn, "train_step": check_train_step,
          "ste_hyperstep": check_ste_hyperstep}


def main(rank: int, world: int, init: str, out_dir: str) -> None:
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist
    from laplace_gnn_torch.parallel import distributed, make_mesh
    distributed.initialize(init, world, rank, device="cpu")
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    ctx = {"inputs": inputs, "mesh": make_mesh(world, device="cpu"),
           "mesh_one": make_mesh(world, model_parallel=world, device="cpu")}
    results, seconds = {}, {}
    for name, check in CHECKS.items():
        t0 = time.perf_counter()
        results[name] = check(ctx)
        seconds[name] = time.perf_counter() - t0
    results["seconds"] = seconds
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
