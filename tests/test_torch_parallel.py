"""The port's partition plans, mesh rules and scaling model
(laplace_gnn_torch/parallel/{partition,sharded,mesh,scaling}.py) against
the JAX package, with no process group.

Every host plan is numpy in both packages and must give exactly JAX's
arrays on the same graph; the scaling model agrees at 1e-12 when the
bandwidths are passed; ``shard_gnn_params`` puts each leaf on the axis
JAX's ``spec_for`` does; ``make_mesh`` raises where JAX's does. The cases
of the non-slow tests of tests/test_parallel.py whose subject is a plan, a
mesh or the scaling model are repeated on the port."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu.graph import container as JC
from laplace_gnn_tpu.parallel import mesh as JMESH
from laplace_gnn_tpu.parallel import partition as JP
from laplace_gnn_tpu.parallel import scaling as JSC
from laplace_gnn_tpu.parallel import sharded as JS
from laplace_gnn_torch.graph import container as TC
from laplace_gnn_torch.parallel import mesh as TMESH
from laplace_gnn_torch.parallel import partition as TP
from laplace_gnn_torch.parallel import scaling as TSC
from laplace_gnn_torch.parallel import sharded as TS

import torch_sharded_worker as W


def _graphs(name):
    """(2, E) edges, node count, weights, normalization of a test graph."""
    if name == "random":
        ei, _ = W.agg_graph(1)
        return ei, W.N_AGG, None, "sym"
    if name == "banded":
        return W.banded(), 128, None, None
    if name == "shuffled":                  # the banded graph relabelled
        order = np.random.default_rng(2).permutation(128)
        return TP.apply_node_order(W.banded(), order)[0], 128, None, None
    if name == "skewed":
        return W.skewed(n=96), 96, None, None
    ei, w = W.gat_graph(11, p=0.25, zero_every=7)
    return ei, 32, w, None


def _pair(name):
    """The same graph in both packages (float64 weights)."""
    ei, n, w, norm = _graphs(name)
    loops = norm is not None
    jg = JC.sparse_from_edge_index(ei, n, weights=w, normalize=norm,
                                   add_self_loops=loops)
    tg = TC.sparse_from_edge_index(ei, n, weights=w, normalize=norm,
                                   add_self_loops=loops, dtype=torch.float64,
                                   device="cpu")
    return jg, tg


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


GRAPHS = ["random", "banded", "shuffled", "skewed", "gat_zero_weights"]


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_host_plans_equal_jax(name, n_parts):
    jg, tg = _pair(name)
    for a, b, what in zip(JS.partition_sparse_graph(jg, n_parts),
                          TS.partition_sparse_graph(tg, n_parts),
                          ("src", "dst", "w", "block")):
        _same(a, b, f"partition_sparse_graph {what}")
    _same(JS.halo_widths(jg, n_parts), TS.halo_widths(tg, n_parts),
          "halo_widths")
    jp, tp = JS.build_halo_exchange(jg, n_parts), \
        TS.build_halo_exchange(tg, n_parts)
    assert jp.keys() == tp.keys()
    for k in jp:
        _same(jp[k], tp[k], f"build_halo_exchange {k}")
    jr, tr = JS.build_ring_halo_exchange(jg, n_parts), \
        TS.build_ring_halo_exchange(tg, n_parts)
    assert jr.keys() == tr.keys()
    assert jr["H_s"] == tr["H_s"] and jr["block"] == tr["block"]
    assert len(jr["send_idx"]) == len(tr["send_idx"]) == n_parts - 1
    for s, (a, b) in enumerate(zip(jr["send_idx"], tr["send_idx"])):
        _same(a, b, f"ring send_idx shift {s + 1}")
    for k in jr.keys() - {"H_s", "block", "send_idx"}:
        _same(jr[k], tr[k], f"build_ring_halo_exchange {k}")
    # the fixed paddings that stack plans of edge subsets
    _same(JS.build_halo_exchange(jg, n_parts, H_min=9, EL_min=300,
                                 ER_min=200)["src_r"],
          TS.build_halo_exchange(tg, n_parts, H_min=9, EL_min=300,
                                 ER_min=200)["src_r"], "padded src_r")


@pytest.mark.parametrize("n_parts", [5, 7, 9])
@pytest.mark.parametrize("name", ["random", "skewed"])
def test_halo_widths_padded_and_indivisible(name, n_parts):
    jg, tg = _pair(name)
    _same(JS.halo_widths(jg, n_parts, allow_pad=True),
          TS.halo_widths(tg, n_parts, allow_pad=True), "allow_pad")
    for fn in (TS.halo_widths, TS.partition_sparse_graph,
               TS.build_halo_exchange, TS.build_ring_halo_exchange):
        with pytest.raises(ValueError, match="divide"):
            fn(tg, n_parts)


def _adj(n, p, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < p).astype(np.float32)
    return np.minimum(adj + adj.T, 1.0)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("n_parts", [3, 4])
def test_partition_functions_equal_jax(n_parts, reorder):
    adj = _adj(64, 0.2, 3)
    jpart = JP.degree_balanced_partition(adj, n_parts, reorder=reorder)
    tpart = TP.degree_balanced_partition(adj, n_parts, reorder=reorder)
    _same(jpart.offsets, tpart.offsets, "offsets")
    _same(jpart.perm, tpart.perm, "perm")
    nodes = np.arange(64)
    _same(jpart.owner(nodes), tpart.owner(nodes), "owner")
    jplan = JP.build_halo_plan(adj, jpart)
    tplan = TP.build_halo_plan(adj, tpart)
    for a, b in zip(jplan.halo_indices, tplan.halo_indices):
        _same(a, b, "halo_indices")
    _same(jplan.n_owned, tplan.n_owned, "n_owned")
    _same(jplan.halo_sizes(), tplan.halo_sizes(), "halo_sizes")
    js, ts = JP.partition_efficiency(adj, jpart), \
        TP.partition_efficiency(adj, tpart)
    assert js.keys() == ts.keys()
    for k in js:
        _same(js[k], ts[k], k)


@pytest.mark.parametrize("name", ["banded", "shuffled", "skewed"])
def test_orders_blocks_and_padding_equal_jax(name):
    ei, n, _, _ = _graphs(name)
    order = TP.rcm_order(ei, n)
    _same(JP.rcm_order(ei, n), order, "rcm_order")
    X = np.random.default_rng(0).standard_normal((n, 3))
    for a, b in zip(JP.apply_node_order(ei, order, X),
                    TP.apply_node_order(ei, order, X)):
        _same(a, b, "apply_node_order")
    assert JP.bandwidth(ei) == TP.bandwidth(ei)
    assert TP.bandwidth(np.zeros((2, 0), int)) == 0
    for n_parts in (2, 4, 5):
        offsets = TP.edge_balanced_blocks(ei, n, n_parts)
        _same(JP.edge_balanced_blocks(ei, n, n_parts), offsets, "offsets")
        for a, b in zip(JP.pad_to_blocks(ei, offsets, X),
                        TP.pad_to_blocks(ei, offsets, X)):
            _same(a, b, "pad_to_blocks")


def test_degree_balanced_partition():
    adj = _adj(64, 0.2, 3)
    part = TP.degree_balanced_partition(adj, 4)
    assert part.offsets[0] == 0 and part.offsets[-1] == 64
    stats = TP.partition_efficiency(adj, part)
    assert stats["edge_imbalance"] < 1.6
    assert stats["edges_per_part"].sum() == adj.sum()
    assert part.owner(np.array([0])) == 0
    assert part.owner(np.array([63]))[0] == 3
    part_r = TP.degree_balanced_partition(adj, 4, reorder=True)
    assert sorted(part_r.perm.tolist()) == list(range(64))


def test_halo_plan():
    adj = _adj(24, 0.15, 5)
    part = TP.degree_balanced_partition(adj, 3)
    plan = TP.build_halo_plan(adj, part)
    assert len(plan.halo_indices) == 3
    for i, halo in enumerate(plan.halo_indices):
        lo, hi = part.offsets[i], part.offsets[i + 1]
        assert not np.any((halo >= lo) & (halo < hi))
        assert set(halo.tolist()) <= set(np.nonzero(adj[lo:hi])[1].tolist())


def test_rcm_order_reduces_bandwidth_and_preserves_spmm():
    rng = np.random.default_rng(0)
    n = 200
    src = np.tile(np.arange(n - 3), 3)
    dst = np.concatenate([np.arange(n - 3) + k for k in (1, 2, 3)])
    shuffle = rng.permutation(n)
    ei_shuf, = TP.apply_node_order(np.stack([src, dst]), np.argsort(shuffle))
    order = TP.rcm_order(ei_shuf, n)
    ei_rcm, = TP.apply_node_order(ei_shuf, order)
    assert TP.bandwidth(ei_rcm) <= 6 < TP.bandwidth(ei_shuf)
    X = torch.as_tensor(rng.standard_normal((n, 4)))
    g = TC.sparse_from_edge_index(ei_shuf, n, normalize="sym",
                                  dtype=torch.float64, device="cpu")
    g2 = TC.sparse_from_edge_index(ei_rcm, n, normalize="sym",
                                   dtype=torch.float64, device="cpu")
    order_t = torch.as_tensor(order.copy())
    np.testing.assert_allclose(g2.spmm(X[order_t]).numpy(),
                               g.spmm(X).numpy()[order], atol=1e-12)
    part = TP.Partition(offsets=np.array([0, 50, 100, 150, n]),
                        perm=np.arange(n))

    def halo(ei):
        adj = np.zeros((n, n))
        adj[ei[1], ei[0]] = 1
        return TP.build_halo_plan(adj, part).halo_sizes().sum()

    assert halo(ei_rcm) <= 20 < halo(ei_shuf)


def test_halo_volume_shrinks_with_order_and_ring_concentrates():
    _, g_band = _pair("banded")
    _, g_shuf = _pair("shuffled")
    assert TS.build_halo_exchange(g_band, 4)["H"] * 3 \
        < TS.build_halo_exchange(g_shuf, 4)["H"]
    H_s = TS.build_ring_halo_exchange(g_band, 4)["H_s"]
    assert H_s[0] > 1 and H_s[-1] > 1          # hops +-1
    assert all(h == 1 for h in H_s[1:-1])      # interior: padding only
    W_ = TS.halo_widths(g_shuf, 4)
    assert TS.build_halo_exchange(g_shuf, 4)["H"] == int(W_.max())
    H_s = TS.build_ring_halo_exchange(g_shuf, 4)["H_s"]
    for s in range(1, 4):
        assert H_s[s - 1] == max(1, max(int(W_[p][(p - s) % 4])
                                        for p in range(4)))


def test_edge_balanced_blocks_reduce_imbalance():
    rng = np.random.default_rng(9)
    n = 400
    w = 1.0 / (np.arange(n) + 1)
    dst = rng.choice(n, 8000, p=w / w.sum())
    ei = np.stack([rng.integers(0, n, 8000), dst])

    def imbalance(owner):
        counts = np.bincount(owner, minlength=4)
        return counts.max() / counts.mean()

    offsets = TP.edge_balanced_blocks(ei, n, 4)
    owner = np.repeat(np.arange(4), np.diff(offsets))[dst]
    assert imbalance(owner) < 0.5 * imbalance(dst // (n // 4))
    assert offsets[0] == 0 and offsets[-1] == n
    assert (np.diff(offsets) > 0).all()


# the bandwidths both packages are given (bytes/s)
BW = {"ici_bw": 4.5e11}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("n_chips", [(2, 4, 8), (3,), (2, 5, 16)])
def test_projected_scaling_equals_jax(n_chips, overlap):
    rng = np.random.default_rng(0)
    n = 64
    ei = np.stack([rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)])
    jg = JC.sparse_from_edge_index(ei, n, normalize="sym")
    tg = TC.sparse_from_edge_index(ei, n, normalize="sym",
                                   dtype=torch.float64, device="cpu")
    kw = dict(d_features=32, t_compute_1chip=1e-4, n_chips=n_chips,
              overlap=overlap, t_fixed=1e-6, **BW)
    jrows, trows = JSC.projected_scaling(jg, **kw), \
        TSC.projected_scaling(tg, **kw)
    for a, b in zip(jrows, trows):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0)
    assert JSC.format_table(jrows) == TSC.format_table(trows)
    for r in trows:
        assert 0 < r["efficiency"] <= 1.0 + 1e-9
        assert r["t_step_us"] >= max(r["t_comp_us"], r["t_comm_us"]) - 1e-9


@pytest.mark.parametrize("n_dcn,n_graph", [(2, 4), (4, 1), (8, 2)])
def test_dcn_and_ring_projections_equal_jax(n_dcn, n_graph):
    kw = dict(n_nodes=4096, d_features=64, n_dcn=n_dcn,
              t_step_1slice=1e-3, n_graph=n_graph, dcn_bw=5e10)
    a, b = JSC.dcn_projection(**kw), TSC.dcn_projection(**kw)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0)
    assert b["t_step_us"] >= b["t_psum_us"] + (1e-3 / n_dcn) * 1e6 - 1e-9
    kw = dict(t_matmul_1chip=1e-3, n_chips=(2, n_dcn), **BW)
    for a, b in zip(JSC.ring_dense_projection(4096, 64, **kw),
                    TSC.ring_dense_projection(4096, 64, **kw)):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0)
        assert b["ring_speedup"] >= 1.0 - 1e-9
        assert 0 < b["ring_efficiency"] <= 1.0 + 1e-9


def test_projected_scaling_model_and_defaults():
    rng = np.random.default_rng(0)
    n = 64
    ei = np.stack([rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)])
    g = TC.sparse_from_edge_index(ei, n, normalize="sym", device="cpu")
    slow = TSC.projected_scaling(g, 32, 1.0, n_chips=(2,))[0]
    assert slow["efficiency"] > 0.99
    fast = TSC.projected_scaling(g, 32, 1e-4, n_chips=(2,))[0]
    no = TSC.projected_scaling(g, 32, 1e-4, n_chips=(2,), overlap=False)[0]
    assert no["efficiency"] <= fast["efficiency"] + 1e-12
    rows = TSC.projected_scaling(g, 32, 1e-4, n_chips=(3,))
    assert rows[0]["halo_rows"] == 2 * max(1, int(
        TS.halo_widths(g, 3, allow_pad=True).max()))
    # the defaults are the H100 SXM's published figures, not a TPU's
    assert (TSC.H100_NVLINK_BW, TSC.H100_NIC_BW, TSC.H100_HBM_BW) == (
        4.5e11, 5e10, 3.35e12)
    assert TSC.projected_scaling.__defaults__[2] == TSC.H100_NVLINK_BW
    assert TSC.dcn_projection.__defaults__[1] == TSC.H100_NIC_BW


@pytest.mark.parametrize("schedule", ["alltoall", "ring"])
@pytest.mark.parametrize("name,n_parts", [("random", 2), ("banded", 4),
                                          ("skewed", 4)])
def test_halo_stats_equal_jax(name, n_parts, schedule):
    """The bodies return row blocks, as JAX's do: the port's stats of a
    halo aggregate (halo_stats of its plan's crossing rows) are JAX's
    stats dict, exactly."""
    jg, tg = _pair(name)
    jmake = {"alltoall": JS.make_halo_sparse_aggregate,
             "ring": JS.make_ring_halo_sparse_aggregate}[schedule]
    want = jmake(JMESH.make_mesh(n_parts), jg)[2]
    if schedule == "ring":
        plan = TS.build_ring_halo_exchange(tg, n_parts)
        got = TS.halo_stats(tg.n_nodes, n_parts, int(sum(plan["H_s"])))
        got["H_s"] = plan["H_s"]
    else:
        plan = TS.build_halo_exchange(tg, n_parts)
        got = TS.halo_stats(tg.n_nodes, n_parts, (n_parts - 1) * plan["H"])
    assert got == want


def test_one_part_halo_stats_equal_jax():
    jg, tg = _pair("random")
    want = JS.make_halo_sparse_aggregate(JMESH.make_mesh(1), jg)[2]
    assert TS.halo_stats(tg.n_nodes, 1, 0) == want


def _stand_in_mesh(graph, model):
    """The two attributes shard_gnn_params reads of a DeviceMesh."""
    return types.SimpleNamespace(mesh_dim_names=("graph", "model"),
                                 size=lambda dim: (graph, model)[dim])


def _jax_models(n=16, d=8):
    from laplace_gnn_tpu import models as JM
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((n, d)))
    adj = jnp.asarray(_adj(n, 0.3, 1))
    return {"STEGCN": JM.STEGCN(d, 4, 2, 2, X, adj * 0),
            "LoRASTEGCN": JM.LoRASTEGCN(d, 4, 2, 2, X, adj, r=2,
                                        lora_alpha=1.0),
            "AttSTEGCN": JM.AttSTEGCN(d, 4, 2, 2, X, adj)}


@pytest.mark.parametrize("model_axis", [True, False])
@pytest.mark.parametrize("kind", ["STEGCN", "LoRASTEGCN", "AttSTEGCN"])
def test_shard_gnn_params_specs_equal_jax(kind, model_axis):
    from laplace_gnn_torch.utils.pytree import params_from_numpy
    jm = _jax_models()[kind]
    params = jm.init(jax.random.PRNGKey(0))
    jmesh = JMESH.make_mesh(8, model_parallel=2)
    jspec = JMESH.shard_gnn_params(jmesh, params, model_axis=model_axis)
    flat = {}

    def visit(path, sh):
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        flat[name] = tuple(sh.spec)
    jax.tree_util.tree_map_with_path(visit, jspec)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    tspec = TMESH.shard_gnn_params(_stand_in_mesh(4, 2), tparams,
                                   model_axis=model_axis)
    assert {k: s.spec for k, s in tspec.items()} == flat
    if model_axis:
        assert flat["convs.0.lin.weight"] == ("model", None)
    if kind != "LoRASTEGCN":
        assert flat["adj"] == ("graph", None)


def test_placements_and_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _stand_in_mesh(4, 2)
    assert TMESH.graph_sharding(mesh).placements == (Shard(0), Replicate())
    assert TMESH.graph_sharding(mesh).spec == ("graph", None)
    assert TMESH.graph_sharding(mesh).rows_on == "graph"
    assert TMESH.replicated(mesh).placements == (Replicate(), Replicate())
    assert TMESH.replicated(mesh).spec == ()
    assert TMESH.replicated(mesh).rows_on is None
    hybrid = types.SimpleNamespace(mesh_dim_names=("dcn", "graph", "model"))
    assert TMESH.graph_sharding(hybrid).placements == (
        Replicate(), Shard(0), Replicate())
    assert TMESH.graph_sharding(hybrid).spec == ("graph", None)


@pytest.mark.parametrize("index", [0, 3])
def test_rank_rows_are_the_plans_block(index):
    """A placed value is the rank's contiguous block, plan["block"] rows;
    rows that do not divide raise."""
    jg, tg = _pair("skewed")
    plan = TS.build_halo_exchange(tg, 4)
    ax = types.SimpleNamespace(size=4, index=index, name="graph")
    x = torch.arange(96.0)[:, None].expand(96, 3)
    b = int(plan["block"])
    np.testing.assert_array_equal(TMESH.rank_rows(x, ax).numpy(),
                                  x[index * b:(index + 1) * b].numpy())
    with pytest.raises(ValueError, match="divide"):
        TMESH.rank_rows(torch.zeros(10, 2), ax)


@pytest.mark.parametrize("n,mp", [(8, 3), (6, 4), (3, 2)])
def test_make_mesh_raises_as_jax(n, mp):
    with pytest.raises(ValueError):
        JMESH.make_mesh(n, model_parallel=mp)
    with pytest.raises(ValueError, match="divisible"):
        TMESH.make_mesh(n, model_parallel=mp, device="cpu")


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        TMESH.make_mesh(device="cpu")
