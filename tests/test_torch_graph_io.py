"""Port parity for the dataset layer and the graph helpers: the Planetoid
and geom-gcn parsers on raw files written here, ``load_data``'s dispatch,
the homophily and interaction metrics, the adjacency helpers (value and
gradient) and the learned-graph plots, torch and numpy against JAX in
float64 on the CPU."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import ops as JO
from laplace_gnn_tpu.graph import datasets as JDS
from laplace_gnn_tpu.graph import homophily as JH
from laplace_gnn_tpu.graph import plots as JP
from laplace_gnn_torch import ops as TO
from laplace_gnn_torch.graph import datasets as TDS
from laplace_gnn_torch.graph import homophily as TH
from laplace_gnn_torch.graph import plots as TP


# ---------------------------------------------------------------------------
# Raw files in the upstream formats
# ---------------------------------------------------------------------------

def _write_planetoid(root, name, n_labeled=4, n_unlabeled=2, n_test=4, d=5,
                     c=3, seed=0, gap=False):
    """A tiny dataset in Yang et al.'s raw Planetoid format under
    ``<root>/<Name>/raw``: allx stacks the labeled and unlabeled rows, the
    test nodes come last and are listed, shuffled, in test.index. With
    ``gap`` one id inside the test range is left out of test.index and of
    tx / ty (citeseer's isolated test nodes)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n_all = n_labeled + n_unlabeled
    test_ids = np.arange(n_all, n_all + n_test + int(gap))
    if gap:
        test_ids = np.delete(test_ids, 1)

    def feat(n):
        return sp.csr_matrix((rng.random((n, d)) < 0.4).astype(np.float32))

    def labels(n):
        onehot = np.zeros((n, c), np.int64)
        onehot[np.arange(n), rng.integers(0, c, n)] = 1
        return onehot

    allx, tx = feat(n_all), feat(len(test_ids))
    ally, ty = labels(n_all), labels(len(test_ids))
    n_nodes = n_all + n_test + int(gap)
    graph = {i: [int(j) for j in rng.choice(n_nodes + 1, 3, replace=False)
                 if j != i] for i in range(n_nodes)}
    raw = os.path.join(root, name.capitalize(), "raw")
    os.makedirs(raw, exist_ok=True)
    for ext, obj in (("x", allx[:n_labeled]), ("tx", tx), ("allx", allx),
                     ("y", ally[:n_labeled]), ("ty", ty), ("ally", ally),
                     ("graph", graph)):
        with open(os.path.join(raw, f"ind.{name}.{ext}"), "wb") as f:
            pickle.dump(obj, f, protocol=2)
    with open(os.path.join(raw, f"ind.{name}.test.index"), "w") as f:
        f.write("\n".join(str(int(i)) for i in rng.permutation(test_ids))
                + "\n")


def _write_geom_gcn(d, dense=True):
    """A tiny graph in the geom-gcn raw format (a header, then
    tab-separated rows; dense comma-separated features, or one-hot indices
    as Actor stores them), with one duplicate edge."""
    os.makedirs(d, exist_ok=True)
    if dense:
        rows = ["node_id\tfeature\tlabel", "0\t1,0,1\t0", "1\t0,1,0\t1",
                "2\t1,1,0\t0", "3\t0,0,1\t2", "4\t1,0,0\t1"]
    else:
        rows = ["node_id\tfeature\tlabel", "0\t0,2\t0", "1\t1\t1",
                "2\t0,1\t0", "3\t2\t2", "4\t0\t1"]
    with open(os.path.join(d, "out1_node_feature_label.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    edges = ["id1\tid2", "0\t1", "1\t2", "2\t0", "3\t4", "0\t1"]
    with open(os.path.join(d, "out1_graph_edges.txt"), "w") as f:
        f.write("\n".join(edges) + "\n")


def _assert_same_data(t, j):
    for field in ("x", "y", "edge_index", "train_indices", "val_indices",
                  "test_indices"):
        a, b = getattr(t, field), getattr(j, field)
        if a is None or b is None:
            assert a is None and b is None, field
            continue
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert t.name == j.name


@pytest.mark.parametrize("name", ["cora", "pubmed", "citeseer"])
def test_load_planetoid_matches_jax(tmp_path, name):
    _write_planetoid(str(tmp_path), name)
    t = TDS.load_planetoid(name, str(tmp_path))
    j = JDS.load_planetoid(name, str(tmp_path))
    _assert_same_data(t, j)
    assert t.x.shape == (10, 5) and t.y.shape == (10,)
    assert t.edge_index.max() < 10         # the out-of-range edge is gone
    # through load_data, splits attached
    _assert_same_data(TDS.load_data(name, root=str(tmp_path)),
                      JDS.load_data(name, root=str(tmp_path)))
    path = os.path.join(tmp_path, name.capitalize(), "raw",
                        f"ind.{name}.test.index")
    np.testing.assert_array_equal(TDS._parse_index_file(path),
                                  JDS._parse_index_file(path))


def test_load_planetoid_citeseer_isolated_test_nodes(tmp_path):
    """A test id missing from test.index (citeseer's isolated nodes): the
    port keeps a zero row for it and puts every listed test node's row of
    tx / ty at its id, as the Planetoid code does; the JAX parser widens
    its reorder to the whole id range and fails on these files."""
    import scipy.sparse as sp
    _write_planetoid(str(tmp_path), "citeseer", gap=True)
    with pytest.raises(ValueError):
        JDS.load_planetoid("citeseer", str(tmp_path))
    t = TDS.load_planetoid("citeseer", str(tmp_path))
    raw = os.path.join(tmp_path, "Citeseer", "raw")

    def obj(ext):
        with open(os.path.join(raw, f"ind.citeseer.{ext}"), "rb") as f:
            return pickle.load(f, encoding="latin1")
    test_idx = TDS._parse_index_file(os.path.join(raw,
                                                  "ind.citeseer.test.index"))
    allx, tx = obj("allx").toarray(), obj("tx").toarray()
    ally, ty = obj("ally"), obj("ty")
    assert t.x.shape == (11, 5)
    np.testing.assert_array_equal(t.x[:6], allx)
    np.testing.assert_array_equal(t.y[:6], ally.argmax(1))
    np.testing.assert_array_equal(t.x[test_idx], tx)
    np.testing.assert_array_equal(t.y[test_idx], ty.argmax(1))
    isolated = sorted(set(range(6, 11)) - set(test_idx.tolist()))
    assert isolated == [7] and not t.x[7].any() and t.y[7] == 0
    assert sp.issparse(obj("tx"))


def test_load_planetoid_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="Planetoid raw files"):
        TDS.load_data("cora", root=str(tmp_path))


@pytest.mark.parametrize("name,subdir,dense,n_edges", [
    ("texas", ("texas", "raw"), True, 8),            # WebKB: undirected
    ("cornell", ("Cornell", "raw"), True, 8),
    ("wisconsin", ("wisconsin", "geom_gcn", "raw"), True, 8),
    ("chameleon", ("chameleon", "raw"), True, 4),    # Wikipedia: directed
    ("squirrel", ("squirrel",), True, 4),
    ("actor", ("actor", "raw"), False, 4),           # sparse features
])
def test_load_geom_gcn_matches_jax(tmp_path, name, subdir, dense, n_edges):
    _write_geom_gcn(os.path.join(tmp_path, *subdir), dense=dense)
    t = TDS.load_data(name, root=str(tmp_path))
    j = JDS.load_data(name, root=str(tmp_path))
    _assert_same_data(t, j)
    assert t.edge_index.shape == (2, n_edges)
    edges = set(map(tuple, t.edge_index.T.tolist()))
    assert ((4, 3) in edges) == (n_edges == 8)
    if name == "actor":
        assert t.x.shape == (5, 932) and t.x.sum() == 7
        np.testing.assert_array_equal(np.nonzero(t.x[0])[0], [0, 2])
    else:
        np.testing.assert_array_equal(t.x[0], [1, 0, 1])
    kw = dict(sparse_features=not dense, undirected=False)
    _assert_same_data(TDS.load_geom_gcn(name, str(tmp_path), **kw),
                      JDS.load_geom_gcn(name, str(tmp_path), **kw))


def test_load_geom_gcn_npz_fallback_and_missing(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "texas.npz",
             x=rng.standard_normal((6, 4)).astype(np.float32),
             y=rng.integers(0, 3, 6), edge_index=np.array([[0, 1], [1, 2]]))
    _assert_same_data(TDS.load_data("texas", root=str(tmp_path)),
                      JDS.load_data("texas", root=str(tmp_path)))
    with pytest.raises(FileNotFoundError, match="geom-gcn raw files"):
        TDS.load_data("squirrel", root=str(tmp_path))


@pytest.mark.parametrize("name,kw", [
    ("karate", {}), ("sbm", dict(n_nodes=60, n_classes=3, d_features=4)),
    ("banana", dict(n_samples=40)), ("mini", {})])
def test_load_data_dispatch_matches_jax(tmp_path, name, kw):
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "mini.npz",
             x=rng.standard_normal((12, 3)).astype(np.float32),
             y=np.arange(12) % 3, edge_index=np.array([[0, 1], [1, 2]]))
    t = TDS.load_data(name, n_rand_splits=2, root=str(tmp_path), **kw)
    j = JDS.load_data(name, n_rand_splits=2, root=str(tmp_path), **kw)
    _assert_same_data(t, j)
    assert t.train_indices.shape[1] == 2
    with pytest.raises(ValueError, match="Unknown dataset"):
        TDS.load_data("nonexistent", root=str(tmp_path))


# ---------------------------------------------------------------------------
# Homophily and interaction metrics
# ---------------------------------------------------------------------------

def _graph(seed=0, n=30, c=3):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.12).astype(float)   # directed
    y = rng.integers(0, c, n)
    return adj, y, rng


def test_homophily_metrics_match_jax():
    adj, y, rng = _graph()
    perm = rng.permutation(len(y))
    tr, te = perm[:10], perm[10:20]
    edge_index = np.stack(np.nonzero(adj))
    for n_layers in (1, 2, 3):
        assert TH.avg_receptive_field_degree(adj, tr, n_layers) == \
            JH.avg_receptive_field_degree(adj, tr, n_layers)
        np.testing.assert_array_equal(
            TH.test_receptive_field(adj, tr, te, n_layers),
            JH.test_receptive_field(adj, tr, te, n_layers))
        for kw in (dict(adj=adj), dict(edge_index=edge_index),
                   dict(adj=adj, test_nodes=te)):
            np.testing.assert_allclose(
                TH.interaction_bound(y, n_layers=n_layers, **kw),
                JH.interaction_bound(y, n_layers=n_layers, **kw),
                rtol=1e-12)
    for kw in (dict(adj=adj), dict(edge_index=edge_index)):
        np.testing.assert_allclose(TH.label_informativeness(y, **kw),
                                   JH.label_informativeness(y, **kw),
                                   rtol=1e-12)
    new = adj.copy()
    new[rng.random(adj.shape) < 0.05] = 1.0
    new[rng.random(adj.shape) < 0.05] = 0.0
    assert TH.edge_diff(adj, new, y) == JH.edge_diff(adj, new, y)
    assert TH.edge_diff(adj, new, y)["n_add"] > 0
    with pytest.raises(ValueError):
        TH.interaction_bound(y)


# ---------------------------------------------------------------------------
# Adjacency helpers
# ---------------------------------------------------------------------------

def test_adjacency_helpers_match_jax():
    adj, _, rng = _graph(1, n=12)
    w = rng.standard_normal(adj.shape)
    soft = np.where(rng.random(adj.shape) < 0.3, 0.5, adj)   # ties at 1
    for name, fn_t, fn_j in (
            ("symmetrize", TO.symmetrize_adj, JO.symmetrize_adj),
            ("power3", lambda a: TO.power_adj(a, 3),
             lambda a: JO.power_adj(a, 3)),
            ("preprocess", TO.preprocess_adj, JO.preprocess_adj)):
        for a in (adj, soft):
            at = torch.tensor(a, requires_grad=True)
            vt = fn_t(at)
            (gt,) = torch.autograd.grad(torch.sum(vt * torch.tensor(w)), at)
            vj = fn_j(jnp.asarray(a))
            gj = jax.grad(lambda x: jnp.sum(fn_j(x) * w))(jnp.asarray(a))
            np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj),
                                       rtol=1e-12, atol=1e-15, err_msg=name)
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj),
                                       rtol=1e-12, atol=1e-15, err_msg=name)
    # power_adj takes numpy too
    np.testing.assert_array_equal(TO.power_adj(adj, 2), adj @ adj)


def test_clip_ste_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.5, 1.5, (6, 5))
    g = rng.standard_normal((6, 5))
    xt = torch.tensor(x, requires_grad=True)
    vt = TO.clip_ste(xt)
    (gt,) = torch.autograd.grad(vt, xt, torch.tensor(g))
    vj, vjp = jax.vjp(JO.clip_ste, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(vt.detach().numpy(), np.asarray(vj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert (gt.numpy() >= 0).all() and (gt.numpy() <= 1).all()
    # the backward is built from differentiable ops, and vmaps
    batched = torch.func.vmap(TO.clip_ste)(torch.tensor(x))
    np.testing.assert_array_equal(batched.numpy(), np.asarray(vj))


# ---------------------------------------------------------------------------
# Plots
# ---------------------------------------------------------------------------

def _write_snapshots(d, epochs, n=8, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for e in epochs:
        adj = (rng.random((n, n)) < 0.3).astype(float)
        with open(os.path.join(d, f"epoch_{e}.pkl"), "wb") as f:
            pickle.dump({"edge_index": np.stack(np.nonzero(adj)),
                         "marglik": -float(e), "num_edges": adj.sum(),
                         "homophily": 0.5, "epoch": e}, f)


def test_plot_helpers_match_jax(tmp_path):
    d = str(tmp_path / "snaps")
    _write_snapshots(d, [100, 20, 3, 60])
    t = list(TP.get_learned_graphs(d))
    j = list(JP.get_learned_graphs(d))
    assert [fn for fn, _ in t] == [fn for fn, _ in j]
    assert [s["epoch"] for _, s in t] == [3, 20, 60, 100]
    (fn, s), = TP.get_learned_graphs(d, epoch_num=60)
    assert fn.endswith("epoch_60.pkl") and s["epoch"] == 60
    adj, y, _ = _graph(4, n=20)
    np.testing.assert_array_equal(TP.class_sort_order(y),
                                  JP.class_sort_order(y))
    ei = np.stack(np.nonzero(adj))
    assert TP.count_type_edges(ei, y) == JP.count_type_edges(ei, y)


@pytest.mark.parametrize("power", [1, 2])
def test_plots_build_and_save(tmp_path, power):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    adj, y, rng = _graph(5, n=16)
    ei = np.stack(np.nonzero(adj))
    for arg in (adj, ei):
        out = str(tmp_path / f"adj_{power}_{arg.shape[0]}.png")
        ft = TP.plot_adjacency_by_class(arg, y, title="t", out_fn=out,
                                        power=power)
        fj = JP.plot_adjacency_by_class(arg, y, title="t", power=power)
        assert os.path.getsize(out) > 0
        np.testing.assert_array_equal(ft.axes[0].images[0].get_array(),
                                      fj.axes[0].images[0].get_array())
        plt.close(ft)
        plt.close(fj)
    epochs = [40, 20, 60]
    figs = [
        TP.plot_avg_local_homophily(
            epochs, [0.5, 0.4, 0.6], [0.3, 0.2, 0.1],
            losses={"epochs": epochs, "train_loss": [1.0, 2.0, 0.5],
                    "val_loss": [1.5, 2.5, 0.7]},
            out_fn=str(tmp_path / "homophily.png")),
        TP.plot_interaction_bounds(epochs, [1, 2, 3], [3, 2, 1], [1, 1, 2],
                                   [2, 2, 1],
                                   out_fn=str(tmp_path / "bounds.png")),
        TP.plot_degree_distribution(adj, adj.T,
                                    out_fn=str(tmp_path / "degree.png"))]
    for f in ("homophily.png", "bounds.png", "degree.png"):
        assert os.path.getsize(tmp_path / f) > 0
    # the homophily curve is drawn in epoch order
    np.testing.assert_array_equal(figs[0].axes[0].lines[0].get_xdata(),
                                  [20, 40, 60])
    for f in figs:
        plt.close(f)
