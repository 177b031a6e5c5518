"""The port's sharded layer (laplace_gnn_torch/parallel) on 4 Gloo ranks on
the CPU against the JAX package in float64.

One world per module: a fixture writes the JAX parameters, starts four
processes of ``torch_sharded_worker.py`` (a ``file://`` rendezvous under
the test's own temporary directory, so no port is shared) and reads what
each rank wrote. The JAX side runs here, on ``make_mesh(4)`` over the
conftest's virtual CPU devices, or on JAX's single-device model where
JAX's own tests (tests/test_parallel.py) hold the two equal.

Tolerances (float64): the aggregates' values and gradients 1e-12; the
sharded SparseGCN / SparseGAT forward and gradients 1e-12 and their -log
marglik 1e-10 relative (gradients 1e-10 absolute + relative); the
row-sharded GAT composition rtol 1e-9 on the value and atol 1e-9 / rtol
1e-7 on every gradient leaf (test_parallel.py:675-679); the AttSTEGCN
hyperstep rtol 1e-10 on the value, rtol 1e-8 / atol 1e-10 on d/d adj_W
(:720-723); the sharded train step's losses and parameters after 3 steps
1e-10; the composed STE-GCN hyperstep on row blocks 1e-10 on the value
and on each rank's block of d/d adj. Placed values and body outputs are
the rank's row blocks (their shapes are checked); the worker reports them
gathered, and every rank must report the same whole values."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_sharded_worker as W
from laplace_gnn_tpu.graph import container as JC
from laplace_gnn_tpu.parallel import mesh as JMESH
from laplace_gnn_tpu.parallel import sharded as JS

WORLD = 4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_sharded_worker.py")
F64 = jnp.float64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    """JAX pytree -> {dotted name: array}, the port's names."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def _models():
    """The JAX models and parameters of the checks, by name."""
    from laplace_gnn_tpu import models as JM
    out = {}
    ei, X, y = W.sparse_model_data()
    g = JC.sparse_from_edge_index(ei, X.shape[0], normalize="sym")
    m = JM.SparseGCN(16, 8, 4, 2, jnp.asarray(X), g, dropout_p=0.0)
    out["sparse_gcn"] = (m, m.init(jax.random.PRNGKey(0), F64), y)
    m = JM.SparseGCN(16, 8, 4, 2, jnp.asarray(X), g, dropout_p=0.0,
                     norm="batch")
    out["sparse_gcn_bn"] = (m, m.init(jax.random.PRNGKey(6), F64), y)
    for name, seed, every in (("gat", 8, None), ("gat_zero_a2a", 11, 7),
                              ("gat_zero_ring", 11, 7)):
        ei_g, w = W.gat_graph(seed, p=0.25 if every else 0.2,
                              zero_every=every)
        gg = JC.sparse_from_edge_index(ei_g, 32, weights=w, normalize=None,
                                       add_self_loops=False)
        mg = JM.SparseGAT(8, 8, 3, 2, jnp.asarray(W.features(seed + 50, 32,
                                                             8)),
                          gg, dropout_p=0.0)
        out[name] = (mg, mg.init(jax.random.PRNGKey(0), F64), None)
    X, adj, y = W.dense_gat_data()
    m = JM.GAT(8, 8, 4, 2, jnp.asarray(X), jnp.asarray(adj), heads=2,
               concat=True, dropout_p=0.0)
    out["dense_gat"] = (m, m.init(jax.random.PRNGKey(3), F64), y)
    X, adj, y = W.att_data()
    m = JM.AttSTEGCN(8, 8, 4, 2, jnp.asarray(X), jnp.asarray(adj),
                     dropout_p=0.0)
    out["att"] = (m, m.init(jax.random.PRNGKey(4), F64), y)
    X, adj, y = W.step_data()
    m = JM.STEGCN(16, 8, 3, 2, jnp.asarray(X), jnp.asarray(adj),
                  dropout_p=0.0)
    out["step"] = (m, m.init(jax.random.PRNGKey(0), F64), y)
    X, adj, y = W.ste_data()
    m = JM.STEGCN(16, 8, 3, 2, jnp.asarray(X), jnp.asarray(adj),
                  dropout_p=0.0)
    out["ste"] = (m, m.init(jax.random.PRNGKey(7), F64), y)
    m = JM.STEGCN(16, 8, 3, 2, jnp.asarray(X), jnp.asarray(adj),
                  dropout_p=0.0, symmetric=True, train_masked_update=True,
                  train_nodes=jnp.arange(W.STE_MASKED))
    out["ste_sym"] = (m, m.init(jax.random.PRNGKey(8), F64), y)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX models, each rank's results) of one 4-rank run."""
    d = tmp_path_factory.mktemp("sharded")
    models = _models()
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({k: _np_tree(p) for k, (_, p, _) in models.items()}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), f"file://{d}/rdzv",
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return models, ranks


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _replicated(result: dict, name: str):
    """What a check reports the same on every rank (its whole values)."""
    if name == "ste_hyperstep":        # each rank's own block of d/d adj
        return {k: {kk: vv for kk, vv in v.items() if kk != "adj_grad"}
                for k, v in result.items()}
    return result


def test_every_rank_holds_the_same_values(world):
    _, ranks = world
    for r in range(1, WORLD):
        for name in W.CHECKS:
            assert _equal(_replicated(ranks[r][name], name),
                          _replicated(ranks[0][name], name)), (r, name)


def test_placed_values_and_outputs_are_blocks(world):
    """Each rank holds its block of every placed value and of every body
    output: R = N / 4 rows."""
    _, ranks = world
    for r in range(WORLD):
        agg = ranks[r]["aggregates"]["shapes"]
        for name in ("dense", "ring_dense"):
            assert agg[name] == [(8, 32), (8, 8), (8, 8), (8, 32), (8, 8)]
        for name in ("sparse_allgather", "sparse_alltoall", "sparse_ring"):
            assert agg[name] == [(W.N_AGG // WORLD, W.D_AGG)] * 3
        assert agg["sparse_vmap"] == [(3, W.N_AGG // WORLD, W.D_AGG)]
        sm = ranks[r]["sparse_models"]["shapes"]
        assert sm == {"X": (16, 16), "block_out": (16, 4)}
        gat = ranks[r]["row_sharded_gat"]
        for key in ("plain", "flash"):
            assert gat[f"{key}_shapes"] == {"adj": (32, 128),
                                            "block_out": (32, 4)}
        ste = ranks[r]["ste_hyperstep"]
        assert ste["sharded"]["adj_shape"] == (32, 128)
        assert ste["unsharded"]["adj_shape"] == (128, 128)
        step = ranks[r]["train_step"]
        assert step["adj_shape fused=False"] == (8, 32)
        assert step["adj_shape fused=True"] == (32, 32)


def _close(a, b, tol=1e-12, rtol=None):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol if rtol is None else rtol)


def _jmesh(model_parallel=1):
    return JMESH.make_mesh(WORLD, model_parallel=model_parallel)


def test_dense_aggregates(world):
    out = world[1][0]["aggregates"]
    mesh = _jmesh()
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((32, 32)))
    x = jnp.asarray(rng.standard_normal((32, 8)))
    spec = NamedSharding(mesh, P("graph", None))
    ring, _ = JS.make_ring_dense_aggregate(mesh, 32)
    for name, f in (("dense", lambda a, v: JS.sharded_aggregate(mesh, a, v)),
                    ("ring_dense", ring)):
        a_, v_ = jax.device_put(A, spec), jax.device_put(x, spec)
        val = jax.jit(f)(a_, v_)
        ga, gv = jax.jit(jax.grad(lambda a, v: jnp.sum(jnp.sin(f(a, v))),
                                  argnums=(0, 1)))(a_, v_)
        for got, want in zip(out[name], (val, ga, gv)):
            _close(got, want)


@pytest.mark.parametrize("name", ["allgather", "alltoall", "ring"])
def test_sparse_aggregates(world, name):
    out = world[1][0]["aggregates"]
    ei, _ = W.agg_graph(1)
    g = JC.sparse_from_edge_index(ei, W.N_AGG, normalize="sym")
    x = jnp.asarray(W.features(2, W.N_AGG, W.D_AGG))
    maker = {"allgather": JS.make_sharded_sparse_aggregate,
             "alltoall": JS.make_halo_sparse_aggregate,
             "ring": JS.make_ring_halo_sparse_aggregate}[name]
    f, put, *stats = maker(_jmesh(), g, W.D_AGG)
    val = jax.jit(f)(put(x))
    gx = jax.jit(jax.grad(lambda v: jnp.sum(f(v) ** 2)))(put(x))
    _close(out[f"sparse_{name}"][0], val)
    _close(out[f"sparse_{name}"][1], gx)
    if stats:
        # the bodies return blocks, as JAX's do: the stats are JAX's
        assert out[f"stats_{name}"] == stats[0]


def test_halo_vmap_jvp_and_bits(world):
    out = world[1][0]["aggregates"]
    ei, _ = W.agg_graph(1)
    dense = np.asarray(JC.sparse_from_edge_index(
        ei, W.N_AGG, normalize="sym").to_dense())
    xb = np.random.default_rng(3).standard_normal((3, W.N_AGG, W.D_AGG))
    _close(out["sparse_vmap"], np.einsum("ij,bjd->bid", dense, xb))
    _close(out["sparse_jvp"], dense @ xb[0])
    assert out["same_bits"]


def test_halo_auto_schedule_padding_and_one_part(world):
    out = world[1][0]["aggregates"]
    gb = JC.sparse_from_edge_index(W.banded(), 128, normalize="sym")
    hg = JS.HaloAggGraph(_jmesh(), gb)
    assert out["auto_schedule"] == hg.schedule == "ring"
    _close(out["auto_value"], jax.jit(hg.spmm)(hg.put(jnp.asarray(
        W.features(5, 128, 8)))))
    assert out["bogus"] and "schedule" in out["bogus"]
    # a variable-width partition padded to fixed blocks: JAX's halo
    # aggregate on the padded graph; ghost rows receive nothing
    from laplace_gnn_tpu.parallel import edge_balanced_blocks, pad_to_blocks
    ei_s = W.skewed()
    ei2, n_new, node_map, X2 = pad_to_blocks(
        ei_s, edge_balanced_blocks(ei_s, 100, 4), W.features(11, 100, 8))
    g2 = JC.sparse_from_edge_index(ei2, n_new, normalize=None,
                                   add_self_loops=False)
    hg2 = JS.HaloAggGraph(_jmesh(), g2)
    got, got_map = out["padded"]
    np.testing.assert_array_equal(got_map, node_map)
    _close(got, jax.jit(hg2.spmm)(hg2.put(jnp.asarray(X2))))
    ghost = np.setdiff1d(np.arange(n_new), node_map)
    assert np.all(got[ghost] == 0)
    # a one-part graph axis (model axis 4): the local path, no halo
    ei6, _ = W.agg_graph(6, 32, 0.2)
    g6 = JC.sparse_from_edge_index(ei6, 32, normalize="sym")
    x6 = jnp.asarray(W.features(7, 32, 8))
    one = _jmesh(model_parallel=WORLD)
    for name, maker in (("alltoall", JS.make_halo_sparse_aggregate),
                        ("ring", JS.make_ring_halo_sparse_aggregate)):
        f, put, stats = maker(one, g6, 8)
        _close(out[f"one_part_{name}"][0], jax.jit(f)(put(x6)))
        assert out[f"one_part_{name}"][1] == stats["comm_volume_ratio"] == 0
    _close(out["one_part_auto"], g6.spmm(x6))


def _jax_marglik(model, params, idx, y, n, **kw):
    from laplace_gnn_tpu.training.marglik_gnn import make_neg_marglik_fn
    fn = make_neg_marglik_fn(model, "classification", "kron", "all", N=n,
                             **kw)
    val, g = jax.jit(jax.value_and_grad(fn))(_j(params), jnp.asarray(idx),
                                             jnp.asarray(y))
    return float(val), _flat(_np_tree(g))


def _close_marglik(got, want, rtol, g_atol, g_rtol):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for k, v in got[1].items():
        np.testing.assert_allclose(v, want[1][k], atol=g_atol, rtol=g_rtol,
                                   err_msg=k)


def test_halo_sparse_gcn(world):
    models, ranks = world
    out = ranks[0]["sparse_models"]
    m, params, y = models["sparse_gcn"]
    from laplace_gnn_tpu.curvature.losses import cross_entropy_sum
    n = 64
    idx = jnp.arange(n)
    _close(out["gcn_forward"], jax.jit(m.apply)(_j(params), idx))
    g = jax.jit(jax.grad(lambda p: cross_entropy_sum(
        m.apply(p, idx), jnp.asarray(y)) / n))(_j(params))
    g = _flat(_np_tree(g))
    for k, v in out["gcn_grad"].items():
        _close(v, g[k])
    _close_marglik(out["gcn_marglik"], _jax_marglik(m, params, idx, y, n),
                   1e-10, 1e-10, 1e-10)


def test_halo_sparse_gcn_batchnorm(world):
    """BatchNorm's statistics summed over the ranks' blocks: the forward
    and the gradients equal JAX's unsharded SparseGCN(norm="batch")."""
    models, ranks = world
    out = ranks[0]["sparse_models"]
    m, params, y = models["sparse_gcn_bn"]
    from laplace_gnn_tpu.curvature.losses import cross_entropy_sum
    n = 64
    idx = jnp.arange(n)
    _close(out["bn_forward"], jax.jit(m.apply)(_j(params), idx))
    g = jax.jit(jax.grad(lambda p: cross_entropy_sum(
        m.apply(p, idx), jnp.asarray(y)) / n))(_j(params))
    g = _flat(_np_tree(g))
    assert set(out["bn_grad"]) == set(g)
    for k, v in out["bn_grad"].items():
        _close(v, g[k])


def test_sharded_dropout_masks_are_the_unsharded_rows(world):
    """A rank's dropout mask is its rows of the mask the whole graph draws
    from the same generator: the sharded train-mode forward equals the
    one-part one (up to the halo's order of sums), and dropout changed
    it."""
    out = world[1][0]["sparse_models"]["dropout"]
    _close(out["sharded"], out["whole"])
    assert np.abs(out["whole"] - out["off"]).max() > 1e-2


@pytest.mark.parametrize("name", ["gat", "gat_zero_a2a", "gat_zero_ring"])
def test_halo_sparse_gat(world, name):
    models, ranks = world
    out = ranks[0]["sparse_models"]
    m, params, _ = models[name]
    idx = jnp.arange(32)
    want = jax.jit(m.apply)(_j(params), idx)
    _close(out[f"{name}_forward"], want)
    if name != "gat":
        return
    _close(out["gat_one_part_forward"], want)
    y = np.random.default_rng(9).integers(0, 3, 32)

    def loss(p):
        lp = jax.nn.log_softmax(m.apply(p, idx))
        return -jnp.mean(lp[jnp.arange(32), jnp.asarray(y)])

    g = _flat(_np_tree(jax.jit(jax.grad(loss))(_j(params))))
    for k, v in out["gat_grad"].items():
        _close(v, g[k])
    _close_marglik(out["gat_marglik"], _jax_marglik(m, params, idx, y, 32),
                   1e-10, 1e-10, 1e-10)


@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_row_sharded_gat_hyperstep_triple_composition(world, impl):
    """Row-sharded attention x mixed-structure KFAC (column chunks of 2)
    against JAX's single-device dense GAT; with ``use_flash=True`` the
    curvature takes the attention's plain twin (``jvp_safe``)."""
    models, ranks = world
    out = ranks[0]["row_sharded_gat"]
    m, params, y = models["dense_gat"]
    n = 128
    idx = jnp.arange(n)
    _close(out[f"{impl}_forward"], jax.jit(m.apply)(_j(params), idx))
    want = _jax_marglik(m, params, idx, y, n)
    _close_marglik(out[f"{impl}_marglik"], want, 1e-9, 1e-9, 1e-7)
    assert set(out[f"{impl}_marglik"][1]) == set(want[1])
    assert float(np.abs(want[1]["adj"]).max()) == 0.0
    assert out[f"{impl}_twin_is_plain"]


def test_attstegcn_adj_constraint_hyperstep(world):
    models, ranks = world
    m, params, y = models["att"]
    n = 64
    got = ranks[0]["attstegcn"]["marglik"]
    want = _jax_marglik(m, params, jnp.arange(n), y, n)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
    np.testing.assert_allclose(got[1]["adj_W.weight"],
                               want[1]["adj_W.weight"], rtol=1e-8,
                               atol=1e-10)
    assert float(np.abs(want[1]["adj_W.weight"]).max()) > 0


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_train_step(world, fused):
    """make_sharded_train_step against JAX's on make_mesh(4): the losses
    and the parameters after 3 steps, and the placements by leaf."""
    from laplace_gnn_tpu import models as JM
    from laplace_gnn_tpu.curvature.losses import cross_entropy_sum
    models, ranks = world
    out = ranks[0]["train_step"]
    X, adj, y = W.step_data()
    n = X.shape[0]
    m = JM.STEGCN(16, 8, 3, 2, jnp.asarray(X), jnp.asarray(adj),
                  dropout_p=0.0, fused=fused)
    _, params, _ = models["step"]
    step, shard = JS.make_sharded_train_step(
        m, _jmesh(), lambda f, t: cross_entropy_sum(f, t) / n, lr=W.STEP_LR)
    p, shardings = shard(_j(params))
    losses = []
    for _ in range(W.STEP_N):
        p, loss = step(p, jnp.arange(n), jnp.asarray(y))
        losses.append(float(loss))
    got_losses, got_params = out[f"fused={fused}"]
    np.testing.assert_allclose(got_losses, losses, rtol=1e-10)
    want = _flat(_np_tree(p))
    for k, v in got_params.items():
        _close(v, want[k], tol=1e-10)
    specs = {k: tuple(s.spec) for k, s in _flat_shardings(shardings).items()}
    if fused:      # core_spmm reads the square adjacency: kept whole
        specs["adj"] = ()
    assert out[f"specs fused={fused}"] == specs


def test_composed_ste_hyperstep_on_row_blocks(world):
    """The composed STE-GCN Kron hyperstep at P = 4: JAX's -log marglik,
    each rank's block of JAX's d/d adj at 1e-10, and no tensor that its
    autograd graph keeps larger than ceil(N / P) x N (the unsharded
    hyperstep keeps N x N ones)."""
    from laplace_gnn_tpu.training.marglik_gnn import make_neg_marglik_fn
    models, ranks = world
    m, params, y = models["ste"]
    n = 128
    fn = make_neg_marglik_fn(m, "classification", "kron", "all", N=n)
    val, g = jax.jit(jax.value_and_grad(fn))(_j(params), jnp.arange(n),
                                             jnp.asarray(y))
    g_adj = np.asarray(g["adj"])
    assert float(np.abs(g_adj).max()) > 0
    r = -(-n // WORLD)
    for rank in range(WORLD):
        out = ranks[rank]["ste_hyperstep"]
        np.testing.assert_allclose(out["sharded"]["neg_marglik"],
                                   float(val), rtol=1e-10)
        np.testing.assert_allclose(out["sharded"]["adj_grad"],
                                   g_adj[rank * r:(rank + 1) * r],
                                   atol=1e-10, rtol=1e-10)
        assert out["sharded"]["max_saved"] <= r * n
        assert out["unsharded"]["max_saved"] >= n * n


def test_symmetric_masked_ste_hyperstep_on_row_blocks(world):
    """STE-GCN with ``symmetric=True`` (each rank's rows of A^T by one
    all-to-all) and ``train_masked_update`` (the mask's row block): JAX's
    -log marglik and each rank's block of d/d adj at 1e-10."""
    from laplace_gnn_tpu.training.marglik_gnn import make_neg_marglik_fn
    models, ranks = world
    m, params, y = models["ste_sym"]
    n = 128
    fn = make_neg_marglik_fn(m, "classification", "kron", "all", N=n)
    val, g = jax.jit(jax.value_and_grad(fn))(_j(params), jnp.arange(n),
                                             jnp.asarray(y))
    g_adj = np.asarray(g["adj"])
    assert float(np.abs(g_adj).max()) > 0
    r = n // WORLD
    for rank in range(WORLD):
        out = ranks[rank]["ste_hyperstep"]["symmetric_masked"]
        np.testing.assert_allclose(out["neg_marglik"], float(val),
                                   rtol=1e-10)
        np.testing.assert_allclose(out["adj_grad"],
                                   g_adj[rank * r:(rank + 1) * r],
                                   atol=1e-10, rtol=1e-10)


def _flat_shardings(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat_shardings(v, f"{prefix}{k}."))
    return out
