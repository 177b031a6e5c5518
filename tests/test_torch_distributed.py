"""The port's hybrid ('dcn', 'graph', 'model') mesh and its edge-striped
aggregates (laplace_gnn_torch/parallel/distributed.py) against the JAX
package in float64.

The grid arithmetic, ``stripe_edges`` and the per-slice halo plans are
numpy and need no process group. The bodies run on Gloo CPU processes of
``torch_distributed_worker.py``, one group per topology (dcn, graph) =
(2, 1), (2, 2) and (4, 1), all started at once; the JAX side runs here on
``make_hybrid_mesh`` over the conftest's 8 virtual CPU devices (the model
axis takes the rest).

Tolerances (float64): the DCN SpMM and GAT aggregate's values and
gradients 1e-10 (tests/test_distributed.py's are 1e-10 / 1e-9); the
DcnAggGraph SparseGCN / SparseGAT forward 1e-9 and -log marglik rtol
1e-8, gradients atol 1e-8 / rtol 1e-6, against JAX's single-device model,
as tests/test_distributed.py holds JAX's DCN path; ``mp_worker.py``'s four
scalars rtol 2e-4, as JAX's multi-process test."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_distributed_worker as W
from laplace_gnn_tpu.graph.container import sparse_from_edge_index as jsg
from laplace_gnn_tpu.parallel import distributed as JD
from laplace_gnn_torch.graph.container import sparse_from_edge_index as tsg
from laplace_gnn_torch.parallel import distributed as TD

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_distributed_worker.py")
TOPOLOGIES = [(2, 1), (2, 2), (4, 1)]
F64 = jnp.float64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
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


def _jmesh(dcn, gp):
    return JD.make_hybrid_mesh(dcn_parallel=dcn,
                               model_parallel=8 // (dcn * gp), n_devices=8)


# -- no process group ---------------------------------------------------------

@pytest.mark.parametrize("dcn,mp,hosts", [
    (2, 2, [0] * 8), (4, 1, [0] * 8), (None, 1, [0] * 8),
    (2, 1, [0] * 4 + [1] * 4), (None, 2, [0] * 4 + [1] * 4),
    (4, 1, [1, 0] * 4)])
def test_hybrid_grid_equals_jax_arithmetic(dcn, mp, hosts):
    """The (dcn, graph, model) grid: JAX's shapes for one host (its
    single-process mesh); with several hosts 'dcn' varies slowest by host,
    so each slice's ranks share a host."""
    grid = TD.hybrid_grid(8, hosts, dcn, mp)
    n_hosts = len(set(hosts))
    want_dcn = dcn or n_hosts
    assert grid.shape == (want_dcn, 8 // (want_dcn * mp), mp)
    assert sorted(grid.ravel().tolist()) == list(range(8))
    if n_hosts == 1:
        jm = JD.make_hybrid_mesh(dcn_parallel=dcn or 1, model_parallel=mp)
        assert grid.shape == tuple(jm.shape.values())
        assert grid.ravel().tolist() == list(range(8))
    for k in range(grid.shape[0]):
        slice_hosts = {hosts[r] for r in grid[k].ravel()}
        if want_dcn >= n_hosts:
            assert len(slice_hosts) == 1
    if want_dcn == n_hosts:
        assert len({hosts[grid[k, 0, 0]] for k in range(want_dcn)}) \
            == n_hosts


@pytest.mark.parametrize("kw", [dict(dcn_parallel=3), dict(model_parallel=3),
                                dict(dcn_parallel=4, model_parallel=4),
                                dict(dcn_parallel=16)])
def test_hybrid_grid_raises_as_jax(kw):
    with pytest.raises(ValueError):
        JD.make_hybrid_mesh(**kw)
    with pytest.raises(ValueError):
        TD.hybrid_grid(8, [0] * 8, **kw)


def test_hybrid_grid_host_errors():
    with pytest.raises(ValueError, match="incompatible"):
        TD.hybrid_grid(6, [0, 0, 1, 1, 2, 2], dcn_parallel=2)
    with pytest.raises(ValueError, match="single-process"):
        TD.hybrid_grid(8, [0] * 4 + [1] * 4, n_devices=8)
    with pytest.raises(ValueError, match="spans every process"):
        TD.hybrid_grid(8, [0] * 8, n_devices=6)
    with pytest.raises(RuntimeError, match="process group"):
        TD.make_hybrid_mesh(device="cpu")


def _graphs():
    jg = jsg(W.agg_edges(), W.N, normalize="sym")
    tg = tsg(W.agg_edges(), W.N, normalize="sym", dtype=__import__(
        "torch").float64, device="cpu")
    return jg, tg


@pytest.mark.parametrize("n_dcn", [1, 2, 3, 4])
def test_stripe_edges_equals_jax(n_dcn):
    jg, tg = _graphs()
    js, ts = JD.stripe_edges(jg, n_dcn), TD.stripe_edges(tg, n_dcn)
    assert len(ts) == n_dcn
    for a, b in zip(js, ts):
        assert a.n_nodes == b.n_nodes
        for k in ("src", "dst", "weights"):
            np.testing.assert_array_equal(np.asarray(getattr(a, k)),
                                          getattr(b, k))


def _jax_stacked(fn):
    """The stacked plan arrays a JAX DCN aggregate closes over."""
    names = fn.__code__.co_freevars
    return fn.__closure__[names.index("stacked")].cell_contents


@pytest.mark.parametrize("dcn,gp", [(2, 2), (2, 4), (4, 2)])
def test_dcn_plans_equal_jax(dcn, gp):
    """The per-slice halo plans with common paddings, stacked, are JAX's
    arrays exactly; the stats are JAX's."""
    jg, tg = _graphs()
    agg, _, jstats = JD.make_dcn_halo_aggregate(_jmesh(dcn, gp), jg)
    want = _jax_stacked(agg)
    plans, H = TD.dcn_halo_plans(tg, TD.stripe_edges(tg, dcn), gp)
    assert H == jstats["H"]
    for k, v in want.items():
        got = np.stack([pl[k] for pl in plans])
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)


# -- the Gloo groups ----------------------------------------------------------

def _jax_params():
    from laplace_gnn_tpu import models as JM
    X, _ = W.model_data()
    jg, _ = _graphs()
    gcn = JM.SparseGCN(16, 16, 4, 2, jnp.asarray(X), jg, dropout_p=0.0)
    Xg, _ = W.gat_model_data()
    gg = jsg(W.gat_edges(seed=12), W.N, normalize=None, add_self_loops=False)
    gat = JM.SparseGAT(8, 8, 3, 2, jnp.asarray(Xg), gg, heads=2,
                       concat=False, dropout_p=0.0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mp_worker
    n, d, c, ei, x, Xm, y, _ = mp_worker.build_problem()
    mp = JM.SparseGCN(d, 16, c, 2, jnp.asarray(Xm),
                      jsg(ei, n, normalize="sym"), dropout_p=0.0)
    return {"gcn": (gcn, gcn.init(jax.random.PRNGKey(1), F64)),
            "gat": (gat, gat.init(jax.random.PRNGKey(2), F64)),
            "mp": (mp, mp.init(jax.random.PRNGKey(1)))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(JAX models, {topology: each rank's results}), every topology's
    group started at once."""
    d = tmp_path_factory.mktemp("dcn")
    models = _jax_params()
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({k: _np_tree(p) for k, (_, p) in models.items()}, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for dcn, gp in TOPOLOGIES:
        world = dcn * gp
        for r in range(world):
            procs[(dcn, gp, r)] = subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world),
                 f"file://{d}/rdzv_{dcn}x{gp}", str(d), str(dcn)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = {}
    try:
        for key, p in procs.items():
            logs[key] = p.communicate(timeout=240)[0].decode()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for key, p in procs.items():
        assert p.returncode == 0, f"{key} failed:\n{logs[key][-4000:]}"
    out = {}
    for dcn, gp in TOPOLOGIES:
        out[(dcn, gp)] = []
        for r in range(dcn * gp):
            with open(d / f"{dcn}x{gp}_rank{r}.pkl", "rb") as f:
                out[(dcn, gp)].append(pickle.load(f))
    return models, out


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dcn,gp", TOPOLOGIES)
def test_mesh_shape_and_blocks(worlds, dcn, gp):
    ranks = worlds[1][(dcn, gp)]
    coords = set()
    for r, res in enumerate(ranks):
        assert res["mesh_shape"] == (dcn, gp, 1)
        coords.add(res["coordinate"])
        b = W.N // gp
        assert res["aggregates"]["shapes"] == [(b, W.D)] * 3
    assert len(coords) == dcn * gp


@pytest.mark.parametrize("dcn,gp", TOPOLOGIES)
def test_dcn_spmm_equals_jax(worlds, dcn, gp):
    jg, _ = _graphs()
    x = jnp.asarray(W.agg_inputs()[0])
    agg, put, stats = JD.make_dcn_halo_aggregate(_jmesh(dcn, gp), jg,
                                                 d_features=W.D)
    val = jax.jit(agg)(put(x))
    gx = jax.jit(jax.grad(lambda v: jnp.sum(jnp.sin(agg(v)))))(put(x))
    for res in worlds[1][(dcn, gp)]:
        got = res["aggregates"]
        _close(got["spmm"][0], val, 1e-10)
        _close(got["spmm"][1], gx, 1e-10)
        assert got["stats"] == stats


@pytest.mark.parametrize("dcn,gp", TOPOLOGIES)
def test_dcn_gat_aggregate_equals_jax(worlds, dcn, gp):
    gg = jsg(W.gat_edges(), W.N, normalize=None, add_self_loops=False)
    h, a_s, a_d = (jnp.asarray(a) for a in W.agg_inputs()[1:])
    gat, put = JD.make_dcn_gat_aggregate(_jmesh(dcn, gp), gg)

    def obj(hh, s, d_):
        return jnp.sum(jnp.sin(gat(hh, s, d_, 0.2)))

    val = jax.jit(lambda *a: gat(*a, 0.2))(put(h), a_s, a_d)
    grads = jax.jit(jax.grad(obj, argnums=(0, 1, 2)))(put(h), a_s, a_d)
    for res in worlds[1][(dcn, gp)]:
        got = res["aggregates"]["gat"]
        _close(got[0], val, 1e-10)
        for a, b in zip(got[1:], grads):
            _close(a, b, 1e-10)


def _jax_marglik(m, params, y):
    from laplace_gnn_tpu.training.marglik_gnn import make_neg_marglik_fn
    fn = make_neg_marglik_fn(m, "classification", "kron", "all", N=W.N)
    val, g = jax.jit(jax.value_and_grad(fn))(params, jnp.arange(W.N),
                                             jnp.asarray(y))
    return float(val), _flat(_np_tree(g))


@pytest.mark.parametrize("name", ["gcn", "gat"])
def test_dcn_agg_graph_marglik_equals_jax(worlds, name):
    """SparseGCN / SparseGAT on a DcnAggGraph at every topology: the
    forward and the KFAC -log marglik with its gradient equal JAX's
    single-device model."""
    models, out = worlds
    m, params = models[name]
    y = (W.model_data() if name == "gcn" else W.gat_model_data())[1]
    f = jax.jit(m.apply)(params, jnp.arange(W.N))
    val, g = _jax_marglik(m, params, y)
    for key, ranks in out.items():
        for res in ranks:
            got = res["models"]
            _close(got[f"{name}_forward"], f, 1e-9)
            np.testing.assert_allclose(got[f"{name}_marglik"][0], val,
                                       rtol=1e-8, err_msg=str(key))
            assert set(got[f"{name}_marglik"][1]) == set(g)
            for k, v in got[f"{name}_marglik"][1].items():
                np.testing.assert_allclose(v, g[k], atol=1e-8, rtol=1e-6,
                                           err_msg=f"{key} {k}")


def test_mp_worker_scalars_equal_jax(worlds):
    """tests/mp_worker.py's four replicated scalars (the DCN SpMM's
    checksum and square sum, the SparseGCN -log marglik and its gradient
    norm) at (dcn, graph) = (2, 2), against JAX's program on its
    (2, 2, 2) hybrid mesh."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mp_worker
    want = mp_worker.compute_scalars(JD.make_hybrid_mesh(
        dcn_parallel=2, model_parallel=2))
    for res in worlds[1][(2, 2)]:
        for k in ("checksum", "sq", "neg_marglik", "grad_norm"):
            np.testing.assert_allclose(res["scalars"][k], want[k],
                                       rtol=2e-4, err_msg=k)
