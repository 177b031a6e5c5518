"""Port parity for training/marglik_gnn.py, graph/data.py and
graph/homophily.py: the hyperstep's value and d/d adj, and a few epochs of
the marglik trainer, torch against JAX in float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.graph import data as JD
from laplace_gnn_tpu.graph import homophily as JH
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.graph import data as TD
from laplace_gnn_torch.graph import homophily as TH
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils.pytree import params_from_numpy, named_leaves

N, F, H, C = 40, 12, 8, 3
M = 20


def _setup(fused, seed=0, soften=True):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    adj = (rng.random((N, N)) < 0.1).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, C, N)
    jm = JM.STEGCN(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                   symmetric=True)
    tm = TM.STEGCN(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                   symmetric=True, device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if soften:
        jp["adj"] = np.where(rng.random((N, N)) < 0.15, 0.5,
                             jp["adj"] * 0.7 + 0.2)
    return jm, tm, jp, y


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_neg_marglik_value_and_adj_gradient(fused, cache):
    """The fused STE op gives an exactly zero d/d adj in the JAX hyperstep
    (its forward rule is differentiated as plain code under the outer
    derivative); the composed path gives the STE gradient. The port
    matches both."""
    jm, tm, jp, y = _setup(fused)
    idx = np.arange(M)
    jfn = JT.make_neg_marglik_fn(jm, "classification", "kron", "all", N=M,
                                 prior_precision=0.7,
                                 cache_static_factors=cache)
    jv, jg = jax.jit(jax.value_and_grad(jfn))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(idx),
        jnp.asarray(y[:M]))
    tfn = TT.make_neg_marglik_fn(tm, "classification", "kron", "all", N=M,
                                 prior_precision=0.7,
                                 cache_static_factors=cache)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    tv = tfn(tp, torch.as_tensor(idx), torch.as_tensor(y[:M]))
    (ga,) = torch.autograd.grad(tv, tp["adj"], allow_unused=True)
    ga = torch.zeros(N, N, dtype=torch.float64) if ga is None else ga
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-12)
    jga = np.asarray(jg["adj"])
    assert (np.abs(jga).max() == 0) == fused
    np.testing.assert_allclose(ga.numpy(), jga, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_neg_marglik_last_layer_and_unported_structures(fused):
    """The last-layer Kron value, and the "diag" and "full" GGN structures:
    value and d/d adj, against JAX."""
    jm, tm, jp, y = _setup(fused)
    idx = np.arange(M)
    jv = jax.jit(JT.make_neg_marglik_fn(jm, "classification", "kron",
                                        "last_layer", N=M))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(idx),
        jnp.asarray(y[:M]))
    tv = TT.make_neg_marglik_fn(tm, "classification", "kron", "last_layer",
                                N=M)(params_from_numpy(jp, device="cpu"),
                                     torch.as_tensor(idx),
                                     torch.as_tensor(y[:M]))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-12)
    for structure in ("diag", "full"):
        jfn = JT.make_neg_marglik_fn(jm, "classification", structure, "all",
                                     N=M, prior_precision=0.7)
        jv, jg = jax.jit(jax.value_and_grad(jfn))(
            jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(idx),
            jnp.asarray(y[:M]))
        tfn = TT.make_neg_marglik_fn(tm, "classification", structure, "all",
                                     N=M, prior_precision=0.7)
        tp = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(jp, device="cpu").items()}
        tv = tfn(tp, torch.as_tensor(idx), torch.as_tensor(y[:M]))
        (ga,) = torch.autograd.grad(tv, tp["adj"], allow_unused=True)
        ga = torch.zeros(N, N, dtype=torch.float64) if ga is None else ga
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-10,
                                   err_msg=structure)
        np.testing.assert_allclose(ga.numpy(), np.asarray(jg["adj"]),
                                   rtol=1e-8, atol=1e-12, err_msg=structure)


@pytest.mark.parametrize("fused", [True, False])
def test_marglik_optimization_matches_jax(fused):
    jm, tm, jp, y = _setup(fused, seed=1, soften=False)
    tr, va = np.arange(M), np.arange(M, 30)
    kw = dict(val_indices=va, val_labels=y[va], y=y, lr=1e-2, lr_adj=0.8,
              weight_decay=5e-5, weight_decay_adj=5e-4, momentum_adj=0.9,
              n_epochs=5, n_hypersteps=2, n_epochs_burnin=2,
              marglik_frequency=2, grad_norm=True, verbose=False)
    jres, jpar, jl, jvl, jnm = JT.marglik_optimization(
        jm, jax.tree_util.tree_map(jnp.asarray, jp), tr, y[tr], **kw)
    tres, tpar, tl, tvl, tnm = TT.marglik_optimization(
        tm, params_from_numpy(jp, device="cpu"), tr, y[tr], device="cpu",
        **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    np.testing.assert_allclose(tvl, jvl, rtol=1e-10)
    np.testing.assert_allclose(tnm, jnm, rtol=1e-10)
    jflat = dict(named_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpar), device="cpu")))
    for k, v in tpar.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    # the hypersteps moved the adjacency (weight decay at least)
    assert not np.allclose(tpar["adj"].numpy(), jp["adj"])
    for crit in ("marglik", "valloss"):
        assert tres[crit]["epoch"] == jres[crit]["epoch"]


def test_marglik_optimization_without_validation(tmp_path):
    jm, tm, jp, y = _setup(True, seed=2, soften=False)
    tr = np.arange(M)
    kw = dict(n_epochs=3, n_hypersteps=1, n_epochs_burnin=1,
              marglik_frequency=1, verbose=True, log_every=1, y=y)
    _, jpar, jl, jvl, jnm = JT.marglik_optimization(
        jm, jax.tree_util.tree_map(jnp.asarray, jp), tr, y[tr], **kw)
    res, tpar, tl, tvl, tnm = TT.marglik_optimization(
        tm, params_from_numpy(jp, device="cpu"), tr, y[tr], device="cpu",
        learned_graphs_dir=str(tmp_path), **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    np.testing.assert_allclose(tnm, jnm, rtol=1e-10)
    assert tvl == [] and res["valloss"]["params"] is None
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "epoch_1.pkl", "epoch_2.pkl", "latest_adj.npy"]
    with pytest.raises(ValueError):
        TT.marglik_optimization(tm, params_from_numpy(jp, device="cpu"), tr,
                                y[tr], stop_criterion="valloss",
                                device="cpu")


def test_mean_eval_matches_jax():
    jm, tm, jp, y = _setup(True, seed=3)
    idx = np.arange(M)
    jl, ja = JT.mean_eval(jm, jax.tree_util.tree_map(jnp.asarray, jp), idx,
                          y[idx])
    tl, ta = TT.mean_eval(tm, params_from_numpy(jp, device="cpu"), idx,
                          y[idx])
    np.testing.assert_allclose(tl, jl, rtol=1e-12)
    # JAX takes the mean of a boolean in float32
    assert ta == pytest.approx(ja, rel=1e-6)


def test_graph_data_and_homophily():
    rng = np.random.default_rng(4)
    adj = (rng.random((N, N)) < 0.2).astype(float)
    labels = rng.integers(0, C, N)
    ei = TD.adj_to_edge_index(adj)
    np.testing.assert_array_equal(ei, JD.adj_to_edge_index(adj))
    np.testing.assert_array_equal(TD.edge_index_to_adj(ei, N),
                                  JD.edge_index_to_adj(ei, N))
    w = rng.random(ei.shape[1])
    np.testing.assert_array_equal(TD.edge_index_to_adj(ei, N, w),
                                  JD.edge_index_to_adj(ei, N, w))
    assert TH.global_homophily(adj, labels) == JH.global_homophily(adj,
                                                                   labels)
    assert TH.global_homophily(np.zeros((3, 3)), labels[:3]) == 0.0
    tr, te = np.arange(10), np.arange(10, N)
    assert TH.avg_local_homophilies(adj, tr, te, labels) == \
        JH.avg_local_homophilies(adj, tr, te, labels)
