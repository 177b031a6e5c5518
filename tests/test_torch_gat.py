"""Port parity for dense GAT: models/layers.py::GATConv and its attention
paths, models/models.py::GAT, BaseGNN.jvp_safe, the mixed-diagonal KFAC
blocks (curvature/kfac.py), the GAT -log marglik and the GAT marglik
trainer, torch against JAX in float64 on the CPU.

On the CPU the JAX flash entry runs its XLA fallback and the port's flash
Function runs the plain versions of its kernels, so every comparison here
is composed float64 math: 1e-10 (values) and 1e-9 relative (after Adam
steps, whose sqrt(v) division amplifies the last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.curvature.kfac import compute_kfac_factors as jkfac
from laplace_gnn_tpu.models.layers import GATConv as JGATConv
from laplace_gnn_tpu.models.layers import _masked_attention_chunked as jchunk
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.curvature.kfac import compute_kfac_factors as tkfac
from laplace_gnn_torch.models.layers import _masked_attention_chunked
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils.pytree import named_leaves, params_from_numpy

ATOL = 1e-10
N, D, HID, C = 20, 6, 8, 4
M = 12


def _graph(n=N, d=D, seed=11, p=0.3):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < p).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    X = rng.standard_normal((n, d))
    y = rng.integers(0, C, n)
    return X, adj, y


def _jax_params(model, seed=1):
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(seed)))


def _models(impl="flash", seed=11, **kw):
    """(JAX GAT, port GAT, JAX params as numpy, labels)."""
    X, adj, y = _graph(seed=seed)
    kw = {"heads": 2, "concat": False, "dropout_p": 0.0, **kw}
    jm = JM.GAT(D, HID, C, 2, X, adj, attention_impl=impl, **kw)
    tm = TM.GAT(D, HID, C, 2, X, adj, attention_impl=impl, device="cpu",
                dtype=torch.float64, **kw)
    return jm, tm, _jax_params(jm), y


def _t(x):
    return torch.as_tensor(np.array(x))


# --- layers ---

@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("impl", ["dense", "chunked", "flash", "callable"])
def test_gatconv_matches_jax(impl, concat):
    X, adj, _ = _graph(n=30, d=7, seed=3)
    adj = np.minimum(adj + np.eye(30), 1.0)
    adj[4] = 0.0                                   # a row with no neighbour
    kw = dict(heads=3, concat=concat)
    if impl == "chunked":
        kw["row_block"] = 8
    elif impl == "flash":
        kw["attention_impl"] = "flash"
    jconv = JGATConv(7, 5, **kw)
    if impl == "callable":
        jconv.attention_impl = lambda *a: jchunk(*a, 8)
        kw["attention_impl"] = lambda *a: _masked_attention_chunked(*a, 8)
    tconv = TM.GATConv(7, 5, dtype=torch.float64, **kw)
    jp = _jax_params(jconv, 0)
    want = jconv.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                       jnp.asarray(adj), jnp.asarray(X))
    tp = {"lin.weight": _t(jp["lin"]["weight"]),
          **{k: _t(jp[k]) for k in ("att_src", "att_dst", "bias")}}
    assert set(tp) == {k for k, _ in tconv.named_parameters()}
    got = functional_call(tconv, tp, (_t(adj), _t(X)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mask_dtype", [None, "int8"])
@pytest.mark.parametrize("impl", [None, "flash"])
@pytest.mark.parametrize("concat", [True, False])
def test_gat_forward_matches_jax(concat, impl, mask_dtype):
    jm, tm, jp, _ = _models(impl, concat=concat, mask_dtype=mask_dtype)
    tp = params_from_numpy(jp, device="cpu")
    # the JAX parameter names cross over unchanged
    assert set(tp) == set(tm.params())
    assert {k for k in tp if k.startswith("convs.0")} == {
        "convs.0.lin.weight", "convs.0.att_src", "convs.0.att_dst",
        "convs.0.bias"}
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, jp))
    got = tm.apply(tp)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    assert tm.first_tap_static is False


def test_gat_heads_must_divide_concat_width():
    X, adj, _ = _graph()
    with pytest.raises(ValueError, match="divisible"):
        TM.GAT(D, 7, C, 2, X, adj, heads=2, concat=True, device="cpu")


# --- jvp_safe ---

def test_jvp_safe_semantics():
    _, model_fl, jp, _ = _models("flash")
    _, model_rf, _, _ = _models(None)
    assert model_rf.jvp_safe() is model_rf
    safe = model_fl.jvp_safe()
    assert safe is not model_fl
    assert all(c.attention_impl is None for c in safe.convs)
    assert all(c.attention_impl == "flash" for c in model_fl.convs)
    # the clone shares every parameter and buffer under the same names
    assert dict(safe.named_parameters()).keys() == \
        dict(model_fl.named_parameters()).keys()
    for (_, a), (_, b) in zip(safe.named_parameters(),
                              model_fl.named_parameters()):
        assert a is b
    assert safe.X is model_fl.X
    tp = params_from_numpy(jp, device="cpu")
    np.testing.assert_allclose(safe.apply(tp).detach().numpy(),
                               model_fl.apply(tp).detach().numpy(),
                               atol=ATOL)
    # callable impls are plain PyTorch and stay
    impl = lambda *a: _masked_attention_chunked(*a, 8)          # noqa: E731
    _, model_cb, _, _ = _models(impl)
    assert model_cb.jvp_safe() is model_cb


# --- KFAC with exact-diagonal blocks ---

@pytest.mark.parametrize("last_layer", [False, True])
def test_kfac_mixed_diag_blocks_match_jax(last_layer):
    jm, tm, jp, y = _models(None, concat=True)
    idx = np.arange(M)
    jk = jkfac(jm, jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(idx),
               jnp.asarray(y[:M]), "classification", N=M, mixed_diag=True,
               last_layer=last_layer)
    tk = tkfac(tm, params_from_numpy(jp, device="cpu"), _t(idx),
               _t(y[:M]), "classification", N=M, mixed_diag=True,
               last_layer=last_layer)
    assert [len(g) for g in tk.kfacs] == [len(g) for g in jk.kfacs]
    assert [g[0].dim() for g in tk.kfacs] == [g[0].ndim for g in jk.kfacs]
    for gt_, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt_, gj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)
    # without mixed_diag the non-Linear posterior parameters are refused
    with pytest.raises(ValueError, match="mixed_diag"):
        tkfac(tm, params_from_numpy(jp, device="cpu"), _t(idx), _t(y[:M]),
              "classification", N=M)
    with pytest.raises(NotImplementedError, match="diag_probes"):
        tkfac(tm, params_from_numpy(jp, device="cpu"), _t(idx), _t(y[:M]),
              "classification", N=M, mixed_diag=True, diag_probes=4)


# --- -log marglik and the trainer ---

@pytest.mark.parametrize("impl", ["flash", None, "callable"])
def test_gat_neg_marglik_matches_jax(impl):
    if impl == "callable":
        j_impl = lambda *a: jchunk(*a, 8)                       # noqa: E731
        t_impl = lambda *a: _masked_attention_chunked(*a, 8)    # noqa: E731
    else:
        j_impl = t_impl = impl
    X, adj, y = _graph()
    kw = dict(heads=2, concat=False, dropout_p=0.0)
    jm = JM.GAT(D, HID, C, 2, X, adj, attention_impl=j_impl, **kw)
    tm = TM.GAT(D, HID, C, 2, X, adj, attention_impl=t_impl, device="cpu",
                dtype=torch.float64, **kw)
    jp = _jax_params(jm)
    idx = np.arange(M)
    jfn = JT.make_neg_marglik_fn(jm, "classification", "kron", "all", N=M,
                                 prior_precision=0.7)
    jv, jg = jax.value_and_grad(jfn)(jax.tree_util.tree_map(jnp.asarray, jp),
                                     jnp.asarray(idx), jnp.asarray(y[:M]))
    tfn = TT.make_neg_marglik_fn(tm, "classification", "kron", "all", N=M,
                                 prior_precision=0.7)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    tv = tfn(tp, _t(idx), _t(y[:M]))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-10)
    # the value is differentiable w.r.t. the weights, through the KFAC and
    # the exact-diagonal blocks, and matches jax.grad
    names = [k for k in tp if k != "adj"]
    grads = torch.autograd.grad(tv, [tp[k] for k in names])
    jflat = dict(named_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg), device="cpu")))
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), jflat[k].numpy(), rtol=1e-8,
                                   atol=1e-10, err_msg=k)


@pytest.mark.parametrize("impl", ["flash", None])
def test_gat_marglik_optimization_matches_jax(impl):
    """The JAX package's flash-GAT trainer test, held to the port: train
    steps run reverse mode through the flash Function, per-epoch -log
    marglik evaluations run the jvp_safe clone, no hypersteps."""
    n, d, hid = 16, 5, 6
    rng = np.random.default_rng(12)
    a = (rng.random((n, n)) < 0.35).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    X = rng.standard_normal((n, d))
    y = rng.integers(0, 2, n)
    tr, va = np.arange(10), np.arange(10, 16)
    kw = dict(heads=2, concat=False, dropout_p=0.0, attention_impl=impl)
    jm = JM.GAT(d, hid, 2, 2, X, adj, **kw)
    tm = TM.GAT(d, hid, 2, 2, X, adj, device="cpu", dtype=torch.float64,
                **kw)
    jp = _jax_params(jm, 0)
    run = dict(lr=0.05, lr_adj=0.1, n_epochs=6, n_hypersteps=1,
               n_epochs_burnin=2, marglik_frequency=2, model_type="gat",
               verbose=False)
    jres, jpar, jl, jvl, jnm = JT.marglik_optimization(
        jm, jax.tree_util.tree_map(jnp.asarray, jp), tr, y[tr], va, y[va],
        **run)
    tres, tpar, tl, tvl, tnm = TT.marglik_optimization(
        tm, params_from_numpy(jp, device="cpu"), tr, y[tr], va, y[va],
        device="cpu", **run)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    np.testing.assert_allclose(tvl, jvl, rtol=1e-9)
    np.testing.assert_allclose(tnm, jnm, rtol=1e-9)
    jflat = dict(named_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpar), device="cpu")))
    for k, v in tpar.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    # GAT takes no hypersteps: the adjacency is untouched
    np.testing.assert_array_equal(tpar["adj"].numpy(), jp["adj"])
    for crit in ("marglik", "valloss"):
        assert tres[crit]["epoch"] == jres[crit]["epoch"]
