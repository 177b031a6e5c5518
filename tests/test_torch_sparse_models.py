"""Port parity for the sparse models (models/sparse_gnn.py): SparseGCN,
SparseSAGE and SparseGAT against the JAX package in float64 on the CPU,
with JAX's parameters carried across by ``params_from_numpy``.

Forward passes, KFAC factors, the -log marglik and its weight gradient,
the mixed Kron + diagonal KFAC of SparseGAT and a Kron Laplace's log
marglik agree at 1e-10 relative. The ELL GAT attention computes its scores
and softmax in float32 in both packages (``ell_gat_attention``), so the
ELL SparseGAT agrees at float32 tolerance (1e-6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.curvature.kfac import compute_kfac_factors as jkfac
from laplace_gnn_tpu.graph import container as JC
from laplace_gnn_tpu.laplace import Laplace as JLaplace
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.curvature.kfac import compute_kfac_factors as tkfac
from laplace_gnn_torch.graph import container as TC
from laplace_gnn_torch.laplace.dispatch import Laplace as TLaplace
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils.pytree import named_leaves, params_from_numpy

RTOL = 1e-10
D, HID, C = 6, 8, 4
NORMALIZE = {"gcn": "sym", "sage": "row", "gat": None}
CLASSES = {"gcn": (JM.SparseGCN, TM.SparseGCN),
           "sage": (JM.SparseSAGE, TM.SparseSAGE),
           "gat": (JM.SparseGAT, TM.SparseGAT)}


def _power_law(n=60, seed=5):
    """A hub on every node, a mid-degree cluster and random edges, so
    ``max_k=2`` (pad budget 1.2) gives overflow levels and a remainder."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, n), rng.integers(0, n, 150),
                          np.tile(np.arange(20, 30), 3)])
    dst = np.concatenate([np.zeros(n - 1, int), rng.integers(0, n, 150),
                          np.repeat(np.arange(1, 4), 10)])
    return np.stack([src, dst]), n


def _models(kind, ell=False, agg_dtype=None, seed=5, **kw):
    """(JAX model, port model, JAX params as numpy, labels)."""
    ei, n = _power_law(seed=seed)
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((n, D))
    y = rng.integers(0, C, n)
    jg = JC.sparse_from_edge_index(ei, n, normalize=NORMALIZE[kind])
    tg = TC.sparse_from_edge_index(ei, n, normalize=NORMALIZE[kind],
                                   dtype=torch.float64, device="cpu")
    if ell:
        jg = JC.add_ell_format(jg, max_k=2, pad_budget=1.2)
        tg = TC.add_ell_format(tg, max_k=2, pad_budget=1.2)
        assert tg.ell_levels and tg.has_remainder()
    jg = dataclasses.replace(jg, agg_dtype=agg_dtype)
    tg = dataclasses.replace(tg, agg_dtype=agg_dtype)
    if kind == "gat":
        kw.setdefault("heads", 2)
    jcls, tcls = CLASSES[kind]
    jm = jcls(D, HID, C, 2, jnp.asarray(X), jg, dropout_p=0.0, **kw)
    tm = tcls(D, HID, C, 2, X, tg, dropout_p=0.0, device="cpu",
              dtype=torch.float64, **kw)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tm, jp, y


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(x):
    return torch.as_tensor(np.array(x))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("ell", [False, True])
@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
def test_forward_matches_jax(kind, ell):
    jm, tm, jp, _ = _models(kind, ell)
    tp = params_from_numpy(jp, device="cpu")
    assert set(tp) == set(tm.params()) == set(tm.init())
    assert not any("adj" in k for k in tp)
    want = np.asarray(jax.jit(jm.apply)(_j(jp)))
    got = tm.apply(tp).detach().numpy()
    tol = 1e-6 if (kind == "gat" and ell) else RTOL
    assert _rel(got, want) < tol
    idx = np.array([3, 0, 7])
    np.testing.assert_allclose(tm.apply(tp, _t(idx)).detach().numpy(),
                               got[idx], rtol=0, atol=0)
    assert tm.first_tap_static == jm.first_tap_static
    assert tm.last_layer_closed_form is False
    assert tm.tap_sites(tp) == jm.tap_sites(jp)
    assert tm.last_layer_path(tp) == jm.last_layer_path(jp)
    a, f = tm.features(tp)
    ja = jax.jit(lambda p: jm.features(p)[0])(_j(jp))
    assert _rel(a.detach(), ja) < tol
    np.testing.assert_array_equal(f.detach().numpy(), got)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_bf16_aggregation_matches_jax(kind):
    """bf16 gathers (ELL, levels and remainder): bf16 tolerance."""
    jm, tm, jp, _ = _models(kind, ell=True, agg_dtype="bfloat16")
    want = np.asarray(jax.jit(jm.apply)(_j(jp)))
    got = tm.apply(params_from_numpy(jp, device="cpu")).detach().numpy()
    assert _rel(got, want) < 2e-2


def test_sparse_gcn_matches_dense_gcn():
    """SparseGCN on the normalized edges equals the port's dense GCN."""
    ei, n = _power_law()
    a = np.zeros((n, n))
    a[ei[1], ei[0]] = 1.0
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    X = np.random.default_rng(0).standard_normal((n, D))
    dense = TM.GCN(D, HID, C, 2, X, a, dropout_p=0.0, device="cpu",
                   dtype=torch.float64)
    und = np.array(np.nonzero(a))[::-1]
    sparse = TM.SparseGCN(D, HID, C, 2, X, TC.sparse_from_edge_index(
        und, n, device="cpu", dtype=torch.float64), dropout_p=0.0,
        device="cpu", dtype=torch.float64)
    p = {k: v for k, v in dense.params().items() if k != "adj"}
    torch.testing.assert_close(sparse.apply(p), dense.apply(dense.params()),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("last_layer", [False, True])
def test_kfac_factors_match_jax_sparse_gcn(last_layer):
    jm, tm, jp, y = _models("gcn", ell=True)
    idx = np.arange(0, 60, 2)
    jk = jax.jit(lambda p, i, t: jkfac(
        jm, p, i, t, "classification", N=len(idx), last_layer=last_layer))(
        _j(jp), jnp.asarray(idx), jnp.asarray(y[idx]))
    tk = tkfac(tm, params_from_numpy(jp, device="cpu"), _t(idx), _t(y[idx]),
               "classification", N=len(idx), last_layer=last_layer)
    assert [len(g) for g in tk.kfacs] == [len(g) for g in jk.kfacs]
    for gt, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt, gj):
            assert _rel(a.detach(), b) < RTOL


def test_neg_marglik_matches_jax_sparse_gcn():
    """The -log marglik on the ELL SparseGCN (its SpMM Function in the
    vmapped KFAC pullback) and its weight gradient (through that
    pullback's backward)."""
    jm, tm, jp, y = _models("gcn", ell=True)
    idx = np.arange(0, 60, 2)
    jfn = JT.make_neg_marglik_fn(jm, "classification", "kron", "all",
                                 N=len(idx), prior_precision=0.7)
    jv, jg = jax.jit(jax.value_and_grad(jfn))(_j(jp), jnp.asarray(idx),
                                              jnp.asarray(y[idx]))
    tfn = TT.make_neg_marglik_fn(tm, "classification", "kron", "all",
                                 N=len(idx), prior_precision=0.7)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    tv = tfn(tp, _t(idx), _t(y[idx]))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    grads = torch.autograd.grad(tv, list(tp.values()))
    jflat = dict(named_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg), device="cpu")))
    for k, g in zip(tp, grads):
        assert _rel(g, jflat[k]) < 1e-9, k


def test_mixed_kron_and_diag_sparse_gat_match_jax():
    """SparseGAT's Linear sites get Kron blocks and its attention vectors
    and biases exact curvature diagonals (forward mode through the
    segment sums and gathers)."""
    jm, tm, jp, y = _models("gat")
    idx = np.arange(0, 60, 3)
    jk = jax.jit(lambda p, i, t: jkfac(
        jm, p, i, t, "classification", N=len(idx), mixed_diag=True))(
        _j(jp), jnp.asarray(idx), jnp.asarray(y[idx]))
    tk = tkfac(tm, params_from_numpy(jp, device="cpu"), _t(idx), _t(y[idx]),
               "classification", N=len(idx), mixed_diag=True)
    assert [len(g) for g in tk.kfacs] == [len(g) for g in jk.kfacs]
    assert any(len(g) == 1 and g[0].dim() == 1 for g in tk.kfacs)
    for gt, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt, gj):
            assert _rel(a.detach(), b) < RTOL
    with pytest.raises(ValueError, match="mixed_diag"):
        tkfac(tm, params_from_numpy(jp, device="cpu"), _t(idx), _t(y[idx]),
              "classification", N=len(idx))


def test_kron_laplace_log_marglik_matches_jax():
    """A Kron Laplace over all weights of the ELL SparseSAGE (whose
    row-normalized graph is not symmetric: the SpMM's backward runs on
    the transposed graph)."""
    jm, tm, jp, y = _models("sage", ell=True)
    idx = np.arange(60)

    names = []

    def jax_fit(p):
        la = JLaplace(jm, p, "classification", subset_of_weights="all",
                      hessian_structure="kron")
        names.append(type(la).__name__)
        la.fit([(jnp.asarray(idx), jnp.asarray(y))])
        return la.log_marginal_likelihood()

    want = jax.jit(jax_fit)(_j(jp))
    jname = names[0]
    tla = TLaplace(tm, params_from_numpy(jp, device="cpu"), "classification",
                   subset_of_weights="all", hessian_structure="kron")
    tla.fit([(_t(idx), _t(y))])
    assert type(tla).__name__ == jname == "KronLaplace"
    np.testing.assert_allclose(float(tla.log_marginal_likelihood()),
                               float(want), rtol=RTOL)


def test_sparse_gat_ell_matches_segment_path():
    """The ELL attention (levels and remainder) against the per-edge
    segment path of the same model, forward and weight gradient (float32
    scores: 1e-6)."""
    _, seg, jp, y = _models("gat")
    _, ell, _, _ = _models("gat", ell=True)
    tp = params_from_numpy(jp, device="cpu")
    outs, grads = [], []
    for m in (seg, ell):
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out = m.apply(p)
        loss = torch.nn.functional.cross_entropy(out, _t(y))
        outs.append(out.detach())
        grads.append(torch.autograd.grad(loss, list(p.values())))
    assert _rel(outs[1], outs[0]) < 1e-6
    for a, b in zip(*grads):
        assert _rel(a, b) < 1e-5


def test_constructor_checks():
    ei, n = _power_law()
    X = np.zeros((n, D))
    g = TC.sparse_from_edge_index(ei, n, normalize=None, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        TM.SparseGAT(D, 7, C, 2, X, g, heads=2, device="cpu")
    with pytest.raises(ValueError, match="graph is on"):
        TM.SparseGCN(D, HID, C, 2, X, g, device="meta")
    fast = TC.FastAggGraph(g)
    assert TM.SparseGCN(D, HID, C, 2, X, fast, device="cpu").graph is fast
