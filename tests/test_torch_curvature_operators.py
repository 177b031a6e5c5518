"""Port parity for the matrix-free curvature operators: curvature/base.py,
curvature/operators.py, curvature/oracles.py,
curvature/activation_hessian.py and the pytree helpers they use
(utils/pytree.py), torch against JAX in float64 on the CPU.

Everything is composed float64 math, held at 1e-10 relative. The models
are the JAX tests' 2-layer MLP (D 3, H 4, C 2, two batches of 3) and the
STE-GCN graph of ``test_torch_marglik.py::_setup``. The MC Fisher's labels
are JAX's, carried into the port by replacing its private draw function
``operators._mc_labels``. Forward-mode products raise on the fused
STE-GCN in both packages (JAX: ``TypeError``, the port:
``NotImplementedError``); the reverse-mode ones run through the fused
aggregation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import curvature as JC
from laplace_gnn_tpu import nn as JNN
from laplace_gnn_tpu.curvature import losses as JLS
from laplace_gnn_tpu.curvature import oracles as JO
from laplace_gnn_tpu.utils import pytree as JP
from laplace_gnn_torch import curvature as TC
from laplace_gnn_torch import nn as TNN
from laplace_gnn_torch.curvature import base as TB
from laplace_gnn_torch.curvature import operators as TO
from laplace_gnn_torch.curvature import oracles as TOR
from laplace_gnn_torch.curvature.kfac import _fold_seed
from laplace_gnn_torch.utils import pytree as TP
from laplace_gnn_torch.utils.pytree import params_from_numpy
from test_torch_marglik import _setup

RTOL = 1e-10
M, D, H, C = 6, 3, 4, 2
LIKELIHOODS = ["classification", "regression"]


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _mlp(likelihood, seed=0):
    """(JAX model_fn, params, data), (the port's), as the JAX tests'
    ``make_setup``."""
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    jm = JNN.MLP([D, H, C], act="tanh")
    jp = jm.init(k1)
    X = jax.random.normal(k2, (M, D))
    y = (jax.random.randint(k3, (M,), 0, C) if likelihood == "classification"
         else jax.random.normal(k3, (M, C)))
    jdata = [(X[:3], y[:3]), (X[3:], y[3:])]
    tm = TNN.MLP([D, H, C], act="tanh", device="cpu", dtype=torch.float64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    tdata = [(_t(a), _t(b)) for a, b in jdata]
    return ((lambda w, X: jm.apply(w, X)), jp, jdata), \
        ((lambda w, X: tm.apply(w, X)), tp, tdata)


def _gnn(fused, likelihood="classification"):
    """The posterior model functions of the STE-GCN of
    ``test_torch_marglik.py::_setup`` (adjacency frozen), and two batches
    of training nodes."""
    jm, tm, jp, y = _setup(fused)
    jb = JC.GGNBackend(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                       likelihood)
    tb = TC.GGNBackend(tm, params_from_numpy(jp, device="cpu"), likelihood)
    idx = [np.arange(0, 10), np.arange(10, 20)]
    jdata = [(jnp.asarray(i), jnp.asarray(y[i])) for i in idx]
    tdata = [(torch.as_tensor(i), torch.as_tensor(y[i])) for i in idx]
    return (jb.model_fn, jb.w, jdata), (tb.model_fn, tb.w, tdata)


# -- pytree helpers ----------------------------------------------------------

def test_pytree_helpers_match_jax():
    (_, jp, _), (_, tp, _) = _mlp("classification")
    rng = np.random.default_rng(0)
    jvec = rng.standard_normal(TP.tree_size(tp))
    jtree = JP.tree_unflattener(jp)(jnp.asarray(jvec))
    ttree = TP.tree_unflattener(tp)(_t(jvec))
    assert set(ttree) == set(tp)
    _close(TP.tree_vector(ttree), JP.tree_vector(jtree), rtol=0, atol=0)
    jvec2 = rng.standard_normal(jvec.shape)
    jtree2 = JP.tree_unflattener(jp)(jnp.asarray(jvec2))
    ttree2 = TP.tree_unflattener(tp)(_t(jvec2))
    _close(TP.tree_dot(ttree, ttree2), JP.tree_dot(jtree, jtree2))
    _close(TP.tree_vector(TP.tree_add(ttree, ttree2, alpha=-0.3)),
           JP.tree_vector(JP.tree_add(jtree, jtree2, alpha=-0.3)))
    _close(TP.tree_vector(TP.tree_scale(ttree, 1.7)),
           JP.tree_vector(JP.tree_scale(jtree, 1.7)))
    assert float(TP.tree_vector(TP.tree_zeros_like(ttree)).abs().sum()) == 0
    assert TP.parameters_per_layer(tp) == JP.parameters_per_layer(jp)
    draws = TP.tree_random_normal(torch.Generator().manual_seed(3), tp)
    jdraws = JP.tree_random_normal(jax.random.PRNGKey(3), jp)
    assert {k: tuple(v.shape) for k, v in draws.items()} == \
        {k: tuple(v.shape) for k, v in TP.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jdraws), device="cpu").items()}
    assert all(v.dtype == torch.float64 for v in draws.values())


# -- operators on the MLP ----------------------------------------------------

OPS = {"hessian": (TC.HessianOperator, JC.HessianOperator),
       "ggn": (TC.GGNOperator, JC.GGNOperator),
       "ef": (TC.EFOperator, JC.EFOperator)}
ORACLES = {"hessian": (TOR.functorch_hessian, JO.functorch_hessian),
           "ggn": (TOR.functorch_ggn, JO.functorch_ggn),
           "ef": (TOR.functorch_ef, JO.functorch_ef)}


@pytest.mark.parametrize("kind", list(OPS))
@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_curvature_operator_matches_jax_and_oracle(kind, likelihood):
    (jf, jp, jdata), (tf, tp, tdata) = _mlp(likelihood)
    top = OPS[kind][0](tf, likelihood, tp, tdata)
    jop = OPS[kind][1](jf, likelihood, jp, jdata)
    assert top.shape == jop.shape and top.dtype == torch.float64
    dense = top.to_dense()
    _close(dense, jop.to_dense())
    oracle = ORACLES[kind][0](tf, likelihood, tp, tdata)
    _close(oracle, ORACLES[kind][1](jf, likelihood, jp, jdata))
    _close(dense, oracle.detach().numpy())
    v = np.random.default_rng(1).standard_normal(top.shape[1])
    _close(top.matvec(_t(v)), jop.matvec(jnp.asarray(v)))
    _close(top @ _t(v), jop @ jnp.asarray(v))
    _close(top.trace_exact(), jop.trace_exact())
    top.check_deterministic()


def test_jacobian_oracles_match_jax():
    (jf, jp, jdata), (tf, tp, tdata) = _mlp("regression")
    X = tdata[0][0]
    _close(TOR.functorch_jacobian(tf, tp, X),
           JO.functorch_jacobian(jf, jp, jdata[0][0]))
    _close(TOR.jacobians_naive(tf, tp, X),
           JO.jacobians_naive(jf, jp, jdata[0][0]))


def _use_jax_mc_labels(monkeypatch, seed, n_batches, mc_samples):
    """Map each (batch, sample) seed of the port to JAX's folded key."""
    keys = {}
    for b in range(n_batches):
        for m in range(mc_samples):
            keys[_fold_seed(_fold_seed(seed, b), m)] = jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed), b), m)

    def labels(s, likelihood, f):
        return _t(JLS.sample_labels(keys[s], likelihood,
                                    jnp.asarray(f.detach().numpy())))

    monkeypatch.setattr(TO, "_mc_labels", labels)


@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_fisher_mc_operator_with_jax_labels(likelihood, monkeypatch):
    (jf, jp, jdata), (tf, tp, tdata) = _mlp(likelihood)
    _use_jax_mc_labels(monkeypatch, 11, len(tdata), 3)
    top = TC.FisherMCOperator(tf, likelihood, tp, tdata, mc_samples=3,
                              seed=11)
    jop = JC.FisherMCOperator(jf, likelihood, jp, jdata, mc_samples=3,
                              seed=11)
    _close(top.to_dense(), jop.to_dense())


def test_fisher_mc_own_draws_converge_to_ggn():
    """The port's own label draws: many samples approach the GGN, as the
    JAX test holds JAX's."""
    (_, _, _), (tf, tp, tdata) = _mlp("classification")
    mc = TC.FisherMCOperator(tf, "classification", tp, tdata,
                             mc_samples=2000).to_dense()
    ggn = TOR.functorch_ggn(tf, "classification", tp, tdata)
    np.testing.assert_allclose(mc.numpy(), ggn.detach().numpy(), atol=0.15,
                               rtol=0.5)


def test_jacobian_operators_match_jax():
    (jf, jp, jdata), (tf, tp, tdata) = _mlp("regression")
    J = TC.JacobianOperator(tf, tp, tdata)
    jJ = JC.JacobianOperator(jf, jp, jdata)
    assert J.shape == jJ.shape == (M * C, TP.tree_size(tp))
    rng = np.random.default_rng(2)
    v, u = rng.standard_normal(J.shape[1]), rng.standard_normal(J.shape[0])
    _close(J.matvec(_t(v)), jJ.matvec(jnp.asarray(v)))
    _close(J.rmatvec(_t(u)), jJ.rmatvec(jnp.asarray(u)))
    dense = torch.cat([TOR.functorch_jacobian(tf, tp, X).reshape(
        -1, J.shape[1]) for X, _ in tdata])
    _close(J.matvec(_t(v)), (dense @ _t(v)).detach().numpy())
    JT = TC.TransposedJacobianOperator(tf, tp, tdata)
    jJT = JC.TransposedJacobianOperator(jf, jp, jdata)
    assert JT.shape == jJT.shape
    _close(JT.matvec(_t(u)), jJT.matvec(jnp.asarray(u)))
    _close(JT.rmatvec(_t(v)), jJT.rmatvec(jnp.asarray(v)))


# -- the backends against the oracles ----------------------------------------

@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_backends_match_the_oracles(likelihood):
    """The backends' Jacobians, GGN, EF and Hessian against the dense
    oracles, as the JAX tests hold JAX's (the GGN backend drops the 2 of
    the sum-MSE Hessian, the oracle keeps it)."""
    (_, _, _), (tf, tp, tdata) = _mlp(likelihood)
    tm = TNN.MLP([D, H, C], act="tanh", device="cpu", dtype=torch.float64)
    X = torch.cat([d[0] for d in tdata])
    y = torch.cat([d[1] for d in tdata])
    ggn = TC.GGNBackend(tm, tp, likelihood)
    Js, f = ggn.jacobians(X)
    _close(Js, TOR.functorch_jacobian(tf, tp, X).detach().numpy())
    _close(f, tf(tp, X).detach().numpy())
    scale = 0.5 if likelihood == "regression" else 1.0
    _, Hb = ggn.full(X, y)
    _close(Hb, scale * TOR.functorch_ggn(tf, likelihood, tp,
                                         tdata).detach().numpy())
    _close(ggn.diag(X, y)[1], np.diag(Hb.detach().numpy()))
    _, Hef = TC.EFBackend(tm, tp, likelihood).full(X, y)
    _close(Hef, scale * TOR.functorch_ef(tf, likelihood, tp,
                                         tdata).detach().numpy())
    _, Hh = TC.HessianBackend(tm, tp, likelihood).full(X, y)
    _close(Hh, scale * TOR.functorch_hessian(tf, likelihood, tp,
                                             tdata).detach().numpy())


# -- operator algebra --------------------------------------------------------

class _TDense(TB.LinearOperator):
    def __init__(self, A):
        super().__init__(tuple(A.shape), A.dtype, device="cpu")
        self.A = A

    def matvec(self, v):
        return self.A @ v


class _JDense(JC.LinearOperator):
    def __init__(self, A):
        super().__init__(A.shape, A.dtype)
        self.A = A

    def matvec(self, v):
        return self.A @ v


def _psd(n=30):
    A = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, n)))
    return A @ A.T + 5 * np.eye(n)


def test_operator_algebra_matches_jax():
    A = _psd()
    t, j = _TDense(_t(A)), _JDense(jnp.asarray(A))
    rng = np.random.default_rng(3)
    v = rng.standard_normal(30)
    V = rng.standard_normal((30, 4))
    shift = rng.random(30) + 0.5
    pairs = [
        (TO.ScaledOperator(t, 2.5), JC.ScaledOperator(j, 2.5)),
        (TO.SumOperator(t, t, t), JC.SumOperator(j, j, j)),
        (TO.DiagShiftOperator(t, _t(shift)),
         JC.DiagShiftOperator(j, jnp.asarray(shift))),
        (TO.DiagShiftOperator(t, 0.7), JC.DiagShiftOperator(j, 0.7)),
    ]
    for top, jop in pairs:
        _close(top.matvec(_t(v)), jop.matvec(jnp.asarray(v)))
        _close(top.matmat(_t(V)), jop.matmat(jnp.asarray(V)))
        _close(top @ _t(V), jop @ jnp.asarray(V))
        _close(top.to_dense(), jop.to_dense())
    X = rng.standard_normal((5, 30))
    c = rng.random(5)
    _close(TO.OuterProductOperator(_t(X), _t(c)).to_dense(),
           JC.OuterProductOperator(jnp.asarray(X), jnp.asarray(c)).to_dense())
    _close(TO.OuterProductOperator(_t(X)).matvec(_t(v)),
           JC.OuterProductOperator(jnp.asarray(X)).matvec(jnp.asarray(v)))
    Qo = np.linalg.qr(X.T)[0].T                      # orthonormal rows
    P = TO.Projector(_t(Qo))
    _close(P.to_dense(), JC.Projector(jnp.asarray(Qo)).to_dense())
    _close(P.matvec(P.matvec(_t(v))), P.matvec(_t(v)).numpy())


def test_submatrix_and_set_submatrix_match_jax():
    A = _psd()
    sub = TO.SubmatrixOperator(_TDense(_t(A)), torch.arange(5),
                               torch.arange(5))
    jsub = JC.SubmatrixOperator(_JDense(jnp.asarray(A)), jnp.arange(5),
                                jnp.arange(5))
    v = np.random.default_rng(4).standard_normal(5)
    _close(sub.matvec(_t(v)), jsub.matvec(jnp.asarray(v)))
    _close(sub.matvec(_t(v)), A[:5, :5] @ v)
    sub.set_submatrix(np.arange(10, 20), np.arange(5, 10))
    jsub.set_submatrix(jnp.arange(10, 20), jnp.arange(5, 10))
    assert sub.shape == jsub.shape == (10, 5)
    _close(sub.matvec(_t(v)), jsub.matvec(jnp.asarray(v)))
    _close(sub.matmat(_t(np.eye(5))), A[10:20, 5:10])


def test_check_deterministic_raises_on_a_random_operator():
    class Noisy(TB.LinearOperator):
        def matvec(self, v):
            return v + torch.rand(v.shape, dtype=v.dtype)

    with pytest.raises(RuntimeError, match="not deterministic"):
        Noisy((4, 4), torch.float64, "cpu").check_deterministic()


def test_accumulate_over_batches_sums_dicts():
    data = [(1.0, 2.0), (3.0, 4.0)]
    out = TB.accumulate_over_batches(
        lambda X, y: {"a": torch.tensor(X * y)}, data)
    assert float(out["a"]) == 14.0


# -- operators on the STE-GCN ------------------------------------------------

@pytest.mark.parametrize("kind", list(OPS))
def test_gnn_operators_match_jax(kind):
    """The composed STE-GCN: one matvec of each operator, and the GGN's
    vmapped (jvp + vjp) matmat, against JAX."""
    (jf, jw, jdata), (tf, tw, tdata) = _gnn(fused=False)
    top = OPS[kind][0](tf, "classification", tw, tdata)
    jop = OPS[kind][1](jf, "classification", jw, jdata)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(top.shape[1])
    _close(top.matvec(_t(v)), jop.matvec(jnp.asarray(v)))
    if kind == "ggn":
        V = rng.standard_normal((top.shape[1], 3))
        _close(top.matmat(_t(V)), jop.matmat(jnp.asarray(V)))


def test_gcn_ggn_matmat_matches_jax():
    """vmap over jvp on the composed GCN (dropout off)."""
    from laplace_gnn_tpu import models as JM
    from laplace_gnn_torch import models as TM
    rng = np.random.default_rng(6)
    n, f = 20, 5
    X = rng.standard_normal((n, f))
    a = (rng.random((n, n)) < 0.2).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    y = rng.integers(0, 3, n)
    jm = JM.GCN(f, 4, 3, 2, X, adj, dropout_p=0.0)
    tm = TM.GCN(f, 4, 3, 2, X, adj, dropout_p=0.0, device="cpu",
                dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    jb = JC.GGNBackend(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                       "classification")
    tb = TC.GGNBackend(tm, params_from_numpy(jp, device="cpu"),
                       "classification")
    idx = np.arange(12)
    top = TC.GGNOperator(tb.model_fn, "classification", tb.w,
                         [(torch.as_tensor(idx), torch.as_tensor(y[idx]))])
    jop = JC.GGNOperator(jb.model_fn, "classification", jb.w,
                         [(jnp.asarray(idx), jnp.asarray(y[idx]))])
    V = rng.standard_normal((top.shape[1], 4))
    _close(top.matmat(_t(V)), jop.matmat(jnp.asarray(V)))


def test_fused_stegcn_forward_mode_raises_and_reverse_mode_runs():
    (jf, jw, jdata), (tf, tw, tdata) = _gnn(fused=True)
    v = np.random.default_rng(7).standard_normal(TP.tree_size(tw))
    with pytest.raises(TypeError):
        JC.GGNOperator(jf, "classification", jw, jdata).matvec(
            jnp.asarray(v))
    with pytest.raises(NotImplementedError):
        TC.GGNOperator(tf, "classification", tw, tdata).matvec(_t(v))
    with pytest.raises(NotImplementedError):
        TC.JacobianOperator(tf, tw, tdata).matvec(_t(v))
    JT = TC.TransposedJacobianOperator(tf, tw, tdata)
    jJT = JC.TransposedJacobianOperator(jf, jw, jdata)
    u = np.random.default_rng(8).standard_normal(JT.shape[1])
    _close(JT.matvec(_t(u)), jJT.matvec(jnp.asarray(u)))


# -- activation Hessian ------------------------------------------------------

def test_activation_hessian_matches_jax_and_oracle():
    jm = JNN.MLP([3, 4, 2], act="tanh")
    jp = jm.init(jax.random.PRNGKey(0))
    X = jax.random.normal(jax.random.PRNGKey(1), (5, 3))
    y = jax.random.randint(jax.random.PRNGKey(2), (5,), 0, 2)
    tm = TNN.MLP([3, 4, 2], act="tanh", device="cpu", dtype=torch.float64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    for site, size in (("layers.0", 20), ("layers.1", 10)):
        op = TC.ActivationHessianOperator(tm, tp, "classification", site,
                                          _t(X), _t(y))
        jop = JC.ActivationHessianOperator(jm, jp, "classification", site,
                                           X, y)
        assert op.shape == jop.shape == (size, size)
        dense = op.to_dense()
        _close(dense, jop.to_dense())

        def loss_of_eps(eps):
            taps = TNN.TapCollector({site: eps.reshape(5, size // 5)})
            return TC.cross_entropy_sum(tm.apply(tp, _t(X), taps=taps),
                                        _t(y))

        _close(dense, torch.func.hessian(loss_of_eps)(
            torch.zeros(size, dtype=torch.float64)).numpy())
    from laplace_gnn_torch.curvature.activation_hessian import \
        activation_shapes
    assert activation_shapes(tm, tp, _t(X)) == {
        "layers.0": (5, 4), "layers.1": (5, 2)}
    with pytest.raises(ValueError, match="Unknown activation site"):
        TC.ActivationHessianOperator(tm, tp, "classification", "nope",
                                     _t(X), _t(y))


def test_activation_hessian_on_stegcn_matches_jax():
    jm, tm, jp, y = _setup(False)
    idx = np.arange(20)
    site = "convs.1"
    op = TC.ActivationHessianOperator(
        tm, params_from_numpy(jp, device="cpu"), "classification", site,
        torch.as_tensor(idx), torch.as_tensor(y[idx]))
    jop = JC.ActivationHessianOperator(
        jm, jax.tree_util.tree_map(jnp.asarray, jp), "classification", site,
        jnp.asarray(idx), jnp.asarray(y[idx]))
    assert op.shape == jop.shape
    v = np.random.default_rng(9).standard_normal(op.shape[1])
    _close(op.matvec(_t(v)), jop.matvec(jnp.asarray(v)))
