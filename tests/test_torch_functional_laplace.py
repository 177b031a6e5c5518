"""Port parity for the GP (functional) Laplace: laplace/functional.py
(FunctionalLaplace, ``("all", "gp")``, and FunctionalLLLaplace,
``("last_layer", "gp")``), torch against JAX in float64 on the CPU.

Held at 1e-10 relative: the subset draw, K_MM, Lambda, the scatter mean,
the Cholesky factor, log marglik and its gradient in the prior, the
marginal and joint predictive, with and without independent outputs, for
regression and classification on an MLP and on a GCN / fused STE-GCN;
the predictive samples with JAX's normals; the grid search and marglik
tuning of the prior; reward modeling. With ``n_subset = N`` the GP
predictive equals FullLaplace's (regression), as in the JAX tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu import nn as JNN
from laplace_gnn_tpu.laplace import dispatch as JD
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_tpu.utils.data import ArrayLoader as JLoader
from laplace_gnn_torch import models as TM
from laplace_gnn_torch import nn as TNN
from laplace_gnn_torch.laplace import dispatch as TD
from laplace_gnn_torch.laplace import functional as TF
from laplace_gnn_torch.ops import linalg as TL
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils.data import ArrayLoader
from laplace_gnn_torch.utils.pytree import params_from_numpy

RTOL = 1e-10
SIGMA = 0.1


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _data(likelihood, M=40, d=2, c=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (M, d))
    if likelihood == "regression":
        y = np.sin(X @ rng.standard_normal((d, c))) \
            + SIGMA * rng.standard_normal((M, c))
    else:
        y = rng.integers(0, c, M)
    return X, y


def _pair(likelihood, subset, M=40, d=2, c=2, n_subset=None, seed=0,
          **kw):
    X, y = _data(likelihood, M, d, c, seed)
    jm = JNN.MLP([d, 8, c], act="tanh")
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init(jax.random.PRNGKey(seed + 5)))
    tm = TNN.MLP([d, 8, c], act="tanh", device="cpu", dtype=torch.float64)
    if likelihood == "regression":
        kw = dict(sigma_noise=SIGMA, prior_precision=2.0, **kw)
    jla = JD.Laplace(jm, jax.tree_util.tree_map(jnp.asarray, jp), likelihood,
                     subset, "gp", n_subset=n_subset or M, **kw)
    tla = TD.Laplace(tm, params_from_numpy(jp, device="cpu"), likelihood,
                     subset, "gp", n_subset=n_subset or M, **kw)
    jla.fit(JLoader(jnp.asarray(X), jnp.asarray(y), batch_size=16))
    tla.fit(ArrayLoader(X, y, batch_size=16, device="cpu"))
    return jla, tla, X, y


def _same_fit(tla, jla):
    assert type(tla).__name__ == type(jla).__name__
    _close(tla._X_M, jla._X_M)
    _close(tla._J_M, jla._J_M)
    if tla.independent_outputs:
        for t, j in zip(tla.K_MM + tla.L + tla.Sigma_inv,
                        jla.K_MM + jla.L + jla.Sigma_inv):
            _close(t, j)
    else:
        for name in ("K_MM", "L", "Sigma_inv"):
            _close(getattr(tla, name), getattr(jla, name))
    _close(tla.mu, jla.mu)
    _close(tla.loss, jla.loss)
    _close(tla.log_det_ratio, jla.log_det_ratio)
    _close(tla.scatter, jla.scatter)
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())


@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("likelihood", ["regression", "classification"])
@pytest.mark.parametrize("subset", ["all", "last_layer"])
def test_gp_fit_marglik_and_predictive_match_jax(subset, likelihood,
                                                 independent):
    jla, tla, X, _ = _pair(likelihood, subset, n_subset=25,
                           independent_outputs=independent)
    _same_fit(tla, jla)
    Xt = np.random.default_rng(9).standard_normal((7, 2))
    jX, tX = jnp.asarray(Xt), torch.as_tensor(Xt)
    if likelihood == "regression":
        for joint in (False, True):
            for t, j in zip(tla(tX, joint=joint), jla(jX, joint=joint)):
                _close(t, j)
        _close(tla(tX, diagonal_output=True)[1],
               jla(jX, diagonal_output=True)[1])
    else:
        _close(tla(tX), jla(jX))
        Js, _ = tla._jacobians(tX)
        jJs, _ = jla._jacobians(jX)
        _close(tla.functional_covariance(Js), jla.functional_covariance(jJs))
    # d log marglik / d prior precision and sigma, as JAX differentiates it
    pp = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    sn = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    val = tla._pure_log_marglik(pp, sn)
    gp, gs = torch.autograd.grad(val, (pp, sn))
    jval, (jgp, jgs) = jax.value_and_grad(jla._pure_log_marglik, (0, 1))(
        jnp.asarray(1.7), jnp.asarray(0.3))
    _close(val, jval)
    _close(gp, jgp)
    _close(gs, jgs)
    # a new prior rebuilds the factor, as in JAX
    _close(tla.log_marginal_likelihood(prior_precision=0.4),
           jla.log_marginal_likelihood(prior_precision=0.4))
    _close(tla.Sigma_inv if not independent else tla.Sigma_inv[0],
           jla.Sigma_inv if not independent else jla.Sigma_inv[0])


def test_gp_equals_full_laplace_with_every_point():
    """n_subset = N: the GP predictive is FullLaplace's (regression), with
    and without independent outputs; the JAX tests' tolerances."""
    X, y = _data("regression", d=1, c=1)
    tm = TNN.MLP([1, 8, 1], act="tanh", device="cpu", dtype=torch.float64)
    tp = tm.params()
    loader = ArrayLoader(X, y, device="cpu")
    Xt = torch.linspace(-5, 5, 25, dtype=torch.float64).reshape(-1, 1)
    for subset in ("all", "last_layer"):
        full = TD.Laplace(tm, tp, "regression", subset, "full",
                          sigma_noise=SIGMA, prior_precision=2.0)
        full.fit(loader)
        mu, var = full(Xt)
        for independent in (True, False):
            gp = TD.Laplace(tm, tp, "regression", subset, "gp", n_subset=40,
                            sigma_noise=SIGMA, prior_precision=2.0,
                            independent_outputs=independent)
            gp.fit(loader)
            g_mu, g_var = gp(Xt)
            np.testing.assert_allclose(g_mu.numpy(), mu.numpy(), atol=1e-8)
            np.testing.assert_allclose(g_var.numpy(), var.numpy(),
                                       atol=1e-7)
            # the joint covariance's diagonal is the marginal variance
            _, cov = gp(Xt, joint=True)
            np.testing.assert_allclose(torch.diagonal(cov).numpy(),
                                       g_var.reshape(-1).numpy(), atol=1e-8)


@pytest.mark.parametrize("name", ["gcn", "stegcn_fused"])
def test_gp_on_gnns_matches_jax(name, monkeypatch):
    rng = np.random.default_rng(2)
    n, f, c = 20, 5, 3
    X = rng.standard_normal((n, f))
    a = (rng.random((n, n)) < 0.2).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, c, n)
    kw = dict(dropout_p=0.0)
    if name == "stegcn_fused":
        kw.update(fused=True, symmetric=True)
    cls = "GCN" if name == "gcn" else "STEGCN"
    jm = getattr(JM, cls)(f, 6, c, 2, X, adj, **kw)
    tm = getattr(TM, cls)(f, 6, c, 2, X, adj, device="cpu",
                          dtype=torch.float64, **kw)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tr, te = np.arange(12), np.arange(12, n)
    key = jax.random.PRNGKey(5)
    monkeypatch.setattr(TL, "_standard_normals",
                        lambda shape, g, dtype, device: torch.tensor(
                            np.asarray(jax.random.normal(key, shape,
                                                         jnp.float64))))
    for subset in ("all", "last_layer"):
        jla = JT.fit_laplace(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                             tr, y[tr], subset, "gp", n_subset=9)
        tla = TT.fit_laplace(tm, params_from_numpy(jp, device="cpu"), tr,
                             y[tr], subset, "gp", n_subset=9,
                             backend_kwargs={"jac_chunk_size": 4})
        _same_fit(tla, jla)
        _close(tla(torch.as_tensor(te)), jla(jnp.asarray(te)))
        _close(tla.predictive_samples(torch.as_tensor(te), n_samples=3),
               jla.predictive_samples(jnp.asarray(te), n_samples=3, key=key))


def test_gp_samples_tuning_and_checks(monkeypatch):
    jla, tla, X, y = _pair("classification", "all", n_subset=30)
    Xt = np.random.default_rng(4).standard_normal((6, 2))
    jX, tX = jnp.asarray(Xt), torch.as_tensor(Xt)
    key = jax.random.PRNGKey(11)
    monkeypatch.setattr(TL, "_standard_normals",
                        lambda shape, g, dtype, device: torch.tensor(
                            np.asarray(jax.random.normal(key, shape,
                                                         jnp.float64))))
    for kw in ({}, {"diagonal_output": True}):
        _close(tla.predictive_samples(tX, n_samples=5, **kw),
               jla.predictive_samples(jX, n_samples=5, key=key, **kw))
    _close(tla(tX, link_approx="mc", n_samples=5),
           jla(jX, link_approx="mc", n_samples=5, key=key))
    # the grid search scores each prior with the fit-time factor, then
    # rebuilds it, as JAX does
    grid = dict(method="gridsearch", grid_size=7, log_prior_prec_min=-2.0,
                log_prior_prec_max=2.0)
    jla.optimize_prior_precision(val_loader=JLoader(jnp.asarray(X[:12]),
                                                    jnp.asarray(y[:12])),
                                 **grid)
    tla.optimize_prior_precision(val_loader=ArrayLoader(X[:12], y[:12],
                                                        device="cpu"), **grid)
    _close(tla.prior_precision, jla.prior_precision)
    _close(tla.Sigma_inv, jla.Sigma_inv)
    with pytest.warns(UserWarning, match="discouraged"):
        tla.optimize_prior_precision(method="marglik", n_steps=5)
    with pytest.warns(UserWarning, match="discouraged"):
        jla.optimize_prior_precision(method="marglik", n_steps=5)
    _close(tla.prior_precision, jla.prior_precision, rtol=1e-8)
    with pytest.raises(ValueError, match="isotropic"):
        tla.optimize_prior_precision(prior_structure="layerwise")
    with pytest.raises(ValueError, match="gp"):
        tla.optimize_prior_precision(pred_type="glm")
    with pytest.raises(ValueError, match="gp"):
        tla(tX, pred_type="glm")
    with pytest.raises(ValueError, match="isotropic"):
        tla.prior_precision = torch.ones(tla.n_layers, dtype=torch.float64)
    tm, tp = tla.model, tla.params
    with pytest.raises(ValueError, match="isotropic"):
        TF.FunctionalLaplace(tm, tp, "classification", n_subset=4,
                             prior_precision=np.ones(3))
    with pytest.raises(ValueError, match="n_subset"):
        TF.FunctionalLaplace(tm, tp, "classification", n_subset=60).fit(
            ArrayLoader(X, y, device="cpu"))
    with pytest.raises(RuntimeError, match="not been fitted"):
        TF.FunctionalLaplace(tm, tp, "classification", n_subset=4)(tX)
    with pytest.raises(ValueError, match="sigma_noise"):
        tla.log_marginal_likelihood(sigma_noise=0.5)


class _RewardMLP:
    """(B, 2, d) preference pairs -> (B, 2) logits while fitting; (B, d) ->
    (B, 1) rewards at prediction (the JAX dict-input tests' model)."""

    @staticmethod
    def apply(apply, params, x, **kw):
        if x.ndim == 3:
            b, two, d = x.shape
            return apply(params, x.reshape(-1, d), **kw).reshape(b, two)
        return apply(params, x, **kw)


class _JReward(JNN.MLP):
    def apply(self, params, x, **kw):
        return _RewardMLP.apply(super().apply, params, x, **kw)


class _TReward(TNN.MLP):
    def apply(self, params, x, **kw):
        return _RewardMLP.apply(super().apply, params, x, **kw)


@pytest.mark.parametrize("subset", ["all", "last_layer"])
def test_gp_reward_modeling_matches_jax(subset):
    """Fit as classification on (B, 2) pairs, predict a (B, 1) reward's
    mean and variance as regression. Over the last layer the closed form
    cannot take the pairs (the head sees 2B rows for B outputs): JAX
    fails on a reshape, the port raises a ValueError."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((16, 2, 3))
    y = rng.integers(0, 2, 16)
    jm = _JReward([3, 5, 1], act="tanh")
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    tm = _TReward([3, 5, 1], act="tanh", device="cpu", dtype=torch.float64)
    jla = JD.Laplace(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                     "reward_modeling", subset, "gp", n_subset=10)
    tla = TD.Laplace(tm, params_from_numpy(jp, device="cpu"),
                     "reward_modeling", subset, "gp", n_subset=10)
    if subset == "last_layer":
        with pytest.raises(TypeError, match="reshape"):
            jla.fit(JLoader(jnp.asarray(X), jnp.asarray(y)))
        with pytest.raises(ValueError, match="one feature row"):
            tla.fit(ArrayLoader(X, y, device="cpu"))
        return
    jla.fit(JLoader(jnp.asarray(X), jnp.asarray(y)))
    tla.fit(ArrayLoader(X, y, device="cpu"))
    _same_fit(tla, jla)
    Xt = rng.standard_normal((4, 3))
    t_mu, t_var = tla(torch.as_tensor(Xt))
    j_mu, j_var = jla(jnp.asarray(Xt))
    assert t_mu.shape == (4, 1) and t_var.shape == (4, 1, 1)
    _close(t_mu, j_mu)
    _close(t_var, j_var)
    # while fitting, the pairs' classification predictive
    _close(tla(torch.as_tensor(X[:3]), fitting=True),
           jla(jnp.asarray(X[:3]), fitting=True))
