"""Port parity for LowRank Laplace (laplace/flavors.py::LowRankLaplace and
its ``("all", "lowrank")`` dispatch key), torch against JAX in float64 on
the CPU.

The fits run Lanczos on the matrix-free GGN operator of the composed
STE-GCN of ``test_torch_marglik.py::_setup`` (rank 8 of P = 131) and of
the JAX tests' MLP; JAX's Lanczos start vector enters the port through
``spectrum._start_vector`` and its sampler's normals through
``ops/linalg.py::_standard_normals``. The eigenpairs are held at 1e-8
(eigenvectors up to sign); the log marglik, log det, covariance, probit
predictive, tuned prior and samples at 1e-8. On the fused STE-GCN the fit
raises in both packages (forward mode through the fused aggregation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import nn as JNN
from laplace_gnn_tpu.laplace import dispatch as JD
from laplace_gnn_tpu.laplace import flavors as JF
from laplace_gnn_tpu.utils.data import ArrayLoader as JLoader
from laplace_gnn_torch import nn as TNN
from laplace_gnn_torch.curvature import spectrum as TS
from laplace_gnn_torch.laplace import dispatch as TD
from laplace_gnn_torch.laplace import flavors as TF
from laplace_gnn_torch.ops import linalg as TL
from laplace_gnn_torch.utils.data import ArrayLoader
from laplace_gnn_torch.utils.pytree import params_from_numpy
from test_torch_marglik import _setup

RTOL = 1e-8
TRAIN, TEST = np.arange(0, 20), np.arange(20, 32)


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _jax_start(monkeypatch):
    """The port's Lanczos start vector is JAX's: the first key a fresh JAX
    Laplace object splits off."""
    key = jax.random.split(jax.random.PRNGKey(0))[1]

    def start(seed, P, dtype, device):
        return torch.as_tensor(np.array(jax.random.normal(key, (P,),
                                                          jnp.float64)))

    monkeypatch.setattr(TS, "_start_vector", start)


def _stegcn_fits(monkeypatch, fused=False, rank=8, **kw):
    jm, tm, jp, y = _setup(fused)
    jla = JF.LowRankLaplace(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                            "classification", rank=rank, **kw)
    tla = TF.LowRankLaplace(tm, params_from_numpy(jp, device="cpu"),
                            "classification", rank=rank, **kw)
    _jax_start(monkeypatch)
    jla.fit(JLoader(jnp.asarray(TRAIN), jnp.asarray(y[TRAIN])))
    tla.fit(ArrayLoader(TRAIN, y[TRAIN], device="cpu"))
    return jla, tla


def _mlp(likelihood, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    jm = JNN.MLP([3, 4, 2], act="tanh")
    jp = jm.init(keys[0])
    X = jax.random.normal(keys[1], (10, 3))
    y = (jax.random.randint(keys[2], (10,), 0, 2)
         if likelihood == "classification"
         else jax.random.normal(keys[2], (10, 2)))
    tm = TNN.MLP([3, 4, 2], act="tanh", device="cpu", dtype=torch.float64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return (jm, jp, JLoader(X, y)), (tm, tp, ArrayLoader(
        np.asarray(X), np.asarray(y), device="cpu")), X


def _same_up_to_sign(t, j):
    t, j = t.detach().numpy(), np.asarray(j)
    signs = np.sign(np.sum(t * j, axis=0))
    np.testing.assert_allclose(t * signs, j, rtol=RTOL, atol=1e-10)


def test_lowrank_fit_and_posterior_match_jax(monkeypatch):
    jla, tla = _stegcn_fits(monkeypatch, prior_precision=0.7)
    assert tla.H[1].shape == (8,) and tla.V.shape == (tla.n_params, 8)
    _close(tla.H[1], jla.H[1])
    assert bool((tla.H[1][:-1] >= tla.H[1][1:]).all())      # descending
    _same_up_to_sign(tla.V, jla.V)
    _close(tla.mean, jla.mean)
    _close(tla.loss, jla.loss)
    assert tla.n_data == jla.n_data and tla.n_outputs == jla.n_outputs
    V, l, p0 = tla.posterior_precision
    jV, jl, jp0 = jla.posterior_precision
    _close(l, jl)
    _close(p0, jp0)
    _close(tla.posterior_covariance, jla.posterior_covariance)
    _close(tla.V @ tla.Kinv @ tla.V.T, jla.V @ jla.Kinv @ jla.V.T)
    _close(tla.log_det_posterior_precision, jla.log_det_posterior_precision)
    delta = np.random.default_rng(0).standard_normal(tla.n_params) * 0.1
    _close(tla.square_norm(tla.mean + torch.as_tensor(delta)),
           jla.square_norm(jla.mean + jnp.asarray(delta)))
    _close(tla.log_prob(tla.mean * 0.9), jla.log_prob(jla.mean * 0.9))


def test_lowrank_log_marglik_and_tuning_match_jax(monkeypatch):
    jla, tla = _stegcn_fits(monkeypatch)
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    pp = np.linspace(0.5, 2.0, tla.n_layers)
    _close(tla.log_marginal_likelihood(torch.as_tensor(pp)),
           jla.log_marginal_likelihood(jnp.asarray(pp)))
    for structure in ("scalar", "layerwise"):
        tla.optimize_prior_precision(method="marglik", n_steps=10,
                                     prior_structure=structure)
        jla.optimize_prior_precision(method="marglik", n_steps=10,
                                     prior_structure=structure)
        _close(tla.prior_precision, jla.prior_precision)
        _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())


def test_lowrank_predictive_matches_jax(monkeypatch):
    jla, tla = _stegcn_fits(monkeypatch, prior_precision=0.5)
    Js, _ = tla.backend.jacobians(torch.as_tensor(TEST))
    jJs, _ = jla.backend.jacobians(jnp.asarray(TEST))
    _close(tla.functional_variance(Js), jla.functional_variance(jJs))
    _close(tla.functional_covariance(Js), jla.functional_covariance(jJs))
    for link in ("probit", "bridge"):
        _close(tla(torch.as_tensor(TEST), link_approx=link),
               jla(jnp.asarray(TEST), link_approx=link))


def test_lowrank_samples_with_jax_normals(monkeypatch):
    jla, tla = _stegcn_fits(monkeypatch, prior_precision=0.5)
    key = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(key, (6, tla.n_params), jnp.float64))
    monkeypatch.setattr(TL, "_standard_normals",
                        lambda shape, g, dtype, device: torch.as_tensor(eps))
    _close(tla.sample(6), jla.sample(6, key=key))


def test_lowrank_state_dict_round_trip(monkeypatch):
    _, tla = _stegcn_fits(monkeypatch, prior_precision=0.5)
    sd = tla.state_dict()
    assert set(sd["H"]) == {"V", "l"}
    jm, tm, jp, y = _setup(False)
    fresh = TF.LowRankLaplace(tm, params_from_numpy(jp, device="cpu"),
                              "classification", rank=8)
    fresh.load_state_dict(sd)
    assert torch.equal(fresh.log_marginal_likelihood(),
                       tla.log_marginal_likelihood())
    assert torch.equal(fresh.posterior_covariance, tla.posterior_covariance)
    with pytest.raises(ValueError, match="does not support updating"):
        tla.fit(ArrayLoader(TRAIN, y[TRAIN], device="cpu"), override=False)
    with pytest.raises(AttributeError, match="fit"):
        fresh_unfitted = TF.LowRankLaplace(
            tm, params_from_numpy(jp, device="cpu"), "classification")
        fresh_unfitted.posterior_precision


@pytest.mark.parametrize("likelihood", ["classification", "regression"])
def test_lowrank_on_the_mlp_matches_jax(likelihood, monkeypatch):
    (jm, jp, jl), (tm, tp, tl), X = _mlp(likelihood)
    kw = {"sigma_noise": 0.6} if likelihood == "regression" else {}
    jla = JF.LowRankLaplace(jm, jp, likelihood, rank=5, **kw)
    tla = TF.LowRankLaplace(tm, tp, likelihood, rank=5, **kw)
    _jax_start(monkeypatch)
    jla.fit(jl)
    tla.fit(tl)
    assert tla.factor_correction() == jla.factor_correction()
    _close(tla.H[1], jla.H[1])
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    out, jout = tla(torch.as_tensor(np.asarray(X))), jla(X)
    if likelihood == "regression":
        _close(out[0], jout[0])
        _close(out[1], jout[1])
    else:
        _close(out, jout)


def test_full_rank_lowrank_log_det_equals_full_laplace(monkeypatch):
    """At rank P LowRank's log det is FullLaplace's (GGN), as the JAX test
    holds JAX's: in the port, and against JAX's LowRank."""
    (jm, jp, jl), (tm, tp, tl), _ = _mlp("classification")
    _jax_start(monkeypatch)
    P = 22
    tla = TF.LowRankLaplace(tm, tp, "classification", rank=P)
    tla.fit(tl)
    full = TF.FullLaplace(tm, tp, "classification")
    full.fit(tl)
    np.testing.assert_allclose(float(tla.log_det_posterior_precision),
                               float(full.log_det_posterior_precision),
                               rtol=1e-4)
    jla = JF.LowRankLaplace(jm, jp, "classification", rank=P)
    jla.fit(jl)
    _close(tla.log_det_posterior_precision, jla.log_det_posterior_precision)


def test_lowrank_raises_on_the_fused_stegcn(monkeypatch):
    """Forward mode through the fused aggregation: JAX's custom_vjp raises
    TypeError, the port's autograd Function NotImplementedError."""
    jm, tm, jp, y = _setup(True)
    jla = JF.LowRankLaplace(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                            "classification", rank=4)
    tla = TF.LowRankLaplace(tm, params_from_numpy(jp, device="cpu"),
                            "classification", rank=4)
    with pytest.raises(TypeError):
        jla.fit(JLoader(jnp.asarray(TRAIN), jnp.asarray(y[TRAIN])))
    with pytest.raises(NotImplementedError):
        tla.fit(ArrayLoader(TRAIN, y[TRAIN], device="cpu"))


def test_lowrank_dispatch_key():
    jm, tm, jp, _ = _setup(False)
    tla = TD.Laplace(tm, params_from_numpy(jp, device="cpu"),
                     "classification", "all", "lowrank", rank=3)
    jla = JD.Laplace(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                     "classification", "all", "lowrank", rank=3)
    assert type(tla) is TF.LowRankLaplace
    assert type(tla).__name__ == type(jla).__name__
    assert tla.rank == jla.rank == 3
    assert TD.WAITING == {}
