"""Port parity for the Full and Diag Laplace flavours and the parametric
API: laplace/flavors.py (FullLaplace, DiagLaplace, KronLaplace's state),
laplace/base.py (``optimize_prior_precision`` by marglik and grid search,
``_validate``, ``predictive_samples``, ``state_dict`` /
``load_state_dict``), laplace/dispatch.py, ops/linalg.py
(``invsqrt_precision``, ``normal_samples``) and utils/metrics.py, torch
against JAX in float64 on the CPU.

Fits, log marglik, posteriors and predictives are composed float64 math,
held at 1e-9 relative (factorisations and summation order differ in the
last bits); 10 marglik-tuning steps at 1e-8. The standard normals of the
samplers are JAX's, carried into the port by replacing its private draw
functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.ops import linalg as JL
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_tpu.utils import metrics as JMET
from laplace_gnn_tpu.utils.data import ArrayLoader as JLoader
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.laplace import dispatch as TD
from laplace_gnn_torch.ops import linalg as TL
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils import metrics as TMET
from laplace_gnn_torch.utils.data import ArrayLoader
from laplace_gnn_torch.utils.pytree import params_from_numpy

RTOL = 1e-9
N, F, HID, C = 30, 7, 6, 3
TRAIN, TEST, VAL = np.arange(0, 16), np.arange(16, 24), np.arange(24, 30)

MODELS = {
    "gcn": lambda mod, **kw: mod.GCN(F, HID, C, 2, *_graph()[:2],
                                     dropout_p=0.0, **kw),
    "stegcn_fused": lambda mod, **kw: mod.STEGCN(F, HID, C, 2, *_graph()[:2],
                                                 dropout_p=0.0, fused=True,
                                                 symmetric=True, **kw),
    "stegcn_res": lambda mod, **kw: mod.STEGCN(F, HID, C, 2, *_graph()[:2],
                                               dropout_p=0.0, res=True,
                                               norm="layer", **kw),
}


def _graph(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    a = (rng.random((N, N)) < 0.15).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    return X, adj, rng.integers(0, C, N)


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _fits(name, structure, **kw):
    jm = MODELS[name](JM)
    tm = MODELS[name](TM, device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    if "stegcn" in name:
        rng = np.random.default_rng(5)
        jp["adj"] = np.where(rng.random((N, N)) < 0.2, 0.5,
                             jp["adj"] * 0.6 + 0.3)
    y = _graph()[2]
    jla = JT.fit_laplace(jm, jax.tree_util.tree_map(jnp.asarray, jp), TRAIN,
                         y[TRAIN], hessian_structure=structure, **kw)
    tla = TT.fit_laplace(tm, params_from_numpy(jp, device="cpu"), TRAIN,
                         y[TRAIN], hessian_structure=structure, **kw)
    return jla, tla, y


CASES = [(n, s) for n in MODELS for s in ("full", "diag")]


@pytest.mark.parametrize("name,structure", CASES)
def test_fit_posterior_and_log_marglik_match_jax(name, structure):
    jla, tla, _ = _fits(name, structure, prior_precision=0.8)
    assert type(tla).__name__ == type(jla).__name__
    _close(tla.H, jla.H)
    _close(tla.mean, jla.mean)
    _close(tla.loss, jla.loss)
    assert tla.n_data == jla.n_data and tla.n_outputs == jla.n_outputs
    _close(tla.posterior_precision, jla.posterior_precision)
    _close(tla.posterior_scale, jla.posterior_scale)
    if structure == "full":
        _close(tla.posterior_covariance, jla.posterior_covariance)
    else:
        _close(tla.posterior_variance, jla.posterior_variance)
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    pp = np.linspace(0.5, 2.0, tla.n_layers)
    _close(tla.log_marginal_likelihood(torch.as_tensor(pp)),
           jla.log_marginal_likelihood(jnp.asarray(pp)))
    # the cached scale follows the new prior, as JAX's does
    _close(tla.posterior_scale, jla.posterior_scale)
    _close(tla.log_prob(tla.mean * 0.9), jla.log_prob(jla.mean * 0.9))
    Js, _ = tla.backend.jacobians(torch.as_tensor(TEST))
    jJs, _ = jla.backend.jacobians(jnp.asarray(TEST))
    _close(tla.functional_variance(Js), jla.functional_variance(jJs))
    _close(tla.functional_covariance(Js), jla.functional_covariance(jJs))
    for link in ("probit", "bridge"):
        _close(tla(torch.as_tensor(TEST), link_approx=link),
               jla(jnp.asarray(TEST), link_approx=link))


def test_invsqrt_precision_matches_jax():
    A = np.random.default_rng(1).standard_normal((9, 9))
    M = A @ A.T + np.eye(9)
    S = TL.invsqrt_precision(torch.as_tensor(M))
    _close(S, JL.invsqrt_precision(jnp.asarray(M)))
    _close(S @ S.T, np.linalg.inv(M))


@pytest.mark.parametrize("structure", ["full", "diag", "kron"])
def test_sample_and_predictive_samples_with_jax_normals(structure,
                                                        monkeypatch):
    jla, tla, _ = _fits("stegcn_fused", structure)
    key = jax.random.PRNGKey(3)
    n = 5

    def normals(shape, generator, dtype, device):
        return torch.tensor(np.asarray(jax.random.normal(key, shape,
                                                         jnp.float64)))

    monkeypatch.setattr(TL, "_standard_normals", normals)
    _close(tla.sample(n), jla.sample(n, key=key))
    for kw in ({}, {"diagonal_output": True}):
        _close(tla.predictive_samples(torch.as_tensor(TEST), n_samples=n,
                                      **kw),
               jla.predictive_samples(jnp.asarray(TEST), n_samples=n,
                                      key=key, **kw))
    _close(tla.predictive_samples(torch.as_tensor(TEST), pred_type="nn",
                                  n_samples=n),
           jla.predictive_samples(jnp.asarray(TEST), pred_type="nn",
                                  n_samples=n, key=key))
    with pytest.raises(ValueError, match="glm and nn"):
        tla.predictive_samples(torch.as_tensor(TEST), pred_type="gp")
    # the port's own draws: softmax rows, (n, B, C)
    s = tla.predictive_samples(torch.as_tensor(TEST), n_samples=3,
                               generator=torch.Generator().manual_seed(0))
    assert s.shape == (3, len(TEST), C)
    np.testing.assert_allclose(s.sum(-1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("prior_structure", ["scalar", "layerwise", "diag"])
@pytest.mark.parametrize("structure", ["full", "diag", "kron"])
def test_optimize_prior_precision_marglik_matches_jax(structure,
                                                      prior_structure):
    """10 Adam steps on the log prior precision: torch.optim.Adam against
    optax's adam, through each flavour's log marglik. Kron takes no
    diagonal prior and raises where JAX raises."""
    jla, tla, _ = _fits("gcn", structure)
    kw = dict(method="marglik", n_steps=10, lr=0.1, init_prior_prec=0.5,
              prior_structure=prior_structure)
    if structure == "kron" and prior_structure == "diag":
        with pytest.raises(ValueError):
            jla.optimize_prior_precision(**kw)
        with pytest.raises(ValueError):
            tla.optimize_prior_precision(**kw)
        return
    jla.optimize_prior_precision(**kw)
    tla.optimize_prior_precision(**kw)
    assert tla.prior_precision.shape == jla.prior_precision.shape
    _close(tla.prior_precision, jla.prior_precision, rtol=1e-8)
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood(),
           rtol=1e-8)
    # the fitted state is left as it was by the shallow-copied marglik
    assert tla.H is not None and tla._prior_precision.requires_grad is False


@pytest.mark.parametrize("structure", ["full", "diag", "kron"])
def test_gridsearch_picks_the_same_prior(structure):
    jla, tla, y = _fits("stegcn_fused", structure)
    kw = dict(method="gridsearch", grid_size=9, log_prior_prec_min=-2.0,
              log_prior_prec_max=2.0)
    jla.optimize_prior_precision(val_loader=JLoader(
        jnp.asarray(VAL), jnp.asarray(y[VAL]), batch_size=4), **kw)
    tla.optimize_prior_precision(val_loader=ArrayLoader(
        VAL, y[VAL], batch_size=4, device="cpu"), **kw)
    _close(tla.prior_precision, jla.prior_precision, rtol=1e-12)
    with pytest.raises(ValueError, match="validation"):
        tla.optimize_prior_precision(method="gridsearch")
    with pytest.raises(ValueError, match="marglik and gridsearch"):
        tla.optimize_prior_precision(method="nope")


def test_gridsearch_scores_a_failed_factorisation_inf():
    """A prior whose posterior precision is not positive definite makes
    the Cholesky fail: that grid value scores inf and the search goes on
    (only ``torch.linalg.LinAlgError`` is caught)."""
    _, tla, y = _fits("gcn", "full")
    loader = ArrayLoader(VAL, y[VAL], device="cpu")
    tla.H = tla.H - 50.0 * torch.eye(tla.n_params, dtype=tla.H.dtype)
    grid = torch.tensor([1e-3, 1e3], dtype=torch.float64)
    best = tla._gridsearch(None, grid, loader, "glm", "probit", 10)
    assert float(best) == 1e3
    tla.prior_precision = 1e-3
    with pytest.raises(torch.linalg.LinAlgError):
        tla._validate(loader, TMET.nll_loss, "glm", "probit", 10)


@pytest.mark.parametrize("structure", ["full", "diag", "kron"])
def test_state_dict_round_trip_and_checks(structure):
    jla, tla, _ = _fits("stegcn_fused", structure, prior_precision=0.6)
    state = tla.state_dict()
    jstate = jla.state_dict()
    assert state.keys() == jstate.keys()
    for k in ("mean", "loss", "prior_precision", "sigma_noise"):
        _close(state[k], jstate[k])
    for k in ("n_data", "n_outputs", "likelihood", "temperature",
              "cls_name"):
        assert state[k] == jstate[k], k
    _close(torch.cat([t.reshape(-1) for t in jax.tree_util.tree_leaves(
               state["H"])]),
           np.concatenate([np.ravel(t) for t in jax.tree_util.tree_leaves(
               jstate["H"])]))
    model = tla.model
    fresh = TD.Laplace(model, tla.params, "classification", "all",
                       structure)
    fresh.load_state_dict(state)
    assert torch.equal(fresh.log_marginal_likelihood(),
                       tla.log_marginal_likelihood())
    assert torch.equal(fresh(torch.as_tensor(TEST)), tla(torch.as_tensor(
        TEST)))
    other = "diag" if structure != "diag" else "full"
    with pytest.raises(ValueError, match="wrong Laplace type"):
        TD.Laplace(model, tla.params, "classification", "all",
                   other).load_state_dict(state)
    with pytest.raises(ValueError, match="wrong likelihood"):
        TD.Laplace(model, tla.params, "regression", "all",
                   structure).load_state_dict(state)
    unfitted = TD.Laplace(model, tla.params, "classification", "all",
                          structure)
    if structure == "kron":     # Full and Diag start from a zero H, as in JAX
        with pytest.raises(AttributeError, match="fit"):
            unfitted.state_dict()


def test_metrics_helpers_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((20, 3)), rng.standard_normal((20, 3))
    assert TMET.mse_loss(a, b) == JMET.mse_loss(a, b)
    logits = rng.standard_normal((40, 4))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y = rng.integers(0, 4, 40)
    y[3] = -100
    tm, jm = TMET.RunningNLLMetric(), JMET.RunningNLLMetric()
    for sl in (slice(0, 15), slice(15, 40)):
        assert tm(probs[sl], y[sl]) == jm(probs[sl], y[sl])
    tm.reset()
    assert tm.compute() == 0.0
    jla, tla, yy = _fits("gcn", "diag")
    loader = ArrayLoader(VAL, yy[VAL], batch_size=4, device="cpu")
    jloader = JLoader(jnp.asarray(VAL), jnp.asarray(yy[VAL]), batch_size=4)
    _close(TMET.validate(tla, loader, TMET.nll_loss),
           JMET.validate(jla, jloader, JMET.nll_loss))
    for pp in (0.3, np.linspace(0.5, 1.0, tla.n_layers)):
        _close(TMET.expand_prior_precision(pp, tla),
               JMET.expand_prior_precision(jnp.asarray(pp), jla))
    for structure in ("scalar", "layerwise", "diag"):
        _close(TMET.fix_prior_prec_structure(0.7, structure, 4, 9,
                                             device="cpu"),
               JMET.fix_prior_prec_structure(0.7, structure, 4, 9))
    with pytest.raises(ValueError, match="Invalid prior structure"):
        TMET.fix_prior_prec_structure(0.7, "block", 4, 9, device="cpu")


def test_dispatch_keys():
    _, tla, _ = _fits("gcn", "diag")
    model, params = tla.model, tla.params
    assert set(TD.PORTED) == {
        ("all", "kron"), ("all", "full"), ("all", "diag"), ("all", "gp"),
        ("all", "lowrank"), ("last_layer", "kron"), ("last_layer", "full"),
        ("last_layer", "diag"), ("last_layer", "gp"),
        ("subnetwork", "full"), ("subnetwork", "diag")}
    extra = {"gp": {"n_subset": 4}}
    for key, cls in TD.PORTED.items():
        kw = dict(extra.get(key[1], {}))
        if key[0] == "subnetwork":
            kw["subnetwork_indices"] = [0, 3]
        assert type(TD.Laplace(model, params, "classification", *key,
                               **kw)) is cls
    assert type(TD.Laplace(model, params, "classification")) is \
        TD.PORTED[("last_layer", "kron")]
    assert type(TD.Laplace(model, params, "classification", "all",
                           "lowrank")) is TD.PORTED[("all", "lowrank")]
    assert TD.WAITING == {}
    with pytest.raises(ValueError, match="Subnetwork"):
        TD.Laplace(model, params, "classification", "subnetwork", "kron")
