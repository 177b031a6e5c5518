"""Port parity for the post-hoc Kron Laplace evaluation: curvature/
interface.py::jacobians, laplace/{base,flavors,dispatch,predictive}.py,
training/marglik_gnn.py::{fit_laplace, mc_eval}, training/evaluate.py and
utils/metrics.py, torch against JAX in float64 on the CPU.

The JAX params cross over with ``params_from_numpy``. On the CPU the port's
kernels run their plain versions (``core`` inside STEGCN(fused=True), the
flash Function inside GAT), so every comparison is composed float64 math,
held at 1e-9 relative (eigendecompositions and summation order differ in
the last bits). Random draws differ between the packages, so the MC paths
get the same noise injected on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.laplace import predictive as JP
from laplace_gnn_tpu.training import evaluate as JE
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_tpu.utils import metrics as JMET
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.laplace import predictive as TP
from laplace_gnn_torch.laplace.dispatch import Laplace
from laplace_gnn_torch.training import evaluate as TE
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils import metrics as TMET
from laplace_gnn_torch.utils.data import ArrayLoader
from laplace_gnn_torch.utils.pytree import params_from_numpy

RTOL = 1e-9
N, F, HID, C = 30, 7, 8, 3
TRAIN, TEST = np.arange(0, 16), np.arange(16, 26)

MODELS = {
    "gcn": lambda mod, **kw: mod.GCN(F, HID, C, 2, *_graph()[:2],
                                     dropout_p=0.0, **kw),
    "stegcn": lambda mod, **kw: mod.STEGCN(F, HID, C, 2, *_graph()[:2],
                                           dropout_p=0.0, fused=False,
                                           symmetric=True, **kw),
    "stegcn_fused": lambda mod, **kw: mod.STEGCN(F, HID, C, 2, *_graph()[:2],
                                                 dropout_p=0.0, fused=True,
                                                 symmetric=True, **kw),
    "gat": lambda mod, **kw: mod.GAT(F, HID, C, 2, *_graph()[:2], heads=2,
                                     concat=False, dropout_p=0.0,
                                     attention_impl="flash", **kw),
}


def _graph(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    a = (rng.random((N, N)) < 0.15).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, C, N)
    return X, adj, y


def _pair(name):
    """(JAX model, port model, JAX params as numpy, port params)."""
    jm = MODELS[name](JM)
    tm = MODELS[name](TM, device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    if "stegcn" in name:        # a learned adjacency: 0.5 ties and soft values
        rng = np.random.default_rng(5)
        jp["adj"] = np.where(rng.random((N, N)) < 0.2, 0.5,
                             jp["adj"] * 0.6 + 0.3)
    return jm, tm, jp, params_from_numpy(jp, device="cpu")


def _fits(name, **kw):
    jm, tm, jp, tp = _pair(name)
    y = _graph()[2]
    jla = JT.fit_laplace(jm, jax.tree_util.tree_map(jnp.asarray, jp), TRAIN,
                         y[TRAIN], **kw)
    tla = TT.fit_laplace(tm, tp, TRAIN, y[TRAIN], **kw)
    return jla, tla, y


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(MODELS))
def test_fit_h_factors_and_log_marglik(name):
    jla, tla, _ = _fits(name, prior_precision=0.8)
    assert len(tla.H_facs.kfacs) == len(jla.H_facs.kfacs)
    for tg, jg in zip(tla.H_facs.kfacs, jla.H_facs.kfacs):
        assert [f.dim() for f in tg] == [np.ndim(f) for f in jg]
        for tf, jf in zip(tg, jg):
            _close(tf, jf)
    _close(tla.mean, jla.mean)
    assert tla.n_data == jla.n_data and tla.n_outputs == jla.n_outputs
    _close(tla.loss, jla.loss)
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    # per-layer prior and a changed one through the marglik call
    pp = np.linspace(0.5, 2.0, tla.n_layers)
    _close(tla.log_marginal_likelihood(torch.as_tensor(pp)),
           jla.log_marginal_likelihood(jnp.asarray(pp)))
    _close(tla.log_prob(tla.mean * 0.9), jla.log_prob(jla.mean * 0.9))
    _close(tla.scatter, jla.scatter)


@pytest.mark.parametrize("name", ["gcn", "stegcn_fused", "gat"])
def test_jacobians_and_functional_variance(name):
    jla, tla, _ = _fits(name)
    for chunk in (None, 3):
        tJ, tf = tla.backend.jacobians(torch.as_tensor(TEST), chunk_size=chunk)
        jJ, jf = jla.backend.jacobians(jnp.asarray(TEST), chunk_size=chunk)
        assert tJ.shape == (len(TEST), C, tla.n_params)
        _close(tJ, jJ)
        _close(tf, jf)
    _close(tla.functional_variance(tJ), jla.functional_variance(jJ))
    _close(tla.functional_covariance(tJ), jla.functional_covariance(jJ))


def test_jacobian_chunks_fold_into_one_core_call(monkeypatch):
    """With STEGCN(fused=True) the vmapped pullbacks reach ``core`` through
    its vmap rule: one call per aggregation for a whole chunk, its rows
    folded into the feature axis (on the card: one kernel launch)."""
    from laplace_gnn_torch.ops import fused_spmm
    _, tla, _ = _fits("stegcn_fused")
    widths = []
    plain = fused_spmm.core_reference

    def counted(adj, t, *args):
        widths.append(t.shape[1])
        return plain(adj, t, *args)

    monkeypatch.setattr(fused_spmm, "core_reference", counted)
    tla.backend.jacobians(torch.as_tensor(TEST), chunk_size=4)
    # the forward (2 layers), then 3 chunks (4 + 4 + 2 samples) x 2 layers
    assert len(widths) == 2 + 3 * 2
    assert widths[2:4] == [4 * C * C, 4 * C * HID]


@pytest.mark.parametrize("link", ["probit", "bridge", "bridge_norm"])
@pytest.mark.parametrize("name", ["stegcn", "stegcn_fused", "gat"])
def test_glm_link_probabilities(name, link):
    jla, tla, _ = _fits(name)
    p_t = tla(torch.as_tensor(TEST), link_approx=link)
    p_j = jla(jnp.asarray(TEST), link_approx=link)
    assert p_t.shape == (len(TEST), C)
    _close(p_t, p_j)
    _close(p_t.sum(-1), np.ones(len(TEST)))


def test_mc_predictive_with_injected_noise(monkeypatch):
    """The GLM MC link: the same standard normal draws on both sides."""
    jla, tla, _ = _fits("stegcn_fused")
    n_samples = 7
    eps = np.random.default_rng(8).standard_normal((C, n_samples))

    def j_normal(key, mean, var, n):
        scale = jnp.linalg.cholesky(var)
        return jnp.transpose(mean[..., None] + scale @ jnp.asarray(eps)[None],
                             (2, 0, 1))

    monkeypatch.setattr(JP, "normal_samples", j_normal)
    p_j = jla(jnp.asarray(TEST), link_approx="mc", n_samples=n_samples)
    f_mu, f_var = tla._glm_predictive_distribution(torch.as_tensor(TEST))
    p_t = TP.mc_predictive(f_mu, f_var, n_samples, eps=torch.as_tensor(eps))
    _close(p_t, p_j)
    # and the diagonal-covariance branch of the sampler
    d_t = TP.mc_predictive(f_mu, f_var, n_samples, diagonal_output=True,
                           eps=torch.as_tensor(eps))
    want = np.mean(jax.nn.softmax(
        np.asarray(f_mu.detach())[None] + np.transpose(
            np.sqrt(np.diagonal(f_var.detach().numpy(), axis1=1, axis2=2))
            [..., None] * eps[None], (2, 0, 1)), axis=-1), axis=0)
    _close(d_t, want)


@pytest.mark.parametrize("name", ["stegcn_fused", "gat"])
def test_nn_predictive_with_injected_samples(name, monkeypatch):
    """The NN predictive: the same posterior weight samples through both
    models (GAT's through the flash Function, STEGCN's through core)."""
    jla, tla, y = _fits(name)
    samples = (np.asarray(jla.mean)[None]
               + 0.05 * np.random.default_rng(9).standard_normal(
                   (4, tla.n_params)))
    monkeypatch.setattr(jla, "sample", lambda n, key=None: jnp.asarray(
        samples[:n]))
    fs_j = jla._nn_predictive_samples(jnp.asarray(TEST), 4)
    fs_t = tla._nn_predictive_samples(torch.as_tensor(TEST), 4,
                                      samples=torch.as_tensor(samples))
    assert fs_t.shape == (4, len(TEST), C)
    _close(fs_t, fs_j)
    monkeypatch.setattr(tla, "sample", lambda n, generator=None:
                        torch.as_tensor(samples[:n]))
    _close(TT.mc_eval(tla, TEST, y[TEST], n_samples=4),
           JT.mc_eval(jla, TEST, y[TEST], n_samples=4))


def test_sample_is_the_posterior_square_root():
    """sample() = mean + P^-1/2 eps: with the same eps, the same samples;
    and the port's draws have the posterior covariance's scale."""
    jla, tla, _ = _fits("gcn")
    eps = np.random.default_rng(10).standard_normal((5, tla.n_params))
    _close(tla.posterior_precision.bmm(torch.as_tensor(eps), exponent=-0.5),
           jla.posterior_precision.bmm(jnp.asarray(eps), exponent=-0.5))
    s = tla.sample(2000, generator=torch.Generator().manual_seed(0))
    var = torch.var(s, dim=0)
    diag = torch.diagonal(tla.posterior_precision.to_matrix(exponent=-1))
    assert float(torch.max(torch.abs(var / diag - 1))) < 0.2


def test_evaluate_map_predictive_and_metrics():
    jla, tla, y = _fits("stegcn_fused")
    jp = jla.backend.params
    for kw in ({}, {"link_approx": "bridge"}):
        t = TE.evaluate_predictive(tla, TEST, y[TEST], **kw)
        j = JE.evaluate_predictive(jla, TEST, y[TEST], **kw)
        assert t.keys() == j.keys()
        for k in t:
            _close(t[k], j[k])
    t = TE.evaluate_map(tla.model, tla.params, TEST, y[TEST])
    j = JE.evaluate_map(jla.model, jp, TEST, y[TEST])
    for k in t:
        _close(t[k], j[k])
    # JAX's mean_eval averages the accuracy in float32: 1e-7
    _close(TT.mean_eval(tla.model, tla.params, TEST, y[TEST]),
           JT.mean_eval(jla.model, jp, TEST, y[TEST]), rtol=1e-7)
    loader = [(torch.as_tensor(TEST[:5]), y[TEST[:5]]),
              (torch.as_tensor(TEST[5:]), y[TEST[5:]])]
    t = TE.validate(tla, loader)
    j = JE.validate(jla, [(jnp.asarray(x.numpy()), yy) for x, yy in loader])
    for k in t:
        _close(t[k], j[k])


@pytest.mark.parametrize("fn", ["nll_loss", "accuracy", "brier_score",
                                "expected_calibration_error"])
def test_metrics_match(fn):
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((200, 5)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    y = rng.integers(0, 5, 200)
    assert getattr(TMET, fn)(probs, y) == pytest.approx(
        getattr(JMET, fn)(probs, y), rel=1e-12)


def test_laplace_api_rules():
    _, tm, _, tp = _pair("gcn")
    assert type(Laplace(tm, tp, "classification", "all",
                        "lowrank")).__name__ == "LowRankLaplace"
    # the default key is last-layer Kron
    assert type(Laplace(tm, tp, "classification")).__name__ == \
        "KronLLLaplace"
    with pytest.raises(ValueError):
        Laplace(tm, tp, "classification", "all", "nope")
    la = Laplace(tm, tp, "classification", "all", "kron")
    with pytest.raises(AttributeError, match="fit"):
        la.posterior_precision
    # tuning and saving need a fitted posterior, as in JAX
    for call in (la.optimize_prior_precision, la.state_dict):
        with pytest.raises(AttributeError, match="fit"):
            call()
    with pytest.raises(ValueError, match="Kron either scalar or per-layer"):
        la.prior_precision = torch.ones(la.n_params)
    la.prior_precision = 1.0        # the failed set kept the value, as in JAX
    with pytest.raises(ValueError, match="Only mc"):
        la(torch.as_tensor(TEST), pred_type="nn", link_approx="probit")
    # online fit: a second loader rescales and adds the factors as JAX does
    jm, _, jp, _ = _pair("gcn")
    y = _graph()[2]
    jla = JT.fit_laplace(jm, jax.tree_util.tree_map(jnp.asarray, jp), TRAIN,
                         y[TRAIN])
    from laplace_gnn_tpu.utils.data import ArrayLoader as JLoader
    jla.fit(JLoader(jnp.asarray(TEST), jnp.asarray(y[TEST])), override=False)
    la.fit(ArrayLoader(TRAIN, y[TRAIN], device="cpu"))
    la.fit(ArrayLoader(TEST, y[TEST], device="cpu"), override=False)
    assert la.n_data == jla.n_data
    _close(la.log_marginal_likelihood(), jla.log_marginal_likelihood())


def test_array_loader_batches_on_its_device():
    loader = ArrayLoader(np.arange(10), np.arange(10) % 3, batch_size=4,
                         device="cpu")
    batches = list(loader)
    assert len(loader) == len(batches) == 3 and loader.dataset_size == 10
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for b in batches for x in b)
    assert torch.equal(torch.cat([b[0] for b in batches]), torch.arange(10))
