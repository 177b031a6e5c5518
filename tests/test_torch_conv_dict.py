"""Port parity for the library's own models and the last linalg helpers:
nn/module.py (Conv2d, MLP, CNN, DictInputModel), their KFAC factors
through curvature/kfac.py (conv taps, 'expand' and 'reduce'), Laplace
fits on them, dict-batch fits, reward modeling, and ops/linalg.py
(``safe_symeig``, ``kron``, ``block_diag``, ``diagonal_add_scalar``,
``cho_solve_psd``), torch against JAX in float64 on the CPU at 1e-10
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import nn as JNN
from laplace_gnn_tpu.curvature import kfac as JK
from laplace_gnn_tpu.laplace import dispatch as JD
from laplace_gnn_tpu.ops import linalg as JL
from laplace_gnn_tpu.utils.data import ArrayLoader as JLoader
from laplace_gnn_torch import nn as TNN
from laplace_gnn_torch.curvature import kfac as TK
from laplace_gnn_torch.laplace import dispatch as TD
from laplace_gnn_torch.ops import linalg as TL
from laplace_gnn_torch.utils.data import ArrayLoader
from laplace_gnn_torch.utils.pytree import params_from_numpy

RTOL = 1e-10


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 1)])
def test_conv2d_forward_and_taps_match_jax(stride, padding):
    jc = JNN.Conv2d(3, 5, 3, stride=stride, padding=padding, name="c")
    tc = TNN.Conv2d(3, 5, 3, stride=stride, padding=padding, name="c",
                    dtype=torch.float64, device="cpu")
    jp = jax.tree_util.tree_map(np.asarray, jc.init(jax.random.PRNGKey(0)))
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 7))
    jt, tt = JNN.TapCollector(), TNN.TapCollector()
    jout = jc.apply(_j(jp), jnp.asarray(x), taps=jt)
    tout = torch.func.functional_call(
        tc, {k: torch.tensor(v) for k, v in jp.items()},
        (torch.as_tensor(x),), {"taps": tt})
    _close(tout, jout)
    (jn, ja, js), = jt.records
    (tn, ta, ts), = tt.records
    assert tn == jn == "c" and ta.shape == ja.shape
    _close(ta, ja)
    _close(ts, js)
    # and torch's own convolution
    ref = torch.nn.functional.conv2d(
        torch.as_tensor(x), torch.as_tensor(jp["weight"]),
        torch.as_tensor(jp["bias"]), stride=stride, padding=padding)
    _close(tout, ref)


def _cnn(seed=0):
    jm = JNN.CNN([(2, 4, 3), (4, 3, 3)], head_in=3 * 2 * 2, n_outputs=3)
    tm = TNN.CNN([(2, 4, 3), (4, 3, 3)], head_in=3 * 2 * 2, n_outputs=3,
                 device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((5, 2, 6, 6))
    y = rng.integers(0, 3, 5)
    return jm, _j(jp), tm, params_from_numpy(jp, device="cpu"), X, y


def test_cnn_forward_features_and_init_layout():
    jm, jp, tm, tp, X, _ = _cnn()
    _close(tm.apply(tp, torch.as_tensor(X)), jm.apply(jp, jnp.asarray(X)))
    tphi, tf = tm.features(tp, torch.as_tensor(X))
    jphi, jf = jm.features(jp, jnp.asarray(X))
    _close(tphi, jphi)
    _close(tf, jf)
    assert list(tp) == list(tm.params()) == list(tm.init())
    assert [s["name"] for s in tm.tap_sites()] == [
        s["name"] for s in jm.tap_sites(jp)]
    assert tm.last_layer_path() == jm.last_layer_path(jp)
    # init draws like the constructor: U(+-1/sqrt(fan_in))
    w = tm.init(torch.Generator().manual_seed(1))["convs.0.weight"]
    assert float(w.abs().max()) <= 1 / np.sqrt(2 * 9)


@pytest.mark.parametrize("fisher_type", ["type-2", "empirical",
                                         "forward-only"])
@pytest.mark.parametrize("kfac_approx", ["expand", "reduce"])
def test_cnn_kfac_factors_match_jax(kfac_approx, fisher_type):
    jm, jp, tm, tp, X, y = _cnn()
    kw = dict(kfac_approx=kfac_approx, N=5, fisher_type=fisher_type)
    jk = JK.compute_kfac_factors(jm, jp, jnp.asarray(X), jnp.asarray(y),
                                 "classification", **kw)
    tk = TK.compute_kfac_factors(tm, tp, torch.as_tensor(X),
                                 torch.as_tensor(y), "classification", **kw)
    assert len(tk.kfacs) == len(jk.kfacs) == 6
    for tg, jg in zip(tk.kfacs, jk.kfacs):
        for t, j in zip(tg, jg):
            _close(t, j)


@pytest.mark.parametrize("subset,structure", [
    ("all", "kron"), ("all", "diag"), ("all", "full"),
    ("last_layer", "kron"), ("last_layer", "full")])
def test_laplace_on_cnn_matches_jax(subset, structure):
    jm, jp, tm, tp, X, y = _cnn(1)
    jla = JD.Laplace(jm, jp, "classification", subset, structure)
    tla = TD.Laplace(tm, tp, "classification", subset, structure)
    jla.fit([(jnp.asarray(X), jnp.asarray(y))])
    tla.fit([(torch.as_tensor(X), torch.as_tensor(y))])
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    _close(tla(torch.as_tensor(X)), jla(jnp.asarray(X)))


def _mlp_data(seed, n=20, regression=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3))
    y = rng.standard_normal((n, 1)) if regression else rng.integers(0, 2, n)
    jm = JNN.MLP([3, 8, 2], act="tanh")
    tm = TNN.MLP([3, 8, 2], act="tanh", device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return X, y, jm, _j(jp), tm, params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("structure", ["kron", "diag", "full"])
def test_dict_fit_equals_tuple_fit_and_jax(structure):
    X, y, jm, jp, tm, tp = _mlp_data(1)
    ref = TD.Laplace(tm, tp, "classification", "all", structure)
    ref.fit(ArrayLoader(X, y, batch_size=10, device="cpu"))
    model = TNN.DictInputModel(tm)
    assert model.params().keys() == tp.keys()
    la = TD.Laplace(model, tp, "classification", "all", structure)
    la.fit(ArrayLoader({"input_ids": X, "labels": y}, batch_size=10,
                       device="cpu"))
    assert torch.equal(la.log_marginal_likelihood(),
                       ref.log_marginal_likelihood())
    Xt = torch.as_tensor(X[:5])
    assert torch.equal(la({"input_ids": Xt}), ref(Xt))
    jla = JD.Laplace(JNN.DictInputModel(jm), jp, "classification", "all",
                     structure)
    jla.fit(JLoader({"input_ids": jnp.asarray(X), "labels": jnp.asarray(y)},
                    batch_size=10))
    _close(la.log_marginal_likelihood(), jla.log_marginal_likelihood())
    _close(la({"input_ids": Xt}), jla({"input_ids": jnp.asarray(X[:5])}))


def test_dict_last_layer_custom_keys_and_gridsearch_match_jax():
    X, y, jm, jp, tm, tp = _mlp_data(2)
    kw = dict(dict_key_x="tokens", dict_key_y="targets")
    jla = JD.Laplace(JNN.DictInputModel(jm, dict_key_x="tokens"), jp,
                     "classification", "last_layer", "kron", **kw)
    tla = TD.Laplace(TNN.DictInputModel(tm, dict_key_x="tokens"), tp,
                     "classification", "last_layer", "kron", **kw)
    jla.fit(JLoader({"tokens": jnp.asarray(X), "targets": jnp.asarray(y)},
                    batch_size=7))
    tla.fit(ArrayLoader({"tokens": X, "targets": y}, batch_size=7,
                        device="cpu"))
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    _close(tla({"tokens": torch.as_tensor(X)}),
           jla({"tokens": jnp.asarray(X)}))
    grid = dict(method="gridsearch", grid_size=5)
    jla.optimize_prior_precision(val_loader=JLoader(
        {"tokens": jnp.asarray(X), "targets": jnp.asarray(y)}), **grid)
    tla.optimize_prior_precision(val_loader=ArrayLoader(
        {"tokens": X, "targets": y}, device="cpu"), **grid)
    _close(tla.prior_precision, jla.prior_precision)


class _JReward(JNN.MLP):
    def apply(self, params, x, **kw):
        if x.ndim == 3:
            b, two, d = x.shape
            return super().apply(params, x.reshape(-1, d), **kw).reshape(
                b, two)
        return super().apply(params, x, **kw)


class _TReward(TNN.MLP):
    def apply(self, params, x, **kw):
        if x.dim() == 3:
            b, two, d = x.shape
            return super().apply(params, x.reshape(-1, d), **kw).reshape(
                b, two)
        return super().apply(params, x, **kw)


@pytest.mark.parametrize("structure", ["kron", "diag"])
def test_reward_modeling_on_dict_batches_matches_jax(structure):
    """Fit as classification on (B, 2) preference pairs, predict a (B, 1)
    reward's mean and variance as regression."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((20, 2, 3))
    y = rng.integers(0, 2, 20)
    jm = _JReward([3, 8, 1], act="tanh")
    tm = _TReward([3, 8, 1], act="tanh", device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    jla = JD.Laplace(JNN.DictInputModel(jm), _j(jp), "reward_modeling",
                     "all", structure)
    tla = TD.Laplace(TNN.DictInputModel(tm), params_from_numpy(
        jp, device="cpu"), "reward_modeling", "all", structure)
    jla.fit(JLoader({"input_ids": jnp.asarray(X), "labels": jnp.asarray(y)}))
    tla.fit(ArrayLoader({"input_ids": X, "labels": y}, device="cpu"))
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    t_mu, t_var = tla({"input_ids": torch.as_tensor(X[:4, 0])})
    j_mu, j_var = jla({"input_ids": jnp.asarray(X[:4, 0])})
    assert t_mu.shape == (4, 1) and t_var.shape[0] == 4
    _close(t_mu, j_mu)
    _close(t_var, j_var)
    assert bool((t_var >= 0).all())


def test_linalg_helpers_match_jax():
    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 6))
    S = A @ A.T
    for jitter in (0.0, 0.3):
        tl, tw = TL.safe_symeig(torch.as_tensor(S), jitter)
        jl, jw = JL.safe_symeig(jnp.asarray(S), jitter)
        _close(tl, jl)
        _close(torch.abs(tw), np.abs(np.asarray(jw)), atol=1e-9)
    B = rng.standard_normal((3, 2))
    _close(TL.kron(torch.as_tensor(A[:2, :3]), torch.as_tensor(B)),
           JL.kron(jnp.asarray(A[:2, :3]), jnp.asarray(B)))
    blocks = [A[:2, :2], B, np.eye(1)]
    _close(TL.block_diag([torch.as_tensor(b) for b in blocks]),
           JL.block_diag([jnp.asarray(b) for b in blocks]))
    _close(TL.diagonal_add_scalar(torch.as_tensor(S), 0.7),
           JL.diagonal_add_scalar(jnp.asarray(S), 0.7))
    rhs = rng.standard_normal((6, 3))
    for jitter in (0.0, 1e-3):
        for r in (rhs, rhs[:, 0]):
            _close(TL.cho_solve_psd(torch.as_tensor(S), torch.as_tensor(r),
                                    jitter),
                   JL.cho_solve_psd(jnp.asarray(S), jnp.asarray(r), jitter),
                   rtol=1e-9)
