"""Port parity for curvature/losses.py, laplace/kron.py, curvature/kfac.py
and curvature/interface.py (torch against JAX, float64 on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.curvature import losses as JLo
from laplace_gnn_tpu.curvature.interface import GGNBackend as JB
from laplace_gnn_tpu.curvature import kfac as JKfac
from laplace_gnn_tpu.curvature.kfac import compute_kfac_factors as jkfac
from laplace_gnn_tpu.laplace.kron import Kron as JKron
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.curvature import losses as TLo
from laplace_gnn_torch.curvature.interface import GGNBackend as TB
from laplace_gnn_torch.curvature import kfac as TKfac
from laplace_gnn_torch.curvature.kfac import compute_kfac_factors as tkfac
from laplace_gnn_torch.laplace.kron import Kron as TKron
from laplace_gnn_torch.utils.pytree import params_from_numpy

N, F, H, C = 40, 12, 8, 3
M = 20


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("likelihood", ["classification", "regression"])
def test_losses_and_hessians(likelihood):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((M, C)) * 3
    y = rng.integers(0, C, M)
    np.testing.assert_allclose(
        float(TLo.cross_entropy_sum(_t(f), _t(y))),
        float(JLo.cross_entropy_sum(jnp.asarray(f), jnp.asarray(y))),
        rtol=1e-13)
    assert TLo.get_loss_fn(likelihood) is (
        TLo.cross_entropy_sum if likelihood == "classification"
        else TLo.mse_sum)
    assert TLo.likelihood_factor(likelihood) == JLo.likelihood_factor(
        likelihood)
    np.testing.assert_allclose(
        TLo.loss_hessian(likelihood, _t(f)).numpy(),
        np.asarray(JLo.loss_hessian(likelihood, jnp.asarray(f))), atol=1e-14)
    np.testing.assert_allclose(
        TLo.loss_hessian_sqrt(likelihood, _t(f)).numpy(),
        np.asarray(JLo.loss_hessian_sqrt(likelihood, jnp.asarray(f))),
        atol=1e-14)
    with pytest.raises(ValueError):
        TLo.get_loss_fn("nope")


def test_loss_hessian_sqrt_gradient_finite_at_saturation():
    """exp(log_softmax / 2) keeps the derivative finite once p underflows
    to 0, where a plain sqrt(p) gives NaN; and it equals JAX's."""
    f = np.array([[0.0, 800.0, -800.0], [1.0, 2.0, 3.0]])
    w = np.random.default_rng(1).standard_normal((2, C, C))
    want = jax.grad(lambda x: jnp.sum(JLo.loss_hessian_sqrt(
        "classification", x) * w))(jnp.asarray(f))
    x = _t(f).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(TLo.loss_hessian_sqrt(
        "classification", x) * _t(w)), x)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def test_kron_scalar_distribution():
    rng = np.random.default_rng(2)
    groups = [[rng.random((3, 3))], [rng.random((2, 2)), rng.random((4, 4))]]
    jk = JKron([[jnp.asarray(g) for g in grp] for grp in groups]) * 0.5
    tk = 0.5 * TKron([[_t(g) for g in grp] for grp in groups])
    assert len(tk) == 2
    for ga, gb in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-15)
    s = tk + tk
    np.testing.assert_allclose(s.kfacs[1][1].numpy(),
                               2 * tk.kfacs[1][1].numpy())
    with pytest.raises(ValueError):
        tk * _t(np.ones(3))


def _setup(cls="STEGCN", fused=True, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    adj = (rng.random((N, N)) < 0.1).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, C, N)
    jm = getattr(JM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=True)
    tm = getattr(TM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=True, device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if cls == "STEGCN":
        jp["adj"] = np.where(rng.random((N, N)) < 0.15, 0.5,
                             jp["adj"] * 0.7 + 0.2)
    return jm, tm, jp, y


@pytest.mark.parametrize("cls,fused", [("STEGCN", True), ("STEGCN", False),
                                       ("GCN", True)])
def test_kfac_factors_match_jax(cls, fused, monkeypatch):
    jm, tm, jp, y = _setup(cls, fused)
    idx = np.arange(M)
    jk, jout = jkfac(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                     jnp.asarray(idx), jnp.asarray(y[:M]), "classification",
                     N=M, return_output=True)
    tp = params_from_numpy(jp, device="cpu")
    tk, tout = tkfac(tm, tp, torch.as_tensor(idx), torch.as_tensor(y[:M]),
                     "classification", N=M, return_output=True)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-12)
    assert [len(g) for g in tk.kfacs] == [len(g) for g in jk.kfacs]
    for gt_, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt_, gj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)
    # the MC Fisher with JAX's label draws in place of the port's
    monkeypatch.setattr(TKfac, "_draw_label", lambda seed, m, lik, f: _t(
        JKfac._draw_label(jax.random.fold_in(jax.random.PRNGKey(seed), m),
                          lik, jnp.asarray(f.detach().numpy()))))
    jk = jkfac(jm, jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(idx),
               jnp.asarray(y[:M]), "classification", N=M, fisher_type="mc",
               mc_samples=2, seed=1)
    tk = tkfac(tm, tp, torch.as_tensor(idx), torch.as_tensor(y[:M]),
               "classification", N=M, fisher_type="mc", mc_samples=2, seed=1)
    for gt_, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt_, gj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)


def test_kfac_factor_gradient_wrt_adj_matches_jax():
    """d/d adj of a scalar of the factors (the path the hyperstep takes):
    through the STE in the composed model."""
    jm, tm, jp, y = _setup("STEGCN", fused=False, seed=3)
    idx = np.arange(M)
    w = [np.random.default_rng(k).standard_normal((d, d))
         for k, d in enumerate((H, F, C, H))]

    def jscalar(p):
        k = jkfac(jm, p, jnp.asarray(idx), jnp.asarray(y[:M]),
                  "classification", N=M)
        fs = [k.kfacs[0][0], k.kfacs[1][1], k.kfacs[2][0], k.kfacs[3][1]]
        return sum(jnp.sum(f * wi) for f, wi in zip(fs, w))

    jg = jax.grad(jscalar)(jax.tree_util.tree_map(jnp.asarray, jp))["adj"]
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    k = tkfac(tm, tp, torch.as_tensor(idx), torch.as_tensor(y[:M]),
              "classification", N=M)
    fs = [k.kfacs[0][0], k.kfacs[1][1], k.kfacs[2][0], k.kfacs[3][1]]
    val = sum(torch.sum(f * _t(wi)) for f, wi in zip(fs, w))
    (tg,) = torch.autograd.grad(val, tp["adj"])
    assert np.abs(np.asarray(jg)).max() > 0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-10)


@pytest.mark.parametrize("last_layer", [False, True])
def test_ggn_backend_kron(last_layer):
    jm, tm, jp, y = _setup("STEGCN", fused=True, seed=4)
    idx = np.arange(M)
    jb = JB(jm, jax.tree_util.tree_map(jnp.asarray, jp), "classification",
            last_layer=last_layer)
    tb = TB(tm, params_from_numpy(jp, device="cpu"), "classification",
            last_layer=last_layer)
    assert tb.n_params == jb.n_params
    np.testing.assert_array_equal(tb.mean_vector().numpy(),
                                  np.asarray(jb.mean_vector()))
    jl, jk = jb.kron(jnp.asarray(idx), jnp.asarray(y[:M]), N=M)
    tl, tk = tb.kron(torch.as_tensor(idx), torch.as_tensor(y[:M]), N=M)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-12)
    np.testing.assert_allclose(
        float(tb.loss(torch.as_tensor(idx), torch.as_tensor(y[:M]))),
        float(jl), rtol=1e-12)
    for gt_, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt_, gj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-10, atol=1e-12)
