"""Port parity for curvature/interface.py's backends (GGNBackend full /
diag / kron with its options, stochastic too; EFBackend; HessianBackend)
and the curvature/losses.py helpers, torch against JAX in float64 on the
CPU. JAX's draws of the stochastic GGN middle go into the port through
monkeypatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.curvature import interface as JI
from laplace_gnn_tpu.curvature import losses as JLo
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.curvature import interface as TI
from laplace_gnn_torch.curvature import losses as TLo
from laplace_gnn_torch.utils.pytree import params_from_numpy

N, F, H, C = 30, 6, 5, 3
M = 12


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("likelihood", ["classification", "regression"])
def test_loss_helpers_match_jax(likelihood):
    rng = np.random.default_rng(0)
    f = rng.standard_normal((M, C)) * 4
    v = rng.standard_normal((M, C))
    yb = rng.integers(0, 2, (M, C)).astype(float)
    np.testing.assert_allclose(
        float(TLo.bce_with_logits_sum(_t(f), _t(yb))),
        float(JLo.bce_with_logits_sum(jnp.asarray(f), jnp.asarray(yb))),
        rtol=1e-13)
    np.testing.assert_allclose(
        TLo.loss_hessian_mvp(likelihood, _t(f), _t(v)).numpy(),
        np.asarray(JLo.loss_hessian_mvp(likelihood, jnp.asarray(f),
                                        jnp.asarray(v))), atol=1e-14)
    np.testing.assert_allclose(
        TLo.loss_hessian_diag(likelihood, _t(f)).numpy(),
        np.asarray(JLo.loss_hessian_diag(likelihood, jnp.asarray(f))),
        atol=1e-14)
    # the mvp is the dense Hessian's product, the diagonal its diagonal
    Hd = TLo.loss_hessian(likelihood, _t(f))
    np.testing.assert_allclose(
        TLo.loss_hessian_mvp(likelihood, _t(f), _t(v)).numpy(),
        torch.einsum("mck,mk->mc", Hd, _t(v)).numpy(), atol=1e-14)
    np.testing.assert_allclose(TLo.loss_hessian_diag(likelihood,
                                                     _t(f)).numpy(),
                               torch.diagonal(Hd, dim1=1, dim2=2).numpy(),
                               atol=1e-14)
    # sample_labels: one generator seed, one draw, on f's device and dtype
    a = TLo.sample_labels(torch.Generator().manual_seed(4), likelihood, _t(f))
    b = TLo.sample_labels(torch.Generator().manual_seed(4), likelihood, _t(f))
    assert torch.equal(a, b)
    assert a.shape == ((M,) if likelihood == "classification" else (M, C))


def _setup(cls="STEGCN", fused=True, likelihood="classification", seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    adj = (rng.random((N, N)) < 0.15).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = (rng.integers(0, C, N) if likelihood == "classification"
         else rng.standard_normal((N, C)))
    jm = getattr(JM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=True)
    tm = getattr(TM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=True, device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if cls == "STEGCN":
        jp["adj"] = np.where(rng.random((N, N)) < 0.15, 0.5,
                             jp["adj"] * 0.7 + 0.2)
    return jm, tm, jp, y


def _backends(cls_j, cls_t, model="STEGCN", fused=True,
              likelihood="classification", **kw):
    jm, tm, jp, y = _setup(model, fused, likelihood)
    jb = cls_j(jm, jax.tree_util.tree_map(jnp.asarray, jp), likelihood, **kw)
    tb = cls_t(tm, params_from_numpy(jp, device="cpu"), likelihood, **kw)
    idx = np.arange(M)
    return (jb, (jnp.asarray(idx), jnp.asarray(y[:M])), tb,
            (torch.as_tensor(idx), torch.as_tensor(y[:M])))


def _close(t, j, rtol=1e-10, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def use_jax_middle_draws(monkeypatch):
    def draw(m, likelihood, f):
        k = jax.random.fold_in(jax.random.PRNGKey(0), m)
        fj = jnp.asarray(f.detach().numpy())
        if likelihood == "regression":
            return _t(jax.random.normal(k, fj.shape, fj.dtype))
        return _t(jax.random.categorical(k, fj, axis=-1))

    monkeypatch.setattr(TI, "_middle_draw", draw)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("likelihood", ["classification", "regression"])
@pytest.mark.parametrize("fused", [True, False])
def test_ggn_full_and_diag_match_jax(fused, likelihood, stochastic,
                                     monkeypatch):
    use_jax_middle_draws(monkeypatch)
    jb, jxy, tb, txy = _backends(JI.GGNBackend, TI.GGNBackend, fused=fused,
                                 likelihood=likelihood,
                                 stochastic=stochastic, mc_samples=3)
    jl, jH = jb.full(*jxy)
    tl, tH = tb.full(*txy)
    _close(tl, jl)
    _close(tH, jH)
    for row_chunk in (None, 5):
        jl, jh = jb.diag(*jxy, row_chunk=row_chunk)
        tl, th = tb.diag(*txy, row_chunk=row_chunk)
        _close(tl, jl)
        _close(th, jh)
        np.testing.assert_allclose(th.numpy(), torch.diagonal(tH).numpy(),
                                   rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("fisher_type", [None, "empirical", "forward-only"])
def test_ggn_kron_options_match_jax(fisher_type):
    """The constructor's options reach the Kron factors as in JAX."""
    kw = dict(column_chunk=2, mc_samples=2, seed=1)
    if fisher_type is not None:
        kw["fisher_type"] = fisher_type
    jb, jxy, tb, txy = _backends(JI.GGNBackend, TI.GGNBackend, **kw)
    assert tb._kron_fisher_type == jb._kron_fisher_type
    jl, jk = jb.kron(*jxy, N=M)
    tl, tk = tb.kron(*txy, N=M)
    _close(tl, jl)
    for gt_, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt_, gj):
            _close(a, b)
    stoch = TI.GGNBackend(tb.model, tb.params, "classification",
                          stochastic=True)
    assert stoch._kron_fisher_type == "mc"


@pytest.mark.parametrize("model,fused", [("STEGCN", True), ("GCN", False)])
def test_ef_backend_matches_jax(model, fused):
    jb, jxy, tb, txy = _backends(JI.EFBackend, TI.EFBackend, model=model,
                                 fused=fused)
    jG, jloss = jb.gradients(*jxy)
    tG, tloss = tb.gradients(*txy)
    _close(tG, jG)
    _close(tloss, jloss)
    for name in ("full", "diag"):
        jl, jc = getattr(jb, name)(*jxy)
        tl, tc = getattr(tb, name)(*txy)
        _close(tl, jl)
        _close(tc, jc)
    jl, jk = jb.kron(*jxy, N=M)
    tl, tk = tb.kron(*txy, N=M)
    _close(tl, jl)
    for gt_, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt_, gj):
            _close(a, b)


@pytest.mark.parametrize("likelihood", ["classification", "regression"])
def test_hessian_backend_matches_jax(likelihood):
    """The exact Hessian of the composed GCN, and of the port's fused GCN
    (the same math through the aggregation Function, reverse over
    reverse), against JAX's ``jax.hessian`` of the composed one."""
    jb, jxy, tb, txy = _backends(JI.HessianBackend, TI.HessianBackend,
                                 model="GCN", fused=False,
                                 likelihood=likelihood)
    jl, jH = jb.full(*jxy)
    tl, tH = tb.full(*txy)
    _close(tl, jl)
    _close(tH, jH, atol=1e-11)
    jl, jd = jb.diag(*jxy)
    tl, td = tb.diag(*txy)
    _close(td, jd, atol=1e-11)
    _, _, tbf, _ = _backends(JI.HessianBackend, TI.HessianBackend,
                             model="GCN", fused=True, likelihood=likelihood)
    _, tHf = tbf.full(*txy)
    _close(tHf, jH, atol=1e-11)
    with pytest.raises(NotImplementedError):
        tb.kron(*txy, N=M)
    assert TI.BACKEND_REGISTRY.keys() == JI.BACKEND_REGISTRY.keys()
