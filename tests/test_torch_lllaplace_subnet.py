"""Port parity for last-layer and subnetwork Laplace: laplace/lllaplace.py
(FullLLLaplace, KronLLLaplace, DiagLLLaplace with
``functional_variance_fast``), laplace/subnet.py (every mask,
FullSubnetLaplace, DiagSubnetLaplace, ``assemble_full_samples``),
utils/swag.py, the backends' ``subnetwork_indices`` and closed-form
last-layer Jacobians (curvature/interface.py), torch against JAX in
float64 on the CPU.

Composed math is held at 1e-10 relative; the SWAG variance (SGD steps) at
1e-8. On the MLP (D 3, H 4, C 2, M 10, the JAX tests' sizes) the
last-layer Jacobians are the closed form; on a GCN and a fused STE-GCN
(N 24) they are autodiff ones through the aggregation. JAX's normals and
the random mask's uniforms enter the port through its private draw
functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu import nn as JNN
from laplace_gnn_tpu.curvature import interface as JI
from laplace_gnn_tpu.laplace import dispatch as JD
from laplace_gnn_tpu.laplace import subnet as JS
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_tpu.utils import swag as JSW
from laplace_gnn_tpu.utils.data import ArrayLoader as JLoader
from laplace_gnn_torch import models as TM
from laplace_gnn_torch import nn as TNN
from laplace_gnn_torch.curvature import interface as TI
from laplace_gnn_torch.laplace import dispatch as TD
from laplace_gnn_torch.laplace import subnet as TS
from laplace_gnn_torch.ops import linalg as TL
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils import swag as TSW
from laplace_gnn_torch.utils.data import ArrayLoader
from laplace_gnn_torch.utils.pytree import params_from_numpy

RTOL = 1e-10
M, D, H, C = 10, 3, 4, 2
P = H * D + H + C * H + C
N, F, HID, NC = 24, 5, 6, 3
TRAIN, TEST = np.arange(0, 14), np.arange(14, 24)


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _mlp(seed=0, dims=(D, H, C)):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M, dims[0]))
    y = rng.integers(0, dims[-1], M)
    jm = JNN.MLP(list(dims), act="tanh")
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = TNN.MLP(list(dims), act="tanh", device="cpu", dtype=torch.float64)
    return (jm, jax.tree_util.tree_map(jnp.asarray, jp), JLoader(
        jnp.asarray(X), jnp.asarray(y)), jnp.asarray(X),
        tm, params_from_numpy(jp, device="cpu"),
        ArrayLoader(X, y, device="cpu"), torch.as_tensor(X))


def _gnn(name, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    a = (rng.random((N, N)) < 0.2).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, NC, N)
    kw = dict(dropout_p=0.0)
    if name == "stegcn_fused":
        kw.update(fused=True, symmetric=True)
    cls = "GCN" if name == "gcn" else "STEGCN"
    jm = getattr(JM, cls)(F, HID, NC, 2, X, adj, **kw)
    tm = getattr(TM, cls)(F, HID, NC, 2, X, adj, device="cpu",
                          dtype=torch.float64, **kw)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    if name != "gcn":
        jp["adj"] = np.where(rng.random((N, N)) < 0.2, 0.5,
                             jp["adj"] * 0.6 + 0.3)
    return (jm, jax.tree_util.tree_map(jnp.asarray, jp), tm,
            params_from_numpy(jp, device="cpu"), y)


@pytest.fixture
def jax_normals(monkeypatch):
    key = jax.random.PRNGKey(7)

    def normals(shape, generator, dtype, device):
        return torch.tensor(np.asarray(jax.random.normal(key, shape,
                                                         jnp.float64)))

    monkeypatch.setattr(TL, "_standard_normals", normals)
    return key


def _same_posterior(tla, jla, structure):
    assert type(tla).__name__ == type(jla).__name__
    assert tla.n_params == jla.n_params
    _close(tla.mean, jla.mean)
    _close(tla.loss, jla.loss)
    if structure == "kron":
        for tg, jg in zip(tla.H_facs.kfacs, jla.H_facs.kfacs):
            for t, j in zip(tg, jg):
                _close(t, j)
    else:
        _close(tla.H, jla.H)
        _close(tla.posterior_precision, jla.posterior_precision)
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())
    _close(tla.log_marginal_likelihood(0.7), jla.log_marginal_likelihood(
        0.7))


@pytest.mark.parametrize("structure", ["full", "kron", "diag"])
def test_last_layer_flavours_on_mlp_match_jax(structure, jax_normals):
    jm, jp, jl, jX, tm, tp, tl, tX = _mlp()
    jla = JD.Laplace(jm, jp, "classification", hessian_structure=structure)
    tla = TD.Laplace(tm, tp, "classification", hessian_structure=structure)
    assert tla.n_params == H * C + C
    jla.fit(jl)
    tla.fit(tl)
    _same_posterior(tla, jla, structure)
    Js, f = tla.backend._jacs(tX)
    jJs, jf = jla.backend._jacs(jX)
    _close(Js, jJs)
    _close(f, jf)
    _close(tla.functional_variance(Js), jla.functional_variance(jJs))
    _close(tla(tX, link_approx="probit"), jla(jX, link_approx="probit"))
    key = jax_normals
    _close(tla.sample(4), jla.sample(4, key=key))
    _close(tla.predictive_samples(tX, n_samples=4),
           jla.predictive_samples(jX, n_samples=4, key=key))
    _close(tla.predictive_samples(tX, pred_type="nn", n_samples=4),
           jla.predictive_samples(jX, pred_type="nn", n_samples=4, key=key))
    if structure == "diag":
        tf, tv = tla.functional_variance_fast(tX)
        jf2, jv = jla.functional_variance_fast(jX)
        _close(tv, jv)
        _close(tv, torch.diagonal(tla.functional_variance(Js), dim1=-2,
                                  dim2=-1))


def test_closed_form_jacobians_equal_autodiff_and_no_bias_layout():
    *_, tm, tp, tl, tX = _mlp()
    b = TI.GGNBackend(tm, tp, "classification", last_layer=True)
    Jc, fc = b.last_layer_jacobians(tX)
    Ja, fa = b.jacobians(tX)
    _close(Jc, Ja.detach())
    jm = JNN.MLP([D, H, C], bias=False)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tm2 = TNN.MLP([D, H, C], bias=False, device="cpu", dtype=torch.float64)
    jb = JI.GGNBackend(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                       "classification", last_layer=True)
    tb = TI.GGNBackend(tm2, params_from_numpy(jp, device="cpu"),
                       "classification", last_layer=True)
    _close(tb.last_layer_jacobians(tX)[0],
           jb.last_layer_jacobians(jnp.asarray(tX.numpy()))[0])


@pytest.mark.parametrize("name,structure", [
    ("gcn", "full"), ("stegcn_fused", "kron"), ("stegcn_fused", "diag")])
def test_last_layer_flavours_on_gnns_match_jax(name, structure,
                                              jax_normals):
    """The GNN's last Linear is aggregated before the output: no closed
    form, the Jacobians are autodiff ones, as in JAX."""
    jm, jp, tm, tp, y = _gnn(name)
    assert tm.last_layer_closed_form is False
    jla = JT.fit_laplace(jm, jp, TRAIN, y[TRAIN], "last_layer", structure)
    tla = TT.fit_laplace(tm, tp, TRAIN, y[TRAIN], "last_layer", structure)
    assert tla.n_params == HID * NC + NC
    _same_posterior(tla, jla, structure)
    _close(tla(torch.as_tensor(TEST), link_approx="probit"),
           jla(jnp.asarray(TEST), link_approx="probit"))
    _close(tla.predictive_samples(torch.as_tensor(TEST), n_samples=3),
           jla.predictive_samples(jnp.asarray(TEST), n_samples=3,
                                  key=jax_normals))
    Js, _ = tla.backend._jacs(torch.as_tensor(TEST))
    full_Js, _ = TI.GGNBackend(tm, tp, "classification").jacobians(
        torch.as_tensor(TEST))
    # the last layer's entries of the whole model's Jacobians
    _close(Js, full_Js[..., -(HID * NC + NC):])
    phi, f = tm.features(tp, torch.as_tensor(TEST))
    jphi, jf = jm.features(jp, jnp.asarray(TEST))
    assert phi.shape == (N, HID)
    _close(phi, jphi)
    _close(f, jf)


def test_one_layer_last_layer_equals_all():
    jm, jp, jl, jX, tm, tp, tl, tX = _mlp(dims=(D, C))
    ll = TD.Laplace(tm, tp, "classification", "last_layer", "full")
    al = TD.Laplace(tm, tp, "classification", "all", "full")
    ll.fit(tl)
    al.fit(tl)
    _close(ll.H, al.H)
    _close(ll(tX), al(tX))


@pytest.mark.parametrize("structure", ["full", "diag"])
def test_subnet_flavours_on_mlp_match_jax(structure, jax_normals):
    jm, jp, jl, jX, tm, tp, tl, tX = _mlp()
    idx = np.array([0, 5, 11, P - 1])
    jla = JD.Laplace(jm, jp, "classification", "subnetwork", structure,
                     subnetwork_indices=jnp.asarray(idx))
    tla = TD.Laplace(tm, tp, "classification", "subnetwork", structure,
                     subnetwork_indices=torch.as_tensor(idx))
    jla.fit(jl)
    tla.fit(tl)
    assert tla.n_params == 4
    _same_posterior(tla, jla, structure)
    _close(tla(tX), jla(jX))
    key = jax_normals
    s = tla.sample(5)
    _close(s, jla.sample(5, key=key))
    theta = torch.cat([tp[k].reshape(-1) for k in sorted(tp)])
    rest = np.setdiff1d(np.arange(P), idx)
    _close(s[:, rest], theta[rest].repeat(5, 1))
    _close(tla(tX, pred_type="nn", link_approx="mc", n_samples=5),
           jla(jX, pred_type="nn", link_approx="mc", n_samples=5, key=key))
    _close(tla.predictive_samples(tX, n_samples=3),
           jla.predictive_samples(jX, n_samples=3, key=key))
    with pytest.raises(ValueError):
        tla.log_marginal_likelihood(torch.ones(2, dtype=torch.float64))


@pytest.mark.parametrize("name", ["gcn", "stegcn_fused"])
def test_subnet_on_gnn_with_jax_indices(name, jax_normals):
    """JAX's own indices (the largest-magnitude mask) go to the port, and
    the selected parameters agree by value."""
    jm, jp, tm, tp, y = _gnn(name)
    jidx = JS.LargestMagnitudeSubnetMask(jm, jp, 20).select()
    tidx = TS.LargestMagnitudeSubnetMask(tm, tp, 20).select()
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for structure in ("full", "diag"):
        jla = JT.fit_laplace(jm, jp, TRAIN, y[TRAIN], "subnetwork",
                             structure, subnetwork_indices=jidx)
        tla = TT.fit_laplace(tm, tp, TRAIN, y[TRAIN], "subnetwork",
                             structure,
                             subnetwork_indices=np.asarray(jidx))
        _close(tla.mean, jla.mean)
        _same_posterior(tla, jla, structure)
        _close(tla(torch.as_tensor(TEST)), jla(jnp.asarray(TEST)))
        _close(tla.predictive_samples(torch.as_tensor(TEST), n_samples=3),
               jla.predictive_samples(jnp.asarray(TEST), n_samples=3,
                                      key=jax_normals))


def test_subnet_equals_full_with_every_index_and_validation():
    *_, tm, tp, tl, tX = _mlp()
    sub = TS.FullSubnetLaplace(tm, tp, "classification",
                               subnetwork_indices=torch.arange(P))
    full = TD.Laplace(tm, tp, "classification", "all", "full")
    sub.fit(tl)
    full.fit(tl)
    _close(sub.H, full.H)
    _close(sub.log_marginal_likelihood(), full.log_marginal_likelihood())
    for bad in ([0.5, 1.2], [1, 1, 2], np.zeros((2, 2), int), []):
        with pytest.raises(ValueError):
            TS.FullSubnetLaplace(tm, tp, "classification",
                                 subnetwork_indices=bad)
    with pytest.raises(ValueError, match="GGN and EF"):
        TS.FullSubnetLaplace(tm, tp, "classification",
                             subnetwork_indices=[1, 2],
                             backend=TI.HessianBackend)


@pytest.mark.parametrize("backend", ["ef", "hessian"])
def test_backend_subnetwork_indices_match_jax(backend):
    jm, jp, jl, jX, tm, tp, tl, tX = _mlp(seed=2)
    idx = np.array([1, 4, 9, 17, 25])
    y = next(iter(tl))[1]
    jb = JI.BACKEND_REGISTRY[backend](jm, jp, "classification",
                                      subnetwork_indices=jnp.asarray(idx))
    tb = TI.BACKEND_REGISTRY[backend](tm, tp, "classification",
                                      subnetwork_indices=torch.as_tensor(idx))
    assert tb.n_params == 5
    _close(tb.mean_vector(), jb.mean_vector())
    for kind in ("full", "diag"):
        tl_, th = getattr(tb, kind)(tX, y)
        jl_, jh = getattr(jb, kind)(jX, jnp.asarray(y.numpy()))
        _close(tl_, jl_)
        _close(th, jh)
    if backend == "ef":
        _close(tb.gradients(tX, y)[0], jb.gradients(jX, jnp.asarray(
            y.numpy()))[0])


def test_masks_match_jax(monkeypatch):
    jm, jp, jl, jX, tm, tp, tl, tX = _mlp()
    seed = 3
    jscores = JS.RandomSubnetMask(jm, jp, 6, seed=seed).compute_param_scores(
        None)
    monkeypatch.setattr(TS, "_uniform_scores",
                        lambda s, n, dtype, device: torch.tensor(
                            np.asarray(jscores)))
    pairs = [
        (JS.RandomSubnetMask(jm, jp, 6, seed=seed),
         TS.RandomSubnetMask(tm, tp, 6, seed=seed)),
        (JS.LargestMagnitudeSubnetMask(jm, jp, 6),
         TS.LargestMagnitudeSubnetMask(tm, tp, 6)),
        (JS.LargestVarianceDiagLaplaceSubnetMask(jm, jp, 5),
         TS.LargestVarianceDiagLaplaceSubnetMask(tm, tp, 5)),
        (JS.ParamNameSubnetMask(jm, jp, ["layers.0.bias"]),
         TS.ParamNameSubnetMask(tm, tp, ["layers.0.bias"])),
        (JS.ModuleNameSubnetMask(jm, jp, ["layers.1"]),
         TS.ModuleNameSubnetMask(tm, tp, ["layers.1"])),
        (JS.LastLayerSubnetMask(jm, jp), TS.LastLayerSubnetMask(tm, tp)),
    ]
    for jmask, tmask in pairs:
        jidx = jmask.select(jl)
        tidx = tmask.select(tl)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx),
                                      err_msg=type(tmask).__name__)
        _close(tmask.indices, jmask.indices)
        with pytest.raises(ValueError, match="already selected"):
            tmask.select(tl)
    with pytest.raises(ValueError, match="cannot be larger"):
        TS.RandomSubnetMask(tm, tp, P + 1).select(tl)
    with pytest.raises(ValueError, match="do not exist"):
        TS.ParamNameSubnetMask(tm, tp, ["nope"]).select(tl)
    with pytest.raises(ValueError, match="do not exist"):
        TS.ModuleNameSubnetMask(tm, tp, ["layers.7"]).select(tl)
    with pytest.raises(ValueError, match="train loader"):
        TS.LargestVarianceDiagLaplaceSubnetMask(tm, tp, 3).select(None)
    with pytest.raises(AttributeError, match="select"):
        TS.LastLayerSubnetMask(tm, tp).indices
    # the port's own draws: distinct sorted indices
    own = TS.RandomSubnetMask(tm, tp, 6).select()
    assert torch.equal(own, torch.unique(own)) and own.shape == (6,)


def test_last_layer_mask_equals_last_layer_laplace():
    *_, tm, tp, tl, tX = _mlp()
    idx = TS.LastLayerSubnetMask(tm, tp).select(tl)
    sub = TS.FullSubnetLaplace(tm, tp, "classification",
                               subnetwork_indices=idx)
    ll = TD.Laplace(tm, tp, "classification", "last_layer", "full")
    sub.fit(tl)
    ll.fit(tl)
    _close(sub.H, ll.H)


def test_swag_variance_and_mask_match_jax():
    """Three snapshots of SGD with momentum and weight decay, two batches
    an epoch: torch.optim.SGD against optax's chain, at 1e-8."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((M, D))
    y = rng.integers(0, C, M)
    jm = JNN.MLP([D, H, C], act="tanh")
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    tm = TNN.MLP([D, H, C], act="tanh", device="cpu", dtype=torch.float64)
    tp = params_from_numpy(jp, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    jl = JLoader(jnp.asarray(X), jnp.asarray(y), batch_size=5)
    tl = ArrayLoader(X, y, batch_size=5, device="cpu")
    kw = dict(n_snapshots_total=3, snapshot_freq=2, lr=0.05)
    _close(TSW.fit_diagonal_swag_var(tm, tp, tl, "classification", **kw),
           JSW.fit_diagonal_swag_var(jm, jp, jl, "classification", **kw),
           rtol=1e-8, atol=1e-14)
    kw = dict(swag_n_snapshots=3, swag_lr=0.05)
    jidx = JS.LargestVarianceSWAGSubnetMask(jm, jp, 7, **kw).select(jl)
    tidx = TS.LargestVarianceSWAGSubnetMask(tm, tp, 7, **kw).select(tl)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    with pytest.raises(ValueError, match="train loader"):
        TS.LargestVarianceSWAGSubnetMask(tm, tp, 7, **kw).select(None)
