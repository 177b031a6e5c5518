"""Port parity for nn/module.py, utils/pytree.py, ops/adjacency.py,
ops/linalg.py, ops/spmm.py and the models (torch against JAX, float64 on
the CPU: composed math agrees to 1e-10 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.ops import adjacency as JA
from laplace_gnn_tpu.ops import linalg as JL
from laplace_gnn_tpu.utils import pytree as JP
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.nn import module as TN
from laplace_gnn_torch.ops import adjacency as TA
from laplace_gnn_torch.ops import linalg as TL
from laplace_gnn_torch.ops.spmm import aggregate
from laplace_gnn_torch.utils import pytree as TP

N, F, H, C = 40, 12, 8, 3
ATOL = 1e-10


def _t(x):
    return torch.as_tensor(np.array(x))


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    adj = (rng.random((N, N)) < 0.1).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    return X, adj


def _jax_params(model, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(seed)))


# --- nn/module.py -----------------------------------------------------------

@pytest.mark.parametrize("act", ["relu", "tanh", "gelu", "sigmoid", "elu",
                                 "leaky_relu", "silu", "identity"])
def test_activation_resolver(act):
    from laplace_gnn_tpu.nn.module import activation_resolver as ja
    x = np.linspace(-3, 3, 25)
    np.testing.assert_allclose(TN.activation_resolver(act)(_t(x)).numpy(),
                               np.asarray(ja(act)(jnp.asarray(x))),
                               atol=1e-12)


def test_linear_taps_and_init_bounds():
    from laplace_gnn_tpu.nn.module import Linear as JLin, TapCollector as JT
    lin = TN.Linear(F, H, name="l", generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    bound = 1 / np.sqrt(F)
    assert lin.weight.shape == (H, F) and lin.bias.shape == (H,)
    assert float(lin.weight.detach().abs().max()) <= bound
    x = np.random.default_rng(0).standard_normal((N, F))
    eps = np.random.default_rng(1).standard_normal((N, H))
    p = {"weight": lin.weight.detach().numpy(), "bias": lin.bias.detach().numpy()}
    jt = JT({"l": jnp.asarray(eps)})
    want = JLin(F, H, name="l").apply(p, jnp.asarray(x), taps=jt)
    tt = TN.TapCollector({"l": _t(eps)})
    got = lin(_t(x), taps=tt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    assert [r[0] for r in tt.records] == ["l"]
    # perturb=True creates zero perturbations that require grad
    tp = TN.TapCollector(perturb=True)
    lin(_t(x), taps=tp)
    assert tp.perturbed and tp.eps["l"].requires_grad
    assert float(tp.eps["l"].abs().sum()) == 0.0


def test_dropout_and_norm():
    x = torch.ones(1000, 4, dtype=torch.float64)
    assert torch.equal(TN.dropout(x, 0.5, False), x)
    assert torch.equal(TN.dropout(x, 0.5, True, None), x)
    y = TN.dropout(x, 0.5, True, torch.Generator().manual_seed(0))
    assert set(np.unique(y.numpy())) <= {0.0, 2.0}
    assert 0.4 < float((y == 0).double().mean()) < 0.6
    assert isinstance(TN.make_norm(None, 4), TN.Identity)
    assert isinstance(TN.make_norm("layer", 4), TN.LayerNorm)
    assert isinstance(TN.make_norm("batch", 4), TN.BatchNorm)
    with pytest.raises(ValueError, match="Unknown normalization"):
        TN.make_norm("group", 4)


def test_subtree_helpers():
    p = {"adj": 1, "convs.0.lin.weight": 2, "convs.0.lin.bias": 3,
         "convs.1.lin.weight": 4}
    assert TN.get_subtree(p, ("convs", 0)) == {"convs.0.lin.weight": 2,
                                               "convs.0.lin.bias": 3}
    q = TN.set_subtree(p, ("convs", 1), {"convs.1.lin.weight": 9})
    assert q["convs.1.lin.weight"] == 9 and p["convs.1.lin.weight"] == 4


# --- utils/pytree.py --------------------------------------------------------

def test_named_leaves_order_and_round_trip():
    X, adj = _graph()
    jm = JM.STEGCN(F, H, C, 3, X, adj)
    jp = _jax_params(jm)
    tp = TP.params_from_numpy(jp, device="cpu")
    assert [k for k, _ in TP.named_leaves(tp)] == \
        [k for k, _ in JP.named_leaves(jp)]
    back = TP.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    mask = TP.posterior_mask(tp)
    assert mask["adj"] is False and mask["convs.0.lin.weight"] is True
    w, rest = TP.split_by_mask(tp, mask)
    assert set(rest) == {"adj"}
    assert set(TP.merge_split(w, rest)) == set(tp)
    np.testing.assert_array_equal(
        TP.tree_vector(w).numpy(),
        np.asarray(JP.tree_vector(JP.split_by_mask(
            jp, JP.posterior_mask(jp))[0])))
    assert TP.tree_size(w) == JP.tree_size(JP.split_by_mask(
        jp, JP.posterior_mask(jp))[0])


# --- ops --------------------------------------------------------------------

def test_adjacency_ops():
    rng = np.random.default_rng(2)
    a = rng.random((N, N))
    np.testing.assert_allclose(TA.normalize_adj(_t(a)).numpy(),
                               np.asarray(JA.normalize_adj(jnp.asarray(a))),
                               atol=ATOL)
    np.testing.assert_array_equal(
        TA.fill_diagonal(_t(a), 1.0).numpy(),
        np.asarray(JA.fill_diagonal(jnp.asarray(a), 1.0)))
    np.testing.assert_array_equal(TA.fill_diagonal_any(a, 0.0),
                                  np.asarray(JA.fill_diagonal_any(a, 0.0)))
    tr = np.array([1, 4, 7])
    np.testing.assert_array_equal(
        TA.train_adj_mask(N, tr, dtype=torch.float64).numpy(),
        np.asarray(JA.train_adj_mask(N, jnp.asarray(tr))))


@pytest.mark.parametrize("sign_grad", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_binarize_ste(sign_grad, masked):
    rng = np.random.default_rng(3)
    a, g = rng.random((N, N)), rng.standard_normal((N, N))
    mask = (rng.random((N, N)) > 0.5) * 1.0 if masked else None
    out_j, vjp = jax.vjp(lambda x: JA.binarize_ste(
        x, 0.5, None if mask is None else jnp.asarray(mask), sign_grad),
        jnp.asarray(a))
    x = _t(a).requires_grad_(True)
    out = TA.binarize_ste(x, 0.5, None if mask is None else _t(mask),
                          sign_grad)
    (gx,) = torch.autograd.grad(out, x, _t(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(gx.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_linalg_eigs():
    rng = np.random.default_rng(4)
    mats = [rng.standard_normal((k, k)) for k in (5, 5, 3)]
    mats = [m @ m.T for m in mats]
    for got, want in zip(TL.batched_eigvalsh([_t(m) for m in mats]),
                         JL.batched_eigvalsh([jnp.asarray(m) for m in mats])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)
    for (lg, wg), (lw, ww) in zip(
            TL.batched_symeig([_t(m) for m in mats]),
            JL.batched_symeig([jnp.asarray(m) for m in mats])):
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-10)
        # eigenvectors up to sign
        np.testing.assert_allclose(np.abs(wg.numpy()), np.abs(np.asarray(ww)),
                                   atol=1e-8)
    L, W = TL.symeig(_t(mats[0]))
    np.testing.assert_allclose(L.numpy(),
                               np.asarray(JL.symeig(jnp.asarray(mats[0]))[0]),
                               atol=1e-10)


def test_clip_gradient_at_ties_and_negative_roundoff():
    """max(x, 0) splits the gradient at an exact tie, as jnp.clip does,
    and passes none for negative round-off."""
    x = np.array([-1e-17, 0.0, 0.0, 2.0, -3.0])
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, min=0.0) * jnp.arange(
        1.0, 6.0)))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (got,) = torch.autograd.grad(
        torch.sum(TL.clip_min0(xt) * torch.arange(1.0, 6.0,
                                                   dtype=torch.float64)), xt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aggregate_dense_and_operator():
    rng = np.random.default_rng(5)
    a, x = rng.random((N, N)), rng.standard_normal((N, 4))
    np.testing.assert_allclose(aggregate(_t(a), _t(x)).numpy(), a @ x,
                               atol=ATOL)
    op = TM.FusedAdjOp(lambda s: 2 * s)
    assert torch.equal(aggregate(op, _t(x)), 2 * _t(x))


# --- models -----------------------------------------------------------------

def _pair(cls, fused, symmetric=True, seed=0, **kw):
    X, adj = _graph(seed)
    jm = getattr(JM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=symmetric, **kw)
    tm = getattr(TM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=symmetric, device="cpu",
                          dtype=torch.float64, **kw)
    jp = _jax_params(jm)
    if cls == "STEGCN":
        # soften the 0/1 adjacency so the threshold and STE are exercised,
        # with exact 0.5 entries where one direction keeps an edge
        rng = np.random.default_rng(seed + 1)
        jp["adj"] = np.where(rng.random((N, N)) < 0.15, 0.5,
                             jp["adj"] * 0.7 + 0.2)
    tp = TP.params_from_numpy(jp, device="cpu")
    return jm, tm, jp, tp


@pytest.mark.parametrize("cls,fused", [("STEGCN", False), ("STEGCN", True),
                                       ("GCN", False), ("GCN", True),
                                       ("GCN", "int8"), ("GCN", "auto")])
def test_model_forward_and_adj_gradient(cls, fused):
    jm, tm, jp, tp = _pair(cls, fused)
    idx = np.arange(0, N, 2)
    w = np.random.default_rng(9).standard_normal((len(idx), C))

    def jloss(p):
        return jnp.sum(jnp.tanh(jm.apply(p, jnp.asarray(idx))) * w)

    jv, jg = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray,
                                                              jp))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tv = torch.sum(torch.tanh(tm.apply(tp, torch.as_tensor(idx))) * _t(w))
    tg = dict(zip(tp, torch.autograd.grad(tv, list(tp.values()),
                                          allow_unused=True)))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-12)
    for name, leaf in JP.named_leaves(jg):
        got = tg[name]
        got = np.zeros_like(np.asarray(leaf)) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(leaf), atol=1e-10,
                                   err_msg=name)
    out_full = tm.apply(tp, None)
    assert out_full.shape == (N, C)
    np.testing.assert_array_equal(
        tm.full_adj(tp).detach().numpy(),
        np.asarray(jm.full_adj(jax.tree_util.tree_map(jnp.asarray, jp))))


def test_model_introspection_and_masked_update():
    jm, tm, jp, tp = _pair("STEGCN", True, train_masked_update=True,
                           train_nodes=np.arange(5))
    assert tm.tap_sites() == jm.tap_sites(jp)
    assert tm.last_layer_path() == jm.last_layer_path(jp)
    assert tm.first_tap_static and jm.first_tap_static
    np.testing.assert_array_equal(tm.grad_adj_mask.numpy(),
                                  np.asarray(jm.grad_adj_mask))
    assert list(tm.params()) == [k for k, _ in JP.named_leaves(jp)]
    np.testing.assert_array_equal(tm.params()["adj"].detach().numpy(),
                                  np.asarray(jm.init_adj))


def test_model_dropout_in_train_mode():
    _, tm, _, tp = _pair("STEGCN", True)
    tm.dropout_p = 0.5
    f_eval = tm.apply(tp, None)
    f1 = tm.apply(tp, None, generator=torch.Generator().manual_seed(1),
                  train=True)
    f2 = tm.apply(tp, None, generator=torch.Generator().manual_seed(1),
                  train=True)
    assert torch.equal(f1, f2) and not torch.allclose(f1, f_eval)


def test_init_adj_must_be_binary():
    X, adj = _graph()
    with pytest.raises(ValueError):
        TM.STEGCN(F, H, C, 2, X, adj * 0.5, device="cpu")
