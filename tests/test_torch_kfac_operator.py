"""Port parity for curvature/kfac.py::KFACOperator, mirroring
tests/test_kfac_operator.py on a small GCN (the port has no MLP yet):
products through the factors, matrix functionals, accumulation over
batches, the state_dict round trip, torch against JAX in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.curvature import KFACOperator as JOp
from laplace_gnn_tpu.curvature import kfac as JK
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.curvature import KFACOperator as TOp
from laplace_gnn_torch.curvature import kfac as TK
from laplace_gnn_torch.utils.pytree import params_from_numpy

N, F, H, C = 24, 5, 6, 3
M = 10


def _setup(likelihood="classification", seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    adj = (rng.random((N, N)) < 0.15).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = (rng.integers(0, C, N) if likelihood == "classification"
         else rng.standard_normal((N, C)))
    jm = JM.GCN(F, H, C, 2, X, adj, dropout_p=0.0)
    tm = TM.GCN(F, H, C, 2, X, adj, dropout_p=0.0, device="cpu",
                dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tm, jp, y


def _ops(likelihood="classification", batches=((0, M),), **kw):
    jm, tm, jp, y = _setup(likelihood)
    jdata = [(jnp.arange(a, b), jnp.asarray(y[a:b])) for a, b in batches]
    tdata = [(torch.arange(a, b), torch.as_tensor(y[a:b]))
             for a, b in batches]
    jop = JOp(jm, jax.tree_util.tree_map(jnp.asarray, jp), jdata, likelihood,
              **kw)
    top = TOp(tm, params_from_numpy(jp, device="cpu"), tdata, likelihood,
              **kw)
    return jop, top, (tm, params_from_numpy(jp, device="cpu"), tdata)


@pytest.mark.parametrize("fisher_type", ["type-2", "empirical",
                                         "type-2-sketch"])
def test_matvec_matches_dense(fisher_type, monkeypatch):
    monkeypatch.setattr(TK, "_sketch_projection",
                        lambda seed, C_, k, dtype, device=None: torch.tensor(
                            np.asarray(JK._sketch_projection(
                                seed, C_, k, jnp.float64)), dtype=dtype))
    jop, top, _ = _ops(fisher_type=fisher_type, sketch_size=2)
    assert top.shape == jop.shape
    dense = top.to_dense()
    np.testing.assert_allclose(dense.numpy(), np.asarray(jop.to_dense()),
                               rtol=1e-10, atol=1e-13)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(top.shape[1])
    np.testing.assert_allclose((top @ v).numpy(), dense.numpy() @ v,
                               atol=1e-10)
    np.testing.assert_allclose((top @ v).numpy(), np.asarray(jop @ v),
                               rtol=1e-10, atol=1e-12)
    V = rng.standard_normal((top.shape[1], 3))
    np.testing.assert_allclose((top @ V).numpy(), dense.numpy() @ V,
                               atol=1e-10)
    np.testing.assert_allclose(top.matmat(torch.as_tensor(V)).numpy(),
                               np.asarray(jop.matmat(jnp.asarray(V))),
                               rtol=1e-10, atol=1e-12)


def test_matrix_functionals():
    """Regression: the loss Hessian is full rank, so det and logdet of
    the raw factors are defined."""
    jop, top, _ = _ops("regression")
    dense = top.to_dense().numpy()
    np.testing.assert_allclose(float(top.trace), np.trace(dense), rtol=1e-10)
    np.testing.assert_allclose(float(top.frobenius_norm),
                               np.linalg.norm(dense), rtol=1e-10)
    sign, ld = np.linalg.slogdet(dense)
    assert sign > 0
    np.testing.assert_allclose(float(top.logdet), ld, rtol=1e-8)
    np.testing.assert_allclose(float(top.det), np.exp(ld), rtol=1e-8)
    for name in ("trace", "frobenius_norm", "logdet", "det"):
        np.testing.assert_allclose(float(getattr(top, name)),
                                   float(getattr(jop, name)), rtol=1e-10,
                                   err_msg=name)


def test_batch_accumulation():
    """Factors accumulated over two node batches (seeds seed + i) are the
    sum of each batch's factors, normalized by the total N, as in JAX. (A
    GNN's A covers the whole graph in every batch, so two batches are not
    one concatenated batch, unlike an MLP's.)"""
    batches = ((0, 4), (4, M))
    jop, top, (tm, tp, tdata) = _ops(batches=batches,
                                     fisher_type="empirical")
    assert top.N == M
    np.testing.assert_allclose(top.to_dense().numpy(),
                               np.asarray(jop.to_dense()), rtol=1e-10,
                               atol=1e-13)
    parts = [TK.compute_kfac_factors(tm, tp, X, y, "classification",
                                     fisher_type="empirical", N=M, seed=i)
             for i, (X, y) in enumerate(tdata)]
    np.testing.assert_allclose(top.to_dense().numpy(),
                               (parts[0] + parts[1]).to_matrix().numpy(),
                               atol=1e-14)


def test_state_dict_roundtrip():
    jop, top, (tm, tp, tdata) = _ops()
    state = top.state_dict()
    jstate = jop.state_dict()
    assert {k: v for k, v in state.items() if k != "kfacs"} == {
        k: v for k, v in jstate.items() if k != "kfacs"}
    for gt_, gj in zip(state["kfacs"], jstate["kfacs"]):
        for a, b in zip(gt_, gj):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-13)
    # restore without any data, from the port's state or from JAX's arrays
    for st in (state, {**state, "kfacs": jstate["kfacs"]}):
        op2 = TOp.from_state_dict(st, tm, tp)
        np.testing.assert_allclose(op2.to_dense().numpy(),
                                   top.to_dense().numpy(), rtol=1e-10,
                                   atol=1e-13)
        assert op2.shape == top.shape
    op3 = TOp(tm, tp, tdata, "classification", fisher_type="empirical")
    with pytest.raises(ValueError, match="fisher_type"):
        op3.load_state_dict(state)
    op4 = TOp(tm, tp, None, "classification", N=M)
    op4.load_state_dict(state)
    np.testing.assert_array_equal(op4.to_dense().numpy(),
                                  top.to_dense().numpy())


def test_no_data_raises():
    _, tm, jp, _ = _setup()
    op = TOp(tm, params_from_numpy(jp, device="cpu"), None,
             "classification", N=M)
    with pytest.raises(ValueError, match="no data"):
        _ = op.kron


def test_check_deterministic():
    _, tm, jp, y = _setup()
    TOp(tm, params_from_numpy(jp, device="cpu"),
        [(torch.arange(M), torch.as_tensor(y[:M]))], "classification",
        check_deterministic=True)


def test_last_layer_shape():
    jop, top, _ = _ops(last_layer=True)
    assert top.shape == jop.shape == (H * C + C, H * C + C)
    dense = top.to_dense()
    assert tuple(dense.shape) == top.shape
    np.testing.assert_allclose(dense.numpy(), np.asarray(jop.to_dense()),
                               rtol=1e-10, atol=1e-13)
