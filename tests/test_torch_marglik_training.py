"""Port parity for the online marglik trainer, laplace/marglik.py
(``marglik_training``), torch against JAX in float64 on the CPU.

Each run is held to JAX's at 1e-8 (Adam or SGD steps on the weights and
Adam on the hyperparameters): the ``margliks`` and ``losses`` traces, the
final prior precision (and sigma noise), the returned best-marglik
parameters and the refitted Laplace's log marglik. Array and dict
loaders; Kron, Diag and Full; scalar, layerwise and diagonal priors; a
learning-rate schedule; an MLP and a fused STE-GCN with its adjacency
fixed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu import nn as JNN
from laplace_gnn_tpu.laplace.marglik import marglik_training as j_train
from laplace_gnn_tpu.utils.data import ArrayLoader as JLoader
from laplace_gnn_torch import models as TM
from laplace_gnn_torch import nn as TNN
from laplace_gnn_torch.laplace.marglik import marglik_training as t_train
from laplace_gnn_torch.utils.data import ArrayLoader
from laplace_gnn_torch.utils.pytree import params_from_numpy

RTOL = 1e-8
D, H, C, M = 3, 8, 2, 20


def _close(t, j, rtol=RTOL, atol=1e-10):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _same_run(t_out, j_out):
    tla, tp, tml, tls = t_out
    jla, jp, jml, jls = j_out
    assert len(tml) == len(jml) and len(tls) == len(jls)
    _close(np.array(tml), np.array(jml))
    _close(np.array(tls), np.array(jls))
    _close(tla.prior_precision, jla.prior_precision)
    _close(tla.sigma_noise, jla.sigma_noise)
    flat = {}
    for k, v in jax.tree_util.tree_leaves_with_path(jp):
        flat[".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in k)] = v
    assert set(tp) == set(flat)
    for k in tp:
        _close(tp[k], flat[k])
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())


def _mlp(seed, likelihood="classification", dict_input=False, c=C):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M, D))
    y = (rng.integers(0, c, M) if likelihood == "classification"
         else rng.standard_normal((M, c)))
    jm = JNN.MLP([D, H, c], act="tanh")
    tm = TNN.MLP([D, H, c], act="tanh", device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tp = params_from_numpy(jp, device="cpu")
    if dict_input:
        jm, tm = JNN.DictInputModel(jm), TNN.DictInputModel(tm)
        jl = JLoader({"input_ids": jnp.asarray(X), "labels": jnp.asarray(y)},
                     batch_size=10)
        tl = ArrayLoader({"input_ids": X, "labels": y}, batch_size=10,
                         device="cpu")
    else:
        jl = JLoader(jnp.asarray(X), jnp.asarray(y), batch_size=10)
        tl = ArrayLoader(X, y, batch_size=10, device="cpu")
    return (jm, jax.tree_util.tree_map(jnp.asarray, jp), jl), (tm, tp, tl)


@pytest.mark.parametrize("dict_input", [False, True])
@pytest.mark.parametrize("structure,prior", [("kron", "layerwise"),
                                             ("diag", "diag"),
                                             ("full", "scalar")])
def test_classification_runs_match_jax(structure, prior, dict_input):
    (jm, jp, jl), (tm, tp, tl) = _mlp(1, dict_input=dict_input)
    kw = dict(hessian_structure=structure, prior_structure=prior,
              n_epochs=6, n_epochs_burnin=2, marglik_frequency=2,
              n_hypersteps=3, prior_prec_init=0.5,
              optimizer_kwargs={"lr": 0.05})
    before = {k: v.clone() for k, v in tp.items()}
    t_out = t_train(tm, tp, tl, device="cpu", **kw)
    j_out = j_train(jm, jp, jl, **kw)
    _same_run(t_out, j_out)
    assert len(t_out[2]) == 3 and len(t_out[3]) == 6
    assert all(torch.equal(before[k], tp[k]) for k in tp)
    if dict_input:
        X = tl.X["input_ids"][:5]
        probs = t_out[0]({"input_ids": X}, link_approx="probit")
        _close(probs, j_out[0]({"input_ids": jnp.asarray(X.numpy())},
                               link_approx="probit"))


def test_regression_sgd_with_a_schedule_matches_jax():
    """SGD with momentum under a decaying schedule; sigma noise is tuned
    beside the prior, then held fixed."""
    (jm, jp, jl), (tm, tp, tl) = _mlp(2, likelihood="regression", c=1)
    for fix in (False, True):
        kw = dict(likelihood="regression", hessian_structure="kron",
                  n_epochs=4, marglik_frequency=1, n_hypersteps=2,
                  optimizer="sgd", optimizer_kwargs={"lr": 0.02,
                                                     "momentum": 0.9},
                  sigma_noise_init=0.7, fix_sigma_noise=fix,
                  temperature=0.8)
        t_out = t_train(tm, tp, tl, device="cpu",
                        scheduler=lambda t: 0.02 * 0.8 ** t, **kw)
        j_out = j_train(jm, jp, jl,
                        scheduler=lambda t: 0.02 * jnp.power(
                            0.8, jnp.asarray(t, jnp.float64)),
                        **kw)
        _same_run(t_out, j_out)
        moved = float(t_out[0].sigma_noise) != 0.7
        assert moved is not fix


def test_fused_stegcn_with_fixed_adjacency_matches_jax():
    rng = np.random.default_rng(3)
    n, f, c = 24, 5, 3
    X = rng.standard_normal((n, f))
    a = (rng.random((n, n)) < 0.2).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, c, n)
    kw = dict(dropout_p=0.0, fused=True, symmetric=True)
    jm = JM.STEGCN(f, 6, c, 2, X, adj, **kw)
    tm = TM.STEGCN(f, 6, c, 2, X, adj, device="cpu", dtype=torch.float64,
                   **kw)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    tr = np.arange(16)
    kw = dict(n_epochs=4, marglik_frequency=2, n_hypersteps=2,
              optimizer_kwargs={"lr": 0.01})
    t_out = t_train(tm, params_from_numpy(jp, device="cpu"),
                    ArrayLoader(tr, y[tr], device="cpu"), device="cpu", **kw)
    j_out = j_train(jm, jax.tree_util.tree_map(jnp.asarray, jp),
                    JLoader(jnp.asarray(tr), jnp.asarray(y[tr])), **kw)
    _same_run(t_out, j_out)
    # the adjacency is frozen: returned as it came
    _close(t_out[1]["adj"], jp["adj"], rtol=0, atol=0)


def test_rejects_params_off_device_and_unknown_optimizer():
    _, (tm, tp, tl) = _mlp(0)
    with pytest.raises(ValueError, match="not supported"):
        t_train(tm, tp, tl, optimizer="lbfgs", n_epochs=1, device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        t_train(tm, tp, tl, n_epochs=1, device="meta")
