"""Port parity for laplace/kron.py: ``Kron`` and ``KronDecomposed`` on the
same factors, torch against JAX in float64 (1e-10 relative).

The factor groups mix every structure the Laplace stack makes: a bias
([B]), weights ([B, A]), an exact-diagonal block (one 1-D factor, GAT's
attention vectors), and a weight with a 1-D factor. Eigenvectors of the
two packages may differ in sign, so the comparisons are of quantities
that do not depend on it (log-determinants, products, diagonals)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu.laplace.kron import Kron as JKron
from laplace_gnn_torch.laplace.kron import Kron as TKron

RTOL = 1e-10


def _spd(rng, n):
    a = rng.standard_normal((n, n))
    return a @ a.T + 0.5 * np.eye(n)


def _factors(seed=0):
    rng = np.random.default_rng(seed)
    return [[_spd(rng, 3)], [_spd(rng, 3), _spd(rng, 4)],
            [rng.random(5) + 0.1], [_spd(rng, 2), _spd(rng, 2)],
            [_spd(rng, 4), rng.random(3) + 0.2]]


def _pair(seed=0):
    f = _factors(seed)
    return (TKron([[torch.as_tensor(x) for x in g] for g in f]),
            JKron([[jnp.asarray(x) for x in g] for g in f]))


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-12)


P = 3 + 12 + 5 + 4 + 12


def _w(ndim, seed=1):
    shape = {1: (P,), 2: (4, P), 3: (2, 3, P)}[ndim]
    return np.random.default_rng(seed).standard_normal(shape)


def test_kron_algebra_and_dense_maps():
    t, j = _pair()
    _close(t.logdet(), j.logdet())
    _close(t.diag(), j.diag())
    _close(t.to_matrix(), j.to_matrix())
    for nd in (1, 2, 3):
        _close(t.bmm(torch.as_tensor(_w(nd))), j.bmm(jnp.asarray(_w(nd))))
    t2, j2 = _pair(3)
    _close((t + t2 * 0.7).to_matrix(), (j + j2 * 0.7).to_matrix())
    _close((2.5 * t).logdet(), (2.5 * j).logdet())
    assert len(t) == len(j) == 5
    with pytest.raises(ValueError, match="decomposition"):
        t.bmm(torch.as_tensor(_w(1)), exponent=-1)


@pytest.mark.parametrize("damping", [False, True])
@pytest.mark.parametrize("deltas", [0.3, [0.7], [0.1, 0.2, 0.3, 0.4, 0.5]],
                         ids=["scalar", "one", "per-block"])
def test_kron_decomposed(damping, deltas):
    t, j = _pair()
    td = t.decompose(damping=damping) * 1.7 + torch.as_tensor(
        np.asarray(deltas, dtype=np.float64))
    jd = j.decompose(damping=damping) * 1.7 + jnp.asarray(deltas)
    _close(td.deltas, jd.deltas)
    _close(td.logdet(), jd.logdet())
    _close(td.diag(), jd.diag())
    for exponent in (1, -1, -0.5):
        _close(td.to_matrix(exponent), jd.to_matrix(exponent))
        for nd in (1, 2, 3):
            _close(td.bmm(torch.as_tensor(_w(nd)), exponent),
                   jd.bmm(jnp.asarray(_w(nd)), exponent))
    W = _w(3)
    _close(td.inv_square_form(torch.as_tensor(W)),
           jd.inv_square_form(jnp.asarray(W)))
    # the undamped decomposition represents the same matrix as its Kron
    if not damping:
        _close(t.decompose().to_matrix(), t.to_matrix())
    with pytest.raises(ValueError, match="Invalid shape of delta"):
        td + torch.ones(3)
    with pytest.raises(ValueError, match="scalar"):
        td * torch.ones(2)
