"""Port parity for the Lanczos spectra, the inverse operators and the
stochastic estimators: curvature/spectrum.py, curvature/inverse.py and
curvature/estimators.py, torch against JAX in float64 on the CPU.

The operator is the JAX tests' 30 x 30 PSD matrix (``A A^T + 5 I``, A from
``PRNGKey(0)``). JAX's start vectors and probes enter the port through its
private draw functions (``spectrum._start_vector``,
``estimators._probes``): each port seed maps to the JAX key that the JAX
function folds at the same place. Tolerances: Lanczos eigenvalues 1e-8
(eigenvectors up to sign); CG, LSMR, Neumann, the KFAC inverse and the
estimators 1e-10 relative, and CG and LSMR run the same number of
iterations as JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import curvature as JC
from laplace_gnn_tpu import nn as JNN
from laplace_gnn_tpu.curvature import estimators as JE
from laplace_gnn_tpu.curvature import inverse as JI
from laplace_gnn_tpu.curvature import spectrum as JS
from laplace_gnn_torch import curvature as TC
from laplace_gnn_torch import nn as TNN
from laplace_gnn_torch.curvature import base as TB
from laplace_gnn_torch.curvature import estimators as TE
from laplace_gnn_torch.curvature import inverse as TI
from laplace_gnn_torch.curvature import spectrum as TS
from laplace_gnn_torch.curvature.kfac import _fold_seed
from laplace_gnn_torch.utils.pytree import params_from_numpy

RTOL = 1e-10
EIG_RTOL = 1e-8
BOUNDARY = 2 ** 31 - 1


def _close(t, j, rtol=RTOL, atol=1e-12):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


def _t(a):
    return torch.as_tensor(np.array(a))


class TDense(TB.LinearOperator):
    def __init__(self, A):
        super().__init__(tuple(A.shape), A.dtype, device="cpu")
        self.A = A

    def matvec(self, v):
        return self.A @ v

    def rmatvec(self, v):
        return self.A.T @ v


class JDense(JC.LinearOperator):
    def __init__(self, A):
        super().__init__(A.shape, A.dtype)
        self.A = jnp.asarray(A)

    def matvec(self, v):
        return self.A @ v

    def rmatvec(self, v):
        return self.A.T @ v


@pytest.fixture
def psd():
    A = jax.random.normal(jax.random.PRNGKey(0), (30, 30))
    M = np.asarray(A @ A.T + 5 * jnp.eye(30))
    return TDense(_t(M)), JDense(M), M


def _keys(seeds=range(4), folds=(*range(8), BOUNDARY)):
    """Port seed -> the JAX key of the same place: a base seed s is
    ``PRNGKey(s)``, its folds ``fold_in(PRNGKey(s), n)``."""
    out = {}
    for s in seeds:
        out[s] = jax.random.PRNGKey(s)
        for n in folds:
            out[_fold_seed(s, n)] = jax.random.fold_in(jax.random.PRNGKey(s),
                                                       n)
    return out


@pytest.fixture
def jax_draws(monkeypatch):
    """Replay JAX's start vectors and probes in the port."""
    keys = _keys()

    def start(seed, P, dtype, device):
        return _t(jax.random.normal(keys[seed], (P,), jnp.float64))

    def probes(seed, shape, distribution, dtype, device):
        return _t(JE.random_probes(keys[seed], tuple(shape), distribution,
                                   jnp.float64))

    monkeypatch.setattr(TS, "_start_vector", start)
    monkeypatch.setattr(TE, "_probes", probes)
    return keys


def _same_up_to_sign(t, j, rtol=EIG_RTOL):
    t = t.detach().numpy()
    j = np.asarray(j)
    signs = np.sign(np.sum(t * j, axis=0))
    np.testing.assert_allclose(t * signs, j, rtol=rtol, atol=1e-9)


# -- Lanczos -----------------------------------------------------------------

@pytest.mark.parametrize("k", [10, 30])
def test_lanczos_tridiag_and_eigh_match_jax(psd, jax_draws, k):
    top, jop, M = psd
    a, b, Q = TS.lanczos_tridiag(top, k, seed=1)
    ja, jb, jQ = JS.lanczos_tridiag(jop, k, key=jax.random.PRNGKey(1))
    _close(a, ja, rtol=EIG_RTOL)
    _close(b, jb, rtol=EIG_RTOL)
    _close(Q, jQ, rtol=EIG_RTOL, atol=1e-9)
    evals, evecs = TS.lanczos_eigh(top, k, seed=1)
    jevals, jevecs = JS.lanczos_eigh(jop, k, key=jax.random.PRNGKey(1))
    _close(evals, jevals, rtol=EIG_RTOL)
    _same_up_to_sign(evecs, jevecs)
    if k == 30:
        _close(evals, np.linalg.eigvalsh(M), rtol=1e-6)
    v0 = np.random.default_rng(0).standard_normal(30)
    _close(TS.lanczos_tridiag(top, 5, v0=_t(v0))[0],
           JS.lanczos_tridiag(jop, 5, v0=jnp.asarray(v0))[0], rtol=EIG_RTOL)


def test_lanczos_own_draw_finds_the_spectrum(psd):
    top, _, M = psd
    evals, evecs = TS.lanczos_eigh(top, 30)
    _close(evals, np.linalg.eigvalsh(M), rtol=1e-6)
    _close(evecs.T @ evecs, np.eye(30), atol=1e-8)


@pytest.mark.parametrize("ncv", [8, 30])
def test_fast_lanczos_matches_jax(psd, jax_draws, ncv):
    """At full depth the recurrence loses orthogonality and amplifies
    rounding: JAX's own scan and unrolled programs agree there only on the
    top Ritz value (1e-6) and the bottom one (1e-3, its test's
    tolerances), and so do the two packages."""
    top, jop, M = psd
    evals, evecs = TS.fast_lanczos(top, ncv, seed=2)
    jevals, jevecs = JS.fast_lanczos(jop, ncv, key=jax.random.PRNGKey(2))
    if ncv == 8:
        _close(evals, jevals, rtol=EIG_RTOL)
        _same_up_to_sign(evecs, jevecs)
    else:
        _close(evals[-1], jevals[-1], rtol=EIG_RTOL)
        _close(evals[0], jevals[0], rtol=1e-3)
        _close(evals[-1], np.linalg.eigvalsh(M)[-1], rtol=1e-4)


def test_boundaries_match_jax(psd, jax_draws):
    top, jop, M = psd
    for fn, jfn in ((TS.approximate_boundaries, JS.approximate_boundaries),
                    (TS.approximate_boundaries_abs,
                     JS.approximate_boundaries_abs)):
        for kw in ({"ncv": 30}, {"tol": 1e-2}, {"boundaries": (0.0, None),
                                                 "ncv": 12}):
            got = fn(top, seed=3, **kw)
            want = jfn(jop, key=jax.random.PRNGKey(3), **kw)
            _close(np.array(got), np.array(want), rtol=EIG_RTOL)
    true = np.linalg.eigvalsh(M)
    _close(np.array(TS.approximate_boundaries(top, ncv=30)),
           [true[0], true[-1]], rtol=1e-3)
    assert TS.approximate_boundaries(top, boundaries=(1.0, 2.0)) == (1.0, 2.0)
    assert [TS._boundary_ncv(*a) for a in ((1e-2, 1000, None),
                                           (1e-4, 1000, None),
                                           (0.0, 1000, None),
                                           (1e-4, 50, None),
                                           (1e-4, 1000, 32))] == \
        [JS._boundary_ncv(*a) for a in ((1e-2, 1000, None),
                                        (1e-4, 1000, None),
                                        (0.0, 1000, None), (1e-4, 50, None),
                                        (1e-4, 1000, 32))] == \
        [20, 200, 128, 50, 32]


def test_spectrum_densities_match_jax(psd, jax_draws):
    top, jop, M = psd
    g, d = TS.lanczos_approximate_spectrum(top, ncv=8, num_points=256,
                                           num_repeats=3, seed=1)
    jg, jd = JS.lanczos_approximate_spectrum(jop, ncv=8, num_points=256,
                                             num_repeats=3,
                                             key=jax.random.PRNGKey(1))
    _close(g, jg, rtol=EIG_RTOL)
    _close(d, jd, rtol=EIG_RTOL, atol=1e-12)
    g, d = TS.lanczos_approximate_log_spectrum(top, ncv=8, num_points=256,
                                               num_repeats=2, seed=2)
    jg, jd = JS.lanczos_approximate_log_spectrum(jop, ncv=8, num_points=256,
                                                 num_repeats=2,
                                                 key=jax.random.PRNGKey(2))
    _close(g, jg, rtol=EIG_RTOL)
    _close(d, jd, rtol=EIG_RTOL, atol=1e-12)
    cached = TS.LanczosApproximateSpectrumCached(top, ncv=8, seed=1)
    jcached = JS.LanczosApproximateSpectrumCached(jop, ncv=8,
                                                  key=jax.random.PRNGKey(1))
    for n in (2, 3):
        _close(np.stack(cached.approximate_spectrum(num_repeats=n,
                                                    num_points=128)),
               np.stack(jcached.approximate_spectrum(num_repeats=n,
                                                     num_points=128)),
               rtol=EIG_RTOL, atol=1e-12)
    assert len(cached._iters) == 3
    lcached = TS.LanczosApproximateLogSpectrumCached(top, ncv=8, seed=2)
    ljcached = JS.LanczosApproximateLogSpectrumCached(
        jop, ncv=8, key=jax.random.PRNGKey(2))
    _close(np.stack(lcached.approximate_log_spectrum(num_repeats=2,
                                                     num_points=128)),
           np.stack(ljcached.approximate_log_spectrum(num_repeats=2,
                                                      num_points=128)),
           rtol=EIG_RTOL, atol=1e-12)
    g, d = TS.lanczos_spectrum(top, k=20, n_probes=3, n_bins=50, seed=0)
    jg, jd = JS.lanczos_spectrum(jop, k=20, n_probes=3, n_bins=50)
    _close(g, jg, rtol=EIG_RTOL)
    _close(d, jd, rtol=EIG_RTOL, atol=1e-12)


def test_spectrum_density_with_own_draws(psd):
    top, _, M = psd
    grid, density = TS.lanczos_approximate_spectrum(top, ncv=30,
                                                    num_points=512,
                                                    num_repeats=3)
    assert np.all(density >= -1e-9)
    np.testing.assert_allclose(np.trapezoid(density, grid), 1.0, atol=0.1)
    np.testing.assert_allclose(np.trapezoid(grid * density, grid),
                               np.trace(M) / 30, rtol=0.1)
    grid, density = TS.lanczos_approximate_log_spectrum(top, ncv=30,
                                                        num_points=512,
                                                        num_repeats=2)
    assert np.all(grid > 0)
    np.testing.assert_allclose(np.trapezoid(density * grid, np.log(grid)),
                               1.0, atol=0.15)
    grid, density = TS.lanczos_spectrum(top, k=20, n_probes=3, n_bins=50)
    np.testing.assert_allclose(np.trapezoid(density, grid), 1.0, atol=0.15)


# -- CG, LSMR, Neumann -------------------------------------------------------

def _jax_cg_iterations(jop, b, tol, maxiter):
    """The iterations JAX's cg runs: the first maxiter after which its
    iterate stops changing."""
    prev = None
    for k in range(maxiter + 1):
        x, _ = jax.scipy.sparse.linalg.cg(jop.matvec, b, tol=tol, maxiter=k)
        if prev is not None and np.array_equal(np.asarray(x), prev):
            return k - 1
        prev = np.asarray(x)
    return maxiter


@pytest.mark.parametrize("tol,final_rtol", [(1e-2, RTOL), (1e-6, 3e-8),
                                            (1e-10, RTOL)])
def test_cg_iterates_and_count_match_jax(psd, tol, final_rtol):
    """The iterates of the first 12 steps agree at 1e-10, and the
    iteration counts exactly. Between step 12 and convergence CG loses
    orthogonality and amplifies the last-bit differences of the two
    libraries' matvecs: a run that tol stops there (tol 1e-6, 20 steps)
    read 2.5e-9 of its largest entry in this comparison (float64, x86
    CPU) and is held at 3e-8; a converged one (2.1e-12) at 1e-10."""
    top, jop, M = psd
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (30,)))
    for maxiter, rtol in ((1, RTOL), (3, RTOL), (7, RTOL), (12, RTOL),
                          (60, final_rtol)):
        x, _ = TI.cg(top.matvec, _t(b), tol=tol, maxiter=maxiter)
        jx, _ = jax.scipy.sparse.linalg.cg(jop.matvec, jnp.asarray(b),
                                           tol=tol, maxiter=maxiter)
        # relative to the iterate's largest entry
        _close(x, jx, rtol=rtol, atol=rtol * float(np.abs(jx).max()))
    _, k = TI.cg(top.matvec, _t(b), tol=tol, maxiter=60)
    assert k == _jax_cg_iterations(jop, jnp.asarray(b), tol, 60)
    # maxiter defaults to 10 * size, as in JAX
    jx = jax.scipy.sparse.linalg.cg(jop.matvec, jnp.asarray(b), tol=tol)[0]
    _close(TI.cg(top.matvec, _t(b), tol=tol)[0], jx, rtol=final_rtol,
           atol=final_rtol * float(np.abs(jx).max()))


def test_cg_inverse_operator_matches_jax(psd):
    top, jop, M = psd
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (30,)))
    for kw in ({"tol": 1e-10, "maxiter": 60}, {"tol": 1e-4, "damping": 0.5},
               {"tol": 1e-10, "maxiter": 4}):
        inv, jinv = TC.CGInverseOperator(top, **kw), \
            JC.CGInverseOperator(jop, **kw)
        _close(inv.matvec(_t(v)), jinv.matvec(jnp.asarray(v)))
    inv = TC.CGInverseOperator(top, tol=1e-1)
    inv.set_cg_hyperparameters(tol=1e-10, maxiter=200, damping=0.0)
    _close(M @ inv.matvec(_t(v)).numpy(), v, atol=1e-6)
    assert inv.maxiter == 200 and TC.CGInverseOperator(top).maxiter == 30


def _lsmr_cases():
    rng = np.random.default_rng(0)
    Mq = rng.standard_normal((12, 12))
    spd = Mq @ Mq.T + 0.5 * np.eye(12)
    rng1 = np.random.default_rng(1)
    rect = rng1.standard_normal((20, 8))
    rng2 = np.random.default_rng(2)
    damped = rng2.standard_normal((15, 10))
    rng3 = np.random.default_rng(3)
    sing = rng3.standard_normal((10, 3)) @ rng3.standard_normal((3, 6))
    return {"spd": (spd, 0.0, 400), "rect": (rect, 0.0, 400),
            "damped": (damped, 0.7, 600), "singular": (sing, 0.0, 600)}


@pytest.mark.parametrize("case", list(_lsmr_cases()))
def test_lsmr_matches_jax(case):
    A, damp, maxiter = _lsmr_cases()[case]
    b = np.random.default_rng(9).standard_normal(A.shape[0])
    top, jop = TDense(_t(A)), JDense(A)
    # converged, and cut after 5 steps: the iterates at 1e-10; atol 1e-4
    # stops "spd" mid-convergence (15 of 19 steps), where the recurrence
    # amplifies the last-bit differences of the two libraries' matvecs:
    # the same count, and the iterate, which read 4.2e-8 in this
    # comparison (float64, x86 CPU), at 5e-7; the other cases converge
    # within atol 1e-4 and stay at 1e-10
    converged = None
    for atol, steps in ((1e-12, maxiter), (1e-12, 5), (1e-4, maxiter)):
        x, k = TI.lsmr(top.matvec, top.rmatvec, _t(b), damp=damp, atol=atol,
                       maxiter=steps)
        jx, jk = JI.lsmr(jop.matvec, jop.rmatvec, jnp.asarray(b), damp=damp,
                         atol=atol, maxiter=steps)
        assert k == int(jk)
        converged = k if converged is None else converged
        midway = atol > 1e-12 and k < converged
        _close(x, jx, rtol=5e-7 if midway else RTOL)
    inv = TC.LSMRInverseOperator(top, damp=damp, atol=1e-12, maxiter=maxiter)
    x, info = inv.matvec_with_info(_t(b))
    jx, jinfo = JC.LSMRInverseOperator(jop, damp=damp, atol=1e-12,
                                       maxiter=maxiter).matvec_with_info(
        jnp.asarray(b))
    _close(x, jx)
    _close(inv @ _t(b), jx)
    assert info["iterations"] == int(jinfo["iterations"])
    _close(info["residual_norm"], jinfo["residual_norm"])
    expect = np.linalg.solve(A.T @ A + damp ** 2 * np.eye(A.shape[1]),
                             A.T @ b) if damp else \
        np.linalg.lstsq(A, b, rcond=None)[0]
    np.testing.assert_allclose(x.numpy(), expect, atol=1e-6)


def test_lsmr_setters_and_info(psd):
    top, jop, M = psd
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (30,)))
    ls = TC.LSMRInverseOperator(top, damp=2.0, atol=1e-12, maxiter=500)
    assert ls.shape == (30, 30) and \
        TC.LSMRInverseOperator(top).maxiter == 120
    x, info = ls.matvec_with_info(_t(v))
    r = M @ x.numpy() - v
    np.testing.assert_allclose(
        float(info["residual_norm"]),
        np.sqrt(r @ r + 4.0 * float(x @ x)), rtol=1e-6)
    ls.set_lsmr_hyperparameters(damp=0.0, atol=1e-10, maxiter=1)
    assert ls.matvec_with_info(_t(v))[1]["iterations"] == 1


def test_neumann_matches_jax(psd):
    top, jop, M = psd
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (30,)))
    lmax = float(np.linalg.eigvalsh(M).max())
    inv = TC.NeumannInverseOperator(top, num_terms=50, scale=1.0 / lmax)
    _close(inv.matvec(_t(v)), JC.NeumannInverseOperator(
        jop, num_terms=50, scale=1.0 / lmax).matvec(jnp.asarray(v)))
    inv.set_neumann_hyperparameters(num_terms=3000)
    _close(M @ inv.matvec(_t(v)).numpy(), v, atol=1e-4)
    inv.set_neumann_hyperparameters(scale=1.0, num_terms=400)
    with pytest.raises(ValueError, match="NaNs or Infs"):
        inv.matvec(_t(v))
    inv.set_neumann_hyperparameters(check_nan=False)
    assert not bool(torch.isfinite(inv.matvec(_t(v))).all())


# -- KFAC inverse ------------------------------------------------------------

def _krons():
    jm = JNN.MLP([3, 4, 2], act="tanh")
    jp = jm.init(jax.random.PRNGKey(0))
    X = jax.random.normal(jax.random.PRNGKey(1), (6, 3))
    y = jax.random.randint(jax.random.PRNGKey(2), (6,), 0, 2)
    tm = TNN.MLP([3, 4, 2], act="tanh", device="cpu", dtype=torch.float64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jk = JC.compute_kfac_factors(jm, jp, X, y, "classification", N=6)
    tk = TC.compute_kfac_factors(tm, tp, _t(X), _t(y), "classification", N=6)
    return tk, jk


@pytest.mark.parametrize("method", ["plain", "heuristic", "exact"])
@pytest.mark.parametrize("damping", [0.1, 1.0])
def test_kfac_inverse_matches_jax(method, damping):
    """(The softmax's output-side factors are singular: with no damping
    the inverse is not defined.)"""
    tk, jk = _krons()
    inv = TC.KFACInverseOperator(tk, damping=damping, damping_method=method)
    jinv = JC.KFACInverseOperator(jk, damping=damping,
                                  damping_method=method)
    P = int(sum(np.prod([f.shape[0] for f in g]) for g in tk.kfacs))
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (P,)))
    out = inv.matvec(_t(v))
    _close(out, jinv.matvec(jnp.asarray(v)))
    if method == "exact":
        expected, cur = np.zeros(P), 0
        for g in tk.kfacs:
            blk = (g[0].numpy() if len(g) == 1
                   else np.kron(g[0].numpy(), g[1].numpy()))
            n = blk.shape[0]
            expected[cur:cur + n] = np.linalg.solve(
                blk + damping * np.eye(n), v[cur:cur + n])
            cur += n
        _close(out, expected, rtol=1e-8)
    for exponent in (-1.0, -0.5):
        for t, j in zip(TI.kfac_inverse_factors(tk, damping, method,
                                                exponent),
                        JI.kfac_inverse_factors(jk, damping, method,
                                                exponent)):
            if len(t) == 5:      # exact: eigenbases up to sign
                _same_up_to_sign(t[0], j[0], rtol=1e-9)
                _same_up_to_sign(t[2], j[2], rtol=1e-9)
                t, j = t[1::2], j[1::2]
            for a, b in zip(t, j):
                _close(a, b, atol=1e-11)


def test_kfac_inverse_state_dict_and_errors():
    tk, _ = _krons()
    inv = TC.KFACInverseOperator(tk, damping=0.1, damping_method="exact")
    P = int(sum(np.prod([f.shape[0] for f in g]) for g in tk.kfacs))
    v = torch.randn(P, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    back = TC.KFACInverseOperator.from_state_dict(inv.state_dict())
    _close(back.matvec(v), inv.matvec(v).numpy(), rtol=1e-12)
    other = TC.KFACInverseOperator(tk, damping=9.0)
    other.load_state_dict(inv.state_dict())
    assert other.damping_method == "exact" and other.damping == 0.1
    _close(other.matvec(v), inv.matvec(v).numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="Unknown damping method"):
        TC.KFACInverseOperator(tk, damping_method="nope")
    M = torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64)
    _close(TI._mat_pow(M, -0.5), JI._mat_pow(jnp.asarray(M.numpy()), -0.5))


# -- estimators --------------------------------------------------------------

def test_estimators_match_jax(psd, jax_draws):
    top, jop, M = psd
    for dist in ("rademacher", "normal"):
        _close(TC.random_probes(1, (30, 4), dist, torch.float64, "cpu"),
               JC.random_probes(jax.random.PRNGKey(1), (30, 4), dist,
                                jnp.float64))
        _close(TC.hutchinson_trace(top, 20, seed=1, distribution=dist),
               JC.hutchinson_trace(jop, 20, key=jax.random.PRNGKey(1),
                                   distribution=dist))
        _close(TC.hutchinson_diag(top, 20, seed=2, distribution=dist),
               JC.hutchinson_diag(jop, 20, key=jax.random.PRNGKey(2),
                                  distribution=dist))
    _close(TC.hutchinson_squared_fro(top, 20, seed=0),
           JC.hutchinson_squared_fro(jop, 20))
    with pytest.raises(ValueError, match="Unknown probe distribution"):
        TC.random_probes(0, (3,), "uniform", device="cpu")


def test_hutchpp_matches_jax(psd, monkeypatch):
    """Hutch++ splits JAX's key where the port folds its seed with 0 and
    1."""
    top, jop, M = psd
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    keys = {_fold_seed(3, 0): k1, _fold_seed(3, 1): k2}
    monkeypatch.setattr(TE, "_probes", lambda seed, shape, dist, dtype, dev:
                        _t(JE.random_probes(keys[seed], tuple(shape), dist,
                                            jnp.float64)))
    _close(TC.hutchpp_trace(top, 12, seed=3),
           JC.hutchpp_trace(jop, 12, key=jax.random.PRNGKey(3)))


def test_incremental_estimators_match_jax(psd, jax_draws):
    top, jop, M = psd
    for cls in ("HutchinsonTraceEstimator", "HutchinsonDiagonalEstimator",
                "HutchinsonSquaredFrobeniusNormEstimator"):
        est = getattr(TC, cls)(top, seed=1)
        jest = getattr(JC, cls)(jop, key=jax.random.PRNGKey(1))
        for dist in ("rademacher", "normal", "rademacher"):
            _close(est.sample(dist), jest.sample(dist))
    hpp = TC.HutchPPTraceEstimator(top, basis_dim=5, seed=2)
    jhpp = JC.HutchPPTraceEstimator(jop, basis_dim=5,
                                    key=jax.random.PRNGKey(2))
    for _ in range(3):
        _close(hpp.sample(), jhpp.sample())
    Q = hpp._Q
    hpp.sample()
    assert hpp._Q is Q
    assert TC.HutchPPTraceEstimator(top)._basis_dim == \
        JC.HutchPPTraceEstimator(jop)._basis_dim == 1
    with pytest.raises(ValueError, match="Basis dimension"):
        TC.HutchPPTraceEstimator(top, basis_dim=31)
    with pytest.raises(ValueError, match="square"):
        TC.HutchinsonTraceEstimator(TDense(torch.zeros(3, 4)))


def test_estimators_with_own_draws(psd):
    top, _, M = psd
    np.testing.assert_allclose(float(TC.hutchinson_trace(top, 3000, seed=1)),
                               np.trace(M), rtol=0.05)
    np.testing.assert_allclose(float(TC.hutchpp_trace(top, 60, seed=2)),
                               np.trace(M), rtol=0.05)
    np.testing.assert_allclose(TC.hutchinson_diag(top, 5000, seed=3).numpy(),
                               np.diag(M), rtol=0.35, atol=1.0)
    np.testing.assert_allclose(
        float(TC.hutchinson_squared_fro(top, 3000, seed=4)), np.sum(M * M),
        rtol=0.1)
    est = TC.HutchinsonTraceEstimator(top)
    np.testing.assert_allclose(np.mean([float(est.sample())
                                        for _ in range(800)]),
                               np.trace(M), rtol=0.05)
