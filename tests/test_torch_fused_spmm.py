"""Port parity: ops/fused_spmm.py (torch) against ops/pallas_spmm.py (JAX).

On the CPU the JAX op reaches its plain core ``_core_xla`` and the port's
wrapper takes its plain version ``core_reference``; both compute in
float64 here, so composed math agrees to 1e-10 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu.ops import pallas_spmm as J
from laplace_gnn_torch.ops import fused_spmm as T

N, D = 40, 5
ATOL = 1e-10


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _inputs(seed=0, ties=True):
    rng = np.random.default_rng(seed)
    adj = rng.random((N, N))
    if ties:
        # exact 0.5 entries: what symmetric=True makes of one-way edges
        adj[rng.random((N, N)) < 0.2] = 0.5
    s = rng.standard_normal((N, D))
    g = rng.standard_normal((N, D))
    return adj, s, g


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("binarize", [False, True])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_core_reference_matches_core_xla(transpose, binarize, threshold):
    adj, s, _ = _inputs()
    a_j = jnp.asarray(adj.T if transpose else adj)
    want = J._core_xla(a_j, jnp.asarray(s), threshold=threshold,
                       binarize=binarize)
    got = T.core_reference(_t(adj), _t(s), threshold, binarize, transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the CPU wrapper takes the plain version and launches nothing
    before = T.core.launches
    got2 = T.core(_t(adj), _t(s), threshold, binarize, transpose)
    assert T.core.launches == before
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("transpose", [False, True])
def test_core_reference_int8(transpose):
    rng = np.random.default_rng(1)
    a8 = (rng.random((N, N)) < 0.3).astype(np.int8)
    s = rng.standard_normal((N, D))
    a_j = jnp.asarray(a8.T if transpose else a8)
    want = a_j.astype(jnp.float64).T @ jnp.asarray(s)
    got = T.core_reference(_t(a8), _t(s), binarize=False, transpose=transpose)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_core_fn_gradients_match_plain():
    """The differentiable core: t-gradient is the transposed core; a raw A
    gets t g^T; a binarized A gets none."""
    adj, s, g = _inputs(2)
    for binarize in (False, True):
        for transpose in (False, True):
            a = _t(adj).requires_grad_(True)
            t = _t(s).requires_grad_(True)
            out = T.core_fn(a, t, 0.5, binarize, transpose)
            ga, gt = torch.autograd.grad(out, (a, t), _t(g),
                                         allow_unused=True)

            def f(a_, t_):
                m = a_.T if transpose else a_
                if binarize:
                    b = (m > 0.5).astype(t_.dtype)
                    b = b * (1 - jnp.eye(N)) + jnp.eye(N)
                else:
                    b = m
                return b.T @ t_

            _, vjp = jax.vjp(f, jnp.asarray(adj), jnp.asarray(s))
            ja, jt = vjp(jnp.asarray(g))
            np.testing.assert_allclose(gt.numpy(), np.asarray(jt), atol=ATOL)
            if binarize:
                assert ga is None
            else:
                np.testing.assert_allclose(ga.numpy(), np.asarray(ja),
                                           atol=ATOL)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("sign_grad", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_ste_norm_aggregate_value_and_vjp(symmetric, sign_grad, masked):
    adj, s, g = _inputs(3)
    mask = ((np.random.default_rng(4).random((N, N)) > 0.5) * 1.0
            if masked else None)
    out_j, vjp = jax.vjp(
        lambda a, x: J.ste_norm_aggregate(
            a, x, 0.5, symmetric, sign_grad,
            None if mask is None else jnp.asarray(mask)),
        jnp.asarray(adj), jnp.asarray(s))
    ga_j, gs_j = vjp(jnp.asarray(g))

    a = _t(adj).requires_grad_(True)
    x = _t(s).requires_grad_(True)
    out = T.ste_norm_aggregate(a, x, 0.5, symmetric, sign_grad,
                               None if mask is None else _t(mask))
    ga, gs = torch.autograd.grad(out, (a, x), _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gs_j), atol=ATOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ga_j), atol=ATOL)


def test_norm_aggregate_value_and_vjp():
    adj, s, g = _inputs(5, ties=False)
    adj_b = (adj > 0.5).astype(float)
    np.fill_diagonal(adj_b, 1.0)
    out_j, vjp = jax.vjp(J.norm_aggregate, jnp.asarray(adj_b), jnp.asarray(s))
    ga_j, gs_j = vjp(jnp.asarray(g))
    a = _t(adj_b).requires_grad_(True)
    x = _t(s).requires_grad_(True)
    out = T.norm_aggregate(a, x)
    ga, gs = torch.autograd.grad(out, (a, x), _t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=ATOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gs_j), atol=ATOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ga_j), atol=ATOL)


@pytest.mark.parametrize("op", ["ste", "norm"])
def test_pullback_is_differentiable(op):
    """Reverse over reverse, as the hyperstep uses it: differentiate a
    function of the s-pullback w.r.t. the cotangent, s and (for the plain
    normalization) the adjacency."""
    adj, s, g = _inputs(6)
    w = np.random.default_rng(7).standard_normal((N, D))
    if op == "norm":
        adj = (adj > 0.5).astype(float)
        np.fill_diagonal(adj, 1.0)

    def jfun(a, x, gg):
        f = ((lambda a_, x_: J.ste_norm_aggregate(a_, x_, 0.5, True))
             if op == "ste" else J.norm_aggregate)
        _, vjp = jax.vjp(lambda x_: f(a, x_), x)
        return jnp.sum(vjp(gg)[0] ** 2 * w) + jnp.sum(f(a, x) ** 2)

    want = jax.grad(jfun, argnums=(0, 1, 2))(
        jnp.asarray(adj), jnp.asarray(s), jnp.asarray(g))

    a = _t(adj).requires_grad_(True)
    x = _t(s).requires_grad_(True)
    gg = _t(g).requires_grad_(True)
    fn = ((lambda a_, x_: T.ste_norm_aggregate(a_, x_, 0.5, True))
          if op == "ste" else T.norm_aggregate)
    (ds,) = torch.autograd.grad(fn(a, x), x, gg, create_graph=True)
    val = torch.sum(ds ** 2 * _t(w)) + torch.sum(fn(a, x) ** 2)
    got = torch.autograd.grad(val, (a, x, gg))
    for gt_, gj in zip(got, want):
        np.testing.assert_allclose(gt_.numpy(), np.asarray(gj), atol=1e-9)


def test_static_int8_op_matches_jax():
    adj, s, _ = _inputs(8, ties=False)
    adj_b = (adj > 0.6).astype(float)
    np.fill_diagonal(adj_b, 1.0)
    want = J.StaticNormAdjOp(jnp.asarray(adj_b)).spmm(jnp.asarray(s))
    op = T.StaticNormAdjOp(_t(adj_b))
    assert op.adj_i8.dtype == torch.int8
    np.testing.assert_allclose(op.spmm(_t(s)).numpy(), np.asarray(want),
                               atol=ATOL)


@pytest.mark.cuda
def test_core_kernel_on_card_matches_reference():
    """The CUDA kernel against its plain version (bf16 operands, f32 sums).
    A binarized B is exact, so only t's rounding to bf16 errs:
    |err| <= 2^-9 |B|^T|t|, checked at 2^-8. A raw float A rounds too:
    checked at 2^-7 |A|^T|t|. An int8 0/1 A with t exactly representable
    in bf16 is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    n = 300
    adj = rng.random((n, n)).astype(np.float32)
    adj[rng.random((n, n)) < 0.2] = 0.5
    a = torch.as_tensor(adj, device="cuda")
    a8 = torch.as_tensor((adj > 0.5).astype(np.int8), device="cuda")
    for d in (7, 64, 100):
        t = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                            device="cuda")
        for binarize in (True, False):
            for transpose in (False, True):
                got = T.core(a, t, 0.5, binarize, transpose)
                ref = T.core_reference(a, t, 0.5, binarize, transpose)
                bound = T.core_reference(a.abs(), t.abs(), 0.5, binarize,
                                         transpose)
                tol = (2.0 ** -8 if binarize else 2.0 ** -7) * bound + 1e-5
                torch.cuda.synchronize()
                assert bool(((got - ref).abs() <= tol).all()), \
                    (d, binarize, transpose)
        tq = torch.round(t * 4) / 4
        for transpose in (False, True):
            got = T.core(a8, tq, binarize=False, transpose=transpose)
            ref = T.core_reference(a8, tq, binarize=False, transpose=transpose)
            assert torch.equal(got, ref)
