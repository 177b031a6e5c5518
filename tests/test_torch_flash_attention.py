"""Port parity: ops/flash_attention.py (torch) against
ops/pallas_attention.py (JAX).

The plain versions are held to the Pallas kernels run in interpret mode,
statistics (m, l) included. The Pallas kernels compute in float32 whatever
their input, and the online recurrence sums in another order than the
plain version's two passes, so those comparisons are at float32 tolerance:
rtol 2e-5 / atol 2e-6 for the forward, 3e-5 / 3e-6 for the backward (the
bounds the JAX package's own tests use against its dense oracle). With
attn_dtype="bfloat16" both sides round p and the values to bf16 at
different points (the kernel relative to a running max, the plain
version relative to the final one): held at 2^-7 relative. The autograd
Function on the CPU is composed math and is held to jax.vjp of the dense
attention in float64 at 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu.models.layers import _masked_attention_dense
from laplace_gnn_tpu.ops.pallas_attention import (_flash_bwd_pallas,
                                                  _flash_fwd_pallas_aux)
from laplace_gnn_torch.ops import flash_attention as T

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
BWD_TOL = dict(rtol=3e-5, atol=3e-6)


def _graph(n=70, H=3, F=5, seed=0, iso=True, banded=False):
    rng = np.random.default_rng(seed)
    if banded:
        a = np.zeros((n, n))
        for i in range(n):
            lo, hi = max(0, i - 8), min(n, i + 9)
            a[i, lo:hi] = rng.random(hi - lo) < 0.4
    else:
        a = rng.random((n, n)) < 0.15
    adj = np.minimum(a + a.T + np.eye(n), 1.0).astype(np.float32)
    if iso:                       # one fully isolated target row
        adj[5, :] = 0.0
    h = rng.standard_normal((n, H, F)).astype(np.float32)
    a_src = rng.standard_normal((n, H)).astype(np.float32)
    a_dst = rng.standard_normal((n, H)).astype(np.float32)
    return a_src, a_dst, adj, h


def _t(x):
    return torch.as_tensor(np.array(x))


# name: (graph kwargs, R, int8 mask, attn_dtype)
FWD_CASES = {
    "ragged_isolated": (dict(seed=0), None, False, None),
    "int8_mask": (dict(seed=1), None, True, None),
    "row_shard": (dict(seed=5, iso=False), 24, False, None),
    "bf16": (dict(seed=3), None, False, "bfloat16"),
    "wide_f": (dict(seed=4, H=2, F=33), None, False, None),
    "one_f": (dict(seed=6, H=8, F=1), 40, True, None),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_fwd_reference_matches_pallas_interpret(case):
    kw, R, int8, attn_dtype = FWD_CASES[case]
    a_src, a_dst, adj, h = _graph(**kw)
    R = R or adj.shape[0]
    mask = (adj[:R] > 0).astype(np.int8) if int8 else adj[:R]
    want_o, want_m, want_l = _flash_fwd_pallas_aux(
        jnp.asarray(a_src), jnp.asarray(a_dst[:R]), jnp.asarray(mask),
        jnp.asarray(h), negative_slope=0.2, bm=16, bn=128, interpret=True,
        attn_dtype=attn_dtype)
    before = T.flash_fwd.launches
    out, m, l = T.flash_fwd(_t(a_src), _t(a_dst[:R]), _t(mask), _t(h), 0.2,
                            attn_dtype)
    assert T.flash_fwd.launches == before       # CPU: the plain version
    assert out.shape == (R,) + h.shape[1:] and m.shape == l.shape == (
        h.shape[1], R)
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m)[:, :R],
                               **FWD_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(want_l)[:, :R],
                               **FWD_TOL)
    if attn_dtype is None:
        np.testing.assert_allclose(out.numpy(), np.asarray(want_o),
                                   **FWD_TOL)
    else:
        scale = T.flash_fwd_reference(_t(a_src), _t(a_dst[:R]), _t(mask),
                                      _t(np.abs(h)))[0].numpy()
        assert np.all(np.abs(out.numpy() - np.asarray(want_o))
                      <= 2.0 ** -7 * scale + 1e-6)
    if kw.get("iso", True) and R > 5:
        assert float(out[5].abs().max()) == 0.0     # isolated row -> 0
        assert float(l[:, 5].abs().max()) == 0.0
        assert float(m[:, 5].max()) == np.float32(T.NEG_BIG)


def test_flash_fwd_reference_row_blocks_do_not_change_the_result():
    a_src, a_dst, adj, h = (_t(x) for x in _graph(seed=7))
    whole = T.flash_fwd_reference(a_src, a_dst, adj, h)
    blocked = T.flash_fwd_reference(a_src, a_dst, adj, h, row_block=16)
    for x, y in zip(whole, blocked):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-7)


# name: (graph kwargs, R, attn_dtype)
BWD_CASES = {
    "ragged_isolated": (dict(seed=7), None, None),
    "row_shard": (dict(seed=9, iso=False), 40, None),
    "banded_tile_skip": (dict(n=96, H=2, F=5, seed=13, iso=False,
                              banded=True), None, None),
    "bf16": (dict(seed=11), None, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_bwd_reference_matches_pallas_interpret(case):
    kw, R, attn_dtype = BWD_CASES[case]
    a_src, a_dst, adj, h = _graph(**kw)
    R = R or adj.shape[0]
    args = (jnp.asarray(a_src), jnp.asarray(a_dst[:R]),
            jnp.asarray(adj[:R]), jnp.asarray(h))
    out, m, l = _flash_fwd_pallas_aux(*args, negative_slope=0.2, bm=16,
                                      bn=128, interpret=True,
                                      attn_dtype=attn_dtype)
    g = np.random.default_rng(8).standard_normal(out.shape).astype(
        np.float32)
    want = _flash_bwd_pallas(*args, jnp.asarray(g), out, m, l,
                             negative_slope=0.2, bm=16, bn=128,
                             interpret=True, attn_dtype=attn_dtype)
    before = T.flash_bwd.launches
    got = T.flash_bwd(_t(a_src), _t(a_dst[:R]), _t(adj[:R]), _t(h), _t(g),
                      _t(out), _t(np.asarray(m)[:, :R]),
                      _t(np.asarray(l)[:, :R]), 0.2, attn_dtype)
    assert T.flash_bwd.launches == before
    assert got[1].shape == (R, h.shape[1])
    for x, y in zip(got, want):
        if attn_dtype is None:
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **BWD_TOL)
        else:
            y = np.asarray(y)
            assert np.abs(x.numpy() - y).max() <= 2.0 ** -7 * np.abs(
                y).max() + 1e-5


def _f64_inputs(seed, R=None):
    a_src, a_dst, adj, h = (x.astype(np.float64)
                            for x in _graph(seed=seed, iso=R is None))
    R = R or adj.shape[0]
    g = np.random.default_rng(seed + 1).standard_normal((R,) + h.shape[1:])
    return a_src, a_dst[:R], adj[:R], h, g


@pytest.mark.parametrize("R", [None, 30])
def test_flash_masked_attention_grads_match_dense_vjp(R):
    a_src, a_dst, adj, h, g = _f64_inputs(2, R)
    out_j, vjp = jax.vjp(
        lambda a, b, c: _masked_attention_dense(a, b, jnp.asarray(adj), c,
                                                0.2),
        jnp.asarray(a_src), jnp.asarray(a_dst), jnp.asarray(h))
    want = vjp(jnp.asarray(g))
    xs = [_t(x).requires_grad_(True) for x in (a_src, a_dst, adj, h)]
    out = T.flash_masked_attention(*xs, 0.2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-10)
    grads = torch.autograd.grad(out, xs, _t(g), allow_unused=True)
    for got, w in zip((grads[0], grads[1], grads[3]), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-10)
    # adj enters only through adj > 0: no gradient
    assert grads[2] is None or float(grads[2].abs().max()) == 0.0


def test_flash_masked_attention_double_backward_raises():
    a_src, a_dst, adj, h, g = _f64_inputs(3)
    xs = [_t(x).requires_grad_(True) for x in (a_src, a_dst, h)]
    out = T.flash_masked_attention(xs[0], xs[1], _t(adj), xs[2])
    with pytest.raises(RuntimeError, match="jvp_safe"):
        torch.autograd.grad(out, xs, _t(g), create_graph=True)
    # a first derivative still works on the same graph
    assert all(x is not None for x in torch.autograd.grad(out, xs, _t(g)))


def test_attn_dtype_is_checked():
    a_src, a_dst, adj, h = (_t(x) for x in _graph(seed=4))
    with pytest.raises(ValueError, match="attn_dtype"):
        T.flash_fwd(a_src, a_dst, adj, h, 0.2, "float16")


@pytest.mark.cuda
def test_flash_kernels_on_card_match_plain_versions():
    """Both CUDA kernels against their plain versions on the card: float32
    to 1e-4 relative to the largest entry (sums in another order; d_a_dst
    summed with atomics), bf16 operands to 2^-7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for kw, R, int8, attn_dtype in FWD_CASES.values():
        a_src, a_dst, adj, h = _graph(**kw)
        R = R or adj.shape[0]
        mask = (adj[:R] > 0).astype(np.int8) if int8 else adj[:R]
        args = [torch.as_tensor(x, device="cuda")
                for x in (a_src, a_dst[:R], mask, h)]
        got = T.flash_fwd(*args, 0.2, attn_dtype)
        want = T.flash_fwd_reference(*args, 0.2, attn_dtype)
        g = torch.randn_like(got[0])
        got_b = T.flash_bwd(*args, g, *want, 0.2, attn_dtype)
        want_b = T.flash_bwd_reference(*args, g, *want, 0.2, attn_dtype)
        torch.cuda.synchronize()
        tol = 2.0 ** -7 if attn_dtype else 1e-4
        for x, y in list(zip(got, want)) + list(zip(got_b, want_b)):
            scale = float(y.abs().max()) + 1e-6
            assert float((x - y).abs().max()) <= tol * scale, (kw, R)
