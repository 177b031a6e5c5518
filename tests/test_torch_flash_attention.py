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


# the kernels' launch plan (pure: shapes, dtype, pointer, SM count)
F32, I8 = torch.float32, torch.int8


def _axes(p, n, r, backward):
    """(blocks, walked axis, tile along it) of a plan."""
    if backward:
        return -(-n // p.block), r, p.tile[0]
    return -(-r // p.block), n, p.tile[1]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [F32, I8])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n", [2708, 16384])
def test_plan_split_fills_one_wave_of_the_card(n, sms, dtype, backward):
    for f in (8, 1):
        p = T.plan(n, n, 8, f, dtype, 0, sms, backward)
        blocks, walked, step = _axes(p, n, n, backward)
        per_sm = T.BLOCKS_PER_SM[T.f_block(f)]
        if not backward:          # small blocks: more of them an SM
            per_sm = min(64 // p.block,
                         per_sm * T.THREADS // T.fwd_threads(p.block, 8))
        wave = per_sm * sms
        tiles = -(-walked // step)
        assert 1 <= p.split <= T.MAX_SPLIT
        if p.split > 1:               # one wave and no more
            assert blocks * p.split <= wave
        # no larger split of whole tiles fits the wave
        more = [s for s in range(p.split + 1, T.MAX_SPLIT + 1)
                if blocks * s <= wave and s <= tiles
                and -(-walked // (-(-tiles // s) * step)) > p.split]
        assert not more, (p, more)


def test_plan_at_the_timed_shapes():
    got = {(n, sms, bwd): T.plan(n, n, 8, 8, F32, 0, sms, bwd).split
           for n in (2708, 16384) for sms in (132, 114)
           for bwd in (False, True)}
    assert got == {(2708, 132, False): 3, (2708, 114, False): 2,
                   (16384, 132, False): 1, (16384, 114, False): 1,
                   (2708, 132, True): 8, (2708, 114, True): 8,
                   (16384, 132, True): 2, (16384, 114, True): 1}
    fwd = T.plan(2708, 2708, 8, 8, F32, 0, 132, False)
    bwd = T.plan(2708, 2708, 8, 8, F32, 0, 132, True)
    # 8 rows x 8 heads: 64 threads, 8 blocks an SM
    assert (fwd.block, fwd.tile, fwd.per_split) == (8, (8, 256), 1024)
    assert T.fwd_threads(fwd.block, 8) == 64
    # at N = 16384 blocks of half the rows (one warp, 16 an SM) still fill
    # a wave, and hide the edges' gathers better
    big = T.plan(16384, 16384, 8, 8, F32, 0, 132, False)
    assert (big.block, big.split) == (4, 1)
    assert T.plan(16384, 5461, 8, 8, F32, 0, 132, False).block == 8
    # backward rows of 512 bytes: 128 f32 columns a block
    assert (bwd.block, bwd.tile, bwd.per_split) == (128, (64, 128), 384)
    assert T.plan(2708, 2708, 8, 8, I8, 0, 132, False).tile == (8, 1024)
    assert fwd.stages == bwd.stages == T.RING_STAGES


@pytest.mark.parametrize("backward", [False, True])
def test_plan_split_stays_at_most_eight(backward):
    for n in (40, 300, 2708, 16384):
        for sms in (1, 132, 10 ** 6):
            p = T.plan(n, n, 8, 8, F32, 0, sms, backward)
            assert 1 <= p.split <= T.MAX_SPLIT


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [F32, I8])
def test_plan_ranges_are_whole_tiles_and_none_empty(dtype, backward):
    for n in (1, 40, 255, 256, 1025, 2707, 2708, 5461, 16384):
        for r in {n, max(1, n // 3)}:
            p = T.plan(n, r, 8, 8, dtype, 0, 132, backward)
            _, walked, step = _axes(p, n, r, backward)
            assert p.per_split % step == 0
            assert (p.split - 1) * p.per_split < walked
            assert p.split * p.per_split >= walked


@pytest.mark.parametrize("name,n,dtype,offset,backward,heads,f,vec", [
    ("f32 rows of 16 bytes", 2708, F32, 0, False, 8, 8, 16),
    ("f32 N = 2707", 2707, F32, 0, False, 8, 8, 4),
    ("f32 view one element in", 2708, F32, 4, False, 8, 8, 4),
    ("f32 view two elements in", 2708, F32, 8, True, 8, 8, 8),
    ("int8 rows of 16 bytes", 16384, I8, 0, False, 8, 8, 16),
    ("int8 N = 2708", 2708, I8, 0, True, 8, 8, 4),
    ("int8 N = 2706", 2706, I8, 0, False, 8, 8, 2),
    ("int8 N = 2707", 2707, I8, 0, False, 8, 8, 1),
    ("int8 view one row in", 2708, I8, 2708, False, 8, 8, 4),
    # a backward block of one f32 column starts 4 bytes after the last
    ("f32 one column a block", 2708, F32, 0, True, 256, 64, 4),
    ("int8 four columns a block", 2708, I8, 0, True, 256, 8, 4),
])
def test_plan_copy_width_follows_pointer_and_row_bytes(
        name, n, dtype, offset, backward, heads, f, vec):
    p = T.plan(n, n, heads, f, dtype, (1 << 20) + offset, 132, backward)
    assert p.vec == vec, name


@pytest.mark.parametrize("heads,f", [(1, 1), (1, 64), (3, 5), (16, 8),
                                     (256, 1), (256, 64)])
def test_plan_at_the_edges_of_the_domain(heads, f):
    fb = T.f_block(f)
    for backward in (False, True):
        p = T.plan(300, 300, heads, f, F32, 0, 132, backward)
        if backward:              # the threads' pairs hold every column
            assert p.block * heads <= T.THREADS * T.BWD_PAIRS[fb]
            assert 1 <= p.block <= T.BWD_MAX_COLS
        else:                     # one thread a (row, head) pair
            assert p.block * heads <= T.THREADS
            assert 1 <= p.block <= T.FWD_MAX_ROWS
        assert p.block & (p.block - 1) == 0


@pytest.mark.parametrize("kw", [dict(heads=257), dict(f=65), dict(f=0),
                                dict(heads=0), dict(n=0)])
def test_plan_rejects_what_the_kernels_do_not_take(kw):
    args = dict(n=300, r=300, heads=8, f=8, adj_dtype=F32, adj_ptr=0,
                sms=132, backward=True)
    args.update(kw)
    with pytest.raises(ValueError):
        T.plan(**args)
    with pytest.raises(TypeError):
        T.plan(300, 300, 8, 8, torch.float64, 0, 132, False)
    with pytest.raises(ValueError):            # f32 not 4-byte aligned
        T.plan(300, 300, 8, 8, F32, 2, 132, False)


def test_bwd_workspace_holds_the_partials():
    n, r, H, F = 16384, 16384, 8, 8
    # one (R, H) partial of d_a_dst a block of 128 source columns, and the
    # 2 partials of d_a_src and d_x over the split target axis
    p = T.plan(n, r, H, F, F32, 0, 132, True)
    assert p.split == 2
    assert T.bwd_workspace(p, n, r, H, F) == (128 * r * H
                                               + 2 * n * H * (F + 1))
    one = p._replace(split=1)
    assert T.bwd_workspace(one, n, r, H, F) == 128 * r * H


@pytest.mark.cuda
def test_flash_kernels_on_card_match_plain_versions():
    """Both CUDA kernels against their plain versions on the card: float32
    to 1e-4 relative to the largest entry (sums in another order: the online
    softmax, split partials merged in a fixed order), bf16 operands to
    2^-7; m exactly; two calls of each kernel give the same bits. Beside
    FWD_CASES: a banded graph (most splits of a row empty), N = 2707 (no
    16-byte rows), an offset view, H = 16 and 256, F = 64 and scores whose
    exp underflows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cases = [(kw, R, int8, attn_dtype, None)
             for kw, R, int8, attn_dtype in FWD_CASES.values()]
    cases += [(dict(n=2708, H=8, F=8, seed=20, iso=False, banded=True), None,
               False, None, None),
              (dict(n=2707, H=8, F=8, seed=21), None, False, None, None),
              (dict(n=2707, H=8, F=1, seed=22), None, True, None, None),
              (dict(n=300, H=8, F=8, seed=23), None, False, None, "offset"),
              (dict(n=300, H=16, F=8, seed=24), None, True, None, None),
              (dict(n=80, H=256, F=2, seed=25), None, False, None, None),
              (dict(n=300, H=8, F=64, seed=26), None, False, None, None),
              (dict(n=300, H=8, F=8, seed=27), None, False, None,
               "underflow")]
    for kw, R, int8, attn_dtype, variant in cases:
        a_src, a_dst, adj, h = _graph(**kw)
        if variant == "underflow":
            a_src[3], a_src[4] = -80.0, -800.0
        R = R or adj.shape[0]
        mask = (adj[:R] > 0).astype(np.int8) if int8 else adj[:R]
        args = [torch.as_tensor(x, device="cuda")
                for x in (a_src, a_dst[:R], mask, h)]
        if variant == "offset":           # one element into its buffer
            buf = torch.empty(args[2].numel() + 1, device="cuda")
            buf[1:].copy_(args[2].reshape(-1))
            args[2] = buf[1:].view(args[2].shape)
        got = T.flash_fwd(*args, 0.2, attn_dtype)
        want = T.flash_fwd_reference(*args, 0.2, attn_dtype)
        g = torch.randn_like(got[0])
        got_b = T.flash_bwd(*args, g, *want, 0.2, attn_dtype)
        want_b = T.flash_bwd_reference(*args, g, *want, 0.2, attn_dtype)
        again = (T.flash_fwd(*args, 0.2, attn_dtype)
                 + T.flash_bwd(*args, g, *want, 0.2, attn_dtype))
        torch.cuda.synchronize()
        tol = 2.0 ** -7 if attn_dtype else 1e-4
        for x, y in list(zip(got, want)) + list(zip(got_b, want_b)):
            scale = float(y.abs().max()) + 1e-6
            assert float((x - y).abs().max()) <= tol * scale, (kw, R)
        assert torch.equal(got[1], want[1]), kw          # m is exact
        for x, y in zip(got + got_b, again):
            assert torch.equal(x, y), kw
