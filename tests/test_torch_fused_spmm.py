"""Port parity: ops/fused_spmm.py (torch) against ops/pallas_spmm.py (JAX).

On the CPU the JAX op reaches its plain core ``_core_xla`` and the port's
wrapper takes its plain version ``core_reference``; both compute in
float64 here, so composed math agrees to 1e-10 absolute."""

import itertools
from pathlib import Path

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


# ---------------------------------------------------------------------------
# the kernel's launch plan (pure: shapes, dtypes, pointers, SM count)
# ---------------------------------------------------------------------------

SMS = 132
F32, I8, BF16 = torch.float32, torch.int8, torch.bfloat16


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("n,d,a_dtype", [
    (2708, 64, F32), (2708, 7, F32), (2708, 64, I8), (2708, 65, F32),
    (2707, 1, F32), (300, 64, F32), (16384, 64, I8), (2708, 12250, F32)],
    ids=lambda x: str(x).replace("torch.", ""))
def test_plan_split_fills_one_wave_of_the_card(n, d, a_dtype, sms):
    """The split's blocks fill one wave of the card's own SM count (an H100
    PCIe has 114, where a split sized for 132 would spill into a second
    wave), and no larger split would fit it and the limits."""
    p = T.plan(n, d, a_dtype, F32, 0, 0, sms)
    wave = T.BLOCKS_PER_SM[p.tile[1]] * sms
    tiles = -(-n // p.tile[0]) * -(-d // p.tile[1])
    k_steps = -(-n // p.tile[2])
    assert 1 <= p.split <= T.MAX_SPLIT
    if p.split > 1:
        assert tiles * p.split <= wave
    if p.split < min(T.MAX_SPLIT, k_steps // T.MIN_STEPS_PER_SPLIT):
        assert tiles * (p.split + 1) > wave


def test_plan_splits_the_trainer_shapes_eight_ways_at_132_sms():
    """22 row tiles x 8 = 176 blocks, within two an SM; the wide calls and
    N = 16384 have tiles enough."""
    for d in (64, 7):
        for a_dtype in (F32, I8):
            p = T.plan(2708, d, a_dtype, F32, 0, 0, SMS)
            assert p.split == 8 and 22 * p.split <= 2 * SMS
    assert T.plan(16384, 64, I8, F32, 0, 0, SMS).split == 2
    assert T.plan(2708, 112000, F32, F32, 0, 0, SMS).split == 1


@pytest.mark.parametrize("d,bn", [
    (1, 8), (7, 8), (8, 8), (9, 32), (32, 32), (33, 64), (64, 64),
    (65, 128), (128, 128), (129, 256), (12250, 256), (112000, 256)])
def test_plan_tile_is_skinny_up_to_64_columns_and_wide_after(d, bn):
    for a_dtype in (F32, I8):
        p = T.plan(2708, d, a_dtype, F32, 0, 0, SMS)
        assert p.tile[:2] == (T.BM, bn)
        if bn in T.WIDE_BN:
            assert p.tile[2] == T.WIDE_BK
            assert p.stages == T.RING_STAGES["wide"]
        else:
            assert p.tile[2] == T.SKINNY_BK[a_dtype]
            assert p.stages == T.RING_STAGES["skinny"]


@pytest.mark.parametrize("a_dtype,bk,step_bytes", [(F32, 32, 128),
                                                   (I8, 64, 64)],
                         ids=["f32", "int8"])
def test_plan_skinny_k_step_in_bytes_of_a_row(a_dtype, bk, step_bytes):
    """An f32 A moves 128 bytes of each row a step; int8 takes 64 (its
    64 rows of f32 t keep two blocks an SM, which beat one block with
    128-byte int8 steps on the card)."""
    for d in (1, 7, 64):
        p = T.plan(2708, d, a_dtype, F32, 0, 0, SMS)
        assert p.tile[2] == bk
        assert p.tile[2] * a_dtype.itemsize == step_bytes


def _offset(n, m, dtype):
    """A contiguous (n, m) view one element into its buffer."""
    return torch.zeros(n * m + 1, dtype=dtype)[1:].view(n, m)


# (name, A, t, (vec_a, vec_t))
ALIGN = [
    ("f32_n2708", lambda: torch.zeros(2708, 2708), lambda: torch.zeros(2708, 64),
     (16, 16)),
    ("f32_n2707", lambda: torch.zeros(2707, 2707), lambda: torch.zeros(2707, 7),
     (4, 4)),
    ("f32_n2706", lambda: torch.zeros(2706, 2706),
     lambda: torch.zeros(2706, 12250), (8, 8)),
    ("f32_a_offset", lambda: _offset(2708, 2708, F32),
     lambda: torch.zeros(2708, 64), (4, 16)),
    ("f32_t_offset", lambda: torch.zeros(2708, 2708),
     lambda: _offset(2708, 64, F32), (16, 4)),
    ("int8_n2708", lambda: torch.zeros(2708, 2708, dtype=I8),
     lambda: torch.zeros(2708, 64), (4, 16)),
    ("int8_n16384", lambda: torch.zeros(16384, 16384, dtype=I8),
     lambda: torch.zeros(16384, 64), (16, 16)),
    ("int8_n2707", lambda: torch.zeros(2707, 2707, dtype=I8),
     lambda: torch.zeros(2707, 64), (1, 16)),
    ("int8_n2706", lambda: torch.zeros(2706, 2706, dtype=I8),
     lambda: torch.zeros(2706, 64), (2, 16)),
    ("bf16_t_d7", lambda: torch.zeros(2708, 2708),
     lambda: torch.zeros(2708, 7, dtype=BF16), (16, 2)),
    ("bf16_t_d64", lambda: torch.zeros(2708, 2708),
     lambda: torch.zeros(2708, 64, dtype=BF16), (16, 16)),
]


@pytest.mark.parametrize("name,make_a,make_t,vecs", ALIGN,
                         ids=[c[0] for c in ALIGN])
def test_plan_copy_width_follows_pointers_and_row_length(name, make_a,
                                                         make_t, vecs):
    a, t = make_a(), make_t()
    assert a.is_contiguous() and t.is_contiguous()
    p = T.plan(a.shape[0], t.shape[1], a.dtype, t.dtype, a.data_ptr(),
               t.data_ptr(), SMS)
    assert (p.vec_a, p.vec_t) == vecs


@pytest.mark.parametrize("n", [1, 31, 40, 127, 128, 129, 2707, 2708, 16384])
def test_plan_j_ranges_are_whole_steps_and_none_empty(n):
    for d, a_dtype in itertools.product((1, 7, 64, 65, 300), (F32, I8)):
        p = T.plan(n, d, a_dtype, F32, 0, 0, SMS)
        bk = p.tile[2]
        assert p.k_per_split % bk == 0
        assert (p.split - 1) * p.k_per_split < n <= p.split * p.k_per_split
        if p.split > 1:
            assert p.k_per_split >= T.MIN_STEPS_PER_SPLIT * bk


def test_plan_rejects_other_dtypes_and_misaligned_f32():
    with pytest.raises(TypeError, match="float32 or int8"):
        T.plan(4, 4, torch.float64, F32, 0, 0, SMS)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        T.plan(4, 4, F32, torch.float16, 0, 0, SMS)
    with pytest.raises(ValueError, match="aligned"):
        T.plan(4, 4, F32, F32, 2, 0, SMS)


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every source (each may include it): the
    library's name changes with it."""
    from laplace_gnn_torch.ops import cuda_build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "SRC_DIR", tmp_path)
    before = cuda_build.library_path("k")
    assert before == cuda_build.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    after = cuda_build.library_path("k")
    assert after != before and after.name.startswith("libk_")
    # the repository's kernels do include the shared header
    src = Path(T.__file__).resolve().parent.parent / "csrc"
    for name in ("core_spmm", "matmul"):
        assert '#include "sm90_mma.cuh"' in (src / f"{name}.cu").read_text()


def _card_check(a, t, binarize, transpose, exact=False):
    """The kernel against its plain version, and a second call to the same
    bits. A binarized B is exact, so only t's rounding to bf16 errs:
    |err| <= 2^-9 |B|^T|t|, checked at 2^-8. A raw float A rounds too:
    checked at 2^-7 |A|^T|t|. An int8 0/1 A with t exactly representable
    in bf16 is exact."""
    got = T.core(a, t, 0.5, binarize, transpose)
    assert torch.equal(got, T.core(a, t, 0.5, binarize, transpose))
    ref = T.core_reference(a, t, 0.5, binarize, transpose)
    torch.cuda.synchronize()
    assert got.dtype == t.dtype and got.shape == t.shape
    if exact:
        assert torch.equal(got, ref)
        return
    bound = T.core_reference(a.abs() if a.is_floating_point() else a,
                             t.abs(), 0.5, binarize, transpose).float()
    tol = (2.0 ** -8 if binarize else 2.0 ** -7) * bound + 1e-5
    assert bool(((got.float() - ref.float()).abs() <= tol).all()), \
        (tuple(a.shape), tuple(t.shape), binarize, transpose)


@pytest.mark.cuda
def test_core_kernel_on_card_matches_reference():
    """Skinny and wide tiles, both orientations, the three A modes."""
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
                _card_check(a, t, binarize, transpose)
        tq = torch.round(t * 4) / 4
        for transpose in (False, True):
            _card_check(a8, tq, False, transpose, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "n2707", "n40", "a_offset_view", "a_sub_view", "t_offset_view", "d1",
    "d65", "d129", "bf16_t", "int8_n2707"])
def test_core_kernel_on_card_edge_cases(case):
    """Rows with no 16-byte copy (N = 2707), fewer rows than one tile,
    views one element into their buffers, d = 1 / 65 / 129, a bf16 t and
    odd-length int8 rows; the trainer's width splits j (asserted), and
    every call repeats to the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = {"n2707": 2707, "n40": 40, "int8_n2707": 2707}.get(case, 2708)
    d = {"d1": 1, "d65": 65, "d129": 129, "n40": 7}.get(case, 64)
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(n, n, generator=g, device="cuda")
    a = torch.where(a < 0.1, torch.full_like(a, 0.5), a)
    t = torch.randn(n * d + 1, generator=g, device="cuda")
    t = t[1:].view(n, d) if case == "t_offset_view" else t[:n * d].view(n, d)
    if case == "a_offset_view":
        buf = torch.empty(n * n + 1, device="cuda")
        buf[1:].copy_(a.reshape(-1))
        a = buf[1:].view(n, n)
    elif case == "a_sub_view":
        a, t = a[1:, 1:].contiguous(), t[1:].contiguous()
    elif case == "bf16_t":
        t = t.to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = T.plan(a.shape[0], d, a.dtype, t.dtype, a.data_ptr(), t.data_ptr(),
               sms)
    if case == "n2707":
        assert p.split >= 2 and p.vec_a == 4
    for transpose in (False, True):
        if case == "int8_n2707":
            _card_check((a > 0.5).to(torch.int8), torch.round(t * 8) / 8,
                        False, transpose, exact=True)
        else:
            _card_check(a, t, True, transpose)
            _card_check(a, t, False, transpose)
