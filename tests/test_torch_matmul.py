"""Port parity for ops/matmul.py: the plain version of the blocked matmul
against the JAX Pallas kernel in interpret mode (as
tests/test_pallas_ops.py runs it), on ragged shapes and two tilings; the
kernel's launch plan (tile, split-K, copy width), which is pure Python;
and, on a CUDA device, the hand-written kernel against its plain version.

Tolerances, relative to the largest entry of |a| @ |b|: 1e-5 for float32
(other summation orders), 2^-7 for bfloat16 outputs (one bf16 rounding of
the f32 sum)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from laplace_gnn_tpu.ops import pallas_matmul
from laplace_gnn_torch.ops import matmul as T

SHAPES = [(64, 48, 32), (37, 50, 29), (130, 200, 70)]
TILINGS = [(32, 128, 128), (512, 256, 512)]
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
SMS = 132        # streaming multiprocessors of an H100 SXM


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _bound(a, b):
    return float((np.abs(a.astype(np.float64)) @ np.abs(b)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiling", TILINGS, ids=["small", "default"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matmul_matches_pallas_interpret(shape, tiling, dtype):
    a, b = _inputs(*shape)
    bm, bn, bk = tiling
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_matmul.matmul(ja, jb, bm=bm, bn=bn, bk=bk)
    ta = torch.as_tensor(np.array(ja.astype(jnp.float32))).to(
        getattr(torch, dtype))
    tb = torch.as_tensor(np.array(jb.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = T.matmul(ta, tb, bm=bm, bn=bn, bk=bk)
    assert got.dtype == ta.dtype and got.shape == (shape[0], shape[2])
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    assert err.max() <= TOL[dtype] * _bound(a, b)


def test_wrapper_checks_and_counts_only_kernel_launches():
    a, b = torch.ones(4, 3), torch.ones(3, 2)
    before = T.matmul.launches
    assert torch.equal(T.matmul(a, b), torch.full((4, 2), 3.0))
    assert T.matmul(a.double(), b.double()).dtype == torch.float64
    with pytest.raises(ValueError, match="chain"):
        T.matmul(a, torch.ones(2, 2))
    with pytest.raises(ValueError, match="one CUDA device"):
        T.matmul(a, torch.ones(3, 2, device="meta"))
    with pytest.raises(ValueError, match="block sizes"):
        T.matmul(a, b, bk=0)
    assert T.matmul.launches == before


# the five timed shapes of chip_smoke.py: (M, K, N, dtype) -> split
TIMED = [((2708, 2708, 64, "float32"), 6),
         ((2708, 2708, 64, "bfloat16"), 6),
         ((16384, 16384, 64, "float32"), 2),
         ((16384, 16384, 64, "bfloat16"), 2),
         ((242816, 1433, 1433, "float32"), 1)]


@pytest.mark.parametrize("shape,split", TIMED,
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else str(x))
def test_plan_splits_k_only_for_skinny_products(shape, split):
    m, k, n, dt = shape
    p = T.plan(m, n, k, getattr(torch, dt), 0, 0, SMS)
    assert p.split == split
    assert p.k_per_split % p.tile[2] == 0
    assert (p.split - 1) * p.k_per_split < k <= p.split * p.k_per_split


def _offset_view(m, k, dtype):
    """A contiguous (m, k) view that starts one element into its buffer."""
    return torch.zeros(m * k + 1, dtype=dtype)[1:].view(m, k)


# (name, a, b, copy width in bytes)
ALIGN = [
    ("f32_rows16", lambda: torch.zeros(8, 2708), lambda: torch.zeros(2708, 64),
     16),
    ("f32_k1433", lambda: torch.zeros(8, 1433), lambda: torch.zeros(1433, 8),
     4),
    ("f32_n70", lambda: torch.zeros(8, 200), lambda: torch.zeros(200, 70), 8),
    ("bf16_k2708", lambda: torch.zeros(8, 2708, dtype=torch.bfloat16),
     lambda: torch.zeros(2708, 64, dtype=torch.bfloat16), 8),
    ("bf16_n70", lambda: torch.zeros(8, 200, dtype=torch.bfloat16),
     lambda: torch.zeros(200, 70, dtype=torch.bfloat16), 4),
    ("bf16_k1433", lambda: torch.zeros(8, 1433, dtype=torch.bfloat16),
     lambda: torch.zeros(1433, 64, dtype=torch.bfloat16), 2),
    ("f32_row_view", lambda: torch.zeros(9, 200)[1:],
     lambda: torch.zeros(200, 64), 16),
    ("f32_offset_view", lambda: _offset_view(8, 2708, torch.float32),
     lambda: torch.zeros(2708, 64), 4),
    ("bf16_offset_view", lambda: _offset_view(8, 2708, torch.bfloat16),
     lambda: torch.zeros(2708, 64, dtype=torch.bfloat16), 2),
]


@pytest.mark.parametrize("name,make_a,make_b,vec", ALIGN,
                         ids=[c[0] for c in ALIGN])
def test_plan_copy_width_follows_pointers_and_row_bytes(name, make_a, make_b,
                                                        vec):
    a, b = make_a(), make_b()
    assert a.is_contiguous()
    (m, k), n = a.shape, b.shape[1]
    p = T.plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr(), SMS)
    assert p.vec == vec


@pytest.mark.parametrize("shape,tiling,tile,stages", [
    ((130, 200, 70), (32, 128, 128), T.NARROW, 4),
    ((1300, 200, 700), (512, 256, 512), T.WIDE, 3),
    ((16384, 16384, 64), (512, 256, 512), T.SKINNY, 4),
    ((16384, 16384, 70), (512, 64, 512), T.SKINNY, 4),
    ((242816, 1433, 1433), (32, 128, 128), T.NARROW, 4),
    ((242816, 1433, 1433), (512, 256, 512), T.WIDE, 3),
    # 128-row tiles for fewer than half the SMs: the 64 x 64 tile
    ((130, 200, 70), (512, 256, 512), T.NARROW, 4),
    ((2708, 2708, 64), (512, 256, 512), T.NARROW, 4),
], ids=["small_hint", "default_hint", "skinny_default", "skinny_bn64",
        "kron_small_hint", "kron_default", "small_product",
        "skinny_small_product"])
def test_plan_tile_follows_the_hints(shape, tiling, tile, stages):
    m, k, n = shape
    bm, bn, _ = tiling
    for dtype, bk in ((torch.float32, 32), (torch.bfloat16, 64)):
        p = T.plan(m, n, k, dtype, 0, 0, SMS, bm=bm, bn=bn)
        assert p.tile == (*tile, bk) and p.stages == stages


def _check_k_ranges(m, n, k, dtype, sms):
    p = T.plan(m, n, k, dtype, 0, 0, sms)
    bk = p.tile[2]
    assert bk * dtype.itemsize == T.STEP_BYTES
    assert 1 <= p.split <= T.MAX_SPLIT and p.k_per_split % bk == 0
    assert (p.split - 1) * p.k_per_split < k <= p.split * p.k_per_split
    assert p.stages == T.RING_STAGES[p.tile[:2]]
    tiles = -(-m // p.tile[0]) * -(-n // p.tile[1])
    if p.split > 1:   # the grid stays within one wave
        assert tiles * p.split <= T.BLOCKS_PER_SM[p.tile[:2]] * sms
        assert tiles * p.split <= T.SPLIT_BLOCKS_PER_SM * sms
        assert p.k_per_split >= T.MIN_STEPS_PER_SPLIT * bk
    return p


@pytest.mark.parametrize("k", [1, 31, 32, 33, 200, 1433, 2708, 16384])
def test_plan_k_ranges_are_whole_steps_and_none_empty(k):
    for (m, n), dtype in itertools.product(
            ((5, 3), (300, 64), (2708, 64)), (torch.float32, torch.bfloat16)):
        _check_k_ranges(m, n, k, dtype, SMS)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("shape", [(2708, 2708, 64), (16384, 16384, 64),
                                   (300, 2000, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_split_fills_one_wave_of_the_card(shape, sms):
    """The split follows the card's SM count: an H100 PCIe has 114 SMs,
    where a split sized for 132 would spill into a second wave."""
    m, k, n = shape
    for dtype in (torch.float32, torch.bfloat16):
        p = _check_k_ranges(m, n, k, dtype, sms)
        tiles = -(-m // p.tile[0]) * -(-n // p.tile[1])
        wave = min(T.BLOCKS_PER_SM[p.tile[:2]], T.SPLIT_BLOCKS_PER_SM) * sms
        # no larger split fits the wave and the split limits
        if p.split < min(T.MAX_SPLIT,
                         -(-k // p.tile[2]) // T.MIN_STEPS_PER_SPLIT):
            assert tiles * (p.split + 1) > wave


def test_plan_rejects_other_dtypes_and_misaligned_f32():
    with pytest.raises(TypeError, match="no kernel"):
        T.plan(4, 4, 4, torch.float64, 0, 0, SMS)
    with pytest.raises(ValueError, match="4-byte aligned"):
        T.plan(4, 4, 4, torch.float32, 2, 0, SMS)


# on the card: (M, K, N, tiling, how a is made); every case for f32 and bf16
CARD_CASES = [(m, k, n, t, "plain") for (m, k, n), t in
              zip(SHAPES + [(300, 200, 70), (513, 129, 300)], TILINGS * 3)]
CARD_CASES += [
    (300, 1433, 64, TILINGS[1], "plain"),      # K = 1433: 4- or 2-byte rows
    (70, 1, 70, TILINGS[1], "plain"),          # K shorter than one k-step
    (9, 77, 70, TILINGS[0], "plain"),          # M < 16, N = 70
    (200, 300, 70, TILINGS[1], "row_view"),    # a[1:] of a (201, 300)
    (300, 2000, 64, TILINGS[1], "plain"),      # split-K
]


def _card_operands(m, k, n, how, dtype, seed):
    a, b = _inputs(m + 1, k, n, seed=seed)
    ta = torch.as_tensor(a, device="cuda").to(dtype)
    ta = ta[1:] if how == "row_view" else ta[:m]
    return ta, torch.as_tensor(b, device="cuda").to(dtype)


@pytest.mark.cuda
def test_matmul_kernel_on_card_matches_plain():
    """The CUDA kernel against its plain version on ragged shapes, both
    tiles, every copy width, split-K, f32 and bf16, and one launch counted
    per call (also when a reduce kernel follows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    seen_split = set()
    for m, k, n, (bm, bn, bk), how in CARD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            ta, tb = _card_operands(m, k, n, how, dtype, seed=m + k)
            assert ta.is_contiguous()
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            p = T.plan(m, n, k, dtype, ta.data_ptr(), tb.data_ptr(), sms,
                       bm, bn)
            seen_split.add(p.split > 1)
            before = T.matmul.launches
            got = T.matmul(ta, tb, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            assert T.matmul.launches == before + 1
            want = T.matmul_reference(ta, tb)
            bound = (ta.float().abs() @ tb.float().abs()).max()
            tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * bound
            assert got.dtype == dtype and got.shape == (m, n)
            assert float((got.float() - want.float()).abs().max()) <= tol, (
                m, k, n, how, dtype, p)
    assert seen_split == {True, False}
