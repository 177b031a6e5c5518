"""Port parity for ops/matmul.py: the plain version of the blocked matmul
against the JAX Pallas kernel in interpret mode (as
tests/test_pallas_ops.py runs it), on ragged shapes and two tilings; and,
on a CUDA device, the hand-written kernel against its plain version.

Tolerances, relative to the largest entry of |a| @ |b|: 1e-5 for float32
(other summation orders), 2^-7 for bfloat16 outputs (one bf16 rounding of
the f32 sum)."""

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


@pytest.mark.cuda
def test_matmul_kernel_on_card_matches_plain():
    """The CUDA kernel against its plain version on ragged shapes, both
    tiles, f32 and bf16, and one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for (m, k, n), (bm, bn, bk) in zip(SHAPES + [(300, 200, 70),
                                                 (513, 129, 300)],
                                       TILINGS * 3):
        a, b = _inputs(m, k, n, seed=m)
        for dtype in (torch.float32, torch.bfloat16):
            ta = torch.as_tensor(a, device="cuda").to(dtype)
            tb = torch.as_tensor(b, device="cuda").to(dtype)
            before = T.matmul.launches
            got = T.matmul(ta, tb, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            assert T.matmul.launches == before + 1
            want = T.matmul_reference(ta, tb)
            bound = (ta.float().abs() @ tb.float().abs()).max()
            tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * bound
            assert float((got.float() - want.float()).abs().max()) <= tol
