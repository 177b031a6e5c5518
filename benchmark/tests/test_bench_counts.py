"""The operation and byte counts against values worked by hand."""

import pytest

from benchlib import counts, peaks


def test_core_spmm_bound_bytes_and_flops():
    # n = 4, d = 2, f32 A and t: A 64 bytes, t and out 32 each
    n_bytes, n_flops = 4 * 4 * 4 + 2 * 4 * 2 * 4, 2 * 4 * 4 * 2
    assert counts.core_spmm_bound_s(4, 2, 4, 4) == pytest.approx(
        max(n_bytes / peaks.HBM_BYTES_PER_S, n_flops / peaks.BF16_FLOPS))
    # Cora's trainer launch: 2708^2 f32 bytes dominate
    want = (2708 * 2708 * 4 + 2 * 2708 * 64 * 4) / 3.35e12
    assert counts.core_spmm_bound_s(2708, 64, 4, 4) == pytest.approx(want)


def test_spmm_bound():
    # 10 edges (int64 index + bf16 value), 5 nodes of width 3 in and out
    want = (10 * (8 + 2) + 2 * 5 * 3 * 2) / 3.35e12
    assert counts.spmm_bound_s(10, 5, 3, 8, 2) == pytest.approx(want)


def test_stegcn_run_flops_by_hand():
    n, f, h, c = 3, 2, 2, 2
    agg_h, agg_c = 2 * 9 * 2, 2 * 9 * 2          # 36 each
    lin_fh, lin_hc = 2 * 3 * 2 * 2, 2 * 3 * 2 * 2  # 24 each
    forward = lin_fh + agg_h + lin_hc + agg_c      # 120
    train = forward + agg_c + 2 * lin_hc + agg_h + lin_fh   # 264
    ev = (forward + c * (agg_c + 2 * 3 * 2 * 2 + agg_h)
          + 2 * (c * n) * c * c + 2 * (c * n) * h * h + 2 * n * h * h)
    assert ev == 120 + 2 * 96 + 48 + 48 + 24
    assert counts.stegcn_run_flops(n, f, h, c, 4, 3) == pytest.approx(
        4 * (train + forward + ev) + 3 * ev)


def test_gcn_epoch_flops_by_hand():
    # 2 layers 4 -> 3 -> 2 on 5 nodes and 7 stored edges
    l0 = 2 * 5 * 4 * 3
    l1 = 2 * 5 * 3 * 2
    s0, s1 = 2 * 7 * 3, 2 * 7 * 2
    want = (l0 + s0) + (s0 + l0) + (l1 + s1) + (s1 + l1 + l1)
    assert counts.gcn_epoch_flops(5, 7, [4, 3, 2]) == want


def test_mfu_numerator_at_cora():
    # about 3.2 TFLOP a whole run at Cora's width, 200 epochs, 50
    # hypersteps: the figure PERF.md's prediction rests on
    total = counts.stegcn_run_flops(2708, 1433, 64, 7, 200, 50)
    assert 3.0e12 < total < 3.4e12
