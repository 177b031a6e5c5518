"""The GAT attention's spans and counters on the CPU, on both attention
paths (ELL, and the segment path with ``--ell 0``): under a profiler each
layer's edge softmax and aggregation lies in the span
``lgnn.gat.attention`` and its backward in ``lgnn.gat.attention.backward``
(the attention's backward nodes inside it, the Linear's outside), and
``gat.calls`` / ``gat.edge_columns`` count the layers and their stored
edges x heads x head width; with no profiler recording nothing opens a
range and nothing is counted; under a ``torch.func`` transform no
backward span is laid."""

import contextlib
import types

import numpy as np
import pytest
import torch

from laplace_gnn_torch import profiling
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.training import sparse_experiment as SE

HEADS, WIDTH, CLASSES, LAYERS = 3, 4, 5, 3
SPAN = "lgnn.gat.attention"
BACK = SPAN + ".backward"


def _sparse_gat(ell: bool, n=80, features=6):
    rng = np.random.default_rng(1)
    src = rng.integers(0, n, 300)
    dst = rng.integers(0, n, 300)
    keep = src != dst
    edge_index = np.stack([np.concatenate([src[keep], dst[keep]]),
                           np.concatenate([dst[keep], src[keep]])])
    data = types.SimpleNamespace(
        edge_index=edge_index, num_nodes=n, num_features=features,
        num_classes=CLASSES,
        x=torch.as_tensor(rng.standard_normal((n, features)),
                          dtype=torch.float32))
    args = SE.argument_parser().parse_args(
        ["--model_type", "sparsegat", "--heads", str(HEADS),
         "--hidden_channels", str(HEADS * WIDTH), "--num_layers",
         str(LAYERS), "--ell", str(int(ell))])
    g = SE.build_graph(args, data, device="cpu")
    model = SE.build_model(args, data, g, device="cpu", norm="batch",
                           res=True, mean_output_heads=True)
    params = {k: v.requires_grad_(True) for k, v in model.init(
        torch.Generator().manual_seed(0)).items()}
    opt = TT.DeviceAdam(params.values(), lr=1e-2)
    idx = torch.arange(0, n, 2)
    y = torch.as_tensor(rng.integers(0, CLASSES, n))[idx]
    return model, params, opt, idx, y, g


def _by_name(prof):
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append(e)
    return out


def _within(e, spans) -> bool:
    return any(s.thread == e.thread
               and s.time_range.start <= e.time_range.start
               and e.time_range.end <= s.time_range.end for s in spans)


@pytest.mark.parametrize("ell", [True, False], ids=["ell", "segment"])
def test_an_epoch_lays_both_spans_and_counts_the_layers(ell):
    model, params, opt, idx, y, g = _sparse_gat(ell)
    assert (g.format == "ell") == ell
    SE.train_steps(model, params, opt, idx, y, 1)
    profiling.reset_counters()
    with torch.profiler.profile() as prof:
        SE.train_steps(model, params, opt, idx, y, 1)
    got = profiling.counters()
    assert got["gat.calls"] == LAYERS
    widths = [HEADS * WIDTH] * (LAYERS - 1) + [HEADS * CLASSES]
    assert got["gat.edge_columns"] == g.n_edges * sum(widths)
    by = _by_name(prof)
    assert len(by[SPAN]) == LAYERS and len(by[BACK]) == LAYERS
    # the forward's gathers lie in the forward spans
    gathers = by["aten::index_select"]
    assert gathers and any(_within(e, by[SPAN]) for e in gathers)
    # the attention's backward nodes lie in the backward spans, the
    # Linears' (weight gradients of the fc and residual layers) outside
    nodes = [e for name, evs in by.items()
             if name.startswith("autograd::engine::evaluate_function: ")
             for e in evs]
    inner = [e for e in nodes if "_GatherFnBackward" in e.name
             or "_SegmentSumFnBackward" in e.name]
    linear = [e for e in nodes if "MmBackward" in e.name]
    assert inner and all(_within(e, by[BACK]) for e in inner)
    assert linear and not any(_within(e, by[BACK]) for e in linear)
    # the backward spans lie after the forward's and do not overlap
    spans = sorted(by[BACK], key=lambda e: e.time_range.start)
    assert min(e.time_range.start for e in spans) > max(
        e.time_range.end for e in by[SPAN])
    assert all(a.time_range.end <= b.time_range.start
               for a, b in zip(spans, spans[1:]))


def test_off_no_range_is_opened_and_nothing_is_counted(monkeypatch):
    model, params, opt, idx, y, _ = _sparse_gat(True)

    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler on")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()
    SE.train_steps(model, params, opt, idx, y, 1)
    assert profiling.counters() == {}


def test_the_spans_leave_the_numbers_as_they_are():
    model, params, _, idx, y, _ = _sparse_gat(True)
    grads = []
    for traced in (False, True):
        with torch.profiler.profile() if traced else \
                contextlib.nullcontext():
            loss = torch.nn.functional.cross_entropy(
                model.apply(params, idx), y)
            grads.append(torch.autograd.grad(loss, list(params.values())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_no_backward_span_under_a_transform_or_without_grad():
    model, params, _, idx, y, _ = _sparse_gat(False)
    detached = {k: v.detach() for k, v in params.items()}

    def loss(p):
        return torch.nn.functional.cross_entropy(model.apply(p, idx), y)

    with torch.profiler.profile() as prof:
        torch.func.grad(loss)(detached)
        with torch.no_grad():
            model.apply(params, idx)
    by = _by_name(prof)
    assert len(by[SPAN]) == 2 * LAYERS
    assert BACK not in by


def test_spanned_closes_its_backward_span_once_every_input_has_its_grad():
    a = torch.randn(4, requires_grad=True)
    b = torch.randn(4, requires_grad=True)
    c = torch.randn(4)                              # takes no gradient
    with torch.profiler.profile() as prof:
        out = profiling.spanned("pair", lambda x, y, z, k: (x * y + z) * k,
                                a, b, c, 2.0)
        ga, gb = torch.autograd.grad(out.sum(), [a, b])
    torch.testing.assert_close(ga, 2 * b)
    torch.testing.assert_close(gb, 2 * a)
    by = _by_name(prof)
    assert len(by["lgnn.pair"]) == len(by["lgnn.pair.backward"]) == 1
    mul = [e for e in by["autograd::engine::evaluate_function: "
                         "MulBackward0"]]
    assert mul and all(_within(e, by["lgnn.pair.backward"]) for e in mul)
