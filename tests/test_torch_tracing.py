"""The port's spans and counters (profiling.py) on the CPU: with no
profiler recording they open no range and count nothing; under a
profiler the whole run's spans nest as its layers do and the counters
equal the counts derived from the run's shape; ``trace`` writes both."""

import json
import os
import types

import numpy as np
import pytest
import torch

from laplace_gnn_torch import profiling
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.graph import datasets as TDS
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.training import sparse_experiment as SE

KW = dict(lr=0.03, lr_adj=0.2, weight_decay=5e-4, n_epochs=12,
          n_hypersteps=3, n_epochs_burnin=4, marglik_frequency=4,
          model_type="stegcn")
HIDDEN = 8


@pytest.fixture(scope="module")
def karate():
    return TDS.load_data("karate", n_rand_splits=1)


def _whole_run(d, model, params):
    tr, va, _ = d.split(0)
    return TT.marglik_optimization_scan(model, params, tr, d.y[tr], va,
                                        d.y[va], device="cpu", **KW)


def _stegcn(d):
    model = TM.STEGCN(d.num_features, HIDDEN, d.num_classes, 2, d.x,
                      d.adjacency(), dropout_p=0.0, fused=True,
                      device="cpu", dtype=torch.float64)
    return model, model.params()


def _sparse_gcn(num_layers=3, n=60, hidden=16, classes=3, features=5):
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, 200)
    dst = rng.integers(0, n, 200)
    edge_index = np.stack([np.concatenate([src, dst]),
                           np.concatenate([dst, src])])
    data = types.SimpleNamespace(
        edge_index=edge_index, num_nodes=n, num_features=features,
        num_classes=classes,
        x=torch.as_tensor(rng.standard_normal((n, features)),
                          dtype=torch.float32))
    args = SE.argument_parser().parse_args(
        ["--hidden_channels", str(hidden), "--num_layers", str(num_layers)])
    g = SE.build_graph(args, data, device="cpu")
    model = SE.build_model(args, data, g, device="cpu")
    params = {k: v.requires_grad_(True) for k, v in model.init(
        torch.Generator().manual_seed(0)).items()}
    opt = TT.DeviceAdam(params.values(), lr=1e-2)
    idx = torch.arange(0, n, 2)
    y = torch.as_tensor(rng.integers(0, classes, n))[idx]
    widths = [hidden] * (num_layers - 1) + [classes]
    return model, params, opt, idx, y, g.n_edges, widths


def _events(prof):
    return [e for e in prof.events()
            if e.name.startswith(profiling.SPAN_PREFIX)]


def _inside(inner, outer) -> bool:
    return (inner.thread == outer.thread
            and outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.fixture
def no_ranges(monkeypatch):
    """``record_function`` raises: a span that opens one fails."""
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler on")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()


def test_off_a_whole_run_opens_no_range_and_counts_nothing(karate,
                                                           no_ranges):
    model, params = _stegcn(karate)
    for _ in range(2):                      # build, then the cached run
        _whole_run(karate, model, params)
    assert profiling.counters() == {}


def test_off_a_sparse_epoch_opens_no_range_and_counts_nothing(no_ranges):
    model, params, opt, idx, y, _, _ = _sparse_gcn()
    SE.train_steps(model, params, opt, idx, y, 1)
    assert profiling.counters() == {}


def test_on_the_whole_run_spans_nest_and_counters_match(karate):
    model, params = _stegcn(karate)
    untraced = _whole_run(karate, model, params)       # builds the program
    profiling.reset_counters()
    with torch.profiler.profile() as prof:
        traced = _whole_run(karate, model, params)
    for a, b in zip(untraced[2:], traced[2:]):
        np.testing.assert_array_equal(a, b)
    run = next(iter(TT._model_program_cache(model).values()))
    n_epochs, n_hyper = KW["n_epochs"], len(run.hyper_epochs) * KW[
        "n_hypersteps"]
    assert n_hyper == 6
    got = profiling.counters()
    assert {k: v for k, v in got.items() if k.startswith("step.")} == {
        "step.train_step.eager": n_epochs, "step.tracking.eager": n_epochs,
        "step.neg_marglik.eager": n_epochs, "step.hyperstep.eager": n_hyper}
    # each -log marglik: one eigensolve per distinct size among the Kron
    # factors B (HIDDEN) and B (C) of the two layers and A (HIDDEN) of the
    # second (the first layer's A, X^T X / N, is decomposed at the build)
    sizes = [HIDDEN, karate.num_classes, HIDDEN]
    curvature_steps = n_epochs + n_hyper
    assert got["eigh.calls"] == curvature_steps * len(set(sizes))
    assert got["eigh.matrices"] == curvature_steps * len(sizes)
    # every eigensolve, then the run's end: two best epochs, three traces
    assert got["host_sync"] == got["eigh.calls"] + 2 + 3

    evs = _events(prof)
    by = {}
    for e in evs:
        by.setdefault(e.name, []).append(e)
    assert len(by["lgnn.step.neg_marglik"]) == n_epochs
    assert len(by["lgnn.step.hyperstep"]) == n_hyper
    for name in ("lgnn.kfac", "lgnn.logdet", "lgnn.marglik.backend"):
        assert all(any(_inside(e, s) for e in by[name])
                   for s in by["lgnn.step.neg_marglik"]), name
    for child in ("lgnn.kfac.forward", "lgnn.kfac.pullback",
                  "lgnn.kfac.covariances"):
        assert all(any(_inside(c, k) for k in by["lgnn.kfac"])
                   for c in by[child]), child
    assert all(any(_inside(e, d) for d in by["lgnn.logdet"])
               for e in by["lgnn.eigh"])
    assert len(by["lgnn.eigh"]) == curvature_steps
    for name in ("lgnn.hypergrad", "lgnn.adj_update"):
        assert len(by[name]) == n_hyper
        assert all(any(_inside(e, s) for s in by["lgnn.step.hyperstep"])
                   for e in by[name])


def test_on_an_epoch_counts_two_spmms_per_aggregation():
    model, params, opt, idx, y, n_edges, widths = _sparse_gcn()
    SE.train_steps(model, params, opt, idx, y, 1)
    profiling.reset_counters()
    with torch.profiler.profile() as prof:
        SE.train_steps(model, params, opt, idx, y, 1)
    got = profiling.counters()
    # each layer's aggregation forward, and its transpose in the backward
    assert got["spmm.calls"] == 2 * len(widths)
    assert got["spmm.edge_columns"] == 2 * n_edges * sum(widths)
    assert sum(e.name == "lgnn.spmm" for e in _events(prof)) == 2 * len(
        widths)


def test_trace_writes_the_spans_and_the_counters(tmp_path):
    profiling.count("left.over")          # no profiler: not counted
    a = torch.ones(8, 8)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("outer"):
            with profiling.annotate("outer"):
                a @ a
        profiling.count("things", 3)
        profiling.count("things")
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2
    counters, trace = files
    assert counters.startswith("counters_") and trace.startswith("trace_")
    assert counters[len("counters_"):] == trace[len("trace_"):]
    with open(tmp_path / counters) as f:
        assert json.load(f) == {"things": 4}
    with open(tmp_path / trace) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("lgnn.outer") == 2
    # off again: nothing more is counted
    profiling.count("things")
    assert profiling.counters() == {"things": 4}


def test_annotate_is_a_decorator_decided_at_each_call(no_ranges):
    @profiling.annotate("decorated")
    def double(x):
        return 2 * x

    assert double(3) == 6                 # off: no range
    assert profiling.annotate("decorated") is profiling.annotate("decorated")
    with pytest.raises(AssertionError, match="no profiler on"):
        with torch.profiler.profile():
            double(3)
