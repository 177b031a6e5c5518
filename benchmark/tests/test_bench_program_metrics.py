"""The per-layer metrics that read the program's own spans and counters
(``benchlib/program.py``), on small copies of the cells on the CPU: each
that reads host time or a counter is reported with ``--trace 1``, the
host waits of a whole run are the count its shape gives, the device time
of the work launched inside a span is found on every thread, and a
program without spans or counters gives None. (``spmm_ms.train`` and
``predictive_share.eval`` read device time, which a CPU trace has not.)"""

import json
import types

import pytest

import run
import tinyroot
from benchlib import program

NEW = {"stegcn-cora.marglik": ("host_syncs_per_run.marglik",
                               "kfac_share.marglik"),
       "sparsegcn-arxiv.laplace": ("tune_share.lastlayer",)}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tinyroot.copy_checkout(str(tmp_path_factory.mktemp("program")))
    return root, tinyroot.add_small_cells(root)


def _traced(root, cell, capsys):
    from laplace_gnn_torch import profiling
    profiling.reset_counters()
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 9),
                   "--seconds", "0.3", "--trace", "1"], device="cpu",
                  root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(NEW))
def test_the_program_metrics_are_reported(small_root, capsys, cell):
    root, cells = small_root
    metrics = _traced(root, cells[cell], capsys)["metrics"]
    for name in NEW[cell]:
        assert name in metrics, (name, sorted(metrics))
        assert metrics[name]["value"] > 0
    for name in NEW[cell]:
        if "share" in name:
            assert metrics[name]["value"] < 100


def test_a_whole_runs_host_waits_are_its_eigensolves_and_reads(
        small_root, capsys):
    root, cells = small_root
    metrics = _traced(root, cells["stegcn-cora.marglik"], capsys)["metrics"]
    small = tinyroot.SMALL["stegcn-cora"]
    hyper_epochs = [e for e in range(1, small["n_epochs"] + 1)
                    if e < small["n_hyper_stop"]
                    and e % small["marglik_frequency"] == 0
                    and e >= small["n_epochs_burnin"]]
    curvature_steps = small["n_epochs"] + len(hyper_epochs) * small[
        "n_hypersteps"]
    # one eigensolve per distinct factor size (B: hidden and classes; the
    # second layer's A: hidden), two best epochs and three traces read
    sizes = {small["hidden_channels"], small["n_classes"]}
    want = curvature_steps * len(sizes) + 5
    assert metrics["host_syncs_per_run.marglik"]["value"] == want


def _event(name, start, end, thread=1, device_us=0.0):
    return types.SimpleNamespace(
        name=name, thread=thread, self_device_time_total=device_us,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_a_spans_device_time_is_what_starts_inside_it_on_any_thread():
    prof = types.SimpleNamespace(wall_s=1.0, cpu=[
        _event("lgnn.laplace.predictive", 10, 20),
        _event("aten::mm", 11, 12, device_us=100.0),
        # the pullback's backward, on the autograd engine's thread
        _event("aten::mm", 15, 19, thread=2, device_us=40.0),
        _event("lgnn.laplace.predictive", 30, 40),
        _event("lgnn.laplace.predictive", 32, 35),      # nested: once
        _event("aten::add", 33, 34, device_us=7.0),
        _event("aten::mm", 25, 26, device_us=1000.0),   # between them
        _event("aten::mm", 8, 21, device_us=500.0),     # began before
    ])
    assert program.span_device_s(prof, "laplace.predictive") == 147e-6
    assert program.span_s(prof, "laplace.predictive") == 20e-6
    assert program.span_device_s(prof, "kfac") is None


def test_a_program_without_spans_or_counters_gives_none(monkeypatch):
    view = types.SimpleNamespace(
        prof=types.SimpleNamespace(cpu=[], wall_s=1.0), units=1)
    assert program.span_share(view, "kfac") is None
    from laplace_gnn_torch import profiling
    monkeypatch.delattr(profiling, "counters")
    assert program.counter("host_sync") is None
