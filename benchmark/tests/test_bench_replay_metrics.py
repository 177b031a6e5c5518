"""The readers of ``replay_share.marglik`` (the program's step counters)
and ``eigsolve_ms.marglik`` (the small eigensolver's kernels by name):
on fake traces, and on the small whole-run cell on the CPU, where no step
replays (0%) and no kernel runs (no reading)."""

import importlib.util
import json
import os
import types

import pytest

import run
import tinyroot
from benchlib import program

METRICS = os.path.join(tinyroot.BENCH_DIR, "metrics")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("counts, want", [
    ({"step.train_step.replay": 200, "step.tracking.replay": 200,
      "step.neg_marglik.eager": 200, "step.hyperstep.eager": 50},
     100.0 * 400 / 650),
    ({"step.train_step.replay": 200, "step.tracking.replay": 200,
      "step.neg_marglik.replay": 200, "step.hyperstep.replay": 50}, 100.0),
    ({}, None),
])
def test_replay_share_reads_the_step_counters(monkeypatch, counts, want):
    monkeypatch.setattr(program, "counter", counts.get)
    got = _reader("replay_share.marglik").read(types.SimpleNamespace(units=1))
    assert got == want


def test_eigsolve_ms_reads_the_kernels_by_name():
    kernels = [("void (anonymous namespace)::small_eigvalsh_kernel<float>"
                "(float const*, float*, int, int*)", 0.0, 30.0),
               ("void (anonymous namespace)::small_eigh_kernel<float>()",
                40.0, 50.0),
               ("syevbj_batch_32x16", 50.0, 500.0)]

    def device_s(pred):
        return sum(t - s for n, s, t in kernels if pred(n)) / 1e6
    view = types.SimpleNamespace(units=2,
                                 prof=types.SimpleNamespace(device_s=device_s))
    reader = _reader("eigsolve_ms.marglik")
    assert reader.read(view) == pytest.approx(1e3 * 40e-6 / 2)
    kernels[:2] = []
    assert reader.read(view) is None


def test_the_small_whole_run_reports_replay_share(tmp_path, capsys):
    root = tinyroot.copy_checkout(str(tmp_path))
    cells = tinyroot.add_small_cells(root)
    from laplace_gnn_torch import profiling
    profiling.reset_counters()
    rc = run.main(["--workload", cells["stegcn-cora.marglik"], "--seed",
                   str(2 ** 31 + 11), "--seconds", "0.3", "--trace", "1"],
                  device="cpu", root=root)
    assert rc == 0
    metrics = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
    assert metrics["replay_share.marglik"]["value"] == 0.0
    assert "eigsolve_ms.marglik" not in metrics
