"""The ``sparsegcnii-arxiv.train`` cell on the CPU at a tiny size: its
driver and plain reference run through the harness, the sound path is
correct and each planted fault is not, under the full cell's limits; the
counts of ``benchlib/gcnii_counts.py`` against a hand count; the
configuration against the source's published settings; and a run of the
cell loads nothing of JAX, in a fresh process.

Importing this file enters the cell's small configuration
(``tinygcnii.SMALL_GCNII``) in ``tinyroot.SMALL``, for the tests that
build a small copy of every cell."""

import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

import run
import tinygcnii
import tinyroot
from benchlib import gcnii_counts
from benchlib.drive import load
from benchlib.launched import launched_device_s
from benchlib.program import span_device_s

tinyroot.SMALL.setdefault(tinygcnii.CONFIG, tinygcnii.SMALL_GCNII)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tinyroot.copy_checkout(str(tmp_path_factory.mktemp("gcnii")))
    return root, tinygcnii.add_small_gcnii_cell(root)


def _run(root, cell, capsys, seed, trace="0"):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", trace], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _driver(root):
    return load(types.SimpleNamespace(
        bench_dir=os.path.join(root, "benchmark")), "drivers",
        "sparse_gcnii_train")


def _config(name="sparsegcnii-arxiv.json", root=tinyroot.ROOT):
    with open(os.path.join(root, "benchmark", "configs", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", [2 ** 33 + 7, 41])
def test_the_sound_path_is_correct(small_root, capsys, seed):
    root, small = small_root
    result = _run(root, small, capsys, seed)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "epoch_ms"}


def test_a_traced_run_reports_what_the_cpu_can_read(small_root, capsys):
    """On the CPU the trace has no device time: the convs' and the
    SpMMs' metrics and the idle share read nothing and are left out; the
    MFU is read."""
    root, small = small_root
    result = _run(root, small, capsys, 2 ** 32 + 5, trace="1")
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"mfu.gcnii"}
    assert 0 < result["metrics"]["mfu.gcnii"]["value"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered",
                                   "initial_residual_dropped",
                                   "identity_map_dropped"])
def test_a_broken_path_is_not_correct(small_root, capsys, fault):
    root, small = small_root
    with _driver(root).FAULTS[fault]():
        result = _run(root, small, capsys, 31)
    assert result["correct"] is False, result["compared"]


def test_the_weights_are_the_models_and_follow_the_seed(small_root):
    import torch
    from laplace_gnn_torch.training import sparse_experiment as se
    root, _ = small_root
    cfg = _config("sparsegcnii-arxiv-small.json", root)
    drv = _driver(root)
    w = drv.gcnii_weights(5, cfg, "cpu")
    assert torch.equal(w["convs.3.lin.weight"],
                       drv.gcnii_weights(5, cfg, "cpu")["convs.3.lin.weight"])
    assert not torch.equal(w["convs.0.lin.weight"],
                           drv.gcnii_weights(6, cfg, "cpu")[
                               "convs.0.lin.weight"])
    n = 40
    ei = torch.stack([torch.arange(n), (torch.arange(n) + 1) % n])
    data = types.SimpleNamespace(
        edge_index=torch.cat([ei, ei.flip(0)], 1).numpy(), num_nodes=n,
        num_features=cfg["n_features"], num_classes=cfg["n_classes"],
        x=torch.zeros(n, cfg["n_features"]))
    args = se.argument_parser().parse_args(
        ["--model_type", "sparsegcnii", "--hidden_channels",
         str(cfg["hidden_channels"]), "--num_layers",
         str(cfg["num_layers"])])
    model = se.build_model(args, data, se.build_graph(args, data, "cpu"),
                           device="cpu", **cfg["model_options"])
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        k: tuple(v.shape) for k, v in model.params().items()}
    bound = 1 / cfg["hidden_channels"] ** 0.5
    assert float(w["convs.1.lin.weight"].abs().max()) <= bound


def test_the_configuration_is_the_published_one():
    cfg = _config()
    assert (cfg["num_layers"], cfg["hidden_channels"]) == (32, 256)
    assert (cfg["alpha"], cfg["lamda"], cfg["lr"]) == (0.1, 0.6, 0.01)
    assert (cfg["wd1"], cfg["wd2"]) == (0.01, 5e-4)
    # the model's options and weight decays state the same numbers
    from laplace_gnn_torch.models import SparseGCNII
    assert cfg["model_options"] == {"alpha": cfg["alpha"],
                                    "lamda": cfg["lamda"]}
    assert SparseGCNII.weight_decays == (cfg["wd1"], cfg["wd2"])
    assert set(cfg["reduced"]) == {"dropout", "n_train", "n_val", "n_test",
                                   "agg_dtype"}
    assert {"graph", "split", "weights", "loss"} <= set(cfg["assumed"])
    with open(os.path.join(tinyroot.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {c["name"]: c for c in bench["configs"]}["sparsegcnii-arxiv"]
    assert entry["reduced"] == cfg["reduced"]


def test_epoch_flops_by_hand():
    # 5 nodes, 7 stored edges, 4 features, width 3, 2 classes, 2 layers
    layer = (2 * 7 * 3 + 6 * 5 * 3 + 2 * 5 * 3 * 3) + (
        2 * 7 * 3 + 6 * 5 * 3 + 2 * 2 * 5 * 3 * 3)
    want = 2 * (2 * 5 * 4 * 3) + 2 * layer + 3 * (2 * 5 * 3 * 2)
    assert gcnii_counts.epoch_flops(5, 7, 4, 3, 2, 2) == want


def test_flops_of_the_published_configuration():
    cfg = _config()
    n = cfg["n_nodes"]
    flops = gcnii_counts.epoch_flops(n, 2_500_000, cfg["n_features"],
                                     cfg["hidden_channels"],
                                     cfg["n_classes"], cfg["num_layers"])
    # 3 products of 2 N 256^2 a layer, about 2.1 TFLOP an epoch, most of it
    gemms = 32 * 3 * 2 * n * 256 ** 2
    assert 2.1e12 < gemms < flops < 1.05 * gemms + 0.1e12


def _event(name, start, end, device_us):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        self_device_time_total=device_us)


def test_a_span_counts_the_work_its_operations_launched_once():
    """A runtime call or a tracer's record inside the span that the
    profiler gave an operation's kernels too is left out; work outside
    the span is not counted; a trace without the span gives None."""
    prof = types.SimpleNamespace(cpu=[
        _event("lgnn.gcnii.conv", 10, 50, 0.0),
        _event("aten::addmm", 12, 20, 300.0),
        _event("spmm", 21, 30, 200.0),
        _event("cudaStreamIsCapturing", 22, 23, 200.0),
        _event("cuLaunchKernel", 24, 25, 200.0),
        _event("Command Buffer Full", 25, 26, 200.0),
        _event("lgnn.gcnii.conv", 60, 80, 0.0),
        _event("aten::relu", 61, 62, 50.0),
        _event("aten::nll_loss_forward", 90, 95, 70.0)])
    assert launched_device_s(prof, "gcnii.conv") == pytest.approx(550e-6)
    assert span_device_s(prof, "gcnii.conv") == pytest.approx(1150e-6)
    assert launched_device_s(prof, "gcnii.conv.backward") is None


def test_a_run_of_the_cell_loads_no_jax(tmp_path):
    code = f"""
        import json, sys
        sys.path[:0] = [{tinyroot.BENCH_DIR!r},
                        {os.path.dirname(os.path.abspath(__file__))!r}]
        import tinyroot, tinygcnii, run
        root = tinyroot.copy_checkout({str(tmp_path)!r})
        cell = tinygcnii.add_small_gcnii_cell(root)
        for trace in ("0", "1"):
            rc = run.main(["--workload", cell, "--seed", "5",
                           "--seconds", "0.3", "--trace", trace],
                          device="cpu", root=root)
            assert rc == 0, (trace, rc)
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       cwd=tinyroot.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "laplace_gnn_tpu"}
    assert "laplace_gnn_torch" in top


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
        import importlib.util, json, sys
        sys.path.insert(0, {tinyroot.BENCH_DIR!r})
        spec = importlib.util.spec_from_file_location("sparse_gcnii",
            {os.path.join(tinyroot.BENCH_DIR, 'references',
                          'sparse_gcnii.py')!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "laplace_gnn_tpu",
                      "laplace_gnn_torch"}
