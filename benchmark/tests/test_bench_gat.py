"""The ``sparsegat-arxiv.train`` cell on the CPU at a tiny size: its
driver and plain reference run through the harness, the sound path is
correct and each planted fault is not, under the full cell's limits; the
counts of ``benchlib/gat_counts.py`` against a hand count; and a run of
the cell loads nothing of JAX, in a fresh process."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import run
import tinyroot
from benchlib import counts, gat_counts, peaks
from benchlib.drive import load
from tinygat import add_small_gat_cell


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tinyroot.copy_checkout(str(tmp_path_factory.mktemp("gat")))
    return root, add_small_gat_cell(root)


def _run(root, cell, capsys, seed, trace="0"):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", trace], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _driver(root):
    import types
    return load(types.SimpleNamespace(
        bench_dir=os.path.join(root, "benchmark")), "drivers",
        "sparse_gat_train")


@pytest.mark.parametrize("seed", [2 ** 33 + 7, 41])
def test_the_sound_path_is_correct(small_root, capsys, seed):
    root, small = small_root
    result = _run(root, small, capsys, seed)
    assert result["correct"] is True, result["compared"]
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "epoch_ms"}


def test_a_traced_run_reports_what_the_cpu_can_read(small_root, capsys):
    """On the CPU the trace has no device time: the attention's metrics
    and the idle share read nothing and are left out; the MFU is read."""
    root, small = small_root
    result = _run(root, small, capsys, 2 ** 32 + 5, trace="1")
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"mfu.gat"}
    assert 0 < result["metrics"]["mfu.gat"]["value"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "attention_uniform"])
def test_a_broken_path_is_not_correct(small_root, capsys, fault):
    root, small = small_root
    with _driver(root).FAULTS[fault]():
        result = _run(root, small, capsys, 31)
    assert result["correct"] is False, result["compared"]


def test_the_faults_are_the_train_cells_and_one_of_the_attention(
        small_root):
    assert set(_driver(small_root[0]).FAULTS) == {
        "state_unchanged", "half_batch", "answer_altered",
        "attention_uniform"}


def test_the_weights_are_the_models_and_follow_the_seed(small_root):
    import torch
    from laplace_gnn_torch.training import sparse_experiment as se
    import types
    root, _ = small_root
    with open(os.path.join(root, "benchmark", "configs",
                           "sparsegat-arxiv-small.json")) as f:
        cfg = json.load(f)
    drv = _driver(root)
    w = drv.gat_weights(5, cfg, "cpu")
    assert torch.equal(w["convs.1.att_src"],
                       drv.gat_weights(5, cfg, "cpu")["convs.1.att_src"])
    assert not torch.equal(w["convs.0.lin.weight"],
                           drv.gat_weights(6, cfg, "cpu")[
                               "convs.0.lin.weight"])
    n = 40
    ei = torch.stack([torch.arange(n), (torch.arange(n) + 1) % n])
    data = types.SimpleNamespace(
        edge_index=torch.cat([ei, ei.flip(0)], 1).numpy(), num_nodes=n,
        num_features=cfg["n_features"], num_classes=cfg["n_classes"],
        x=torch.zeros(n, cfg["n_features"]))
    args = se.argument_parser().parse_args(
        ["--model_type", "sparsegat", "--hidden_channels",
         str(cfg["hidden_channels"]), "--heads", str(cfg["heads"]),
         "--num_layers", str(cfg["num_layers"])])
    model = se.build_model(args, data, se.build_graph(args, data, "cpu"),
                           device="cpu", **cfg["model_options"])
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        k: tuple(v.shape) for k, v in model.params().items()}


def test_attention_counts_by_hand():
    # 5 nodes, 7 stored edges, 2 heads of 3, bf16 rows, int64 indices
    fwd_bytes = 7 * ((6 + 2) * 2 + 8) + 5 * (6 + 2) * 4
    assert gat_counts.attention_bytes(7, 5, 2, 3, 2) == fwd_bytes
    assert gat_counts.attention_flops(7, 2, 3) == 2 * 7 * 6
    layers = [(4, 2, 3, True), (6, 2, 2, False)]
    want = 3 * counts.bound_s(fwd_bytes, 84) + 3 * counts.bound_s(
        7 * ((4 + 2) * 2 + 8) + 5 * (4 + 2) * 4, 2 * 7 * 4)
    assert gat_counts.attention_bound_s(7, 5, layers, 2) == \
        pytest.approx(want)
    assert want == pytest.approx(3 * (fwd_bytes + 7 * 20 + 5 * 24)
                                 / peaks.HBM_BYTES_PER_S)


def test_epoch_flops_by_hand():
    # 5 nodes, 7 stored edges; 4 -> 2 heads of 3 (residual) -> 2 heads of 2
    lin0 = 2 * 5 * 4 * 6 * 2                   # fc and residual
    rest0 = 2 * 2 * 5 * 6 + 5 * 7 * 2 + 2 * 7 * 6
    lin1 = 2 * 5 * 6 * 4
    rest1 = 2 * 2 * 5 * 4 + 5 * 7 * 2 + 2 * 7 * 4
    want = (lin0 + 3 * rest0 + lin0) + (lin1 + 3 * rest1 + 2 * lin1)
    layers = [(4, 2, 3, True), (6, 2, 2, False)]
    assert gat_counts.epoch_flops(5, 7, layers) == want


def test_layers_of_the_published_configuration():
    with open(os.path.join(tinyroot.BENCH_DIR, "configs",
                           "sparsegat-arxiv.json")) as f:
        cfg = json.load(f)
    assert gat_counts.layers(cfg) == [(128, 3, 250, True),
                                      (750, 3, 250, True),
                                      (750, 3, 40, False)]
    # the Linears of the forward, about 0.48 TFLOP an epoch
    n = cfg["n_nodes"]
    lin = sum(2 * n * i * h * f * (2 if r else 1)
              for i, h, f, r in gat_counts.layers(cfg))
    assert 0.47e12 < lin < 0.49e12


def test_a_run_of_the_cell_loads_no_jax(tmp_path):
    code = f"""
        import json, sys
        sys.path[:0] = [{tinyroot.BENCH_DIR!r},
                        {os.path.dirname(os.path.abspath(__file__))!r}]
        import tinyroot, tinygat, run
        root = tinyroot.copy_checkout({str(tmp_path)!r})
        cell = tinygat.add_small_gat_cell(root)
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
        spec = importlib.util.spec_from_file_location("sparse_gat",
            {os.path.join(tinyroot.BENCH_DIR, 'references',
                          'sparse_gat.py')!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "laplace_gnn_tpu",
                      "laplace_gnn_torch"}
