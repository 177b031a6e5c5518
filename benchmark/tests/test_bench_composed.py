"""The ``stegcn-cora-composed.marglik`` cell on the CPU at a tiny size: the
program's composed whole run against the plain reference of the STE
hypergradient in float64 (traces, final weights and adjacency, a run in
which entries cross the threshold included), one hyperstep's gradient
against the reference's, the reference's gradient nonzero where the fused
reference's is zero; through the harness the sound path is correct and
the control and each planted fault are not, under the full cell's limits;
the counts of ``benchlib/composed_counts.py`` by hand; the configuration
against ``stegcn-cora``'s; and a run of the cell loads nothing of JAX, in
a fresh process.

Importing this file enters the cell's small configuration
(``tinycomposed.SMALL_COMPOSED``) in ``tinyroot.SMALL``, for the tests
that build a small copy of every cell."""

import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import run
import tinycomposed
import tinyroot
from benchlib import compare, composed_counts, counts, graphs
from benchlib.drive import load, make_weights

tinyroot.SMALL.setdefault(tinycomposed.CONFIG, tinycomposed.SMALL_COMPOSED)

TRAIN_KEYS = ("lr", "lr_adj", "weight_decay", "weight_decay_adj",
              "momentum_adj", "n_epochs", "n_hypersteps", "n_epochs_burnin",
              "n_hyper_stop", "marglik_frequency", "grad_norm",
              "prior_precision")


def _ctx(root=tinyroot.ROOT):
    return types.SimpleNamespace(bench_dir=os.path.join(root, "benchmark"))


def _reference(name="stegcn_composed"):
    return load(_ctx(), "references", name)


def _config(name="stegcn-cora-composed.json", root=tinyroot.ROOT):
    with open(os.path.join(root, "benchmark", "configs", name)) as f:
        return json.load(f)


def _small_f64(**over):
    cfg = dict(_config(), **tinycomposed.SMALL_COMPOSED)
    cfg.update(dtype="float64", **over)
    return cfg


def _inputs(cfg, seed):
    n, f, c, h = (cfg["n_nodes"], cfg["n_features"], cfg["n_classes"],
                  cfg["hidden_channels"])
    X, adj, y = graphs.cora_like(seed, n, f, c,
                                 cfg["n_directed_edges"] / n ** 2, "cpu")
    w0 = {k: v.double() for k, v in
          make_weights(seed, [f, h, c], "cpu").items()}
    tr, va = graphs.node_split(seed, n, (cfg["n_train"], cfg["n_val"]),
                               "cpu")
    return X.double(), adj, y, w0, (tr, y[tr], va, y[va])


def _model(cfg, X, adj):
    from laplace_gnn_torch.models import STEGCN
    return STEGCN(cfg["n_features"], cfg["hidden_channels"],
                  cfg["n_classes"], 2, X, adj, dropout_p=cfg["dropout"],
                  threshold=cfg["threshold"], symmetric=cfg["symmetric"],
                  fused=cfg["fused"], device="cpu", dtype=torch.float64)


def _flips(r, cfg, adj_raw, adj):
    thr, sym = cfg["threshold"], cfg["symmetric"]
    start = r.binarized(r.initial_adjacency(adj_raw.to(adj), sym), thr, sym)
    return int((r.binarized(adj, thr, sym) != start).sum())


# seeds whose runs cross the threshold (flips) and one that crosses none
@pytest.mark.parametrize("seed,lr_adj,crosses", [
    (2 ** 33 + 5, 2.0, True), (41, 2.0, True), (2 ** 33 + 5, 0.8, False)])
def test_the_composed_whole_run_matches_the_reference_in_float64(
        seed, lr_adj, crosses):
    from laplace_gnn_torch.training.marglik_gnn import \
        marglik_optimization_scan
    cfg = _small_f64(lr_adj=lr_adj)
    X, adj, y, w0, split = _inputs(cfg, seed)
    model = _model(cfg, X, adj)
    params = {"adj": model.adj.detach().clone(), **w0}
    tr, ytr, va, yva = split
    _, final, losses, vls, nms = marglik_optimization_scan(
        model, params, tr, ytr, va, yva, device="cpu", model_type="stegcn",
        **{k: cfg[k] for k in TRAIN_KEYS})
    r = _reference()
    ref = r.whole_run(X, adj, w0, split, cfg, "float64", "float64", "cpu")
    for got, want in ((losses, ref["loss"]), (vls, ref["val_loss"]),
                      (nms, ref["neg_marglik"])):
        assert compare.trace_gap(got, want) < 1e-10
    assert compare.max_abs_gap(final["adj"], ref["params"]["adj"]) < 1e-10
    for k in w0:
        assert compare.max_abs_gap(final[k], ref["params"][k]) < 1e-10
    assert (_flips(r, cfg, adj, ref["params"]["adj"]) > 0) == crosses
    # the hypersteps moved the graph by more than the decay: the gradient
    assert compare.max_abs_gap(final["adj"], params["adj"]) > 1e-3


def test_one_hyperstep_gradient_is_the_references():
    from laplace_gnn_torch.training import marglik_gnn as mg
    cfg = _small_f64(grad_norm=False)
    X, adj, y, w0, split = _inputs(cfg, 2 ** 32 + 9)
    tr, ytr, _, _ = split
    model = _model(cfg, X, adj)
    params = {k: v.requires_grad_(True) for k, v in
              {"adj": model.adj.detach().clone(), **w0}.items()}
    adj0 = params["adj"].detach().clone()
    progs = mg.TrainingPrograms(
        model, params, lr=cfg["lr"], weight_decay=cfg["weight_decay"],
        lr_adj=cfg["lr_adj"], weight_decay_adj=cfg["weight_decay_adj"],
        momentum_adj=cfg["momentum_adj"], grad_norm=False,
        hessian_structure="kron", subset_of_weights="all",
        prior_precision=cfg["prior_precision"], N=len(tr))
    progs.hyperstep(tr, ytr)
    r = _reference()
    stegcn = _reference("stegcn")
    ref_model = stegcn.Model(X, 2, "float64")
    A0 = X.T @ X / len(tr)
    static = torch.clamp(torch.linalg.eigvalsh(A0), min=0.0)
    args = (ref_model, w0, adj0, "float64", cfg["threshold"],
            cfg["symmetric"], tr, ytr, cfg["prior_precision"], static)
    want = r.adjacency_gradient(*args)
    got = params["adj"].grad
    assert float(want.abs().max()) > 1e-4
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                               atol=1e-12 * float(want.abs().max()))
    # the fused reference's gradient at the same point is zero
    assert float(stegcn.adjacency_gradient(*args).abs().max()) == 0.0


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = tinyroot.copy_checkout(str(tmp_path_factory.mktemp("composed")))
    return root, tinycomposed.add_small_composed_cell(root)


def _run(root, cell, capsys, seed, trace="0"):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.3", "--trace", trace], device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _driver(root):
    return load(_ctx(root), "drivers", "stegcn_composed_run")


@pytest.mark.parametrize("seed", [2 ** 33 + 7, 41])
def test_the_sound_path_is_correct(small_root, capsys, seed):
    root, small = small_root
    result = _run(root, small, capsys, seed)
    assert result["correct"] is True, result["compared"]
    assert result["compared"]["flips_gap"]["value"] == 0
    assert set(result["metrics"]) == {"setup_s", "run_s"}


def test_a_traced_run_reports_what_the_cpu_can_read(small_root, capsys):
    """On the CPU the trace has no device time: the eigenvectors' and the
    idle share read nothing and are left out; the MFU is read."""
    root, small = small_root
    result = _run(root, small, capsys, 2 ** 32 + 5, trace="1")
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"mfu.composed"}
    assert 0 < result["metrics"]["mfu.composed"]["value"]


@pytest.mark.parametrize("fault", ["state_unchanged", "adj_unchanged",
                                   "half_batch", "answer_altered",
                                   "hypergrad_zero"])
def test_a_broken_path_is_not_correct(small_root, capsys, fault):
    root, small = small_root
    with _driver(root).FAULTS[fault]():
        result = _run(root, small, capsys, 31)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("seed", [31, 2 ** 32 + 77])
def test_the_control_is_not_correct(small_root, seed):
    """The reference at TF32 products in the program's place fails at
    least one of the full cell's limits."""
    root, small = small_root
    bench = run.read_json(os.path.join(root, "BENCHMARK.json"))
    w = {w["name"]: w for w in bench["workloads"]}[small]
    ctx = run.Context(root, w, bench, seed, 0.0, False, torch.device("cpu"))
    c = _driver(root).setup(ctx)
    c.unit(0)
    c.release()
    judged = compare.judged(compare.worst(c.control()),
                            ctx.limits["limits"])
    assert any(v > lim for _, v, lim in judged), judged


def test_the_configuration_is_stegcn_coras_on_the_composed_route():
    mine, fused = _config(), _config("stegcn-cora.json")
    differ = {k for k in set(mine) | set(fused)
              if mine.get(k) != fused.get(k)}
    assert differ == {"fused", "agg_dtype", "reference",
                      "control_precision", "reduced", "assumed", "about"}
    assert (mine["fused"], mine["agg_dtype"], mine["reference"]) == (
        False, "float32", "stegcn_composed")
    assert mine["control_precision"] == ["tf32", "tf32"]
    assert mine["reduced"] == []
    assert {"graph", "split", "weights", "prior_precision",
            "fused"} <= set(mine["assumed"])
    with open(os.path.join(tinyroot.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = {c["name"]: c for c in bench["configs"]}["stegcn-cora-composed"]
    assert entry["reduced"] == []
    assert entry["source"] == mine["source"]


def test_run_flops_by_hand():
    n, f, h, c, epochs, hyper = 5, 4, 3, 2, 7, 3
    evaluation = counts.stegcn_run_flops(n, f, h, c, 0, 1)
    # the aggregations of an evaluation: h and c in the forward, and in
    # each of the c pullbacks; each one's gradient into the adjacency
    dadj = sum(2 * n * n * d for d in [h, c] + [c, h] * c)
    assert composed_counts.run_flops(n, f, h, c, epochs, hyper) == (
        counts.stegcn_run_flops(n, f, h, c, epochs, hyper)
        + hyper * (evaluation + dadj))


def test_a_run_of_the_cell_loads_no_jax(tmp_path):
    code = f"""
        import json, sys
        sys.path[:0] = [{tinyroot.BENCH_DIR!r},
                        {os.path.dirname(os.path.abspath(__file__))!r}]
        import tinyroot, tinycomposed, run
        root = tinyroot.copy_checkout({str(tmp_path)!r})
        cell = tinycomposed.add_small_composed_cell(root)
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
        spec = importlib.util.spec_from_file_location("stegcn_composed",
            {os.path.join(tinyroot.BENCH_DIR, 'references',
                          'stegcn_composed.py')!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "laplace_gnn_tpu",
                      "laplace_gnn_torch"}
