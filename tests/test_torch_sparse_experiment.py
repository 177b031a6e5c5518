"""The sparse CLI (training/sparse_experiment.py) on the CPU, with the
utilities it stands on: checkpoints (utils/checkpoint.py), profiling
(profiling.py), the baseline evaluator (training/eval_baselines.py) and
``parallel/distributed.py::initialize``.

The CLI's flags, defaults and choices equal JAX's; a run on a small SBM
trains to a MAP accuracy above 0.5, and a checkpointed run resumed from
its newest checkpoint ends within 1e-5 of a straight run (as
``tests/test_training.py`` asks of JAX). The baseline evaluator's dict
equals JAX's under the same deterministic runner."""

import contextlib
import io
import os
import socket

import numpy as np
import pytest
import torch

from laplace_gnn_tpu.training import eval_baselines as JE
from laplace_gnn_tpu.training import sparse_experiment as JS
from laplace_gnn_torch import profiling
from laplace_gnn_torch.parallel import initialize
from laplace_gnn_torch.training import eval_baselines as TE
from laplace_gnn_torch.training import sparse_experiment as TS
from laplace_gnn_torch.utils import (TrainCheckpointer, load_laplace,
                                     load_pytree, save_laplace, save_pytree)

SBM = ["--dataset", "sbm", "--n_nodes", "300", "--n_classes", "3",
       "--d_features", "8", "--hidden_channels", "16", "--n_mc_samples",
       "5"]


# --- checkpoints ----------------------------------------------------------

def test_pytree_round_trip(tmp_path):
    tree = {"a": torch.arange(5.0), "b": [torch.ones(2, 2), "meta"],
            "c": (torch.zeros(3, dtype=torch.bfloat16), None), "n": 7}
    path = str(tmp_path / "sub" / "ck.pkl")
    save_pytree(path, tree)
    back = load_pytree(path, device="cpu")
    torch.testing.assert_close(back["a"], torch.arange(5.0))
    assert back["b"][1] == "meta" and back["n"] == 7
    assert isinstance(back["c"], tuple) and back["c"][1] is None
    assert back["c"][0].dtype == torch.float32       # numpy has no bf16
    raw = load_pytree(path, as_torch=False)
    assert isinstance(raw["a"], np.ndarray)
    assert [f for f in os.listdir(tmp_path / "sub")] == ["ck.pkl"]


def test_laplace_checkpoint_round_trip(tmp_path):
    from laplace_gnn_torch.laplace.flavors import DiagLaplace, KronLaplace
    from laplace_gnn_torch.nn import MLP
    from laplace_gnn_torch.utils.data import ArrayLoader
    model = MLP([3, 4, 2], device="cpu", dtype=torch.float64)
    gen = torch.Generator().manual_seed(1)
    X = torch.randn(6, 3, generator=gen, dtype=torch.float64)
    y = torch.tensor([0, 1, 1, 0, 1, 0])
    for flavor in (DiagLaplace, KronLaplace):
        la = flavor(model, model.params(), "classification")
        la.fit(ArrayLoader(X, y, device="cpu"))
        path = str(tmp_path / f"{flavor.__name__}.pkl")
        save_laplace(path, la)
        la2 = flavor(model, model.params(), "classification")
        load_laplace(path, la2)
        torch.testing.assert_close(la2.log_marginal_likelihood(),
                                   la.log_marginal_likelihood(), rtol=0,
                                   atol=0)


def test_train_checkpointer_keeps_the_newest(tmp_path):
    ck = TrainCheckpointer(str(tmp_path), keep=2, device="cpu")
    assert ck.latest() is None
    for step in (1, 2, 3):
        ck.save(step, {"params": {"w": torch.full((2,), float(step))}})
    latest = ck.latest()
    assert latest["step"] == 3
    torch.testing.assert_close(latest["state"]["params"]["w"],
                               torch.full((2,), 3.0))
    assert ck._steps() == [2, 3]


# --- profiling ------------------------------------------------------------

def test_profiling_helpers_on_the_cpu(tmp_path):
    a = torch.ones(64, 64)
    t = profiling.device_time(lambda m: m @ m, a, iters=3)
    assert t >= 0.0
    t = profiling.device_time(lambda m, s: {"out": (m * s, 1)}, a, 2.0,
                              iters=2)
    assert t >= 0.0
    with pytest.raises(ValueError, match="tensor"):
        profiling.device_time(lambda s: s, 2.0)
    assert profiling.memory_stats() == {}      # no card here
    with profiling.annotate("matmul"):     # no profiler: no range
        a @ a
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("matmul"):
            a @ a
    files = sorted(os.listdir(tmp_path / "tr"))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    assert files[0].startswith("counters_") and files[1].startswith("trace_")
    with open(tmp_path / "tr" / files[1]) as f:
        assert "lgnn.matmul" in f.read()


# --- the baseline evaluator -----------------------------------------------

def _runner(x, y, edge_index, tr, va, te, seed=0):
    """Deterministic stand-in for a GSL model: a split- and seed-dependent
    score in [0, 1]."""
    return float((np.sum(tr) * 7 + np.sum(te) + 13 * seed) % 100) / 100


def test_eval_baselines_matches_jax():
    want = JE.evaluate_baseline("karate", "idgl", n_rand_splits=3,
                                n_repeats=2, runner=_runner)
    got = TE.evaluate_baseline("karate", "idgl", n_rand_splits=3,
                               n_repeats=2, runner=_runner)
    assert got == want
    assert TE.BASELINE_MODELS == JE.BASELINE_MODELS


def test_eval_baselines_reports_the_missing_package():
    for mod in (JE, TE):
        with pytest.raises(ImportError, match="GSL"):
            mod.evaluate_baseline("karate", "lds", n_rand_splits=1)
    with pytest.raises(SystemExit):
        TE.argument_parser().parse_args(["--dataset", "karate", "--model",
                                         "gcn"])


# --- initialize -----------------------------------------------------------

def test_initialize_is_a_no_op_without_the_variables(monkeypatch):
    for var in ("LAPLACE_GNN_COORDINATOR", "LAPLACE_GNN_NUM_PROCESSES",
                "LAPLACE_GNN_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_joins_a_one_process_gloo_group(monkeypatch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("LAPLACE_GNN_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("LAPLACE_GNN_NUM_PROCESSES", "1")
    monkeypatch.setenv("LAPLACE_GNN_PROCESS_ID", "0")
    try:
        assert initialize(device="cpu") is False       # one process
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
        assert initialize(device="cpu") is False       # idempotent
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


# --- the CLI --------------------------------------------------------------

def _flags(parser):
    return {a.dest: (a.default, a.choices, a.type, a.required)
            for a in parser._actions if a.dest != "help"}


def test_argument_parser_matches_jax():
    """The port's flags are JAX's, but for one more sparse model type,
    ``sparsegcnii``, which the JAX package lacks."""
    port, jax_ = _flags(TS.argument_parser()), _flags(JS.argument_parser())
    default, choices, kind, required = jax_.pop("model_type")
    assert port.pop("model_type") == (
        default, tuple(choices) + ("sparsegcnii",), kind, required)
    assert port == jax_
    assert _flags(TE.argument_parser()) == _flags(JE.argument_parser())
    assert TS.SPARSE_MODELS == tuple(JS.SPARSE_MODELS) + ("sparsegcnii",)


def test_sparse_experiment_main_on_sbm():
    r = TS.main(SBM + ["--n_nodes", "400", "--n_steps", "60",
                       "--n_mc_samples", "8"], device="cpu")
    assert set(r) == {"map", "laplace"}
    assert set(r["map"]) == {"acc", "nll", "ece"}
    assert r["map"]["acc"] > 0.5
    assert np.isfinite(r["laplace"]["nll"])


@pytest.mark.parametrize("extra", [
    ["--fisher_type", "type-2-sketch", "--sketch_size", "4",
     "--column_chunk", "2", "--subset_of_weights", "all"],
    ["--model_type", "sparsesage", "--hessian_structure", "diag"],
    ["--model_type", "sparsegat", "--heads", "2", "--n_classes", "4",
     "--hidden_channels", "8", "--fisher_type", "mc", "--mc_samples", "2",
     "--diag_probes", "2", "--probe_batch", "2",
     "--subset_of_weights", "all"],
    ["--model_type", "sparsegat", "--heads", "2", "--n_classes", "4",
     "--hidden_channels", "8", "--ell", "0", "--agg_dtype", ""],
], ids=["gcn-sketch", "sage-diag", "gat-mc-probes", "gat-segment"])
def test_sparse_experiment_options(extra):
    r = TS.main(SBM + ["--n_steps", "30"] + extra, device="cpu")
    assert np.isfinite(r["laplace"]["nll"]) and r["map"]["acc"] > 0.5


def test_sparse_experiment_checkpoint_resume(tmp_path):
    common = SBM + ["--checkpoint_dir", str(tmp_path),
                    "--checkpoint_every", "20"]
    TS.main(common + ["--n_steps", "40"], device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000020.pkl",
                                            "ckpt_00000040.pkl"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = TS.main(common + ["--n_steps", "80"], device="cpu")
    assert "resumed from checkpoint step 40" in buf.getvalue()
    # the optimizer state rides in the checkpoint, so the resumed run is
    # step for step the uninterrupted one
    straight = TS.main(SBM + ["--n_steps", "80"], device="cpu")
    for k in ("map", "laplace"):
        assert abs(r[k]["nll"] - straight[k]["nll"]) < 1e-5, (k, r, straight)
