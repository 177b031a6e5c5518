"""Port parity for the data and experiment layer: graph/datasets.py
(loaders and the random splits, which the port draws without scikit-learn),
graph/data.py (k-NN graph), models/models.py::MODEL_REGISTRY, the config
copies, and training/experiment.py::main, torch against JAX on the CPU.

``main`` runs both experiments on karate in float64 with dropout 0: the JAX
init of each repeat is carried across by patching the port's
``BaseGNN.init``, so the two runs start from the same parameters and their
stats agree at 1e-7 relative (a few Adam steps and hypersteps amplify the
last bits; JAX averages accuracies in float32)."""

import filecmp
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from laplace_gnn_tpu.curvature import kfac as JK
from laplace_gnn_tpu.graph import data as JD
from laplace_gnn_tpu.graph import datasets as JDS
from laplace_gnn_tpu.models import base_gnn as JB
from laplace_gnn_tpu.training import experiment as JX
from laplace_gnn_torch.curvature import kfac as TK
from laplace_gnn_torch.graph import data as TD
from laplace_gnn_torch.graph import datasets as TDS
from laplace_gnn_torch.models import base_gnn as TB
from laplace_gnn_torch.models.models import MODEL_REGISTRY
from laplace_gnn_torch.ops import adjacency as TA
from laplace_gnn_torch.training import experiment as TX
from laplace_gnn_torch.utils.pytree import params_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n_splits", [1, 3])
@pytest.mark.parametrize("n", [34, 100, 2708])
def test_random_splits_equal_sklearn(n, n_splits):
    x = np.zeros((n, 2), np.float32)
    j = JD.GraphData(x=x, y=np.zeros(n, int), edge_index=np.zeros((2, 0)))
    t = TD.GraphData(x=x, y=np.zeros(n, int), edge_index=np.zeros((2, 0)))
    JDS.add_random_splits(j, n_splits)
    TDS.add_random_splits(t, n_splits)
    for part in ("train_indices", "val_indices", "test_indices"):
        np.testing.assert_array_equal(getattr(t, part), getattr(j, part))
    assert t.train_indices.shape[1] == n_splits
    if n == 2708:         # Cora's size: 1299 / 867 / 542
        assert (t.train_indices.shape[0], t.val_indices.shape[0],
                t.test_indices.shape[0]) == (1299, 867, 542)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_knn_graph_equal_on_tie_free_data(k):
    X = np.random.default_rng(k).standard_normal((150, 6)).astype(np.float32)
    got, ei = TD.get_knn_graph(X, k, return_edge_index=True)
    want, wei = JD.get_knn_graph(X, k, return_edge_index=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ei, wei)
    assert np.all(np.diag(got) == 1) and np.array_equal(got, got.T)


def test_knn_blocks_do_not_change_the_graph():
    X = np.random.default_rng(0).standard_normal((97, 4))
    np.testing.assert_array_equal(TD.knn_indices(X, 4, row_block=10),
                                  TD.knn_indices(X, 4))


def _same_data(t, j):
    for f in ("x", "y", "edge_index", "train_indices", "val_indices",
              "test_indices"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert (t.num_nodes, t.num_features, t.num_classes, t.num_edges) == \
        (j.num_nodes, j.num_features, j.num_classes, j.num_edges)
    np.testing.assert_array_equal(t.adjacency(), j.adjacency())


@pytest.mark.parametrize("name,kw", [
    ("karate", {}), ("sbm", {"n_nodes": 300, "n_classes": 3}),
    ("moons", {"n_samples": 60}), ("banana", {"n_samples": 80})])
def test_builtin_datasets_match(name, kw, tmp_path):
    _same_data(TDS.load_data(name, 2, root=str(tmp_path), **kw),
               JDS.load_data(name, 2, root=str(tmp_path), **kw))


def test_npz_dataset_and_unported_parsers(tmp_path):
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "toy.npz", x=rng.standard_normal((50, 4)),
             y=rng.integers(0, 3, 50), edge_index=rng.integers(0, 50, (2, 80)))
    _same_data(TDS.load_data("toy", 1, root=str(tmp_path)),
               JDS.load_data("toy", 1, root=str(tmp_path)))
    # the raw-file parsers (ported since): absent files raise as in JAX
    for name, what in (("cora", "Planetoid"), ("texas", "geom-gcn")):
        for pkg in (TDS, JDS):
            with pytest.raises(FileNotFoundError, match=f"{what} raw files"):
                pkg.load_data(name, root=str(tmp_path))
    with pytest.raises(ValueError, match="Unknown dataset"):
        TDS.load_data("nothing", root=str(tmp_path))


def test_fully_connected_labels_and_edge_index():
    y = np.array([0, 1, 0, 2, 1])
    np.testing.assert_array_equal(TD.fully_connected_labels(y),
                                  JD.fully_connected_labels(y))
    adj = (np.random.default_rng(2).random((9, 9)) < 0.3).astype(float)
    np.testing.assert_array_equal(TD.adj_to_edge_index(adj),
                                  JD.adj_to_edge_index(adj))


def test_config_copies_are_byte_identical():
    ours = REPO / "laplace_gnn_torch" / "training" / "configs"
    theirs = REPO / "laplace_gnn_tpu" / "training" / "configs"
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*.yaml"))
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*.yaml"))
    assert files
    for f in files:
        assert filecmp.cmp(ours / f, theirs / f, shallow=False), f


def test_registry_and_parser_keep_the_jax_keys():
    assert list(MODEL_REGISTRY) == \
        JX.argument_parser()._option_string_actions["--model_type"].choices
    assert TX.argument_parser()._option_string_actions[
        "--model_type"].choices == list(MODEL_REGISTRY)
    # every key constructs with the experiment's model-specific arguments
    args = vars(TX.argument_parser().parse_args([]))
    hp = {"ste_thresh": 0.5, "lora_r": 2}
    eye = np.eye(6)
    for key, cls in MODEL_REGISTRY.items():
        spec = TX.model_specific_args({**args, "model_type": key}, hp,
                                      np.arange(3))
        model = cls(6, 4, 2, 2, eye, eye, device="cpu", **spec)
        assert type(model).__name__ == type(JX.MODEL_REGISTRY[key](
            6, 4, 2, 2, eye, eye, **spec)).__name__
        assert model.apply(model.params(), None).shape == (6, 2)
    with pytest.raises(KeyError):
        MODEL_REGISTRY["nope"]
    t = vars(TX.argument_parser().parse_args([]))
    j = vars(JX.argument_parser().parse_args([]))
    assert t == j


def test_load_config_and_hyperparam_space_match():
    args = vars(JX.argument_parser().parse_args(
        ["--dataset", "cora", "--model_type", "stegcn", "--init_graph",
         "knng"]))
    t, j = TX.load_config(dict(args)), JX.load_config(dict(args))
    assert t == j and t["hidden_channels"] == 64 and t["lr_adj"] == 0.8
    assert TX.hyperparam_space(t) == JX.hyperparam_space(j)


ARGS = ["--dataset", "karate", "--overwrite_config", "true",
        "--n_epochs", "6", "--n_epochs_burnin", "2", "--marglik_frequency",
        "2", "--n_hypersteps", "2", "--n_data_rand_splits", "2",
        "--n_repeats", "1", "--hidden_channels", "8", "--lr", "0.01",
        "--weight_decay", "5e-4", "--dropout_p", "0.0", "--res", "false",
        "--ste_thresh", "0.5", "--lr_adj", "0.3", "--weight_decay_adj",
        "5e-4", "--symmetric", "true"]


def _main_both(argv, tmp_path, monkeypatch, capsys):
    """``main`` of both packages on ``argv``, the JAX init of each repeat
    carried into the port; the stats and summaries must agree."""
    inits, depth = [], [0]

    def recording(j_init):
        """The outermost init call's params (a model's own init adds its
        parameters around BaseGNN.init's)."""
        def recording_init(self, key, dtype=None):
            depth[0] += 1
            try:
                p = j_init(self, key, dtype)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                inits.append(jax.tree_util.tree_map(np.asarray, p))
            return p
        return recording_init

    for cls in {JB.BaseGNN, *JX.MODEL_REGISTRY.values()}:
        if "init" in vars(cls):
            monkeypatch.setattr(cls, "init", recording(vars(cls)["init"]))
    j = JX.main(argv + ["--base_out_dir", str(tmp_path / "jax")])
    carried = list(inits)
    monkeypatch.setattr(TB.BaseGNN, "init", lambda self, generator=None:
                        params_from_numpy(carried.pop(0), device="cpu",
                                          dtype=torch.float64))
    t = TX.main(argv + ["--base_out_dir", str(tmp_path / "torch")],
                device="cpu")
    capsys.readouterr()
    assert not carried and len(inits) == 2          # one init per split
    assert os.path.exists(tmp_path / "torch" / "karate" / "stats.pkl")
    assert t["args"] == {**j["args"], "base_out_dir": str(tmp_path / "torch")}
    assert len(t["results"]) == len(j["results"]) == 1
    ts, js = t["results"][0]["stats"], j["results"][0]["stats"]
    assert ts.keys() == js.keys()
    for crit in ts:
        assert ts[crit].keys() == js[crit].keys() and ts[crit]
        for key in ts[crit]:
            np.testing.assert_allclose(np.asarray(ts[crit][key], float),
                                       np.asarray(js[crit][key], float),
                                       rtol=1e-7, atol=1e-9, err_msg=key)
    assert t["summary"].keys() == j["summary"].keys()
    for crit, entry in t["summary"].items():
        assert entry["hyperparams"] == j["summary"][crit]["hyperparams"]
        assert entry["test_acc_mean"] == pytest.approx(
            j["summary"][crit]["test_acc_mean"], rel=1e-7)
    return t


@pytest.mark.parametrize("model_type,extra", [
    ("gcn", []), ("stegcn", []), ("graphsage", []), ("stegraphsage", []),
    ("lorastegcn", ["--lora_r", "2", "--lora_alpha", "8"]),
    ("attstegcn", [])])
def test_main_matches_jax_on_karate(model_type, extra, tmp_path, monkeypatch,
                                    capsys):
    """Every model key through ``main``, with its model-specific flags.
    GraphSAGE samples 10 neighbours a row in its train steps: JAX's
    uniforms of each epoch's key are replayed in the port."""
    n_epochs = int(ARGS[ARGS.index("--n_epochs") + 1])
    rng, draws = jax.random.PRNGKey(0), []
    for _ in range(n_epochs):      # the JAX trainer's key of each epoch
        rng, sub = jax.random.split(rng)
        draws.append(np.asarray(jax.random.uniform(jax.random.split(sub)[0],
                                                   (34, 34))))
    calls = iter(range(10 ** 6))
    monkeypatch.setattr(TA, "_neigh_uniforms",
                        lambda n, generator, dtype, device: torch.tensor(
                            draws[next(calls) % n_epochs], dtype=dtype))
    _main_both(ARGS + ["--model_type", model_type] + extra, tmp_path,
               monkeypatch, capsys)
    assert (next(calls) > 0) == (model_type == "graphsage")


def test_experiment_options_and_diag_fit_match_jax(tmp_path, monkeypatch,
                                                   capsys):
    """The curvature options reach the hypersteps as in JAX: a sketched
    type-2 Fisher in blocks of 2 columns (JAX's sketch carried into the
    port) on karate. Then the whole experiment with a "diag" Laplace (its
    hypersteps and post-hoc fits), residual Linears and batch norms,
    against JAX."""
    monkeypatch.setattr(TK, "_sketch_projection",
                        lambda seed, C, k, dtype, device=None: torch.tensor(
                            np.asarray(JK._sketch_projection(
                                seed, C, k, np.float64)), dtype=dtype))
    t = _main_both(ARGS + ["--model_type", "stegcn", "--fisher_type",
                           "type-2-sketch", "--sketch_size", "4",
                           "--column_chunk", "2", "--fisher_seed", "3"],
                   tmp_path, monkeypatch, capsys)
    assert (t["args"]["sketch_size"], t["args"]["column_chunk"]) == (4, 2)
    t = _main_both(ARGS + ["--model_type", "stegcn", "--hessian_structure",
                           "diag", "--n_epochs", "4", "--res", "true",
                           "--norm", "batch"],
                   tmp_path / "diag", monkeypatch, capsys)
    assert (t["args"]["hessian_structure"], t["args"]["res"],
            t["args"]["norm"]) == ("diag", True, "batch")
