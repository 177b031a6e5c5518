"""The plain references agree with the program's CPU path in float64 at a
small size (the program is the measured system; the references import
nothing of it)."""

import json
import os

import numpy as np
import torch

from benchlib import graphs
from benchlib.drive import make_weights
from tinyroot import BENCH_DIR, SMALL


def _config(name):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg.update(SMALL[name])
    return cfg


def _reference(name):
    import types
    from benchlib.drive import load_reference
    return load_reference(types.SimpleNamespace(bench_dir=BENCH_DIR), name)


def test_stegcn_whole_run_matches_the_program_in_float64():
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import \
        marglik_optimization_scan
    cfg = dict(_config("stegcn-cora"), dtype="float64")
    seed = 2 ** 33 + 1
    n, f, c, h = (cfg["n_nodes"], cfg["n_features"], cfg["n_classes"],
                  cfg["hidden_channels"])
    X, adj, y = graphs.cora_like(seed, n, f, c,
                                 cfg["n_directed_edges"] / n ** 2, "cpu")
    X = X.double()
    model = STEGCN(f, h, c, 2, X, adj, dropout_p=cfg["dropout"],
                   threshold=cfg["threshold"], symmetric=True, fused=True,
                   device="cpu", dtype=torch.float64)
    w0 = {k: v.double() for k, v in
          make_weights(seed, [f, h, c], "cpu").items()}
    params = {"adj": model.adj.detach().clone(), **w0}
    tr, va = graphs.node_split(seed, n, (cfg["n_train"], cfg["n_val"]),
                               "cpu")
    keys = ("lr", "lr_adj", "weight_decay", "weight_decay_adj",
            "momentum_adj", "n_epochs", "n_hypersteps", "n_epochs_burnin",
            "n_hyper_stop", "marglik_frequency", "grad_norm",
            "prior_precision")
    _, final, losses, vls, nms = marglik_optimization_scan(
        model, params, tr, y[tr], va, y[va], device="cpu",
        **{k: cfg[k] for k in keys})
    ref = _reference("stegcn").whole_run(X, adj, w0, (tr, y[tr], va, y[va]),
                                         cfg, "float64", "cpu")
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-10)
    np.testing.assert_allclose(vls, ref["val_loss"], rtol=1e-10)
    np.testing.assert_allclose(nms, ref["neg_marglik"], rtol=1e-10)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(final[k].numpy(), v.numpy(), rtol=1e-9,
                                   atol=1e-12)
    # the run moved the weights and shrank the adjacency
    assert float((final["convs.0.lin.weight"] - w0["convs.0.lin.weight"])
                 .abs().max()) > 1e-3
    assert 0.5 < float(final["adj"].max()) < 1.0


def test_sparse_gcn_steps_match_the_program_in_float64():
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.models import SparseGCN
    from laplace_gnn_torch.training import sparse_experiment as se
    from laplace_gnn_torch.training.marglik_gnn import DeviceAdam
    cfg = _config("sparsegcn-arxiv")
    seed = 2 ** 33 + 2
    n, f, c, h = (cfg["n_nodes"], cfg["n_features"], cfg["n_classes"],
                  cfg["hidden_channels"])
    x, y, ei = graphs.arxiv_like(seed, n, f, c, cfg["n_undirected_draws"],
                                 cfg["max_degree"], "cpu")
    g = C.add_ell_format(C.sparse_from_edge_index(
        ei.numpy(), n, normalize="sym", dtype=torch.float64, device="cpu"))
    model = SparseGCN(f, h, c, 3, x.double(), g, dropout_p=0.0,
                      device="cpu", dtype=torch.float64)
    w0 = {k: v.double() for k, v in
          make_weights(seed, [f, h, h, c], "cpu").items()}
    params = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    opt = DeviceAdam(params.values(), lr=cfg["lr"])
    (tr,) = graphs.node_split(seed, n, (cfg["n_train"],), "cpu")
    se.train_steps(model, params, opt, tr, y[tr], 1)
    grad1 = {k: m / 0.1 for k, m in zip(params, opt.exp_avg)}
    se.train_steps(model, params, opt, tr, y[tr], 2)
    ref = _reference("sparse_gcn").train_steps(x.double(), ei, y, tr, w0,
                                               cfg, 3)
    for k in w0:
        np.testing.assert_allclose(grad1[k].detach().numpy(),
                                   ref["grad1"][k].numpy(), rtol=1e-9,
                                   atol=1e-14)
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   ref["params"][k].numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_last_layer_laplace_matches_the_program_in_float64():
    import argparse
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.models import SparseGCN
    from laplace_gnn_torch.training import sparse_experiment as se
    cfg = _config("sparsegcn-arxiv")
    seed = 2 ** 33 + 3
    n, f, c, h = (cfg["n_nodes"], cfg["n_features"], cfg["n_classes"],
                  cfg["hidden_channels"])
    x, y, ei = graphs.arxiv_like(seed, n, f, c, cfg["n_undirected_draws"],
                                 cfg["max_degree"], "cpu")
    g = C.add_ell_format(C.sparse_from_edge_index(
        ei.numpy(), n, normalize="sym", dtype=torch.float64, device="cpu"))
    model = SparseGCN(f, h, c, 3, x.double(), g, dropout_p=0.0,
                      device="cpu", dtype=torch.float64)
    w = {k: v.double() for k, v in
         make_weights(seed, [f, h, h, c], "cpu").items()}
    tr, _, te = graphs.node_split(seed, n, (cfg["n_train"], cfg["n_val"],
                                            cfg["n_test"]), "cpu")
    args = se.argument_parser().parse_args(["--n_mc_samples", "5"])
    la = se.fit_posterior(args, model, w, tr, y[tr])
    probs = se.predict(args, model, w, la, te)
    eps = torch.randn((5, c + c * h), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    ref = _reference("sparse_gcn").last_layer_laplace(
        x.double(), ei, y, tr, te, w, cfg, 5, eps)
    assert abs(float(la.prior_precision[0]) - ref["prior_precision"]) \
        < 1e-8 * ref["prior_precision"]
    assert abs(float(la.log_marginal_likelihood()) - ref["log_marglik"]) \
        < 1e-8 * abs(ref["log_marglik"])
    np.testing.assert_allclose(probs["map"], ref["map"].numpy(), atol=1e-6)
    np.testing.assert_allclose(probs["laplace"], ref["mc"].numpy(),
                               atol=1e-6)


def test_kron_evaluation_matches_the_program_in_float64():
    from laplace_gnn_torch.laplace.predictive import probit_predictive
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import fit_laplace, \
        mean_eval
    cfg = dict(_config("stegcn-cora"), dtype="float64")
    seed = 2 ** 33 + 4
    n, f, c, h = (cfg["n_nodes"], cfg["n_features"], cfg["n_classes"],
                  cfg["hidden_channels"])
    X, adj, y = graphs.cora_like(seed, n, f, c,
                                 cfg["n_directed_edges"] / n ** 2, "cpu")
    X = X.double()
    model = STEGCN(f, h, c, 2, X, adj, dropout_p=cfg["dropout"],
                   threshold=cfg["threshold"], symmetric=True, fused=True,
                   device="cpu", dtype=torch.float64)
    w = {k: v.double() for k, v in
         make_weights(seed, [f, h, c], "cpu").items()}
    # a learned adjacency: the graph's with a few edges below threshold
    a = model.adj.detach().clone()
    a[0, 1:6] = 0.3
    params = {"adj": a, **w}
    tr, va, te = graphs.node_split(seed, n, (cfg["n_train"], cfg["n_val"],
                                             cfg["n_test"]), "cpu")
    la = fit_laplace(model, params, tr, y[tr], subset_of_weights="all",
                     hessian_structure="kron")
    f_mu, f_var = la._glm_predictive_distribution(te)
    ref = _reference("stegcn").kron_evaluation(
        X, params, y, (tr, y[tr], va, y[va], te, y[te]), cfg)
    np.testing.assert_allclose(float(la.log_marginal_likelihood()),
                               ref["log_marglik"], rtol=1e-10)
    np.testing.assert_allclose(mean_eval(model, params, va, y[va])[0],
                               ref["val_loss"], rtol=1e-10)
    np.testing.assert_allclose(probit_predictive(f_mu, f_var).numpy(),
                               ref["probit"].numpy(), atol=1e-12)
    np.testing.assert_allclose(torch.softmax(f_mu, -1).numpy(),
                               ref["map"].numpy(), atol=1e-12)
