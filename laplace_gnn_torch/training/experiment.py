"""Experiment entry point: CLI, YAML config merge, hyperparameter grid,
and the split x repeat loop of training and post-hoc Laplace evaluation
(counterpart of ``laplace_gnn_tpu/training/experiment.py``). Run with:

    python -m laplace_gnn_torch.training.experiment --dataset karate \\
        --model_type stegcn --overwrite_config true --n_epochs 60 ...

It runs on ``cuda``; ``main(argv, device="cpu")`` runs it on the CPU. The
YAML configs are the port's own copy under ``training/configs``
(``LAPLACE_GNN_CONFIGS`` overrides the directory); PyYAML is imported only
when a config is read.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import warnings
from itertools import product

import numpy as np
import torch

from ..device import resolve_device
from ..graph.data import edge_index_to_adj, get_knn_graph
from ..graph.datasets import load_data
from ..graph.homophily import avg_local_homophilies, global_homophily
from ..models.models import MODEL_REGISTRY
from .evaluate import evaluate_map, evaluate_predictive
from .marglik_gnn import (fit_laplace, marglik_optimization, mean_eval)

BASE_OUT_DIR = "results"

def _to_bool(value: str) -> bool:
    return str(value).lower() in ["true", "1", "yes", "y"]


def argument_parser() -> argparse.ArgumentParser:
    """The JAX experiment's flags, all of them."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str)
    p.add_argument("--model_type", type=str, choices=list(MODEL_REGISTRY))
    p.add_argument("--base_out_dir", type=str, default=BASE_OUT_DIR)
    p.add_argument("--subset_of_weights", type=str, default="all",
                   choices=["all", "last", "last_layer"])
    p.add_argument("--hessian_structure", type=str, default="kron",
                   choices=["full", "diag", "kron"])
    p.add_argument("--hidden_channels", type=int, default=None)
    p.add_argument("--ste_thresh", type=float, default=None)
    p.add_argument("--knng_k", type=int, default=3)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_adj", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=None)
    p.add_argument("--n_epochs", type=int, default=200)
    p.add_argument("--n_hypersteps", type=int, default=10)
    p.add_argument("--n_epochs_burnin", type=int, default=100)
    p.add_argument("--marglik_frequency", type=int, default=20)
    p.add_argument("--init_graph", type=str, default="original")
    p.add_argument("--dropout_p", type=float, default=None)
    p.add_argument("--n_repeats", type=int, default=1)
    p.add_argument("--stop_criterion", type=str, default=None,
                   choices=["valloss", "marglik"])
    p.add_argument("--lora_r", type=int, default=None)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--n_data_rand_splits", type=int, default=10)
    p.add_argument("--n_hyper_stop", type=int, default=None)
    p.add_argument("--norm", type=str, default=None,
                   choices=["none", "batch", "layer"])
    p.add_argument("--res", type=_to_bool, default=None)
    p.add_argument("--weight_decay_adj", type=float, default=None)
    p.add_argument("--heads", type=int, default=1)
    p.add_argument("--symmetric", type=_to_bool, default=False)
    p.add_argument("--train_masked_update", type=_to_bool, default=False)
    p.add_argument("--num_sampled_nodes_per_hop", type=int, default=10)
    p.add_argument("--optimizer", type=str, default="adam",
                   choices=["adam", "sgd"])
    p.add_argument("--grad_norm", type=_to_bool, default=False)
    p.add_argument("--sign_grad", type=_to_bool, default=False)
    p.add_argument("--momentum_adj", type=float, default=0.0)
    p.add_argument("--early_stop", type=_to_bool, default=False)
    p.add_argument("--overwrite_config", type=_to_bool, default=False)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fisher_type", type=str, default="type-2",
                   choices=["type-2", "type-2-fork", "type-2-sketch", "mc",
                            "empirical", "forward-only"])
    p.add_argument("--sketch_size", type=int, default=8,
                   help="type-2-sketch: number of Rademacher combinations k")
    p.add_argument("--column_chunk", type=int, default=None,
                   help="bound type-2 peak memory: pullback columns per "
                        "chunk (None = all at once)")
    p.add_argument("--mc_samples", type=int, default=1,
                   help="MC Fisher samples per fit")
    p.add_argument("--diag_probes", type=int, default=None,
                   help="mixed-structure KFAC (GAT): Hutchinson probes for "
                        "the attention-parameter diagonal instead of the "
                        "exact per-parameter tangent passes")
    p.add_argument("--probe_batch", type=int, default=None,
                   help="vmapped probes per step")
    p.add_argument("--fisher_seed", type=int, default=0,
                   help="base seed for sketch/MC fisher estimators")
    return p


def load_config(args_dict: dict) -> dict:
    """YAML config merge: the Default section, then the dataset's."""
    if not args_dict.get("overwrite_config"):
        cfg_dir = os.environ.get(
            "LAPLACE_GNN_CONFIGS",
            osp.join(osp.dirname(__file__), "configs"))
        config_path = osp.join(cfg_dir, args_dict["init_graph"],
                               f"{args_dict['model_type'].lower()}_config.yaml")
        if osp.exists(config_path):
            import yaml
            with open(config_path) as f:
                config = yaml.safe_load(f)
            args_dict.update(config.get("Default", {}))
            args_dict.update(
                config.get(args_dict["dataset"].capitalize(), {}))
        else:
            warnings.warn(f"No config found at {config_path}; using CLI "
                          "arguments only.")
    return {k: None if str(v).lower() == "none" else v
            for k, v in args_dict.items()}


def initial_adjacency(data, args_dict) -> np.ndarray:
    init_graph = args_dict["init_graph"]
    if init_graph == "original":
        adj = np.minimum(
            edge_index_to_adj(data.edge_index, data.num_nodes), 1.0)
    elif init_graph == "knng":
        adj = get_knn_graph(data.x, args_dict["knng_k"])
    elif init_graph is None:
        adj = np.eye(data.num_nodes)
    elif osp.exists(str(init_graph)):
        with open(init_graph, "rb") as f:
            rst = pickle.load(f)
        adj = edge_index_to_adj(rst["edge_index"], data.num_nodes)
    else:
        raise ValueError(f"Unknown initial graph structure: {init_graph}. "
                         "Choose from 'original', 'knng', 'none'")
    return adj.astype(np.float32)


def hyperparam_space(args_dict) -> dict:
    """The hyperparameter grid."""
    a = args_dict
    is_ste = "ste" in a["model_type"]
    return {
        "res": [True, False] if a["res"] is None else [a["res"]],
        "norm": [a["norm"]],
        "lora_r": ([16, 32, 64] if a["lora_r"] is None
                   and "lora" in a["model_type"] else [a["lora_r"]]),
        "lr": [a["lr"]] if a["lr"] is not None else [0.01, 0.05, 0.1],
        "weight_decay": ([a["weight_decay"]] if a["weight_decay"] is not None
                         else [5e-4, 5e-5, 5e-6]),
        "hidden_channels": ([a["hidden_channels"]]
                            if a["hidden_channels"] is not None
                            else [16, 32, 64]),
        "dropout_p": ([a["dropout_p"]] if a["dropout_p"] is not None
                      else [0.2, 0.3, 0.4, 0.5]),
        "lr_adj": ([0.0] if a["model_type"] in ("gcn", "gat")
                   else [a["lr_adj"]] if a["lr_adj"] is not None
                   else [0.3, 0.4, 0.5, 0.6, 0.7]),
        "ste_thresh": (list(np.arange(0.1, 1.0, 0.1))
                       if is_ste and a["ste_thresh"] is None
                       else [a["ste_thresh"] if is_ste else 0.0]),
        "weight_decay_adj": ([5e-3, 5e-4, 5e-5, 5e-6, 5e-7]
                             if a["weight_decay_adj"] is None and is_ste
                             else [a["weight_decay_adj"] or 0.0]),
    }


def model_specific_args(args_dict, hp, train_indices) -> dict:
    return {
        "stegcn": {"threshold": hp["ste_thresh"],
                   "train_masked_update": args_dict["train_masked_update"],
                   "train_nodes": train_indices,
                   "sign_grad": args_dict["sign_grad"]},
        "stegraphsage": {"threshold": hp["ste_thresh"],
                         "train_masked_update": args_dict["train_masked_update"],
                         "train_nodes": train_indices,
                         "num_sampled_nodes_per_hop":
                             args_dict["num_sampled_nodes_per_hop"],
                         "sign_grad": args_dict["sign_grad"]},
        "graphsage": {"num_sampled_nodes_per_hop":
                      args_dict["num_sampled_nodes_per_hop"]},
        "gcn": {},
        "attstegcn": {"threshold": hp["ste_thresh"]},
        "lorastegcn": {"r": hp["lora_r"],
                       "lora_alpha": args_dict["lora_alpha"]},
        "gat": {"heads": args_dict["heads"]},
    }[args_dict["model_type"]]


def run_experiment(args_dict: dict, verbose: bool = True,
                   device=None) -> dict:
    """Splits x repeats x hyperparameter combinations, each trained by
    ``marglik_optimization`` and evaluated by a fresh Kron Laplace; returns
    the aggregated stats and writes them to ``<out_dir>/stats.pkl``."""
    dev = resolve_device(device)
    args_dict = load_config(args_dict)
    if verbose:
        print("Arguments:")
        for k, v in args_dict.items():
            print(f"\t{k}: {v}")

    data = load_data(args_dict["dataset"], args_dict["n_data_rand_splits"])
    adj = initial_adjacency(data, args_dict)
    sow = ("last_layer" if args_dict["subset_of_weights"] == "last"
           else args_dict["subset_of_weights"])

    h = global_homophily(data.adjacency(), data.y)
    if verbose:
        print(f"Original num edges: {data.num_edges}, Homophily: {h:.3f}")
        print(f"Initial num edges: {int(adj.sum())}")

    if args_dict["stop_criterion"] is None:
        args_dict["stop_criterion"] = (
            "marglik" if "ste" in args_dict["model_type"] else "valloss")
    if args_dict["model_type"] in ("gcn", "gat") \
            and args_dict["stop_criterion"] == "marglik":
        warnings.warn("Marglik should not be used as the stop criteria for "
                      "GCN and GAT models")

    out_dir = osp.join(args_dict["base_out_dir"], str(args_dict["dataset"]))
    os.makedirs(out_dir, exist_ok=True)
    learned_graphs_dir = osp.join(
        out_dir, "_".join([str(args_dict["init_graph"]),
                           args_dict["model_type"],
                           args_dict["hessian_structure"], sow, "strucs"]))

    space = hyperparam_space(args_dict)
    n_splits = data.train_indices.shape[1]
    all_results = []

    for combo in product(*space.values()):
        hp = dict(zip(space.keys(), combo))
        if verbose:
            print("-" * 10, {k: v for k, v in hp.items()}, "-" * 10)
        stats = {"marglik": {}, "valloss": {}}

        def add_stat(crit, key, split_idx, value):
            stats[crit].setdefault(key, [[] for _ in range(n_splits)])
            stats[crit][key][split_idx].append(value)

        common = dict(in_channels=data.num_features,
                      hidden_channels=hp["hidden_channels"],
                      out_channels=data.num_classes,
                      num_layers=args_dict["num_layers"],
                      dropout_p=hp["dropout_p"], init_adj=adj,
                      norm=args_dict["norm"], res=bool(args_dict["res"]),
                      X=data.x, symmetric=args_dict["symmetric"],
                      device=dev)

        for split_idx in range(n_splits):
            tr, va, te = data.split(split_idx)
            if verbose:
                gh, trh, teh = avg_local_homophilies(adj, tr, te, data.y)
                print(f"Homophily global, local train, local test:"
                      f"{gh:.3f}, {trh:.3f}, {teh:.3f}")

            spec = model_specific_args(args_dict, hp, tr)
            model = MODEL_REGISTRY[args_dict["model_type"]](**common, **spec)
            for repeat in range(args_dict["n_repeats"]):
                if verbose:
                    print("-" * 20, f"Split: {split_idx + 1} / {n_splits} "
                          f"(Repeat {repeat + 1})", "-" * 20)
                params = model.init(torch.Generator().manual_seed(
                    args_dict.get("seed", 0) + repeat))
                results, _, losses, val_losses, neg_margliks = \
                    marglik_optimization(
                        model, params, tr, data.y[tr], va, data.y[va],
                        y=data.y,
                        stop_criterion=args_dict["stop_criterion"],
                        lr=hp["lr"], lr_adj=hp["lr_adj"],
                        weight_decay=hp["weight_decay"],
                        weight_decay_adj=hp["weight_decay_adj"],
                        momentum_adj=args_dict["momentum_adj"],
                        n_epochs=args_dict["n_epochs"],
                        n_hypersteps=args_dict["n_hypersteps"],
                        n_epochs_burnin=args_dict["n_epochs_burnin"],
                        n_hyper_stop=args_dict["n_hyper_stop"],
                        marglik_frequency=args_dict["marglik_frequency"],
                        subset_of_weights=sow,
                        hessian_structure=args_dict["hessian_structure"],
                        grad_norm=args_dict["grad_norm"],
                        early_stop=args_dict["early_stop"],
                        model_type=args_dict["model_type"],
                        fisher_type=args_dict.get("fisher_type", "type-2"),
                        sketch_size=int(args_dict.get("sketch_size", 8)),
                        column_chunk=args_dict.get("column_chunk"),
                        mc_samples=int(args_dict.get("mc_samples", 1)),
                        diag_probes=args_dict.get("diag_probes"),
                        probe_batch=args_dict.get("probe_batch"),
                        fisher_seed=int(args_dict.get("fisher_seed", 0)),
                        learned_graphs_dir=learned_graphs_dir,
                        verbose=verbose, device=dev)

                for crit, best in results.items():
                    if best["params"] is None:
                        continue
                    bp = best["params"]
                    la = fit_laplace(model, bp, tr, data.y[tr],
                                     subset_of_weights=sow,
                                     hessian_structure=args_dict[
                                         "hessian_structure"])
                    marglik = float(la.log_marginal_likelihood())
                    out_adj = model.full_adj(bp).detach().cpu().numpy()
                    hh = global_homophily(out_adj, data.y)
                    mean_val = mean_eval(model, bp, va, data.y[va])
                    mean_test = mean_eval(model, bp, te, data.y[te])
                    q_map = evaluate_map(model, bp, te, data.y[te])
                    q_bayes = evaluate_predictive(la, te, data.y[te],
                                                  link_approx="probit")
                    add_stat(crit, "test nll", split_idx, q_map["nll"])
                    add_stat(crit, "test ece", split_idx, q_map["ece"])
                    add_stat(crit, "bayes test acc", split_idx,
                             q_bayes["acc"] * 100)
                    add_stat(crit, "bayes test nll", split_idx,
                             q_bayes["nll"])
                    add_stat(crit, "bayes test ece", split_idx,
                             q_bayes["ece"])
                    add_stat(crit, "marglik", split_idx, marglik)
                    add_stat(crit, "mean val loss", split_idx, mean_val[0])
                    add_stat(crit, "mean val acc", split_idx, mean_val[1])
                    add_stat(crit, "mean test loss", split_idx, mean_test[0])
                    add_stat(crit, "mean test acc", split_idx, mean_test[1])
                    add_stat(crit, "homophily", split_idx, hh)
                    add_stat(crit, "num edges", split_idx,
                             float(out_adj.sum()))
                    add_stat(crit, "best model epoch", split_idx,
                             best["epoch"])
                    if verbose:
                        print(f"Stop criterion: {crit} | "
                              f"Marglik={marglik:.2f}, "
                              f"Mean Val Acc={mean_val[1]:.3f}, "
                              f"Mean Test Acc={mean_test[1]:.3f}, "
                              f"Best Model Epoch={best['epoch']}")

        all_results.append({"hyperparams": hp, "stats": stats})

    summary = summarize(all_results)
    with open(osp.join(out_dir, "stats.pkl"), "wb") as f:
        pickle.dump({"args": args_dict, "results": all_results,
                     "summary": summary}, f)
    if verbose:
        print_summary(summary)
    return {"args": args_dict, "results": all_results, "summary": summary}


def summarize(all_results) -> dict:
    out = {}
    for crit in ("marglik", "valloss"):
        best_acc, best_entry = -np.inf, None
        for entry in all_results:
            st = entry["stats"][crit]
            if "mean test acc" not in st:
                continue
            accs = [np.mean(s) for s in st["mean test acc"] if s]
            acc = float(np.mean(accs)) if accs else -np.inf
            if acc > best_acc:
                best_acc = acc
                std = (float(np.std(accs)) if accs else 0.0)
                best_entry = {"hyperparams": entry["hyperparams"],
                              "test_acc_mean": acc, "test_acc_std": std}
        out[crit] = best_entry
    return out


def print_summary(summary) -> None:
    for crit, entry in summary.items():
        if entry is None:
            continue
        print(f"[{crit}] best test acc = {entry['test_acc_mean']:.2f} "
              f"+- {entry['test_acc_std']:.2f} @ {entry['hyperparams']}")


def main(argv=None, device=None) -> dict:
    args = argument_parser().parse_args(argv)
    return run_experiment(vars(args), device=device)


def cli() -> None:
    """Console entry point (discards main()'s stats dict so the script
    exits 0 on success)."""
    main()


if __name__ == "__main__":
    main()
