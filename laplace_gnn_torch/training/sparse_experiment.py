"""Scale CLI: fixed-graph sparse models end to end.

Counterpart of ``laplace_gnn_tpu/training/sparse_experiment.py``:
SparseGCN / SparseSAGE / SparseGAT / SparseGCNII over a
:class:`~laplace_gnn_torch.graph.container.SparseGraph`, full-graph Adam
training (with rolling checkpoints that a restart resumes from, the
optimizer state included), a post-hoc Laplace fit with marglik prior
tuning, and MAP against Bayes metrics on the test split.

    python -m laplace_gnn_torch.training.sparse_experiment \\
        --dataset sbm --n_nodes 20000 --model_type sparsegcn

It runs on ``cuda``; ``main(argv, device="cpu")`` runs it on the CPU.
Datasets: any name :func:`~laplace_gnn_torch.graph.datasets.load_data`
accepts (planetoid / karate / moons / banana / sbm / npz files such as an
ogbn-arxiv export under ``LAPLACE_GNN_DATA``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..profiling import count

SPARSE_MODELS = ("sparsegcn", "sparsesage", "sparsegat", "sparsegcnii")


def argument_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags, defaults and choices, and one more model,
    ``sparsegcnii``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="sbm")
    p.add_argument("--model_type", default="sparsegcn",
                   choices=SPARSE_MODELS)
    p.add_argument("--n_nodes", type=int, default=10_000,
                   help="synthetic datasets only")
    p.add_argument("--n_classes", type=int, default=8)
    p.add_argument("--d_features", type=int, default=32)
    p.add_argument("--hidden_channels", type=int, default=128)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--n_steps", type=int, default=400)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--subset_of_weights", default="last_layer",
                   choices=["all", "last_layer"])
    p.add_argument("--hessian_structure", default="kron",
                   choices=["full", "kron", "diag"])
    p.add_argument("--agg_dtype", default="bfloat16")
    p.add_argument("--ell", type=int, default=1,
                   help="attach the hybrid-ELL format")
    p.add_argument("--fisher_type", default=None,
                   choices=["type-2", "type-2-sketch", "mc", "empirical"],
                   help="kron Fisher flavor (default: backend default, "
                        "i.e. exact type-2)")
    p.add_argument("--sketch_size", type=int, default=8)
    p.add_argument("--column_chunk", type=int, default=None)
    p.add_argument("--mc_samples", type=int, default=1)
    p.add_argument("--diag_probes", type=int, default=None,
                   help="mixed-structure KFAC (sparsegat): Hutchinson "
                        "probes for the attention-parameter diagonal")
    p.add_argument("--probe_batch", type=int, default=None,
                   help="probes vmapped per step (same numbers)")
    p.add_argument("--fisher_seed", type=int, default=0)
    p.add_argument("--n_mc_samples", type=int, default=30)
    p.add_argument("--checkpoint_dir", default=None,
                   help="rolling train checkpoints; restart resumes from "
                        "the newest one")
    p.add_argument("--checkpoint_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    return p


def build_graph(args, data, device=None):
    """The model's SparseGraph: 'sym' weights for GCN and GCNII, 'row' for
    SAGE, none for GAT; the hybrid ELL form and ``agg_dtype`` apply to
    every model."""
    from ..graph.container import add_ell_format, sparse_from_edge_index

    normalize = {"sparsegcn": "sym", "sparsesage": "row",
                 "sparsegat": None, "sparsegcnii": "sym"}[args.model_type]
    g = sparse_from_edge_index(data.edge_index, data.num_nodes,
                               normalize=normalize, device=device)
    if args.ell:
        g = add_ell_format(g)
    if args.agg_dtype:
        g = dataclasses.replace(g, agg_dtype=args.agg_dtype)
    return g


def build_model(args, data, g, device=None, **overrides):
    """The CLI's model on ``g``. ``overrides`` are keyword arguments of the
    model's constructor, added to or taking the place of the CLI's: the
    options that have no flag (``norm``, ``res``, SparseGAT's
    ``mean_output_heads``, SparseGCNII's ``alpha`` and ``lamda``, ...), so
    the flags stay the JAX CLI's."""
    from ..models import SparseGAT, SparseGCN, SparseGCNII, SparseSAGE

    kw = dict(in_channels=data.num_features,
              hidden_channels=args.hidden_channels,
              out_channels=data.num_classes,
              num_layers=args.num_layers, X=data.x, graph=g, dropout_p=0.0,
              device=device)
    kw.update(overrides)
    if args.model_type == "sparsegcn":
        return SparseGCN(**kw)
    if args.model_type == "sparsesage":
        return SparseSAGE(**kw)
    if args.model_type == "sparsegcnii":
        return SparseGCNII(**kw)
    return SparseGAT(heads=args.heads, **kw)


def train_steps(model, params: dict, opt, train_idx, y_train,
                n_steps: int) -> None:
    """``n_steps`` full-graph Adam steps on the mean cross-entropy of the
    training nodes, updating ``params`` and ``opt`` in place."""
    leaves = list(params.values())
    for _ in range(n_steps):
        loss = F.cross_entropy(model.apply(params, train_idx), y_train)
        for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
            p.grad = g
        opt.step()


def _opt_state(opt) -> dict:
    return {"step_count": opt.step_count, "exp_avg": opt.exp_avg,
            "exp_avg_sq": opt.exp_avg_sq}


def _load_opt_state(opt, state: dict) -> None:
    opt.step_count.copy_(state["step_count"])
    for dst, src in zip(opt.exp_avg + opt.exp_avg_sq,
                        list(state["exp_avg"]) + list(state["exp_avg_sq"])):
        dst.copy_(src)


def fit_posterior(args, model, params: dict, train_idx, y_train):
    """The post-hoc Laplace fit with marglik prior tuning. SparseGAT with
    kron runs the mixed-structure KFAC (Kron for the Linear sites, exact
    or Hutchinson diagonals for the attention vectors). SparseGCNII takes
    the last layer only."""
    from ..laplace.dispatch import Laplace

    if args.model_type == "sparsegcnii" and \
            args.subset_of_weights != "last_layer":
        raise ValueError("sparsegcnii: --subset_of_weights all is not "
                         "supported (its convs are no KFAC sites, and no "
                         "curvature over them has been held to a dense "
                         "GGN); use last_layer")
    backend_kwargs = {"seed": args.fisher_seed}
    if args.fisher_type is not None:
        backend_kwargs.update(fisher_type=args.fisher_type,
                              sketch_size=args.sketch_size,
                              mc_samples=args.mc_samples)
    if args.column_chunk is not None:
        backend_kwargs["column_chunk"] = args.column_chunk
    if args.diag_probes is not None:
        backend_kwargs["diag_probes"] = args.diag_probes
    if args.probe_batch is not None:
        backend_kwargs["probe_batch"] = args.probe_batch
    la = Laplace(model, params, "classification",
                 subset_of_weights=args.subset_of_weights,
                 hessian_structure=args.hessian_structure,
                 backend_kwargs=backend_kwargs)
    la.fit([(train_idx, y_train)])
    la.optimize_prior_precision(method="marglik", n_steps=100)
    return la


@torch.no_grad()
def predict(args, model, params: dict, la, test_idx) -> dict:
    """Test-node probabilities of the MAP and of the MC ``nn`` predictive."""
    probs_map = torch.softmax(model.apply(params, test_idx), dim=-1)
    probs_bayes = la(test_idx, pred_type="nn", link_approx="mc",
                     n_samples=args.n_mc_samples)
    count("host_sync", 2)
    return {"map": probs_map.float().cpu().numpy(),
            "laplace": probs_bayes.float().cpu().numpy()}


def _synchronized(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def main(argv=None, device=None) -> dict:
    args = argument_parser().parse_args(argv)
    args.dataset = args.dataset.lower()
    dev = resolve_device(device)

    # joins a multi-process run when LAPLACE_GNN_COORDINATOR /
    # _NUM_PROCESSES / _PROCESS_ID are set; a no-op otherwise
    from ..parallel.distributed import initialize as distributed_init
    if distributed_init(device=dev):
        import torch.distributed as dist
        print(f"multi-process: process {dist.get_rank()}/"
              f"{dist.get_world_size()}")

    from ..graph import datasets
    from ..utils.metrics import (accuracy, expected_calibration_error,
                                 nll_loss)
    from .marglik_gnn import DeviceAdam

    synth = dict(n_nodes=args.n_nodes, n_classes=args.n_classes,
                 d_features=args.d_features, seed=args.seed) \
        if args.dataset == "sbm" else {}
    data = datasets.load_data(args.dataset, **synth)
    g = build_graph(args, data, device=dev)
    print(f"{args.dataset}: N={data.num_nodes} E={g.n_edges} "
          f"C={data.num_classes} d={data.num_features}")

    # the loader's 60/20/20 split, the one every experiment CLI uses
    tr, va, te = data.split(0)

    model = build_model(args, data, g, device=dev)
    params = {k: v.requires_grad_(True) for k, v in
              model.init(torch.Generator().manual_seed(args.seed)).items()}
    y = torch.as_tensor(np.asarray(data.y), device=dev)
    tr_t = torch.as_tensor(tr, device=dev)
    y_tr = y[tr_t]
    # a model with weight-decay groups (SparseGCNII) gives them
    groups = (model.param_groups(params) if hasattr(model, "param_groups")
              else params.values())
    opt = DeviceAdam(groups, lr=args.lr)

    t0 = _synchronized(dev)
    if args.checkpoint_dir:
        # chunks with rolling checkpoints; the optimizer state rides in the
        # checkpoint, so a chunked or resumed run is step for step the
        # uninterrupted one
        from ..utils.checkpoint import TrainCheckpointer
        ck = TrainCheckpointer(args.checkpoint_dir, device=dev)
        start = 0
        latest = ck.latest()
        if latest is not None:
            start = int(latest["step"])
            with torch.no_grad():
                for k, v in latest["state"]["params"].items():
                    params[k].copy_(v)
            if "opt_state" in latest["state"]:
                _load_opt_state(opt, latest["state"]["opt_state"])
            print(f"resumed from checkpoint step {start}")
        step = args.checkpoint_every
        for s0 in range(start, args.n_steps, step):
            n = min(step, args.n_steps - s0)
            train_steps(model, params, opt, tr_t, y_tr, n)
            ck.save(s0 + n, {"params": params, "opt_state": _opt_state(opt)})
    else:
        train_steps(model, params, opt, tr_t, y_tr, args.n_steps)
    print(f"{args.n_steps} full-graph steps: "
          f"{_synchronized(dev) - t0:.3f} s")

    params = {k: v.detach() for k, v in params.items()}
    t0 = _synchronized(dev)
    la = fit_posterior(args, model, params, tr_t, y_tr)
    print(f"Laplace fit + marglik prior tuning: "
          f"{_synchronized(dev) - t0:.3f} s; "
          f"marglik {float(la.log_marginal_likelihood()):.1f}")

    te_t = torch.as_tensor(te, device=dev)
    y_te = np.asarray(data.y)[te]
    results = {}
    for name, p in predict(args, model, params, la, te_t).items():
        acc = float(accuracy(p, y_te))
        nll = float(nll_loss(p, y_te))
        ece = float(expected_calibration_error(p, y_te))
        results[name] = {"acc": acc, "nll": nll, "ece": ece}
        print(f"{name:8s} test acc {acc:.4f}  NLL {nll:.4f}  ECE {ece:.4f}")
    return results


def cli() -> None:
    """Console entry point (discards main()'s results dict so the script
    exits 0 on success)."""
    main()


if __name__ == "__main__":
    main()
