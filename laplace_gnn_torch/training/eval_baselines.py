"""External graph-structure-learning baselines over the framework's splits.

Counterpart of ``laplace_gnn_tpu/training/eval_baselines.py``: runs a model
of the external ``GSL`` package (LDS / IDGL / SUBLIME / NodeFormer) over
the same 60/20/20 splits as every experiment CLI and aggregates the test
accuracy. The package is not part of this framework; its absence is
reported with the same ``ImportError`` as the JAX package gives, and the
split and aggregation logic takes an injected runner.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Callable, Optional

import numpy as np

from ..graph.datasets import load_data

BASELINE_MODELS = ("lds", "idgl", "sublime", "nodeformer")


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--model", type=str, choices=BASELINE_MODELS,
                   required=True)
    p.add_argument("--n_data_rand_splits", type=int, default=10)
    p.add_argument("--n_repeats", type=int, default=1)
    p.add_argument("--out", type=str, default=None)
    return p


def _resolve_gsl_runner(model: str) -> Callable:
    try:
        import GSL  # noqa: F401  the external baseline library
    except ImportError as e:
        raise ImportError(
            "External baseline evaluation requires the 'GSL' package "
            "(https://github.com/GSL-Benchmark/GSL), which is not bundled — "
            "the reference imports it the same way (gnn/eval.py).") from e
    from GSL import runners  # type: ignore
    return getattr(runners, model)


def evaluate_baseline(dataset: str, model: str, n_rand_splits: int = 10,
                      n_repeats: int = 1,
                      runner: Optional[Callable] = None) -> dict:
    """Run a GSL baseline over the framework's splits.

    ``runner(x, y, edge_index, train_idx, val_idx, test_idx, seed)``
    returns the test accuracy in [0, 1]; the mean over repeats is each
    split's score."""
    data = load_data(dataset, n_rand_splits)
    runner = runner or _resolve_gsl_runner(model)
    accs = [[] for _ in range(n_rand_splits)]
    for split in range(n_rand_splits):
        tr, va, te = data.split(split)
        for rep in range(n_repeats):
            acc = runner(data.x, data.y, data.edge_index, tr, va, te,
                         seed=rep)
            accs[split].append(float(acc))
    per_split = [float(np.mean(a)) for a in accs]
    return {
        "dataset": dataset,
        "model": model,
        "per_split_acc": per_split,
        "test_acc_mean": float(np.mean(per_split)),
        "test_acc_std": float(np.std(per_split)),
    }


def main(argv=None) -> dict:
    args = argument_parser().parse_args(argv)
    out = evaluate_baseline(args.dataset, args.model,
                            args.n_data_rand_splits, args.n_repeats)
    print(f"{out['model']} on {out['dataset']}: "
          f"{out['test_acc_mean'] * 100:.2f} +- "
          f"{out['test_acc_std'] * 100:.2f}")
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(out, f)
    return out


if __name__ == "__main__":
    main()
