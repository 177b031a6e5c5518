"""Bayesian optimization with a Laplace-approximated neural surrogate.

Analog of the reference's examples/bayesopt_example.py: an MLP surrogate
refit each round, a KronLaplace posterior giving calibrated mean/variance,
and upper-confidence-bound acquisition maximized on a candidate grid.
Target: maximize f(x) = sin(5x) - (x - 0.5)^2 on [0, 1].

Run: python examples/torch/07_bayesopt.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

# runnable from a clean checkout: the script's directory is on sys.path,
# the repository root is not
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from laplace_gnn_torch import Laplace, resolve_device  # noqa: E402
from laplace_gnn_torch.nn import MLP  # noqa: E402
from laplace_gnn_torch.utils.data import ArrayLoader  # noqa: E402


def f_true(x):
    return torch.sin(5 * x) - (x - 0.5) ** 2


def fit_surrogate(X, y, seed, dev):
    model = MLP([1, 32, 32, 1], act="tanh", device=dev)
    params = {k: v.requires_grad_(True) for k, v in
              model.init(torch.Generator().manual_seed(seed)).items()}
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    for _ in range(500):
        opt.zero_grad()
        torch.mean((model.apply(params, X) - y) ** 2).backward()
        opt.step()
    la = Laplace(model, {k: v.detach() for k, v in params.items()},
                 "regression", subset_of_weights="all",
                 hessian_structure="kron")
    la.fit(ArrayLoader(X, y, device=dev))
    la.optimize_prior_precision(method="marglik")
    return la


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    def noise(shape):
        return sigma * torch.as_tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=dev)

    rng = np.random.default_rng(0)
    sigma = 0.05
    X = torch.as_tensor(rng.uniform(0, 1, (5, 1)), dtype=torch.float32,
                        device=dev)
    y = f_true(X) + noise((5, 1))
    candidates = torch.linspace(0, 1, 256, dtype=torch.float32,
                                device=dev)[:, None]
    x_star = float(candidates[torch.argmax(f_true(candidates[:, 0])), 0])

    for round_ in range(10):
        la = fit_surrogate(X, y, round_, dev)
        mu, var = la(candidates)
        ucb = mu[:, 0] + 2.0 * torch.sqrt(
            torch.diagonal(var, dim1=-2, dim2=-1)[:, 0])
        x_next = candidates[torch.argmax(ucb)][None].detach()
        y_next = f_true(x_next) + noise((1, 1))
        X = torch.cat([X, x_next])
        y = torch.cat([y, y_next])
        best = float(X[torch.argmax(y[:, 0]), 0])
        print(f"round {round_}: queried x={float(x_next[0, 0]):.3f}, "
              f"best-so-far x={best:.3f} (optimum {x_star:.3f})")

    assert abs(best - x_star) < 0.12, (best, x_star)
    print("bayesopt example OK")
    return {"best": best, "x_star": x_star}


if __name__ == "__main__":
    main()
