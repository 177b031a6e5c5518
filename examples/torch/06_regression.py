"""Bayesian regression with online marginal-likelihood training.

Analog of the reference's examples/regression_example.py: a sinusoid with
noise, an MLP trained jointly with {prior precision, observation noise}
via the online marglik loop, then GLM predictive mean +/- 2 std intervals.

Run: python examples/torch/06_regression.py [--device cpu]
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

from laplace_gnn_torch import marglik_training, resolve_device  # noqa: E402
from laplace_gnn_torch.nn import MLP  # noqa: E402
from laplace_gnn_torch.utils.data import ArrayLoader  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    n = 150
    sigma_true = 0.3
    X = torch.as_tensor(rng.uniform(-4.0, 4.0, (n, 1)), dtype=torch.float32)
    y = torch.sin(X) + sigma_true * torch.as_tensor(
        rng.standard_normal((n, 1)), dtype=torch.float32)

    model = MLP([1, 50, 1], act="tanh", device=dev)
    params = model.init(torch.Generator().manual_seed(0))

    la, params, margliks, _ = marglik_training(
        model, params, ArrayLoader(X, y, batch_size=150, device=dev),
        likelihood="regression", hessian_structure="kron",
        n_epochs=300, marglik_frequency=20, n_hypersteps=30,
        optimizer_kwargs={"lr": 1e-2}, lr_hyp=1e-1, device=dev)
    sigma_hat = float(la.sigma_noise)
    print(f"marglik improved {float(margliks[0]):.1f} -> "
          f"{float(margliks[-1]):.1f}; learned sigma {sigma_hat:.3f} "
          f"(true {sigma_true})")
    assert abs(sigma_hat - sigma_true) < 0.15

    x_grid = torch.linspace(-6, 6, 200, dtype=torch.float32,
                            device=dev)[:, None]
    f_mu, f_var = la(x_grid)                   # GLM predictive
    f_sigma = torch.sqrt(torch.diagonal(f_var, dim1=-2, dim2=-1))
    pred_std = torch.sqrt(f_sigma ** 2 + sigma_hat ** 2)
    in_dist = torch.abs(x_grid[:, 0]) < 4
    std_in = float(pred_std[in_dist].mean())
    std_out = float(pred_std[~in_dist].mean())
    print(f"predictive std: in-distribution {std_in:.3f}, "
          f"extrapolation {std_out:.3f}")
    assert std_out > std_in
    print("regression example OK")
    return {"margliks": [float(m) for m in margliks], "sigma": sigma_hat,
            "std_in": std_in, "std_out": std_out}


if __name__ == "__main__":
    main()
