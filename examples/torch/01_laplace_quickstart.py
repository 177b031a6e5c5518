"""Post-hoc Laplace on a toy regression MLP (counterpart of the reference's
examples/regression_example: train MAP, fit Laplace, tune prior precision
and observation noise by marginal likelihood, plot-ready predictive).

Run: python examples/torch/01_laplace_quickstart.py [--device cpu]
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    # sinusoid with a gap (the classic uncertainty-visualization setup)
    f32 = torch.float32
    X = torch.cat([torch.linspace(-4, -1, 60, dtype=f32),
                   torch.linspace(1, 4, 60, dtype=f32)])
    X = X[:, None]
    y = torch.sin(X) + 0.2 * torch.randn(
        X.shape, generator=torch.Generator().manual_seed(0), dtype=f32)
    X, y = X.to(dev), y.to(dev)

    model = MLP([1, 50, 1], act="tanh", device=dev)
    params = {k: v.requires_grad_(True) for k, v in
              model.init(torch.Generator().manual_seed(1)).items()}

    opt = torch.optim.Adam(params.values(), lr=1e-2)
    for i in range(1000):
        opt.zero_grad()
        loss = torch.mean((model.apply(params, X) - y) ** 2)
        loss.backward()
        opt.step()
    print(f"MAP training done, MSE={loss.item():.4f}")
    params = {k: v.detach() for k, v in params.items()}

    la = Laplace(model, params, "regression",
                 subset_of_weights="all", hessian_structure="kron")
    la.fit(ArrayLoader(X, y, batch_size=60, device=dev))
    before = float(la.log_marginal_likelihood())
    print(f"marglik before tuning: {before:.2f}")
    la.optimize_prior_precision(method="marglik", n_steps=100)
    after = float(la.log_marginal_likelihood())
    print(f"marglik after tuning:  {after:.2f}")
    print(f"tuned prior precision: "
          f"{la.prior_precision.detach().cpu().numpy()}")

    X_test = torch.linspace(-6, 6, 200, dtype=f32, device=dev)[:, None]
    f_mu, f_var = la(X_test, pred_type="glm")
    f_var = f_var.detach().cpu().numpy()
    std = np.sqrt(f_var[:, 0, 0] + float(la.sigma_noise) ** 2)
    in_gap = np.abs(X_test[:, 0].cpu().numpy()) < 1
    print(f"mean predictive std in data region: {std[~in_gap].mean():.3f}")
    print(f"mean predictive std in the gap:     {std[in_gap].mean():.3f}"
          "  (should be larger)")
    return {"marglik_before": before, "marglik_after": after,
            "f_var_shape": f_var.shape, "std_data": float(std[~in_gap].mean()),
            "std_gap": float(std[in_gap].mean())}


if __name__ == "__main__":
    main()
