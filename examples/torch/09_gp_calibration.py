"""GP (FunctionalLaplace) calibration: post-hoc GGN-Laplace as a Gaussian
process with subset-of-data, tuning the prior precision by GP marginal
likelihood (counterpart of the reference's calibration_gp_example.py:
same workflow — fit GP Laplace on a trained classifier, optimize the
prior, compare NLL/ECE against the MAP softmax).

The example runs in float64, as the JAX example runs under its tests
(which enable x64): the GP's subset kernel has 450 rows (150 points x 3
classes) over the MLP's 291 weights, so it is singular, and in float32
its rounding outweighs the 1e-5 the scatter adds to its diagonal (the
JAX example in float32 ends with a NaN prior precision; the port's
Cholesky factor raises).

Run: python examples/torch/09_gp_calibration.py [--device cpu]
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
from laplace_gnn_torch.utils.metrics import (  # noqa: E402
    expected_calibration_error, nll_loss)


def blobs(dev, n=400, d=5, c=3, seed=0, dtype=torch.float32):
    """Three Gaussian blobs in d dimensions: 300 training points, 100 test
    points, and the generator that draws the weights."""
    gen = torch.Generator().manual_seed(seed)
    means = torch.randn(c, d, generator=gen, dtype=dtype) * 1.2
    y = torch.randint(0, c, (n,), generator=gen)
    X = means[y] + torch.randn(n, d, generator=gen, dtype=dtype)
    X, y = X.to(dev), y.to(dev)
    return X[:300], y[:300], X[300:], y[300:], gen


def train_map(model, params, X_tr, y_tr, steps=2000, lr=5e-3):
    """Adam on the mean cross-entropy, long enough to overfit."""
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(params.values(), lr=lr)
    rows = torch.arange(len(y_tr), device=y_tr.device)
    for _ in range(steps):
        opt.zero_grad()
        logp = torch.log_softmax(model.apply(params, X_tr), -1)
        loss = -logp[rows, y_tr].mean()
        loss.backward()
        opt.step()
    return {k: v.detach() for k, v in params.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    n, d, c = 400, 5, 3
    X_tr, y_tr, X_te, y_te, gen = blobs(dev, n, d, c, dtype=torch.float64)
    model = MLP([d, 32, c], act="tanh", device=dev, dtype=torch.float64)
    params = train_map(model, model.init(gen), X_tr, y_tr)  # overfit

    y_np = y_te.cpu().numpy()
    with torch.no_grad():
        probs_map = torch.softmax(model.apply(params, X_te), -1)
    probs_map = probs_map.cpu().numpy()
    print(f"MAP:        NLL={nll_loss(probs_map, y_np):.3f} "
          f"ECE={expected_calibration_error(probs_map, y_np):.3f}")

    # GGN-Laplace as a GP (reference hessian_structure='gp'): subset-of-data
    # kernel, prior precision tuned on the GP marginal likelihood
    la = Laplace(model, params, "classification",
                 subset_of_weights="all", hessian_structure="gp",
                 n_subset=150)
    la.fit(ArrayLoader(X_tr, y_tr, batch_size=100, device=dev))
    la.optimize_prior_precision(method="marglik", n_steps=150, lr=0.1)
    print(f"GP prior precision: {float(la.prior_precision.ravel()[0]):.3f}, "
          f"log marglik: {float(la.log_marginal_likelihood()):.2f}")

    probs_gp = la(X_te, pred_type="gp").detach().cpu().numpy()
    nll = nll_loss(probs_gp, y_np)
    ece = expected_calibration_error(probs_gp, y_np)
    print(f"GP Laplace: NLL={nll:.3f} ECE={ece:.3f}")
    assert np.isfinite(nll)
    print("gp calibration example OK")
    return {"nll": nll, "ece": ece}


if __name__ == "__main__":
    main()
