"""Bayesian reward modeling (Bradley-Terry) with Laplace.

Analog of the reference's examples/reward_modeling_example.py: a
single-output reward net trained on pairwise preferences with the
cross-entropy (Bradley-Terry) likelihood, then a Laplace posterior whose
*prediction* is a regression over the scalar reward — mean + epistemic
variance per input (`likelihood="reward_modeling"` switches automatically;
reference laplace/baselaplace.py:57-63, :1060-1061).

Run: python examples/torch/08_reward_modeling.py [--device cpu]
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


class RewardMLP(MLP):
    """(B, 2, d) pairs -> (B, 2) logits during fitting; (B, d) -> (B, 1)
    scalar rewards at prediction (the reference's SimpleRewardModel)."""

    def apply(self, params, x, **kw):
        if x.dim() == 3:
            b, two, d = x.shape
            out = super().apply(params, x.reshape(-1, d), **kw)
            return out.reshape(b, two)
        return super().apply(params, x, **kw)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    n, d = 128, 3
    w_true = np.array([1.5, -2.0, 0.5])

    # preference pairs: label = which of x0/x1 has higher true reward
    x0 = rng.standard_normal((n, d)).astype(np.float32)
    x1 = rng.standard_normal((n, d)).astype(np.float32)
    r0, r1 = x0 @ w_true, x1 @ w_true
    label = (r1 > r0).astype(np.int64)          # class 1 = x1 preferred
    X = torch.as_tensor(np.stack([x0, x1], axis=1), device=dev)  # (n, 2, d)
    y = torch.as_tensor(label, device=dev)

    model = RewardMLP([d, 32, 1], act="tanh", device=dev)
    params = {k: v.requires_grad_(True) for k, v in
              model.init(torch.Generator().manual_seed(0)).items()}
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    for i in range(800):
        opt.zero_grad()
        logits = model.apply(params, X)          # (n, 2) Bradley-Terry
        loss = torch.nn.functional.cross_entropy(logits, y)
        loss.backward()
        opt.step()
    params = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        acc = float((model.apply(params, X).argmax(-1) == y).float().mean())
    print(f"preference train accuracy {acc:.3f}, CE loss {loss.item():.3f}")

    la = Laplace(model, params, "reward_modeling",
                 subset_of_weights="all", hessian_structure="kron")
    la.fit([(X, y)])
    la.optimize_prior_precision(method="marglik")
    print(f"marglik {float(la.log_marginal_likelihood()):.1f}")

    # prediction = regression over the scalar reward
    x_test = torch.as_tensor(rng.standard_normal((6, d)),
                             dtype=torch.float32, device=dev)
    r_mu, r_var = la(x_test)
    r_mu = r_mu.detach().cpu().numpy()[:, 0]
    r_std = np.sqrt(r_var.detach().cpu().numpy().reshape(-1))
    true_r = x_test.cpu().numpy() @ w_true
    corr = np.corrcoef(r_mu, true_r)[0, 1]
    for m, s, t in zip(r_mu, r_std, true_r):
        print(f"  reward {m:+.2f} +- {s:.2f}   (true {t:+.2f})")
    print(f"rank correlation with true reward: {corr:.3f}")
    assert corr > 0.9
    print("reward modeling example OK")
    return {"accuracy": acc, "corr": float(corr), "reward_std": r_std}


if __name__ == "__main__":
    main()
