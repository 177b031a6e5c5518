"""Dense-adjacency GAT with the fused flash-attention CUDA kernels.

The reference's dense GAT materializes the full (N, N, heads) score
tensor (gnn/models/layers.py:101-124). `GATConv`'s scale knobs remove it
in stages:

  - `row_block`: exact row-blocked masked softmax, peak attention memory
    block*N*H (the default above N=4096);
  - `attention_impl="flash"`: the hand-written sm_90a kernels of
    `laplace_gnn_torch/csrc/flash_attention.cu` — the forward carries
    running (max, denom, acc) on chip so nothing score-shaped is written
    to memory, and a second kernel runs the backward from the saved
    (m, l) statistics.

Everything composes with the Laplace stack: training steps run
reverse-mode through the kernels' autograd Function, while curvature
products (KFAC factors, GGN mat-vecs: forward-mode and nested
derivatives, which the Function has no rule for) are routed through the
mathematically identical plain attention by `BaseGNN.jvp_safe()` — no
user action needed.

On a CUDA device the train steps launch the kernels; with `--device cpu`
the same model runs the kernels' plain PyTorch versions.

Run: python examples/torch/13_flash_attention_gat.py [--device cpu]
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

from laplace_gnn_torch.laplace import Laplace  # noqa: E402
from laplace_gnn_torch.models import GAT  # noqa: E402
from laplace_gnn_torch.training import marglik_optimization  # noqa: E402
from laplace_gnn_torch.utils.data import ArrayLoader  # noqa: E402
from laplace_gnn_torch import resolve_device  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    n, d, classes = 64, 8, 3
    rng = np.random.default_rng(0)
    a = (rng.random((n, n)) < 0.15).astype(np.float32)
    adj = np.minimum(a + a.T + np.eye(n, dtype=np.float32), 1.0)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = torch.as_tensor(rng.integers(0, classes, n), device=dev)
    tr = torch.arange(40, device=dev)
    va = torch.arange(40, 64, device=dev)

    model = GAT(d, 16, classes, 2, X, adj, heads=4, concat=False,
                dropout_p=0.0, attention_impl="flash", device=dev)
    params = model.init(torch.Generator().manual_seed(0))

    # 1) plain training + marglik hypersteps: train steps use the flash
    #    kernels; hypersteps run the jvp-safe clone
    results, params, losses, _, nms = marglik_optimization(
        model, params, tr, y[tr], va, y[va],
        lr=0.05, lr_adj=0.1, n_epochs=12, n_hypersteps=1,
        n_epochs_burnin=4, marglik_frequency=4, model_type="gat",
        verbose=False, device=dev)
    print(f"flash GAT marglik training: loss {float(losses[0]):.3f} -> "
          f"{float(losses[-1]):.3f}, neg marglik trace "
          f"{[round(float(v), 2) for v in nms]}")

    # 2) the Laplace class path fits on the same flash model
    la = Laplace(model, params, "classification",
                 subset_of_weights="all", hessian_structure="kron")
    la.fit(ArrayLoader(tr, y[tr], device=dev))
    probs = la(va)
    rows = probs.detach().sum(-1)
    print(f"Laplace on flash GAT: log marglik "
          f"{float(la.log_marginal_likelihood()):.2f}, predictive rows "
          f"sum to {float(rows.mean()):.3f}")
    return {"neg_margliks": nms, "losses": losses,
            "row_sums": rows.cpu().numpy()}


if __name__ == "__main__":
    main()
