"""HF-style dict-input models: Laplace over an LLM-like classifier head.

Analog of the reference's examples/huggingface_example.py (offline): a
model consuming ``MutableMapping`` batches ``{"input_ids", "attention_mask",
"labels"}`` — here a small embedding + masked mean-pool + MLP head standing
in for a frozen transformer encoder — gets a last-layer Kron Laplace
posterior fit directly on dict loaders. ``dict_key_x``/``dict_key_y``
(reference laplace/baselaplace.py:77-82) name the input/target keys; the
DictInputModel adapter gives every module the same dual plain-array/dict
behavior the reference's HF wrappers have.

Run: python examples/torch/12_dict_input_llm_head.py [--device cpu]
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
from laplace_gnn_torch.nn import MLP, TapCollector  # noqa: E402
from laplace_gnn_torch.utils.data import ArrayLoader  # noqa: E402

VOCAB, SEQ, DIM, C = 50, 12, 16, 3


def _head(params):
    """The head's entries of the flat parameter dict, under its own
    names."""
    return {k[len("head."):]: v for k, v in params.items()
            if k.startswith("head.")}


class TokenClassifier:
    """Embedding -> masked mean pool -> MLP head, taking HF-style dicts.
    Parameters: ``embed`` and the head's ``head.layers.<i>.*``."""

    def __init__(self, device):
        self.head = MLP([DIM, 32, C], act="tanh", device=device)
        self.device = device
        self.n_outputs = C
        self.last_layer_closed_form = True

    def init(self, generator):
        embed = 0.1 * torch.randn(VOCAB, DIM, generator=generator,
                                  dtype=torch.float32)
        head = self.head.init(generator)
        return {"embed": embed.to(self.device),
                **{f"head.{k}": v for k, v in head.items()}}

    def _pool(self, params, batch):
        tok = params["embed"][batch["input_ids"]]        # (B, S, DIM)
        mask = batch["attention_mask"][..., None].to(tok.dtype)
        return (tok * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)

    def apply(self, params, batch, taps=None, generator=None, train=False):
        return self.head.apply(_head(params), self._pool(params, batch),
                               taps=taps)

    __call__ = apply

    def features(self, params, batch):
        taps = TapCollector()
        f = self.apply(params, batch, taps=taps)
        last = self.head.layers[-1].name
        a = [a for (n, a, s) in taps.records if n == last][-1]
        return a, f

    def tap_sites(self, params=None):
        return [{**s, "param_path": ("head",) + s["param_path"]}
                for s in self.head.tap_sites()]

    def last_layer_path(self, params=None):
        return ("head",) + self.head.last_layer_path()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    dev = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    n = 96
    ids = rng.integers(1, VOCAB, (n, SEQ))
    lengths = rng.integers(4, SEQ + 1, n)
    mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.float32)
    ids = ids * mask.astype(ids.dtype)
    # labels depend on which vocab band dominates the (unmasked) tokens
    y = (np.array([np.bincount(r[r > 0] * C // VOCAB, minlength=C).argmax()
                   for r in ids])).astype(np.int64)

    data = {"input_ids": torch.as_tensor(ids, device=dev),
            "attention_mask": torch.as_tensor(mask, device=dev),
            "labels": torch.as_tensor(y, device=dev)}
    model = TokenClassifier(dev)
    params = {k: v.requires_grad_(True) for k, v in
              model.init(torch.Generator().manual_seed(0)).items()}

    opt = torch.optim.Adam(params.values(), lr=5e-2)
    for _ in range(300):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model.apply(params, data),
                                                 data["labels"])
        loss.backward()
        opt.step()
    params = {k: v.detach() for k, v in params.items()}
    with torch.no_grad():
        acc = float((model.apply(params, data).argmax(-1) ==
                     data["labels"]).float().mean())
    print(f"MAP train loss {loss.item():.3f} acc {acc:.2f}")

    # fit on MutableMapping batches directly — no unpacking anywhere
    loader = ArrayLoader(data, batch_size=32, device=dev)
    la = Laplace(model, params, "classification",
                 subset_of_weights="last_layer", hessian_structure="kron")
    la.fit(loader)
    la.optimize_prior_precision(method="marglik", n_steps=50)
    print(f"marglik after tuning: {float(la.log_marginal_likelihood()):.2f}")

    probs = la({"input_ids": data["input_ids"][:8],
                "attention_mask": data["attention_mask"][:8]},
               pred_type="glm", link_approx="probit")
    probs = probs.detach().cpu().numpy()
    print("dict-input Bayesian predictive:", np.round(probs, 3))
    assert np.allclose(probs.sum(-1), 1.0, atol=1e-5)
    print("dict-input predictive sums to 1: OK")
    return {"probs": probs, "accuracy": acc}


if __name__ == "__main__":
    main()
