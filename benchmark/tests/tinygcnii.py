"""The small copy of the ``sparsegcnii-arxiv`` configuration, which the
CPU runs in seconds, and its cell in a checkout that ``tinyroot`` made."""

from __future__ import annotations

import json
import os

CONFIG = "sparsegcnii-arxiv"
CELL = "sparsegcnii-arxiv.train"
SMALL_GCNII = dict(n_nodes=3000, n_features=32, n_classes=6,
                   hidden_channels=64, num_layers=8,
                   n_undirected_draws=15000, max_degree=300, n_train=1800,
                   n_val=600, n_test=600)


def add_small_gcnii_cell(root: str) -> str:
    """``sparsegcnii-arxiv.train-small`` in the checkout ``root``: the cell
    on ``sparsegcnii-arxiv-small``, the configuration cut to SMALL_GCNII's
    sizes, under the full cell's mix and limits."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    c = {c["name"]: c for c in bench["configs"]}[CONFIG]
    with open(os.path.join(root, c["file"])) as f:
        cfg = json.load(f)
    cfg.update(SMALL_GCNII)
    file = f"benchmark/configs/{CONFIG}-small.json"
    with open(os.path.join(root, file), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append(dict(c, name=f"{CONFIG}-small", file=file))
    w = {w["name"]: w for w in bench["workloads"]}[CELL]
    small = f"{CELL}-small"
    bench["workloads"].append(dict(w, name=small, config=f"{CONFIG}-small"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(small)
    with open(path, "w") as f:
        json.dump(bench, f)
    limits = os.path.join(root, "benchmark", "limits")
    with open(os.path.join(limits, f"{CELL}.json")) as f:
        text = f.read()
    with open(os.path.join(limits, f"{small}.json"), "w") as f:
        f.write(text)
    return small
