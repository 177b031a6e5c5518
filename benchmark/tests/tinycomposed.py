"""The small copy of the ``stegcn-cora-composed`` configuration, which the
CPU runs in seconds, and its cell in a checkout that ``tinyroot`` made."""

from __future__ import annotations

import json
import os

CONFIG = "stegcn-cora-composed"
CELL = "stegcn-cora-composed.marglik"
# ``stegcn-cora``'s small row, with a step on the adjacency large enough
# that some entries cross the threshold in a run (0.8 moves none at this
# size; 5 removes nearly every edge)
SMALL_COMPOSED = dict(n_nodes=120, n_features=30, n_classes=4,
                      hidden_channels=16, n_directed_edges=700, n_train=30,
                      n_val=40, n_test=40, n_epochs=20, n_epochs_burnin=5,
                      marglik_frequency=5, n_hypersteps=2, n_hyper_stop=15,
                      lr_adj=2.0)


def add_small_composed_cell(root: str) -> str:
    """``stegcn-cora-composed.marglik-small`` in the checkout ``root``: the
    cell on ``stegcn-cora-composed-small``, the configuration cut to
    SMALL_COMPOSED's sizes, under the full cell's mix and limits."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    c = {c["name"]: c for c in bench["configs"]}[CONFIG]
    with open(os.path.join(root, c["file"])) as f:
        cfg = json.load(f)
    cfg.update(SMALL_COMPOSED)
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
