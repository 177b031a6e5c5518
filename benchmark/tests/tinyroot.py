"""A checkout in a temporary folder holding a copy of the benchmark, the
program (a link to it) and small cells the CPU runs in seconds: each of
the benchmark's configurations cut to a few hundred nodes, under the
benchmark's own traffic mixes and the full cells' limits."""

from __future__ import annotations

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

SMALL = {
    "stegcn-cora": dict(n_nodes=120, n_features=30, n_classes=4,
                        hidden_channels=16, n_directed_edges=700,
                        n_train=30, n_val=40, n_test=40, n_epochs=20,
                        n_epochs_burnin=5, marglik_frequency=5,
                        n_hypersteps=2, n_hyper_stop=15),
    "sparsegcn-arxiv": dict(n_nodes=3000, n_features=32, n_classes=6,
                            hidden_channels=64, n_undirected_draws=15000,
                            max_degree=300, n_train=1800, n_val=600,
                            n_test=600),
}


def copy_checkout(dst: str) -> str:
    """``dst`` with BENCHMARK.json, the benchmark folder and a link to the
    program."""
    shutil.copytree(BENCH_DIR, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    os.symlink(os.path.join(ROOT, "laplace_gnn_torch"),
               os.path.join(dst, "laplace_gnn_torch"))
    return dst


def add_small_cells(dst: str) -> dict:
    """A small copy of every cell of BENCHMARK.json, named
    ``<cell>-small``, with its configuration ``<config>-small``; returns
    {cell: small cell}."""
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    names = {}
    for c in list(bench["configs"]):
        with open(os.path.join(dst, c["file"])) as f:
            cfg = json.load(f)
        cfg.update(SMALL[c["name"]])
        small = f"{c['name']}-small"
        file = f"benchmark/configs/{small}.json"
        with open(os.path.join(dst, file), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append(dict(c, name=small, file=file))
    for w in list(bench["workloads"]):
        small = f"{w['name']}-small"
        names[w["name"]] = small
        bench["workloads"].append(dict(w, name=small,
                                       config=f"{w['config']}-small"))
        shutil.copy(os.path.join(dst, "benchmark", "limits",
                                 f"{w['name']}.json"),
                    os.path.join(dst, "benchmark", "limits",
                                 f"{small}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [names[w] for w in m["workloads"]]
    with open(path, "w") as f:
        json.dump(bench, f)
    return names
