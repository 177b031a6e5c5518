"""Dataset loading and random splits (counterpart of
``laplace_gnn_tpu/graph/datasets.py``).

Loaders: **npz** (``<root>/<name>.npz`` with ``x``, ``y``, ``edge_index``),
**karate** (built in), **moons** / ``circle`` (scikit-learn's two moons,
imported lazily as in the JAX package, plus a label-driven graph),
**banana** (csv if present, else a synthetic), **sbm** (stochastic block
model). The planetoid and geom-gcn raw-file parsers wait (ROADMAP Queue 1
item 11): their raw files are not in the repo, so those names raise, except
that a geom-gcn name falls back to ``<root>/<name>.npz`` as in the JAX
package.

Splits are 60/20/20 as scikit-learn's nested ``ShuffleSplit(random_state=0)``
draws them (:func:`add_random_splits`), computed here without scikit-learn.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from .data import GraphData

PLANETOID = ("cora", "citeseer", "pubmed")
WEBKB = ("texas", "wisconsin", "cornell")
WIKIPEDIA = ("chameleon", "squirrel")


def default_root() -> str:
    return os.environ.get("LAPLACE_GNN_DATA",
                          os.path.join(Path.home(), "data"))


def load_data(dataset: str, n_rand_splits: int = 1,
              root: Optional[str] = None, **synth_kwargs) -> GraphData:
    root = root or default_root()
    dataset = dataset.lower()
    npz = os.path.join(root, f"{dataset}.npz")
    if dataset in PLANETOID:
        raise NotImplementedError(
            f"the planetoid raw-file parser ({dataset}) is not ported yet "
            "(ROADMAP Queue 1 item 11): its raw files are not in the repo")
    if dataset in WEBKB + WIKIPEDIA or dataset == "actor":
        if not os.path.exists(npz):
            raise NotImplementedError(
                f"the geom-gcn raw-file parser ({dataset}) is not ported yet "
                "(ROADMAP Queue 1 item 11): its raw files are not in the "
                f"repo; provide {npz}")
        data = load_npz(dataset, root)
    elif dataset == "karate":
        data = karate_club()
    elif dataset in ("circle", "moons"):
        data = moons_dataset(**synth_kwargs)
    elif dataset == "banana":
        data = banana_dataset(root=root, **synth_kwargs)
    elif dataset == "sbm":
        data = sbm_dataset(**synth_kwargs)
    elif os.path.exists(npz):
        data = load_npz(dataset, root)
    else:
        raise ValueError(f"Unknown dataset: {dataset} (no builtin and no "
                         f"{npz} found)")
    add_random_splits(data, n_rand_splits)
    return data


def shuffle_split(n: int, train_size: float, n_splits: int = 1,
                  random_state: int = 0):
    """(train, test) index pairs as scikit-learn's ``ShuffleSplit(n_splits,
    train_size=train_size, random_state=random_state)`` yields them: one
    ``RandomState(random_state)``, one permutation per split, the first
    ``n - floor(train_size * n)`` entries for test and the next
    ``floor(train_size * n)`` for train."""
    n_train = int(np.floor(train_size * n))
    n_test = n - n_train
    rng = np.random.RandomState(random_state)
    for _ in range(n_splits):
        perm = rng.permutation(n)
        yield perm[n_test:n_test + n_train], perm[:n_test]


def add_random_splits(data: GraphData, n_rand_splits: int) -> None:
    """60/20/20 train/val/test columns: an 80/20 split, then 60% of the 80%
    for training (each with ``random_state=0``)."""
    train_p, val_p = 0.6, 0.2
    tr, va, te = [], [], []
    for train_and_val, test_idx in shuffle_split(
            data.num_nodes, train_p + val_p, n_rand_splits):
        tr_i, va_i = next(shuffle_split(len(train_and_val), train_p))
        tr.append(train_and_val[tr_i])
        va.append(train_and_val[va_i])
        te.append(test_idx)
    data.train_indices = np.stack(tr, axis=1)
    data.val_indices = np.stack(va, axis=1)
    data.test_indices = np.stack(te, axis=1)


def load_npz(name: str, root: str) -> GraphData:
    z = np.load(os.path.join(root, f"{name}.npz"))
    return GraphData(x=z["x"].astype(np.float32), y=z["y"].astype(np.int64),
                     edge_index=z["edge_index"].astype(np.int64), name=name)


# ---------------------------------------------------------------------------
# Built-in datasets
# ---------------------------------------------------------------------------

_KARATE_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]

# Community labels as in torch_geometric's KarateClub (greedy modularity).
_KARATE_Y = np.array([1, 1, 1, 1, 3, 3, 3, 1, 0, 1, 3, 1, 1, 1, 0, 0, 3, 1,
                      0, 1, 0, 1, 0, 0, 2, 2, 0, 0, 2, 0, 0, 2, 0, 0])


def karate_club() -> GraphData:
    e = np.array(_KARATE_EDGES).T
    edge_index = np.concatenate([e, e[::-1]], axis=1)
    return GraphData(x=np.eye(34, dtype=np.float32), y=_KARATE_Y.copy(),
                     edge_index=edge_index, name="karate")


def gen_edge_index(y, n_edges: int, hetero_frac: float = 0.2,
                   seed: int = 42) -> np.ndarray:
    """Synthetic label-driven graph: ``1 - hetero_frac`` of edges connect
    same-class nodes."""
    rng = np.random.default_rng(seed)
    y = np.asarray(y)
    classes = np.unique(y)
    edges = []
    n_homo = int(n_edges * (1 - hetero_frac))
    for _ in range(n_homo):
        c = rng.choice(classes)
        nodes = np.nonzero(y == c)[0]
        i, j = rng.choice(nodes, 2, replace=False)
        edges.append((i, j))
    for _ in range(n_edges - n_homo):
        c1, c2 = rng.choice(classes, 2, replace=False)
        i = rng.choice(np.nonzero(y == c1)[0])
        j = rng.choice(np.nonzero(y == c2)[0])
        edges.append((i, j))
    e = np.array(edges).T
    return np.concatenate([e, e[::-1]], axis=1)


def moons_dataset(n_samples: int = 100, noise: float = 0.2,
                  n_edges: int = 70, hetero_frac: float = 0.2,
                  seed: int = 42) -> GraphData:
    """Two moons with a label-driven graph."""
    from sklearn.datasets import make_moons
    X, y = make_moons(n_samples=n_samples, noise=noise, random_state=seed)
    edge_index = gen_edge_index(y, n_edges, hetero_frac, seed)
    return GraphData(x=X.astype(np.float32), y=y.astype(np.int64),
                     edge_index=edge_index, name="moons")


def banana_dataset(root: Optional[str] = None, n_samples: int = 400,
                   seed: int = 0) -> GraphData:
    """CSV if available, else a banana-shaped two-class synthetic."""
    root = root or default_root()
    csv = os.path.join(root, "banana.csv")
    if not os.path.exists(csv):
        csv = "data/banana.csv"
    if os.path.exists(csv):
        import csv as _csv
        rows = list(_csv.DictReader(open(csv)))
        X = np.array([[float(r["At1"]), float(r["At2"])] for r in rows],
                     dtype=np.float32)
        y = np.array([0 if int(float(r["Class"])) in (-1, 0) else 1
                      for r in rows], dtype=np.int64)
    else:
        rng = np.random.default_rng(seed)
        n = n_samples // 2
        t1 = rng.uniform(0.3 * np.pi, 1.4 * np.pi, n)
        t2 = rng.uniform(1.2 * np.pi, 2.3 * np.pi, n)
        X = np.concatenate([
            np.stack([np.cos(t1), np.sin(t1)], 1) + rng.normal(0, .15, (n, 2)),
            np.stack([1 + np.cos(t2), np.sin(t2) + .5], 1)
            + rng.normal(0, .15, (n, 2))]).astype(np.float32)
        y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.int64)
    edge_index = gen_edge_index(y, max(len(y), 70), 0.2, seed)
    return GraphData(x=X, y=y, edge_index=edge_index, name="banana")


def sbm_dataset(n_nodes: int = 1000, n_classes: int = 4, d_features: int = 32,
                p_in: float = 0.02, p_out: float = 0.002,
                feature_signal: float = 1.0, seed: int = 0) -> GraphData:
    """Stochastic block model with class-informative Gaussian features.

    ``feature_signal`` scales the class means relative to unit noise; with
    high-dimensional features, lower it (e.g. 3/sqrt(D)) to keep the task
    Cora-like instead of linearly separable."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n_nodes)
    means = rng.normal(0, 1.0, (n_classes, d_features)) * feature_signal
    x = (means[y] + rng.normal(0, 1.0, (n_nodes, d_features))).astype(
        np.float32)
    rows, cols = [], []
    # sample edges blockwise without materializing N^2 probabilities
    for c1 in range(n_classes):
        idx1 = np.nonzero(y == c1)[0]
        for c2 in range(c1, n_classes):
            idx2 = np.nonzero(y == c2)[0]
            p = p_in if c1 == c2 else p_out
            n_possible = len(idx1) * len(idx2)
            n_edges = rng.binomial(n_possible, p)
            if n_edges == 0:
                continue
            i = rng.choice(idx1, n_edges)
            j = rng.choice(idx2, n_edges)
            keep = i != j
            rows.append(i[keep])
            cols.append(j[keep])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    e = np.stack([rows, cols])
    edge_index = np.concatenate([e, e[::-1]], axis=1)
    return GraphData(x=x, y=y.astype(np.int64), edge_index=edge_index,
                     name=f"sbm{n_nodes}")
