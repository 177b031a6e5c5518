"""Dataset loading and random splits (counterpart of
``laplace_gnn_tpu/graph/datasets.py``).

Loaders: **planetoid** (cora / citeseer / pubmed: the raw
``ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}`` pickles under
``<root>/<Name>/raw``; scipy imported lazily), **geom-gcn** (WebKB,
Wikipedia and Actor raw text files, falling back to ``<root>/<name>.npz``),
**npz** (``<root>/<name>.npz`` with ``x``, ``y``, ``edge_index``),
**karate** (built in), **moons** / ``circle`` (scikit-learn's two moons,
imported lazily as in the JAX package, plus a label-driven graph),
**banana** (csv if present, else a synthetic), **sbm** (stochastic block
model). Every loader returns numpy arrays and touches no device.

Splits are 60/20/20 as scikit-learn's nested ``ShuffleSplit(random_state=0)``
draws them (:func:`add_random_splits`), computed here without scikit-learn.
"""

from __future__ import annotations

import os
import pickle
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
        data = load_planetoid(dataset, root)
    elif dataset in WEBKB + WIKIPEDIA or dataset == "actor":
        try:
            data = load_geom_gcn(
                dataset, root, sparse_features=(dataset == "actor"),
                # Actor's bag of words is 932-dim (PyG's convention)
                feature_dim=932 if dataset == "actor" else None,
                # PyG's WebKB makes the raw directed links undirected;
                # Wikipedia and Actor keep them as stored
                undirected=(dataset in WEBKB))
        except FileNotFoundError:
            if not os.path.exists(npz):
                raise
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


# ---------------------------------------------------------------------------
# Raw-file parsers
# ---------------------------------------------------------------------------

def _parse_index_file(path) -> np.ndarray:
    with open(path) as f:
        return np.array([int(line.strip()) for line in f])


def load_planetoid(name: str, root: str) -> GraphData:
    """Parse the Planetoid raw pickles (Yang et al. 2016's format)."""
    raw = os.path.join(root, name.capitalize(), "raw")
    if not os.path.isdir(raw):
        raw = os.path.join(root, name, "raw")
    if not os.path.isdir(raw):
        raise FileNotFoundError(
            f"Planetoid raw files for {name} not found under {root}; expected "
            f"<root>/{name.capitalize()}/raw/ind.{name}.*")

    objs = {}
    for ext in ("x", "tx", "allx", "y", "ty", "ally", "graph"):
        with open(os.path.join(raw, f"ind.{name}.{ext}"), "rb") as f:
            objs[ext] = pickle.load(f, encoding="latin1")
    test_idx = _parse_index_file(os.path.join(raw, f"ind.{name}.test.index"))

    import scipy.sparse as sp
    allx, tx = objs["allx"].tolil(), objs["tx"].tolil()
    ally, ty = objs["ally"], objs["ty"]

    test_idx_range = np.sort(test_idx)
    if name == "citeseer":
        # isolated test nodes: extend tx / ty over the whole contiguous
        # range of test ids with zero rows, which the isolated nodes keep.
        # (The JAX package also widens test_idx_range to that range, and
        # then the reorder below fails on citeseer's files; the Planetoid
        # code keeps the listed ids, as here.)
        n_range = test_idx_range.max() - test_idx_range.min() + 1
        tx_ext = sp.lil_matrix((n_range, tx.shape[1]))
        tx_ext[test_idx_range - test_idx_range.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((n_range, ty.shape[1]))
        ty_ext[test_idx_range - test_idx_range.min(), :] = ty
        ty = ty_ext

    # the test rows are stored in test.index order: put them at their ids
    features = sp.vstack([allx, tx]).tolil()
    features[test_idx, :] = features[test_idx_range, :]
    labels = np.vstack([ally, ty])
    labels[test_idx, :] = labels[test_idx_range, :]

    x = np.asarray(features.todense(), dtype=np.float32)
    y = labels.argmax(axis=1).astype(np.int64)

    rows, cols = [], []
    for src, nbrs in objs["graph"].items():
        for dst in nbrs:
            rows.append(src)
            cols.append(dst)
    edge_index = np.stack([np.array(rows), np.array(cols)])
    keep = (edge_index[0] < x.shape[0]) & (edge_index[1] < x.shape[0])
    return GraphData(x=x, y=y, edge_index=edge_index[:, keep], name=name)


def load_geom_gcn(name: str, root: str, sparse_features: bool = False,
                  undirected: bool = False,
                  feature_dim: Optional[int] = None) -> GraphData:
    """Parse the geom-gcn raw format of WebKB (texas / wisconsin /
    cornell), Wikipedia (chameleon / squirrel) and Actor.

    Files (a header line, then tab-separated rows):
    ``out1_node_feature_label.txt`` holds ``node_id\tfeature\tlabel``,
    ``feature`` a comma-separated list of values, or with
    ``sparse_features=True`` (Actor) of the indices of one-valued entries
    of a ``feature_dim``-wide bag of words; ``out1_graph_edges.txt`` holds
    ``src\tdst`` directed edges. ``undirected=True`` adds every edge's
    reverse (WebKB); duplicates are coalesced either way, and the edges
    come out sorted. The files are looked for in ``<root>/<name>/raw``,
    ``<root>/<Name>/raw``, ``<root>/<name>/geom_gcn/raw`` and
    ``<root>/<name>``."""
    candidates = [os.path.join(root, name, "raw"),
                  os.path.join(root, name.capitalize(), "raw"),
                  os.path.join(root, name, "geom_gcn", "raw"),
                  os.path.join(root, name)]
    raw = next((d for d in candidates
                if os.path.isfile(os.path.join(
                    d, "out1_node_feature_label.txt"))), None)
    if raw is None:
        raise FileNotFoundError(
            f"geom-gcn raw files for {name} not found under {root}; expected "
            f"out1_node_feature_label.txt + out1_graph_edges.txt in one of "
            f"{candidates}, or provide <root>/{name}.npz")

    ids, feats, labels = [], [], []
    for nid, feat, lab in _tab_rows(
            os.path.join(raw, "out1_node_feature_label.txt")):
        ids.append(int(nid))
        labels.append(int(lab))
        feats.append([int(v) for v in feat.split(",")] if feat else [])
    n = max(ids) + 1
    y = np.zeros(n, np.int64)
    y[np.asarray(ids)] = labels
    if sparse_features:
        d = feature_dim or (max((max(fi) for fi in feats if fi),
                                default=-1) + 1)
        x = np.zeros((n, d), np.float32)
        for nid, fi in zip(ids, feats):
            x[nid, fi] = 1.0
    else:
        x = np.zeros((n, len(feats[0])), np.float32)
        for nid, fi in zip(ids, feats):
            x[nid] = fi

    e = np.asarray([(int(s), int(t)) for s, t in _tab_rows(
        os.path.join(raw, "out1_graph_edges.txt"))], np.int64).T
    if undirected:
        e = np.concatenate([e, e[::-1]], axis=1)
    e = np.unique(e.T, axis=0).T
    return GraphData(x=x, y=y, edge_index=e, name=name)


def _tab_rows(path):
    """The tab-separated fields of each non-empty line after the header."""
    with open(path) as f:
        next(f)
        for line in f:
            line = line.strip()
            if line:
                yield line.split("\t")


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
