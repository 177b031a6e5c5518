"""The frozen generators give the published shapes from a seed, and the
same inputs twice."""

import torch

from benchlib import graphs

BIG_SEED = 2 ** 33 + 12345


def test_cora_like_shape_and_repeat():
    X, adj, y = graphs.cora_like(BIG_SEED, 2708, 1433, 7,
                                 10556 / 2708 ** 2, "cpu")
    assert X.shape == (2708, 1433) and X.dtype == torch.float32
    assert adj.shape == (2708, 2708)
    assert torch.equal(adj, adj.T) and float(adj.diagonal().abs().sum()) == 0
    assert set(torch.unique(adj).tolist()) <= {0.0, 1.0}
    assert y.shape == (2708,) and int(y.max()) < 7
    # each directed pair drawn at Cora's density, then symmetrized
    assert 15000 < float(adj.sum()) < 27000
    X2, adj2, y2 = graphs.cora_like(BIG_SEED, 2708, 1433, 7,
                                    10556 / 2708 ** 2, "cpu")
    assert torch.equal(X, X2) and torch.equal(adj, adj2) \
        and torch.equal(y, y2)
    X3, _, _ = graphs.cora_like(BIG_SEED + 1, 2708, 1433, 7,
                                10556 / 2708 ** 2, "cpu")
    assert not torch.equal(X, X3)


def test_arxiv_like_shape_and_repeat():
    args = (169343, 128, 40, 1166243, 13000, "cpu")
    x, y, ei = graphs.arxiv_like(BIG_SEED, *args)
    assert x.shape == (169343, 128) and y.shape == (169343,)
    assert int(y.max()) == 39
    assert ei.shape[0] == 2 and ei.shape[1] % 2 == 0
    # about 1.17 M undirected edges after duplicates, stored both ways
    assert 2.0e6 < ei.shape[1] < 2.34e6
    assert bool((ei[0] != ei[1]).all())
    deg = torch.bincount(ei[1], minlength=169343)
    assert 8000 < int(deg.max()) < 20000
    half = ei.shape[1] // 2
    assert torch.equal(ei[0, :half], ei[1, half:])
    x2, y2, ei2 = graphs.arxiv_like(BIG_SEED, *args)
    assert torch.equal(x, x2) and torch.equal(y, y2) \
        and torch.equal(ei, ei2)


def test_splits_are_disjoint_and_seeded():
    a, b = graphs.node_split(BIG_SEED, 2708, (140, 500), "cpu", "run", 3)
    assert len(set(a.tolist()) | set(b.tolist())) == 640
    a2, _ = graphs.node_split(BIG_SEED, 2708, (140, 500), "cpu", "run", 3)
    a3, _ = graphs.node_split(BIG_SEED, 2708, (140, 500), "cpu", "run", 4)
    assert torch.equal(a, a2) and not torch.equal(a, a3)
