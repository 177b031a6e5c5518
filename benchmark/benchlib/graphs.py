"""Seeded graphs at published shapes, made on the device in a few large
calls from a ``torch.Generator``.

Frozen copies of the repository's synthetic generators (``chip_smoke.py``
``make_graph`` and ``arxiv_like``), moved from numpy on the host to torch
on the device: the same distributions, other random streams. The same
seed on the same device gives the same tensors."""

from __future__ import annotations

import math

import numpy as np
import torch


def substream(seed: int, *keys) -> int:
    """A 63-bit seed for the draw ``keys`` of a run seeded with ``seed``
    (any whole number >= 0, larger than 32 bits included)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for k in keys:
        if isinstance(k, str):
            words.extend(k.encode())
        else:
            words.extend([int(k) & 0xFFFFFFFF, (int(k) >> 32) & 0xFFFFFFFF])
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2 ** 63 - 1)


def generator(seed: int, device, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(substream(seed, *keys))


def cora_like(seed: int, n_nodes: int, n_features: int, n_classes: int,
              density: float, device):
    """(X (N, F) float32, adj (N, N) float32 0/1, symmetric with a zero
    diagonal, y (N,) int64) as ``make_graph`` builds them: standard normal
    features, each directed pair drawn with probability ``density`` and
    the result symmetrized, uniform labels."""
    g = generator(seed, device, "cora_like")
    X = torch.randn(n_nodes, n_features, generator=g, device=device)
    adj = (torch.rand(n_nodes, n_nodes, generator=g, device=device)
           < density).float()
    adj = torch.maximum(adj, adj.T)
    adj.fill_diagonal_(0.0)
    y = torch.randint(0, n_classes, (n_nodes,), generator=g, device=device)
    return X, adj, y


def arxiv_like(seed: int, n_nodes: int, n_features: int, n_classes: int,
               n_undirected: int, max_degree: int, device):
    """(x (N, F) float32, y (N,) int64, edge_index (2, E) int64) as
    ``arxiv_like`` builds them: class-informative Gaussian features
    (signal 3 / sqrt(F)), and a Chung-Lu graph whose expected degrees
    follow a power law (exponent 2.5, capped at ``max_degree``, which
    three hubs reach) with 65% of the ``n_undirected`` drawn edges inside
    a class; self-pairs dropped, the undirected edges deduplicated and
    stored both ways."""
    g = generator(seed, device, "arxiv_like")
    n, c, e = n_nodes, n_classes, n_undirected
    f64 = dict(device=device, dtype=torch.float64)
    y = torch.randint(0, c, (n,), generator=g, device=device)
    means = torch.randn(c, n_features, generator=g, **f64) * (
        3 / math.sqrt(n_features))
    x = (means[y] + torch.randn(n, n_features, generator=g, **f64)).float()
    w = (1 - torch.rand(n, generator=g, **f64)) ** (-1 / 1.5)
    cap = max_degree * float(w.sum()) / (2 * e)
    w = torch.clamp(w, max=cap)
    w[torch.argsort(w)[-3:]] = 2.2 * cap
    cum = torch.cumsum(w, 0)
    a = torch.searchsorted(cum, torch.rand(e, generator=g, **f64) * cum[-1])
    b = torch.searchsorted(cum, torch.rand(e, generator=g, **f64) * cum[-1])
    a, b = a.clamp(max=n - 1), b.clamp(max=n - 1)
    # the homophilous edges draw their second end by weight within a's
    # class
    order = torch.sort(y, stable=True).indices
    ccum = torch.cumsum(w[order], 0)
    ends = torch.searchsorted(y[order].contiguous(),
                              torch.arange(c + 1, device=device))
    lo = torch.where(ends[:-1] > 0, ccum[(ends[:-1] - 1).clamp(min=0)],
                     torch.zeros((), **f64))
    hi = ccum[ends[1:] - 1]
    homo = torch.rand(e, generator=g, **f64) < 0.65
    cls = y[a[homo]]
    t = lo[cls] + torch.rand(int(cls.shape[0]), generator=g, **f64) * (
        hi[cls] - lo[cls])
    b[homo] = order[torch.searchsorted(ccum, t).clamp(max=n - 1)]
    keep = a != b
    pairs = torch.unique(torch.minimum(a, b)[keep] * n
                         + torch.maximum(a, b)[keep])
    u, v = pairs // n, pairs % n
    return x, y, torch.stack([torch.cat([u, v]), torch.cat([v, u])])


def node_split(seed: int, n_nodes: int, sizes, device, *keys):
    """Disjoint index sets of the given sizes from one seeded permutation
    (a split of a grid over splits)."""
    perm = torch.randperm(n_nodes, generator=generator(seed, device, "split",
                                                       *keys),
                          device=device)
    out, at = [], 0
    for s in sizes:
        out.append(perm[at:at + s])
        at += s
    return out
