"""The STE-GCN's composed route's spans and counters (profiling.py): the
composed form counts ``ste.composed.forms`` once a forward and the fused
aggregation's ``ste.forms`` never, the reverse on the fused route; the
backward of the small eigensolver recomputes its vectors under the span
``eigh.vectors`` and counts one a batched solve, two a composed hyperstep
(one per Kron factor size) and none a fused one; with no profiler
recording nothing is counted and no range is opened."""

import pytest
import torch

from laplace_gnn_torch import models as TM
from laplace_gnn_torch import profiling
from laplace_gnn_torch.graph import datasets as TDS
from laplace_gnn_torch.training import marglik_gnn as TT

HIDDEN = 8
KW = dict(lr=0.03, lr_adj=0.2, weight_decay=5e-4, weight_decay_adj=5e-4,
          momentum_adj=0.9, grad_norm=True)


@pytest.fixture(scope="module")
def karate():
    return TDS.load_data("karate", n_rand_splits=1)


def _programs(d, fused):
    model = TM.STEGCN(d.num_features, HIDDEN, d.num_classes, 2, d.x,
                      d.adjacency(), dropout_p=0.0, fused=fused,
                      symmetric=True, device="cpu", dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.params().items()}
    tr, _, _ = d.split(0)
    progs = TT.TrainingPrograms(
        model, params, hessian_structure="kron", subset_of_weights="all",
        prior_precision=1.0, N=len(tr), **KW)
    return model, params, progs, torch.as_tensor(tr), \
        torch.as_tensor(d.y[tr])


def _traced(fn):
    profiling.reset_counters()
    with torch.profiler.profile() as prof:
        fn()
    names = [e.name for e in prof.events()
             if e.name.startswith(profiling.SPAN_PREFIX)]
    return profiling.counters(), names


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
def test_a_forward_counts_its_route(karate, fused):
    model, params, _, idx, _ = _programs(karate, fused)
    got, names = _traced(lambda: model.apply(params, idx))
    if fused:
        assert got.get("ste.composed.forms", 0) == 0
        assert got["ste.forms"] >= 1
        assert "lgnn.ste.composed" not in names
    else:
        assert got["ste.composed.forms"] == 1
        assert got.get("ste.forms", 0) == 0 and got.get("ste.calls", 0) == 0
        assert names.count("lgnn.ste.composed") == 1


@pytest.mark.parametrize("fused", [False, True], ids=["composed", "fused"])
def test_a_hyperstep_recomputes_eigenvectors_on_the_composed_route_only(
        karate, fused):
    _, params, progs, idx, y = _programs(karate, fused)
    # the Kron factors' sizes: B of each layer (HIDDEN, C) and A of the
    # second (HIDDEN): two batched solves, one a size
    assert karate.num_classes != HIDDEN
    before = params["adj"].detach().clone()
    got, names = _traced(lambda: progs.hyperstep(idx, y))
    n_vectors = 0 if fused else 2
    assert got.get("eigh.vectors", 0) == n_vectors
    assert names.count("lgnn.eigh.vectors") == n_vectors
    assert got["eigh.calls"] == 2
    if fused:
        assert got.get("ste.composed.forms", 0) == 0
    else:
        # the KFAC's forward forms the graph once; the hypergradient moves
        # it by more than the decay
        assert got["ste.composed.forms"] == 1
        moved = (params["adj"].detach() - before).abs().max()
        assert float(moved) > 10 * KW["lr_adj"] * KW["weight_decay_adj"]
    # a -log marglik evaluation runs no backward
    got, _ = _traced(lambda: progs.neg_marglik_eval(idx, y))
    assert got.get("eigh.vectors", 0) == 0


def test_off_the_composed_route_counts_nothing_and_opens_no_range(
        karate, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was opened with no profiler on")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()
    model, params, progs, idx, y = _programs(karate, False)
    model.apply(params, idx)
    progs.hyperstep(idx, y)
    progs.neg_marglik_eval(idx, y)
    assert profiling.counters() == {}
