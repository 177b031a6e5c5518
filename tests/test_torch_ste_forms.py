"""The fused STE-GCN's held aggregation inputs (``ops/fused_spmm.py::
SteForms``): ``a_sym`` and the degrees are formed once per value of the
adjacency, never read stale, and change no bit of what the model and the
whole run compute against forming them on every call."""

from unittest import mock

import numpy as np
import pytest
import torch

from laplace_gnn_torch import models as TM
from laplace_gnn_torch import profiling
from laplace_gnn_torch.curvature.interface import GGNBackend
from laplace_gnn_torch.graph import datasets as TDS
from laplace_gnn_torch.ops import fused_spmm as FS
from laplace_gnn_torch.training import marglik_gnn as TT

KW = dict(lr=0.03, lr_adj=0.2, weight_decay=5e-4, n_epochs=12,
          n_hypersteps=3, n_epochs_burnin=4, marglik_frequency=4,
          grad_norm=True, momentum_adj=0.9, weight_decay_adj=5e-4,
          model_type="stegcn")
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module")
def karate():
    return TDS.load_data("karate", n_rand_splits=1)


def _model(d, dtype, device="cpu"):
    m = TM.STEGCN(d.num_features, 8, d.num_classes, 2, d.x, d.adjacency(),
                  dropout_p=0.0, fused=True, symmetric=True, device=device,
                  dtype=dtype, generator=torch.Generator().manual_seed(0))
    return m, {k: v.detach().clone().requires_grad_(True)
               for k, v in m.params().items()}


def _per_call(model):
    """``model``'s aggregations forming their inputs on every call, as
    :func:`ste_norm_aggregate` does."""
    return mock.patch.object(model.ste_forms, "aggregate",
                             FS.ste_norm_aggregate)


def _assert_fresh(model, adj):
    """The held buffers are the forms of ``adj``'s value, bit for bit."""
    (held,) = model.ste_forms._held.values()
    with torch.no_grad():
        a_sym = FS._sym(adj, True)
        d = FS._ste_degree(a_sym, model.threshold, adj.dtype)
    assert torch.equal(held.a_sym, a_sym)
    assert torch.equal(held.d, d)


def _forward_backward(model, params, idx, y):
    f = model.apply(params, idx)
    loss = torch.nn.functional.cross_entropy(f, y)
    return (f.detach(),) + torch.autograd.grad(loss, list(params.values()))


def _assert_matches_per_call(model, params, idx, y):
    held = _forward_backward(model, params, idx, y)
    with _per_call(model):
        fresh = _forward_backward(model, params, idx, y)
    for a, b in zip(held, fresh):
        assert torch.equal(a, b)


def _edit(adj):
    """Flip two symmetric pairs across the threshold, in place."""
    with torch.no_grad():
        for i, j in ((0, 5), (3, 20)):
            v = 0.9 if adj[i, j] < 0.5 else 0.1
            adj[i, j] = adj[j, i] = v


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("way", ["hyperstep", "load", "inplace",
                                 "new_tensor", "transforms"])
def test_held_forms_follow_every_change_of_the_adjacency(karate, way,
                                                         dtype):
    d = karate
    tr, va, _ = d.split(0)
    idx = torch.as_tensor(tr)
    y = torch.as_tensor(d.y[tr])
    model, params = _model(d, dtype)
    model.apply(params, idx)
    _assert_fresh(model, params["adj"])
    before = params["adj"].detach().clone()
    if way == "hyperstep":
        cfg = {k: KW[k] for k in ("lr", "lr_adj", "weight_decay",
                                  "weight_decay_adj", "momentum_adj",
                                  "grad_norm")}
        progs = TT.TrainingPrograms(
            model, params, hessian_structure="kron", subset_of_weights="all",
            prior_precision=1.0, N=len(tr), **cfg)
        progs.hyperstep(idx, y)
        # the step itself forms: the buffers are fresh before any forward
        _assert_fresh(model, params["adj"])
    elif way == "load":
        TT.marglik_optimization_scan(model, params, tr, d.y[tr], va,
                                     d.y[va], device="cpu", **KW)
        (run,) = TT._model_program_cache(model).values()
        other = dict(params)
        other["adj"] = params["adj"].detach().clone()
        _edit(other["adj"])
        run._load(other, run.tr_idx, run.tr_y, run.va_idx, run.va_y)
        _assert_fresh(model, run.params["adj"])
        assert torch.equal(run.params["adj"], other["adj"])
        params = run.params
    elif way == "inplace":
        _edit(params["adj"])
    elif way == "new_tensor":
        # made out of place: the same version, offset and strides as the
        # held key's, only the storage differs
        edited = before.clone()
        _edit(edited)
        params = dict(params)
        params["adj"] = edited.clone().requires_grad_(True)
        (held,) = model.ste_forms._held.values()
        assert held.key[2] == params["adj"]._version == 0
    else:
        # the first forward after the edit runs under torch.func: the
        # Jacobians' vjp and the KFAC pullback's vjp under vmap
        _edit(params["adj"])
        backend = GGNBackend(model, params, "classification")
        js = backend.jacobians(idx)
        _assert_fresh(model, params["adj"])
        with _per_call(model):
            js_fresh = GGNBackend(model, params,
                                  "classification").jacobians(idx)
        for a, b in zip(js, js_fresh):
            assert torch.equal(a, b)
        _edit(params["adj"])
        loss, H = backend.kron(idx, y, N=len(tr))
        _assert_fresh(model, params["adj"])
        with _per_call(model):
            loss_f, H_f = GGNBackend(model, params, "classification").kron(
                idx, y, N=len(tr))
        assert torch.equal(loss, loss_f)
        for a, b in zip(H.kfacs, H_f.kfacs):
            for fa, fb in zip(a, b):
                assert torch.equal(fa, fb)
    assert not torch.equal(params["adj"].detach(), before)
    model.apply(params, idx)
    _assert_fresh(model, params["adj"])
    _assert_matches_per_call(model, params, idx, y)


def _counted_run(model, params, d, split):
    tr, va = split
    profiling.reset_counters()
    with torch.profiler.profile():
        out = TT.marglik_optimization_scan(model, params, tr, d.y[tr], va,
                                           d.y[va], device="cpu", **KW)
    return out, profiling.counters()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_whole_run_forms_once_per_adjacency_value(karate, dtype):
    """``ste.forms`` is 1 + the hypersteps in each call of a whole run,
    ``ste.calls`` two a forward; and the run's traces, best and final
    parameters are those of a run that forms on every call."""
    d = karate
    tr, va, _ = d.split(0)
    model, params = _model(d, dtype)
    # hyper phases at epochs 4 and 8 (none at the last, 12)
    n_hyper = KW["n_hypersteps"] * 2
    # each epoch: the train step, the -log marglik and the validation
    # forward; each hyperstep: the -log marglik's forward
    forwards = 3 * KW["n_epochs"] + n_hyper
    perm = np.random.default_rng(1).permutation(d.num_nodes)
    splits = [(tr, va), (perm[:len(tr)], perm[len(tr):len(tr) + len(va)])]
    runs = []
    for split in splits:
        out, c = _counted_run(model, params, d, split)
        assert c["step.hyperstep.eager"] == n_hyper > 0
        assert c["ste.forms"] == 1 + n_hyper
        assert c["ste.calls"] == 2 * forwards
        runs.append(out)
    fresh_model, _ = _model(d, dtype)
    with _per_call(fresh_model):
        for split, held in zip(splits, runs):
            fresh, c = _counted_run(fresh_model, params, d, split)
            # every call forms, beside the run's own 1 + n_hyper forms
            assert c["ste.calls"] == 2 * forwards
            assert c["ste.forms"] == 2 * forwards + 1 + n_hyper
            for a, b in zip(held[2:], fresh[2:]):
                np.testing.assert_array_equal(a, b)
            for k, v in fresh[1].items():
                assert torch.equal(held[1][k], v), k
            for crit in ("marglik", "valloss"):
                assert held[0][crit]["epoch"] == fresh[0][crit]["epoch"]
                for k, v in fresh[0][crit]["params"].items():
                    assert torch.equal(held[0][crit]["params"][k], v), k
    assert not torch.equal(runs[0][1]["adj"], params["adj"].detach())


def test_captured_form_is_read_only_by_captures(karate, monkeypatch):
    """A form made while a stream captures holds its value only once the
    graph replays: a capture reads it, an eager call forms anew. With no
    buffers yet, a capture's form holds nothing (the capture check is
    faked: the CPU has no stream to capture)."""
    d = karate
    model, params = _model(d, torch.float64)
    adj = params["adj"]
    capturing = [True]
    monkeypatch.setattr(FS, "_capturing", lambda: capturing[0])
    forms = model.ste_forms
    forms.form(adj, 0.5, True, adj.dtype)
    assert forms._held == {}
    capturing[0] = False
    held = forms.form(adj, 0.5, True, adj.dtype)
    assert not held.captured
    capturing[0] = True
    _edit(adj)
    assert forms.form(adj, 0.5, True, adj.dtype) is held and held.captured
    calls = []
    monkeypatch.setattr(FS, "_sym", lambda a, s: calls.append(1) or
                        ((a + a.T) / 2).contiguous())
    model.apply(params, torch.arange(4))
    assert calls == []
    capturing[0] = False
    model.apply(params, torch.arange(4))
    assert calls == [1] and not held.captured
    model.apply(params, torch.arange(4))
    assert calls == [1]


@pytest.mark.cuda
def test_captured_steps_form_only_in_the_hyperstep(karate, monkeypatch):
    """On the card: capturing the train, tracking and -log marglik steps
    forms nothing; capturing the hyperstep forms once. After replayed
    hypersteps that moved the adjacency the held buffers are its forms,
    and the replayed run's traces equal the eager loop's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = karate
    tr, va, _ = d.split(0)
    model, params = _model(d, torch.float32, device="cuda")
    sym = FS._sym
    formed = []
    step = [None]

    def counted(adj, symmetric):
        if torch.cuda.is_current_stream_capturing():
            formed.append(step[0])
        return sym(adj, symmetric)
    monkeypatch.setattr(FS, "_sym", counted)
    capture = TT.capture

    def named(steps, generators=()):
        for s in steps:
            fn = s.fn

            def tagged(fn=fn, name=s.name):
                step[0] = name
                fn()
            s.fn = tagged
        capture(steps, generators)
    monkeypatch.setattr(TT, "capture", named)
    scan = TT.marglik_optimization_scan(model, params, tr, d.y[tr], va,
                                        d.y[va], device="cuda", **KW)
    (run,) = TT._model_program_cache(model).values()
    assert all(run.captured.values()), run.captured
    assert formed == ["hyperstep"]
    assert run.steps["hyperstep"].calls > 2
    assert not torch.equal(scan[1]["adj"], params["adj"].detach())
    _assert_fresh(model, run.params["adj"])
    eager = TT.marglik_optimization(model, params, tr, d.y[tr], va, d.y[va],
                                    verbose=False, device="cuda", **KW)
    for a, b in zip(scan[2:], eager[2:]):
        np.testing.assert_array_equal(a, b)
    for k, v in eager[1].items():
        assert torch.equal(scan[1][k], v), k
