"""Port parity for the whole run (training/marglik_gnn.py::
marglik_optimization_scan) in float64 on the CPU: against the port's eager
loop at 1e-12 for plain, dropout, early-stop and grad_norm runs, fused and
composed; against JAX's whole run at 1e-9 with its snapshot files; the
program cache; DeviceAdam against torch's Adam; BaseGNN.reset_adj."""

import os
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.graph import datasets as TDS
from laplace_gnn_torch.graph.plots import get_learned_graphs
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils.pytree import named_leaves, params_from_numpy

KW = dict(lr=0.03, lr_adj=0.2, weight_decay=5e-4, n_epochs=12,
          n_hypersteps=3, n_epochs_burnin=4, marglik_frequency=4,
          model_type="stegcn")


@pytest.fixture(scope="module")
def karate():
    return TDS.load_data("karate", n_rand_splits=1)


def _model(d, fused=False, dropout_p=0.0):
    m = TM.STEGCN(d.num_features, 8, d.num_classes, 2, d.x, d.adjacency(),
                  dropout_p=dropout_p, fused=fused, device="cpu",
                  dtype=torch.float64)
    return m, m.params()


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _count_hypersteps():
    calls = {"n": 0}
    hyperstep = TT.TrainingPrograms.hyperstep

    def counted(self, *args):
        calls["n"] += 1
        return hyperstep(self, *args)
    return calls, mock.patch.object(TT.TrainingPrograms, "hyperstep",
                                    counted)


def _assert_runs_equal(eager, scan, rtol):
    (r1, p1, l1, v1, n1), (r2, p2, l2, v2, n2) = eager, scan
    assert isinstance(l2, np.ndarray) and l2.shape == (len(l1),)
    assert _rel(l2, l1) <= rtol
    assert _rel(v2, v1) <= rtol
    assert _rel(n2, n1) <= rtol
    for crit in ("marglik", "valloss"):
        assert r2[crit]["epoch"] == r1[crit]["epoch"], crit
        for k, v in r1[crit]["params"].items():
            np.testing.assert_allclose(r2[crit]["params"][k].numpy(),
                                       v.numpy(), rtol=rtol, atol=1e-14,
                                       err_msg=f"{crit} {k}")
    for k, v in p1.items():
        np.testing.assert_allclose(p2[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=1e-14, err_msg=k)


VARIANTS = {
    "plain": dict(),
    "dropout": dict(dropout_p=0.5),
    # PATIENCE 3 with a rising -log marglik halts the graph updates after
    # the second of five scheduled hyper phases
    "early_stop": dict(n_epochs=16, n_hypersteps=2, n_epochs_burnin=2,
                       marglik_frequency=3, early_stop=True),
    "grad_norm": dict(grad_norm=True, momentum_adj=0.9,
                      weight_decay_adj=5e-4),
}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_scan_matches_eager_loop(karate, variant, fused, monkeypatch):
    d = karate
    tr, va, _ = d.split(0)
    kw = dict(KW, **VARIANTS[variant])
    model, params = _model(d, fused, kw.pop("dropout_p", 0.0))
    if kw.get("early_stop"):
        monkeypatch.setattr(TT, "PATIENCE", 3)
    calls, patch = _count_hypersteps()
    with patch:
        eager = TT.marglik_optimization(model, params, tr, d.y[tr], va,
                                        d.y[va], verbose=False,
                                        device="cpu", **kw)
        eager_calls, calls["n"] = calls["n"], 0
        scan = TT.marglik_optimization_scan(model, params, tr, d.y[tr], va,
                                            d.y[va], device="cpu", **kw)
    _assert_runs_equal(eager, scan, 1e-12)
    assert calls["n"] == eager_calls
    run = next(iter(TT._model_program_cache(model).values()))
    n_phases = len(run.hyper_epochs)
    if variant == "early_stop":
        # the stop: two of the five phases ran, in both loops
        assert n_phases == 5 and calls["n"] == 2 * kw["n_hypersteps"]
        assert bool(run.best["no_adj"])
    else:
        assert calls["n"] == n_phases * kw["n_hypersteps"] > 0
    # the hypersteps moved the adjacency: the fused op's d/d adj is zero
    # (as in JAX), so there only weight decay moves it
    moved = not torch.equal(scan[1]["adj"], params["adj"])
    assert moved == (not fused or kw.get("weight_decay_adj", 0) > 0)
    if variant == "dropout":
        # the masks change the trajectory
        no_drop, _ = _model(d, fused)
        plain = TT.marglik_optimization_scan(no_drop, params, tr, d.y[tr],
                                             va, d.y[va], device="cpu", **kw)
        assert not np.allclose(plain[2], scan[2])
    assert run.captured == {"train_step": False, "hyperstep": False,
                            "neg_marglik": False, "tracking": False}


@pytest.fixture(scope="module")
def jax_and_port_runs(karate, tmp_path_factory):
    """One whole run (fused=False, 9 epochs, hyper phases at 4 and 8) in
    JAX and in the port from JAX's initial parameters, each writing its
    snapshots."""
    d = karate
    tr, va, _ = d.split(0)
    kw = dict(KW, n_epochs=9, n_hypersteps=2, grad_norm=True,
              momentum_adj=0.9)
    jm = JM.STEGCN(d.num_features, 8, d.num_classes, 2, jnp.asarray(d.x),
                   d.adjacency(), dropout_p=0.0)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TM.STEGCN(d.num_features, 8, d.num_classes, 2, d.x, d.adjacency(),
                   dropout_p=0.0, device="cpu", dtype=torch.float64)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jdir = str(tmp_path_factory.mktemp("jax_snapshots"))
    tdir = str(tmp_path_factory.mktemp("port_snapshots"))
    jout = JT.marglik_optimization_scan(jm, jp, tr, d.y[tr], va, d.y[va],
                                        y=d.y, learned_graphs_dir=jdir, **kw)
    tout = TT.marglik_optimization_scan(tm, tp, tr, d.y[tr], va, d.y[va],
                                        y=d.y, learned_graphs_dir=tdir,
                                        device="cpu", **kw)
    return jout, tout, jdir, tdir


def test_scan_matches_jax(jax_and_port_runs):
    (jres, jpar, jl, jvl, jnm), (tres, tpar, tl, tvl, tnm), _, _ = \
        jax_and_port_runs
    assert _rel(tl, jl) <= 1e-9
    assert _rel(tvl, jvl) <= 1e-9
    assert _rel(tnm, jnm) <= 1e-9
    for crit in ("marglik", "valloss"):
        assert tres[crit]["epoch"] == jres[crit]["epoch"]
    jflat = dict(named_leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jpar), device="cpu")))
    for k, v in tpar.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=k)


def test_scan_snapshots_match_jax(jax_and_port_runs):
    _, _, jdir, tdir = jax_and_port_runs
    jsnaps = {s["epoch"]: s for _, s in get_learned_graphs(jdir)}
    tsnaps = {s["epoch"]: s for _, s in get_learned_graphs(tdir)}
    assert set(tsnaps) == set(jsnaps) == {4, 8}
    for e, js in jsnaps.items():
        ts = tsnaps[e]
        assert set(ts) == set(js)
        np.testing.assert_array_equal(ts["edge_index"], js["edge_index"])
        assert ts["num_edges"] == js["num_edges"]
        assert ts["epoch"] == js["epoch"] == e
        np.testing.assert_allclose(ts["homophily"], js["homophily"],
                                   rtol=1e-12)
        np.testing.assert_allclose(ts["marglik"], js["marglik"], rtol=1e-9)
    np.testing.assert_array_equal(
        np.load(os.path.join(tdir, "latest_adj.npy")),
        np.load(os.path.join(jdir, "latest_adj.npy")))


def test_scan_snapshots_match_eager_files(karate, tmp_path):
    """The whole run's files carry the eager loop's edges, edge counts and
    epochs (their marglik is the epoch's trace entry after the
    hypersteps, the eager loop's the last hyperstep's)."""
    d = karate
    tr, va, _ = d.split(0)
    model, params = _model(d, fused=True)
    eager_dir, scan_dir = str(tmp_path / "eager"), str(tmp_path / "scan")
    _, _, _, _, enm = TT.marglik_optimization(
        model, params, tr, d.y[tr], va, d.y[va], y=d.y, verbose=False,
        learned_graphs_dir=eager_dir, device="cpu", **KW)
    TT.marglik_optimization_scan(model, params, tr, d.y[tr], va, d.y[va],
                                 y=d.y, learned_graphs_dir=scan_dir,
                                 device="cpu", **KW)
    eager = {s["epoch"]: s for _, s in get_learned_graphs(eager_dir)}
    scan = {s["epoch"]: s for _, s in get_learned_graphs(scan_dir)}
    assert set(scan) == set(eager) == {4, 8}
    for e in eager:
        np.testing.assert_array_equal(scan[e]["edge_index"],
                                      eager[e]["edge_index"])
        assert scan[e]["num_edges"] == eager[e]["num_edges"]
        assert scan[e]["homophily"] == eager[e]["homophily"]
        np.testing.assert_allclose(-scan[e]["marglik"], enm[e - 1],
                                   rtol=1e-12)
    with open(os.path.join(scan_dir, "epoch_8.pkl"), "rb") as f:
        assert pickle.load(f)["epoch"] == 8


def test_program_cache_reuse(karate):
    """One entry per static configuration: a second call, and a call with
    another split of the same shapes, reuse it; a new configuration, or a
    validation split of another size, gets its own."""
    d = karate
    tr, va, te = d.split(0)
    model, params = _model(d)
    kw = dict(KW, n_epochs=4, n_hypersteps=1, n_epochs_burnin=1,
              marglik_frequency=2)
    cache = TT._model_program_cache(model)

    def run(tr_idx, va_idx, **extra):
        return TT.marglik_optimization_scan(
            model, params, tr_idx, d.y[tr_idx], va_idx, d.y[va_idx],
            device="cpu", **dict(kw, **extra))

    first = run(tr, va)
    assert len(cache) == 1
    entry = next(iter(cache.values()))
    again = run(tr, va)
    assert len(cache) == 1 and next(iter(cache.values())) is entry
    np.testing.assert_array_equal(again[2], first[2])
    np.testing.assert_array_equal(again[4], first[4])
    # another split of the same shapes: the same program, the new data
    perm = np.random.default_rng(1).permutation(d.num_nodes)
    tr2, va2 = perm[:len(tr)], perm[len(tr):len(tr) + len(va)]
    other = run(tr2, va2)
    assert len(cache) == 1
    fresh_model, _ = _model(d)
    fresh = TT.marglik_optimization_scan(
        fresh_model, params, tr2, d.y[tr2], va2, d.y[va2], device="cpu",
        **kw)
    np.testing.assert_array_equal(other[4], fresh[4])
    assert not np.array_equal(other[4], first[4])
    run(tr, va, lr=0.01)
    assert len(cache) == 2
    run(tr, te)                       # another validation size
    assert len(cache) == 3
    monkey = TT.PATIENCE
    try:
        TT.PATIENCE = 5
        run(tr, va)
    finally:
        TT.PATIENCE = monkey
    assert len(cache) == 4
    # an unhashable configuration builds uncached
    run(tr, va, prior_precision=torch.tensor(1.0, dtype=torch.float64))
    assert len(cache) == 4


def test_device_adam_matches_torch_adam():
    rng = np.random.default_rng(0)
    ps = [torch.tensor(rng.standard_normal(s)) for s in ((5, 3), (3,))]
    a = [p.clone().requires_grad_(True) for p in ps]
    b = [p.clone().requires_grad_(True) for p in ps]
    ref = torch.optim.Adam(a, lr=1e-2, weight_decay=5e-4)
    dev = TT.DeviceAdam(b, lr=1e-2, weight_decay=5e-4)
    for step in range(30):
        for x, y in zip(a, b):
            g = torch.tensor(rng.standard_normal(tuple(x.shape)))
            x.grad, y.grad = g, g.clone()
        ref.step()
        dev.step()
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.detach().numpy(),
                                       x.detach().numpy(), rtol=1e-13,
                                       atol=1e-15)
    assert float(dev.step_count) == 30.0
    dev.reset()
    assert float(dev.step_count) == 0 and not any(
        bool(t.any()) for t in dev.exp_avg + dev.exp_avg_sq)


def test_reset_adj(karate):
    d = karate
    jm = JM.STEGCN(d.num_features, 8, d.num_classes, 2, jnp.asarray(d.x),
                   d.adjacency(), dropout_p=0.0)
    jp = jm.init(jax.random.PRNGKey(0))
    jp = dict(jp, adj=jp["adj"] * 0.3)
    model, params = _model(d)
    params = dict(params, adj=params["adj"].detach() * 0.3)
    out = model.reset_adj(params)
    ref = np.asarray(jm.reset_adj(jp)["adj"])
    assert out is not params and out.keys() == params.keys()
    assert out["adj"].dtype == torch.float64
    np.testing.assert_array_equal(out["adj"].numpy(), ref)
    assert all(out[k] is params[k] for k in params if k != "adj")
    # a copy, not the model's buffer
    out["adj"].zero_()
    assert model.init_adj.sum() > 0
    f32 = model.reset_adj({"adj": torch.zeros(3, dtype=torch.float32)})
    assert f32["adj"].dtype == torch.float32


def test_step_counts_launches_of_calls_and_replays():
    """A step counts its kernels' launches whether it calls its function
    or replays a graph; a replay counts the launches its capture recorded
    (faked here: the CPU has no graph to capture)."""
    from laplace_gnn_torch.ops.fused_spmm import core
    from laplace_gnn_torch.training.graphs import Step, capture
    saved = core.launches, core.replayed

    def fn():                 # two launches, as _counted makes them
        core.launches += 2

    step = Step("s", fn, capture=False)
    capture([step])                          # nothing marked: a no-op
    assert step.graph is None
    core.launches = core.replayed = 0
    step()
    assert (core.launches, core.replayed, step.launches) == (2, 0,
                                                           {"core_spmm": 2})

    class Replayed:
        def replay(self):
            pass

    step.graph, step.recorded = Replayed(), {core: 2}
    step()
    step()
    assert (core.launches, core.replayed, step.calls) == (6, 4, 3)
    assert step.launches == {"core_spmm": 6}
    core.launches, core.replayed = saved


def test_capture_collects_dead_graphs_first_and_holds_gc_off():
    """Freeing a dead CUDA graph while a stream captures invalidates the
    capture, and a dead run (its steps and it refer to each other) is
    freed only by a collection: ``capture`` collects before its captures
    and holds the collector off during them, then restores it (the CUDA
    calls are faked: the CPU has no graph to capture)."""
    import gc
    from contextlib import contextmanager

    from laplace_gnn_torch.training.graphs import Step, capture
    events = []

    class Dead:                                  # a dead run's graph
        def __del__(self):
            events.append("dead graph freed")

    class FakeGraph:
        def register_generator_state(self, gen):
            pass

    @contextmanager
    def fake_capture(graph):
        events.append(("capture", gc.isenabled()))
        yield
        events.append(("capture ends", gc.isenabled()))

    class FakeStream:
        def wait_stream(self, other):
            pass

    def fn():
        events.append(("fn", gc.isenabled()))

    cuda = torch.cuda
    with mock.patch.object(cuda, "Stream", FakeStream), \
            mock.patch.object(cuda, "current_stream", FakeStream), \
            mock.patch.object(cuda, "stream", lambda s: mock.MagicMock()), \
            mock.patch.object(cuda, "CUDAGraph", FakeGraph), \
            mock.patch.object(cuda, "graph", fake_capture), \
            mock.patch.object(cuda, "synchronize", lambda: None):
        for enabled in (True, False):
            (gc.enable if enabled else gc.disable)()
            try:
                events.clear()
                dead = Dead()
                dead.cycle = dead
                del dead
                step = Step("s", fn, capture=True)
                capture([step])
                assert gc.isenabled() is enabled
            finally:
                gc.enable()
            # freed by the time the capture starts: by capture's own
            # collection, or by an automatic one before it
            assert (events.index("dead graph freed")
                    < events.index(("capture", False)))
            warm = [("fn", enabled)] * 2
            assert [e for e in events if e != "dead graph freed"] == warm + [
                ("capture", False), ("fn", False), ("capture ends", False)]
            assert isinstance(step.graph, FakeGraph)
