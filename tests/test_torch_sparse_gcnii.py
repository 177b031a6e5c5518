"""GCNII (initial residual and identity mapping, 32-layer capable) through
``SparseGCNII`` and the sparse CLI's ``build_model``, held to the
benchmark's plain reference (``benchmark/references/sparse_gcnii.py``,
float64 torch written from the paper's equations, loaded by path) on the
CPU in float64, on a ~300-node graph with hubs, on both SpMM layouts (the
dst-sorted segments, and ELL levels with a remainder).

Tolerances: the program and the reference both run in float64 and differ
only in the order of their sums (the SpMM's edge order, ``addmm`` and
``lerp`` against the reference's products and sums), so the logits and
every gradient agree to 1e-10 relative; the weights after three Adam
steps to 1e-9 absolute, since the normalized update divides by the square
root of the second moment, which magnifies a gradient's rounding where
the gradient is near nought.

Also: the theta schedule; alpha = 0 and theta = 1 make the layer a
bias-free GCN conv; the CLI end to end (``--subset_of_weights all`` is
refused with the model's name; the library's Kron posterior over every
weight takes the convs' weights into diagonal blocks); the conv's spans and counter under a
profiler and nothing without one; ``DeviceAdam``'s param-group form
against ``torch.optim.Adam`` with two groups, and its flat form bit for
bit and op for op as before."""

import importlib.util
import math
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from laplace_gnn_torch import profiling
from laplace_gnn_torch.graph import container as TC
from laplace_gnn_torch.models import SparseGCNIIConv
from laplace_gnn_torch.models.layers import GCNConv
from laplace_gnn_torch.training import sparse_experiment as SE
from laplace_gnn_torch.training.marglik_gnn import DeviceAdam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
N, D, HIDDEN, C, LAYERS = 300, 10, 12, 5, 6
CFG = dict(num_layers=LAYERS, alpha=0.1, lamda=0.6, lr=1e-2, wd1=0.01,
           wd2=5e-4)
OPTIONS = dict(alpha=0.1, lamda=0.6)


def _reference():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)            # the reference's benchlib
    spec = importlib.util.spec_from_file_location(
        "bench_references_sparse_gcnii",
        os.path.join(BENCH, "references", "sparse_gcnii.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _graph_data(seed=3):
    """A graph with two hubs (one on every node, one on a third of
    them) and random edges, stored both ways, no self-pairs; features and
    labels."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([np.zeros(N - 1, int), np.ones(N // 3, int),
                        rng.integers(2, N, 900)])
    b = np.concatenate([np.arange(1, N), rng.integers(2, N, N // 3),
                        rng.integers(2, N, 900)])
    keep = a != b
    pairs = np.unique(np.sort(np.stack([a[keep], b[keep]]), axis=0),
                      axis=1)
    ei = np.concatenate([pairs, pairs[::-1]], axis=1)
    x = torch.as_tensor(rng.standard_normal((N, D)))
    y = torch.as_tensor(rng.integers(0, C, N))
    return ei, x, y


def _args(*extra):
    return SE.argument_parser().parse_args(
        ["--model_type", "sparsegcnii", "--hidden_channels", str(HIDDEN),
         "--num_layers", str(LAYERS), *extra])


def _model(ell: bool, seed=3):
    ei, x, y = _graph_data(seed)
    g = TC.sparse_from_edge_index(ei, N, normalize="sym",
                                  dtype=torch.float64, device="cpu")
    if ell:
        g = TC.add_ell_format(g, max_k=4, pad_budget=1.2)
        assert g.ell_levels and g.has_remainder()
    data = types.SimpleNamespace(edge_index=ei, num_nodes=N, num_features=D,
                                 num_classes=C, x=x)
    model = SE.build_model(_args(), data, g, device="cpu",
                           dtype=torch.float64, **OPTIONS)
    gen = torch.Generator().manual_seed(seed)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen,
                                        dtype=v.dtype)
              for k, v in model.init(gen).items()}
    return model, params, torch.as_tensor(ei), x, y


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("ell", [False, True], ids=["segment", "ell"])
def test_logits_and_every_gradient_match_the_reference(ell):
    model, params, ei, x, y = _model(ell)
    assert set(params) == set(REF.weight_names(LAYERS))
    agg = REF.Aggregation(ei, N, "float64")
    rows = torch.arange(0, N, 2)
    outs, grads = [], []
    for side in ("program", "reference"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        out = (model.apply(p) if side == "program" else
               REF.forward(p, x, agg, CFG, "float64", torch.arange(N)))
        loss = torch.nn.functional.cross_entropy(out[rows], y[rows])
        outs.append(out.detach())
        grads.append(dict(zip(p, torch.autograd.grad(loss,
                                                     list(p.values())))))
    assert _rel(outs[0], outs[1]) < 1e-10
    for k in params:
        assert float(torch.linalg.norm(grads[1][k])) > 0, k
        assert _rel(grads[0][k], grads[1][k]) < 1e-10, k


@pytest.mark.parametrize("ell", [False, True], ids=["segment", "ell"])
def test_three_adam_steps_with_two_decay_groups_match_the_reference(ell):
    model, params, ei, x, y = _model(ell)
    tr = torch.arange(1, N, 3)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    groups = model.param_groups(p)
    assert [g["weight_decay"] for g in groups] == [0.01, 5e-4]
    assert sum(len(g["params"]) for g in groups) == len(p)
    opt = DeviceAdam(groups, lr=CFG["lr"])
    losses = []
    for _ in range(3):
        with torch.no_grad():
            losses.append(float(torch.nn.functional.cross_entropy(
                model.apply(p, tr), y[tr])))
        SE.train_steps(model, p, opt, tr, y[tr], 1)
    ref = REF.train_steps(x, ei, y, tr, params, CFG, 3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-10)
    moved = 0.0
    for k, v in ref["params"].items():
        np.testing.assert_allclose(p[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=1e-9, err_msg=k)
        moved = max(moved, float((v - params[k]).abs().max()))
    assert moved > 1e-2                  # the steps moved the weights
    # the decays are the source's: without them the weights part
    plain = REF.train_steps(x, ei, y, tr, params, dict(CFG, wd1=0.0), 3)
    assert max(float((plain["params"][k] - v).abs().max())
               for k, v in ref["params"].items()) > 1e-6


def test_the_theta_schedule():
    model, _, _, _, _ = _model(False)
    convs = model.convs[1:-1]
    assert len(convs) == LAYERS
    want = [math.log(0.6 / l + 1) for l in range(1, LAYERS + 1)]
    assert [c.theta for c in convs] == want
    assert [REF.theta(0.6, l) for l in range(1, LAYERS + 1)] == want
    assert all(c.alpha == 0.1 for c in convs)
    # the source's default lamda, 0.5, where none is given
    ei, x, _ = _graph_data()
    g = TC.sparse_from_edge_index(ei, N, device="cpu")
    m = SE.build_model(_args(), types.SimpleNamespace(
        num_features=D, num_classes=C, x=x), g, device="cpu")
    assert m.convs[3].theta == math.log(0.5 / 3 + 1)


def test_alpha_nought_and_theta_one_make_a_bias_free_gcn_conv():
    ei, x, _ = _graph_data()
    g = TC.FastAggGraph(TC.sparse_from_edge_index(
        ei, N, normalize="sym", dtype=torch.float64, device="cpu"))
    gen = torch.Generator().manual_seed(1)
    conv = SparseGCNIIConv(D, 0.0, 1.0, generator=gen, dtype=torch.float64)
    gcn = GCNConv(D, D, bias=False, dtype=torch.float64)
    gcn.lin.weight = conv.lin.weight
    h0 = torch.randn(N, D, dtype=torch.float64)
    torch.testing.assert_close(conv(g, x, h0), torch.relu(gcn(g, x)),
                               rtol=1e-12, atol=1e-12)
    # the same layer with the source's alpha reads h0
    mixed = SparseGCNIIConv(D, 0.1, 1.0, dtype=torch.float64)
    mixed.lin.weight = conv.lin.weight
    assert not torch.allclose(mixed(g, x, h0), conv(g, x, h0))


def test_the_cli_runs_end_to_end():
    argv = ["--dataset", "karate", "--model_type", "sparsegcnii",
            "--n_steps", "5", "--num_layers", "4", "--hidden_channels",
            "16", "--n_mc_samples", "4"]
    out = SE.main(argv, device="cpu")
    for side in ("map", "laplace"):
        assert 0.0 <= out[side]["acc"] <= 1.0
        assert np.isfinite(out[side]["nll"])
    with pytest.raises(ValueError, match="sparsegcnii"):
        SE.main(argv + ["--subset_of_weights", "all"], device="cpu")
    # the library's Kron posterior over every weight is the mixed one: the
    # convs are no KFAC sites, so their weights take diagonal blocks
    from laplace_gnn_torch.laplace.dispatch import Laplace
    model, params, _, _, y = _model(False)
    assert [s["name"] for s in model.tap_sites()] == [
        "convs.0", f"convs.{LAYERS + 1}"]
    idx = torch.arange(0, N, 3)
    la = Laplace(model, params, "classification", subset_of_weights="all",
                 hessian_structure="kron")
    la.fit([(idx, y[idx])])
    assert la.n_params == sum(v.numel() for v in params.values())


def _within(e, spans) -> bool:
    return any(s.thread == e.thread
               and s.time_range.start <= e.time_range.start
               and e.time_range.end <= s.time_range.end for s in spans)


def test_the_convs_spans_and_counter():
    model, params, _, _, y = _model(False)
    p = {k: v.requires_grad_(True) for k, v in params.items()}
    opt = DeviceAdam(model.param_groups(p), lr=1e-2)
    idx = torch.arange(0, N, 2)
    profiling.reset_counters()
    SE.train_steps(model, p, opt, idx, y[idx], 1)
    assert profiling.counters() == {}        # no profiler, no counts
    with torch.profiler.profile() as prof:
        SE.train_steps(model, p, opt, idx, y[idx], 1)
    got = profiling.counters()
    assert got["gcnii.calls"] == LAYERS
    assert got["spmm.calls"] == 2 * LAYERS   # forward and transposed
    by = {}
    for e in prof.events():
        by.setdefault(e.name, []).append(e)
    fwd, back = by["lgnn.gcnii.conv"], by["lgnn.gcnii.conv.backward"]
    assert len(fwd) == len(back) == LAYERS
    spmm = by["lgnn.spmm"]
    assert sum(_within(e, fwd) for e in spmm) == LAYERS
    assert sum(_within(e, back) for e in spmm) == LAYERS
    # the Linears' products lie outside both spans: the input Linear's
    # and the output Linear's, forward and backward
    mms = [e for e in by.get("aten::addmm", []) + by.get("aten::mm", [])]
    assert any(not _within(e, fwd + back) for e in mms)


def _old_step(opt):
    """DeviceAdam's flat update as it was before the group form."""
    with torch.no_grad():
        beta1, beta2 = opt.betas
        opt.step_count += 1
        neg_step_size = -(opt.lr / (1 - beta1 ** opt.step_count))
        bias_correction2_sqrt = (1 - beta2 ** opt.step_count) ** 0.5
        for p, m, v in zip(opt.params, opt.exp_avg, opt.exp_avg_sq):
            g = p.grad
            if opt.weight_decay != 0:
                g = g.add(p, alpha=opt.weight_decay)
            m.lerp_(g, 1 - beta1)
            v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
            denom = (v.sqrt() / bias_correction2_sqrt).add_(opt.eps)
            p.add_(neg_step_size * m / denom)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_device_adam_flat_form_is_bit_and_op_equal_to_before(wd):
    gen = torch.Generator().manual_seed(2)
    shapes = [(4, 3), (3,), (7, 4)]
    sides = []
    for _ in range(2):
        ps = [torch.randn(s, generator=torch.Generator().manual_seed(i))
              .requires_grad_(True) for i, s in enumerate(shapes)]
        sides.append((ps, DeviceAdam(ps, lr=1e-2, weight_decay=wd)))
    assert sides[0][1].decays == [wd] * len(shapes)
    for _ in range(4):
        grads = [torch.randn(s, generator=gen) for s in shapes]
        logs = []
        for (ps, opt), step in zip(sides, (_old_step, DeviceAdam.step)):
            for q, g in zip(ps, grads):
                q.grad = g.clone()
            with _Ops() as mode:
                step(opt)
            logs.append(mode.ops)
        assert logs[0] == logs[1]
        for a, b in zip(sides[0][0], sides[1][0]):
            assert torch.equal(a, b)


def test_device_adam_groups_are_torch_adams_groups():
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (3,), (2, 5), (4,)]
    ps = [torch.tensor(rng.standard_normal(s)) for s in shapes]
    a = [p.clone().requires_grad_(True) for p in ps]
    b = [p.clone().requires_grad_(True) for p in ps]
    ref = torch.optim.Adam([{"params": a[:2], "weight_decay": 0.01},
                            {"params": a[2:], "weight_decay": 5e-4}],
                           lr=1e-2)
    dev = DeviceAdam([{"params": b[:2], "weight_decay": 0.01},
                      {"params": b[2:], "weight_decay": 5e-4}], lr=1e-2)
    assert dev.decays == [0.01, 0.01, 5e-4, 5e-4]
    for _ in range(20):
        for x, y in zip(a, b):
            g = torch.tensor(rng.standard_normal(tuple(x.shape)))
            x.grad, y.grad = g, g.clone()
        ref.step()
        dev.step()
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.detach().numpy(),
                                       x.detach().numpy(), rtol=1e-13,
                                       atol=1e-15)
    # a group without its own decay takes the optimizer's
    c = DeviceAdam([{"params": b[:1]}], lr=1e-2, weight_decay=0.5)
    assert c.decays == [0.5]
    with pytest.raises(ValueError, match="lr"):
        DeviceAdam([{"params": b, "lr": 0.1}], lr=1e-2)
