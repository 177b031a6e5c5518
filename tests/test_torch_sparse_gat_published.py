"""The published multi-head GAT (3 layers, BatchNorm and residual Linears
in the hidden layers, the output layer's heads averaged) through
``SparseGAT`` and the sparse CLI's ``build_model``, held to the
benchmark's plain reference (``benchmark/references/sparse_gat.py``,
float64 torch written from the paper's equations, loaded by path) on the
CPU in float64, on a ~300-node graph with hubs, on both attention paths: the segment path
(per-edge softmax over the dst-sorted edges) and the ELL path (levels and
a remainder).

Tolerances: the segment path runs in float64 throughout, so it agrees
with the reference to summation order (1e-10 relative on the logits and
on every gradient; 1e-9 on the weights after Adam, whose normalized
update divides by the square root of the second moment). The ELL path
computes the scores, exponentials and softmax denominators in float32 by
design (as the JAX package), so it agrees to float32 rounding: 1e-6 on
the logits and 1e-5 on the gradients, as
``test_torch_sparse_models.py::test_sparse_gat_ell_matches_segment_path``
holds it to the segment path; after three Adam steps, which move the
weights by ~3e-2, they agree to 1e-6 absolute (the update is lr = 1e-2
times a ratio of moments of gradients that carry that rounding, and an
entry whose gradient is near nought moves by a ratio that the rounding
shifts most: 1.0e-7 read on this graph).

Also: the output layer averages its heads and takes its bias after the
mean; 40 classes over 3 heads build with the option and are refused
without it; the default ``SparseGAT`` is the same model, bit for bit,
with the option off; ``build_model``'s keyword arguments reach the model;
the CLI's flags are still the JAX CLI's, but for one more model type."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from laplace_gnn_tpu.training import sparse_experiment as JS
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.graph import container as TC
from laplace_gnn_torch.training import sparse_experiment as SE
from laplace_gnn_torch.training.marglik_gnn import DeviceAdam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
N, D, HEADS, WIDTH, C = 300, 10, 3, 4, 5
CFG = dict(num_layers=3, heads=HEADS, negative_slope=0.2, lr=1e-2,
           norm="batch", res=True, output_heads="mean")
OPTIONS = dict(norm="batch", res=True, mean_output_heads=True)


def _reference():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)            # the reference's benchlib
    spec = importlib.util.spec_from_file_location(
        "bench_references_sparse_gat",
        os.path.join(BENCH, "references", "sparse_gat.py"))
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


def _model(ell: bool, seed=3, **options):
    ei, x, y = _graph_data(seed)
    g = TC.sparse_from_edge_index(ei, N, normalize=None,
                                  dtype=torch.float64, device="cpu")
    if ell:
        g = TC.add_ell_format(g, max_k=4, pad_budget=1.2)
        assert g.ell_levels and g.has_remainder()
    model = TM.SparseGAT(D, HEADS * WIDTH, C, 3, x, g, heads=HEADS,
                         dropout_p=0.0, device="cpu", dtype=torch.float64,
                         **(OPTIONS if not options else options))
    # every leaf moved off its init, so biases and norms are not 0 / 1
    gen = torch.Generator().manual_seed(seed)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen,
                                       dtype=v.dtype)
              for k, v in model.init(gen).items()}
    return model, params, torch.as_tensor(ei), x, y


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


PATHS = [pytest.param(False, 1e-10, 1e-10, 1e-9, id="segment"),
         pytest.param(True, 1e-6, 1e-5, 1e-6, id="ell")]


@pytest.mark.parametrize("ell,tol_out,tol_grad,tol_w", PATHS)
def test_logits_and_every_gradient_match_the_reference(ell, tol_out,
                                                       tol_grad, tol_w):
    model, params, ei, x, y = _model(ell)
    assert set(params) == set(REF.weight_names(3))
    edges = REF.Edges(ei, N)
    rows = torch.arange(0, N, 2)
    got, want, grads = [], [], []
    for side in ("program", "reference"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        if side == "program":
            out = model.apply(p)
        else:
            out = REF.forward(p, x, edges, CFG, "float64", "float64",
                              torch.arange(N))
        loss = torch.nn.functional.cross_entropy(out[rows], y[rows])
        (got if side == "program" else want).append(out.detach())
        grads.append(dict(zip(p, torch.autograd.grad(loss,
                                                     list(p.values())))))
    assert _rel(got[0], want[0]) < tol_out
    norms = {k: float(torch.linalg.norm(v)) for k, v in grads[1].items()}
    median = float(np.median(list(norms.values())))
    for k in params:
        # a bias followed by BatchNorm has a gradient of nought to rounding
        if norms[k] < 1e-6 * median:
            assert float(torch.linalg.norm(grads[0][k])) < 1e-6 * median
            assert k.endswith("bias") and not k.startswith("convs.2")
        else:
            assert _rel(grads[0][k], grads[1][k]) < tol_grad, k


@pytest.mark.parametrize("ell,tol_out,tol_grad,tol_w", PATHS)
def test_three_adam_steps_match_the_reference(ell, tol_out, tol_grad,
                                              tol_w):
    model, params, ei, x, y = _model(ell)
    tr = torch.arange(1, N, 3)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = DeviceAdam(p.values(), lr=CFG["lr"])
    losses = []
    for _ in range(3):
        with torch.no_grad():
            losses.append(float(torch.nn.functional.cross_entropy(
                model.apply(p, tr), y[tr])))
        SE.train_steps(model, p, opt, tr, y[tr], 1)
    ref = REF.train_steps(x, ei, y, tr, params, CFG, 3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=tol_grad)
    moved = 0.0
    for k, v in ref["params"].items():
        np.testing.assert_allclose(p[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=tol_w, err_msg=k)
        moved = max(moved, float((v - params[k]).abs().max()))
    assert moved > 1e-2                  # the steps moved the weights


def test_the_output_layer_averages_its_heads():
    model, params, _, x, _ = _model(False)
    last = model.convs[-1]
    assert (last.heads, last.out_channels, last.concat) == (HEADS, C, False)
    assert params["convs.2.bias"].shape == (C,)
    assert params["convs.2.lin.weight"].shape == (HEADS * C, HEADS * WIDTH)
    assert all(c.concat and c.out_channels == WIDTH
               for c in model.convs[:-1])
    # the same layer concatenating its heads: the mean of its blocks
    cat = TM.sparse_gnn.SparseGATConv(HEADS * WIDTH, C, HEADS, concat=True,
                                      name="convs.2", dtype=torch.float64)
    h = torch.randn(N, HEADS * WIDTH, dtype=torch.float64)
    leaves = {k[len("convs.2."):]: v for k, v in params.items()
              if k.startswith("convs.2.")}
    avg = torch.func.functional_call(last, leaves, (model.graph, h))
    blocks = torch.func.functional_call(
        cat, dict(leaves, bias=torch.zeros(HEADS * C, dtype=torch.float64)),
        (model.graph, h))
    torch.testing.assert_close(
        avg, blocks.reshape(N, HEADS, C).mean(1) + leaves["bias"],
        rtol=1e-12, atol=1e-12)


def test_forty_classes_over_three_heads_build_with_the_option():
    ei, x, _ = _graph_data()
    g = TC.sparse_from_edge_index(ei, N, normalize=None, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        TM.SparseGAT(D, 750, 40, 3, x, g, heads=3, device="cpu")
    model = TM.SparseGAT(D, 750, 40, 3, x, g, heads=3, device="cpu",
                         **OPTIONS)
    assert model.apply(model.params()).shape == (N, 40)
    assert model.params()["convs.2.lin.weight"].shape == (120, 750)


@pytest.mark.parametrize("ell", [False, True])
def test_the_default_is_unchanged_bit_for_bit(ell):
    ei, x, y = _graph_data()
    g = TC.sparse_from_edge_index(ei, N, normalize=None,
                                  dtype=torch.float64, device="cpu")
    if ell:
        g = TC.add_ell_format(g, max_k=4, pad_budget=1.2)
    outs = []
    for kw in ({}, {"mean_output_heads": False}):
        m = TM.SparseGAT(D, 8, 4, 2, x, g, heads=2, dropout_p=0.0,
                         device="cpu", dtype=torch.float64, **kw)
        p = {k: v.requires_grad_(True) for k, v in m.init().items()}
        out = m.apply(p)
        outs.append((p, out, torch.autograd.grad(out.square().sum(),
                                                 list(p.values()))))
    (p0, o0, g0), (p1, o1, g1) = outs
    assert list(p0) == list(p1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(o0, o1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert o0.shape == (N, 4) and p0["convs.1.bias"].shape == (4,)


def _cli(model_type="sparsegat", hidden=12):
    ei, x, _ = _graph_data()
    data = types.SimpleNamespace(edge_index=ei, num_nodes=N, num_features=D,
                                 num_classes=C, x=x.float())
    args = SE.argument_parser().parse_args(
        ["--model_type", model_type, "--hidden_channels", str(hidden),
         "--heads", str(HEADS), "--num_layers", "3"])
    return args, data, SE.build_graph(args, data, device="cpu")


def test_build_model_passes_its_keyword_arguments_to_the_model():
    args, data, g = _cli()
    with pytest.raises(ValueError, match="divisible"):
        SE.build_model(args, data, g, device="cpu")     # C over 3 heads
    plain = SE.build_model(args, data, g, device="cpu", out_channels=6)
    assert plain.norm is None and not plain.use_res
    assert plain.convs[-1].concat and plain.dropout_p == 0.0
    m = SE.build_model(args, data, g, device="cpu", dropout_p=0.25,
                       **OPTIONS)
    assert m.norm == "batch" and m.use_res and m.dropout_p == 0.25
    assert not m.convs[-1].concat and m.convs[-1].out_channels == C
    assert set(m.params()) == set(REF.weight_names(3))
    args, data, g = _cli("sparsegcn", 16)
    gcn = SE.build_model(args, data, g, device="cpu", norm="batch",
                         res=True)
    assert gcn.norm == "batch" and gcn.use_res
    with pytest.raises(TypeError):
        SE.build_model(args, data, g, device="cpu", mean_output_heads=True)


def test_the_cli_flags_are_still_the_jax_clis():
    """Every flag is the JAX CLI's, with one departure: ``model_type``'s
    choices are JAX's and ``sparsegcnii``."""
    def flags(parser):
        return {a.dest: (a.default, a.choices, a.type, a.required)
                for a in parser._actions if a.dest != "help"}
    port, jax_ = flags(SE.argument_parser()), flags(JS.argument_parser())
    default, choices, kind, required = jax_["model_type"]
    jax_["model_type"] = (default, tuple(choices) + ("sparsegcnii",), kind,
                          required)
    port["model_type"] = port["model_type"][:1] + (
        tuple(port["model_type"][1]),) + port["model_type"][2:]
    assert port == jax_
    assert not {"norm", "res", "mean_output_heads", "alpha", "lamda"} & \
        set(port)
