"""The sparse GAT attention's Function (``ops/gat_attention.py``) on the
CPU, where it runs the plain version of the kernels' CSR arithmetic:
held in float64 to autograd through the composed ELL body and to
``segment_attention``, forward and the hand-written backward for ``h``,
``a_src`` and ``a_dst``, on each graph layout; the work items the kernels
walk; the route of ``ell_gat_attention`` (the Function outside
``torch.func`` transforms, the composed body under ``vmap`` and ``jvp``,
counted as ``gat.kernel`` / ``gat.composed``); and the benchmark's fault
that patches ``sparse_gnn.ell_gat_attention`` by name. The kernels
themselves run only on the card (marked ``cuda``; this file imports no
JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_gat_attention_kernel.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from laplace_gnn_torch import profiling
from laplace_gnn_torch.graph import container as TC
from laplace_gnn_torch.models import SparseGAT
from laplace_gnn_torch.models import sparse_gnn as SG
from laplace_gnn_torch.ops import gat_attention as GA

SLOPE = 0.2
H, F = 3, 5


def _graph(kind: str, n: int = 90, seed: int = 0):
    """A float64 graph with a self-loop on every node, in the ELL form
    each layout names: ``levels`` (K 2: overflow levels and a remainder),
    ``hub`` (a destination and a source with more edges than a chunk),
    ``self_loop`` (node 7 has its self-loop and no other edge),
    ``bf16`` (as ``levels``, the payload in bfloat16)."""
    rng = np.random.default_rng(seed)
    src = [np.arange(1, 30), rng.integers(0, n, 200),
           np.tile(np.arange(40, 50), 3)]
    dst = [np.zeros(29, int), rng.integers(0, n, 200),
           np.repeat(np.arange(1, 4), 10)]
    if kind == "hub":
        src += [np.arange(n), np.full(n, 5)]
        dst += [np.full(n, 2), np.arange(n)]
        src += [np.arange(n)]
        dst += [np.full(n, 2)]
    src, dst = np.concatenate(src), np.concatenate(dst)
    if kind == "self_loop":
        keep = (src != 7) & (dst != 7)
        src, dst = src[keep], dst[keep]
    g = TC.sparse_from_edge_index(np.stack([src, dst]), n, normalize=None,
                                  dtype=torch.float64, device="cpu")
    g = TC.add_ell_format(g, max_k=2, pad_budget=1.2)
    if kind == "bf16":
        g = dataclasses.replace(g, agg_dtype="bfloat16")
    return g


LAYOUTS = ["levels", "hub", "self_loop", "bf16"]


def _inputs(n, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen, dtype=torch.float64)
            .requires_grad_(True) for shape in ((n, H, F), (n, H), (n, H))]


def _exact(g, h, a_src, a_dst):
    """``segment_attention`` in float64 on the payload the Function
    gathers (``h`` rounded to the graph's ``agg_dtype``)."""
    if g.agg_dtype is not None:
        h = h + (h.to(getattr(torch, g.agg_dtype)).double() - h).detach()
    return SG.segment_attention(dataclasses.replace(g, agg_dtype=None), h,
                                a_src, a_dst, SLOPE)


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_graph_has_its_layout(layout):
    g = _graph(layout)
    csr = TC.ell_gat_layout(g)["csr"]
    deg = torch.diff(csr.indptr.long())
    assert g.ell_levels and g.has_remainder()
    if layout == "hub":
        assert int(deg.max()) > GA.CHUNK and csr.fwd.merges.shape[0] >= 1
        assert csr.bwd.merges.shape[0] >= 1
    if layout == "self_loop":
        assert int(deg[7]) == 1 and int(csr.src[csr.indptr[7]]) == 7
        assert int((csr.src == 7).sum()) == 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_matches_the_composed_body_and_the_segment_path(layout):
    g = _graph(layout)
    layout_ = TC.ell_gat_layout(g)
    h, a_src, a_dst = _inputs(g.n_nodes)
    got = TC.ell_gat_attention(g, layout_, h, a_src, a_dst, SLOPE)
    assert "_GatAttention" in type(got.grad_fn).__name__
    assert got.dtype == torch.float64
    composed = TC._ell_gat_attention_composed(g, layout_, h, a_src, a_dst,
                                              SLOPE)
    if layout == "bf16":
        # f32 sums over the same bf16 rows; the composed body also rounds
        # the source scores and the products to bf16
        assert _rel(got, _exact(g, h, a_src, a_dst)) < 1e-6
        assert _rel(got, composed) < 2e-2
    else:
        # the composed body's scores and softmax run in float32
        assert _rel(got, _exact(g, h, a_src, a_dst)) < 1e-12
        assert _rel(got, composed) < 1e-6


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_backward_matches_autograd(layout):
    """The hand-written backward against autograd through the segment
    path and the composed body, for h, a_src and a_dst; in float64 also
    ``gradcheck`` in its fast mode: finite differences along a random
    projection of the Jacobian, which the comparison at 1e-12 already
    holds whole. The fast mode scales ``atol`` by the projection's sums,
    so it is held at rtol 1e-6 and atol 1e-9, where a 1e-4 error in one
    gradient fails it."""
    g = _graph(layout)
    layout_ = TC.ell_gat_layout(g)
    h, a_src, a_dst = _inputs(g.n_nodes)
    gout = torch.randn(g.n_nodes, H, F, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(TC.ell_gat_attention(
        g, layout_, h, a_src, a_dst, SLOPE), [h, a_src, a_dst], gout)
    want = torch.autograd.grad(_exact(g, h, a_src, a_dst),
                               [h, a_src, a_dst], gout)
    composed = torch.autograd.grad(TC._ell_gat_attention_composed(
        g, layout_, h, a_src, a_dst, SLOPE), [h, a_src, a_dst], gout)
    # bf16: the backward rounds dout to the payload dtype, as the composed
    # body carries the payload's gradient
    tol_exact, tol_composed = ((1e-2, 5e-2) if layout == "bf16"
                               else (1e-12, 1e-6))
    for a, b, c in zip(got, want, composed):
        assert _rel(a, b) < tol_exact
        assert _rel(a, c) < tol_composed
    if layout != "bf16":
        assert torch.autograd.gradcheck(
            lambda *x: TC.ell_gat_attention(g, layout_, *x, SLOPE),
            (h, a_src, a_dst), fast_mode=True, rtol=1e-6, atol=1e-9)


def test_the_work_items_cover_every_edge_once_in_order():
    """Each side's items walk every row's edges in order, a row of more
    than CHUNK edges split into chunks whose workspace slots run on in
    order and are listed once in the merges; the transposed CSR holds the
    same edges sorted by source."""
    g = _graph("hub", n=200)
    csr = TC.ell_gat_layout(g)["csr"]
    for work, indptr in ((csr.fwd, csr.indptr.long()), (csr.bwd, torch.cat(
            [torch.zeros(1, dtype=torch.long), torch.cumsum(torch.bincount(
                csr.src.long(), minlength=g.n_nodes), 0)]))):
        row, beg, end, slot = work.items.long().T
        assert torch.equal(torch.unique_consecutive(row),
                           torch.arange(g.n_nodes))
        assert bool((end - beg <= GA.CHUNK).all())
        for r in range(g.n_nodes):
            mine = row == r
            spans = torch.stack([beg[mine], end[mine]], 1)
            assert int(spans[0, 0]) == int(indptr[r])
            assert int(spans[-1, 1]) == int(indptr[r + 1])
            assert torch.equal(spans[1:, 0], spans[:-1, 1])
            assert bool((slot[mine] == -1).all()) == (int(mine.sum()) == 1)
        split = slot >= 0
        assert torch.equal(slot[split], torch.arange(work.n_slots))
        m_row, first, chunks, _ = work.merges.long().T
        assert torch.equal(m_row, torch.unique(row[split]))
        assert torch.equal(chunks, torch.bincount(row[split])[m_row])
        assert torch.equal(first, torch.cumsum(chunks, 0) - chunks)
    e = csr.t_eid.long()
    assert torch.equal(csr.dst[e], csr.t_dst)
    assert bool((torch.diff(csr.src[e]) >= 0).all())
    assert torch.equal(torch.sort(e).values, torch.arange(g.n_edges))


def test_two_calls_give_the_same_bits():
    g = _graph("hub")
    layout = TC.ell_gat_layout(g)
    outs = []
    for _ in range(2):
        h, a_src, a_dst = _inputs(g.n_nodes)
        out = TC.ell_gat_attention(g, layout, h, a_src, a_dst, SLOPE)
        outs.append((out,) + torch.autograd.grad(out.square().sum(),
                                                 [h, a_src, a_dst]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def _route_counts(fn):
    profiling.reset_counters()
    with torch.profiler.profile():
        fn()
    return {k: v for k, v in profiling.counters().items()
            if k in ("gat.kernel", "gat.composed")}


@pytest.mark.parametrize("how", ["call", "vmap", "jvp"])
def test_the_route_is_the_function_outside_transforms(how):
    """``ell_gat_attention`` runs the Function outside ``torch.func``
    transforms and the composed body under ``vmap`` and ``jvp``, each
    giving the attention within float32 rounding."""
    g = _graph("levels")
    layout = TC.ell_gat_layout(g)
    h, a_src, a_dst = (x.detach() for x in _inputs(g.n_nodes))

    def attend(hh, s, d):
        return TC.ell_gat_attention(g, layout, hh, s, d, SLOPE)
    want = _exact(g, h, a_src, a_dst)
    got = {}
    if how == "call":
        counts = _route_counts(lambda: got.setdefault(
            "out", attend(h, a_src, a_dst)))
        assert counts == {"gat.kernel": 1}
        assert _rel(got["out"], want) < 1e-12
    elif how == "vmap":
        hs = torch.stack([h, 2 * h])
        counts = _route_counts(lambda: got.setdefault(
            "out", torch.func.vmap(attend, (0, None, None))(
                hs, a_src, a_dst)))
        assert counts == {"gat.composed": 1}
        assert _rel(got["out"][1], 2 * want) < 1e-6
    else:
        dh = torch.randn_like(h)
        counts = _route_counts(lambda: got.setdefault(
            "out", torch.func.jvp(lambda hh: attend(hh, a_src, a_dst),
                                  (h,), (dh,))))
        assert counts == {"gat.composed": 1}
        out, tangent = got["out"]
        assert _rel(out, want) < 1e-6
        gs = dataclasses.replace(g, format="segment")
        gs.segments("src")              # plans outside the transform
        exact_t = torch.func.jvp(lambda hh: SG.segment_attention(
            gs, hh, a_src, a_dst, SLOPE), (h,), (dh,))[1]
        assert _rel(tangent, exact_t) < 1e-6


def test_the_kernel_wrapper_refuses_cpu_tensors():
    g = _graph("levels")
    csr = TC.ell_gat_layout(g)["csr"]
    h, a_src, a_dst = (x.detach() for x in _inputs(g.n_nodes))
    with pytest.raises(ValueError, match="CUDA"):
        GA.forward_kernel(csr, h, a_src, a_dst, SLOPE, torch.float64)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_uniform_attention_fault_still_reaches_the_model(layout,
                                                             monkeypatch):
    """The benchmark's fault ``attention_uniform`` replaces
    ``sparse_gnn.ell_gat_attention`` by name with a call of the original
    on zeroed scores: the model's output moves to that of zero attention
    vectors."""
    g = _graph(layout)
    x = np.random.default_rng(3).standard_normal((g.n_nodes, 6))
    model = SparseGAT(6, 8, 4, 2, x, g, heads=2, dropout_p=0.0,
                      device="cpu", dtype=torch.float64)
    params = model.init(torch.Generator().manual_seed(0))
    flat_params = {k: (torch.zeros_like(v) if "att_" in k else v)
                   for k, v in params.items()}
    plain, flat = model.apply(params), model.apply(flat_params)
    original = SG.ell_gat_attention

    def uniform(gg, layout_, hh, a_src, a_dst, slope):
        return original(gg, layout_, hh, a_src * 0, a_dst * 0, slope)
    monkeypatch.setattr(SG, "ell_gat_attention", uniform)
    faulty = model.apply(params)
    assert _rel(faulty, plain) > 1e-3
    torch.testing.assert_close(faulty, flat, rtol=1e-12, atol=1e-12)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.cuda
def test_the_kernel_wrapper_raises_on_what_it_does_not_take():
    _card()
    g = _graph("levels")
    csr = GA.attention_csr(g.src.cuda(), g.dst.cuda(), g.n_nodes)
    h, a_src, a_dst = (x.detach().cuda().float()
                       for x in _inputs(g.n_nodes))
    with pytest.raises(TypeError, match="payload"):
        GA.forward_kernel(csr, h, a_src, a_dst, SLOPE, torch.float16)
    wide = torch.zeros(g.n_nodes, 9, 4, device="cuda")
    with pytest.raises(ValueError, match="heads"):
        GA.forward_kernel(csr, wide, wide[..., 0], wide[..., 0], SLOPE,
                          torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        GA.forward_kernel(csr, h.cpu(), a_src, a_dst, SLOPE, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_kernels_match_the_plain_version(layout):
    _card()
    g = _graph(layout)
    csr_cpu = TC.ell_gat_layout(g)["csr"]
    csr = GA.attention_csr(g.src.cuda(), g.dst.cuda(), g.n_nodes)
    payload = torch.bfloat16 if layout == "bf16" else torch.float64
    h, a_src, a_dst = (x.detach() for x in _inputs(g.n_nodes))
    gout = torch.randn_like(h)
    cd = GA.sums_dtype(payload)
    want = GA.forward_plain(csr_cpu, h, a_src.to(cd), a_dst.to(cd), SLOPE,
                            payload)
    dev = [t.cuda() for t in (h, a_src.to(cd), a_dst.to(cd))]
    got = GA.forward_kernel(csr, *dev, SLOPE, payload)
    tol = 1e-5 if layout == "bf16" else 1e-12
    for a, b in zip(got[:2], want[:2]):
        assert _rel(a.cpu(), b) < tol
    grads = GA.backward_kernel(csr, got[2], dev[1], dev[2], got[0], got[1],
                               gout.cuda(), SLOPE)
    ref = GA.backward_plain(csr_cpu, want[2], a_src.to(cd), a_dst.to(cd),
                            want[0], want[1], gout, SLOPE)
    for a, b in zip(grads, ref):
        assert _rel(a.cpu(), b) < tol
