"""The sparse graph's SpMM kernel (``ops/spmm_kernel.py``,
``csrc/spmm.cu``) and its route in ``SparseGraph.spmm``. On the CPU: the
dst-sorted CSR layout (row offsets, hub rows split into chunks, the work
items and merges) on graphs with empty rows, a hub of more than CHUNK
edges and self-loops; the plain route for CPU tensors, with no
``spmm.kernel`` counted; the ``ValueError`` for mixed devices; and, with
the route forced to the kernel and the kernel's wrapper replaced by the
plain arithmetic, that ``vmap``, ``jvp``, ``grad`` and ``vjp`` through
``FastAggGraph`` reach the kernel's wrapper with plain tensors, once a
call. The kernel itself runs only on the card (marked ``cuda``; this file
imports no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_spmm_kernel.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from laplace_gnn_torch import profiling
from laplace_gnn_torch.graph import container as TC
from laplace_gnn_torch.ops import spmm_kernel as SK


def _graph(kind: str = "hub", n: int = 200, seed: int = 0,
           device: str = "cpu", agg=None, normalize="sym"):
    """A float64 graph: ``hub`` (random edges, node 2 receiving an edge
    from every node: more than CHUNK, a self-loop on every node),
    ``empty`` (as ``hub`` without self-loops and with nodes 7 and 11
    left with no edge at all), ``self_loop`` (node 7 has its self-loop
    and no other edge), ``directed`` (``empty`` plus edges one way only,
    so the graph is not symmetric)."""
    rng = np.random.default_rng(seed)
    src = [rng.integers(0, n, 4 * n), np.arange(n)]
    dst = [rng.integers(0, n, 4 * n), np.full(n, 2)]
    src, dst = np.concatenate(src), np.concatenate(dst)
    if kind != "directed":          # both ways: a symmetric graph
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    else:
        src = np.concatenate([src, np.arange(20, 60)])
        dst = np.concatenate([dst, np.full(40, 13)])
    if kind in ("empty", "directed"):
        keep = ~np.isin(src, (7, 11)) & ~np.isin(dst, (7, 11)) & (src != dst)
    elif kind == "self_loop":
        keep = (src != 7) & (dst != 7)
    else:
        keep = np.ones(len(src), bool)
    g = TC.sparse_from_edge_index(
        np.stack([src[keep], dst[keep]]), n, normalize=normalize,
        add_self_loops=kind in ("hub", "self_loop"), dtype=torch.float64,
        device=device)
    return dataclasses.replace(g, agg_dtype=agg) if agg else g


KINDS = ["hub", "empty", "self_loop", "directed"]


def _dense(g) -> torch.Tensor:
    return g.to_dense().double()


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# -- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_the_layout_holds_the_dst_sorted_csr(kind):
    """``indptr`` counts each row's edges; ``src`` and the weights are the
    graph's dst-sorted edges, the weights in their own dtype first and in
    the aggregation dtype."""
    g = _graph(kind, agg="bfloat16")
    csr = g.csr()
    assert csr is g.csr()                        # formed once
    assert csr.indptr.dtype == torch.int32 and csr.src.dtype == torch.int32
    counts = torch.bincount(g.dst, minlength=g.n_nodes)
    assert torch.equal(csr.indptr.long(), torch.cat(
        [torch.zeros(1, dtype=torch.long), torch.cumsum(counts, 0)]))
    assert torch.equal(csr.src.long(), g.src)
    assert list(csr.weights) == [torch.float64, torch.bfloat16]
    assert torch.equal(csr.weights[torch.float64], g.weights)
    assert torch.equal(csr.weights[torch.bfloat16],
                       g.weights.to(torch.bfloat16))
    assert csr.n_edges == g.n_edges and csr.n_nodes == g.n_nodes
    if kind in ("empty", "directed"):
        assert int(counts[7]) == 0 and int(counts[11]) == 0
    if kind == "self_loop":
        assert int(counts[7]) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_the_work_items_cover_every_row_once_in_order(kind):
    """Each row's items walk its edges in order, at most CHUNK each; an
    empty row is one empty item; the hub's row is split into chunks whose
    workspace slots run on in order and are merged once."""
    g = _graph(kind)
    csr = g.csr()
    indptr = csr.indptr.long()
    row, beg, end, slot = csr.work.items.long().T
    assert torch.equal(torch.unique_consecutive(row), torch.arange(g.n_nodes))
    assert bool((end - beg <= SK.CHUNK).all())
    for r in range(g.n_nodes):
        mine = row == r
        spans = torch.stack([beg[mine], end[mine]], 1)
        assert int(spans[0, 0]) == int(indptr[r])
        assert int(spans[-1, 1]) == int(indptr[r + 1])
        assert torch.equal(spans[1:, 0], spans[:-1, 1])
        assert bool((slot[mine] == -1).all()) == (int(mine.sum()) == 1)
    split = slot >= 0
    assert torch.equal(slot[split], torch.arange(csr.work.n_slots))
    m_row, first, chunks, _ = csr.work.merges.long().T
    assert torch.equal(m_row, torch.unique(row[split]))
    assert torch.equal(chunks, torch.bincount(row[split])[m_row])
    assert torch.equal(first, torch.cumsum(chunks, 0) - chunks)
    degree = indptr[1:] - indptr[:-1]
    assert 2 in m_row.tolist()                      # the hub is split
    assert int(chunks[m_row == 2]) == -(-int(degree[2]) // SK.CHUNK)
    if kind in ("empty", "directed"):
        for r in (7, 11):
            assert int(beg[row == r]) == int(end[row == r])


def test_an_unsorted_graph_is_sorted_for_the_layout():
    """``spmm_csr`` of edges out of dst order sorts them stably first."""
    g = _graph("hub")
    perm = torch.randperm(g.n_edges, generator=torch.Generator()
                          .manual_seed(0))
    csr = SK.spmm_csr(g.src[perm], g.dst[perm], g.weights[perm], g.n_nodes,
                      dst_sorted=False)
    order = torch.argsort(g.dst[perm], stable=True)
    assert torch.equal(csr.src.long(), g.src[perm][order])
    assert torch.equal(csr.weights[torch.float64], g.weights[perm][order])
    assert torch.equal(csr.indptr, g.csr().indptr)


def test_the_layout_refuses_to_form_under_a_transform():
    g = _graph("hub")
    g._plans.pop("csr", None)

    def inside(x):
        g.csr()
        return x
    with pytest.raises(RuntimeError, match="outside torch.func"):
        torch.func.vmap(inside)(torch.zeros(2, 3))


@pytest.mark.parametrize("d, dtype, padded", [
    (1, torch.float32, 4), (3, torch.float64, 4), (40, torch.bfloat16, 40),
    (41, torch.bfloat16, 48), (256, torch.bfloat16, 256),
    (1200, torch.float32, 1200)])
def test_the_operand_is_padded_to_whole_vectors(d, dtype, padded):
    x = torch.randn(5, d, dtype=torch.float64)
    xo = SK.operand(x, dtype)
    assert xo.shape == (5, padded) and xo.dtype == dtype
    assert xo.is_contiguous() and xo.data_ptr() % 16 == 0
    assert torch.equal(xo[:, :d], x.to(dtype))
    assert not bool(xo[:, d:].any())
    view = SK.operand(torch.randn(6, 8)[1:], torch.float32)  # offset view
    assert view.data_ptr() % 16 == 0


@pytest.mark.parametrize("nvec, lanes", [(1, 1), (2, 2), (3, 4), (5, 8),
                                         (10, 16), (16, 16), (32, 16),
                                         (150, 16)])
def test_the_lanes_cover_the_row_up_to_256_bytes(nvec, lanes):
    assert SK.lanes_for(nvec) == lanes


# -- the route -----------------------------------------------------------------

def _counted(fn):
    profiling.reset_counters()
    with torch.profiler.profile():
        out = fn()
    counts = {k: v for k, v in profiling.counters().items()
              if k in ("spmm.calls", "spmm.kernel")}
    return out, counts


@pytest.mark.parametrize("agg", [None, "bfloat16"])
def test_cpu_tensors_take_the_plain_route_and_count_no_kernel(agg,
                                                              monkeypatch):
    g = _graph("hub", agg=agg)
    x = torch.randn(g.n_nodes, 6, dtype=torch.float64)
    launched = []
    monkeypatch.setattr(SK, "spmm", lambda *a: launched.append(a))
    out, counts = _counted(lambda: g.spmm(x))
    assert counts == {"spmm.calls": 1} and not launched
    want = (g._aggregate(x.to(torch.bfloat16)).double() if agg
            else g._aggregate(x))
    assert torch.equal(out, want)
    assert _rel(out, _dense(g) @ x) < (1e-2 if agg else 1e-12)


def test_mixed_devices_raise():
    """A CPU graph with a tensor elsewhere raises the kernels' device
    rule, on the graph and through ``FastAggGraph``."""
    g = _graph("hub")
    x = torch.empty(g.n_nodes, 4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        g.spmm(x)
    with pytest.raises(ValueError, match="one CUDA device"):
        TC.FastAggGraph(g).spmm(x)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    g = _graph("hub")
    x = torch.randn(g.n_nodes, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        SK.spmm(g.csr(), x)


@pytest.mark.parametrize("how", ["call", "vmap", "jvp", "grad", "vjp"])
def test_the_route_reaches_the_kernel_under_transforms(how, monkeypatch):
    """With the route forced to the kernel and the kernel's wrapper
    replaced by the plain aggregation, each ``torch.func`` transform
    through ``FastAggGraph`` hands the wrapper plain tensors (the vmapped
    batch folded into the columns), once a call: ``spmm.kernel`` ==
    ``spmm.calls``; the results are the dense product's."""
    g = _graph("directed", normalize=None)
    fast = TC.FastAggGraph(g)
    g.csr(), fast.graph_t.csr()         # formed outside the transforms
    dense = _dense(g)
    seen = []

    def fake(csr, x, agg):
        seen.append((csr, tuple(x.shape),
                     torch._C._functorch.is_functorch_wrapped_tensor(x)))
        graph = g if csr is g.csr() else fast.graph_t
        return graph._aggregate(x)
    monkeypatch.setattr(TC, "route", lambda name, *t: "kernel")
    monkeypatch.setattr(SK, "spmm", fake)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(g.n_nodes, 5, dtype=torch.float64, generator=gen)
    t = torch.randn(g.n_nodes, 5, dtype=torch.float64, generator=gen)
    if how == "call":
        out, counts = _counted(lambda: fast.spmm(x))
        assert _rel(out, dense @ x) < 1e-12
    elif how == "vmap":
        xs = torch.stack([x, 2 * x, t])
        out, counts = _counted(lambda: torch.func.vmap(fast.spmm)(xs))
        assert _rel(out, dense @ xs) < 1e-12
        assert [s for _, s, _ in seen] == [(g.n_nodes, 15)]
    elif how == "jvp":
        out, counts = _counted(lambda: torch.func.jvp(fast.spmm, (x,),
                                                      (t,)))
        assert _rel(out[0], dense @ x) < 1e-12
        assert _rel(out[1], dense @ t) < 1e-12
    elif how == "grad":
        out, counts = _counted(lambda: torch.func.grad(
            lambda z: (fast.spmm(z) * t).sum())(x))
        assert _rel(out, dense.T @ t) < 1e-12
    else:
        out, counts = _counted(lambda: torch.func.vjp(fast.spmm, x)[1](t))
        assert _rel(out[0], dense.T @ t) < 1e-12
    assert counts["spmm.kernel"] == counts["spmm.calls"] == len(seen)
    assert len(seen) == {"call": 1, "vmap": 1, "jvp": 2, "grad": 2,
                         "vjp": 2}[how]
    assert not any(wrapped for _, _, wrapped in seen)
    if how in ("grad", "vjp"):          # the backward runs A^T's layout
        assert seen[-1][0] is fast.graph_t.csr() is not g.csr()


@pytest.mark.parametrize("kind", ["hub", "directed"])
def test_a_direct_call_that_needs_a_gradient_gets_one(kind, monkeypatch):
    """On the kernel's route (forced here; the wrapper replaced by the
    plain aggregation without autograd) a direct ``SparseGraph.spmm`` of a
    tensor that needs a gradient goes through ``FastAggGraph``'s
    Function: its backward is the SpMM of A^T, counted once a call."""
    g = _graph(kind, normalize=None)
    g.csr()

    def fake(csr, x, agg):
        graph = g if csr is g.csr() else g._plans["fast"].graph_t
        with torch.no_grad():
            return graph._aggregate(x)
    monkeypatch.setattr(TC, "route", lambda name, *t: "kernel")
    monkeypatch.setattr(SK, "spmm", fake)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(g.n_nodes, 4, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    t = torch.randn(g.n_nodes, 4, dtype=torch.float64, generator=gen)
    (out, gx), counts = _counted(lambda: (lambda o: (o, torch.autograd.grad(
        o, x, t)[0]))(g.spmm(x)))
    dense = _dense(g)
    assert _rel(out, dense @ x) < 1e-12 and _rel(gx, dense.T @ t) < 1e-12
    assert counts == {"spmm.calls": 2, "spmm.kernel": 2}
    assert (g._plans["fast"].graph_t is g) == (kind == "hub")


def test_the_kernel_sums_without_atomics():
    """The kernel sums each row in a fixed order (a lane's edges in order,
    a fixed butterfly, the chunks of a split row in order), so two calls
    give the same bits: the source calls no atomic operation."""
    import re
    from pathlib import Path
    src = (Path(SK.__file__).parent.parent / "csrc" / "spmm.cu").read_text()
    assert not re.search(r"atomic\w*\s*\(", src)


def test_the_route_counts_nothing_outside_a_trace():
    g = _graph("hub")
    profiling.reset_counters()
    g.spmm(torch.randn(g.n_nodes, 3, dtype=torch.float64))
    assert "spmm.calls" not in profiling.counters()


# -- the kernel (on the card) --------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


# (operand dtype, tolerance against the float64 product of the rounded
# operands: the kernel sums in f32, f64 for f64)
OPERANDS = [("bfloat16", 2e-6), ("float32", 2e-6), ("float64", 1e-13)]
WIDTHS = [1, 40, 128, 256, 1200]       # 1200: 40 classes x 30 samples


def _rounded(g, x, op):
    """The float64 product of the operands the kernel reads: ``x`` and
    the weights rounded to ``op``."""
    w = g.weights.to(op).double()
    return TC.SparseGraph(src=g.src, dst=g.dst, weights=w, n_nodes=g.n_nodes,
                          dst_sorted=True)._aggregate(x.to(op).double())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hub", "empty"])
@pytest.mark.parametrize("op, tol", OPERANDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_the_kernel_matches_the_plain_version(kind, op, tol, d):
    _card()
    agg = op if op != "float64" else None
    g = _graph(kind, agg=agg)
    gc = _graph(kind, agg=agg, device="cuda")
    x = torch.randn(g.n_nodes, d, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(d))
    xin = x if op == "float64" else x.float()
    out = gc.spmm(xin.cuda())
    assert out.dtype == xin.dtype and out.shape == (g.n_nodes, d)
    assert _rel(out, _rounded(g, xin, getattr(torch, op))) < tol
    # the plain route rounds the sums to the aggregation dtype
    plain = g.spmm(xin)
    assert _rel(out, plain) < (1e-2 if agg else 1e-13)


@pytest.mark.cuda
def test_a_direct_call_on_the_card_carries_its_gradient():
    _card()
    g = _graph("directed", normalize=None, device="cuda")
    x = torch.randn(g.n_nodes, 40, dtype=torch.float64, device="cuda",
                    requires_grad=True)
    t = torch.randn_like(x)
    (gx,) = torch.autograd.grad(g.spmm(x), x, t)
    assert _rel(gx, g.to_dense().T @ t) < 1e-13


@pytest.mark.cuda
def test_two_calls_give_the_same_bits():
    _card()
    g = _graph("hub", n=300, agg="bfloat16", device="cuda")
    x = torch.randn(g.n_nodes, 256, device="cuda")
    assert torch.equal(g.spmm(x), g.spmm(x))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hub", "directed"])
def test_the_backward_through_fastagg(kind):
    """``FastAggGraph``'s backward is the kernel over A^T (the graph itself
    when it is symmetric), in float64 to the dense product; the forward
    and backward each launch once."""
    _card()
    g = _graph(kind, normalize="sym" if kind == "hub" else None,
               device="cuda")
    fast = TC.FastAggGraph(g)
    assert (fast.graph_t is g) == (kind == "hub")
    dense = g.to_dense()
    x = torch.randn(g.n_nodes, 40, dtype=torch.float64, device="cuda",
                    requires_grad=True)
    t = torch.randn_like(x)
    n0 = SK.spmm_launch.launches
    out = fast.spmm(x)
    (gx,) = torch.autograd.grad(out, x, t)
    assert SK.spmm_launch.launches - n0 == 2
    assert _rel(out, dense @ x) < 1e-13
    assert _rel(gx, dense.T @ t) < 1e-13


@pytest.mark.cuda
def test_one_launch_a_call_and_the_counter():
    _card()
    g = _graph("hub", agg="bfloat16", device="cuda")
    x = torch.randn(g.n_nodes, 40, device="cuda")
    n0 = SK.spmm_launch.launches
    _, counts = _counted(lambda: [g.spmm(x) for _ in range(3)])
    assert SK.spmm_launch.launches - n0 == 3
    assert counts == {"spmm.calls": 3, "spmm.kernel": 3}
