"""Port parity for the sparse graph container (graph/container.py) and the
C++ packer (native/): the port against the JAX package in float64 on the
CPU.

The packed arrays (edges, ELL tables, levels, remainder, edge slots) must
equal JAX's exactly; the SpMM on each tier agrees at 1e-12; the bf16
aggregation at bf16 tolerance. The SpMM Function's backward, double
backward, vmap and jvp are held to ``torch.func`` on the dense product.
The ELL GAT attention computes its scores and softmax in float32 in both
packages, so it agrees at float32 tolerance (1e-6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu.graph import container as JC
from laplace_gnn_tpu.graph import datasets as JD
from laplace_gnn_torch import native
from laplace_gnn_torch.graph import container as TC

ATOL = 1e-12


def _power_law():
    """120 nodes: a hub on every node, a mid-degree cluster, random edges
    (JAX's tests/test_sparse.py three-tier graph)."""
    rng = np.random.default_rng(0)
    n = 120
    src = np.concatenate([np.arange(1, n), rng.integers(0, n, 300),
                          np.tile(np.arange(40, 60), 3)])
    dst = np.concatenate([np.zeros(n - 1, int), rng.integers(0, n, 300),
                          np.repeat(np.arange(1, 4), 20)])
    return np.stack([src, dst]), n


def _karate():
    d = JD.load_data("karate", n_rand_splits=1)
    return np.asarray(d.edge_index), d.num_nodes


def _power_law_undirected():
    ei, n = _power_law()
    return np.concatenate([ei, ei[::-1]], axis=1), n


GRAPHS = {"karate": _karate, "power_law": _power_law,
          "power_law_undirected": _power_law_undirected}


def _pair(graph="power_law", normalize="sym", ell=None, **kw):
    """(JAX graph, port graph) from the same edges; ``ell`` None (segment),
    "auto" (budgeted K) or a max_k."""
    ei, n = GRAPHS[graph]()
    jg = JC.sparse_from_edge_index(ei, n, normalize=normalize, **kw)
    tg = TC.sparse_from_edge_index(ei, n, normalize=normalize,
                                   dtype=torch.float64, device="cpu", **kw)
    if ell == "auto":
        jg, tg = JC.add_ell_format(jg), TC.add_ell_format(tg)
    elif ell is not None:
        jg = JC.add_ell_format(jg, max_k=ell, pad_budget=1.2)
        tg = TC.add_ell_format(tg, max_k=ell, pad_budget=1.2)
    return jg, tg


def _eq(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def _x(n, d=9, seed=3):
    return np.random.default_rng(seed).standard_normal((n, d))


# --- building and packing -------------------------------------------------

@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("normalize", ["sym", "row", None])
@pytest.mark.parametrize("graph", ["karate", "power_law"])
def test_sparse_from_edge_index_matches_jax(graph, normalize, self_loops):
    jg, tg = _pair(graph, normalize, add_self_loops=self_loops)
    for name in ("src", "dst", "weights"):
        _eq(getattr(tg, name), getattr(jg, name))
    assert tg.symmetric == jg.symmetric
    assert tg.dst_sorted and tg.format == "segment"
    assert tg.weights.dtype == torch.float64 and tg.src.dtype == torch.int64


def test_unknown_normalization_raises_in_both():
    ei, n = _power_law()
    with pytest.raises(ValueError, match="Unknown normalization"):
        JC.sparse_from_edge_index(ei, n, normalize="nope")
    with pytest.raises(ValueError, match="Unknown normalization"):
        TC.sparse_from_edge_index(ei, n, normalize="nope", device="cpu")


@pytest.mark.parametrize("ell", ["auto", 2, 5])
@pytest.mark.parametrize("graph", ["karate", "power_law"])
def test_add_ell_format_matches_jax(graph, ell):
    jg, tg = _pair(graph, "sym", ell=ell)
    for name in ("ell_cols", "ell_vals", "rem_src", "rem_dst", "rem_w"):
        _eq(getattr(tg, name), getattr(jg, name))
    assert len(tg.ell_levels) == len(jg.ell_levels)
    for tl, jl in zip(tg.ell_levels, jg.ell_levels):
        for t, j in zip(tl, jl):
            _eq(t, j)
    if graph == "power_law" and ell == 2:
        # every tier is populated, and every edge is in exactly one
        assert tg.ell_levels and tg.has_remainder()
        assert (int((tg.ell_vals != 0).sum())
                + sum(int((v != 0).sum()) for _, _, v in tg.ell_levels)
                + tg.rem_src.shape[0]) == tg.n_edges


# --- the SpMM -------------------------------------------------------------

@pytest.mark.parametrize("tier", ["segment", "ell", "three-tier"])
@pytest.mark.parametrize("normalize", ["sym", "row", None])
def test_spmm_matches_jax(tier, normalize):
    ell = {"segment": None, "ell": "auto", "three-tier": 2}[tier]
    jg, tg = _pair("power_law", normalize, ell=ell)
    x = _x(tg.n_nodes)
    want = np.asarray(jax.jit(jg.spmm)(jnp.asarray(x)))
    np.testing.assert_allclose(tg.spmm(torch.as_tensor(x)).numpy(), want,
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose((tg @ torch.as_tensor(x)).numpy(), want,
                               rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(
        TC.make_spmm(tg)(torch.as_tensor(x)).numpy(), want, rtol=ATOL,
        atol=ATOL)


@pytest.mark.parametrize("tier", ["segment", "three-tier"])
def test_bf16_agg_dtype_matches_jax(tier):
    """Gathered rows in bf16, the result cast back. The port sums a
    segment's bf16 items in float32 and JAX in bf16, so the hub's row
    (120 terms) differs by JAX's rounding: held at 1e-2 relative in norm
    (bf16's epsilon is 7.8e-3), and closer to the float32 result than
    JAX's."""
    jg, tg = _pair("power_law", "sym", ell=None if tier == "segment" else 2)
    jg = dataclasses.replace(jg, agg_dtype="bfloat16")
    tg = dataclasses.replace(tg, agg_dtype="bfloat16")
    x = _x(tg.n_nodes).astype(np.float32)
    got = tg.spmm(torch.as_tensor(x))
    assert got.dtype == torch.float32
    want = torch.as_tensor(np.asarray(jax.jit(jg.spmm)(jnp.asarray(x))))
    assert float((got - want).norm() / want.norm()) < 1e-2
    exact = dataclasses.replace(tg, agg_dtype=None).spmm(torch.as_tensor(x))
    assert (got - exact).norm() <= (want - exact).norm()


@pytest.mark.parametrize("tier", ["segment", "three-tier"])
@pytest.mark.parametrize("normalize", ["sym", "row"])
def test_spmm_function_rules_match_dense(normalize, tier):
    """The linear Function: backward (A^T; a symmetric graph reuses
    itself), double backward, vmap over either axis and jvp, against
    torch.func on the dense product."""
    _, tg = _pair("power_law_undirected", normalize,
                  ell=None if tier == "segment" else 2)
    fast = TC.FastAggGraph(tg)
    assert (fast.graph_t is tg) == (normalize == "sym") == tg.symmetric
    dense = tg.to_dense()
    rng = np.random.default_rng(7)
    n = tg.n_nodes
    x = torch.as_tensor(rng.standard_normal((n, 5)))
    ct = torch.as_tensor(rng.standard_normal((n, 5)))

    def ref(v):
        return dense @ v

    out, pull = torch.func.vjp(fast.spmm, x)
    want, want_pull = torch.func.vjp(ref, x)
    torch.testing.assert_close(out, want, rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(pull(ct)[0], want_pull(ct)[0], rtol=ATOL,
                               atol=ATOL)
    torch.testing.assert_close(torch.func.jvp(fast.spmm, (x,), (ct,))[1],
                               torch.func.jvp(ref, (x,), (ct,))[1],
                               rtol=ATOL, atol=ATOL)
    xb = torch.as_tensor(rng.standard_normal((3, n, 5)))
    torch.testing.assert_close(torch.func.vmap(fast.spmm)(xb), dense @ xb,
                               rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(
        torch.func.vmap(fast.spmm, in_dims=2, out_dims=2)(
            xb.permute(1, 2, 0)), (dense @ xb).permute(1, 2, 0),
        rtol=ATOL, atol=ATOL)
    # double backward: d/dct of |A^T ct|^2 = 2 A A^T ct
    ctg = ct.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(fast.spmm(xg), xg, ctg, create_graph=True)
    (gg,) = torch.autograd.grad(torch.sum(gx ** 2), ctg)
    torch.testing.assert_close(gg, 2 * dense @ (dense.T @ ct), rtol=ATOL,
                               atol=ATOL)
    # a vector input
    torch.testing.assert_close(fast.spmm(x[:, 0]), dense @ x[:, 0],
                               rtol=ATOL, atol=ATOL)
    # the backward through FastAggGraph matches JAX's custom transpose
    jg, _ = _pair("power_law_undirected", normalize,
                  ell=None if tier == "segment" else 2)
    jspmm = JC.make_spmm(jg)
    jgrad = jax.jit(lambda v, c: jax.vjp(jspmm, v)[1](c)[0])(
        jnp.asarray(x.numpy()), jnp.asarray(ct.numpy()))
    np.testing.assert_allclose(pull(ct)[0].numpy(), np.asarray(jgrad),
                               rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("is_sorted", [True, False])
def test_segment_sum_rules(is_sorted):
    """The segment sum against index_add, on sorted and unsorted indices,
    under grad, jvp and vmap (torch's segment_reduce has no forward-mode
    or batching rule)."""
    rng = np.random.default_rng(1)
    index = np.sort(rng.integers(0, 9, 40)) if is_sorted else \
        rng.integers(0, 9, 40)
    idx = torch.as_tensor(index)
    seg = TC.Segments.of(idx, 11, is_sorted)
    x = torch.as_tensor(rng.standard_normal((40, 3, 2)))

    def ref(v):
        return torch.zeros((11,) + v.shape[1:], dtype=v.dtype).index_add(
            0, idx, v)

    torch.testing.assert_close(TC.segment_sum(x, seg), ref(x), rtol=ATOL,
                               atol=ATOL)
    torch.testing.assert_close(seg.reduce(x, "max")[index[0]],
                               torch.amax(x[idx == index[0]], dim=0))
    assert torch.all(seg.reduce(x, "max")[9:] == -torch.inf)
    t = torch.randn_like(x)
    torch.testing.assert_close(
        torch.func.jvp(lambda v: TC.segment_sum(v, seg), (x,), (t,))[1],
        ref(t), rtol=ATOL, atol=ATOL)
    ct = torch.randn(11, 3, 2, dtype=torch.float64)
    torch.testing.assert_close(
        torch.func.vjp(lambda v: TC.segment_sum(v, seg), x)[1](ct)[0],
        torch.func.vjp(ref, x)[1](ct)[0], rtol=ATOL, atol=ATOL)
    xb = torch.randn(4, 40, 3, 2, dtype=torch.float64)
    torch.testing.assert_close(
        torch.func.vmap(lambda v: TC.segment_sum(v, seg), in_dims=1,
                        out_dims=1)(xb.transpose(0, 1)),
        torch.func.vmap(ref)(xb).transpose(0, 1), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("padded", [False, True])
def test_gather_is_the_transpose_of_segment_sum(padded):
    """The gather of a plan (pads read zeros) and its segment sum are each
    other's transposes, under grad, jvp and vmap; rows longer than
    SEGMENT_CHUNK are summed in two levels to the same values."""
    rng = np.random.default_rng(4)
    n, E = 12, 3 * TC.SEGMENT_CHUNK
    index = rng.integers(0, n, E)
    index[:2 * TC.SEGMENT_CHUNK + 5] = 3          # a row of two chunks+
    keep = rng.random(E) < 0.8 if padded else None
    if padded:
        index[~keep] = n
    seg = TC.Segments.of(torch.as_tensor(index), n,
                         keep=None if keep is None else torch.as_tensor(keep))
    assert seg.chunks is not None
    x = torch.as_tensor(rng.standard_normal((n, 2, 3)))
    ref_x = torch.cat([x, torch.zeros(1, 2, 3, dtype=x.dtype)]) if padded \
        else x
    want = ref_x[torch.as_tensor(index)]
    torch.testing.assert_close(TC.gather(x, seg), want, rtol=0, atol=0)
    ct = torch.as_tensor(rng.standard_normal((E, 2, 3)))
    if padded:
        ct_ref = torch.where(torch.as_tensor(keep)[:, None, None], ct, 0.0)
    else:
        ct_ref = ct
    summed = torch.zeros(n + 1, 2, 3, dtype=x.dtype).index_add(
        0, torch.as_tensor(index), ct_ref)[:n]
    torch.testing.assert_close(TC.segment_sum(ct, seg), summed, rtol=ATOL,
                               atol=ATOL)
    # transposes: <gather(x), ct> == <x, segment_sum(ct)>
    torch.testing.assert_close(torch.sum(TC.gather(x, seg) * ct_ref),
                               torch.sum(x * TC.segment_sum(ct, seg)),
                               rtol=ATOL, atol=ATOL)
    (gx,) = torch.func.vjp(lambda v: TC.gather(v, seg), x)[1](ct_ref)
    torch.testing.assert_close(gx, summed, rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(
        torch.func.jvp(lambda v: TC.gather(v, seg), (x,), (x,))[1], want,
        rtol=0, atol=0)
    xb = torch.as_tensor(rng.standard_normal((4, n, 2, 3)))
    torch.testing.assert_close(
        torch.func.vmap(lambda v: TC.gather(v, seg))(xb),
        torch.stack([TC.gather(v, seg) for v in xb]), rtol=0, atol=0)
    # the two-level sum equals the one-level one
    one = dataclasses.replace(seg, chunk_lengths=None, chunks=None)
    torch.testing.assert_close(one.reduce(ct, "sum"), seg.reduce(ct, "sum"),
                               rtol=ATOL, atol=ATOL)
    torch.testing.assert_close(one.reduce(ct, "max"), seg.reduce(ct, "max"),
                               rtol=0, atol=0)


def test_segment_plans_form_outside_transforms():
    _, tg = _pair("power_law", None)
    tg._plans.pop("src", None)
    with pytest.raises(RuntimeError, match="outside torch.func"):
        torch.func.grad(lambda v: torch.sum(TC.gather(v, tg.segments("src"))
                                            ))(torch.ones(tg.n_nodes))
    TC.gather(torch.ones(tg.n_nodes), tg.segments("src"))   # formed now


@pytest.mark.parametrize("ell", [None, 2])
def test_transpose_and_to_dense_match_jax(ell):
    jg, tg = _pair("power_law", "row", ell=ell)
    _eq(tg.to_dense(), jg.to_dense())
    jt, tt = jg.transpose(), tg.transpose()
    for name in ("src", "dst", "weights"):
        _eq(getattr(tt, name), getattr(jt, name))
    assert tt.format == jt.format
    if ell is not None:
        assert tt.ell_cols.shape == tuple(jt.ell_cols.shape)
        _eq(tt.ell_cols, jt.ell_cols)
        _eq(tt.rem_w, jt.rem_w)
    x = _x(tg.n_nodes)
    np.testing.assert_allclose(tt.spmm(torch.as_tensor(x)).numpy(),
                               tg.to_dense().T.numpy() @ x, rtol=ATOL,
                               atol=ATOL)


def test_to_dense_karate_is_the_adjacency_with_self_loops():
    d = JD.load_data("karate", n_rand_splits=1)
    tg = TC.sparse_from_edge_index(d.edge_index, d.num_nodes,
                                   normalize=None, device="cpu",
                                   dtype=torch.float64)
    want = d.adjacency(np.float64)
    np.fill_diagonal(want, 1.0)
    np.testing.assert_array_equal(tg.to_dense().numpy(), want)


# --- the C++ packer against numpy, in the port ---------------------------

def test_native_builds_here():
    assert native.available()
    assert native.library_path().parent.name == "_build"
    assert native.library_path().parent.parent.name == "laplace_gnn_torch"


@pytest.mark.parametrize("normalize", ["sym", "row"])
def test_native_equals_numpy(normalize, monkeypatch):
    ei, n = _power_law()
    g_nat = TC.add_ell_format(TC.sparse_from_edge_index(
        ei, n, normalize=normalize, device="cpu", dtype=torch.float64),
        max_k=2, pad_budget=1.2)
    t_nat = g_nat.transpose()
    monkeypatch.setattr(native, "available", lambda: False)
    g_np = TC.add_ell_format(TC.sparse_from_edge_index(
        ei, n, normalize=normalize, device="cpu", dtype=torch.float64),
        max_k=2, pad_budget=1.2)
    t_np = g_np.transpose()
    for a, b in ((g_nat, g_np), (t_nat, t_np)):
        for name in ("src", "dst", "weights", "ell_cols", "ell_vals",
                     "rem_src", "rem_dst", "rem_w"):
            torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                       rtol=0, atol=0)
        assert a.symmetric == b.symmetric
        for la, lb in zip(a.ell_levels, b.ell_levels):
            for u, v in zip(la, lb):
                torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_native_functions_equal_numpy():
    rng = np.random.default_rng(0)
    n = 300
    src = rng.integers(0, n, 3000).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n, 2800),
                          np.full(200, 7)]).astype(np.int32)
    w = rng.random(3000)
    so, do, wo, offs = native.sort_by_dst(src, dst, w, n)
    order = np.argsort(dst, kind="stable")
    for got, want in ((so, src[order]), (do, dst[order]), (wo, w[order])):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(offs, np.concatenate(
        [[0], np.cumsum(np.bincount(dst, minlength=n))]))
    deg = np.zeros(n)
    np.add.at(deg, dst, w)
    np.testing.assert_array_equal(native.degree(dst, w, n), deg)
    cols, vals, rs, rd, rw = native.ell_pack(so, wo, offs, 6)
    counts = np.bincount(dst, minlength=n)
    assert rs.shape[0] == int(np.maximum(counts - 6, 0).sum())
    np.testing.assert_array_equal(rd, np.sort(rd))
    pairs = np.unique(np.minimum(src, dst) * n + np.maximum(src, dst))
    a, b = (pairs // n).astype(np.int32), (pairs % n).astype(np.int32)
    wp = rng.random(len(pairs))
    assert native.check_symmetric(np.r_[a, b], np.r_[b, a], np.r_[wp, wp], n)
    assert not native.check_symmetric(np.r_[a, b], np.r_[b, a],
                                      np.r_[wp, wp + 1], n)


# --- the ELL GAT layout ---------------------------------------------------

def _skewed(n=60, seed=5):
    """A graph with four hubs, so a small-K ELL has levels and a
    remainder (JAX's tests/test_sparse_models.py skewed graph)."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for i in range(n):
        deg = n // 2 if i < 4 else 1 + rng.integers(0, 4)
        src.extend(rng.choice(n, size=deg, replace=False))
        dst.extend([i] * deg)
    return np.stack([np.array(src), np.array(dst)]), n


def _skewed_pair(normalize, seed=5):
    ei, n = _skewed(seed=seed)
    jg = JC.add_ell_format(JC.sparse_from_edge_index(ei, n,
                                                     normalize=normalize),
                           max_k=2)
    tg = TC.add_ell_format(TC.sparse_from_edge_index(
        ei, n, normalize=normalize, device="cpu", dtype=torch.float64),
        max_k=2)
    return jg, tg


def test_ell_edge_slots_match_jax():
    jg, tg = _skewed_pair("sym")
    js, ts = JC.ell_edge_slots(jg), TC.ell_edge_slots(tg)
    for name in ("ell0_edge_idx", "ell0_row", "ell0_pos", "rem_edge_idx"):
        _eq(getattr(ts, name), getattr(js, name))
    assert len(ts.levels) == len(js.levels) >= 1
    for tl, jl in zip(ts.levels, js.levels):
        for t, j in zip(tl, jl):
            _eq(t, j)
    # the slots put the packed weights back in place
    w = tg.weights
    vals0 = torch.zeros_like(tg.ell_vals)
    vals0[ts.ell0_row, ts.ell0_pos] = w[ts.ell0_edge_idx]
    torch.testing.assert_close(vals0, tg.ell_vals, rtol=0, atol=0)
    torch.testing.assert_close(w[ts.rem_edge_idx], tg.rem_w, rtol=0, atol=0)
    jl = JC.ell_gat_layout(jg)
    tl = TC.ell_gat_layout(tg)
    _eq(tl["mask0"], jl["mask0"])
    for t, j in zip(tl["level_masks"], jl["level_masks"]):
        _eq(t, j)
    with pytest.raises(ValueError, match="ELL"):
        TC.ell_edge_slots(_pair("power_law")[1])


def test_ell_aggregate_edge_coeff_matches_jax():
    jg, tg = _skewed_pair(None, seed=6)
    rng = np.random.default_rng(0)
    coeff = rng.standard_normal((tg.n_edges, 3))
    h = rng.standard_normal((tg.n_nodes, 3, 5))
    slots = JC.ell_edge_slots(jg)
    want = np.asarray(jax.jit(lambda c, v: JC.ell_aggregate_edge_coeff(
        jg, slots, c, v))(jnp.asarray(coeff), jnp.asarray(h)))
    got = TC.ell_aggregate_edge_coeff(tg, TC.ell_edge_slots(tg),
                                      torch.as_tensor(coeff),
                                      torch.as_tensor(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
    # and the plain per-edge segment sum
    msgs = torch.as_tensor(coeff)[:, :, None] * torch.as_tensor(h)[tg.src]
    torch.testing.assert_close(got, TC.segment_sum(msgs, tg.segments()),
                               rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("agg_dtype", [None, "bfloat16"])
def test_ell_gat_attention_matches_jax(agg_dtype):
    jg, tg = _skewed_pair(None, seed=7)
    jg = dataclasses.replace(jg, agg_dtype=agg_dtype)
    tg = dataclasses.replace(tg, agg_dtype=agg_dtype)
    rng = np.random.default_rng(2)
    n = tg.n_nodes
    h = rng.standard_normal((n, 2, 4))
    a_src, a_dst = rng.standard_normal((2, n, 2))
    layout = JC.ell_gat_layout(jg)
    want = np.asarray(jax.jit(lambda *a: JC.ell_gat_attention(
        jg, layout, *a, 0.2))(jnp.asarray(h), jnp.asarray(a_src),
                              jnp.asarray(a_dst)))
    got = TC.ell_gat_attention(tg, TC.ell_gat_layout(tg), torch.as_tensor(h),
                               torch.as_tensor(a_src),
                               torch.as_tensor(a_dst), 0.2)
    tol = 1e-6 if agg_dtype is None else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
