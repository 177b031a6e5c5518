"""Port parity for the fisher types of curvature/kfac.py: every fisher
type x model x kfac_approx, column_chunk, the vmapped pullback against a
column loop, d/d adj of the sketch and fork factors, and the port's own
random draws. Torch against JAX in float64 on the CPU; JAX's draws go into
the port through monkeypatch (JAX's PRNG cannot be reproduced)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import loop_kfac_factors
from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.curvature import kfac as JK
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.curvature import kfac as TK
from laplace_gnn_torch.ops import fused_spmm
from laplace_gnn_torch.utils.pytree import params_from_numpy

N, F, H, C = 40, 12, 8, 3
M = 20
OPTS = dict(mc_samples=2, sketch_size=4, seed=3)


def _t(x):
    return torch.as_tensor(np.array(x))


def use_jax_draws(monkeypatch):
    """The port's draws replaced by JAX's for the same (seed, ...)."""
    def sketch(seed, C_, k, dtype, device=None):
        return _t(JK._sketch_projection(seed, C_, k, jnp.float64)).to(dtype)

    def label(seed, m, likelihood, f):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), m)
        return _t(JK._draw_label(key, likelihood,
                                 jnp.asarray(f.detach().numpy())))

    def probes(seed, n, M_, K, dtype, device=None):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 104729)
        return _t(jax.random.rademacher(key, (n, M_, K)).astype(
            jnp.float64)).to(dtype)

    monkeypatch.setattr(TK, "_sketch_projection", sketch)
    monkeypatch.setattr(TK, "_draw_label", label)
    monkeypatch.setattr(TK, "_probe_signs", probes)


def _setup(cls="STEGCN", fused=True, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    adj = (rng.random((N, N)) < 0.1).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, C, N)
    jm = getattr(JM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=True)
    tm = getattr(TM, cls)(F, H, C, 2, X, adj, dropout_p=0.0, fused=fused,
                          symmetric=True, device="cpu", dtype=torch.float64)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    if cls == "STEGCN":
        jp["adj"] = np.where(rng.random((N, N)) < 0.15, 0.5,
                             jp["adj"] * 0.7 + 0.2)
    return jm, tm, jp, y


def _jfactors(jm, jp, y, **kw):
    return JK.compute_kfac_factors(
        jm, jax.tree_util.tree_map(jnp.asarray, jp), jnp.arange(M),
        jnp.asarray(y[:M]), "classification", N=M, **kw)


def _tfactors(tm, tp, y, **kw):
    return TK.compute_kfac_factors(tm, tp, torch.arange(M),
                                   torch.as_tensor(y[:M]), "classification",
                                   N=M, **kw)


def _assert_factors(tk, jk, rtol=1e-10):
    assert [len(g) for g in tk.kfacs] == [len(g) for g in jk.kfacs]
    for gt_, gj in zip(tk.kfacs, jk.kfacs):
        for a, b in zip(gt_, gj):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=rtol, atol=1e-12)


MODELS = [("GCN", True), ("STEGCN", True), ("STEGCN", False)]


@pytest.mark.parametrize("kfac_approx", ["expand", "reduce"])
@pytest.mark.parametrize("cls,fused", MODELS)
@pytest.mark.parametrize("fisher_type", TK.FISHER_TYPES)
def test_fisher_types_match_jax(fisher_type, cls, fused, kfac_approx,
                                monkeypatch):
    use_jax_draws(monkeypatch)
    jm, tm, jp, y = _setup(cls, fused)
    kw = dict(fisher_type=fisher_type, kfac_approx=kfac_approx, **OPTS)
    jk, jout = _jfactors(jm, jp, y, return_output=True, **kw)
    tk, tout = _tfactors(tm, params_from_numpy(jp, device="cpu"), y,
                         return_output=True, **kw)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-12)
    _assert_factors(tk, jk)
    # the options are JAX's, and an unknown one is refused as there
    assert TK.FISHER_TYPES == JK.FISHER_TYPES
    assert TK.KFAC_APPROX == JK.KFAC_APPROX
    with pytest.raises(ValueError, match="fisher_type"):
        _tfactors(tm, params_from_numpy(jp, device="cpu"), y,
                  fisher_type="nope")


@pytest.mark.parametrize("fisher_type", ["type-2", "type-2-sketch",
                                         "type-2-fork"])
@pytest.mark.parametrize("chunk", [1, 3])
def test_column_chunk_gives_the_same_factors(chunk, fisher_type,
                                             monkeypatch):
    """Blocks of ``chunk`` columns (3 does not divide the sketch's 4)
    sum to the unchunked factors, and match JAX's chunked map."""
    use_jax_draws(monkeypatch)
    jm, tm, jp, y = _setup("STEGCN", True, seed=1)
    tp = params_from_numpy(jp, device="cpu")
    kw = dict(fisher_type=fisher_type, **OPTS)
    whole = _tfactors(tm, tp, y, **kw)
    chunked = _tfactors(tm, tp, y, column_chunk=chunk, **kw)
    for ga, gb in zip(chunked.kfacs, whole.kfacs):
        for a, b in zip(ga, gb):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                       atol=1e-14)
    _assert_factors(chunked, _jfactors(jm, jp, y, column_chunk=chunk, **kw))


@pytest.mark.parametrize("cls,fused", MODELS)
def test_vmapped_pullback_equals_the_column_loop(cls, fused, monkeypatch):
    """One vjp with the C columns vmapped gives the B of the column loop
    it replaced (one ``torch.autograd.grad(create_graph=True)`` a column,
    kept in chip_smoke.py to count its launches on the card) and the same
    d/d adj; through the fused aggregation it calls the kernel 4 times
    whatever C is (2 forward, 2 pullback with the columns folded into the
    feature axis: C x C and C x H), where the loop calls it 2 + 2 C
    times."""
    _, tm, jp, y = _setup(cls, fused, seed=2)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    widths = []
    plain = fused_spmm.core_reference

    def counted(adj, t, *a, **k):
        widths.append(t.shape[1])
        return plain(adj, t, *a, **k)

    monkeypatch.setattr(fused_spmm, "core_reference", counted)
    with torch.no_grad():
        _tfactors(tm, {k: v.detach() for k, v in tp.items()}, y)
    if fused:
        assert sorted(widths) == sorted([H, C, C * C, C * H])
    widths.clear()
    lk = loop_kfac_factors(tm, tp, torch.arange(M), torch.as_tensor(y[:M]),
                           "classification", N=M)
    loop = {"convs.0": lk.kfacs[0][0], "convs.1": lk.kfacs[2][0]}
    if fused:     # GCN's loop also recomputes forwards for d/d adj
        assert len(widths) == 2 + 2 * C or (cls == "GCN"
                                            and len(widths) > 2 + 2 * C)
    tk = _tfactors(tm, tp, y)
    vm = {"convs.0": tk.kfacs[0][0], "convs.1": tk.kfacs[2][0]}
    w = {n: torch.as_tensor(np.random.default_rng(k).standard_normal(
        b.shape)) for k, (n, b) in enumerate(vm.items())}
    for n in vm:
        np.testing.assert_allclose(vm[n].detach().numpy(),
                                   loop[n].detach().numpy(), rtol=1e-12,
                                   atol=1e-15)
    g_vm = torch.autograd.grad(sum(torch.sum(vm[n] * w[n]) for n in vm),
                               [tp["adj"], tp["convs.0.lin.weight"]],
                               allow_unused=True)
    g_lp = torch.autograd.grad(sum(torch.sum(loop[n] * w[n]) for n in vm),
                               [tp["adj"], tp["convs.0.lin.weight"]],
                               allow_unused=True)
    for a, b in zip(g_vm, g_lp):
        if cls == "STEGCN" and fused and a is None:   # adj detached
            assert b is None
            continue
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-14)


@pytest.mark.parametrize("column_chunk", [None, 2])
@pytest.mark.parametrize("fisher_type", ["type-2-sketch", "type-2-fork"])
def test_sketch_and_fork_adj_gradient_match_jax(fisher_type, column_chunk,
                                                monkeypatch):
    """d/d adj of a scalar of the factors through the STE (fused=False),
    with the blocks checkpointed when chunked."""
    use_jax_draws(monkeypatch)
    jm, tm, jp, y = _setup("STEGCN", False, seed=3)
    kw = dict(fisher_type=fisher_type, column_chunk=column_chunk, **OPTS)
    wts = [np.random.default_rng(k).standard_normal((d, d))
           for k, d in enumerate((H, F, C, H))]

    def scalar(k, wrap):
        fs = [k.kfacs[0][0], k.kfacs[1][1], k.kfacs[2][0], k.kfacs[3][1]]
        return sum((f * wrap(wi)).sum() for f, wi in zip(fs, wts))

    jg = jax.grad(lambda p: scalar(JK.compute_kfac_factors(
        jm, p, jnp.arange(M), jnp.asarray(y[:M]), "classification", N=M,
        **kw), jnp.asarray))(jax.tree_util.tree_map(jnp.asarray, jp))["adj"]
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    (tg,) = torch.autograd.grad(scalar(_tfactors(tm, tp, y, **kw), _t),
                                tp["adj"])
    assert np.abs(np.asarray(jg)).max() > 0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-8,
                               atol=1e-12)


def test_fork_differs_from_type2_on_a_gcn():
    """The fork's non-detached square root changes B on a GNN (the
    adjacency mixes rows), by the same amount in both packages; A is
    untouched."""
    jm, tm, jp, y = _setup("GCN", False, seed=4)
    tp = params_from_numpy(jp, device="cpu")
    t2, fork = (_tfactors(tm, tp, y, fisher_type=f)
                for f in ("type-2", "type-2-fork"))
    j2, jfork = (_jfactors(jm, jp, y, fisher_type=f)
                 for f in ("type-2", "type-2-fork"))
    for i in (0, 2):                    # the two sites' B (bias groups)
        d_t = (fork.kfacs[i][0] - t2.kfacs[i][0]).numpy()
        d_j = np.asarray(jfork.kfacs[i][0] - j2.kfacs[i][0])
        assert np.abs(d_t).max() > 1e-4 * np.abs(t2.kfacs[i][0].numpy()).max()
        np.testing.assert_allclose(d_t, d_j, rtol=1e-8, atol=1e-13)
    np.testing.assert_array_equal(fork.kfacs[1][1].numpy(),
                                  t2.kfacs[1][1].numpy())


def test_fork_gradient_finite_at_saturated_logits():
    """Saturated logits (p underflows to 0) keep the fork's cotangents and
    their derivative finite: the square root is exp(log_softmax / 2)."""
    out = torch.tensor([[0.0, 800.0, -800.0], [1.0, 2.0, 3.0]],
                       dtype=torch.float64, requires_grad=True)
    cots = TK._fork_cotangents("classification", out)
    (g,) = torch.autograd.grad(torch.sum(cots ** 2), out)
    assert torch.isfinite(cots).all() and torch.isfinite(g).all()


def test_sketch_unbiased_and_deterministic():
    """The port's own sketch: E[P P^T] = I over seeds, so B averaged over
    seeds approaches the exact type-2 B; A is exact for every seed; one
    seed reproduces bit for bit and another differs."""
    k = 4
    PP = np.mean([(lambda P: P @ P.T)(TK._sketch_projection(
        s, C, k, torch.float64).numpy()) for s in range(4000)], axis=0)
    np.testing.assert_allclose(PP, np.eye(C), atol=0.03)
    _, tm, jp, y = _setup("STEGCN", True, seed=5)
    tp = params_from_numpy(jp, device="cpu")
    exact = _tfactors(tm, tp, y)
    fits = [_tfactors(tm, tp, y, fisher_type="type-2-sketch", sketch_size=k,
                      seed=s) for s in range(60)]
    for i, g in enumerate(exact.kfacs):
        bar = np.mean([f.kfacs[i][0].numpy() for f in fits], axis=0)
        scale = np.abs(g[0].numpy()).max()
        assert np.abs(bar - g[0].numpy()).max() < 0.15 * scale
        if len(g) == 2:
            np.testing.assert_array_equal(fits[0].kfacs[i][1].numpy(),
                                          g[1].numpy())
    again = _tfactors(tm, tp, y, fisher_type="type-2-sketch", sketch_size=k,
                      seed=0)
    for ga, gb in zip(again.kfacs, fits[0].kfacs):
        for a, b in zip(ga, gb):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(fits[1].kfacs[0][0].numpy(),
                              fits[0].kfacs[0][0].numpy())


def test_mc_labels_follow_the_predictive():
    """The port's MC label draws: class frequencies over many draws match
    softmax(f); regression draws are f + N(0, 1/2); one (seed, m) always
    gives the same draw."""
    f = torch.tensor([[2.0, 0.0, -1.0], [0.0, 0.0, 0.0], [-3.0, 1.0, 1.5]],
                     dtype=torch.float64)
    draws = torch.stack([TK._draw_label(7, m, "classification", f)
                         for m in range(6000)])
    freq = torch.stack([(draws == c).double().mean(0) for c in range(3)],
                       dim=-1)
    np.testing.assert_allclose(freq.numpy(), torch.softmax(f, -1).numpy(),
                               atol=0.025)
    assert torch.equal(TK._draw_label(7, 5, "classification", f), draws[5])
    z = torch.stack([TK._draw_label(1, m, "regression", f) - f
                     for m in range(3000)])
    assert abs(float(z.mean())) < 0.02
    assert abs(float(z.var()) - 0.5) < 0.02
    # on a graph without edges (rows do not mix) the mc factors over many
    # samples approach the exact type-2 ones; with edges they need not, as
    # type-2 keeps the cross-sample terms of its fixed columns
    _, tm, jp, y = _setup("STEGCN", True, seed=6)
    tp = params_from_numpy(jp, device="cpu")
    tp["adj"] = torch.zeros_like(tp["adj"])
    exact = _tfactors(tm, tp, y)
    mc = _tfactors(tm, tp, y, fisher_type="mc", mc_samples=400)
    for g, gm in zip(exact.kfacs, mc.kfacs):
        scale = np.abs(g[0].numpy()).max()
        assert np.abs(gm[0].numpy() - g[0].numpy()).max() < 0.1 * scale


@pytest.mark.parametrize("fisher_type", TK.FISHER_TYPES)
def test_neg_marglik_fisher_options_match_jax(fisher_type, monkeypatch):
    """make_neg_marglik_fn with each fisher type and its options (blocks
    of 2 columns, sketch k 4, 2 MC samples, fisher_seed 3): value and d/d
    adj through the STE (fused=False), against JAX."""
    from laplace_gnn_tpu.training import marglik_gnn as JT
    from laplace_gnn_torch.training import marglik_gnn as TT
    use_jax_draws(monkeypatch)
    jm, tm, jp, y = _setup("STEGCN", False, seed=7)
    kw = dict(fisher_type=fisher_type, column_chunk=2, sketch_size=4,
              mc_samples=2, fisher_seed=3, prior_precision=0.7)
    jfn = JT.make_neg_marglik_fn(jm, "classification", "kron", "all", N=M,
                                 **kw)
    jv, jg = jax.value_and_grad(jfn)(jax.tree_util.tree_map(jnp.asarray, jp),
                                     jnp.arange(M), jnp.asarray(y[:M]))
    tfn = TT.make_neg_marglik_fn(tm, "classification", "kron", "all", N=M,
                                 **kw)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    tv = tfn(tp, torch.arange(M), torch.as_tensor(y[:M]))
    (ga,) = torch.autograd.grad(tv, tp["adj"])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-10)
    assert np.abs(np.asarray(jg["adj"])).max() > 0
    np.testing.assert_allclose(ga.numpy(), np.asarray(jg["adj"]), rtol=1e-8,
                               atol=1e-12)
