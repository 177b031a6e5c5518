"""Port parity for the other dense models: nn/module.py's LayerNorm and
BatchNorm, ops/adjacency.py::sample_neigh_adj, models/layers.py::
GraphSAGEConv, models/base_gnn.py's ``res`` and ``norm``, models/models.py's
GraphSAGE, STEGraphSAGE, LoRASTEGCN and AttSTEGCN, and their hypersteps
and trainer (the models' ``adj_params``), torch against
JAX in float64 on the CPU.

Composed float64 math: values are held at 1e-10 relative and gradients at
1e-10 absolute (1e-8 relative where a Kron eigendecomposition enters);
the 4-epoch trainers' parameters at 1e-8. JAX's random draws (neighbour
uniforms, dropout masks) are carried into the port by replacing its
private draw function or its dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_gnn_tpu import models as JM
from laplace_gnn_tpu.models import base_gnn as JB
from laplace_gnn_tpu.models import layers as JLY
from laplace_gnn_tpu.nn import module as JN
from laplace_gnn_tpu.ops import adjacency as JA
from laplace_gnn_tpu.training import marglik_gnn as JT
from laplace_gnn_torch import models as TM
from laplace_gnn_torch.models import base_gnn as TB
from laplace_gnn_torch.models import layers as TLY
from laplace_gnn_torch.nn import module as TN
from laplace_gnn_torch.ops import adjacency as TA
from laplace_gnn_torch.training import marglik_gnn as TT
from laplace_gnn_torch.utils.pytree import named_leaves, params_from_numpy

N, F, H, C = 30, 6, 8, 3
M = 16
RTOL = 1e-10
ATOL = 1e-10


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _graph(seed=0, isolated=True):
    """Features, a symmetric 0/1 adjacency without self-loops (node 0
    without any edge when ``isolated``) and labels."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    a = (rng.random((N, N)) < 0.15).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    if isolated:
        adj[0, :] = adj[:, 0] = 0.0
    return X, adj, rng.integers(0, C, N)


# --- nn/module.py and ops/adjacency.py ---------------------------------------

@pytest.mark.parametrize("kind", ["layer", "batch"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, H)) * 3 + 1
    w, b = rng.standard_normal(H), rng.standard_normal(H)
    jn = JN.make_norm(kind, H)
    tn = TN.make_norm(kind, H, dtype=torch.float64)
    assert type(tn).__name__ == type(jn).__name__ and tn.eps == jn.eps
    np.testing.assert_array_equal(tn.weight.detach().numpy(),
                                  np.asarray(jn.init(None)["weight"]))
    np.testing.assert_array_equal(tn.bias.detach().numpy(),
                                  np.asarray(jn.init(None)["bias"]))
    g = rng.standard_normal((N, H))

    def jloss(xx):
        return jnp.sum(jn.apply({"weight": w, "bias": b}, xx) * g)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    with torch.no_grad():
        tn.weight.copy_(torch.as_tensor(w))
        tn.bias.copy_(torch.as_tensor(b))
    tv = torch.sum(tn(tx) * torch.as_tensor(g))
    (tg,) = torch.autograd.grad(tv, tx)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)


@pytest.mark.parametrize("k", [None, 1, 3, 6])
@pytest.mark.parametrize("ties", [False, True])
def test_sample_neigh_adj_matches_jax(k, ties, monkeypatch):
    """The same uniforms on both sides (rounded to a grid of 0.25 for
    ties at the k-th value); rows with fewer than k edges (node 0 has
    none) keep all of them."""
    _, adj, _ = _graph(2)
    u = np.random.default_rng(3).random((N, N))
    if ties:
        u = np.round(u * 4) / 4
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(u))
    monkeypatch.setattr(TA, "_neigh_uniforms",
                        lambda n, generator, dtype, device: torch.tensor(
                            u, dtype=dtype))
    want = np.asarray(JA.sample_neigh_adj(jax.random.PRNGKey(0),
                                          jnp.asarray(adj), k))
    got = TA.sample_neigh_adj(torch.Generator(), torch.as_tensor(adj), k)
    np.testing.assert_array_equal(got.numpy(), want)
    if k is not None:
        deg = adj.sum(1)
        kept = got.numpy().sum(1)
        assert np.all(kept[deg <= k] == deg[deg <= k])
        assert np.all(kept[deg > k] >= k) and np.all(got.numpy() <= adj)
        assert ties or np.all(kept[deg > k] == k)


def test_graphsage_conv_matches_jax():
    X, adj, _ = _graph(4)
    jc = JLY.GraphSAGEConv(F, H, name="convs.0")
    jp = _np(jc.init(jax.random.PRNGKey(1)))
    tc = TLY.GraphSAGEConv(F, H, name="convs.0", dtype=torch.float64)
    g = np.random.default_rng(5).standard_normal((N, H))

    def jloss(p, a):
        return jnp.sum(jc.apply(p, a, jnp.asarray(X)) * g)

    jv, (jgp, jga) = jax.value_and_grad(jloss, argnums=(0, 1))(
        _jnp(jp), jnp.asarray(adj))
    tp = {k: v.requires_grad_(True) for k, v in
          params_from_numpy(jp, device="cpu").items()}
    ta = torch.tensor(adj, requires_grad=True)
    tv = torch.sum(torch.func.functional_call(tc, tp, (ta, torch.as_tensor(
        X))) * torch.as_tensor(g))
    grads = torch.autograd.grad(tv, [tp["lin.weight"], tp["lin.bias"], ta])
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    for got, want in zip(grads, (jgp["lin"]["weight"], jgp["lin"]["bias"],
                                 jga)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert tc.tap_sites() == jc.tap_sites()


# --- models -----------------------------------------------------------------

# name -> (class, constructor options); every new model, and the norms and
# residual Linears on the models of earlier slices
MODELS = {
    "graphsage": ("GraphSAGE", {}),
    "graphsage_k2": ("GraphSAGE", {"num_sampled_nodes_per_hop": 2}),
    "stegraphsage": ("STEGraphSAGE", {"symmetric": True}),
    "lorastegcn": ("LoRASTEGCN", {"r": 4, "lora_alpha": 16}),
    "attstegcn": ("AttSTEGCN", {"d_k": 4, "threshold": 0.3,
                                "symmetric": True}),
    "stegcn_layer": ("STEGCN", {"norm": "layer", "symmetric": True}),
    "stegcn_batch_fused": ("STEGCN", {"norm": "batch", "fused": True}),
    "gcn_res": ("GCN", {"res": True, "fused": True}),
    "stegcn_res": ("STEGCN", {"res": True, "norm": "layer"}),
}


def _pair(name, seed=0, dropout_p=0.0):
    """(JAX model, port model, JAX params as numpy, port params). A learned
    adjacency gets soft values with exact 0.5 ties; the norms get weights
    other than 1 and 0."""
    cls, kw = MODELS[name]
    X, adj, y = _graph(seed)
    jm = getattr(JM, cls)(F, H, C, 2, X, adj, dropout_p=dropout_p, **kw)
    tm = getattr(TM, cls)(F, H, C, 2, X, adj, dropout_p=dropout_p,
                          device="cpu", dtype=torch.float64, **kw)
    jp = _np(jm.init(jax.random.PRNGKey(seed + 7)))
    rng = np.random.default_rng(seed + 1)
    if "ste" in name:
        jp["adj"] = np.where(rng.random((N, N)) < 0.15, 0.5,
                             jp["adj"] * 0.7 + 0.2)
    for nm in jp.get("norms", []):
        nm["weight"] = 1 + 0.3 * rng.standard_normal(H)
        nm["bias"] = 0.3 * rng.standard_normal(H)
    return jm, tm, jp, y


def _grads(tp, tv):
    names = list(tp)
    return dict(zip(names, torch.autograd.grad(
        tv, [tp[k] for k in names], allow_unused=True)))


def _check_grads(tg, jg, atol=ATOL, rtol=0.0):
    for name, leaf in named_leaves(params_from_numpy(_np(jg), device="cpu")):
        got = tg[name]
        got = torch.zeros_like(leaf) if got is None else got
        np.testing.assert_allclose(got.numpy(), leaf.numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


@pytest.mark.parametrize("name", list(MODELS))
def test_model_forward_and_ce_gradients_match_jax(name):
    """Eval-mode forward and the CE gradients of every parameter, the
    tap sites, the parameter names and the first tap site's kind."""
    jm, tm, jp, y = _pair(name)
    idx = np.arange(0, N, 2)

    def jloss(p):
        f = jm.apply(p, jnp.asarray(idx))
        return JT._ce_mean(f, jnp.asarray(y[idx]))

    jv, jg = jax.value_and_grad(jloss)(_jnp(jp))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    tv = TT._ce_mean(tm.apply(tp, torch.as_tensor(idx)),
                     torch.as_tensor(y[idx]))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    _check_grads(_grads(tp, tv), jg)
    assert sorted(tm.params()) == sorted(tp)
    assert tm.tap_sites() == jm.tap_sites(jp)
    assert tm.first_tap_static == jm.first_tap_static
    np.testing.assert_array_equal(
        tm.full_adj(tp).detach().numpy(), np.asarray(jm.full_adj(_jnp(jp))))


@pytest.mark.parametrize("name", ["graphsage_k2", "stegcn_layer",
                                  "lorastegcn", "gcn_res"])
def test_model_train_mode_with_jax_draws(name, monkeypatch):
    """A train-mode forward with dropout 0.5: JAX's dropout masks and
    neighbour uniforms (for GraphSAGE, drawn from the first half of the
    split key as JAX draws them) replayed in the port."""
    jm, tm, jp, y = _pair(name, dropout_p=0.5)
    key = jax.random.PRNGKey(11)
    masks = []

    def jdrop(rng, x, p, train):
        keep = jax.random.bernoulli(rng, 1.0 - p, x.shape)
        masks.append(np.asarray(keep))
        return jnp.where(keep, x / (1.0 - p), 0.0)

    monkeypatch.setattr(JB, "dropout", jdrop)
    idx = np.arange(N)
    g = np.random.default_rng(2).standard_normal((N, C))

    def jloss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(idx), rng=key, train=True) * g)

    jv, jg = jax.value_and_grad(jloss)(_jnp(jp))
    replay = iter(masks)

    def tdrop(x, p, train, generator):
        assert train and generator is not None
        keep = torch.tensor(next(replay))
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    u = np.asarray(jax.random.uniform(jax.random.split(key)[0], (N, N)))
    monkeypatch.setattr(TB, "dropout", tdrop)
    monkeypatch.setattr(TA, "_neigh_uniforms",
                        lambda n, generator, dtype, device: torch.tensor(
                            u, dtype=dtype))
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    tv = torch.sum(tm.apply(tp, torch.as_tensor(idx),
                            generator=torch.Generator(), train=True)
                   * torch.as_tensor(g))
    assert next(replay, None) is None and len(masks) == 1
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    _check_grads(_grads(tp, tv), jg)
    # eval mode and a train-mode forward without a generator do not sample
    monkeypatch.setattr(TB, "dropout", TN.dropout)
    with torch.no_grad():
        f_eval = tm.apply(tp, None)
        f_nogen = tm.apply(tp, None, train=True)
    assert torch.equal(f_eval, f_nogen)


def test_lora_and_attention_parameters():
    """LoRA's factors and AttSTEGCN's projection: shapes, the init bounds,
    and the port's init() drawing what the constructor drew."""
    _, tm, _, _ = _pair("lorastegcn")
    p = tm.init()
    assert p["adj_lora_A"].shape == (4, N) and p["adj_lora_B"].shape == (N, 4)
    assert float(p["adj_lora_A"].abs().max()) <= 1 / np.sqrt(N)
    assert tm.scaling == 4.0
    for k, v in tm.params().items():
        assert torch.equal(v, p[k]), k
    _, ta, _, _ = _pair("attstegcn")
    assert ta.params()["adj_W.weight"].shape == (4, F)
    assert "adj_W.weight" in ta.init()


# --- hypersteps ---------------------------------------------------------------

def _adj_params(name):
    return ("adj_lora_A", "adj_lora_B") if name == "lorastegcn" else ("adj",)


@pytest.mark.parametrize("name,structure", [
    ("graphsage", "kron"), ("stegraphsage", "kron"), ("lorastegcn", "kron"),
    ("attstegcn", "kron"), ("stegcn_layer", "kron"),
    ("stegcn_batch_fused", "kron"), ("stegcn_res", "diag"),
    ("stegcn_res", "full"), ("gcn_res", "diag")])
def test_neg_marglik_value_and_adj_gradient_match_jax(name, structure):
    """-log marglik and its gradient w.r.t. the parameters the hyperstep
    steps (``adj``; for LoRA ``adj_lora_*``). STEGraphSAGE's first conv
    reads [X, mean_agg(X)], so d/d adj flows through its A factor."""
    jm, tm, jp, y = _pair(name)
    idx = np.arange(M)
    jfn = JT.make_neg_marglik_fn(jm, "classification", structure, "all",
                                 N=M, prior_precision=0.7)
    jv, jg = jax.jit(jax.value_and_grad(jfn))(
        _jnp(jp), jnp.asarray(idx), jnp.asarray(y[:M]))
    tfn = TT.make_neg_marglik_fn(tm, "classification", structure, "all",
                                 N=M, prior_precision=0.7)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").items()}
    tv = tfn(tp, torch.as_tensor(idx), torch.as_tensor(y[:M]))
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    names = _adj_params(name)
    grads = torch.autograd.grad(tv, [tp[k] for k in names],
                                allow_unused=True)
    for k, got in zip(names, grads):
        want = np.asarray(jg[k])
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=ATOL,
                                   err_msg=k)
        if name == "stegraphsage":
            assert np.abs(want).max() > 0


@pytest.mark.parametrize("name", ["stegcn_res", "gcn_res"])
def test_residual_layers_under_kron_raise_as_in_jax(name):
    """JAX lists the residual Linears as tap sites and applies them
    untapped, so its KFAC has no record for them: a KeyError. The port
    raises a ValueError that names the site."""
    jm, tm, jp, y = _pair(name)
    idx = np.arange(M)
    jfn = JT.make_neg_marglik_fn(jm, "classification", "kron", "all", N=M)
    with pytest.raises(KeyError, match="res.0"):
        jfn(_jnp(jp), jnp.asarray(idx), jnp.asarray(y[:M]))
    with pytest.raises(KeyError, match="res.0"):
        JT.fit_laplace(jm, _jnp(jp), idx, y[:M])
    tp = params_from_numpy(jp, device="cpu")
    tfn = TT.make_neg_marglik_fn(tm, "classification", "kron", "all", N=M)
    with pytest.raises(ValueError, match="'res.0'"):
        tfn(tp, torch.as_tensor(idx), torch.as_tensor(y[:M]))
    with pytest.raises(ValueError, match="'res.0'"):
        TT.fit_laplace(tm, tp, idx, y[:M])


# --- the trainer --------------------------------------------------------------

@pytest.mark.parametrize("name,model_type", [
    ("lorastegcn", "lorastegcn"), ("stegraphsage", "stegraphsage"),
    ("attstegcn", "attstegcn"), ("graphsage_k2", "graphsage")])
def test_marglik_optimization_matches_jax(name, model_type, monkeypatch):
    """4 epochs, 1 burn-in, 2 hypersteps every 2 epochs, grad_norm on:
    every parameter against JAX. LoRA's hypersteps move only
    ``adj_lora_*`` (``adj`` stays as it was: grad_norm rescales only the
    masked-out ``adj``); AttSTEGCN's ``adj_W`` is in neither optimizer;
    GraphSAGE takes no hyperstep, and its train steps sample neighbours
    from the trainer's generator (JAX's uniforms of each epoch's key
    replayed)."""
    jm, tm, jp, y = _pair(name, seed=1)
    rng, draws = jax.random.PRNGKey(0), []
    for _ in range(4):          # the JAX trainer's key of each epoch
        rng, sub = jax.random.split(rng)
        draws.append(np.asarray(jax.random.uniform(jax.random.split(sub)[0],
                                                   (N, N))))
    replay = iter(draws)
    monkeypatch.setattr(TA, "_neigh_uniforms",
                        lambda n, generator, dtype, device: torch.tensor(
                            next(replay), dtype=dtype))
    tr, va = np.arange(M), np.arange(M, 24)
    kw = dict(val_indices=va, val_labels=y[va], y=y, lr=1e-2, lr_adj=0.8,
              weight_decay=5e-5, weight_decay_adj=5e-4, momentum_adj=0.9,
              n_epochs=4, n_hypersteps=2, n_epochs_burnin=1,
              marglik_frequency=2, grad_norm=True, model_type=model_type,
              verbose=False)
    jres, jpar, jl, jvl, jnm = JT.marglik_optimization(
        jm, _jnp(jp), tr, y[tr], **kw)
    tres, tpar, tl, tvl, tnm = TT.marglik_optimization(
        tm, params_from_numpy(jp, device="cpu"), tr, y[tr], device="cpu",
        **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    np.testing.assert_allclose(tvl, jvl, rtol=1e-10)
    np.testing.assert_allclose(tnm, jnm, rtol=1e-10)
    jflat = dict(named_leaves(params_from_numpy(_np(jpar), device="cpu")))
    assert tpar.keys() == jflat.keys()
    for k, v in tpar.items():
        np.testing.assert_allclose(v.numpy(), jflat[k].numpy(), rtol=1e-8,
                                   atol=1e-12, err_msg=k)
    for crit in ("marglik", "valloss"):
        assert tres[crit]["epoch"] == jres[crit]["epoch"]
    start = params_from_numpy(jp, device="cpu")
    moved = {k for k in tpar if not torch.equal(tpar[k], start[k])}
    weights = {k for k in tpar if "adj" not in k}
    assert moved == weights | {"lorastegcn": {"adj_lora_A", "adj_lora_B"},
                               "stegraphsage": {"adj"},
                               "attstegcn": {"adj"},
                               "graphsage": set()}[model_type]
    assert (next(replay, None) is None) == (model_type == "graphsage")
