"""KFAC Kronecker factors through tap sites.

Counterpart of ``laplace_gnn_tpu/curvature/kfac.py``. One forward runs the
model with a ``TapCollector`` that adds a perturbation ``eps`` to every
dense layer's pre-activation; ``torch.func.vjp`` w.r.t. ``eps`` gives the
per-layer output gradients for any output cotangent, and its pullback runs
under ``torch.func.vmap`` over the cotangent columns: through the fused
aggregation, ``_CoreFn``'s vmap rule folds the columns into the kernel's
feature axis, so a block of columns is one launch per aggregation. Then

    A = a^T a / (N * scale)      (input covariance; scale = the product of
                                  the middle dims for 'expand', 1 for
                                  'reduce')
    B = sum over columns of g^T g

Fisher types: 'type-2' (the columns of the exact loss-Hessian square
root), 'type-2-sketch' (k random Rademacher combinations of them), 'type-2-
fork' (the reference fork's non-detached square root), 'mc' (gradients at
labels drawn from the predictive), 'empirical' (the gradient at the true
labels) and 'forward-only' (B = I).

Everything is plain differentiable PyTorch: the factors stay
differentiable w.r.t. anything the forward depends on, the adjacency
included, which is what the marglik hyperstep differentiates.

Random draws (the sketch, the MC labels, the Hutchinson probes) come from
CPU ``torch.Generator``s seeded from ``seed`` and are then moved to the
device, so the card and the CPU draw the same numbers. Each draw lives in
its own small function (:func:`_sketch_projection`, :func:`_draw_label`,
:func:`_probe_signs`).

With ``mixed_diag=True`` posterior parameters outside every Linear site
(GAT attention vectors and biases) get curvature-diagonal blocks: exact,
from forward-mode tangent passes, or a Hutchinson estimate from
``diag_probes`` reverse-mode pullbacks.

On a sharded graph the model says so (its ``row_axis``: the axis whose
ranks hold its row blocks): the activations and the pullbacks' gradients
are then the rank's rows, and the factors' sums over rows become sums
over rows and ranks (``collectives.sum_replicated``: whole factors, whose
cotangents each rank takes as they are). ``N`` stays the global count.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..laplace.kron import Kron
from ..nn.module import TapCollector, get_subtree, set_subtree
from ..profiling import annotate
from ..utils.pytree import (DEFAULT_EXCLUDE, merge_split, named_leaves,
                            posterior_mask, split_by_mask, tree_size)
from .losses import get_loss_fn, loss_hessian_sqrt, sample_labels

FISHER_TYPES = ("type-2", "type-2-fork", "type-2-sketch", "mc", "empirical",
                "forward-only")
KFAC_APPROX = ("expand", "reduce")
DIAG_CHUNK = 16          # tangent directions per vmap of the diagonal blocks
PROBE_STREAM = 104729    # the Hutchinson probes' stream, apart from the MC's


def _fold_seed(seed: int, stream: int) -> int:
    """A seed for draw ``stream`` of a fit seeded with ``seed`` (the
    counterpart of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1)[0])


def _sketch_projection(seed: int, C: int, k: int, dtype,
                       device=None) -> torch.Tensor:
    """Rademacher sketch P (C, k) scaled so E[P P^T] = I.

    Projecting the loss-Hessian square root's C columns onto k random
    +-1/sqrt(k) combinations gives an unbiased estimate of the exact
    type-2 B at k pullbacks instead of C. The randomness enters linearly
    through exact columns, so a fixed seed gives a smooth surrogate that
    the hyperstep can differentiate. P and its scale are built in float32
    and the finished matrix is cast, as in the JAX package."""
    g = torch.Generator().manual_seed(seed)
    P = torch.randint(0, 2, (C, k), generator=g).to(torch.float32) * 2 - 1
    return (P / math.sqrt(k)).to(device=device, dtype=dtype)


def _draw_label(seed: int, m: int, likelihood: str,
                f: torch.Tensor) -> torch.Tensor:
    """The m-th MC Fisher label draw of a fit seeded with ``seed``, from
    the model's predictive at ``f``."""
    return sample_labels(torch.Generator().manual_seed(_fold_seed(seed, m)),
                         likelihood, f)


def _probe_signs(seed: int, n_probes: int, M: int, K: int, dtype,
                 device=None) -> torch.Tensor:
    """Rademacher Hutchinson probes z (n_probes, M, K)."""
    g = torch.Generator().manual_seed(_fold_seed(seed, PROBE_STREAM))
    z = torch.randint(0, 2, (n_probes, M, K), generator=g) * 2 - 1
    return z.to(device=device, dtype=dtype)


def _posterior_sites(model, params, exclude, last_layer,
                     allow_incomplete: bool = False):
    """Tap sites covering the posterior, and the posterior mask. Raises
    when a site marks its layer ``kfac_incomplete`` (posterior parameters
    outside its Linear, e.g. GAT attention vectors) unless
    ``allow_incomplete``: callers then cover those parameters with
    diagonal blocks (``mixed_diag``)."""
    mask = posterior_mask(params, exclude)
    sites = model.tap_sites(params)
    if last_layer:
        ll = tuple(model.last_layer_path(params))
        sites = [s for s in sites if tuple(s["param_path"]) in (ll, ll[:-1])]
    sites = [s for s in sites
             if any(get_subtree(mask, s["param_path"]).values())]
    if not allow_incomplete and any(s.get("kfac_incomplete") for s in sites):
        raise ValueError(
            "KFAC is only defined for models whose posterior parameters all "
            "belong to dense (Linear) layers; found non-Linear posterior "
            "parameters (e.g. GAT attention vectors). Pass mixed_diag=True "
            "for Kron-for-Linear + exact-diag-for-the-rest.")
    return sites, mask


def _loss_grad(lossfunc, f: torch.Tensor, y) -> torch.Tensor:
    """d lossfunc(f, y) / d f, differentiable w.r.t. f."""
    return torch.func.grad(lambda f_: lossfunc(f_, y))(f)


def _middle_sqrt(fisher_type, likelihood, out, y, lossfunc, seed,
                 mc_samples, sketch_size) -> torch.Tensor:
    """The middle square root R (M, C, K) of a fisher type, whose K columns
    are the pullbacks' cotangents: the loss-Hessian square root (type-2;
    the fork's value too), its sketch, the sampled gradients over
    sqrt(mc_samples), the batch gradient, or the identity
    (forward-only)."""
    if fisher_type in ("type-2", "type-2-fork"):
        return loss_hessian_sqrt(likelihood, out)
    if fisher_type == "type-2-sketch":
        S = loss_hessian_sqrt(likelihood, out)
        P = _sketch_projection(seed, S.shape[-1], sketch_size, out.dtype,
                               out.device)
        return torch.einsum("mcd,dk->mck", S, P)
    if fisher_type == "mc":
        cols = [_loss_grad(lossfunc, out,
                           _draw_label(seed, m, likelihood, out))
                for m in range(mc_samples)]
        return torch.stack(cols, dim=-1) / math.sqrt(float(mc_samples))
    if fisher_type == "empirical":
        return _loss_grad(lossfunc, out, y)[..., None]
    C = out.shape[-1]
    eye = torch.eye(C, dtype=out.dtype, device=out.device)
    return eye.expand(out.shape[0], C, C)


def _fork_cotangents(likelihood: str, out: torch.Tensor) -> torch.Tensor:
    """The reference fork's type-2 cotangents (C, M, C). The fork backwards
    ``sum(out * S[:, :, c])`` with a square root S that is not detached, so
    column c's cotangent is the gradient of that scalar w.r.t. the output:
    S[:, :, c] plus the dS/d(out) term. By the chain rule, pulling it back
    through the model equals the fork's gradient w.r.t. the taps."""
    C = out.shape[-1]

    def scalar(o, onehot):
        return torch.sum(o * torch.einsum(
            "mck,k->mc", loss_hessian_sqrt(likelihood, o), onehot))

    eye = torch.eye(C, dtype=out.dtype, device=out.device)
    return torch.func.vmap(torch.func.grad(scalar), in_dims=(None, 0))(
        out, eye)


def _mixed_diag_blocks(model, w, frozen, X, y, out, uncovered, fisher_type,
                       likelihood, mc_samples, seed, lossfunc,
                       sketch_size=8, diag_probes=None, probe_batch=None,
                       differentiate=False):
    """Curvature diagonal of the posterior leaves outside every tap site,
    ``{leaf name: (numel,) diagonal}``, with the fisher type's semantics
    and scale. With R the middle square root (:func:`_middle_sqrt`; the
    fork's non-detached artifact is not reproduced here, as in JAX), for
    the unit direction e_p of such a parameter

        diag[p] = sum_{m,k} (sum_c R[m, c, k] (J e_p)[m, c])^2.

    Exact (default): one forward-mode tangent pass (``torch.func.jvp``) per
    direction, ``DIAG_CHUNK`` directions at a time under
    ``torch.func.vmap``. The model must be jvp-capable (``jvp_safe``).

    ``diag_probes=k``: an unbiased Hutchinson estimate over the (sample,
    column) axes, diag[p] = E_z[(J^T (sum_k z_mk R_k))[p]^2] with
    Rademacher z (:func:`_probe_signs`): one ``torch.func.vjp`` and k
    pullbacks, each squared, averaged. Probes run in sequence, or
    ``probe_batch`` at a time under vmap (the same numbers); when the
    factors will be differentiated each step is checkpointed, so its
    pullback is recomputed in the outer backward instead of stored."""
    names = [n for n, _ in uncovered]
    sizes = [int(leaf.numel()) for _, leaf in uncovered]
    offs = [0]
    for sz in sizes:
        offs.append(offs[-1] + sz)
    P_u = offs[-1]
    R = _middle_sqrt(fisher_type, likelihood, out, y, lossfunc, seed,
                     mc_samples, sketch_size)                # (M, C, K)

    if diag_probes:
        uset = set(names)
        wu = {k: v for k, v in w.items() if k in uset}
        wrest = {k: v for k, v in w.items() if k not in uset}

        def f_u(wu_):
            return model.apply(merge_split(merge_split(wu_, wrest), frozen),
                               X)

        _, pull = torch.func.vjp(f_u, wu)
        zs = _probe_signs(seed, diag_probes, out.shape[0], R.shape[-1],
                          out.dtype, out.device)

        def one_probe(z):
            (g,) = pull(torch.einsum("mck,mk->mc", R, z))
            return torch.cat([g[n].reshape(-1) ** 2 for n in names])

        def step(zb):
            if probe_batch:
                return torch.func.vmap(one_probe)(zb)
            return one_probe(zb[0])[None]

        b = min(probe_batch, diag_probes) if probe_batch else 1
        rows = [checkpoint(step, zs[i:i + b], use_reentrant=False)
                if differentiate else step(zs[i:i + b])
                for i in range(0, diag_probes, b)]
        diag = torch.mean(torch.cat(rows), dim=0)
        return {n: diag[o:o + sz] for n, o, sz in zip(names, offs[:-1],
                                                       sizes)}

    def f_only(w_):
        return model.apply(merge_split(w_, frozen), X)

    def one(e):
        tangent = {k: torch.zeros_like(v) for k, v in w.items()}
        for n, o, sz in zip(names, offs[:-1], sizes):
            tangent[n] = e[o:o + sz].reshape(w[n].shape)
        _, td = torch.func.jvp(f_only, (w,), (tangent,))      # (M, C)
        q = torch.einsum("mck,mc->mk", R, td)
        return torch.sum(q * q)

    eye = torch.eye(P_u, dtype=out.dtype, device=out.device)
    diag = torch.cat([torch.func.vmap(one)(eye[i:i + DIAG_CHUNK])
                      for i in range(0, P_u, DIAG_CHUNK)])
    return {n: diag[o:o + sz] for n, o, sz in zip(names, offs[:-1], sizes)}


def _over_ranks(t: torch.Tensor, row_axis) -> torch.Tensor:
    """A sum over the rank's rows, summed over the ranks of ``row_axis``
    (a whole value); ``t`` itself without one."""
    if row_axis is None:
        return t
    from ..parallel.collectives import sum_replicated
    return sum_replicated(t, row_axis)


def _cov(g: torch.Tensor, kfac_approx: str, row_axis=None) -> torch.Tensor:
    """Sum over the leading (column) axis of g_c^T g_c, with the middle
    dims expanded into rows ('expand') or summed ('reduce'); one product
    for all columns, then the sum over the ranks' rows."""
    if kfac_approx == "expand":
        g2 = g.reshape(-1, g.shape[-1])
    else:
        g2 = g.reshape(g.shape[0] * g.shape[1], -1, g.shape[-1]).sum(dim=1)
    return _over_ranks(g2.T @ g2, row_axis)


def _input_cov(a: torch.Tensor, kfac_approx: str, N: int,
               row_axis=None) -> torch.Tensor:
    if kfac_approx == "expand":
        scale = math.prod(a.shape[1:-1])
        a2 = a.reshape(-1, a.shape[-1])
    else:
        scale = 1
        a2 = a.reshape(a.shape[0], -1, a.shape[-1]).mean(dim=1)
    return _over_ranks(a2.T @ a2, row_axis) / (N * scale)


def _static_input_cov(model, N: int, kfac_approx: str, dtype):
    """A of the first tap site when that site consumes the model's raw
    features (``first_tap_static``): X^T X / N is constant in every
    parameter, so it is formed once per model, N and dtype and kept on the
    model. The JAX package forms it in every traced hyperstep, where XLA
    drops the product when only the cached eigenvalues are used."""
    cache = model.__dict__.setdefault("_static_input_cov", {})
    key = (N, kfac_approx, dtype)
    if key not in cache:
        with torch.no_grad():
            cache[key] = _input_cov(_rank_features(model).to(dtype),
                                    kfac_approx, N, _row_axis(model))
    return cache[key]


def _row_axis(model):
    """The axis whose ranks hold the model's row blocks, or None."""
    return getattr(model, "row_axis", None)


def _rank_features(model):
    """The rows of the model's features this rank works on."""
    rows = getattr(model, "rank_features", None)
    return rows() if rows is not None else getattr(model, "X", None)


def _owning_site(leaf_name: str, site_by_prefix, sites, strict: bool = True):
    """The tap site whose Linear holds ``leaf_name``; None when there is
    none and not ``strict``."""
    parts = leaf_name.split(".")
    for k in range(len(parts), 0, -1):
        c = tuple(int(p) if p.isdigit() else p for p in parts[:k])
        if c in site_by_prefix:
            return site_by_prefix[c]
    if not strict:
        return None
    raise ValueError(
        f"Posterior parameter {leaf_name!r} does not belong to any KFAC tap "
        f"site; KFAC requires all posterior parameters to live in dense "
        f"layers (sites: {[s['name'] for s in sites]}).")


def posterior_split(model, params, exclude=DEFAULT_EXCLUDE,
                    last_layer: bool = False, allow_incomplete: bool = True):
    """(posterior params w, frozen params, tap sites)."""
    sites, mask = _posterior_sites(model, params, exclude, last_layer,
                                   allow_incomplete)
    if last_layer:
        ll_path = model.last_layer_path(params)
        ll_mask = {k: False for k in mask}
        mask = set_subtree(ll_mask, ll_path, get_subtree(mask, ll_path))
    w, frozen = split_by_mask(params, mask)
    return w, frozen, sites


def _zero_perturbations(model, params, sites, X) -> dict:
    """eps0: a zero perturbation of each site's pre-activation. On a
    BaseGNN that is (rows of the model's features, out features of the
    site's Linear): every layer runs on the whole graph, or on the rank's
    rows of it. Other models (MLP, CNN) give the shapes of the
    pre-activations that one forward on ``X`` records."""
    feats = _rank_features(model)
    shapes = {}
    if feats is None:
        taps = TapCollector()
        with torch.no_grad():
            model.apply(params, X, taps=taps)
        shapes = {name: s.shape for name, _, s in taps.records}
    out = {}
    for s in sites:
        weight = params[".".join(map(str, s["param_path"])) + ".weight"]
        shape = (shapes[s["name"]] if feats is None
                 else (feats.shape[0], weight.shape[0]))
        out[s["name"]] = torch.zeros(shape, dtype=weight.dtype,
                                     device=weight.device)
    return out


@annotate("kfac")
def compute_kfac_factors(model, params, X, y, likelihood: str,
                         fisher_type: str = "type-2", mc_samples: int = 1,
                         kfac_approx: str = "expand",
                         exclude=DEFAULT_EXCLUDE, last_layer: bool = False,
                         N: Optional[int] = None, seed: int = 0,
                         return_output: bool = False,
                         column_chunk: Optional[int] = None,
                         mixed_diag: bool = False,
                         sketch_size: int = 8,
                         diag_probes: Optional[int] = None,
                         probe_batch: Optional[int] = None):
    """KFAC factors of one batch (X, y), A normalized by ``N`` (the dataset
    size). ``return_output=True`` also returns the forward's model output,
    which callers reuse for the loss.

    ``column_chunk`` bounds the peak memory of the vmapped pullback (C x
    width intermediates): blocks of that many columns run in sequence, each
    under ``torch.utils.checkpoint`` when the factors will be
    differentiated, so the outer backward recomputes a block's pullback
    instead of storing every block's. Blocks sum exactly. (JAX pads the
    last block with zero columns, which add zero, to map over equal
    shapes; here it is just shorter.)

    ``mixed_diag=True``: posterior parameters outside every Linear tap
    site get diagonal blocks (:func:`_mixed_diag_blocks`) in their slots
    instead of raising.

    The span ``kfac`` holds ``kfac.forward`` (the forward and its
    ``torch.func.vjp``), ``kfac.pullback`` (the loss-Hessian columns and
    the vmapped pullbacks), ``kfac.covariances`` (the B sums of each
    block of columns, the A factors and the blocks) and, with
    ``mixed_diag``, ``kfac.diag_blocks``."""
    if fisher_type not in FISHER_TYPES:
        raise ValueError(f"fisher_type must be one of {FISHER_TYPES}")
    if kfac_approx not in KFAC_APPROX:
        raise ValueError(f"kfac_approx must be one of {KFAC_APPROX}")

    w, frozen, sites = posterior_split(model, params, exclude, last_layer,
                                       allow_incomplete=mixed_diag)
    site_names = [s["name"] for s in sites]
    lossfunc = get_loss_fn(likelihood)
    if N is None:
        N = y.shape[0]
    # the pullbacks are checkpointed only when the caller will
    # differentiate the factors (and not under a torch.func transform,
    # which takes no checkpoint)
    differentiate = (torch.is_grad_enabled()
                     and not torch._C._are_functorch_transforms_active()
                     and any(v.requires_grad for v in params.values()))

    def f_of_eps(eps):
        taps = TapCollector(eps)
        out = model.apply(merge_split(w, frozen), X, taps=taps)
        acts = {name: a for name, a, _ in taps.records if name in site_names}
        return out, acts

    with annotate("kfac.forward"):
        eps0 = _zero_perturbations(model, params, sites, X)
        out, pullback, acts = torch.func.vjp(f_of_eps, eps0, has_aux=True)
    for name in site_names:
        # JAX raises KeyError here: a residual Linear (res=True) is a
        # listed site that its forward applies without a tap
        if name not in acts:
            raise ValueError(f"KFAC tap site {name!r} recorded no tap in "
                             f"the forward; its layer runs untapped")

    row_axis = _row_axis(model)

    def summed(cots):
        with annotate("kfac.pullback"):
            (gs,) = torch.func.vmap(pullback)(cots)
        with annotate("kfac.covariances"):
            return {name: _cov(gs[name], kfac_approx, row_axis)
                    for name in site_names}

    def accumulate_B(cots):
        """Per-site sum over the cotangent columns (K, M, C) of g^T g."""
        n = cots.shape[0]
        if column_chunk is None or n <= column_chunk:
            return summed(cots)
        B = None
        for i in range(0, n, column_chunk):
            b = (checkpoint(summed, cots[i:i + column_chunk],
                            use_reentrant=False) if differentiate
                 else summed(cots[i:i + column_chunk]))
            B = b if B is None else {k: B[k] + b[k] for k in B}
        return B

    if fisher_type == "forward-only":        # FOOF: B = I
        B = {name: torch.eye(eps0[name].shape[-1], dtype=out.dtype,
                             device=out.device) for name in site_names}
    elif fisher_type == "type-2-fork":
        B = accumulate_B(_fork_cotangents(likelihood, out))
    else:
        with annotate("kfac.pullback"):
            R = _middle_sqrt(fisher_type, likelihood, out, y, lossfunc, seed,
                             mc_samples, sketch_size)
        B = accumulate_B(R.movedim(-1, 0))

    with annotate("kfac.covariances"):
        static = (model.tap_sites(None)[0]["name"]
                  if getattr(model, "first_tap_static", False) else None)
        A = {name: (_static_input_cov(model, N, kfac_approx, out.dtype)
                    if name == static else _input_cov(acts[name], kfac_approx,
                                                      N, row_axis))
             for name in site_names}

        site_by_prefix = {tuple(s["param_path"]): s for s in sites}
        kfacs, uncovered, slots = [], [], []
        for leaf_name, leaf in named_leaves(w):
            site = _owning_site(leaf_name, site_by_prefix, sites,
                                strict=not mixed_diag)
            if site is None:                     # diagonal block
                uncovered.append((leaf_name, leaf))
                slots.append(len(kfacs))
                kfacs.append(None)
                continue
            name = site["name"]
            kfacs.append([B[name]] if leaf.dim() == 1 else [B[name], A[name]])
    if uncovered:
        with annotate("kfac.diag_blocks"):
            diags = _mixed_diag_blocks(
                model, w, frozen, X, y, out, uncovered, fisher_type,
                likelihood, mc_samples, seed, lossfunc,
                sketch_size=sketch_size, diag_probes=diag_probes,
                probe_batch=probe_batch, differentiate=differentiate)
        for slot, (leaf_name, _) in zip(slots, uncovered):
            kfacs[slot] = [diags[leaf_name]]
    kron = Kron(kfacs)
    if return_output:
        return kron, out
    return kron


class KFACOperator:
    """KFAC as a linear operator on the flat posterior vector (the
    reference's ``KFACLinearOperator``): factors computed lazily and
    accumulated over a data iterable, products through the Kronecker
    factors, ``trace`` / ``det`` / ``logdet`` / ``frobenius_norm`` without
    the dense matrix, and a ``state_dict`` round trip. Its tensors live on
    the device of ``params``."""

    def __init__(self, model, params, data, likelihood: str,
                 fisher_type: str = "type-2", mc_samples: int = 1,
                 kfac_approx: str = "expand", exclude=DEFAULT_EXCLUDE,
                 last_layer: bool = False, N: Optional[int] = None,
                 seed: int = 0, check_deterministic: bool = False,
                 mixed_diag: bool = False, sketch_size: int = 8,
                 diag_probes: Optional[int] = None,
                 probe_batch: Optional[int] = None):
        self.model = model
        self.params = params
        self.data = list(data) if data is not None else None
        self.likelihood = likelihood
        self.fisher_type = fisher_type
        self.mc_samples = mc_samples
        self.sketch_size = sketch_size
        self.diag_probes = diag_probes
        self.probe_batch = probe_batch
        self.kfac_approx = kfac_approx
        self.exclude = exclude
        self.last_layer = last_layer
        self.mixed_diag = mixed_diag
        if N is None and self.data is not None:
            N = sum(int(y.shape[0]) for _, y in self.data)
        self.N = N
        self.seed = seed
        self._kron: Optional[Kron] = None

        w, _, _ = posterior_split(model, params, exclude, last_layer,
                                  allow_incomplete=mixed_diag)
        P = tree_size(w)
        self.shape = (P, P)
        leaves = [v for _, v in named_leaves(w)]
        self.dtype = leaves[0].dtype if leaves else torch.float32
        self.device = (leaves[0].device if leaves
                       else next(iter(params.values())).device)
        if check_deterministic:
            self.check_deterministic()

    @property
    def kron(self) -> Kron:
        """Accumulated Kronecker factors (computed once, cached)."""
        if self._kron is None:
            if self.data is None:
                raise ValueError(
                    "KFACOperator has no data; restore factors with "
                    "from_state_dict or pass a data iterable.")
            total = None
            for i, (X, y) in enumerate(self.data):
                k = compute_kfac_factors(
                    self.model, self.params, X, y, self.likelihood,
                    fisher_type=self.fisher_type, mc_samples=self.mc_samples,
                    kfac_approx=self.kfac_approx, exclude=self.exclude,
                    last_layer=self.last_layer, N=self.N,
                    seed=self.seed + i, mixed_diag=self.mixed_diag,
                    sketch_size=self.sketch_size,
                    diag_probes=self.diag_probes,
                    probe_batch=self.probe_batch)
                total = k if total is None else total + k
            self._kron = total
        return self._kron

    # -- linear-operator surface ------------------------------------------
    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        return self.kron.bmm(v)

    def matmat(self, V: torch.Tensor) -> torch.Tensor:
        return self.kron.bmm(V.T).T

    def __matmul__(self, other):
        other = torch.as_tensor(other, dtype=self.dtype, device=self.device)
        return self.matvec(other) if other.dim() == 1 else self.matmat(other)

    def to_dense(self) -> torch.Tensor:
        return self.kron.to_matrix()

    def check_deterministic(self) -> None:
        v = torch.randn(self.shape[1], generator=torch.Generator()
                        .manual_seed(0), dtype=torch.float64)
        v = v.to(self.device, self.dtype)
        a, b = self.matvec(v), self.matvec(v)
        if not torch.allclose(a, b, rtol=5e-5, atol=1e-6):
            raise RuntimeError("KFACOperator is not deterministic.")

    # -- matrix functionals -------------------------------------------------
    @property
    def trace(self) -> torch.Tensor:
        out = 0.0
        for g in self.kron.kfacs:
            t = torch.trace(g[0])
            if len(g) == 2:
                t = t * torch.trace(g[1])
            out = out + t
        return out

    @property
    def logdet(self) -> torch.Tensor:
        return self.kron.logdet()

    @property
    def det(self) -> torch.Tensor:
        return torch.exp(self.kron.logdet())

    @property
    def frobenius_norm(self) -> torch.Tensor:
        out = 0.0
        for g in self.kron.kfacs:
            n = torch.sum(g[0] ** 2)
            if len(g) == 2:
                n = n * torch.sum(g[1] ** 2)
            out = out + n
        return torch.sqrt(out)

    # -- serialization ------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "kfacs": [[f.detach() for f in g] for g in self.kron.kfacs],
            "likelihood": self.likelihood,
            "fisher_type": self.fisher_type,
            "mc_samples": self.mc_samples,
            "kfac_approx": self.kfac_approx,
            "last_layer": self.last_layer,
            "N": self.N,
            "seed": self.seed,
        }

    def _factors(self, state: dict) -> Kron:
        return Kron([[torch.as_tensor(
            f if isinstance(f, torch.Tensor) else np.array(f),
            device=self.device) for f in g] for g in state["kfacs"]])

    @classmethod
    def from_state_dict(cls, state: dict, model, params,
                        exclude=DEFAULT_EXCLUDE) -> "KFACOperator":
        op = cls(model, params, None, state["likelihood"],
                 fisher_type=state["fisher_type"],
                 mc_samples=state["mc_samples"],
                 kfac_approx=state["kfac_approx"], exclude=exclude,
                 last_layer=state["last_layer"], N=state["N"],
                 seed=state["seed"])
        op._kron = op._factors(state)
        return op

    def load_state_dict(self, state: dict) -> None:
        for key in ("likelihood", "fisher_type", "kfac_approx",
                    "last_layer"):
            if state[key] != getattr(self, key):
                raise ValueError(
                    f"state_dict mismatch for {key!r}: "
                    f"{state[key]!r} != {getattr(self, key)!r}")
        self._kron = self._factors(state)
