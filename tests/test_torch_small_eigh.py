"""The small eigensolver (ops/linalg.py::small_eigvalsh, csrc/small_eigh.cu)
and the whole run's capture decision (training/marglik_gnn.py::
capture_plan).

On the CPU: the Function's plain path and its backward (``V diag(g) V^T``
from recomputed vectors) against ``torch.linalg.eigvalsh``'s autograd in
float64, the dispatch by device and size, and which steps a run on a GPU
would capture. On the card (marked ``cuda``; this file imports no JAX, so
``python -m pytest --noconftest -m cuda tests/test_torch_small_eigh.py``
runs them there): the kernels against the plain version, the backward
against torch's autograd, a replayed whole run at Cora's shape against the
eager loop, and a planted non-finite factor raising at the run's end."""

import math

import numpy as np
import pytest
import torch

from laplace_gnn_torch import models as TM
from laplace_gnn_torch import profiling
from laplace_gnn_torch.ops import linalg as L
from laplace_gnn_torch.training import marglik_gnn as TT


def _psd(kind: str, n: int, batch: int, seed: int, dtype=torch.float64,
         device="cpu") -> torch.Tensor:
    """(batch, n, n) symmetric PSD matrices with the named spectrum:
    ``separated`` (eigenvalues 1 .. n), ``clustered`` (three clusters of
    width 1e-6), ``rank_deficient`` (rank n // 3: repeated zeros), ``zero``
    (the zero matrix) or ``repeated`` (two exactly repeated values)."""
    g = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(batch, n, n, generator=g,
                                       dtype=torch.float64))
    k = torch.arange(n, dtype=torch.float64)
    lam = {"separated": 1.0 + k,
           "clustered": torch.tensor([1.0, 5.0, 9.0],
                                     dtype=torch.float64)[k.long() % 3]
           + 1e-6 * k,
           "rank_deficient": torch.where(k < n // 3, 1.0 + k, 0.0 * k),
           "zero": 0.0 * k,
           "repeated": torch.where(k < n // 2, 2.0 + 0.0 * k, 7.0 + 0.0 * k),
           }[kind]
    M = (Q * lam) @ Q.mT
    M = 0.5 * (M + M.mT)
    return M.to(device=device, dtype=dtype)


def _loss(lam: torch.Tensor) -> torch.Tensor:
    """A symmetric function of the spectrum, as the -log marglik's
    log-determinant is: its gradient does not depend on the basis chosen
    within a repeated eigenvalue. (No clip at 0: a rank-deficient
    matrix's zeros come out of either solver as +-1e-16, on either side
    of a clip's kink.)"""
    return torch.sum(torch.log(lam + 0.5)) + 0.1 * torch.sum(lam ** 2)


@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("kind", ["separated", "clustered",
                                  "rank_deficient"])
def test_plain_path_and_backward_match_eigvalsh_autograd(kind, n):
    M = _psd(kind, n, 3, seed=n)
    A = M.clone().requires_grad_(True)
    B = M.clone().requires_grad_(True)
    mine = L.small_eigvalsh(A)
    ref = torch.linalg.eigvalsh(B)
    np.testing.assert_allclose(mine.detach().numpy(), ref.detach().numpy(),
                               rtol=0, atol=1e-12 * max(1.0, n))
    (ga,) = torch.autograd.grad(_loss(mine), A)
    (gb,) = torch.autograd.grad(_loss(ref), B)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=0, atol=1e-10)
    # the backward is V diag(g) V^T: symmetric
    np.testing.assert_allclose(ga.numpy(), ga.mT.numpy(), atol=1e-12)


def test_backward_is_once_differentiable():
    A = _psd("separated", 5, 1, seed=0).requires_grad_(True)
    (g,) = torch.autograd.grad(_loss(L.small_eigvalsh(A)), A,
                               create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), A)


def test_small_eigenvectors_on_the_cpu_are_eigh_vectors():
    M = _psd("separated", 9, 2, seed=3)
    V = L.small_eigenvectors(M)
    lam = torch.linalg.eigvalsh(M)
    np.testing.assert_allclose((M @ V).numpy(), (V * lam[:, None, :]).numpy(),
                               atol=1e-12)


@pytest.mark.parametrize("n", [7, L.SMALL_N, L.SMALL_N + 1])
def test_batched_eigvalsh_dispatch_by_device_and_size(n):
    """CPU tensors: torch's values at every size; up to SMALL_N through the
    Function's plain path (no kernel launch, a host wait counted), above it
    torch.linalg.eigvalsh. A tensor on any other device takes the kernel
    up to SMALL_N, which refuses what is not CUDA rather than falling
    back, and torch above it (the meta device computes shapes only)."""
    mats = [_psd("separated", n, 1, seed=s)[0] for s in range(2)]
    mats.append(_psd("separated", 3, 1, seed=9)[0])
    launches = (L.eigvalsh_kernel.launches, L.eigh_kernel.launches)
    profiling.reset_counters()
    with torch.profiler.profile():
        out = L.batched_eigvalsh(mats)
        got = profiling.counters()
    for m, lam in zip(mats, out):
        np.testing.assert_allclose(lam.numpy(),
                                   torch.linalg.eigvalsh(m).numpy(),
                                   atol=1e-12 * n)
    assert (L.eigvalsh_kernel.launches, L.eigh_kernel.launches) == launches
    assert got["eigh.calls"] == 2 and got["eigh.matrices"] == 3
    assert got["host_sync"] == 2          # both groups ran torch's solver
    meta = [torch.empty(n, n, device="meta")]
    if n <= L.SMALL_N:
        with pytest.raises(ValueError, match="a CUDA tensor"):
            L.batched_eigvalsh(meta)
    else:
        (lam,) = L.batched_eigvalsh(meta)
        assert lam.shape == (n,) and lam.device.type == "meta"


@pytest.mark.parametrize("case", ["bad_dtype", "bad_shape", "too_large",
                                  "not_square"])
def test_kernel_wrapper_refuses_what_it_does_not_take(case):
    M = {"bad_dtype": torch.zeros(1, 4, 4, dtype=torch.float16),
         "bad_shape": torch.zeros(4, 4),
         "too_large": torch.zeros(1, L.SMALL_N + 1, L.SMALL_N + 1),
         "not_square": torch.zeros(1, 4, 5)}[case]
    with pytest.raises((ValueError, TypeError)):
        L.eigvalsh_kernel(M.to("meta"))
    with pytest.raises((ValueError, TypeError)):
        L.eigh_kernel(M)


def test_flag_reads_are_no_ops_off_the_card():
    profiling.reset_counters()
    with torch.profiler.profile():
        L.reset_eigensolve_failures("cpu")
        L.raise_on_failed_eigensolve("cpu")
        got = profiling.counters()
    assert "host_sync" not in got


# --- the whole run's capture decision ---------------------------------------

def _stegcn(n_feat=20, hidden=8, n_class=3, fused=True, n=12):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, n_feat))
    adj = (rng.random((n, n)) < 0.3).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    m = TM.STEGCN(n_feat, hidden, n_class, 2, X, adj, dropout_p=0.0,
                  fused=fused, device="cpu", dtype=torch.float64)
    return m, m.params()


CURVATURE = dict(hessian_structure="kron", subset_of_weights="all",
                 fisher_type="type-2", column_chunk=None, diag_probes=None,
                 sketch_size=8, mc_samples=1)


@pytest.mark.parametrize("case, captured", [
    ("kron_type2", True),
    ("kron_type2_features_wider_than_small_n", True),   # A0: at the build
    ("kron_type2_last_layer", True),
    ("kron_type2_composed", True),
    ("diag", True),
    ("kron_hidden_wider_than_small_n", False),
    ("kron_last_layer_wider_than_small_n", False),
    ("sketch", False),
    ("mc", False),
    ("full", False),
    ("column_chunk", False),
    ("diag_probes", False),
])
def test_capture_plan_on_a_gpu(case, captured):
    """On a GPU the train and tracking steps are captured; the -log marglik
    evaluation and the hyperstep with them when their curvature makes no
    host read: Kron type-2 with every per-step factor within SMALL_N (the
    first layer's A at more features is decomposed once, at the build),
    or the diagonal GGN."""
    model_kw, cfg = {}, dict(CURVATURE)
    wide = L.SMALL_N + 1
    if case == "kron_type2_features_wider_than_small_n":
        model_kw = dict(n_feat=wide)
    elif case == "kron_type2_last_layer":
        cfg["subset_of_weights"] = "last_layer"
    elif case == "kron_type2_composed":
        model_kw = dict(fused=False)
    elif case == "kron_hidden_wider_than_small_n":
        model_kw = dict(hidden=wide)
    elif case == "kron_last_layer_wider_than_small_n":
        model_kw = dict(hidden=wide)
        cfg["subset_of_weights"] = "last_layer"
    elif case in ("diag", "full"):
        cfg["hessian_structure"] = case
    elif case == "sketch":
        cfg["fisher_type"] = "type-2-sketch"
    elif case == "mc":
        cfg["fisher_type"] = "mc"
    elif case == "column_chunk":
        cfg["column_chunk"] = 2
    elif case == "diag_probes":
        cfg["diag_probes"] = 4
    model, params = _stegcn(**model_kw)
    plan = TT.capture_plan(True, model, params, **cfg)
    assert plan == {"train_step": True, "hyperstep": captured,
                    "neg_marglik": captured, "tracking": True}
    assert not any(TT.capture_plan(False, model, params, **cfg).values())


def test_kron_step_sizes_follow_the_tap_sites():
    model, params = _stegcn(n_feat=20, hidden=8, n_class=3)
    # B of both layers, A of the second; the first A (20) at the build
    assert sorted(TT.kron_step_sizes(model, params, "all")) == [3, 8, 8]
    assert sorted(TT.kron_step_sizes(model, params, "last_layer")) == [3, 8]


# --- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from laplace_gnn_torch.ops import cuda_build
    cuda_build.build(["small_eigh"])


CARD_NS = [1, 2, 7, 31, 32, 33, 64, 65, 127, 128]
CARD_KINDS = ["separated", "clustered", "rank_deficient", "repeated",
              "zero"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", CARD_NS)
def test_kernel_values_on_card_match_plain(n, dtype):
    """Every kind of spectrum at batches 1-4, against the plain version in
    float64 on the same (rounded) input: within 4 n eps ||M||_2, the
    backward-stable bound of a Householder reduction (Wilkinson: each of
    the n - 2 reflections perturbs M by O(eps ||M||)) with bisection's
    own eps ||T||; the values ascending."""
    _card()
    eps = torch.finfo(dtype).eps
    for b, kind in enumerate(CARD_KINDS):
        M = _psd(kind, n, 1 + b % 4, seed=n + b, dtype=dtype, device="cuda")
        got = L.eigvalsh_kernel(M)
        ref = torch.linalg.eigvalsh(M.double().cpu())
        norm = float(torch.linalg.matrix_norm(M.double().cpu(), 2).max())
        tol = 4 * n * eps * max(norm, 1.0)          # 1.0: the zero matrix
        err = float((got.double().cpu() - ref).abs().max())
        assert err <= tol, (kind, err)
        assert bool((got[:, 1:] >= got[:, :-1]).all()), kind


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", CARD_NS)
def test_kernel_vectors_on_card(n, dtype):
    """The Jacobi kernel's vectors: orthonormal and M V = V diag(w) within
    8 n eps ||M||_2 (each sweep's rotations are backward stable), its
    values those of the plain version within the same bound."""
    _card()
    eps = torch.finfo(dtype).eps
    for b, kind in enumerate(CARD_KINDS):
        M = _psd(kind, n, 1 + b % 4, seed=n + b, dtype=dtype, device="cuda")
        V = L.small_eigenvectors(M).double().cpu()
        Md = M.double().cpu()
        lam = torch.linalg.eigvalsh(Md)
        norm = max(float(torch.linalg.matrix_norm(Md, 2).max()), 1.0)
        tol = 8 * n * eps * norm
        eye = torch.eye(n, dtype=torch.float64)
        assert float((V.mT @ V - eye).abs().max()) <= 8 * n * eps, kind
        resid = float((Md @ V - V * lam[:, None, :]).abs().max())
        assert resid <= tol, (kind, resid)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["separated", "clustered",
                                  "rank_deficient"])
def test_kernel_backward_on_card_matches_torch_autograd(kind):
    _card()
    for n in (7, 64):
        M = _psd(kind, n, 2, seed=n, dtype=torch.float64, device="cuda")
        A = M.clone().requires_grad_(True)
        B = M.clone().requires_grad_(True)
        (ga,) = torch.autograd.grad(_loss(L.small_eigvalsh(A)), A)
        (gb,) = torch.autograd.grad(_loss(torch.linalg.eigvalsh(B)), B)
        assert float((ga - gb).abs().max()) <= 1e-9 * n, (kind, n)


@pytest.mark.cuda
def test_kernel_flags_a_non_finite_input_without_waiting():
    _card()
    M = _psd("separated", 16, 3, seed=0, dtype=torch.float32, device="cuda")
    L.reset_eigensolve_failures("cuda")
    M[1, 3, 2] = math.nan
    lam = L.eigvalsh_kernel(M)
    assert bool(torch.isnan(lam[1]).all())
    assert bool(torch.isfinite(lam[0]).all() and torch.isfinite(lam[2]).all())
    with pytest.raises(FloatingPointError, match="non-finite"):
        L.raise_on_failed_eigensolve("cuda")
    L.raise_on_failed_eigensolve("cuda")       # cleared by the raise


CORA_RUN = dict(lr=1e-3, lr_adj=0.8, weight_decay=5e-5, n_epochs=24,
                n_hypersteps=2, n_epochs_burnin=4, marglik_frequency=10,
                grad_norm=True, momentum_adj=0.9, weight_decay_adj=5e-4,
                model_type="stegcn")


def _cora_model(fused=True):
    rng = np.random.default_rng(0)
    n, f, c = 2708, 1433, 7
    X = rng.standard_normal((n, f)).astype(np.float32)
    adj = (rng.random((n, n)) < 10556 / n ** 2).astype(np.float32)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, c, n)
    model = TM.STEGCN(f, 64, c, 2, X, adj, dropout_p=0.0, fused=fused,
                      device="cuda",
                      generator=torch.Generator().manual_seed(0))
    split = (np.arange(140), y[:140], np.arange(140, 640), y[140:640])
    return model, split


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_replayed_kron_steps_at_cora_shape_match_eager_calls(fused):
    """Every step of a Kron type-2 whole run at Cora's widths is captured,
    and its traces and parameters equal the eager loop's on the same
    inputs within 1e-5 (float32 on one card: the same kernels in the same
    order, graphs only replaying them)."""
    _card()
    model, split = _cora_model(fused)
    scan = TT.marglik_optimization_scan(model, model.params(), *split,
                                        device="cuda", **CORA_RUN)
    (run,) = TT._model_program_cache(model).values()
    assert all(run.captured.values()), run.captured
    assert run.steps["hyperstep"].graph is not None
    eager = TT.marglik_optimization(model, model.params(), *split,
                                    verbose=False, device="cuda", **CORA_RUN)
    for a, b in zip(scan[2:], eager[2:]):
        a, b = np.asarray(a), np.asarray(b)
        assert float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) \
            <= 1e-5
    for k, v in eager[1].items():
        assert float((scan[1][k] - v).abs().max()) <= 1e-5 * max(
            1.0, float(v.abs().max())), k


@pytest.mark.cuda
def test_planted_non_finite_factor_raises_at_the_run_end():
    """A NaN in the second layer's weight makes every Kron factor NaN:
    the captured run goes on to its end without a host wait and raises
    there; the eager loop raises at its first epoch's read."""
    _card()
    model, split = _cora_model()
    params = model.params()
    kw = dict(CORA_RUN, n_epochs=12)
    TT.marglik_optimization_scan(model, params, *split, device="cuda", **kw)
    bad = dict(params)
    bad["convs.1.lin.weight"] = params["convs.1.lin.weight"].clone()
    bad["convs.1.lin.weight"][0, 0] = math.nan
    with pytest.raises(FloatingPointError, match="non-finite"):
        TT.marglik_optimization_scan(model, bad, *split, device="cuda", **kw)
    # the flag was cleared: a good run after it completes
    TT.marglik_optimization_scan(model, params, *split, device="cuda", **kw)
    with pytest.raises(FloatingPointError, match="non-finite"):
        TT.marglik_optimization(model, bad, *split, verbose=False,
                                device="cuda", **kw)
