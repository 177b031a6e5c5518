"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points never fall back to the CPU unasked."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "laplace_gnn_tpu")


def _package_files():
    """The package's Python sources (not what a build left in _build/)."""
    pkg = REPO / "laplace_gnn_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "_build" not in p.relative_to(pkg).parts)


def _port_files():
    return _package_files() + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_no_jax_module_loaded_by_the_package():
    mods = ", ".join(
        "laplace_gnn_torch." + ".".join(p.relative_to(
            REPO / "laplace_gnn_torch").with_suffix("").parts)
        for p in _package_files() if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in '{mods}'.split(', '):\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _graph():
    rng = np.random.default_rng(0)
    adj = (rng.random((10, 10)) < 0.3).astype(float)
    return rng.standard_normal((10, 4)), np.minimum(adj + adj.T, 1.0)


def test_entry_points_raise_without_gpu_unless_cpu_asked(no_gpu):
    from laplace_gnn_torch import resolve_device
    from laplace_gnn_torch.models import GAT, GCN, STEGCN
    from laplace_gnn_torch.training import marglik_optimization
    from laplace_gnn_torch.utils.pytree import params_from_numpy

    X, adj = _graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        STEGCN(4, 8, 3, 2, X, adj, fused=True)
    with pytest.raises(RuntimeError):
        GCN(4, 8, 3, 2, X, adj)
    with pytest.raises(RuntimeError):
        params_from_numpy({"adj": adj})
    with pytest.raises(RuntimeError):
        GAT(4, 8, 4, 2, X, adj, heads=2, attention_impl="flash")
    GAT(4, 8, 4, 2, X, adj, heads=2, attention_impl="flash", device="cpu")
    m = STEGCN(4, 8, 3, 2, X, adj, fused=True, device="cpu")
    with pytest.raises(RuntimeError):
        marglik_optimization(m, m.params(), np.arange(5), np.zeros(5, int),
                             n_epochs=1, verbose=False)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrapper_rejects_mixed_devices():
    from laplace_gnn_torch.ops.fused_spmm import core
    a = torch.zeros(4, 4)
    t = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError):
        core(a, t)


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd"])
def test_flash_wrappers_reject_mixed_devices(wrapper):
    from laplace_gnn_torch.ops import flash_attention as fa
    n, H, F = 6, 2, 3
    a_src, a_dst = torch.zeros(n, H), torch.zeros(n, H, device="meta")
    adj, h = torch.ones(n, n), torch.zeros(n, H, F)
    args = (a_src, a_dst, adj, h)
    if wrapper == "flash_bwd":
        args += (torch.zeros(n, H, F), torch.zeros(n, H, F),
                 torch.zeros(H, n), torch.ones(H, n))
    before = getattr(fa, wrapper).launches
    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(fa, wrapper)(*args)
    assert getattr(fa, wrapper).launches == before
