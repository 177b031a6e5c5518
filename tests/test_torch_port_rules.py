"""Rules of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points never fall back to the CPU unasked."""

import ast
import importlib
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


def _example_files():
    """The port's user entry points, ``examples/torch/*.py``."""
    return sorted((REPO / "examples" / "torch").glob("*.py"))


def _port_files():
    return _package_files() + [REPO / "chip_smoke.py"] + _example_files()


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


@pytest.mark.parametrize("path", _package_files() + _example_files(),
                         ids=lambda p: p.name)
def test_no_sklearn_or_yaml_at_module_level(path):
    """The card has neither scikit-learn nor (maybe) PyYAML: the port reads
    a config or makes two moons only inside the function that needs it."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split(".")[0])
    assert not top & {"sklearn", "yaml"}, path


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_matplotlib_or_scipy_at_module_level(path):
    """The card has no matplotlib: the plots import it, and the Planetoid
    parser scipy, only inside the function that needs it."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split(".")[0])
    assert not top & {"matplotlib", "scipy"}, path


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


def test_no_plotting_or_sklearn_module_loaded_by_the_package():
    """Importing every module of the package (as chip_smoke.py's imports
    reach them) loads no matplotlib, scikit-learn or scipy."""
    mods = ", ".join(
        "laplace_gnn_torch." + ".".join(p.relative_to(
            REPO / "laplace_gnn_torch").with_suffix("").parts)
        for p in _package_files() if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in '{mods}'.split(', '):\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('matplotlib', 'sklearn', 'scipy')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _jax_surface():
    """(port package, the public names of the JAX package's ``__init__``
    there, JAX's ``__version__`` or None) for every JAX ``__init__.py``:
    the names it imports from its own modules and the public functions
    and classes it defines."""
    out = []
    for init in sorted((REPO / "laplace_gnn_tpu").rglob("__init__.py")):
        tree = ast.parse(init.read_text(), filename=str(init))
        names, version = [], None
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.level >= 1:
                names += [a.asname or a.name for a in node.names]
            elif (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                  and not node.name.startswith("_")):
                names.append(node.name)
            elif isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__version__"
                    for t in node.targets):
                version = ast.literal_eval(node.value)
        rel = init.parent.relative_to(REPO / "laplace_gnn_tpu").parts
        out.append((".".join(("laplace_gnn_torch",) + rel), names, version))
    return out


@pytest.mark.parametrize("module,names,version", _jax_surface(),
                         ids=[m for m, _, _ in _jax_surface()])
def test_public_surface_matches_jax_init(module, names, version):
    """Every name a JAX ``__init__`` exports imports from the port's
    counterpart; an ``__all__`` there lists every one of them and nothing
    the package lacks; ``__version__`` is JAX's."""
    assert names or module.endswith("native"), module
    mod = importlib.import_module(module)
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, f"{module} lacks {missing}"
    if hasattr(mod, "__all__"):
        assert not set(names) - set(mod.__all__), module
        assert all(hasattr(mod, n) for n in mod.__all__), module
    if version is not None:
        assert mod.__version__ == version


def test_top_level_import_in_fresh_interpreter():
    """The first line of the library examples works in a fresh process and
    loads no JAX, Triton, scipy, matplotlib or scikit-learn module."""
    banned = FORBIDDEN + ("triton", "scipy", "matplotlib", "sklearn")
    code = (
        "import sys\n"
        "from laplace_gnn_torch import Laplace, KronLaplace, "
        "marglik_training\n"
        "import laplace_gnn_torch\n"
        "assert laplace_gnn_torch.__version__ == '0.1.0'\n"
        "assert Laplace.__module__ == 'laplace_gnn_torch.laplace.dispatch'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        f"       {banned!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_jax_example_has_a_port():
    """``examples/torch/`` holds one counterpart per JAX example, under the
    same file name."""
    jax_names = sorted(p.name for p in (REPO / "examples").glob("*.py"))
    assert jax_names and jax_names == [p.name for p in _example_files()]


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
    from laplace_gnn_torch.training import marglik_optimization_scan
    split = (np.arange(5), np.zeros(5, int), np.arange(5, 8),
             np.zeros(3, int))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        marglik_optimization_scan(m, m.params(), *split, n_epochs=1)
    out = marglik_optimization_scan(m, m.params(), *split, n_epochs=1,
                                    device="cpu")
    assert out[1]["adj"].device.type == "cpu" and out[2].shape == (1,)
    from laplace_gnn_torch.laplace.marglik import marglik_training
    from laplace_gnn_torch.nn import CNN, MLP, Conv2d
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MLP([4, 8, 3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CNN([(1, 2, 3)], 2 * 4 * 4, 3)
    mlp = MLP([4, 8, 3], device="cpu")
    CNN([(1, 2, 3)], 2 * 4 * 4, 3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Conv2d(1, 2, 3)
    Conv2d(1, 2, 3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        marglik_training(mlp, mlp.params(), [(torch.zeros(2, 4),
                                              torch.zeros(2, dtype=int))],
                         n_epochs=1)
    from laplace_gnn_torch.training.experiment import main
    from laplace_gnn_torch.utils.data import ArrayLoader
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArrayLoader(np.arange(5), np.zeros(5, int))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--dataset", "karate", "--model_type", "gcn"])
    from laplace_gnn_torch.curvature import LinearOperator, random_probes
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinearOperator((3, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_probes(0, (3, 2))
    assert LinearOperator((3, 3), device="cpu").device == torch.device("cpu")
    assert random_probes(0, (3, 2), device="cpu").device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def _mixed_device_call(site):
    """A call of ``site`` with CPU and ``meta`` tensors (the two eigensolver
    sites take one tensor: it is on ``meta``, neither CPU nor CUDA)."""
    from laplace_gnn_torch.ops import flash_attention as fa
    from laplace_gnn_torch.ops import gat_attention as ga
    from laplace_gnn_torch.ops import linalg
    from laplace_gnn_torch.ops.fused_spmm import core
    from laplace_gnn_torch.ops.matmul import matmul
    meta = {"device": "meta"}
    if site == "core":
        return lambda: core(torch.zeros(4, 4), torch.zeros(4, 2, **meta))
    if site == "matmul":
        return lambda: matmul(torch.zeros(4, 3), torch.zeros(3, 2, **meta))
    if site in ("small_eigvalsh", "small_eigenvectors"):
        fn = getattr(linalg, site)
        return lambda: fn(torch.zeros(2, 4, 4, **meta))
    if site == "spmm":
        from laplace_gnn_torch.graph.container import sparse_from_edge_index
        g = sparse_from_edge_index(np.array([[0, 1], [1, 0]]), 4,
                                   device="cpu")
        return lambda: g.spmm(torch.zeros(4, 3, **meta))
    n, H, F = 6, 2, 3
    a_src, a_dst = torch.zeros(n, H), torch.zeros(n, H, **meta)
    h = torch.zeros(n, H, F)
    if site == "gat_attention":
        src = torch.arange(n)
        csr = ga.attention_csr(src, src, n)
        return lambda: ga.gat_attention(csr, h, a_src, a_dst, 0.2)
    args = (a_src, a_dst, torch.ones(n, n), h)
    if site == "flash_bwd":
        args += (torch.zeros(n, H, F), torch.zeros(n, H, F),
                 torch.zeros(H, n), torch.ones(H, n))
    return lambda: getattr(fa, site)(*args)


@pytest.mark.parametrize("site", ["core", "matmul", "flash_fwd", "flash_bwd",
                                  "gat_attention", "small_eigvalsh",
                                  "small_eigenvectors", "spmm"])
def test_kernel_wrapper_rejects_mixed_devices(site):
    """Every wrapper takes its plain version on CPU tensors and its kernel
    on tensors of one CUDA device (``cuda_build.route``); anything else
    raises before a launch is counted."""
    from laplace_gnn_torch.ops import cuda_build
    call = _mixed_device_call(site)
    with cuda_build.counting() as launched:
        with pytest.raises(ValueError, match="one CUDA device"):
            call()
    assert launched == {}


def test_kernel_launch_checks_its_return_and_counts(monkeypatch):
    """``Kernel.launch`` binds its entry point on first use, counts a
    launch that returns 0, raises naming the kernel on any other return
    and counts nothing then, and counts a launch made under a stream
    capture in ``recorded`` (the capture check is faked: the CPU has no
    stream to capture)."""
    import ctypes
    import types
    from laplace_gnn_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "KERNELS", [])
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])

    class Entry:
        rc = 0

        def __call__(self, *args):
            self.args = args
            return self.rc

    entry = Entry()
    k = cuda_build.Kernel("fake", "fake_lib", "fake_launch", [ctypes.c_int])
    monkeypatch.setattr(cuda_build, "load",
                        lambda name: types.SimpleNamespace(fake_launch=entry))
    assert cuda_build.KERNELS == [k]
    assert k.source == "laplace_gnn_torch/csrc/fake_lib.cu"
    with cuda_build.counting() as launched:
        k.launch(7)
    assert entry.args == (7,) and entry.restype is ctypes.c_int
    assert entry.argtypes == [ctypes.c_int]
    assert (k.launches, k.recorded, launched) == (1, 0, {k: 1})
    entry.rc = 700
    with pytest.raises(RuntimeError,
                       match="fake launch failed with CUDA error 700"):
        k.launch(7)
    assert (k.launches, k.recorded) == (1, 0)
    entry.rc = 0
    capturing[0] = True
    with cuda_build.counting("recorded") as recorded:
        k.launch(7)
    assert (k.launches, k.recorded, recorded) == (1, 1, {k: 1})
    k.count_replay(3)
    assert (k.launches, k.replayed) == (4, 3)


def test_kernel_launch_is_an_operation_under_a_profiler(monkeypatch):
    """Under a profiler a launch is an operation (not a user span) named
    after the kernel, inside the spans around the call, so the device
    work it launches counts under them; it calls the entry point once
    either way."""
    import ctypes
    import types
    from laplace_gnn_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "KERNELS", [])
    calls = []
    entry = types.SimpleNamespace()
    entry.fake_launch = lambda *args: calls.append(args) or 0
    monkeypatch.setattr(cuda_build, "load", lambda name: entry)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    k = cuda_build.Kernel("fake", "fake_lib", "fake_launch", [ctypes.c_int])
    with torch.profiler.profile() as prof:
        with torch.autograd.profiler.record_function("lgnn.outer"):
            k.launch(3)
    k.launch(4)
    (event,) = [e for e in prof.events() if e.name == "fake"]
    assert event.scope == 0 and not event.is_user_annotation
    assert event.cpu_parent is not None
    assert event.cpu_parent.name == "lgnn.outer"
    assert calls == [(3,), (4,)] and k.launches == 2


def test_flash_kernels_sum_without_atomics():
    """Both flash kernels sum in a fixed order (a cluster merge and an
    ordered reduce of per-block partials), so two calls give the same
    bits: the source holds no atomic add."""
    src = (REPO / "laplace_gnn_torch" / "csrc" / "flash_attention.cu")
    assert "atomicAdd" not in src.read_text()


def test_sparse_entry_points_raise_without_gpu_unless_cpu_asked(no_gpu,
                                                                tmp_path):
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.models import SparseGAT, SparseGCN, SparseSAGE
    from laplace_gnn_torch.parallel import initialize
    from laplace_gnn_torch.training.sparse_experiment import main
    from laplace_gnn_torch.utils import (TrainCheckpointer, load_pytree,
                                         save_pytree)

    X, adj = _graph()
    ei = np.array(np.nonzero(adj))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sparse_from_edge_index(ei, 10)
    g = sparse_from_edge_index(ei, 10, device="cpu")
    assert g.src.device.type == "cpu"
    for cls, kw in ((SparseGCN, {}), (SparseSAGE, {}),
                    (SparseGAT, {"heads": 2})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(4, 8, 4, 2, X, g, **kw)
        m = cls(4, 8, 4, 2, X, g, device="cpu", **kw)
        assert all(p.device.type == "cpu" for p in m.params().values())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--dataset", "karate", "--n_steps", "1"])
    path = str(tmp_path / "t.pkl")
    save_pytree(path, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_pytree(path)
    assert load_pytree(path, device="cpu")["w"].device.type == "cpu"
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.latest()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize("localhost:1", 2, 0)       # raises before it connects


def test_native_loader_reads_nothing_of_the_jax_package():
    """A fresh process builds (or finds) the C++ packer and packs a graph;
    an audit hook records every file it opens or loads: none is under
    laplace_gnn_tpu/. The port's source is its own copy."""
    from laplace_gnn_torch import native
    code = (
        "import sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda ev, args: opened.append(str(args[0])) "
        "if ev in ('open', 'ctypes.dlopen') else None)\n"
        "import numpy as np\n"
        "from laplace_gnn_torch import native\n"
        "from laplace_gnn_torch.graph import container\n"
        "assert native.available()\n"
        "g = container.sparse_from_edge_index(np.array([[0, 1], [1, 2]]), "
        "3, device='cpu')\n"
        "container.add_ell_format(g)\n"
        "bad = [f for f in opened if 'laplace_gnn_tpu' in f]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert native.SRC.parent == REPO / "laplace_gnn_torch" / "native"
    assert native.library_path().parent == REPO / "laplace_gnn_torch" / \
        "_build"
    assert native.SRC.read_bytes() == (
        REPO / "laplace_gnn_tpu" / "native" / "graph_prep.cpp").read_bytes()


def test_parallel_entry_points_raise_without_gpu_unless_cpu_asked(no_gpu):
    """The sharded layer's entry points resolve their device before they
    touch the mesh: without a GPU they raise unless ``device="cpu"``."""
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.parallel import (HaloAggGraph, make_mesh,
                                            make_row_sharded_gat_attention,
                                            make_sharded_train_step)
    X, adj = _graph()
    g = sparse_from_edge_index(np.array(np.nonzero(adj)), 10, device="cpu")
    m = STEGCN(4, 8, 3, 2, X, adj, device="cpu")
    for call in (lambda: make_mesh(),
                 lambda: HaloAggGraph(None, g),
                 lambda: make_sharded_train_step(m, None, torch.sum),
                 lambda: make_row_sharded_gat_attention(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # with the CPU asked, make_mesh still needs a process group
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_dcn_entry_points_raise_without_gpu_unless_cpu_asked(no_gpu):
    """The hybrid mesh and the DCN aggregates resolve their device before
    they touch the mesh: without a GPU they raise unless
    ``device="cpu"``."""
    from laplace_gnn_torch.graph.container import sparse_from_edge_index
    from laplace_gnn_torch.parallel import (DcnAggGraph,
                                            make_dcn_gat_aggregate,
                                            make_dcn_halo_aggregate,
                                            make_hybrid_mesh)
    X, adj = _graph()
    g = sparse_from_edge_index(np.array(np.nonzero(adj)), 10, device="cpu")
    for call in (lambda: make_hybrid_mesh(),
                 lambda: make_dcn_halo_aggregate(None, g),
                 lambda: make_dcn_gat_aggregate(None, g),
                 lambda: DcnAggGraph(None, g)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(RuntimeError, match="process group"):
        make_hybrid_mesh(device="cpu")


def test_fake_group_only_when_asked(tmp_path):
    """A fake process group (one rank alone, nothing moved) makes a mesh
    only with ``allow_fake=True``; its collectives then give zeros where
    they would receive, at the real shapes."""
    code = (
        "import sys, torch\n"
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "import laplace_gnn_torch.parallel as P\n"
        "from laplace_gnn_torch.parallel import collectives as C\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                        world_size=4)\n"
        "for make in (lambda **k: P.make_mesh(device='cpu', **k),\n"
        "             lambda **k: P.make_hybrid_mesh(2, device='cpu', **k)):\n"
        "    try:\n"
        "        make()\n"
        "        sys.exit(1)\n"
        "    except RuntimeError as e:\n"
        "        assert 'fake' in str(e)\n"
        "mesh = P.make_hybrid_mesh(2, device='cpu', allow_fake=True)\n"
        "ax = C.mesh_axis(mesh, 'graph')\n"
        "assert ax.backend == 'fake' and ax.size == 2\n"
        "got = C.all_gather(torch.ones(3, 2), ax)\n"
        "assert got.shape == (6, 2) and not got.isnan().any()\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


def test_parallel_loads_no_scipy_and_gloo_takes_no_device_tensor(tmp_path):
    """A fresh process imports the sharded layer (no scipy is loaded: only
    ``rcm_order`` imports it, inside), joins a one-process Gloo group and
    makes a CPU mesh; a tensor on another device (``meta`` here, as a
    card's would be) raises at every collective instead of crossing
    Gloo."""
    code = (
        "import sys, torch\n"
        "import laplace_gnn_torch.parallel as P\n"
        "from laplace_gnn_torch.parallel import collectives as C\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'scipy']\n"
        f"P.initialize('file://{tmp_path}/rdzv', 1, 0, device='cpu')\n"
        "mesh = P.make_mesh(device='cpu')\n"
        "ax = C.mesh_axis(mesh)\n"
        "assert ax.backend == 'gloo' and ax.size == 1\n"
        "x = torch.zeros(2, 3, device='meta')\n"
        "raised = 0\n"
        "for f in (C.all_gather, C.reduce_scatter, C.all_to_all,\n"
        "          C.all_reduce, C.gather_rows, C.sum_replicated,\n"
        "          C.pmax_shift, lambda t, a: C.ppermute(t, a, 1)):\n"
        "    try:\n"
        "        f(x, ax)\n"
        "    except RuntimeError as e:\n"
        "        raised += 'Gloo' in str(e)\n"
        "print(raised)\n"
        "sys.exit(0 if raised == 8 else 1)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
