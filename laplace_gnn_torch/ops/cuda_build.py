"""The port's one boundary to its CUDA kernels: build, load, bind, launch,
check and count (nvcc -> shared library -> ctypes).

Every ``csrc/*.cu`` file is compiled on first use for ``sm_90a`` into
``laplace_gnn_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and flags, so an edited source rebuilds and an
unchanged one is reused; the hash covers the shared headers
``csrc/*.cuh`` too. :func:`build` starts one ``nvcc`` per missing
library, all at once. Nothing here runs at import time.

A wrapper declares each entry point it calls as a :class:`Kernel` and
calls :meth:`Kernel.launch`; it picks the kernel or its plain version
with :func:`route` and reads the card's SMs from :func:`sm_count`.

Launch counts. A :class:`Kernel` counts its launches in ``launches``. A
launch made while its stream is capturing a CUDA graph runs nothing yet:
it is counted in ``recorded``, and the graph's replays count it, once a
replay each, in ``launches`` and in ``replayed`` (``training/graphs.py``).
So ``launches`` is how many times the kernel ran, and ``replayed`` how
many of those came from a graph rather than a call from Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the GPU")
    return found


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: the name carries a hash of the
    source, of every shared header ``csrc/*.cuh`` (a source may include
    any of them) and of the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process each, concurrently. Returns ``{name: (seconds, ptxas
    report)}`` for what was compiled; raises with nvcc's output on
    failure."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, library_path(name))
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def route(name: str, *tensors: torch.Tensor) -> str:
    """The device rule of every kernel wrapper: ``"plain"`` when all
    ``tensors`` are on the CPU, ``"kernel"`` when all are on one CUDA
    device; anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return "plain"
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return "kernel"
    raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; all "
                     "must be on one CUDA device or all on the CPU")


def kernel_only(name: str, *tensors: torch.Tensor) -> None:
    """:func:`route` for an entry point with no plain version of its own:
    raises unless the kernel takes ``tensors``."""
    if route(name, *tensors) != "kernel":
        raise ValueError(f"{name}: CPU tensors; the kernel takes tensors on "
                         "one CUDA device")


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (132 on an H100 SXM,
    114 on a PCIe one)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


KERNELS: list = []     # every Kernel, in the order made


class Kernel:
    """The entry point ``symbol`` of ``csrc/<library>.cu``, a C function
    that launches on the stream it is given and returns a CUDA error code,
    typed by ``argtypes``. ``name`` names it in counts and errors."""

    def __init__(self, name: str, library: str, symbol: str, argtypes):
        self.name = name
        self.library = library
        self.source = f"laplace_gnn_torch/csrc/{library}.cu"
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.replayed = 0
        self.recorded = 0
        self._fn = None
        KERNELS.append(self)

    def bind(self, lib=None) -> None:
        """Launch through ``lib``'s entry point (default: the library built
        from ``csrc/<library>.cu``)."""
        fn = getattr(load(self.library) if lib is None else lib, self.symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = self.argtypes
        self._fn = fn

    def launch(self, *args) -> None:
        """Call the entry point (bound on first use) and count the launch;
        raises on a non-zero return, counting nothing. Under a profiler the
        call is an operation named ``name``, so the device work it launches
        is counted under the spans around it (a span's device time sums the
        operations inside it, and a kernel launched outside any operation
        belongs to none)."""
        if self._fn is None:
            self.bind()
        if torch.autograd._profiler_enabled():
            with torch._C._profiler._RecordFunctionFast(self.name):
                rc = self._fn(*args)
        else:
            rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error "
                               f"{rc}")
        if torch.cuda.is_current_stream_capturing():
            self.recorded += 1
        else:
            self.launches += 1

    def count_replay(self, n: int) -> None:
        """``n`` launches recorded into a graph ran once more."""
        self.launches += n
        self.replayed += n


@contextmanager
def counting(field: str = "launches"):
    """Yields a dict that, when the block ends, maps each kernel whose
    ``field`` count (``launches`` or ``recorded``) changed inside it to
    the change."""
    changed: dict = {}
    before = {k: getattr(k, field) for k in KERNELS}
    yield changed
    changed.update({k: getattr(k, field) - n for k, n in before.items()
                    if getattr(k, field) != n})
