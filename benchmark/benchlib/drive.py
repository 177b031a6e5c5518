"""Pieces the drivers share: the plain references found by name, weights
made on the device from the seed, inputs that the reference makes in
set-up, and a patch undone on leaving."""

from __future__ import annotations

import contextlib
import importlib.util
import math
import os
import time

import torch

from . import graphs


def load(ctx, folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module (names may hold
    ``.`` and ``-``, so they are loaded by path)."""
    path = os.path.join(ctx.bench_dir, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_{name}".replace(".", "_").replace("-", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reference(ctx, name: str):
    """``benchmark/references/<name>.py`` as a module."""
    return load(ctx, "references", name)


def load_driver(ctx, name: str):
    """``benchmark/drivers/<name>.py`` as a module."""
    return load(ctx, "drivers", name)


def make_weights(seed: int, widths, device) -> dict:
    """Each layer's weight (out, in) and bias (out) uniform in
    +-1/sqrt(in), as torch.nn.Linear draws them, named as the models name
    them, made on the device in float32 from the seed."""
    g = graphs.generator(seed, device, "weights")
    out = {}
    for i, (fi, fo) in enumerate(zip(widths[:-1], widths[1:])):
        bound = 1.0 / math.sqrt(fi)
        for name, shape in (("weight", (fo, fi)), ("bias", (fo,))):
            u = torch.rand(shape, generator=g, device=device)
            out[f"convs.{i}.lin.{name}"] = u * (2 * bound) - bound
    return out


class ReferenceInputs:
    """Inputs that the plain reference makes in set-up (a model it
    trains from the seed): the time they take, kept out of ``setup_s``,
    and the card's peak memory, set back when they are made, so that the
    peak is the program's."""

    def __init__(self, cell, device):
        self.cell, self.device = cell, device

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.cell.reference_setup_s = time.perf_counter() - self.t0
        return False


def kept(i: int, mix: dict) -> bool:
    """Whether unit ``i`` of the window is one of the first ``n_kept``,
    whose outputs are kept for the check (so what is kept does not grow
    with the window)."""
    return 0 <= i < int(mix["n_kept"])


def checked_units(seed: int, done, mix: dict) -> list:
    """``n_checked`` of the kept units ``done``, drawn from the seed."""
    import numpy as np
    done = sorted(done)
    rng = np.random.default_rng(graphs.substream(seed, "check"))
    k = min(int(mix["n_checked"]), len(done))
    return sorted(rng.choice(done, size=k, replace=False).tolist())


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)
