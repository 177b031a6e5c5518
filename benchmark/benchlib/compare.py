"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the plain reference works out from the same
inputs, read in float64 on the host, and each is held to a limit of its
own (``benchmark/limits/<cell>.json``)."""

from __future__ import annotations

import statistics

import numpy as np
import torch


def as_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def trace_gap(prog, ref) -> float:
    """Largest |prog - ref| / |ref| over two traces of one length."""
    p, r = as_array(prog), as_array(ref)
    if p.shape != r.shape:
        return float("inf")
    if not np.all(np.isfinite(p)):
        return float("inf")
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-300)))


def max_abs_gap(prog, ref) -> float:
    p, r = as_array(prog), as_array(ref)
    if p.shape != r.shape or not np.all(np.isfinite(p)):
        return float("inf")
    return float(np.max(np.abs(p - r)))


def leaf_norm_gap(prog: dict, ref: dict, base: dict = None,
                  skip=()) -> float:
    """The worst leaf's gap of norms, ``abs(norm(prog - base) -
    norm(ref - base))``, over the larger of ``norm(ref - base)`` and the
    median leaf's (``base`` zero when not given), over the leaves not in
    ``skip``: the gap between the program's norm and the reference's, not
    the norm of their difference."""
    names = [k for k in ref if k not in skip]
    if set(prog) - set(skip) != set(names):
        return float("inf")
    pn, rn = {}, {}
    for k in names:
        p, r = as_array(prog[k]), as_array(ref[k])
        if p.shape != r.shape or not np.all(np.isfinite(p)):
            return float("inf")
        if base is not None:
            b = as_array(base[k])
            p, r = p - b, r - b
        pn[k], rn[k] = np.linalg.norm(p), np.linalg.norm(r)
    median = statistics.median(rn.values())
    return max(abs(pn[k] - rn[k]) / max(rn[k], median, 1e-300)
               for k in names)


def relative_gap(prog, ref) -> float:
    """‖prog - ref‖ / ‖ref‖."""
    p, r = as_array(prog), as_array(ref)
    if p.shape != r.shape or not np.all(np.isfinite(p)):
        return float("inf")
    return float(np.linalg.norm(p - r) / max(np.linalg.norm(r), 1e-300))


def judged(readings: dict, limits: dict) -> list:
    """[(name, value, limit)] for every number that has a limit, in the
    limits' order; a number the run could not read counts as infinite."""
    return [(name, float(readings.get(name, float("inf"))), float(lim))
            for name, lim in limits.items()]


def worst(rows: list) -> dict:
    """The largest reading of each number over several checked units."""
    out: dict = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out
