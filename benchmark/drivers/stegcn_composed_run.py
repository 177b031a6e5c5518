"""Whole STE-GCN structure-learning runs on the composed route, one a unit.

The driver of ``stegcn_whole_run`` (set-up, units, traced stretch,
readings and faults) on a configuration with ``fused: false``, whose
plain reference (``stegcn_composed``) takes the straight-through gradient
of the -log marginal likelihood into the adjacency. It adds:

- the reading ``neg_marglik_early_gap``: the median, over the first
  ``EARLY`` epochs, of the -log marglik's relative gap. The whole run can
  part from the reference at a tie that the rounding decides: a hidden
  pre-activation within rounding of zero (ReLU's derivative jumps there,
  in the KFAC pullback's mask and in the training gradient, which Adam's
  step scales to about the learning rate) or, after a hyperstep, an
  adjacency entry within rounding of the threshold (binarized
  differently, so the two runs aggregate over different graphs). A part
  grows into a run as far from the reference as the TF32 control's, and
  most of a float32 program's runs part somewhere in their 200 epochs;
  so the whole run's readings are held to the faults, and the precision
  is read in the first epochs, before training can have parted. There
  a tie in the pullback's mask moves one epoch's -log marglik alone,
  which the median passes over, while the control's -log marglik is off
  in every epoch;
- ``flips_gap`` (the adjacency entries that the program's and the
  reference's final parameters binarize differently), ``flips_ref`` (the
  entries whose binarization the reference's run changed, start to end)
  and ``closest_ref`` (the reference's closest approach of an entry to
  the threshold after a hyperstep); the last two are not judged, and the
  check prints them on standard error;
- the fault ``hypergrad_zero``: the composed aggregation's adjacency
  detached inside the curvature's transforms, as the fused route's is, so
  the hypersteps' gradient is zero;
- the whole run's model operations on this route
  (``benchlib.composed_counts``) for the traced stretch's counters."""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from benchlib import compare, composed_counts
from benchlib.drive import load_reference, patched
from drivers import stegcn_whole_run as base


# the first epochs, before the training of the float32 program and of the
# float64 reference can have parted at a tie: on the card, at Cora's
# size, over 240 runs the program's median gap over them was at most
# 3.4e-7 and the TF32 control's at least 3.0e-5 (over 40)
EARLY = 5


class ComposedRuns(base.WholeRuns):

    @contextlib.contextmanager
    def traced(self, spans):
        with super().traced(spans) as counters:
            yield counters
        n, f, h, c = self.sizes
        n_hyper = len(self.run.hyper_epochs) * self.cfg["n_hypersteps"]
        counters["model_flops_per_unit"] = composed_counts.run_flops(
            n, f, h, c, self.cfg["n_epochs"], n_hyper)

    def readings(self, out: dict, ref: dict) -> dict:
        row = super().readings(out, ref)
        got, want = (compare.as_array(x["neg_marglik"][:EARLY])
                     for x in (out, ref))
        row["neg_marglik_early_gap"] = float(np.median(
            np.abs(got - want) / np.abs(want)))
        r = load_reference(self.ctx, self.cfg["reference"])
        thr, sym = float(self.cfg["threshold"]), bool(self.cfg["symmetric"])
        final = r.binarized(ref["params"]["adj"], thr, sym)
        start = r.binarized(r.initial_adjacency(
            self.adj_raw.to(ref["params"]["adj"]), sym), thr, sym)
        prog = r.binarized(out["params"]["adj"].to(final.device), thr, sym)
        row["flips_gap"] = int((prog != final).sum())
        row["flips_ref"] = int((final != start).sum())
        row["closest_ref"] = float(ref["closest"])
        return row

    def check(self) -> list:
        rows = super().check()
        for i, row in zip(self.sample(), rows):
            print(f"check: unit {i} flips_ref {row['flips_ref']} "
                  f"closest_ref {row['closest_ref']!r} flips_gap "
                  f"{row['flips_gap']}", file=sys.stderr, flush=True)
        return rows


def fault_hypergrad_zero():
    """The composed aggregation's adjacency detached inside the
    curvature's pullback (the fused route's semantics): the -log marglik
    reaches no parameter of the graph, the hypersteps' gradient is zero."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.ops.adjacency import (binarize_ste, fill_diagonal,
                                                 normalize_adj)
    orig = STEGCN.forward_adj

    def detached(self, taps=None):
        inner = ((taps is not None and taps.perturbed)
                 or torch._C._are_functorch_transforms_active())
        if self.fused or not inner:
            return orig(self, taps)
        adj = self.adj.detach()
        if self.symmetric:
            adj = (adj + adj.T) / 2
        adj = binarize_ste(adj, self.threshold, self.grad_adj_mask,
                           self.sign_grad)
        return normalize_adj(fill_diagonal(adj, 1.0))
    return patched(STEGCN, "forward_adj", detached)


# the faults a whole run can have, each planted in the program before
# set-up (a step captured into a CUDA graph keeps what it was captured as)
FAULTS = dict(base.FAULTS, hypergrad_zero=fault_hypergrad_zero)


def setup(ctx):
    return ComposedRuns(ctx)
