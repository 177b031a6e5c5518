"""Post-hoc Laplace evaluations of a trained sparse GNN, one a unit.

Set-up builds the program as ``sparse_train`` does; the plain reference
then trains the model from the seed's weights for the mix's epochs (Adam
on the training nodes in float64, as its ``train_steps`` defines a step),
and the trained weights, in the configuration's dtype, are the input of
every evaluation on both sides. A unit is what the sparse CLI does after
training: ``fit_posterior`` (the Laplace fit with marglik prior tuning)
and ``predict`` (the MAP and the MC ``nn`` predictive on the test nodes).
The check runs the plain reference's evaluation of the same trained
weights over a sample of the window's evaluations, drawn from the seed."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchlib import compare
from benchlib.drive import (ReferenceInputs, checked_units, kept,
                            load_driver, load_reference, patched)


class Evaluations:

    def __init__(self, ctx):
        load_driver(ctx, "sparse_train").build_program(self, ctx)
        self.mix = ctx.mix
        self.params = self.opt = None
        dtype = getattr(torch, self.cfg["dtype"])
        with ReferenceInputs(self, self.dev):
            ref = load_reference(ctx, self.cfg["reference"])
            run = ref.train_steps(self.x, self.edge_index, self.y,
                                  self.train_idx, self.weights0, self.cfg,
                                  int(ctx.mix["train_epochs"]))
            self.trained = {k: v.to(self.dev, dtype)
                            for k, v in run["params"].items()}
            del run
        self.outputs = {}
        self.unit(-1)

    def unit(self, i: int) -> None:
        la = self.se.fit_posterior(self.args, self.model, self.trained,
                                   self.train_idx, self.y_train)
        probs = self.se.predict(self.args, self.model, self.trained, la,
                                self.test_idx)
        if kept(i, self.mix):
            self.outputs[i] = {"la": la, "map": probs["map"],
                               "mc": probs["laplace"]}

    @contextlib.contextmanager
    def traced(self, spans):
        """A synchronized span around the fit with its prior tuning."""
        se = self.se
        fit = se.fit_posterior
        counters = {}
        with patched(se, "fit_posterior", spans.wrap("fit", fit)):
            yield counters

    def release(self) -> None:
        """Read each kept evaluation's log marglik (at its tuned prior)
        from its Laplace object, then free the program's state."""
        for out in self.outputs.values():
            la = out.pop("la")
            out["log_marglik"] = float(la.log_marginal_likelihood())
        self.model = self.graph = None

    def readings(self, out: dict, ref: dict) -> dict:
        return {
            "log_marglik_gap": abs(out["log_marglik"] - ref["log_marglik"])
            / abs(ref["log_marglik"]),
            "map_prob_gap": compare.max_abs_gap(out["map"], ref["map"]),
            "mc_prob_gap": compare.max_abs_gap(out["mc"], ref["mc"]),
        }

    def _eps(self):
        """The MC predictive's standard normals as the method states them:
        a generator seeded with 0 on the device, (samples, parameters) in
        the weights' dtype."""
        c, h = self.cfg["n_classes"], self.cfg["hidden_channels"]
        g = torch.Generator(device=self.dev).manual_seed(0)
        return torch.randn((self.cfg["n_mc_samples"], c + c * h),
                           generator=g, dtype=torch.float32, device=self.dev)

    def reference(self, dense_mode="float64", agg_mode="float64") -> dict:
        ref = load_reference(self.ctx, self.cfg["reference"])
        return ref.last_layer_laplace(
            self.x, self.edge_index, self.y, self.train_idx, self.test_idx,
            self.trained, self.cfg, self.cfg["n_mc_samples"], self._eps(),
            dense_mode, agg_mode)

    def sample(self) -> list:
        return checked_units(self.ctx.seed, self.outputs, self.mix)

    def check(self) -> list:
        ref = self.reference()
        return [self.readings(self.outputs[i], ref) for i in self.sample()]

    def control(self) -> list:
        dense, agg = self.cfg["control_precision"]
        ref = self.reference()
        out = self.reference(dense, agg)
        return [self.readings(out, ref) for _ in self.sample()]


def fault_prior_untuned():
    """The prior tuning returns the prior it started from."""
    from laplace_gnn_torch.laplace.base import BaseLaplace
    return patched(BaseLaplace, "optimize_prior_precision",
                   lambda self, *a, **k: None)


def fault_answer_altered():
    """One test node's MC predictive has its classes shifted by one where
    it is returned."""
    from laplace_gnn_torch.training import sparse_experiment as se
    orig = se.predict

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out["laplace"] = out["laplace"].copy()
        out["laplace"][0] = np.roll(out["laplace"][0], 1)
        return out
    return patched(se, "predict", altered)


FAULTS = {"prior_untuned": fault_prior_untuned,
          "answer_altered": fault_answer_altered}


def setup(ctx):
    return Evaluations(ctx)
