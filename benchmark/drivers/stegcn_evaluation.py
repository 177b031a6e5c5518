"""Post-hoc evaluations of one trained STE-GCN, one a unit.

Set-up builds the program as ``stegcn_whole_run`` does; the plain
reference then makes one whole structure-learning run on the first split
from the seed's weights and graph (in float64, as its ``whole_run``
defines a run), and its final weights and adjacency parameter, in the
configuration's dtype, are the model that every evaluation takes on both
sides. A unit is the evaluation the experiment entry makes of a trained
model (``training/experiment.py::run_experiment``): ``fit_laplace`` (Kron
over every weight), its log marginal likelihood, the learned graph's
homophily, ``mean_eval`` on the validation and test nodes, and
``evaluate_map`` and ``evaluate_predictive`` (probit) on the test nodes.
The probabilities each metric is taken from are recorded as the metrics
function receives them. The check runs the plain reference's evaluation
of the same trained parameters over a sample of the window's evaluations
drawn from the seed."""

from __future__ import annotations

import contextlib

import torch

from benchlib import compare, graphs
from benchlib.drive import (ReferenceInputs, checked_units, kept,
                            load_driver, load_reference, patched)


class Evaluations:

    def __init__(self, ctx):
        whole = load_driver(ctx, "stegcn_whole_run")
        whole.build_program(self, ctx)
        from laplace_gnn_torch.training import evaluate
        self.evaluate = evaluate
        n = self.sizes[0]
        tr, va, te = graphs.node_split(ctx.seed, n, self._split_sizes,
                                       self.dev, "run", 0)
        self.split = (tr, self.y[tr], va, self.y[va], te, self.y[te])
        self.params = None
        dtype = getattr(torch, self.cfg["dtype"])
        with ReferenceInputs(self, self.dev):
            ref = load_reference(ctx, self.cfg["reference"])
            run = ref.whole_run(self.X, self.adj_raw, self.weights0,
                                self.split[:4], self.cfg, device=self.dev)
            self.trained = {k: v.to(self.dev, dtype).contiguous()
                            for k, v in run["params"].items()}
            del run
        self.y_host = self.y.cpu().numpy()
        self._probs = []
        self.outputs = {}
        metrics = evaluate._metrics

        def recorded(probs, labels):
            self._probs.append(probs)
            return metrics(probs, labels)
        self._restore = patched(evaluate, "_metrics", recorded)
        self._restore.__enter__()
        self.unit(-1)
        self.outputs.clear()

    def unit(self, i: int) -> None:
        from laplace_gnn_torch.graph.homophily import global_homophily
        mg, ev = self.mg, self.evaluate
        tr, ytr, va, yva, te, yte = self.split
        bp = self.trained
        self._probs.clear()
        la = mg.fit_laplace(self.model, bp, tr, ytr,
                            subset_of_weights="all", hessian_structure="kron")
        marglik = float(la.log_marginal_likelihood())
        out_adj = self.model.full_adj(bp).detach().cpu().numpy()
        global_homophily(out_adj, self.y_host)
        mg.mean_eval(self.model, bp, va, yva)
        mg.mean_eval(self.model, bp, te, yte)
        ev.evaluate_map(self.model, bp, te, yte)
        ev.evaluate_predictive(la, te, yte, link_approx="probit")
        if kept(i, self.mix):
            self.outputs[i] = {"log_marglik": marglik,
                               "map": self._probs[0],
                               "probit": self._probs[1]}

    @contextlib.contextmanager
    def traced(self, spans):
        """A synchronized span around the Laplace fit."""
        with patched(self.mg, "fit_laplace",
                     spans.wrap("fit", self.mg.fit_laplace)):
            yield {}

    def release(self) -> None:
        self._restore.__exit__(None, None, None)
        self.model = None

    def readings(self, out: dict, ref: dict) -> dict:
        """The log marglik's relative gap; the MAP softmax's largest gap;
        the probit's gap relative to its norm over every test node; and
        the largest gap of the probit's shift from the MAP, which the
        posterior's variance makes."""
        def shift(d):
            return (compare.as_array(d["probit"])
                    - compare.as_array(d["map"]))
        return {
            "log_marglik_gap": abs(out["log_marglik"]
                                   - float(ref["log_marglik"]))
            / abs(float(ref["log_marglik"])),
            "map_prob_gap": compare.max_abs_gap(out["map"], ref["map"]),
            "probit_rel_gap": compare.relative_gap(out["probit"],
                                                   ref["probit"]),
            "probit_shift_gap": compare.max_abs_gap(shift(out), shift(ref)),
        }

    def reference(self, dense_mode="float64", agg_mode="float64") -> dict:
        ref = load_reference(self.ctx, self.cfg["reference"])
        return ref.kron_evaluation(self.X, self.trained, self.y, self.split,
                                   self.cfg, dense_mode, agg_mode)

    def sample(self) -> list:
        return checked_units(self.ctx.seed, self.outputs, self.mix)

    def check(self) -> list:
        ref = self.reference()
        return [self.readings(self.outputs[i], ref) for i in self.sample()]

    def control(self) -> list:
        dense, agg = self.cfg["control_precision"]
        ref = self.reference()
        out = {k: (v.numpy() if hasattr(v, "numpy") else float(v))
               for k, v in self.reference(dense, agg).items()}
        return [self.readings(out, ref) for _ in self.sample()]


def fault_half_batch():
    """The Laplace fit takes half of the training nodes."""
    from laplace_gnn_torch.training import marglik_gnn as mg
    orig = mg.fit_laplace

    def half(model, params, idx, yy, **kwargs):
        k = idx.shape[0] // 2
        return orig(model, params, idx[:k], yy[:k], **kwargs)
    return patched(mg, "fit_laplace", half)


def fault_answer_altered():
    """One test node's probit predictive has its classes shifted by one
    where it is produced."""
    from laplace_gnn_torch.laplace import predictive
    orig = predictive.probit_predictive

    def altered(f_mu, f_var):
        p = orig(f_mu, f_var).clone()
        p[0] = p[0].roll(1)
        return p
    return patched(predictive, "probit_predictive", altered)


FAULTS = {"half_batch": fault_half_batch,
          "answer_altered": fault_answer_altered}


def setup(ctx):
    return Evaluations(ctx)
