"""Whole STE-GCN structure-learning runs back to back, one a unit.

Set-up builds the model on a seeded graph at the configuration's shape,
makes the weights on the device from the seed, and makes one cold run
(the program builds its whole-run program: kernels loaded, steps
captured). Each unit is one ``marglik_optimization_scan`` call on a split
of its own, drawn from the seed as a grid over splits draws them; the run
reuses the cached program. The check runs the plain reference over a
sample of the window's runs, drawn from the seed, and compares the
traces, the final weights and the final adjacency."""

from __future__ import annotations

import contextlib

import torch

from benchlib import compare, counts, graphs
from benchlib.drive import (checked_units, kept, load_reference,
                            make_weights, patched)

TRAIN_KEYS = ("lr", "lr_adj", "weight_decay", "weight_decay_adj",
              "momentum_adj", "n_epochs", "n_hypersteps", "n_epochs_burnin",
              "n_hyper_stop", "marglik_frequency", "grad_norm",
              "prior_precision", "subset_of_weights", "hessian_structure",
              "fisher_type", "early_stop")


def build_program(cell, ctx) -> None:
    """Set on ``cell``: the seeded graph (``X``, ``adj_raw``, ``y``), the
    program's model on it, the weights (``weights0``, and ``params`` with
    the model's adjacency parameter), the whole run's options
    (``train_kw``) and the split sizes."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training import marglik_gnn as mg
    cell.ctx, cell.mg = ctx, mg
    cfg = cell.cfg = ctx.config
    cell.mix = ctx.mix
    dev = cell.dev = ctx.device
    n, f, c = cfg["n_nodes"], cfg["n_features"], cfg["n_classes"]
    cell.sizes = (n, f, cfg["hidden_channels"], c)
    cell.X, cell.adj_raw, cell.y = graphs.cora_like(
        ctx.seed, n, f, c, cfg["n_directed_edges"] / (n * n), dev)
    cell.model = STEGCN(
        f, cfg["hidden_channels"], c, cfg["num_layers"], cell.X,
        cell.adj_raw, dropout_p=cfg["dropout"], threshold=cfg["threshold"],
        symmetric=cfg["symmetric"], fused=cfg["fused"], device=dev)
    widths = ([f] + [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
              + [c])
    cell.weights0 = make_weights(ctx.seed, widths, dev)
    cell.params = {"adj": cell.model.adj.detach().clone(), **cell.weights0}
    cell.train_kw = {k: cfg[k] for k in TRAIN_KEYS}
    cell._split_sizes = (cfg["n_train"], cfg["n_val"], cfg["n_test"])


class WholeRuns:

    def __init__(self, ctx):
        build_program(self, ctx)
        self.outputs = {}
        self.recorder = None
        if ctx.trace:
            self.recorder = _CoreRecorder()
        self.unit(-1)                 # the cold run: build and capture
        (self.run,) = self.mg._model_program_cache(self.model).values()

    def split(self, i: int):
        tr, va, _ = graphs.node_split(self.ctx.seed, self.sizes[0],
                                      self._split_sizes, self.dev, "run", i)
        return tr, self.y[tr], va, self.y[va]

    def unit(self, i: int) -> None:
        tr, ytr, va, yva = self.split(i)
        _, final, losses, val_losses, nms = self.mg.marglik_optimization_scan(
            self.model, self.params, tr, ytr, va, yva,
            model_type="stegcn", device=self.dev, **self.train_kw)
        if kept(i, self.mix):
            self.outputs[i] = {"loss": losses, "val_loss": val_losses,
                               "neg_marglik": nms, "params": final}

    # --- the traced stretch ------------------------------------------------
    @contextlib.contextmanager
    def traced(self, spans):
        """Spans around the steps that run from Python and around the
        eigensolves; the core_spmm launches' bounds counted."""
        run, mg = self.run, self.mg
        steps = dict(run.steps)
        calls0 = {k: s.calls for k, s in steps.items()}
        eig = mg.batched_eigvalsh
        for k, s in steps.items():
            if s.graph is None:
                run.steps[k] = spans.wrap("eager_step", s)
        mg.batched_eigvalsh = spans.wrap("eigh", eig, sync=False)
        self.recorder.live = True
        self.recorder.live_bound_s = 0.0
        counters = {}
        try:
            yield counters
        finally:
            self.recorder.live = False
            mg.batched_eigvalsh = eig
            run.steps.update(steps)
        replay_bound = 0.0
        shapes = list(self.recorder.captured)
        for k, s in steps.items():
            if not s.capture:
                continue
            from laplace_gnn_torch.ops.fused_spmm import core
            mine = shapes[:s.recorded.get(core, 0)]
            shapes = shapes[len(mine):]
            per = sum(counts.core_spmm_bound_s(*sh) for sh in mine)
            replay_bound += per * (s.calls - calls0[k])
        counters["core_spmm_bound_s"] = (self.recorder.live_bound_s
                                         + replay_bound)
        n, f, h, c = self.sizes
        n_hyper = len(run.hyper_epochs) * self.cfg["n_hypersteps"]
        counters["model_flops_per_unit"] = counts.stegcn_run_flops(
            n, f, h, c, self.cfg["n_epochs"], n_hyper)

    # --- the check ---------------------------------------------------------
    def release(self) -> None:
        self.mg._model_program_cache(self.model).clear()
        del self.run
        self.model = None

    def readings(self, out: dict, ref: dict) -> dict:
        """Each trace's relative error (the norm of the gap over the
        reference's norm) and largest relative gap over the run's epochs,
        the final weights' change and the final adjacency."""
        names = [k for k in ref["params"] if k != "adj"]
        row = {}
        for k in ("loss", "val_loss", "neg_marglik"):
            row[f"{k}_rel"] = compare.relative_gap(out[k], ref[k])
            row[f"{k}_gap"] = compare.trace_gap(out[k], ref[k])
        row["weight_change_gap"] = compare.leaf_norm_gap(
            {k: out["params"][k] for k in names},
            {k: ref["params"][k] for k in names}, base=self.weights0)
        row["adj_gap"] = compare.max_abs_gap(out["params"]["adj"],
                                             ref["params"]["adj"])
        return row

    def reference(self, i: int, dense_mode: str = "float64",
                  agg_mode: str = "float64") -> dict:
        ref = load_reference(self.ctx, self.cfg["reference"])
        return ref.whole_run(self.X, self.adj_raw, self.weights0,
                             self.split(i), self.cfg, dense_mode, agg_mode,
                             self.dev)

    def sample(self) -> list:
        return checked_units(self.ctx.seed, self.outputs, self.mix)

    def check(self) -> list:
        """The readings of each checked run."""
        return [self.readings(self.outputs[i], self.reference(i))
                for i in self.sample()]

    def control(self) -> list:
        """The readings of the control (the reference at the precision
        below the configuration's) in the program's place, on the runs
        that ``check`` reads."""
        dense, agg = self.cfg["control_precision"]
        return [self.readings(self.reference(i, dense, agg),
                              self.reference(i))
                for i in self.sample()]


def fault_state_unchanged():
    """The train step's update returns the weights unchanged."""
    from laplace_gnn_torch.training import marglik_gnn as mg
    return patched(mg.DeviceAdam, "step", lambda self: None)


def fault_half_batch():
    """The train step takes the mean loss over half of its nodes."""
    from laplace_gnn_torch.training import marglik_gnn as mg
    orig = mg.TrainingPrograms.train_step

    def half(self, idx, yy, generator=None):
        k = idx.shape[0] // 2
        return orig(self, idx[:k], yy[:k], generator)
    return patched(mg.TrainingPrograms, "train_step", half)


def fault_adj_unchanged():
    """The hypersteps return the adjacency unchanged."""
    from laplace_gnn_torch.training import marglik_gnn as mg
    return patched(mg.TrainingPrograms, "hyperstep",
                    lambda self, idx, yy: self.neg_marglik_eval(idx, yy))


def fault_answer_altered():
    """One entry of a run's loss trace, in its middle, is doubled where the
    run returns it."""
    from laplace_gnn_torch.training import marglik_gnn as mg
    orig = mg.marglik_optimization_scan

    def altered(*args, **kwargs):
        results, final, losses, val_losses, nms = orig(*args, **kwargs)
        losses = losses.copy()
        losses[len(losses) // 2] *= 2.0
        return results, final, losses, val_losses, nms
    return patched(mg, "marglik_optimization_scan", altered)


# the faults a whole run can have, each planted in the program before
# set-up (a step captured into a CUDA graph keeps what it was captured as)
FAULTS = {"state_unchanged": fault_state_unchanged,
          "adj_unchanged": fault_adj_unchanged,
          "half_batch": fault_half_batch,
          "answer_altered": fault_answer_altered}


class _CoreRecorder:
    """Records the shape of every core_spmm launch: those made while a
    stream captures (they replay later) in order, and the bound of those
    made live while ``live`` is set."""

    def __init__(self):
        from laplace_gnn_torch.ops import fused_spmm as fs
        self.captured = []
        self.live = False
        self.live_bound_s = 0.0
        launch = fs.CoreKernel._launch
        rec = self

        def recorded(kernel, adj, t, threshold, binarize, transpose):
            out = launch(kernel, adj, t, threshold, binarize, transpose)
            if out.numel():
                shape = (adj.shape[0], t.shape[1], adj.element_size(),
                         t.element_size())
                if torch.cuda.is_current_stream_capturing():
                    rec.captured.append(shape)
                elif rec.live:
                    rec.live_bound_s += counts.core_spmm_bound_s(*shape)
            return out

        fs.CoreKernel._launch = recorded


def setup(ctx):
    return WholeRuns(ctx)
