"""Full-batch training epochs of a sparse GNN, one a unit.

Set-up makes a seeded graph at the configuration's shape on the device,
builds the graph container and the model through the sparse CLI's own
pieces (``training/sparse_experiment.py``: ``build_graph``,
``build_model``, ``DeviceAdam``), makes the weights on the device from the
seed and drives the training object through its first three steps with
the window's own call (``train_steps`` of one step), recording each step's
loss, the first gradient as the optimizer holds it and the weights after
the third step. The window then goes on with the same object. The check
runs the plain reference over the same three steps from the same weights."""

from __future__ import annotations

import contextlib
import types

import torch

from benchlib import compare, counts, graphs
from benchlib.drive import load_reference, make_weights, patched

N_CHECKED_STEPS = 3


class _RecordingF:
    """``torch.nn.functional`` with ``cross_entropy`` recording each loss
    it returns, for the steps of set-up."""

    def __init__(self, F, losses):
        self._F = F
        self._losses = losses

    def __getattr__(self, name):
        return getattr(self._F, name)

    def cross_entropy(self, *args, **kwargs):
        loss = self._F.cross_entropy(*args, **kwargs)
        self._losses.append(loss.detach().clone())
        return loss


def build_program(cell, ctx) -> None:
    """Set on ``cell``: the seeded graph (``x``, ``y``, ``edge_index``),
    the program's graph container and model built by the sparse CLI's
    pieces, the weights (``weights0``, and ``params`` that train), the
    optimizer, and the split (``train_idx`` and ``test_idx``, from one
    seeded permutation)."""
    from laplace_gnn_torch.training import sparse_experiment as se
    from laplace_gnn_torch.training.marglik_gnn import DeviceAdam
    cell.ctx, cell.se = ctx, se
    cfg = cell.cfg = ctx.config
    dev = cell.dev = ctx.device
    n, f, c = cfg["n_nodes"], cfg["n_features"], cfg["n_classes"]
    cell.x, cell.y, cell.edge_index = graphs.arxiv_like(
        ctx.seed, n, f, c, cfg["n_undirected_draws"], cfg["max_degree"],
        dev)
    argv = ["--model_type", cfg["model_type"],
            "--hidden_channels", str(cfg["hidden_channels"]),
            "--num_layers", str(cfg["num_layers"]),
            "--lr", str(cfg["lr"]), "--agg_dtype", cfg["agg_dtype"],
            "--n_mc_samples", str(cfg["n_mc_samples"])]
    cell.args = se.argument_parser().parse_args(argv)
    data = types.SimpleNamespace(
        edge_index=cell.edge_index.cpu().numpy(), num_nodes=n,
        num_features=f, num_classes=c, x=cell.x)
    cell.graph = se.build_graph(cell.args, data, device=dev)
    cell.model = se.build_model(cell.args, data, cell.graph, device=dev)
    widths = ([f] + [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
              + [c])
    cell.weights0 = make_weights(ctx.seed, widths, dev)
    cell.params = {k: v.clone().requires_grad_(True)
                   for k, v in cell.weights0.items()}
    cell.opt = DeviceAdam(cell.params.values(), lr=cfg["lr"])
    n_test = n - cfg["n_train"] - cfg["n_val"]
    cell.train_idx, _, cell.test_idx = graphs.node_split(
        ctx.seed, n, (cfg["n_train"], cfg["n_val"], n_test), dev)
    cell.y_train = cell.y[cell.train_idx]


class TrainEpochs:

    def __init__(self, ctx):
        build_program(self, ctx)
        self.first = self._first_steps()

    def _first_steps(self) -> dict:
        """The first steps through the window's own call."""
        losses = []
        b1 = self.opt.betas[0]
        with patched(self.se, "F", _RecordingF(self.se.F, losses)):
            self.unit(-3)
            grad1 = {k: (m / (1 - b1)).double().cpu()
                     for k, m in zip(self.params, self.opt.exp_avg)}
            for i in range(N_CHECKED_STEPS - 1):
                self.unit(i - 2)
        return {"losses": [float(v) for v in losses], "grad1": grad1,
                "params": {k: v.detach().double().cpu()
                           for k, v in self.params.items()}}

    def unit(self, i: int) -> None:
        self.se.train_steps(self.model, self.params, self.opt,
                            self.train_idx, self.y_train, 1)

    @contextlib.contextmanager
    def traced(self, spans):
        """A span around each forward SpMM; the bound of each SpMM call,
        forward and (where its input takes a gradient) backward,
        counted."""
        fast = self.model.graph
        spmm = fast.spmm
        counters = {"spmm_bound_s": 0.0}
        g = self.graph
        value_bytes = torch.tensor([], dtype=getattr(
            torch, self.cfg["agg_dtype"])).element_size()

        def counted(x):
            b = counts.spmm_bound_s(g.n_edges, g.n_nodes, x.shape[-1],
                                    8, value_bytes)
            counters["spmm_bound_s"] += b * (2 if x.requires_grad else 1)
            return spmm(x)

        fast.spmm = spans.wrap("spmm", counted, sync=False)
        try:
            yield counters
        finally:
            del fast.spmm
        widths = ([self.cfg["n_features"]]
                  + [self.cfg["hidden_channels"]] * (self.cfg["num_layers"]
                                                     - 1)
                  + [self.cfg["n_classes"]])
        counters["model_flops_per_unit"] = counts.gcn_epoch_flops(
            g.n_nodes, g.n_edges, widths)

    def release(self) -> None:
        self.model = self.graph = self.opt = self.params = None

    def readings(self, out: dict, ref: dict) -> dict:
        gnorm = {k: float(v.norm()) for k, v in ref["grad1"].items()}
        med = sorted(gnorm.values())[len(gnorm) // 2]
        # leaves whose reference gradient is nought to rounding move under
        # Adam by round-off alone
        still = {k for k, v in gnorm.items() if v < 1e-3 * med}
        w0 = {k: v.double().cpu() for k, v in self.weights0.items()}
        return {
            "loss_gap": compare.trace_gap(out["losses"], ref["losses"]),
            "grad_norm_gap": compare.leaf_norm_gap(out["grad1"],
                                                   ref["grad1"]),
            "change_norm_gap": compare.leaf_norm_gap(
                out["params"], ref["params"], base=w0, skip=still),
            "grad_diff_gap": max(
                compare.relative_gap(out["grad1"][k], ref["grad1"][k])
                for k in ref["grad1"]),
        }

    def reference(self, dense_mode="float64", agg_mode="float64") -> dict:
        ref = load_reference(self.ctx, self.cfg["reference"])
        return ref.train_steps(self.x, self.edge_index, self.y,
                               self.train_idx, self.weights0, self.cfg,
                               N_CHECKED_STEPS, dense_mode, agg_mode)

    def check(self) -> list:
        return [self.readings(self.first, self.reference())]

    def control(self) -> list:
        dense, agg = self.cfg["control_precision"]
        return [self.readings(self.reference(dense, agg),
                              self.reference())]


def fault_state_unchanged():
    """The optimizer's step returns the weights unchanged."""
    from laplace_gnn_torch.training.marglik_gnn import DeviceAdam
    return patched(DeviceAdam, "step", lambda self: None)


def fault_half_batch():
    """Each step takes the mean loss over half of the training nodes."""
    from laplace_gnn_torch.training import sparse_experiment as se
    orig = se.train_steps

    def half(model, params, opt, idx, yy, n_steps):
        k = idx.shape[0] // 2
        return orig(model, params, opt, idx[:k], yy[:k], n_steps)
    return patched(se, "train_steps", half)


def fault_answer_altered():
    """One leaf's gradient is doubled where the optimizer takes it."""
    from laplace_gnn_torch.training.marglik_gnn import DeviceAdam
    orig = DeviceAdam.step

    def altered(self):
        with torch.no_grad():
            self.params[0].grad.mul_(2.0)
        return orig(self)
    return patched(DeviceAdam, "step", altered)


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_batch": fault_half_batch,
          "answer_altered": fault_answer_altered}


def setup(ctx):
    return TrainEpochs(ctx)
