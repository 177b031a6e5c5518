"""Full-batch training epochs of a 32-layer GCNII, one a unit.

As ``sparse_train``: set-up parses the sparse CLI's flags first (so a
program without the model refuses the cell at once), makes a seeded graph
at the configuration's shape on the device, builds the graph container
and the model through the sparse CLI's own pieces
(``training/sparse_experiment.py``: ``build_graph``, ``build_model`` with
the configuration's ``model_options``, ``DeviceAdam`` over the model's
``param_groups``), draws GCNII-named weights on the device from the seed
and drives the training object through its first three steps with the
window's own call (``train_steps`` of one step), recording each step's
loss, the first step's gradient as the program formed it (``p.grad``, the
weight decay not added) and the weights after the third step. The window
then goes on with the same object. The check runs the plain reference
over the same three steps from the same weights."""

from __future__ import annotations

import contextlib
import math
import os
import types

import torch

from benchlib import gcnii_counts, graphs
from benchlib.drive import load, patched

_train = load(types.SimpleNamespace(
    bench_dir=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "drivers", "sparse_train")
N_CHECKED_STEPS = _train.N_CHECKED_STEPS


def gcnii_weights(seed: int, cfg: dict, device) -> dict:
    """Every weight of the configuration's GCNII, named as the model names
    them, in float32 on the device, drawn from the seed: the input and
    output Linears' weights and biases uniform in +-1/sqrt(fan_in), each
    conv's weight uniform in +-1/sqrt(hidden) (the source's
    1/sqrt(out_features) of a square weight)."""
    g = graphs.generator(seed, device, "gcnii_weights")

    def uniform(shape, fan_in):
        bound = 1 / math.sqrt(fan_in)
        u = torch.rand(shape, generator=g, device=device)
        return u * (2 * bound) - bound

    f, h, c = cfg["n_features"], cfg["hidden_channels"], cfg["n_classes"]
    L = int(cfg["num_layers"])
    out = {"convs.0.lin.weight": uniform((h, f), f),
           "convs.0.lin.bias": uniform((h,), f)}
    for l in range(1, L + 1):
        out[f"convs.{l}.lin.weight"] = uniform((h, h), h)
    out[f"convs.{L + 1}.lin.weight"] = uniform((c, h), h)
    out[f"convs.{L + 1}.lin.bias"] = uniform((c,), h)
    return out


def build_program(cell, ctx) -> None:
    """Set on ``cell``: the seeded graph (``x``, ``y``, ``edge_index``),
    the program's graph container and model built by the sparse CLI's
    pieces, the weights (``weights0``, and ``params`` that train), the
    optimizer over the model's two weight-decay groups, and the split
    (``train_idx`` and ``test_idx``, from one seeded permutation)."""
    from laplace_gnn_torch.training import sparse_experiment as se
    from laplace_gnn_torch.training.marglik_gnn import DeviceAdam
    cell.ctx, cell.se = ctx, se
    cfg = cell.cfg = ctx.config
    dev = cell.dev = ctx.device
    argv = ["--model_type", cfg["model_type"],
            "--hidden_channels", str(cfg["hidden_channels"]),
            "--num_layers", str(cfg["num_layers"]),
            "--lr", str(cfg["lr"]), "--agg_dtype", cfg["agg_dtype"]]
    cell.args = se.argument_parser().parse_args(argv)
    n, f, c = cfg["n_nodes"], cfg["n_features"], cfg["n_classes"]
    cell.x, cell.y, cell.edge_index = graphs.arxiv_like(
        ctx.seed, n, f, c, cfg["n_undirected_draws"], cfg["max_degree"],
        dev)
    data = types.SimpleNamespace(
        edge_index=cell.edge_index.cpu().numpy(), num_nodes=n,
        num_features=f, num_classes=c, x=cell.x)
    cell.graph = se.build_graph(cell.args, data, device=dev)
    cell.model = se.build_model(cell.args, data, cell.graph, device=dev,
                                **cfg["model_options"])
    cell.weights0 = gcnii_weights(ctx.seed, cfg, dev)
    cell.params = {k: v.clone().requires_grad_(True)
                   for k, v in cell.weights0.items()}
    cell.opt = DeviceAdam(cell.model.param_groups(cell.params), lr=cfg["lr"])
    n_test = n - cfg["n_train"] - cfg["n_val"]
    cell.train_idx, _, cell.test_idx = graphs.node_split(
        ctx.seed, n, (cfg["n_train"], cfg["n_val"], n_test), dev)
    cell.y_train = cell.y[cell.train_idx]


class GcniiTrainEpochs(_train.TrainEpochs):

    def __init__(self, ctx):
        build_program(self, ctx)
        self.first = self._first_steps()

    def _first_steps(self) -> dict:
        """The first steps through the window's own call; the first
        gradient is each weight's ``grad`` as ``train_steps`` set it (the
        optimizer adds the weight decay to a copy)."""
        losses = []
        with patched(self.se, "F", _train._RecordingF(self.se.F, losses)):
            self.unit(-3)
            grad1 = {k: p.grad.double().cpu()
                     for k, p in self.params.items()}
            for i in range(N_CHECKED_STEPS - 1):
                self.unit(i - 2)
        return {"losses": [float(v) for v in losses], "grad1": grad1,
                "params": {k: v.detach().double().cpu()
                           for k, v in self.params.items()}}

    @contextlib.contextmanager
    def traced(self, spans):
        """The epoch's model operations, from the shapes
        (``benchlib.gcnii_counts``); the convs' and the SpMMs' device
        time is read from the program's own spans."""
        counters = {}
        yield counters
        cfg = self.cfg
        counters["model_flops_per_unit"] = gcnii_counts.epoch_flops(
            self.graph.n_nodes, self.graph.n_edges, cfg["n_features"],
            cfg["hidden_channels"], cfg["n_classes"], cfg["num_layers"])


def _each_conv(setting: str, value: float):
    """The model that ``build_model`` returns with ``setting`` of every
    GCNII conv set to ``value``."""
    from laplace_gnn_torch.training import sparse_experiment as se
    orig = se.build_model

    def built(*args, **kwargs):
        model = orig(*args, **kwargs)
        for conv in model.convs[1:-1]:
            setattr(conv, setting, value)
        return model
    return patched(se, "build_model", built)


def fault_initial_residual_dropped():
    """Every layer reads its predecessor alone (alpha = 0)."""
    return _each_conv("alpha", 0.0)


def fault_identity_map_dropped():
    """Every layer's product is the plain ``S W`` (theta = 1)."""
    return _each_conv("theta", 1.0)


FAULTS = {"state_unchanged": _train.fault_state_unchanged,
          "half_batch": _train.fault_half_batch,
          "answer_altered": _train.fault_answer_altered,
          "initial_residual_dropped": fault_initial_residual_dropped,
          "identity_map_dropped": fault_identity_map_dropped}


def setup(ctx):
    return GcniiTrainEpochs(ctx)
