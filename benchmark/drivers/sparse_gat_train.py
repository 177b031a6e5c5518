"""Full-batch training epochs of a multi-head sparse GAT, one a unit.

As ``sparse_train``: set-up makes a seeded graph at the configuration's
shape on the device, builds the graph container and the model through
the sparse CLI's own pieces (``training/sparse_experiment.py``:
``build_graph``, ``build_model`` with the configuration's
``model_options``, ``DeviceAdam``), draws GAT-named weights on the device
from the seed and drives the training object through its first three
steps with the window's own call (``train_steps`` of one step),
recording each step's loss, the first gradient as the optimizer holds it
and the weights after the third step. The window then goes on with the
same object. The check runs the plain reference over the same three
steps from the same weights."""

from __future__ import annotations

import contextlib
import math
import os
import types

import torch

from benchlib import compare, gat_counts, graphs
from benchlib.drive import load, patched

_train = load(types.SimpleNamespace(
    bench_dir=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "drivers", "sparse_train")
N_CHECKED_STEPS = _train.N_CHECKED_STEPS


def gat_weights(seed: int, cfg: dict, device) -> dict:
    """Every weight of the configuration's GAT, named as the model names
    them, in float32 on the device, drawn from the seed as the program's
    init draws them: each Linear's weight (and the residual Linears' bias)
    uniform in +-1/sqrt(fan_in), the attention vectors uniform in
    +-sqrt(6 / (1 + heads * width)); each conv's bias zero, each
    BatchNorm's weight one and bias zero."""
    g = graphs.generator(seed, device, "gat_weights")

    def uniform(shape, bound):
        u = torch.rand(shape, generator=g, device=device)
        return u * (2 * bound) - bound

    out = {}
    layer_list = gat_counts.layers(cfg)
    for k, (i, h, f, res) in enumerate(layer_list):
        last = k == len(layer_list) - 1
        out[f"convs.{k}.lin.weight"] = uniform((h * f, i), 1 / math.sqrt(i))
        bound = math.sqrt(6.0 / (1 + h * f))
        out[f"convs.{k}.att_src"] = uniform((1, h, f), bound)
        out[f"convs.{k}.att_dst"] = uniform((1, h, f), bound)
        out[f"convs.{k}.bias"] = torch.zeros(f if last else h * f,
                                             device=device)
    for k, (i, h, f, res) in enumerate(layer_list[:-1]):
        if res:
            out[f"res.{k}.weight"] = uniform((h * f, i), 1 / math.sqrt(i))
            out[f"res.{k}.bias"] = uniform((h * f,), 1 / math.sqrt(i))
        if cfg.get("norm") == "batch":
            out[f"norms.{k}.weight"] = torch.ones(h * f, device=device)
            out[f"norms.{k}.bias"] = torch.zeros(h * f, device=device)
    return out


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
            "--heads", str(cfg["heads"]),
            "--lr", str(cfg["lr"]), "--agg_dtype", cfg["agg_dtype"]]
    cell.args = se.argument_parser().parse_args(argv)
    data = types.SimpleNamespace(
        edge_index=cell.edge_index.cpu().numpy(), num_nodes=n,
        num_features=f, num_classes=c, x=cell.x)
    cell.graph = se.build_graph(cell.args, data, device=dev)
    cell.model = se.build_model(cell.args, data, cell.graph, device=dev,
                                **cfg["model_options"])
    cell.weights0 = gat_weights(ctx.seed, cfg, dev)
    cell.params = {k: v.clone().requires_grad_(True)
                   for k, v in cell.weights0.items()}
    cell.opt = DeviceAdam(cell.params.values(), lr=cfg["lr"])
    n_test = n - cfg["n_train"] - cfg["n_val"]
    cell.train_idx, _, cell.test_idx = graphs.node_split(
        ctx.seed, n, (cfg["n_train"], cfg["n_val"], n_test), dev)
    cell.y_train = cell.y[cell.train_idx]


class GatTrainEpochs(_train.TrainEpochs):

    def __init__(self, ctx):
        build_program(self, ctx)
        self.first = self._first_steps()

    @contextlib.contextmanager
    def traced(self, spans):
        """The epoch's attention bound and model operations, from the
        shapes (``benchlib.gat_counts``); the attention's device time is
        read from the program's own spans."""
        counters = {}
        yield counters
        g = self.graph
        layer_list = gat_counts.layers(self.cfg)
        value_bytes = torch.tensor([], dtype=getattr(
            torch, self.cfg["agg_dtype"])).element_size()
        counters["attention_bound_s_per_unit"] = \
            gat_counts.attention_bound_s(g.n_edges, g.n_nodes, layer_list,
                                         value_bytes)
        counters["model_flops_per_unit"] = gat_counts.epoch_flops(
            g.n_nodes, g.n_edges, layer_list)

    def readings(self, out: dict, ref: dict) -> dict:
        """As ``sparse_train``'s, with the leaves whose reference gradient
        is nought to rounding (a bias followed by BatchNorm, which
        cancels it) left out of ``grad_diff_gap`` as of
        ``change_norm_gap``."""
        gnorm = {k: float(v.norm()) for k, v in ref["grad1"].items()}
        med = sorted(gnorm.values())[len(gnorm) // 2]
        return dict(super().readings(out, ref), grad_diff_gap=max(
            compare.relative_gap(out["grad1"][k], ref["grad1"][k])
            for k, v in gnorm.items() if v >= 1e-3 * med))


@contextlib.contextmanager
def fault_attention_uniform():
    """Every layer's edge softmax ignores its scores (each destination's
    neighbours weighted alike)."""
    from laplace_gnn_torch.models import sparse_gnn as sg

    def flat(attention):
        def run(g, *args):
            *head, h, a_src, a_dst, slope = args
            return attention(g, *head, h, a_src * 0, a_dst * 0, slope)
        return run
    with patched(sg, "ell_gat_attention", flat(sg.ell_gat_attention)), \
            patched(sg, "segment_attention", flat(sg.segment_attention)):
        yield


FAULTS = {"state_unchanged": _train.fault_state_unchanged,
          "half_batch": _train.fault_half_batch,
          "answer_altered": _train.fault_answer_altered,
          "attention_uniform": fault_attention_uniform}


def setup(ctx):
    return GatTrainEpochs(ctx)
