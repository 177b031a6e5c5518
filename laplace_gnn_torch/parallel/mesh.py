"""The device mesh and the placements of a GNN's parameters.

Counterpart of ``laplace_gnn_tpu/parallel/mesh.py`` on
``torch.distributed``: one process per device (SPMD) instead of one
controller over many. The mesh is a ``DeviceMesh`` with the dimensions
``('graph', 'model')`` (or the hybrid ``('dcn', 'graph', 'model')`` of
:mod:`.distributed`): the graph axis partitions nodes and edges. A
sharding is a :class:`NamedSharding`, the mesh with DTensor placements
(``Shard(0)`` on the graph axis is JAX's ``P('graph', None)``).

A value placed on the graph axis is held as the rank's contiguous block
of rows (the rows JAX's plans give the rank: ``plan["block"]`` of
:mod:`.partition` / :mod:`.sharded`); every other axis holds it whole. So
a graph's features, its activations and a dense adjacency's rows divide
over the graph ranks, and what each rank holds falls with their number.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ..device import resolve_device


@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and one placement per mesh dimension."""
    mesh: object
    placements: tuple

    @property
    def spec(self) -> tuple:
        """JAX's ``PartitionSpec`` of a 2-D leaf as a tuple: the mesh axis
        that splits each dimension, None where none does (``('graph',
        None)`` for rows on the graph axis); ``()`` is replicated."""
        dims = {}
        for name, p in zip(self.mesh.mesh_dim_names, self.placements):
            if isinstance(p, Shard):
                dims[p.dim] = name
        spec = [dims.get(i) for i in range(max(dims, default=-1) + 1)]
        return tuple(spec + ([None] if spec else []))

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    @property
    def rows_on(self) -> Optional[str]:
        """The mesh axis whose ranks split this value's rows, or None."""
        for name, p in zip(self.mesh.mesh_dim_names, self.placements):
            if name == "graph" and isinstance(p, Shard) and p.dim == 0:
                return name
        return None

    def put(self, x) -> torch.Tensor:
        """This rank's part of ``x`` on its device: its contiguous block of
        rows for a graph-axis placement (the rows must divide over the
        ranks), else ``x`` whole. A copy: the whole value is not kept."""
        x = torch.as_tensor(x)
        if self.rows_on is not None:
            from .collectives import mesh_axis
            x = rank_rows(x, mesh_axis(self.mesh, self.rows_on))
        return x.to(self.device, copy=True)


def rank_rows(x: torch.Tensor, ax) -> torch.Tensor:
    """Rank ``ax.index``'s contiguous block of the rows of a whole ``x``
    (a view)."""
    n = x.shape[0]
    if n % ax.size:
        raise ValueError(f"{n} rows do not divide over the {ax.size} ranks "
                         f"of axis {ax.name!r} (pad the graph first)")
    b = n // ax.size
    return x[ax.index * b:(ax.index + 1) * b]


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("graph", "model"),
              model_parallel: int = 1, device=None,
              allow_fake: bool = False):
    """Mesh over the run's ``n_devices`` processes (default: all), shaped
    (n_devices // model_parallel, model_parallel).

    One process per device: join the process group first
    (:func:`laplace_gnn_torch.parallel.distributed.initialize`), NCCL on
    ``cuda`` (the default), Gloo with ``device="cpu"``; a ``fake`` group
    (one rank alone at its real shapes, nothing moved) only with
    ``allow_fake=True``. Raises ValueError when ``model_parallel`` does
    not divide the devices, as JAX's does, or when the mesh would leave
    out processes of the run."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = min(n_devices or world, world)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a run of {world} "
                         f"processes: the mesh spans every process")
    check_group(dev, allow_fake)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axis_names))


def check_group(dev: torch.device, allow_fake: bool = False) -> None:
    """Raise unless the run's process group carries ``dev``'s tensors
    (NCCL for ``cuda``, Gloo for the CPU, or a fake group when allowed);
    on ``cuda``, select this process's card."""
    if not dist.is_initialized():
        raise RuntimeError("join a process group first "
                           "(laplace_gnn_torch.parallel.distributed."
                           "initialize)")
    backend = str(dist.get_backend())
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want and not (allow_fake and backend == "fake"):
        raise RuntimeError(f"a {dev.type} mesh on a {backend} group: "
                           f"{dev.type} tensors go through {want} only")
    if dev.type == "cuda":
        # the card of this process, before the mesh initializes NCCL on it
        index = dev.index
        if index is None:
            index = dist.get_rank() % torch.cuda.device_count()
        torch.cuda.set_device(index)


def _on_axis(mesh, axis: str) -> NamedSharding:
    """Dim 0 split over ``axis``, whole over the mesh's other axes."""
    return NamedSharding(mesh, tuple(
        Shard(0) if name == axis else Replicate()
        for name in mesh.mesh_dim_names))


def graph_sharding(mesh) -> NamedSharding:
    """Rows (nodes) split over the graph axis: ``P('graph', None)``."""
    return _on_axis(mesh, "graph")


def replicated(mesh) -> NamedSharding:
    return _on_axis(mesh, None)


def shard_gnn_params(mesh, params: dict, model_axis: bool = True) -> dict:
    """``{name: NamedSharding}`` for a BaseGNN params dict, by JAX's rule:
      - adj (N, N): rows over 'graph' (not LoRA's factors);
      - a 2-D weight whose first dimension divides the model axis: that
        dimension over 'model' (tensor parallel) when ``model_axis``;
      - every other leaf: replicated.
    The names are the dotted paths of the JAX pytree. The 'model' axis is
    a placement only: :meth:`NamedSharding.put` keeps such a weight whole
    on every rank (the weights are small beside the N x N adjacency)."""
    n_model = int(mesh.size(mesh.mesh_dim_names.index("model")))

    def spec_for(path: str, leaf) -> NamedSharding:
        if leaf.ndim == 2 and leaf.shape[0] == leaf.shape[1] \
                and "adj" in path and "lora" not in path:
            return graph_sharding(mesh)
        if model_axis and leaf.ndim == 2 and "weight" in path \
                and leaf.shape[0] % n_model == 0:
            return _on_axis(mesh, "model")
        return replicated(mesh)

    return {name: spec_for(name, leaf) for name, leaf in params.items()}
