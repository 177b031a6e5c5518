"""The device mesh and the placements of a GNN's parameters.

Counterpart of ``laplace_gnn_tpu/parallel/mesh.py`` on
``torch.distributed``: one process per device (SPMD) instead of one
controller over many. The mesh is a ``DeviceMesh`` with the dimensions
``('graph', 'model')``: the graph axis partitions nodes and edges, the
model axis may split feature dimensions. A sharding is a
:class:`NamedSharding`, the mesh with DTensor placements (``Shard(0)`` on
the graph axis is JAX's ``P('graph', None)``).

A value stays whole on every rank outside a sharded body: a placement
says which rows each rank works on inside the body (see
:mod:`laplace_gnn_torch.parallel.collectives`), which keeps every global
computation (the loss, the KFAC curvature) the same program as on one
device.
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

    def put(self, x) -> torch.Tensor:
        """The whole tensor on this rank's device, which the bodies read
        their rows of."""
        return torch.as_tensor(x).to(self.device)


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("graph", "model"),
              model_parallel: int = 1, device=None):
    """Mesh over the run's ``n_devices`` processes (default: all), shaped
    (n_devices // model_parallel, model_parallel).

    One process per device: join the process group first
    (:func:`laplace_gnn_torch.parallel.distributed.initialize`), NCCL on
    ``cuda`` (the default), Gloo with ``device="cpu"``. Raises ValueError
    when ``model_parallel`` does not divide the devices, as JAX's does, or
    when the mesh would leave out processes of the run."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = min(n_devices or world, world)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a run of {world} "
                         f"processes: the mesh spans every process")
    if not dist.is_initialized():
        raise RuntimeError("join a process group first "
                           "(laplace_gnn_torch.parallel.distributed."
                           "initialize)")
    backend = str(dist.get_backend())
    if dev.type == "cuda" and backend != "nccl":
        raise RuntimeError(f"a {dev.type} mesh on a {backend} group: the "
                           f"port routes CUDA tensors through NCCL only")
    if dev.type == "cpu" and backend != "gloo":
        raise RuntimeError(f"a CPU mesh on a {backend} group: CPU tensors "
                           f"go through Gloo")
    if dev.type == "cuda":
        # the card of this process, before the mesh initializes NCCL on it
        index = dev.index
        if index is None:
            index = dist.get_rank() % torch.cuda.device_count()
        torch.cuda.set_device(index)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (n // model_parallel, model_parallel),
                            mesh_dim_names=tuple(axis_names))


def graph_sharding(mesh) -> NamedSharding:
    """Rows (nodes) split over the graph axis: ``P('graph', None)``."""
    return NamedSharding(mesh, (Shard(0), Replicate()))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, (Replicate(), Replicate()))


def shard_gnn_params(mesh, params: dict, model_axis: bool = True) -> dict:
    """``{name: NamedSharding}`` for a BaseGNN params dict, by JAX's rule:
      - adj (N, N): rows over 'graph' (not LoRA's factors);
      - a 2-D weight whose first dimension divides the model axis: that
        dimension over 'model' (tensor parallel) when ``model_axis``;
      - every other leaf: replicated.
    The names are the dotted paths of the JAX pytree."""
    n_model = int(mesh.size(mesh.mesh_dim_names.index("model")))

    def spec_for(path: str, leaf) -> NamedSharding:
        if leaf.ndim == 2 and leaf.shape[0] == leaf.shape[1] \
                and "adj" in path and "lora" not in path:
            return graph_sharding(mesh)
        if model_axis and leaf.ndim == 2 and "weight" in path \
                and leaf.shape[0] % n_model == 0:
            return NamedSharding(mesh, (Replicate(), Shard(0)))
        return replicated(mesh)

    return {name: spec_for(name, leaf) for name, leaf in params.items()}
