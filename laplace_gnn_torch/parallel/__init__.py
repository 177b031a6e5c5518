"""Multi-process launch (counterpart of ``laplace_gnn_tpu/parallel``).

Only :func:`~laplace_gnn_torch.parallel.distributed.initialize` is ported
so far; the mesh, partition, sharded and scaling modules are still to
come."""

from .distributed import initialize

__all__ = ["initialize"]
