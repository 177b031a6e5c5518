"""PyTorch + CUDA port of ``laplace_gnn_tpu`` (Laplace GNNs and graph
structure learning).

Each module sits at the path of its JAX counterpart
(``laplace_gnn_tpu/x/y.py`` -> ``laplace_gnn_torch/x/y.py``); the Pallas
aggregation kernel ``ops/pallas_spmm.py`` becomes the hand-written CUDA
kernel behind ``ops/fused_spmm.py``. The package imports ``torch`` and
``numpy`` only. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
