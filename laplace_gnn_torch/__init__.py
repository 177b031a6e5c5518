"""PyTorch + CUDA port of ``laplace_gnn_tpu`` (Laplace GNNs and graph
structure learning).

Each module sits at the path of its JAX counterpart
(``laplace_gnn_tpu/x/y.py`` -> ``laplace_gnn_torch/x/y.py``); the Pallas
kernels become hand-written CUDA kernels: the aggregation of
``ops/pallas_spmm.py`` behind ``ops/fused_spmm.py``, the flash attention
forward and backward of ``ops/pallas_attention.py`` behind
``ops/flash_attention.py``. The package imports ``torch`` and
``numpy`` only. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .device import resolve_device
from .laplace import (DiagLaplace, DiagLLLaplace, DiagSubnetLaplace,
                      FullLaplace, FullLLLaplace, FullSubnetLaplace,
                      FunctionalLaplace, FunctionalLLLaplace, Kron,
                      KronDecomposed, KronLaplace, KronLLLaplace, Laplace,
                      LowRankLaplace, SubnetLaplace, marglik_training)

__version__ = "0.1.0"

__all__ = ["resolve_device", "DiagLaplace", "DiagLLLaplace",
           "DiagSubnetLaplace", "FullLaplace", "FullLLLaplace",
           "FullSubnetLaplace", "FunctionalLaplace", "FunctionalLLLaplace",
           "Kron", "KronDecomposed", "KronLaplace", "KronLLLaplace",
           "Laplace", "LowRankLaplace", "SubnetLaplace", "marglik_training"]
