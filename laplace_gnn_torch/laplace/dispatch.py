"""``Laplace()``: maps (subset_of_weights, hessian_structure) to a flavour
class (counterpart of ``laplace_gnn_tpu/laplace/dispatch.py``).

Every flavour of the JAX package is ported; ``WAITING`` (keys still to
port, each raising ``NotImplementedError`` naming its ROADMAP item) is
empty."""

from __future__ import annotations

from .flavors import DiagLaplace, FullLaplace, KronLaplace, LowRankLaplace
from .functional import FunctionalLaplace, FunctionalLLLaplace
from .lllaplace import DiagLLLaplace, FullLLLaplace, KronLLLaplace
from .subnet import DiagSubnetLaplace, FullSubnetLaplace

PORTED = {cls._key: cls for cls in (
    KronLaplace, FullLaplace, DiagLaplace, LowRankLaplace, FullLLLaplace,
    KronLLLaplace, DiagLLLaplace, FullSubnetLaplace, DiagSubnetLaplace,
    FunctionalLaplace, FunctionalLLLaplace)}

WAITING: dict = {}


def Laplace(model, params, likelihood: str,
            subset_of_weights: str = "last_layer",
            hessian_structure: str = "kron",
            *args, **kwargs):
    """Simplified Laplace access with the explicit ``params`` dict after
    ``model``, as in the JAX package."""
    if subset_of_weights == "subnetwork" and hessian_structure not in ("full",
                                                                       "diag"):
        raise ValueError("Subnetwork Laplace requires a full or diagonal "
                         "Hessian approximation!")
    key = (subset_of_weights, hessian_structure)
    if key in PORTED:
        return PORTED[key](model, params, likelihood, *args, **kwargs)
    if key in WAITING:
        raise NotImplementedError(
            f"the Laplace flavour {key} is not ported yet (ROADMAP Queue 1 "
            f"item {WAITING[key]}); ported: {sorted(PORTED)}")
    raise ValueError(f"No Laplace flavor for {key}.")
