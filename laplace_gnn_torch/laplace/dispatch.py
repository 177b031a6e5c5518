"""``Laplace()``: maps (subset_of_weights, hessian_structure) to a flavour
class (counterpart of ``laplace_gnn_tpu/laplace/dispatch.py``).

Ported: ``("all", "kron")``. Every other flavour of the JAX package raises
``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

from .flavors import KronLaplace

PORTED = {("all", "kron"): KronLaplace}

# the JAX package's other flavours, each waiting with ROADMAP Queue 1
# item 14(a)
WAITING = {("all", "full"), ("all", "diag"), ("all", "lowrank"),
           ("all", "gp"), ("last_layer", "full"), ("last_layer", "kron"),
           ("last_layer", "diag"), ("last_layer", "gp"),
           ("subnetwork", "full"), ("subnetwork", "diag")}


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
            f"item 14(a)); ported: {sorted(PORTED)}")
    raise ValueError(f"No Laplace flavor for {key}.")
