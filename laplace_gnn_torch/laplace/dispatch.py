"""``Laplace()``: maps (subset_of_weights, hessian_structure) to a flavour
class (counterpart of ``laplace_gnn_tpu/laplace/dispatch.py``).

Ported: ``("all", "kron" | "full" | "diag")``. Every other flavour of the
JAX package raises ``NotImplementedError`` naming its ROADMAP item."""

from __future__ import annotations

from .flavors import DiagLaplace, FullLaplace, KronLaplace

PORTED = {cls._key: cls for cls in (KronLaplace, FullLaplace, DiagLaplace)}

# the JAX package's other flavours, by the ROADMAP Queue 1 item they wait
# with: LowRank needs the curvature engine's Lanczos and GGN operator
WAITING = {("all", "lowrank"): "14(c)",
           **{key: "14(a)" for key in (
               ("all", "gp"), ("last_layer", "full"), ("last_layer", "kron"),
               ("last_layer", "diag"), ("last_layer", "gp"),
               ("subnetwork", "full"), ("subnetwork", "diag"))}}


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
