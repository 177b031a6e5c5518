from .interface import (BACKEND_REGISTRY, CurvatureBackend, EFBackend,
                        GGNBackend, HessianBackend)
from .kfac import KFACOperator, compute_kfac_factors

__all__ = ["BACKEND_REGISTRY", "CurvatureBackend", "EFBackend", "GGNBackend",
           "HessianBackend", "KFACOperator", "compute_kfac_factors"]
