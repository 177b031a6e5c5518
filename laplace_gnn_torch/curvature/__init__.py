from .interface import CurvatureBackend, GGNBackend
from .kfac import compute_kfac_factors

__all__ = ["CurvatureBackend", "GGNBackend", "compute_kfac_factors"]
