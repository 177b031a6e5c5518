"""Laplace approximations (counterpart of ``laplace_gnn_tpu/laplace``):
the base classes, the ``Laplace`` dispatcher, the parametric,
last-layer, subnetwork and functional (GP) flavours, the Kronecker
factors, ``marglik_training`` and the predictives."""

from .base import BaseLaplace, ParametricLaplace
from .dispatch import Laplace
from .enums import (HessianStructure, LinkApprox, Likelihood, PredType,
                    PriorStructure, SubsetOfWeights, TuningMethod)
from .flavors import DiagLaplace, FullLaplace, KronLaplace, LowRankLaplace
from .functional import FunctionalLaplace, FunctionalLLLaplace
from .kron import Kron, KronDecomposed
from .lllaplace import DiagLLLaplace, FullLLLaplace, KronLLLaplace
from .marglik import marglik_training
from .predictive import (bridge_predictive, glm_classification_predictive,
                         mc_predictive, probit_predictive)
from .subnet import (DiagSubnetLaplace, FullSubnetLaplace,
                     LargestMagnitudeSubnetMask,
                     LargestVarianceDiagLaplaceSubnetMask,
                     LargestVarianceSWAGSubnetMask, LastLayerSubnetMask,
                     ModuleNameSubnetMask, ParamNameSubnetMask,
                     RandomSubnetMask, SubnetLaplace, SubnetMask)

__all__ = [
    "BaseLaplace", "ParametricLaplace", "Laplace", "HessianStructure",
    "LinkApprox", "Likelihood", "PredType", "PriorStructure",
    "SubsetOfWeights", "TuningMethod", "DiagLaplace", "FullLaplace",
    "KronLaplace", "LowRankLaplace", "FunctionalLaplace",
    "FunctionalLLLaplace", "Kron", "KronDecomposed", "DiagLLLaplace",
    "FullLLLaplace", "KronLLLaplace", "marglik_training",
    "bridge_predictive", "glm_classification_predictive", "mc_predictive",
    "probit_predictive", "DiagSubnetLaplace", "FullSubnetLaplace",
    "LargestMagnitudeSubnetMask", "LargestVarianceDiagLaplaceSubnetMask",
    "LargestVarianceSWAGSubnetMask", "LastLayerSubnetMask",
    "ModuleNameSubnetMask", "ParamNameSubnetMask", "RandomSubnetMask",
    "SubnetLaplace", "SubnetMask"]
