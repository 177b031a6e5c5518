from .activation_hessian import ActivationHessianOperator
from .base import LinearOperator, PyTreeOperator
from .estimators import (HutchinsonDiagonalEstimator,
                         HutchinsonSquaredFrobeniusNormEstimator,
                         HutchinsonTraceEstimator, HutchPPTraceEstimator,
                         hutchinson_diag, hutchinson_squared_fro,
                         hutchinson_trace, hutchpp_trace, random_probes)
from .inverse import (CGInverseOperator, KFACInverseOperator,
                      LSMRInverseOperator, NeumannInverseOperator, lsmr)
from .spectrum import (LanczosApproximateLogSpectrumCached,
                       LanczosApproximateSpectrumCached,
                       approximate_boundaries, approximate_boundaries_abs,
                       fast_lanczos, lanczos_approximate_log_spectrum,
                       lanczos_approximate_log_spectrum_from_iter,
                       lanczos_approximate_spectrum,
                       lanczos_approximate_spectrum_from_iter, lanczos_eigh,
                       lanczos_spectrum, lanczos_tridiag)
from .interface import (BACKEND_REGISTRY, CurvatureBackend, EFBackend,
                        GGNBackend, HessianBackend)
from .kfac import KFACOperator, compute_kfac_factors
from .losses import (cross_entropy_sum, get_loss_fn, likelihood_factor,
                     loss_hessian, loss_hessian_diag, loss_hessian_mvp,
                     loss_hessian_sqrt, mse_sum)
from .operators import (DiagShiftOperator, EFOperator, FisherMCOperator,
                        GGNOperator, HessianOperator, JacobianOperator,
                        OuterProductOperator, Projector, ScaledOperator,
                        SubmatrixOperator, SumOperator,
                        TransposedJacobianOperator)
