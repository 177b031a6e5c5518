from .marglik_gnn import (TrainingPrograms, fit_laplace, make_neg_marglik_fn,
                          marglik_optimization, marglik_optimization_scan,
                          mc_eval, mean_eval)
from .evaluate import evaluate_map, evaluate_predictive, validate

__all__ = ["TrainingPrograms", "fit_laplace", "make_neg_marglik_fn",
           "marglik_optimization", "marglik_optimization_scan", "mc_eval",
           "mean_eval", "evaluate_map", "evaluate_predictive", "validate"]
