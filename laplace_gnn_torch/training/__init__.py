from .marglik_gnn import (TrainingPrograms, fit_laplace, make_neg_marglik_fn,
                          marglik_optimization, marglik_optimization_scan,
                          mc_eval, mean_eval)

__all__ = ["TrainingPrograms", "fit_laplace", "make_neg_marglik_fn",
           "marglik_optimization", "marglik_optimization_scan", "mc_eval",
           "mean_eval"]
