"""Laplace approximations. The package imports nothing itself (the KFAC
code imports ``laplace.kron`` while the classes here import the curvature
backends); import the modules: ``laplace.dispatch.Laplace``,
``laplace.flavors.KronLaplace``, ``laplace.kron.Kron``."""
