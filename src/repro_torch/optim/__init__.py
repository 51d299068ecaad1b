"""Optimizers and sparse pool gradients (port of ``repro.optim``)."""
