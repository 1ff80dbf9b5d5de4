"""Hyperparameter sweeps (the port of the JAX package's `tune/`)."""
