"""The benchmark's machinery: set-up, traffic, drivers, traces, checks.

Nothing here imports ``jax`` or the JAX package; the plain references
under ``perfbench/reference/`` import nothing of the program either.
"""
