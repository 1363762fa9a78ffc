"""Compute ops in plain ``jax.numpy``, each with a brute-force or NumPy
oracle in the tests (SURVEY.md §4); XLA compiles and fuses them for the
device.
"""

from .interaction import fm_interaction, fm_interaction_bruteforce
from .scatter import dedupe_grads, scatter_add_dedup, segment_sum_dense

__all__ = [
    "fm_interaction",
    "fm_interaction_bruteforce",
    "dedupe_grads",
    "scatter_add_dedup",
    "segment_sum_dense",
]
