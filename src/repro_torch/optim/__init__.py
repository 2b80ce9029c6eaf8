"""Optimizer of the port. ``optim/compression.py`` (the compressed
cross-pod gradient exchange) exists only across pods and comes with
multi-card placement (ROADMAP queue 1, item 10)."""
from .adamw import AdamWConfig, AdamWState, init, update, schedule, global_norm
