"""Privacy (similarity) constants and the host-side helpers the planner
reaches (placement constraint C2).

Paper metric (CNNs): the *resolution* of a single feature map in the layer's
output grid — below δ = 20x20 px, the user study (Fig. 10/11) shows objects
are no longer identifiable. LM adaptation: per-block representation
similarity against the input embeddings, with δ = ``LM_SIM_DELTA``.

The host part of ``repro/core/privacy.py``. Its image- and LM-space
similarity metrics (``pearson``, ``ssim``, ``downsample_similarity``,
``lm_similarity_profile``) run on device arrays and are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

RESOLUTION_DELTA = 20          # the paper's 20x20 px threshold
LM_SIM_DELTA = 0.5             # calibrated, see EXPERIMENTS.md


def resolution_private(resolution: int, delta: int = RESOLUTION_DELTA) -> bool:
    return resolution < delta


def resolution_similarity(resolution: int, input_resolution: int = 224) -> float:
    """Monotone similarity proxy in [0, 1] from the resolution schedule."""
    return min(1.0, resolution / float(input_resolution))


def cut_exposure(similarity: float, out_bytes: float) -> float:
    """Leakage price of an activation crossing into an untrusted domain:
    similarity-weighted exposed bytes. A cut whose activation still
    resembles the input (sim -> 1) exposes its full byte volume; a private
    representation (sim -> 0) prices near zero. Used by
    ``planner.spec.PlacementSpec.cut_costs`` to make every trust-boundary
    crossing carry an explicit leakage cost next to its transfer cost."""
    return max(0.0, min(1.0, similarity)) * max(0.0, out_bytes)


def private_depth(similarities: Sequence[float], delta: float) -> int:
    """First block index after which the representation is private, i.e. the
    minimum number of leading blocks that MUST stay in a trusted domain."""
    for i, s in enumerate(similarities):
        if s < delta:
            return i + 1
    return len(similarities)
