"""Privacy (similarity) metrics for placement constraint C2.

Paper metric (CNNs): the *resolution* of a single feature map in the layer's
output grid — below δ = 20x20 px, the user study (Fig. 10/11) shows objects
are no longer identifiable. We keep that metric verbatim, plus SSIM/Pearson
alternatives used for the Fig. 10 proxy benchmark.

LM adaptation (beyond paper): per-block *representation similarity* — the
max-over-tokens cosine similarity between layer-l hidden states and the
input embeddings, computed on a calibration batch. The constraint "may only
leave the trusted domain once Sim < δ" is the same C2, with δ calibrated so
the boundary depth fraction is comparable to the CNN case.

The port's copy of ``repro/core/privacy.py``: the image- and LM-space
metrics run on tensors, on whatever device holds them. JAX's
``image.resize(..., "linear")`` widens its triangle kernel when it
downsamples (antialiasing); its counterpart is ``F.interpolate(mode=
"bilinear", align_corners=False, antialias=True)``, which matches it on
downsampling and on upsampling.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

RESOLUTION_DELTA = 20          # the paper's 20x20 px threshold
LM_SIM_DELTA = 0.5             # calibrated, see EXPERIMENTS.md


def resolution_private(resolution: int, delta: int = RESOLUTION_DELTA) -> bool:
    return resolution < delta


def resolution_similarity(resolution: int, input_resolution: int = 224) -> float:
    """Monotone similarity proxy in [0, 1] from the resolution schedule."""
    return min(1.0, resolution / float(input_resolution))


# ---------------------------------------------------------------------------
# Image-space similarity functions (Fig. 10/11 proxy)
# ---------------------------------------------------------------------------
def pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a.reshape(-1).float()
    b = b.reshape(-1).float()
    a = a - a.mean()
    b = b - b.mean()
    denom = torch.sqrt((a * a).sum() * (b * b).sum()) + 1e-9
    return (a * b).sum() / denom


def ssim(a: torch.Tensor, b: torch.Tensor, *, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2, win: int = 8) -> torch.Tensor:
    """Mean local SSIM over non-overlapping windows. a, b: [H, W] in [0,1].
    Variances are population variances, as ``jnp.var``'s."""
    H, W = a.shape
    h = (H // win) * win
    w = (W // win) * win
    pa = a[:h, :w].reshape(h // win, win, w // win, win).float()
    pb = b[:h, :w].reshape(h // win, win, w // win, win).float()
    mu_a = pa.mean(dim=(1, 3))
    mu_b = pb.mean(dim=(1, 3))
    var_a = pa.var(dim=(1, 3), correction=0)
    var_b = pb.var(dim=(1, 3), correction=0)
    cov = (pa * pb).mean(dim=(1, 3)) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return s.mean()


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, ..., "linear")`` over the last two dims of
    ``x`` [..., H, W] (antialiased when it downsamples)."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, *x.shape[-2:]), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(*lead, *size)


def downsample_similarity(image: torch.Tensor, resolution: int,
                          metric: str = "ssim") -> float:
    """How identifiable a [H, W] image remains after being forced through a
    ``resolution``-sized representation (downsample → upsample → compare)."""
    H, W = image.shape
    small = resize_linear(image.float(), (resolution, resolution))
    back = resize_linear(small, (H, W))
    if metric == "ssim":
        return float(ssim(image, back))
    return float(pearson(image, back))


# ---------------------------------------------------------------------------
# LM adaptation: representation similarity profile
# ---------------------------------------------------------------------------
def lm_similarity_profile(hidden_states: torch.Tensor) -> np.ndarray:
    """hidden_states: [L+1, B, S, D] (entry 0 = input embeddings).

    Returns sim[l] = max over tokens of |cos(h_l, h_0)| for l = 1..L —
    the paper's max-over-dataset aggregation (Sec. IV, NN Layer Profile #4).
    """
    h = hidden_states.float()
    h0 = h[0]
    h0n = h0 / (torch.linalg.vector_norm(h0, dim=-1, keepdim=True) + 1e-9)
    hn = h[1:] / (torch.linalg.vector_norm(h[1:], dim=-1, keepdim=True)
                  + 1e-9)
    cos = torch.abs(torch.einsum("lbsd,bsd->lbs", hn, h0n))
    return cos.amax(dim=(1, 2)).cpu().numpy()


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
