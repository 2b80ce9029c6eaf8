"""The paper's evaluation CNNs as coarse layer tables + a tiny runnable CNN
(the port's copy of ``repro/models/cnn.py``).

Serdab's placement operates on per-layer profiles: execution cost, output
bytes, and output *resolution* (the privacy metric). The tables below encode
the five models from Sec. VI with architecture-exact resolution schedules and
architecture-derived FLOP/parameter estimates (224x224x3 input); every number
is the reference's.

``TinyCNN`` is a runnable conv stack matching a table's resolution schedule
(reduced channels) — used to validate the resolution privacy metric on real
feature maps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.privacy import resize_linear
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CnnLayer:
    name: str
    resolution: int          # spatial side of one feature map in the grid
    flops: float             # fwd FLOPs for one 224x224 frame
    out_bytes: float         # activation bytes (fp32)
    params_bytes: float
    eff: float = 1.0         # CPU/TEE GEMM efficiency (depthwise convs and
                             # low-channel layers run far below peak in
                             # TFLite; TPU/GPU engines unaffected)


def _layer(name, res, flops_m, out_ch, params_kb, eff=1.0) -> CnnLayer:
    return CnnLayer(name, res, flops_m * 1e6, res * res * out_ch * 4,
                    params_kb * 1e3, eff)


# ---------------------------------------------------------------------------
# Layer tables (coarse blocks = the paper's partition points)
# ---------------------------------------------------------------------------
ALEXNET = [
    _layer("conv1", 55, 105, 96, 140),
    _layer("pool1", 27, 1, 96, 0),
    _layer("conv2", 27, 224, 256, 1229),  # groups=2
    _layer("pool2", 13, 1, 256, 0),
    _layer("conv3", 13, 150, 384, 3540),
    _layer("conv4", 13, 112, 384, 2655),  # groups=2
    _layer("conv5", 13, 75, 256, 1770),   # groups=2
    _layer("pool5", 6, 1, 256, 0),
    _layer("fc6", 1, 75, 4096, 151000),
    _layer("fc7", 1, 33, 4096, 67000),
    _layer("fc8", 1, 8, 1000, 16400),
]  # ~244 MB params, ~0.78 GFLOPs (grouped convs)

RESNET50 = (
    [_layer("conv1", 112, 118, 64, 38), _layer("pool1", 56, 2, 64, 0)]
    + [_layer(f"res2{c}", 56, 227, 256, 300) for c in "abc"]
    + [_layer(f"res3{c}", 28, 260, 512, 1220) for c in "abcd"]
    + [_layer(f"res4{c}", 14, 245, 1024, 4730) for c in "abcdef"]
    + [_layer(f"res5{c}", 7, 270, 2048, 19900) for c in "abc"]
    + [_layer("fc", 1, 4, 1000, 8200)]
)  # ~102 MB params, ~4.1 GFLOPs

GOOGLENET = [
    _layer("conv1", 112, 118, 64, 38),
    _layer("pool1", 56, 2, 64, 0),
    _layer("conv2", 56, 720, 192, 460),
    _layer("pool2", 28, 1, 192, 0),
    _layer("inc3a", 28, 128, 256, 1070),
    _layer("inc3b", 28, 304, 480, 1540),
    _layer("pool3", 14, 1, 480, 0),
    _layer("inc4a", 14, 73, 512, 1500),
    _layer("inc4b", 14, 88, 512, 1770),
    _layer("inc4c", 14, 100, 512, 2050),
    _layer("inc4d", 14, 119, 528, 2340),
    _layer("inc4e", 14, 170, 832, 3330),
    _layer("pool4", 7, 1, 832, 0),
    _layer("inc5a", 7, 71, 832, 4160),
    _layer("inc5b", 7, 97, 1024, 5550),
    _layer("fc", 1, 2, 1000, 4100),
]  # ~28 MB params, ~1.6 GFLOPs

_MBN = [  # (res, ch, flops_m, params_kb, eff) per separable block
    (112, 64, 58, 9, 0.25), (56, 128, 55, 34, 0.25), (56, 128, 110, 84, 0.25),
    (28, 256, 53, 180, 0.5), (28, 256, 106, 430, 0.5), (14, 512, 52, 830, 1.0),
    (14, 512, 105, 2150, 1.0), (14, 512, 105, 2150, 1.0),
    (14, 512, 105, 2150, 1.0), (14, 512, 105, 2150, 1.0),
    (14, 512, 105, 2150, 1.0), (7, 1024, 52, 4240, 1.0),
    (7, 1024, 104, 8480, 1.0),
]
MOBILENET = (
    [_layer("conv1", 112, 22, 32, 4, 0.5)]
    + [_layer(f"sep{i+2}", r, f, c, p, e) for i, (r, c, f, p, e) in enumerate(_MBN)]
    + [_layer("fc", 1, 2, 1000, 4100)]
)  # ~17 MB params, ~1.14 GFLOPs (569M MACs)

SQUEEZENET = [
    _layer("conv1", 111, 347, 96, 56),
    _layer("pool1", 55, 1, 96, 0),
    _layer("fire2", 55, 93, 128, 47),
    _layer("fire3", 55, 104, 128, 50),
    _layer("fire4", 55, 180, 256, 150),
    _layer("pool4", 27, 1, 256, 0),
    _layer("fire5", 27, 93, 256, 178),
    _layer("fire6", 27, 65, 384, 290),
    _layer("fire7", 27, 74, 384, 330),
    _layer("fire8", 27, 118, 512, 530),
    _layer("pool8", 13, 1, 512, 0),
    _layer("fire9", 13, 65, 512, 720),
    _layer("conv10", 13, 173, 1000, 2050),
]  # ~4.4 MB params, ~1.3 GFLOPs -> lightest model

CNN_MODELS: Dict[str, List[CnnLayer]] = {
    "alexnet": ALEXNET,
    "resnet": RESNET50,
    "googlenet": GOOGLENET,
    "mobilenet": MOBILENET,
    "squeezenet": SQUEEZENET,
}


def model_params_bytes(name: str) -> float:
    return sum(l.params_bytes for l in CNN_MODELS[name])


def model_flops(name: str) -> float:
    return sum(l.flops for l in CNN_MODELS[name])


# ---------------------------------------------------------------------------
# Tiny runnable CNN following a table's resolution schedule
# ---------------------------------------------------------------------------
class TinyCNN(nn.Module):
    """Small conv stack whose intermediate outputs follow ``table``'s
    resolution schedule. Weights are random (drawn from ``generator``) —
    sufficient for the resolution/similarity experiments (edge-detector-like
    first layers arise naturally from random convs + relu).

    One ``[channels, in_ch, 3, 3]`` (OIHW) kernel per table entry, standard
    normals over ``sqrt(9 * in_ch)``; ``in_ch`` is 3 for the first.
    ``kernels`` (e.g. ``weights.cnn_from_jax`` of the reference's) replaces
    the draw. ``device`` defaults to ``cuda`` and raises without a card;
    ``generator`` must live on it."""

    def __init__(self, table: List[CnnLayer], channels: int = 8, *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 kernels: Optional[Sequence[torch.Tensor]] = None):
        super().__init__()
        if (generator is None) == (kernels is None):
            raise ValueError("TinyCNN takes a generator or kernels, not both")
        self.table = table
        self.channels = channels
        dev = resolve_device(device)
        if kernels is None:
            kernels, in_ch = [], 3
            for _ in table:
                w = torch.randn((channels, in_ch, 3, 3), generator=generator,
                                device=dev, dtype=torch.float32)
                kernels.append(w / math.sqrt(9 * in_ch))
                in_ch = channels
        if len(kernels) != len(table):
            raise ValueError(f"{len(kernels)} kernels for {len(table)} layers")
        self.kernels = nn.ParameterList(
            nn.Parameter(w.to(dev), requires_grad=False) for w in kernels)

    @torch.no_grad()
    def intermediates(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image: [H, W, 3] float32 in [0, 1]. Returns per-layer feature maps
        at each table entry's resolution ([res, res, C]): a 3x3 "SAME" conv
        at stride 1, relu, then the reference's linear resize."""
        outs = []
        x = image.permute(2, 0, 1)[None]                    # NCHW
        for layer, w in zip(self.table, self.kernels):
            x = torch.relu(F.conv2d(x, w, padding=1))
            res = max(2, layer.resolution)
            x = resize_linear(x, (res, res))
            outs.append(x[0].permute(1, 2, 0))
        return outs
