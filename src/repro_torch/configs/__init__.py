"""Config registry of the port: ``get_arch(name)``, ``reduced``,
``ShapeConfig`` and the reference's input-shape cells (``SHAPES``,
``get_shape``, ``shape_applicable``)."""
from __future__ import annotations

from .base import (CNN, DENSE, ENCDEC, HYBRID, MOE, SHAPES, SSM, VLM,
                   ArchConfig, ShapeConfig, reduced, shape_applicable)
from .command_r_35b import CONFIG as _command_r
from .glm4_9b import CONFIG as _glm4
from .hymba_1_5b import CONFIG as _hymba
from .llama3_2_1b import CONFIG as _llama1b
from .llama3_2_3b import CONFIG as _llama3b
from .moonshot_v1_16b_a3b import CONFIG as _moonshot
from .qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from .qwen2_vl_7b import CONFIG as _qwen2_vl
from .whisper_small import CONFIG as _whisper
from .xlstm_125m import CONFIG as _xlstm

# every config of the reference: the dense and MoE stacks (moonshot-v1-
# 16b-a3b with its dense stem segment, which the serving engine refuses,
# as the reference's does), the VLM backbone (M-RoPE, a stub patch
# frontend), Hymba (attention + selective SSM) and xLSTM (sLSTM/mLSTM
# pairs), both served on the timeline, and Whisper (encoder-decoder, run
# through the model API; the engine refuses it, as the reference's does)
ARCHS = {c.name: c for c in [_moonshot, _qwen2_moe, _glm4, _command_r,
                             _llama3b, _llama1b, _xlstm, _hymba, _whisper,
                             _qwen2_vl]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; "
                       f"available: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ArchConfig", "ARCHS", "SHAPES", "ShapeConfig", "get_arch",
           "get_shape", "list_archs", "reduced", "shape_applicable",
           "DENSE", "MOE", "SSM", "HYBRID", "ENCDEC", "VLM", "CNN"]
