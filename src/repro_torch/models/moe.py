"""Mixture-of-Experts blocks of the port (``repro/models/moe.py``): top-k
routing with capacity-based scatter/gather dispatch into ``[E, C, D]``
buffers, a gated FFN per expert, Qwen-MoE-style always-on shared experts,
and DeepSeek/Moonlight-style dense stem blocks (``first_k_dense``: a
``"stem"`` segment ahead of the MoE ``"blocks"``).

The serving path dispatches without dropping (``drop_tokens=False``): C
is then ``ceil8(T * K)``, a function of the token count T alone, so a
decode step and every prefill bucket keep static shapes and a CUDA graph
captures them. Nothing here reads a value back to the host (no
``nonzero``, no boolean-mask indexing, no ``.item()``; the one-hot is a
comparison, since ``F.one_hot`` checks its input's range on the host),
and nothing adds floats in an order that varies between runs: tokens
scatter into unique (expert, slot) targets, and the K expert outputs of
a token are summed in k order, as the reference's scatter-add sums them.
The expert products are ``torch.bmm`` over all E experts, the
reference's ``einsum``.

On a rank of a model axis (``sharding.tensor_parallel``) the experts are
split as the reference's ``act_experts`` splits them (expert
parallelism): the router, the top-k and the slots are computed whole on
every rank, each rank scatters only the decisions of its E / M experts
into its rows of the buffer and runs their FFN, and combines its
experts' outputs in k order with zeros for the others'. The shared
experts are a SwiGLU over the rank's ``mlp`` columns. The partial
combines and the shared experts' partial output are then added over the
model group in one ``reduce_model``: a [T, D] message, where gathering
the experts' outputs to run the one-card combine unchanged would move
the whole [E, C, D] buffer (C = T * K rows an expert without dropping).
In training the tokens entering the dispatch, the gate weights entering
the combine and the shared experts' input pass ``copy_to_model``, so
their gradients (and through them the router's) are the whole ones on
every rank. Under a sequence split (``SP_ACT_RULES``) the layer takes
the rank's block of the sequence and gathers it whole first: the router,
the dispatch, the capacity and the shared experts run on the whole
sequence as without the split, and the output is reduce-scattered back
to the block in place of each ``reduce_model`` (``TP.leave``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding import fsdp as FS
from repro_torch.sharding import tensor_parallel as TP
from . import layers as L
from .layers import ParamSpec
from .transformer import StackedLM, _attn_segment

CAPACITY_FACTOR = 1.25


def moe_mlp_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, dff, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s: Dict[str, Any] = {
        "router": ParamSpec((d, E), scale=1.0, axes=("embed", None)),
        "wi": ParamSpec((E, d, dff), axes=("experts", "embed", "mlp")),
        "wg": ParamSpec((E, d, dff), axes=("experts", "embed", "mlp")),
        "wo": ParamSpec((E, dff, d), axes=("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        sdff = cfg.num_shared_experts * dff
        s["shared"] = {"wi": ParamSpec((d, sdff), axes=("embed", "mlp")),
                       "wg": ParamSpec((d, sdff), axes=("embed", "mlp")),
                       "wo": ParamSpec((sdff, d), axes=("mlp", "embed"))}
    return s


def capacity(tokens: int, k: int, num_experts: int,
             factor: float = CAPACITY_FACTOR) -> int:
    c = int(math.ceil(tokens * k / num_experts * factor))
    return max(8, -(-c // 8) * 8)  # round up to multiple of 8


def expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """The gated FFN of every expert over its buffer: [E, C, D] ->
    [E, C, D], three batched products over all E experts."""
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    return torch.bmm(h, p["wo"])


def moe_mlp_apply(cfg: ArchConfig, p, x: torch.Tensor, *,
                  capacity_factor: float = CAPACITY_FACTOR,
                  drop_tokens: bool = True, aux: bool = True,
                  seq: bool = False):
    """x: [B, S, D] -> ([B, S, D], Switch aux load-balancing loss).

    ``drop_tokens=False`` sizes the buffers for the worst case (C =
    ceil8(T * K)) so that no decision is dropped: inference requires it,
    because a capacity that depends on T would make prefill (T = B * S)
    and decode (T = B) drop different tokens. ``aux=False`` returns None
    for the loss (serving never reads it). On a rank of a model axis
    ``p`` holds the rank's experts (or its ``mlp`` columns of all of
    them) and the output is summed over the group (see the module's
    docstring). With ``seq`` (a sequence split) ``x`` and the output are
    the rank's block of the sequence, [B, S / M, D]."""
    x = TP.enter(x, False, seq)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)
    E_loc = p["wi"].shape[0]
    routed_split = TP.split(E_loc, E) or TP.split(p["wi"].shape[-1],
                                                  cfg.moe_d_ff)

    gates = torch.softmax(xt.float() @ p["router"].float(), dim=-1)  # [T, E]
    topv, topi = torch.topk(gates, K, dim=-1, sorted=True)          # [T, K]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # slot of each (t, k) decision within its expert: exclusive cumsum
    flat_e = topi.reshape(T * K)                                    # [TK]
    onehot = (flat_e[:, None]
              == torch.arange(E, device=dev)).to(torch.int64)       # [TK, E]
    pos = torch.cumsum(onehot, 0) - onehot
    pos_in_e = pos.gather(1, flat_e[:, None])[:, 0]                 # [TK]
    tok_idx = torch.arange(T * K, device=dev) // K
    w = topv.reshape(T * K)
    if routed_split:
        # the whole tokens and gate weights enter this rank's share of the
        # experts: their gradients are summed over the model group
        xt, w = TP.copy_to_model(xt), TP.copy_to_model(w)
    row = take = flat_e                     # buffer rows written, read
    rows = E
    if E_loc != E:
        # this rank's experts [lo, lo + E_loc): the others' decisions land
        # in a spare last row, never read, and weigh zero in the combine
        local = flat_e - TP.current().index * E_loc
        mine = (local >= 0) & (local < E_loc)
        row = torch.where(mine, local, torch.full_like(local, E_loc))
        take = torch.where(mine, local, torch.zeros_like(local))
        rows = E_loc + 1
        w = w * mine
    if drop_tokens:
        # where a train step splits the batch's rows over ranks, the slots
        # and the capacity are the whole batch's (``fsdp.earlier_rows``)
        before, blocks = FS.earlier_rows(onehot.sum(0))
        if before is not None:
            pos_in_e = pos_in_e + before.gather(0, flat_e)
        C = capacity(T * blocks, K, E, capacity_factor)
        keep = pos_in_e < C
        # dropped decisions add zeros at slot 0 of their expert, as the
        # reference's scatter-add does; only one value there is nonzero,
        # so the sum is exact in any order
        slot = torch.where(keep, pos_in_e, torch.zeros_like(pos_in_e))
        contrib = torch.where(keep[:, None], xt[tok_idx],
                              torch.zeros((), dtype=x.dtype, device=dev))
        w = w * keep
        buf = torch.zeros(rows, C, D, dtype=x.dtype, device=dev)
        buf.index_put_((row, slot), contrib, accumulate=True)
    else:
        C = max(8, -(-T * K // 8) * 8)     # worst case: nothing dropped
        slot = pos_in_e                   # every (expert, slot) unique
        buf = torch.zeros(rows, C, D, dtype=x.dtype, device=dev)
        buf.index_put_((row, slot), xt[tok_idx])

    y = expert_ffn(p, buf[:E_loc])                              # [E, C, D]

    # gather back; gate weights in the activations' type, as the reference
    # casts them, and the K outputs of a token summed in k order
    y_tok = (y[take, slot] * w.to(y.dtype)[:, None]).view(T, K, D)
    out = y_tok[:, 0]
    for k in range(1, K):
        out = out + y_tok[:, k]

    def leave(t, split):            # [T, D] -> the residual's [B, S, D]
        return TP.leave(t.reshape(B, S, D), split, seq)

    if cfg.num_shared_experts:
        sh = p["shared"]
        shared_split = TP.split(sh["wo"].shape[0],
                                cfg.num_shared_experts * cfg.moe_d_ff)
        xs = TP.copy_to_model(x) if shared_split else x
        shared = L.swiglu(xs, sh["wi"], sh["wg"], sh["wo"]).reshape(
            T, D).to(out.dtype)
        if routed_split and shared_split:
            out = leave(out + shared, True)
        else:
            out = leave(out, routed_split) + leave(shared, shared_split)
    else:
        out = leave(out, routed_split)

    loss = None
    if aux:
        me = gates.mean(0)                                          # [E]
        ce = (onehot.view(T, K, E).sum(1) > 0).float().mean(0)
        loss = (me * ce).sum() * E
    return out.to(x.dtype), loss


def moe_block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), "ones", axes=("embed",)),
        "ln2": ParamSpec((d,), "ones", axes=("embed",)),
        "attn": L.attn_specs(cfg),
        "moe": moe_mlp_specs(cfg),
    }


def moe_ffn(cfg: ArchConfig):
    """An MoE block's FFN for ``AttnBlock``: inference dispatches without
    capacity dropping, as the reference's ``moe_block_apply`` does outside
    training; training drops at capacity and discards the aux loss, as it
    does; ``seq``: ``h`` is the rank's block of a split sequence."""
    def ffn(p, h, train: bool, seq: bool = False):
        out, _ = moe_mlp_apply(cfg, p["moe"], h, drop_tokens=train,
                               aux=False, seq=seq)
        return out
    return ffn


def build_moe(cfg: ArchConfig, remat: bool = True,
              cache_quant: bool = False) -> StackedLM:
    """The reference's ``build_moe``: with ``first_k_dense`` a ``"stem"``
    segment of that many dense blocks (SwiGLU of ``dense_stem_d_ff``, or
    ``d_ff``), then ``num_layers - first_k_dense`` MoE blocks under
    ``"blocks"``."""
    segments = []
    if cfg.first_k_dense:
        segments.append(_attn_segment(cfg, "stem", cfg.first_k_dense,
                                      cache_quant,
                                      d_ff=cfg.dense_stem_d_ff or cfg.d_ff))
    segments.append(_attn_segment(
        cfg, "blocks", cfg.num_layers - cfg.first_k_dense, cache_quant,
        ffn=moe_ffn(cfg), specs_fn=lambda: moe_block_specs(cfg)))
    return StackedLM(cfg, segments, remat, cache_quant,
                     paged_ok=not (cache_quant or cfg.sliding_window))
