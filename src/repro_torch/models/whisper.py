"""Whisper of the port (``repro/models/whisper.py``): the whisper-small
backbone, an encoder of ``encoder_layers`` blocks over precomputed frame
embeddings (the conv/mel frontend is a stub in the reference too) and a
decoder of ``num_layers`` blocks with cross-attention to the encoder's
output.

As the reference computes it, whatever the config or the published model
say: every norm is ``rmsnorm``, the MLP is GELU in its tanh form, the
q/k/v projections carry biases, positions are learned (``pos_enc``, and
``pos_dec`` sized by the model's ``max_seq``), and the output head is
the embedding's transpose. Encoder self-attention and cross-attention
are non-causal, decoder self-attention causal; all three run
``layers.chunked_attention``, so the flash kernel on the card. Decode
attends with the plain ``decode_attention`` over its self-attention
cache and the cross-attention cache that prefill computed.

The timeline cache is ``{"kv": (k, v), "xkv": (xk, xv), "len"}``, k and v
[L, B, KVH, S, D] and the cross K/V [L, B, KVH, encoder_seq, D]; decode
writes at ``min(len, S - 1)``, in place. ``prefill_fn`` returns a cache
exactly as long as the prompt, so a decode straight after it overwrites
the prompt's last position, as the reference's does. There is no paged
cache and no ``segments``: the serving engine refuses Whisper, as the
reference's does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from . import layers as L
from .layers import ParamSpec, init_one
from .transformer import _at, _map_specs, _unbind


def enc_block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), "ones", axes=("embed",)),
        "ln2": ParamSpec((d,), "ones", axes=("embed",)),
        "attn": L.attn_specs(cfg, prefix_bias=True),
        "mlp": {
            "wi": ParamSpec((d, cfg.d_ff), axes=("embed", "mlp")),
            "bi": ParamSpec((cfg.d_ff,), "zeros", axes=("mlp",)),
            "wo": ParamSpec((cfg.d_ff, d), axes=("mlp", "embed")),
            "bo": ParamSpec((d,), "zeros", axes=("embed",)),
        },
    }


def dec_block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    s = enc_block_specs(cfg)
    s["ln_x"] = ParamSpec((cfg.d_model,), "ones", axes=("embed",))
    s["xattn"] = L.attn_specs(cfg, prefix_bias=True)
    return s


def _stacked(specs, n: int):
    return _map_specs(lambda s: L.stacked(s, n), specs)


def _mlp(p, h):
    m = p["mlp"]
    return L.gelu_mlp(h, m["wi"], m["wo"], m["bi"], m["bo"])


class WhisperModel:
    """The reference's ``WhisperModel``: ``encode``, ``loss_fn``,
    ``prefill_fn``, ``decode_fn`` and the cache specs. ``remat``
    recomputes each encoder block, and each decoder block in training, in
    the backward (the reference checkpoints the encoder always; without
    autograd that changes nothing)."""

    paged_ok = False

    def __init__(self, cfg: ArchConfig, max_seq: int, remat: bool = True):
        self.cfg = cfg
        self.max_seq = max_seq
        self.remat = remat

    # -- parameters -----------------------------------------------------------
    def param_specs(self) -> Dict[str, Any]:
        c = self.cfg
        return {
            "embed": ParamSpec((c.vocab_size, c.d_model), "embed",
                               axes=("vocab", "embed")),
            "pos_dec": ParamSpec((self.max_seq, c.d_model), "embed",
                                 axes=(None, "embed")),
            "pos_enc": ParamSpec((c.encoder_seq, c.d_model), "embed",
                                 axes=(None, "embed")),
            "ln_f": ParamSpec((c.d_model,), "ones", axes=("embed",)),
            "ln_enc": ParamSpec((c.d_model,), "ones", axes=("embed",)),
            "enc": _stacked(enc_block_specs(c), c.encoder_layers),
            "dec": _stacked(dec_block_specs(c), c.num_layers),
        }

    def init_params(self, generator: torch.Generator, device, dtype):
        return _map_specs(lambda s: init_one(s, generator, device, dtype),
                          self.param_specs())

    def _maybe_remat(self, fn, *args):
        """``fn(*args)``, recomputed in the backward under ``remat``."""
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    # -- encoder --------------------------------------------------------------
    def _enc_block(self, p, x, positions):
        c = self.cfg
        h = L.rmsnorm(x, p["ln1"], c.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, c)
        x = x + L.attn_out(p["attn"], L.chunked_attention(q, k, v,
                                                          causal=False))
        return x + _mlp(p, L.rmsnorm(x, p["ln2"], c.norm_eps))

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, S_enc, d] precomputed embeddings (the stub
        frontend), cast to the parameters' type. Returns the normed
        encoder output [B, S_enc, d]."""
        c = self.cfg
        S = frames.shape[1]
        pos_enc = params["pos_enc"]
        x = frames.to(pos_enc.dtype) + pos_enc[:S]
        positions = torch.arange(S, device=x.device)[None, :]
        for p in _unbind(params["enc"], c.encoder_layers):
            x = self._maybe_remat(self._enc_block, p, x, positions)
        return L.rmsnorm(x, params["ln_enc"], c.norm_eps)

    # -- decoder block --------------------------------------------------------
    def _dec_block(self, p, x, positions, memory, *, mode: str, cache=None,
                   cache_len=None, xkv=None):
        """One decoder block. ``mode="decode"``: ``cache`` (k, v) and
        ``xkv`` (xk, xv) are this layer's [B, KVH, S, D] views, the new
        K/V written at ``min(len, S - 1)`` in place; returns x. Otherwise
        the whole sequence against ``memory``; ``"prefill"`` returns (x,
        ((k, v), (xk, xv))) in the cache's [B, KVH, S, D] layout."""
        c = self.cfg
        h = L.rmsnorm(x, p["ln1"], c.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, c)
        if mode == "decode":
            k_cache, v_cache = cache
            S = k_cache.shape[2]
            slot = torch.clamp(cache_len.reshape(1).long(), max=S - 1)
            k_cache.index_copy_(2, slot, k.transpose(1, 2))
            v_cache.index_copy_(2, slot, v.transpose(1, 2))
            ctx = L.decode_attention(q, k_cache, v_cache, cache_len + 1)
        else:
            ctx = L.chunked_attention(q, k, v, causal=True)
        x = x + L.attn_out(p["attn"], ctx)

        # cross-attention
        h = L.rmsnorm(x, p["ln_x"], c.norm_eps)
        xp = p["xattn"]
        qx = torch.einsum("bsd,dhk->bshk", h, xp["wq"]) + xp["bq"]
        if mode == "decode":
            xk, xv = xkv
            ctx = L.decode_attention(qx, xk, xv, xk.shape[2])
        else:
            xk = torch.einsum("bsd,dgk->bsgk", memory, xp["wk"]) + xp["bk"]
            xv = torch.einsum("bsd,dgk->bsgk", memory, xp["wv"]) + xp["bv"]
            ctx = L.chunked_attention(qx, xk, xv, causal=False)
        x = x + L.attn_out(xp, ctx)
        x = x + _mlp(p, L.rmsnorm(x, p["ln2"], c.norm_eps))
        if mode == "prefill":
            return x, ((k.transpose(1, 2), v.transpose(1, 2)),
                       (xk.transpose(1, 2), xv.transpose(1, 2)))
        return x

    def _run_decoder(self, params, x, positions, memory, *, mode: str,
                     caches=None, cache_len=None):
        """Every decoder block. ``"prefill"`` returns (x, {"kv": (k, v),
        "xkv": (xk, xv)}, each stacked [L, B, KVH, S, D]); ``"decode"``
        updates ``caches`` ((k, v), (xk, xv)) in place and returns x;
        ``"train"`` returns x (each block recomputed in the backward under
        ``remat``)."""
        layers = []
        for l, p in enumerate(_unbind(params["dec"], self.cfg.num_layers)):
            if mode == "decode":
                kv, xkv = _at(caches, l)
                x = self._dec_block(p, x, positions, None, mode=mode,
                                    cache=kv, cache_len=cache_len, xkv=xkv)
            elif mode == "prefill":
                x, c = self._dec_block(p, x, positions, memory, mode=mode)
                layers.append(c)
            else:
                x = self._maybe_remat(
                    lambda pp, xx: self._dec_block(pp, xx, positions, memory,
                                                   mode="train"),
                    p, x)
        if mode != "prefill":
            return x
        stack = [tuple(torch.stack([c[part][i] for c in layers])
                       for i in range(2)) for part in range(2)]
        return x, {"kv": stack[0], "xkv": stack[1]}

    # -- public API -----------------------------------------------------------
    def embed_tokens(self, params, tokens: torch.Tensor,
                     offset: int = 0) -> torch.Tensor:
        e = params["embed"][tokens.long()]
        return e + params["pos_dec"][offset:offset + tokens.shape[1]]

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the head tied to ``embed.T`` at the last
        position: f32 logits [B, V] (f32 operands, as the reference asks
        for f32 accumulation)."""
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return x[:, -1].float() @ params["embed"].T.float()

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        return torch.arange(tokens.shape[1], device=tokens.device)[None, :]

    def loss_fn(self, params, batch):
        """Mean next-token nll of ``tokens``, ``labels`` [B, S] (optional
        ``label_mask``) given ``frames`` [B, S_enc, d]."""
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        x = self._run_decoder(params, self.embed_tokens(params, tokens),
                              self._positions(tokens), memory, mode="train")
        x = L.rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return L.chunked_softmax_xent(x, params["embed"].T, batch["labels"],
                                      label_mask=batch.get("label_mask"))

    def prefill_fn(self, params, batch):
        """Encode ``frames`` and prefill ``tokens`` [B, S]: (f32 logits
        [B, V] at the last position, {"kv", "xkv", "len": S})."""
        memory = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        x, caches = self._run_decoder(params,
                                      self.embed_tokens(params, tokens),
                                      self._positions(tokens), memory,
                                      mode="prefill")
        caches["len"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        return self._logits(params, x), caches

    def decode_fn(self, params, cache, batch):
        """One decode step of ``tokens`` [B, 1] at position ``cache["len"]``
        (its learned position ``pos_dec[min(len, max_seq - 1)]``): the self-
        attention cache and ``len`` updated in place, the same cache dict
        returned with the f32 logits [B, V]."""
        n = cache["len"]
        pos = torch.clamp(n.reshape(1).long(), max=self.max_seq - 1)
        x = params["embed"][batch["tokens"].long()] + \
            params["pos_dec"].index_select(0, pos)
        x = self._run_decoder(params, x, n.reshape(1, 1), None,
                              mode="decode",
                              caches=(cache["kv"], cache["xkv"]),
                              cache_len=n)
        logits = self._logits(params, x)
        n.add_(1)
        return logits, cache

    # -- caches ---------------------------------------------------------------
    def init_cache_specs(self, batch_size: int, max_seq: int,
                         dtype) -> Dict[str, Any]:
        c = self.cfg
        kv = ((c.num_layers, batch_size, c.num_kv_heads, max_seq,
               c.head_dim), dtype)
        xkv = ((c.num_layers, batch_size, c.num_kv_heads, c.encoder_seq,
                c.head_dim), dtype)
        return {"kv": (kv, kv), "xkv": (xkv, xkv), "len": ((), torch.int32)}

    def init_cache_axes(self) -> Dict[str, Any]:
        """Logical axes of ``init_cache_specs``'s leaves (the reference's)."""
        ax = ("layers", "act_kv_batch", "act_kv_heads", "act_kv_seq", None)
        return {"kv": (ax, ax), "xkv": (ax, ax), "len": ()}
