"""Hymba of the port (``repro/models/hymba.py``): hybrid blocks with
*parallel* attention and Mamba (selective SSM) heads reading the same
normed input, their outputs fused per block.

The reference's adaptations, kept: per-path RMSNorm and a fixed 0.5 mean
(the paper's per-head β-weighted fusion), sliding-window attention in
every block. Prefill attention is the flash kernel with its window; the
selective scan is plain PyTorch, as the reference computes it with
``jnp`` and ``lax`` (no Pallas call). Decode is sub-quadratic: the SSM
state and the rolling window of KV. A layer's timeline cache is
``((k, v), (conv, ssm))``: the rolling KV [B, KVH, window, D], the last
``conv_kernel - 1`` inputs of the depthwise conv [B, k-1, di] in the
activation type and the SSM state [B, di, n] in f32. There is no paged
cache (``paged_ok`` is False): the serving engine runs Hymba on the
timeline.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from . import layers as L
from .layers import ParamSpec
from .transformer import (AttnBlock, Segment, StackedLM,
                          _window_kv, default_kv_cache_axes,
                          default_kv_cache_spec)

SSM_CHUNK = 256


def _dt_rank(cfg: ArchConfig) -> int:
    return max(8, cfg.d_model // 16)


# ---------------------------------------------------------------------------
# Mamba (selective SSM) head group
# ---------------------------------------------------------------------------
def mamba_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    di = d                     # inner dim (parallel-head budget: attn ∥ ssm)
    n = cfg.ssm_state
    r = _dt_rank(cfg)
    return {
        "in_x": ParamSpec((d, di), axes=("embed", "mlp")),
        "in_z": ParamSpec((d, di), axes=("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_kernel, di), axes=("conv", "mlp")),
        "conv_b": ParamSpec((di,), "zeros", axes=("mlp",)),
        "x_proj": ParamSpec((di, r + 2 * n), axes=("mlp", None)),
        "dt_proj": ParamSpec((r, di), axes=(None, "mlp")),
        "dt_bias": ParamSpec((di,), "zeros", axes=("mlp",)),
        "a_log": ParamSpec((di, n), "zeros", axes=("mlp", "state")),
        "d_skip": ParamSpec((di,), "ones", axes=("mlp",)),
        "out": ParamSpec((di, d), axes=("mlp", "embed")),
    }


def _combine(a, b):
    """The scan's operator on (g, u) pairs, ``a`` the earlier:
    (ga * gb, gb * ua + ub)."""
    (ga, ua), (gb, ub) = a, b
    return ga * gb, gb * ua + ub


def _take(x: torch.Tensor, axis: int, start: int, stop=None,
          step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (a has as many elements
    as b, or one more)."""
    nb = b.shape[axis]
    out = torch.stack([a.narrow(axis, 0, nb), b], dim=axis + 1).flatten(
        axis, axis + 1)
    if a.shape[axis] > nb:
        out = torch.cat([out, a.narrow(axis, nb, 1)], dim=axis)
    return out


def _associative_scan(g: torch.Tensor, u: torch.Tensor, axis: int):
    """Inclusive scan of ``_combine`` along ``axis``, by the odd-even
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half recursively, then fill in the even positions. Each
    element is combined in the order XLA combines it, so the products and
    sums associate as the reference's do. Log depth, no division."""
    n = g.shape[axis]
    if n < 2:
        return g, u
    red = _combine((_take(g, axis, 0, -1, 2), _take(u, axis, 0, -1, 2)),
                   (_take(g, axis, 1, None, 2), _take(u, axis, 1, None, 2)))
    og, ou = _associative_scan(*red, axis)
    if n % 2 == 0:
        eg, eu = _combine((_take(og, axis, 0, -1), _take(ou, axis, 0, -1)),
                          (_take(g, axis, 2, None, 2),
                           _take(u, axis, 2, None, 2)))
    else:
        eg, eu = _combine((og, ou), (_take(g, axis, 2, None, 2),
                                     _take(u, axis, 2, None, 2)))
    eg = torch.cat([_take(g, axis, 0, 1), eg], dim=axis)
    eu = torch.cat([_take(u, axis, 0, 1), eu], dim=axis)
    return _interleave(eg, og, axis), _interleave(eu, ou, axis)


def _ssm_scan_chunked(g: torch.Tensor, u: torch.Tensor, h0: torch.Tensor):
    """h_t = g_t * h_{t-1} + u_t over time (axis 1).

    g, u: [B, S, di, n] (f32); h0: [B, di, n]. Returns (hs [B, S, di, n],
    h_S). Chunked as the reference's: chunks of ``pick_chunk(S, 256)``
    steps, the associative scan within each chunk (all chunks at once,
    as each chunk's scan depends on its own inputs alone), then in order
    across chunks ``hs = G * h + U`` from the previous chunk's last
    state."""
    B, S, di, n = g.shape
    c = L.pick_chunk(S, SSM_CHUNK)
    G, U = _associative_scan(g.reshape(B, S // c, c, di, n),
                             u.reshape(B, S // c, c, di, n), axis=2)
    # each chunk a new tensor, stacked once: autograd refuses out=
    outs, h = [], h0
    for i in range(S // c):
        outs.append(G[:, i] * h[:, None] + U[:, i])
        h = outs[-1][:, -1]
    return torch.stack(outs, 1).reshape(B, S, di, n), h


def mamba_apply(cfg: ArchConfig, p, h: torch.Tensor, *, mode: str,
                state=None):
    """h: [B, S, d] (already normed). Returns (y [B, S, d], (conv_state
    [B, k-1, di], ssm_state [B, di, n] f32)). ``mode="decode"`` takes one
    step from ``state``; otherwise the whole sequence, from ``state``'s
    SSM state or zeros. The depthwise conv is a cross-correlation over a
    (k-1)-zero left pad with ``conv_w`` [k, di] (the reference's WIO
    kernel ``[k, 1, di]``, ``feature_group_count = di``): ``F.conv1d``
    with groups = di and the kernel ``conv_w.T[:, None, :]``, unflipped;
    decode's window sum is the same cross-correlation at one step."""
    B, S, d = h.shape
    di, n, k = d, cfg.ssm_state, cfg.conv_kernel
    x = h @ p["in_x"]
    z = h @ p["in_z"]
    if mode == "decode":
        conv_state, ssm_state = state              # [B, k-1, di], [B, di, n]
        window = torch.cat([conv_state, x], dim=1)           # [B, k, di]
        x = torch.einsum("bkc,kc->bc", window, p["conv_w"])[:, None] \
            + p["conv_b"]
        conv_new = window[:, 1:]
    else:
        ssm_state = None if state is None else state[1]
        xp = torch.cat([x.new_zeros((B, k - 1, di)), x], dim=1)
        x = F.conv1d(xp.transpose(1, 2),
                     p["conv_w"].T[:, None, :].to(x.dtype),
                     groups=di).transpose(1, 2) + p["conv_b"]
        conv_new = xp[:, S:]                         # last k-1 inputs
    x = F.silu(x)

    proj = (x @ p["x_proj"]).float()
    r = _dt_rank(cfg)
    dt_in, Bc, Cc = proj.split([r, n, n], dim=-1)
    pre = dt_in @ p["dt_proj"].float() + p["dt_bias"].float()
    dt = torch.logaddexp(pre, torch.zeros_like(pre))    # jax.nn.softplus
    A = -torch.exp(p["a_log"].float())                               # [di, n]
    g = torch.exp(dt[..., None] * A)                          # [B, S, di, n]
    u = (dt * x.float())[..., None] * Bc[:, :, None, :]
    del dt, pre, proj

    if mode == "decode":
        ssm_new = g[:, 0] * ssm_state + u[:, 0]
        hs = ssm_new[:, None]
    else:
        h0 = torch.zeros((B, di, n), dtype=torch.float32, device=h.device) \
            if ssm_state is None else ssm_state
        hs, ssm_new = _ssm_scan_chunked(g, u, h0)
    del g, u

    y = torch.einsum("bsen,bsn->bse", hs, Cc).to(h.dtype)
    del hs
    y = y + x * p["d_skip"]
    y = y * F.silu(z)
    return y @ p["out"], (conv_new, ssm_new)


# ---------------------------------------------------------------------------
# Hymba block: x + fuse(attn(h), ssm(h)); then MLP
# ---------------------------------------------------------------------------
def hymba_block_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": ParamSpec((d,), "ones", axes=("embed",)),
        "ln2": ParamSpec((d,), "ones", axes=("embed",)),
        "ln_attn": ParamSpec((d,), "ones", axes=("embed",)),
        "ln_ssm": ParamSpec((d,), "ones", axes=("embed",)),
        "attn": L.attn_specs(cfg),
        "ssm": mamba_specs(cfg),
        "mlp": {
            "wi": ParamSpec((d, cfg.d_ff), axes=("embed", "mlp")),
            "wg": ParamSpec((d, cfg.d_ff), axes=("embed", "mlp")),
            "wo": ParamSpec((cfg.d_ff, d), axes=("mlp", "embed")),
        },
    }


class HymbaBlock(AttnBlock):
    """The reference's ``hymba_block_apply`` on each path: windowed
    attention (the flash kernel in prefill; a rolling buffer written at
    ``len % window`` in decode) and the selective SSM on the same normed
    input, fused as ``x + 0.5 * (rmsnorm(attn) + rmsnorm(ssm))``, then
    the SwiGLU MLP. No paged paths."""

    paged = False

    def _fuse(self, p, x, attn, ssm):
        eps = self.cfg.norm_eps
        x = x + 0.5 * (L.rmsnorm(attn, p["ln_attn"], eps)
                       + L.rmsnorm(ssm, p["ln_ssm"], eps))
        return self.mlp(p, x)

    def _sequence(self, p, x, positions):
        """Both paths over a whole sequence: (x, k, v, SSM state)."""
        cfg = self.cfg
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, cfg)
        ctx = L.chunked_attention(q, k, v, causal=True, window=self.window)
        attn = L.attn_out(p["attn"], ctx)
        ssm, state = mamba_apply(cfg, p["ssm"], h, mode="train")
        return self._fuse(p, x, attn, ssm), k, v, state

    def forward(self, p, x, positions, pos3=None, train: bool = False):
        x, k, v, _ = self._sequence(p, x, positions)
        return x, k, v

    def prefill(self, p, x, positions, pos3=None):
        """(x, the layer's cache ``((k, v), (conv, ssm))``: the window of
        K/V rolled into its buffer, the conv's last k-1 inputs and the
        SSM's final state)."""
        x, k, v, state = self._sequence(p, x, positions)
        return x, (_window_kv(k, v, self.window), state)

    @staticmethod
    def kv_of(cache):
        return cache[0]

    def decode(self, p, x, positions, pos3, cache, cache_len, slot, start,
               rows):
        """One timeline step of rows ``rows``: the rolling KV written at
        ``slot`` and read from each row's ``start``, the conv window and
        the SSM state advanced one step, in place."""
        cfg = self.cfg
        kv, (conv, ssm) = cache
        h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
        q, k, v = L.attn_qkv(p["attn"], h, positions, cfg)
        ctx = self.attend_decode(q, k, v, kv, cache_len, slot, start, rows)
        attn = L.attn_out(p["attn"], ctx)
        conv, ssm = conv[rows], ssm[rows]
        out, (conv_new, ssm_new) = mamba_apply(cfg, p["ssm"], h,
                                               mode="decode",
                                               state=(conv, ssm))
        conv.copy_(conv_new)
        ssm.copy_(ssm_new)
        return self._fuse(p, x, attn, out)

    def decode_paged(self, *args, **kw):
        raise NotImplementedError(f"{self.cfg.name}: Hymba has no paged "
                                  f"cache (paged_ok is False)")

    prefill_chunk = decode_paged


def hymba_cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
                     dtype=torch.bfloat16):
    """One layer's timeline cache spec: ``((k, v), (conv, ssm))``, the KV
    window-sized (``default_kv_cache_spec``), the conv state in ``dtype``
    and the SSM state in f32."""
    di, n, k = cfg.d_model, cfg.ssm_state, cfg.conv_kernel
    return (default_kv_cache_spec(cfg, batch, max_seq, dtype=dtype),
            (((batch, k - 1, di), dtype), ((batch, di, n), torch.float32)))


# logical axes of one layer's ``hymba_cache_spec``, the reference's
HYMBA_CACHE_AXES = (default_kv_cache_axes(),
                    (("act_kv_batch", None, "act_mlp"),
                     ("act_kv_batch", "act_mlp", None)))


def build_hymba(cfg: ArchConfig, remat: bool = True) -> StackedLM:
    def cache_fn(batch, max_seq, dtype):
        return hymba_cache_spec(cfg, batch, max_seq, dtype)

    return StackedLM(cfg, [Segment("blocks", cfg.num_layers,
                                   lambda: hymba_block_specs(cfg),
                                   HymbaBlock(cfg), cache_fn,
                                   HYMBA_CACHE_AXES)], remat)
