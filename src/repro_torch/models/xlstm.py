"""xLSTM of the port (``repro/models/xlstm.py``): alternating sLSTM /
mLSTM blocks (Beck et al., 2024), scanned as (sLSTM, mLSTM) pairs.

* mLSTM: matrix-memory cell with exponential gating. A whole sequence
  runs the stabilized chunkwise-parallel form (log-space gates, [c, c]
  intra-chunk decay matrices), chunks of ``pick_chunk(S, 256)`` in order;
  decode is one chunk of one step.
* sLSTM: scalar cell with head-block-diagonal recurrent weights, run one
  step at a time over the sequence (the reference's ``lax.scan``); on
  meta tensors, for the dry-run's counts, one step counted by the trip
  count (``_SlstmMetaScan``).

All plain PyTorch, as the reference computes it with ``jnp`` and ``lax``
(no Pallas call). Decode carries O(1) recurrent state, no KV cache: a
pair's timeline cache is ``((h, c, n, m), (C, n, m))``, the sLSTM's four
[B, H, dh] states and the mLSTM's matrix memory [B, H, dh, dh], normalizer
[B, H, dh] and stabilizer [B, H], in f32 (C and n, and the four sLSTM
states, in bf16 under ``cache_quant``; the mLSTM's m stays f32). The
segment is named ``"pairs"``, one block per pair; there is no paged
cache (``paged_ok`` is False), so the serving engine runs xLSTM on the
timeline.

Two starts of the stabilizer m, both the reference's: a call without a
state (training, prefill) starts m at -1e30, while ``init_cache`` zeroes
every leaf, m included, so the engine's per-token prefill starts at
m = 0. The bound ``max(|den|, exp(-m))`` then differs; neither is
changed here.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.utils.cost_analysis import repeat
from . import layers as L
from .layers import ParamSpec
from .transformer import Segment, StackedLM

CHUNK = 256


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-jax.nn.softplus(-x)``, JAX's softplus being ``logaddexp(x, 0)``
    (torch's ``softplus`` switches to the identity past ``threshold=20``;
    ``logaddexp`` has no threshold and agrees within 2 ulp)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "ln": ParamSpec((d,), "ones", axes=("embed",)),
        "wq": ParamSpec((d, H, dh), axes=("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, H, dh), axes=("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, H, dh), axes=("embed", "heads", "head_dim")),
        "wi": ParamSpec((d, H), "zeros", axes=("embed", "heads")),
        "wf": ParamSpec((d, H), "zeros", axes=("embed", "heads")),
        # bias > 0: remember by default
        "bf": ParamSpec((H,), "ones", axes=("heads",)),
        "wz": ParamSpec((d, d), axes=("embed", None)),
        "wo": ParamSpec((H, dh, d), axes=("heads", "head_dim", "embed")),
    }


def _mlstm_chunk(qb, kb, vb, logf, logi, state):
    """One chunk of the stabilized chunkwise-parallel mLSTM.

    qb, kb, vb: [B, c, H, dh] (f32); logf, logi: [B, c, H]; state: (C
    [B, H, dh, dh], n [B, H, dh], m [B, H]). Returns (h [B, c, H, dh],
    state). The reference's order of operations: the intra-chunk decay D
    masked with -inf above the diagonal, the row stabilizer clamped at
    -1e30, and ``exp(-m_row)`` in the denominator's bound (it may overflow
    to inf, which zeroes h, as in the reference)."""
    B, c, H, dh = qb.shape
    C0, n0, m0 = state
    b = torch.cumsum(logf, dim=1)                                 # [B,c,H]
    # intra-chunk log decay D[i, j] = b_i - b_j + a_j  (j <= i)
    D = b[:, :, None, :] - b[:, None, :, :] + logi[:, None, :, :]  # [B,i,j,H]
    idx = torch.arange(c, device=qb.device)
    mask = (idx[:, None] >= idx[None, :])[None, :, :, None]
    D = torch.where(mask, D, -math.inf)
    inter = b + m0[:, None, :]                                    # [B,c,H]
    m_row = torch.maximum(D.amax(dim=2), inter)
    m_row = torch.clamp(m_row, min=-1e30)
    scale = 1.0 / math.sqrt(dh)
    qk = torch.einsum("bihd,bjhd->bijh", qb, kb) * scale          # [B,i,j,H]
    w = torch.exp(D - m_row[:, :, None, :]) * qk
    num_intra = torch.einsum("bijh,bjhd->bihd", w, vb)
    den_intra = w.sum(dim=2)                                      # [B,i,H]
    lam = torch.exp(inter - m_row)                                # [B,c,H]
    # C0 and n0 already hold the 1/sqrt(dh)-scaled keys: the retrieval is
    # not scaled again
    num_inter = torch.einsum("bihd,bhde->bihe", qb, C0) * lam[..., None]
    den_inter = torch.einsum("bihd,bhd->bih", qb, n0) * lam
    num = num_intra + num_inter
    den = den_intra + den_inter
    h = num / torch.maximum(den.abs(), torch.exp(-m_row))[..., None]

    # end-of-chunk state
    bc = b[:, -1, :]                                              # [B,H]
    m_new = torch.maximum(bc + m0, (bc[:, None, :] - b + logi).amax(dim=1))
    decay_state = torch.exp(bc + m0 - m_new)                      # [B,H]
    kv_scale = torch.exp(bc[:, None, :] - b + logi - m_new[:, None, :])
    ks = kb * scale
    C_new = decay_state[:, :, None, None] * C0 + torch.einsum(
        "bjh,bjhd,bjhe->bhde", kv_scale, ks, vb)
    n_new = decay_state[:, :, None] * n0 + torch.einsum(
        "bjh,bjhd->bhd", kv_scale, ks)
    return h, (C_new, n_new, m_new)


def _fresh_mlstm_state(B: int, H: int, dh: int, device):
    f32 = torch.float32
    return (torch.zeros((B, H, dh, dh), dtype=f32, device=device),
            torch.zeros((B, H, dh), dtype=f32, device=device),
            torch.full((B, H), -1e30, dtype=f32, device=device))


def mlstm_apply(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str,
                state=None):
    """x: [B, S, d]. Returns (x + out, new state). ``mode="decode"`` takes
    one step from ``state`` (computed in f32, returned in the state's own
    types); otherwise the chunkwise form over the whole sequence from
    ``state`` or a fresh one (m = -1e30), the state returned in f32."""
    B, S, d = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    h_in = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h_in, p["wq"]).float()
    k = torch.einsum("bsd,dhk->bshk", h_in, p["wk"]).float()
    v = torch.einsum("bsd,dhk->bshk", h_in, p["wv"]).float()
    logi = torch.einsum("bsd,dh->bsh", h_in, p["wi"]).float()
    f_raw = torch.einsum("bsd,dh->bsh", h_in, p["wf"]).float() + \
        p["bf"].float()
    logf = _log_sigmoid(f_raw)

    if state is None:
        state = _fresh_mlstm_state(B, H, dh, x.device)

    if mode == "decode":
        dtypes = [a.dtype for a in state]
        hs, new_state = _mlstm_chunk(q, k, v, logf, logi,
                                     tuple(a.float() for a in state))
        new_state = tuple(a.to(dt) for a, dt in zip(new_state, dtypes))
    else:
        c = L.pick_chunk(S, CHUNK)
        hs = torch.empty_like(q)
        new_state = state
        for i in range(0, S, c):
            blk = slice(i, i + c)
            hs[:, blk], new_state = _mlstm_chunk(
                q[:, blk], k[:, blk], v[:, blk], logf[:, blk], logi[:, blk],
                new_state)

    z = torch.sigmoid(torch.einsum("bsd,de->bse", h_in, p["wz"]))
    out = torch.einsum("bshk,hkd->bsd", hs.to(x.dtype), p["wo"]) * z
    return x + out, new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_specs(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    ff = int(d * 4 / 3) // 8 * 8
    return {
        "ln": ParamSpec((d,), "ones", axes=("embed",)),
        "w": ParamSpec((d, 4, H, dh),
                       axes=("embed", None, "heads", "head_dim")),
        "r": ParamSpec((4, H, dh, dh), axes=(None, "heads", "head_dim", None)),
        "b": ParamSpec((4, H, dh), "zeros", axes=(None, "heads", "head_dim")),
        "ln_out": ParamSpec((d,), "ones", axes=("embed",)),
        "ffn": {
            "wi": ParamSpec((d, ff), axes=("embed", "mlp")),
            "wg": ParamSpec((d, ff), axes=("embed", "mlp")),
            "wo": ParamSpec((ff, d), axes=("mlp", "embed")),
        },
    }


def _slstm_cell(st, pre_t, r, bias):
    """One sLSTM step: st (h, c, n, m) [B, H, dh] each (f32), pre_t the
    input pre-activations [B, 4, H, dh]. Returns the new state."""
    h_prev, c_prev, n_prev, m_prev = st
    rec = torch.einsum("bhk,ghkl->bghl", h_prev, r)
    g = pre_t + rec + bias                                        # [B,4,H,dh]
    z_t = torch.tanh(g[:, 0])
    i_raw = g[:, 1]
    f_raw = g[:, 2]
    o_t = torch.sigmoid(g[:, 3])
    logf = _log_sigmoid(f_raw)
    m_t = torch.maximum(logf + m_prev, i_raw)
    i_p = torch.exp(i_raw - m_t)
    f_p = torch.exp(logf + m_prev - m_t)
    c_t = f_p * c_prev + i_p * z_t
    n_t = f_p * n_prev + i_p
    h_t = o_t * c_t / torch.clamp(n_t, min=1e-6)
    return h_t, c_t, n_t, m_t


class _SlstmMetaScan(torch.autograd.Function):
    """The sLSTM's time loop on meta tensors, which hold shapes and no
    values, for the cost counts (``utils/cost_analysis.py``): op by op on
    meta, 32,768 steps of six pairs would take an hour, and every step has
    one step's shapes. So step 0 runs as the loop runs it, then one later
    step (its state a function of the inputs) is counted ``S - 1`` times
    (``repeat``); the backward rebuilds each one's graph uncounted
    (``repeat(0)``) and takes its gradient, counted as often. The outputs
    take the loop's shapes."""

    @staticmethod
    def forward(ctx, pre, r, bias, *state):
        B, S = pre.shape[:2]
        hs = pre.new_empty((B, S) + tuple(state[0].shape[1:]))
        runs, st = [(1, state)], state
        with repeat(1):
            st = _slstm_cell(st, pre[:, 0], r, bias)
            hs[:, 0] = st[0]
        if S > 1:
            runs.append((S - 1, st))
            with repeat(S - 1):
                st = _slstm_cell(st, pre[:, 0], r, bias)
                hs[:, 0] = st[0]
        ctx.counts = [n for n, _ in runs]
        ctx.save_for_backward(pre, r, bias, *[t for _, s in runs
                                              for t in s])
        return (hs,) + tuple(st)

    @staticmethod
    def backward(ctx, g_hs, *g_state):
        pre, r, bias, *states = ctx.saved_tensors
        grad = ctx.needs_input_grad
        g_r = g_bias = None
        g_st = g_state
        for i in reversed(range(len(ctx.counts))):
            n, st = ctx.counts[i], states[4 * i:4 * i + 4]
            # step 0's state needs a gradient only if the caller's does;
            # a later step's depends on the inputs
            st_grad = grad[3:] if i == 0 else (any(grad[:3]),) * 4
            with repeat(0), torch.enable_grad():
                ins = [t.detach().requires_grad_(g) for t, g in zip(
                    (pre[:, 0], r, bias, *st), grad[:3] + tuple(st_grad))]
                new = _slstm_cell(tuple(ins[3:]), *ins[:3])
            want = [t for t in ins if t.requires_grad]
            with repeat(n):
                g = (g_st[0] + g_hs[:, 0],) + tuple(g_st[1:])
                got = iter(torch.autograd.grad(new, want, g,
                                               allow_unused=True))
                grads = [next(got) if t.requires_grad else None
                         for t in ins]
            g_st = [x if x is not None else torch.zeros_like(t)
                    for x, t in zip(grads[3:], ins[3:])]
            g_r = grads[1] if g_r is None else g_r + grads[1]
            g_bias = grads[2] if g_bias is None else g_bias + grads[2]
        g_pre = torch.empty_like(pre) if grad[0] else None
        return (g_pre, g_r, g_bias, *grads[3:])


def slstm_apply(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str,
                state=None):
    """Sequential scalar LSTM with exponential gating, then its SwiGLU FFN.
    x: [B, S, d]. Returns (x, new state (h, c, n, m)); a fresh state is
    zeros with m = -1e30. The FFN normalizes with ``p["ln"]``, the block's
    input norm, as the reference's does (``ln_out`` norms the cell's
    output)."""
    B, S, d = x.shape
    H, dh = cfg.num_heads, cfg.head_dim
    h_in = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    # pre-activations for all gates: [B, S, 4, H, dh]
    pre = torch.einsum("bsd,dghk->bsghk", h_in, p["w"]).float()

    if state is None:
        zeros = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros,
                 torch.full((B, H, dh), -1e30, dtype=torch.float32,
                            device=x.device))

    r = p["r"].float()
    bias = p["b"].float()

    if mode == "decode":
        dtypes = [a.dtype for a in state]
        st = _slstm_cell(tuple(a.float() for a in state), pre[:, 0], r, bias)
        hs = st[0][:, None]
        new_state = tuple(a.to(dt) for a, dt in zip(st, dtypes))
    elif pre.is_meta:
        hs, *new_state = _SlstmMetaScan.apply(pre, r, bias, *state)
        new_state = tuple(new_state)
    else:
        hs = pre.new_empty((B, S, H, dh))
        new_state = state
        for t in range(S):
            new_state = _slstm_cell(new_state, pre[:, t], r, bias)
            hs[:, t] = new_state[0]

    out = hs.reshape(B, -1, d).to(x.dtype)
    x = x + L.rmsnorm(out, p["ln_out"], cfg.norm_eps)
    f = p["ffn"]
    return x + L.swiglu(L.rmsnorm(x, p["ln"], cfg.norm_eps), f["wi"],
                        f["wg"], f["wo"]), new_state


# ---------------------------------------------------------------------------
# Paired block (sLSTM then mLSTM)
# ---------------------------------------------------------------------------
def pair_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {"slstm": slstm_specs(cfg), "mlstm": mlstm_specs(cfg)}


def pair_apply(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str,
               state=None):
    """The sLSTM then the mLSTM of one pair; ``state`` is the pair's
    ``(s_state, m_state)`` or None. Returns (x, (s_new, m_new))."""
    s_state, m_state = (None, None) if state is None else state
    x, s_new = slstm_apply(cfg, p["slstm"], x, mode=mode, state=s_state)
    x, m_new = mlstm_apply(cfg, p["mlstm"], x, mode=mode, state=m_state)
    return x, (s_new, m_new)


class PairBlock:
    """One (sLSTM, mLSTM) pair on every path of ``StackedLM``, as
    ``AttnBlock`` and ``HymbaBlock`` are one attention block: training and
    prefill run the whole sequence in the reference's ``"train"`` mode from
    a fresh state (prefill keeps the final state as the pair's cache);
    decode takes one step from the cache's rows and writes the new state
    back into them in place, in the cache's types. The recurrent state
    carries no absolute positions, so a late-admitted serving slot needs
    no ``start`` mask (the reference ignores it too). No paged paths."""

    paged = False

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def forward(self, p, x, positions, pos3=None, train: bool = False):
        return pair_apply(self.cfg, p, x, mode="train")

    def train(self, p, x, positions, pos3=None) -> torch.Tensor:
        return self.forward(p, x, positions)[0]

    def prefill(self, p, x, positions, pos3=None):
        """(x, the pair's state ``((h, c, n, m), (C, n, m))``, f32)."""
        return self.forward(p, x, positions)

    def decode_slot(self, cache_len: torch.Tensor, body) -> None:
        """No KV cache, so no write slot."""
        return None

    def decode(self, p, x, positions, pos3, cache, cache_len, slot, start,
               rows):
        """One step of rows ``rows`` from the pair's state ``cache`` (views
        into the segment's stacked leaves), updated in place."""
        state = tuple(tuple(t[rows] for t in part) for part in cache)
        x, new = pair_apply(self.cfg, p, x, mode="decode", state=state)
        for part, new_part in zip(state, new):
            for t, n in zip(part, new_part):
                t.copy_(n)
        return x

    def decode_paged(self, *args, **kw):
        raise NotImplementedError(f"{self.cfg.name}: xLSTM has no paged "
                                  f"cache (paged_ok is False)")

    prefill_chunk = decode_paged


def pair_cache_spec(cfg: ArchConfig, batch: int,
                    state_dtype=torch.float32):
    """One pair's timeline cache spec: the sLSTM's (h, c, n, m) [B, H, dh]
    and the mLSTM's (C [B, H, dh, dh], n [B, H, dh], m [B, H]), in
    ``state_dtype`` (bf16 halves the decode state's traffic) but for the
    mLSTM's stabilizer m, a log-scale max that stays f32."""
    H, dh = cfg.num_heads, cfg.head_dim
    bhd = ((batch, H, dh), state_dtype)
    return ((bhd, bhd, bhd, bhd),
            (((batch, H, dh, dh), state_dtype), bhd,
             ((batch, H), torch.float32)))


_AX_BHD = ("act_kv_batch", "act_kv_heads", None)
# logical axes of one pair's ``pair_cache_spec``, the reference's
PAIR_CACHE_AXES = ((_AX_BHD,) * 4,
                   (("act_kv_batch", "act_kv_heads", None, None), _AX_BHD,
                    ("act_kv_batch", "act_kv_heads")))


def build_xlstm(cfg: ArchConfig, remat: bool = True,
                state_dtype=torch.float32) -> StackedLM:
    """``num_layers / 2`` pairs in one segment ``"pairs"``, untied head.
    The state keeps ``state_dtype`` whatever the parameters' type, as the
    reference's does."""
    if cfg.num_layers % 2:
        raise ValueError(f"{cfg.name}: the xLSTM stack runs (sLSTM, mLSTM) "
                         f"pairs; num_layers {cfg.num_layers} is odd")

    def cache_fn(batch, max_seq, dtype):
        return pair_cache_spec(cfg, batch, state_dtype)

    return StackedLM(cfg, [Segment("pairs", cfg.num_layers // 2,
                                   lambda: pair_specs(cfg), PairBlock(cfg),
                                   cache_fn, PAIR_CACHE_AXES)], remat)
