"""Token sampling of the port (``repro/serving/sampling.py``), with JAX's
keyed randomness rebuilt as plain functions on tensors, bit for bit.

The reference keys each sample by ``fold_in(fold_in(PRNGKey(seed), rid),
index)``, so a request's sampled stream depends only on (seed, request id,
position within the request), never on its slot, its admission or its
batch-mates. Reproducing its streams token for token needs JAX's
threefry-2x32 and the way ``jax.random`` builds on it, as jax 0.9.0 runs
it (``jax_threefry_partitionable`` on):

* ``prng_key(seed)``: the raw key ``(0, seed & 0xFFFFFFFF)`` (without
  x64, JAX takes the seed as an int32, whose logical shift by 32 is 0);
* ``threefry2x32``: 20 rounds over a pair of 32-bit words, with the key
  schedule ``(k1, k2, k1 ^ k2 ^ 0x1BD11BDA)`` injected every 4 rounds;
* ``fold_in(key, data)``: threefry over the count pair ``(0, data)``,
  whose two output words are the new key;
* ``random_bits``: the partitionable layout, where the flat index ``j`` of
  every element is split into hi and lo words, both go through threefry
  and the 32 bits are ``bits1 ^ bits2``;
* ``uniform`` on ``[tiny, 1)``: the top 23 bits as a mantissa of 1.x,
  minus 1, scaled and clamped as ``jax.random.uniform`` does;
* ``gumbel`` (mode "low") ``-log(-log(u))`` and ``categorical``
  ``argmax(gumbel + logits)``, the first maximum.

Torch has no ``add`` for ``uint32``, so every 32-bit word is carried in an
``int64`` tensor masked with ``0xFFFFFFFF`` and rotated with logical
shifts: the integer part is exact on the CPU and on the card. Only the two
``log``s may differ by an ulp between XLA's, torch's CPU and CUDA's.

Everything runs on the logits' device with no host sync, so a warmed
engine captures ``TokenSampler.sample_device`` as a CUDA graph per batch
shape, with the rows' (rid, index) pairs as a device tensor.
``temperature <= 0`` is exact argmax (the first maximum, as
``jnp.argmax``), token-equal to the greedy engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import to_device

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
# jax.random.uniform scales by (maxval - minval) in f32: 1 - tiny rounds
# to 1, kept as the reference computes it
_UNIFORM_SCALE = float(np.float32(1.0) - np.float32(_TINY))

Word = Union[int, torch.Tensor]


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two uint32 words, as jax runs
    it without x64: the seed wraps to 32 bits and the high word is 0."""
    return 0, int(seed) & MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the 32-bit words of ``x`` (int64, masked) left by ``r``, in
    place."""
    lo = x >> (32 - r)
    return x.bitwise_left_shift_(r).bitwise_and_(MASK).bitwise_or_(lo)


def threefry2x32(k1: Word, k2: Word, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the count words ``(x0, x1)`` under the
    key ``(k1, k2)``; words are int64 tensors (or ints) in [0, 2^32), keys
    broadcast against counts. Returns new tensors."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK)
    return x0, x1


def fold_in(k1: Word, k2: Word, data: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, data)`` for each uint32 in ``data`` (int64
    tensor): threefry of the counts ``(0, data)``, whose two words are the
    new key (``threefry_seed(data)`` puts a uint32 in the low word)."""
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(k1: Word, k2: Word, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` in the partitionable layout:
    element j hashes the counts ``(j >> 32, j & 0xFFFFFFFF)`` and is
    ``bits1 ^ bits2``. Per-row keys of shape [B, 1] give [B, n]."""
    if isinstance(k1, torch.Tensor):
        device = k1.device
    j = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, j >> 32, j & MASK)
    return b1.bitwise_xor_(b2)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, tiny, 1)`` from its 32
    random bits (int64 words): the top 23 bits as the mantissa of a float
    in [1, 2), minus 1, then ``max(tiny, u * (1 - tiny) + tiny)``."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * _UNIFORM_SCALE + _TINY, _TINY)


def gumbel(k1: Word, k2: Word, shape: Tuple[int, ...], device=None
           ) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low"):
    ``-log(-log(u))`` over ``uniform`` on [tiny, 1). ``shape`` is (n,), or
    (B, n) with per-row keys of shape [B, 1]."""
    u = uniform(random_bits(k1, k2, shape[-1], device))
    return u.log_().neg_().log_().neg_()


def categorical(k1: Word, k2: Word, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` along the last axis
    (``replace=True``): the first maximum of ``gumbel + logits``. Keys are
    ints for one row, or [B, 1] tensors for per-row keys of [B, V]."""
    g = gumbel(k1, k2, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1)


@dataclasses.dataclass
class TokenSampler:
    """temperature <= 0: greedy argmax. temperature > 0: categorical over
    ``logits / temperature``, optionally restricted to the logits at or
    above the k-th largest (ties kept), each row keyed by its (rid, index)
    as the reference does."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        self._base = prng_key(self.seed)
        # the temperature as a one-element f32 tensor per device: CUDA
        # divides by a host scalar as a multiply by its reciprocal, which
        # can differ from the reference's true division in the last bit
        self._temp: Dict[torch.device, torch.Tensor] = {}

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def row_keys(self, rids: torch.Tensor, indices: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each row's key, ``fold_in(fold_in(base, rid), index)``, with rid
        and index taken as uint32 (int64 tensors in, words out)."""
        k1, k2 = fold_in(*self._base, rids & MASK)
        return fold_in(k1, k2, indices & MASK)

    def sample_device(self, logits: torch.Tensor,
                      rows: Optional[torch.Tensor]) -> torch.Tensor:
        """logits [B, V]; rows [2, B] int64 on the logits' device (rids,
        then within-request token indices; unused when greedy) -> tokens
        [B] int32 on the device. No host sync: a warmed engine captures
        this as a graph."""
        if self.greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        temp = self._temp.get(logits.device)
        if temp is None:
            temp = torch.full((1,), self.temperature, dtype=torch.float32,
                              device=logits.device)
            self._temp[logits.device] = temp
        x = logits.float() / temp
        if 0 < self.top_k < x.shape[-1]:
            kth = torch.topk(x, self.top_k, dim=-1).values[:, -1:]
            x = x.masked_fill(x < kth, float("-inf"))
        k1, k2 = self.row_keys(rows[0], rows[1])
        return categorical(k1[:, None], k2[:, None], x).to(torch.int32)

    def sample(self, logits: torch.Tensor, rids: Sequence[int],
               indices: Sequence[int],
               fn: Optional[Callable[..., torch.Tensor]] = None
               ) -> np.ndarray:
        """logits [B, V]; rids / indices [B] per-row request ids and
        within-request token positions (ignored when greedy) -> tokens [B]
        (int32, on the host; waits for the device). ``fn(logits, rows)``
        runs in place of ``sample_device`` (the engine passes its
        graph-managed wrapper of it)."""
        rows = None if self.greedy else to_device(
            np.stack([np.asarray(rids, np.int64),
                      np.asarray(indices, np.int64)]), logits.device)
        return (fn or self.sample_device)(logits, rows).cpu().numpy()
