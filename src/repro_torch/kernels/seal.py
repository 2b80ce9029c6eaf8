"""Counter-mode keystream of the page cipher, in PyTorch integer arithmetic.

Port of ``repro.kernels.seal.keystream_u32``: an ARX mix of (key, counter,
element index) in 32-bit unsigned arithmetic. PyTorch on the CPU has no
right shift for ``torch.uint32``, so every value is held in int64 in
``[0, 2**32)`` and every product and sum is reduced modulo 2**32. Products
are split into 16-bit halves so that no intermediate leaves int64's range
(a full 32x32-bit product would overflow the signed type). The bits are
those of the JAX function, on any device; the CUDA kernel in
``csrc/seal_bits.cu`` computes the same mix in native ``uint32_t``.
"""
from __future__ import annotations

import torch

M1 = 0x9E3779B9        # golden-ratio odd constants (Weyl / squares)
M2 = 0x85EBCA6B
M3 = 0xC2B2AE35
MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, without overflowing int64."""
    lo = a * (c & 0xFFFF)                        # < 2**48
    hi = ((a * (c >> 16)) & 0xFFFF) << 16        # < 2**32
    return (lo + hi) & MASK32


def keystream_u32(key: int, counter: int, idx: torch.Tensor) -> torch.Tensor:
    """Per-element 32-bit keystream. ``key`` and ``counter`` are Python ints
    taken modulo 2**32; ``idx`` is an integer tensor of element indices,
    taken modulo 2**32 as JAX's uint32 arithmetic wraps them. Returns int64
    values in [0, 2**32)."""
    key, counter = int(key) & MASK32, int(counter) & MASK32
    x = _mul32(idx.to(torch.int64) & MASK32, M1)
    x = x ^ ((key + counter * M2) & MASK32)
    x = _mul32(x ^ (x >> 16), M2)
    x = _mul32(x ^ (x >> 13), M3)
    x = x ^ (x >> 16)
    # second squares round for diffusion
    x = (_mul32(x, key | 1) + counter) & MASK32
    x = _mul32(x ^ (x >> 15), M1)
    return x ^ (x >> 17)


def int_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """The same-width signed integer type a float tensor bitcasts to. The
    port keeps cipher text in int16/int32 (PyTorch's unsigned types lack
    XOR and shifts on the CPU); host payloads view the same bytes as numpy
    uint16/uint32, exactly the reference's cipher dtypes."""
    size = torch.empty((), dtype=dtype).element_size()
    return {2: torch.int16, 4: torch.int32}[size]


def to_signed(ks: torch.Tensor, bits: int) -> torch.Tensor:
    """Low ``bits`` of non-negative int64 ``ks`` as the signed integer type
    of that width (two's complement), bit for bit."""
    low = ks & ((1 << bits) - 1)
    low = low - ((low >> (bits - 1)) << bits)
    return low.to({16: torch.int16, 32: torch.int32}[bits])
