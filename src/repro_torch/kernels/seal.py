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


def _mul32(a, c):
    """(a * c) mod 2**32 for ``a`` and ``c`` in [0, 2**32), each an int or
    an int64 tensor, without overflowing int64."""
    lo = a * (c & 0xFFFF)                        # < 2**48
    hi = ((a * (c >> 16)) & 0xFFFF) << 16        # < 2**32
    return (lo + hi) & MASK32


def check_key_tensor(v: torch.Tensor) -> None:
    """A key or counter tensor holds one integer: raise TypeError if not."""
    if v.numel() != 1 or v.is_floating_point() or v.is_complex() \
            or v.dtype == torch.bool:
        raise TypeError(f"a key or counter tensor holds one integer, got "
                        f"{v.dtype} {tuple(v.shape)}")


def u32(v):
    """A key or counter taken modulo 2**32: a Python int stays an int; a
    one-element integer tensor becomes an int64 scalar tensor on its own
    device, in tensor arithmetic (no ``.item()``, no host sync), so a
    signed int32 bit pattern and an int64 value give the same word."""
    if isinstance(v, torch.Tensor):
        check_key_tensor(v)
        return v.reshape(()).to(torch.int64) & MASK32
    return int(v) & MASK32


def keystream_u32(key, counter, idx: torch.Tensor) -> torch.Tensor:
    """Per-element 32-bit keystream. ``key`` and ``counter`` are Python ints
    or one-element integer tensors (on ``idx``'s device), taken modulo
    2**32; ``idx`` is an integer tensor of element indices, taken modulo
    2**32 as JAX's uint32 arithmetic wraps them. Returns int64 values in
    [0, 2**32), the same for an int and a tensor of the same value."""
    key, counter = u32(key), u32(counter)
    x = _mul32(idx.to(torch.int64) & MASK32, M1)
    x = x ^ ((key + _mul32(counter, M2)) & MASK32)
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
