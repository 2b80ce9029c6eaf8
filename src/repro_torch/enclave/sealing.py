"""Lossless page sealing and integrity tags (port of the page-sealing half
of ``repro/enclave/sealing.py``).

Counter spaces are the reference's: swap events use
``_swap_counter(seq, part)`` with engine-local ``seq < TRANSFER_SEQ_BASE``
and the K / V planes on parts 0 / 1; cross-engine transfers map their
sequence through ``transfer_seq`` into ``[TRANSFER_SEQ_BASE,
2 * TRANSFER_SEQ_BASE)``, which sets bit 31 of the counter, which no swap
counter does. The same (key, seq, part) gives the same cipher bytes in both
packages, so a payload sealed by one unseals under the other.

A host payload is a tuple of numpy arrays whose dtypes are the reference's
cipher dtypes (uint16 for bf16 pages, uint32 for f32 pages): the digest is
taken over exactly the bytes the reference hashes, shapes and dtype codes
included, so both packages mint and verify the same tags.
"""
from __future__ import annotations

import hashlib
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as K

TRANSFER_SEQ_BASE = 0x4000_0000


class SealIntegrityError(Exception):
    """A sealed payload failed integrity verification (the XOR page cipher
    is malleable: without the digest a flipped or truncated payload would
    unseal "successfully" into corrupt KV)."""


def transfer_seq(n: int) -> int:
    """Map handoff sequence number ``n`` into the transfer counter space."""
    if not 0 <= n < TRANSFER_SEQ_BASE:
        raise ValueError(f"transfer sequence {n} outside [0, "
                         f"{TRANSFER_SEQ_BASE})")
    return TRANSFER_SEQ_BASE + n


def _swap_counter(swap_seq: int, part: int) -> int:
    """uint32 ``0xA5A50000 ^ (2 * seq + part)``, wrapped like JAX's uint32."""
    return 0xA5A50000 ^ ((int(swap_seq) * 2 + int(part)) & 0xFFFFFFFF)


def seal_pages(pages: torch.Tensor, key: int, swap_seq: int, *,
               part: int = 0) -> torch.Tensor:
    """pages [n_pages, row_elems] float -> cipher int16/int32 on the same
    device (the CUDA kernel for a CUDA tensor)."""
    return K.seal_bits(pages, key, _swap_counter(swap_seq, part))


def unseal_pages(cipher: torch.Tensor, key: int, swap_seq: int,
                 out_dtype: torch.dtype, *, part: int = 0) -> torch.Tensor:
    return K.unseal_bits(cipher, key, _swap_counter(swap_seq, part),
                         out_dtype=out_dtype)


_HOST_VIEW = {torch.int16: np.uint16, torch.int32: np.uint32}
_SIGNED_VIEW = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def cipher_to_host(cipher: torch.Tensor) -> np.ndarray:
    """Device cipher -> host numpy array in the reference's uint dtype
    (same bytes)."""
    return cipher.cpu().numpy().view(_HOST_VIEW[cipher.dtype])


def cipher_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host uint16/uint32 cipher (from either package) -> int16/int32
    tensor on ``device`` with the same bytes."""
    a = np.ascontiguousarray(arr)
    return torch.from_numpy(a.view(_SIGNED_VIEW[a.dtype]).copy()).to(device)


def _leaves(payload: Any):
    if isinstance(payload, (tuple, list)):
        out = []
        for p in payload:
            out.extend(_leaves(p))
        return out
    if isinstance(payload, dict):
        out = []
        for k in sorted(payload):
            out.extend(_leaves(payload[k]))
        return out
    return [np.asarray(payload)]


def payload_structure(payload: Any) -> tuple:
    """Cheap structural commitment: (shape, dtype code) per leaf."""
    return tuple((leaf.shape, leaf.dtype.str) for leaf in _leaves(payload))


def payload_digest(payload: Any) -> Tuple[tuple, bytes]:
    """``(structure, sha256)`` over a sealed host payload — the same bytes
    the reference feeds to SHA-256 (each leaf's repr'd (shape, dtype code),
    then its raw bits), so the two packages agree byte for byte."""
    h = hashlib.sha256()
    leaves = _leaves(payload)
    for arr in leaves:
        h.update(repr((arr.shape, arr.dtype.str)).encode())
        h.update(arr if arr.flags.c_contiguous else np.ascontiguousarray(arr))
    return (tuple((a.shape, a.dtype.str) for a in leaves), h.digest())


def verify_structure(payload: Any, digest: Any, *,
                     context: str = "sealed payload") -> None:
    """Raise ``SealIntegrityError`` unless leaf shapes and dtypes match the
    digest's structural half. ``digest=None`` verifies trivially."""
    if digest is None:
        return
    structure, _ = digest
    actual = payload_structure(payload)
    if actual != structure:
        raise SealIntegrityError(
            f"{context}: sealed payload structure mismatch "
            f"(expected {structure}, got {actual}) — "
            f"payload was truncated or reshaped in transit")


def verify_payload(payload: Any, digest: Any, *,
                   context: str = "sealed payload") -> None:
    """Raise ``SealIntegrityError`` unless ``payload`` matches ``digest`` in
    structure and sealed bits. ``digest=None`` verifies trivially."""
    if digest is None:
        return
    verify_structure(payload, digest, context=context)
    _, expected = digest
    _, actual = payload_digest(payload)
    if actual != expected:
        raise SealIntegrityError(
            f"{context}: sealed payload digest mismatch "
            f"(expected {expected.hex()[:16]}…, got {actual.hex()[:16]}…) — "
            f"payload was tampered with in transit")
