"""Sealing (port of ``repro/enclave/sealing.py``): the quantizing seal of
stage-boundary activations, the lossless page seal of the swap tier,
integrity tags and the attestation stub (``measure`` / ``verify``).

Activation boundaries use ``_leaf_counter(step, leaf) = step * 65537 +
leaf`` (uint32) and the quantizing ``seal`` / ``unseal`` kernels
(``seal_array`` / ``seal_tree``): int8 with a per-row f32 scale, so a
boundary crossing is lossy by design, as in the reference.

Counter spaces are the reference's: swap events use
``_swap_counter(seq, part)`` with engine-local ``seq < TRANSFER_SEQ_BASE``
and the K / V planes on parts 0 / 1; cross-engine transfers map their
sequence through ``transfer_seq`` into ``[TRANSFER_SEQ_BASE,
2 * TRANSFER_SEQ_BASE)``, which sets bit 31 of the counter, which no swap
counter does. The same (key, seq, part) gives the same cipher bytes in both
packages, so a payload sealed by one unseals under the other.

An engine whose pipeline stages are ranks (``ServingEngine(mesh=)``) moves
with the page cipher what the reference moves inside one program, each
under sequence numbers of its own, carved out of the swap space: a
prefill's hidden state crossing a stage boundary (``crossing_seq``), the
layers a live re-plan moves between ranks (``restage_seq``) and the KV
entries the data ranks of a pod exchange after each decode step
(``exchange_seq``). A decode engine (a rank engine alone, or the decode
role of a disaggregated pair) keeps its swaps in the first eighth of the
swap space and these three in the next three eighths; the prefill role of
a pair, whose two engines share every rank and its key, draws its swaps
and its own three spaces from the upper half (``prefill=True``), so the
roles never cipher under one (key, counter). A rank seals its own layers
of a swap row, or of a handoff's, as a window of the row
(``seal_pages(col0=, row_cols=)``): the ranks' windows side by side are
the one-card payload, under the one-card (key, counter).

Keys, sequence numbers, steps and counters are Python ints or one-element
integer tensors (``kernels.seal.u32``): a tensor stays on its device and
the counter arithmetic runs there, with the same uint32 wrap, so a swap or
a stage boundary captured in a CUDA graph ciphers under whatever key and
sequence its input buffers hold when it is replayed.

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
from repro_torch.kernels.seal import u32

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


# the rank engine's sequence spaces, an eighth of the swap space each: a
# decode engine's swaps stay below EXCHANGE_SEQ_BASE (2^27 of them); the
# prefill role of a pair draws its swaps and the same three spaces
# PREFILL_SEQ_SHIFT higher, all below TRANSFER_SEQ_BASE
EXCHANGE_SEQ_BASE = TRANSFER_SEQ_BASE // 8
CROSSING_SEQ_BASE = TRANSFER_SEQ_BASE // 4
RESTAGE_SEQ_BASE = 3 * TRANSFER_SEQ_BASE // 8
PREFILL_SEQ_SHIFT = TRANSFER_SEQ_BASE // 2


def _in_space(name: str, base: int, n: int, prefill: bool) -> int:
    size = TRANSFER_SEQ_BASE // 8
    if not 0 <= n < size:
        raise ValueError(f"{name} {n} outside [0, {size})")
    return base + n + (PREFILL_SEQ_SHIFT if prefill else 0)


def crossing_seq(n: int, prefill: bool = False) -> int:
    """The swap sequence number of the n-th prefill crossing between two
    pipeline ranks (part 0), of a pair's prefill role with ``prefill``."""
    return _in_space("crossing", CROSSING_SEQ_BASE, n, prefill)


def restage_seq(n: int, prefill: bool = False) -> int:
    """The swap sequence number of the n-th tensor a live re-plan moves
    between two pipeline ranks (part 0), of a pair's prefill role with
    ``prefill``."""
    return _in_space("restage message", RESTAGE_SEQ_BASE, n, prefill)


def exchange_seq(n: int, prefill: bool = False) -> int:
    """The swap sequence number of the n-th KV exchange a data rank of a
    pod seals for the others after a decode step (part 0), of a pair's
    prefill role with ``prefill``."""
    return _in_space("exchange", EXCHANGE_SEQ_BASE, n, prefill)


def _swap_counter(swap_seq, part: int):
    """uint32 ``0xA5A50000 ^ (2 * seq + part)``, wrapped like JAX's uint32;
    an int for an int ``swap_seq``, an int64 scalar tensor on its device
    for a tensor one."""
    return 0xA5A50000 ^ ((u32(swap_seq) * 2 + int(part)) & 0xFFFFFFFF)


def seal_pages(pages: torch.Tensor, key, swap_seq, *, part: int = 0,
               col0: int = 0, row_cols=None) -> torch.Tensor:
    """pages [n_pages, row_elems] float -> cipher int16/int32 on the same
    device (the CUDA kernel for a CUDA tensor). With ``col0`` and
    ``row_cols``, ``pages`` is columns [col0, col0 + row_elems) of rows
    ``row_cols`` wide, and the cipher those columns of the whole rows'."""
    return K.seal_bits(pages, key, _swap_counter(swap_seq, part),
                       **_window(col0, row_cols))


def unseal_pages(cipher: torch.Tensor, key, swap_seq,
                 out_dtype: torch.dtype, *, part: int = 0, col0: int = 0,
                 row_cols=None) -> torch.Tensor:
    return K.unseal_bits(cipher, key, _swap_counter(swap_seq, part),
                         out_dtype=out_dtype, **_window(col0, row_cols))


def _window(col0: int, row_cols) -> dict:
    """The cipher's window arguments; none for a whole row."""
    if col0 == 0 and row_cols is None:
        return {}
    return {"col0": col0, "row_cols": row_cols}


# ---------------------------------------------------------------------------
# Activation boundaries: the quantizing seal
# ---------------------------------------------------------------------------
def _leaf_counter(step, leaf_idx: int):
    """uint32 ``step * 65537 + leaf_idx``, wrapped like JAX's uint32; an
    int for an int ``step``, an int64 scalar tensor on its device for a
    tensor one."""
    return (u32(step) * 65537 + int(leaf_idx)) & 0xFFFFFFFF


def leaf_counters(steps: int, device, leaf: int = 0) -> torch.Tensor:
    """``_leaf_counter(t, leaf)`` for every t < ``steps``, as one int64
    tensor on ``device``. A pipelined step slices its per-tick boundary
    counters out of it: built once, since a host-to-device copy cannot be
    captured in a CUDA graph."""
    return torch.tensor([_leaf_counter(t, leaf) for t in range(steps)],
                        dtype=torch.int64, device=device)


def seal_array(x: torch.Tensor, key, step):
    """Seal one [..., D] float tensor; returns (cipher uint8, scales f32)
    with the leading dims flattened (``unseal_array`` restores the shape).
    The CUDA kernel runs for a CUDA tensor."""
    return K.seal(x.reshape(-1, x.shape[-1]), key, _leaf_counter(step, 0))


def unseal_array(cipher: torch.Tensor, scales: torch.Tensor, shape, key,
                 step, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    flat = K.unseal(cipher, scales, key, _leaf_counter(step, 0),
                    out_dtype=dtype)
    return flat.reshape(shape)


def _flatten(tree: Any, leaves: list):
    """Leaves in the reference's order (dict keys sorted, as ``jax.tree``
    flattens them) and a spec that ``_unflatten`` rebuilds the tree from."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys, [_flatten(tree[k], leaves) for k in keys])
    if isinstance(tree, (tuple, list)):
        return (type(tree), None, [_flatten(t, leaves) for t in tree])
    leaves.append(tree)
    return None


def _unflatten(spec, leaves) -> Any:
    if spec is None:
        return next(leaves)
    kind, keys, children = spec
    vals = [_unflatten(c, leaves) for c in children]
    return dict(zip(keys, vals)) if kind == "dict" else kind(vals)


def seal_tree(tree: Any, key, step):
    """Seal every floating leaf of a boundary pytree (nested dicts, lists,
    tuples of tensors). Leaf i uses counter ``_leaf_counter(step, i)``, so
    keystreams never repeat across leaves or steps. Returns ``(sealed,
    treedef)``; sealed entries are ``("raw", leaf)`` or ``("sealed",
    (cipher, scales, shape, dtype))``, as in the reference."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    sealed = []
    for i, leaf in enumerate(leaves):
        if not leaf.is_floating_point():
            sealed.append(("raw", leaf))
            continue
        shape = tuple(leaf.shape)
        flat = leaf.reshape(-1, shape[-1]) if leaf.dim() > 1 \
            else leaf.reshape(1, -1)
        cipher, scales = K.seal(flat, key, _leaf_counter(step, i))
        sealed.append(("sealed", (cipher, scales, shape, leaf.dtype)))
    return sealed, treedef


def unseal_tree(sealed, treedef, key, step) -> Any:
    leaves = []
    for i, (tag, payload) in enumerate(sealed):
        if tag == "raw":
            leaves.append(payload)
            continue
        cipher, scales, shape, dtype = payload
        flat = K.unseal(cipher, scales, key, _leaf_counter(step, i),
                        out_dtype=dtype)
        leaves.append(flat.reshape(shape))
    return _unflatten(treedef, iter(leaves))


# ---------------------------------------------------------------------------
# Host payloads: cipher text views and integrity tags
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# Attestation stub (the protocol endpoints exist; the quote is a hash chain)
# ---------------------------------------------------------------------------
def measure(code: bytes, params_digest: bytes) -> bytes:
    """Enclave measurement = H(code || params). Stands in for the SGX quote
    (paper Sec. II: users attest via Intel's remote-attestation service)."""
    return hashlib.sha256(code + params_digest).digest()


def verify(measurement: bytes, expected: bytes) -> bool:
    return measurement == expected
