"""Public kernel wrappers (port of ``repro/kernels/ops.py``).

Dispatch goes by the tensor's device: a CPU tensor takes the plain PyTorch
version in ``ref``; a CUDA tensor launches the hand-written kernel from
``csrc/`` or raises — there is no fallback for a CUDA tensor and no switch
that turns the kernels off. Each wrapper counts its kernel launches in
``LAUNCHES`` (plain ints, bumped only where a kernel is launched), so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import ref
from .seal import int_dtype_of

LAUNCHES: Dict[str, int] = {"paged_attention": 0, "seal_bits": 0,
                            "unseal_bits": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({dev} and {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             f"tensors")


def _launch_failed(name: str, rc: int) -> RuntimeError:
    return RuntimeError(f"{name}: CUDA kernel launch failed "
                        f"(cudaError_t {rc})")


# ---------------------------------------------------------------------------
# Lossless page cipher
# ---------------------------------------------------------------------------
def _bits_xor(x: torch.Tensor, key: int, counter: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    from .build import entry
    _check_cuda("seal_bits", x)
    if x.dim() != 2:
        raise ValueError(f"seal_bits takes [rows, cols], got {tuple(x.shape)}")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    vec_ok = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        rc = entry("seal_bits")(
            x.data_ptr(), out.data_ptr(), x.numel(), int(key) & 0xFFFFFFFF,
            int(counter) & 0xFFFFFFFF, x.element_size(), vec_ok,
            _stream(x.device))
    if rc:
        raise _launch_failed("seal_bits", rc)
    return out


def seal_bits(x: torch.Tensor, key: int, counter: int) -> torch.Tensor:
    """Losslessly cipher a 2D float tensor (f32 or bf16) -> int32/int16 of
    the same bit width; ``unseal_bits`` restores it bit for bit."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"seal_bits takes float32 or bfloat16, got {x.dtype}")
    if not x.is_cuda:
        return ref.seal_bits_ref(x, key, counter)
    out = _bits_xor(x, key, counter, int_dtype_of(x.dtype))
    LAUNCHES["seal_bits"] += 1
    return out


def unseal_bits(cipher: torch.Tensor, key: int, counter: int,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if cipher.dtype != int_dtype_of(out_dtype):
        raise TypeError(f"cipher dtype {cipher.dtype} does not carry "
                        f"{out_dtype} bits")
    if not cipher.is_cuda:
        return ref.unseal_bits_ref(cipher, key, counter, out_dtype)
    out = _bits_xor(cipher, key, counter, out_dtype)
    LAUNCHES["unseal_bits"] += 1
    return out


# ---------------------------------------------------------------------------
# Paged decode attention (GQA-aware wrapper)
# ---------------------------------------------------------------------------
_PAGED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGED_HEAD_DIMS = (16, 32, 64, 128)
_STATIC_SMEM_LIMIT = 48 * 1024      # the kernel asks for no opt-in beyond it


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """q: [B, H, D] (one decode token per row); k_pages, v_pages:
    [num_pages, KVH, page_size, D]; block_tables: [B, max_pages] int32;
    seq_lens: [B] int32. Returns [B, H, D] in q's type.

    On the card the query heads are grouped as [B, KVH, rep, D] (the
    reference's ops.py does the same) so one kernel block serves every
    query head that shares a KV head."""
    if not q.is_cuda:
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       seq_lens)
    from .build import entry
    B, H, D = q.shape
    N, KVH, Pg, Dk = k_pages.shape
    MP = block_tables.shape[-1]
    _check_cuda("paged_attention", q, k_pages, v_pages, block_tables,
                seq_lens)
    if q.dtype not in _PAGED_DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention takes one of f32/bf16 for q and "
                        f"both pools, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and seq_lens must be "
                        "int32")
    if v_pages.shape != k_pages.shape or Dk != D or H % KVH \
            or tuple(block_tables.shape) != (B, MP) \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_attention: inconsistent shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}, seq_lens "
                         f"{tuple(seq_lens.shape)}")
    rep = H // KVH
    smem = 4 * (rep * D + Pg * (D + 1) + Pg * D)
    if D not in _PAGED_HEAD_DIMS or rep > 32 or Pg > 32 \
            or smem > _STATIC_SMEM_LIMIT:
        raise ValueError(f"paged_attention kernel supports head_dim in "
                         f"{_PAGED_HEAD_DIMS}, rep <= 32, page_size <= 32 and "
                         f"<= 48 KB of shared memory; got D={D}, rep={rep}, "
                         f"page_size={Pg} ({smem} bytes)")
    qg = q.reshape(B, KVH, rep, D)       # GQA: heads grouped by KV head
    out = torch.empty_like(qg)
    with torch.cuda.device(q.device):
        rc = entry("paged_attention")(
            qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, KVH, rep, D, N, Pg, MP, 1.0 / math.sqrt(D),
            _PAGED_DTYPES[q.dtype], _stream(q.device))
    if rc:
        raise _launch_failed("paged_attention", rc)
    LAUNCHES["paged_attention"] += 1
    return out.reshape(B, H, D)
