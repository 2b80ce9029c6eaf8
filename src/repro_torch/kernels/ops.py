"""Public kernel wrappers (port of ``repro/kernels/ops.py``).

Dispatch goes by the tensor's device: a CPU tensor takes the plain PyTorch
version in ``ref``; a CUDA tensor launches the hand-written kernel from
``csrc/`` or raises — there is no fallback for a CUDA tensor and no switch
that turns the kernels off. Each wrapper counts its kernel launches in
``LAUNCHES`` (plain ints, bumped only where a kernel is launched), so a run
can show that its main path went through the kernels. The cipher
kernels (``seal``, ``unseal``, ``seal_bits``, ``unseal_bits``) read their
key and counter from device memory, as one-element int64 tensors
(``_keys``), so a captured launch ciphers under whatever they hold at
replay.
"""
from __future__ import annotations

import math
from typing import Dict, Union

import torch

from . import ref
from .seal import check_key_tensor, int_dtype_of, u32

LAUNCHES: Dict[str, int] = {"paged_attention": 0, "seal_bits": 0,
                            "unseal_bits": 0, "seal_bits_window": 0,
                            "unseal_bits_window": 0, "seal": 0, "unseal": 0,
                            "flash_attention": 0}


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


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The attention kernels copy 16 bytes at a time (cp.async)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel takes tensors that "
                             f"start on a 16-byte boundary")


_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _split_scratch(name: str, device: torch.device, rows: int, D: int,
                   tiles: int):
    """What a split launch needs: f32 (m, l) and acc [rows, D] for the
    parts' partial rows, and int32 counters, one per merged tile. The
    counters are zeros kept between calls, one buffer per kernel, device
    and stream: the last part of a tile resets its counter, so the buffer
    is zero again after each launch. Launches on one stream run in order,
    so they never share counters while in flight; two launches that could
    overlap on one stream's buffer (two captured CUDA graphs replayed on
    different streams) would need a buffer each."""
    key = (name, device, _stream(device))
    ctr = _COUNTERS.get(key)
    if ctr is None or ctr.numel() < tiles:
        ctr = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = ctr
    return (torch.empty(rows * 2, dtype=torch.float32, device=device),
            torch.empty(rows * D, dtype=torch.float32, device=device), ctr)


def _pointers(tensors) -> list:
    """Data pointers, 0 (NULL) for None."""
    return [0 if t is None else t.data_ptr() for t in tensors]


# ---------------------------------------------------------------------------
# Split plan of the paged decode kernel (plain Python, shared by the
# wrapper and the CPU tests of the merge rule)
# ---------------------------------------------------------------------------
def _page_splits(B: int, KVH: int, MP: int, sms: int) -> int:
    """Page splits per (row, KV head) of the paged kernel: enough for eight
    blocks per SM (small blocks, many resident; a split's pages are a
    chain of dependent rounds, so shorter chains finish sooner), none
    covering fewer than two of the table's MP pages, at most 32 (one
    merging lane each)."""
    return max(1, min(-(-8 * sms // (B * KVH)), MP // 2, 32))


def _page_part(split: int, splits: int, MP: int, seq_len: int, Pg: int):
    """Table pages [p0, p1) that split ``split`` reads for a row of length
    ``seq_len`` (the kernel's rule); empty when p0 >= p1."""
    per = -(-MP // splits)
    live = min(-(-seq_len // Pg), MP) if seq_len > 0 else 0
    p0 = split * per
    return p0, max(p0, min(live, p0 + per))


# ---------------------------------------------------------------------------
# Launch plans of the cipher kernels (plain Python, shared by the wrappers
# and the CPU tests of coverage)
# ---------------------------------------------------------------------------
def _cipher_plan(n: int, elem_bytes: int, vec_ok: bool):
    """(threads per block, blocks) of the page cipher for n elements. An
    item is one 16-byte vector when both pointers are 16-byte aligned,
    else one element; thread g takes item g, and the first threads one
    tail element each past the last whole vector. Blocks of 256 threads:
    at the swap path's [10, 131072] bf16 that is 640 blocks, at most 5 on
    an SM of an H100, within 3% of an even share."""
    items = n // (16 // elem_bytes if vec_ok else 1)
    return 256, max(1, -(-items // 256))


_SEAL_EPT = 4          # elements a thread of the seal kernel holds (kEpt)


def _seal_threads(cols: int) -> int:
    """Threads per block of the quantizing seal: one block per row, thread
    t holding columns t * 4 .. t * 4 + 3 of each tile of threads * 4
    columns; enough threads (a multiple of 32, at most 1024) that one tile
    covers the row where it can."""
    return min(1024, 32 * max(1, -(-cols // (32 * _SEAL_EPT))))


# most threads per block of the quantizing unseal: of 32 .. 512 in
# ``python -m repro_torch.launch.sweep_seal``, 128 and 256 were within noise
# of each other at [4, 2048] and [8, 2048] bf16 on an H100, and 128 the
# fastest at the stage boundary's [4, 2048] (PERF.md section 6)
_UNSEAL_THREADS = 128


def _unseal_plan(cols: int):
    """(threads per block, column tiles) of the quantizing unseal, the
    same for every row: block (x, row) holds a tile of threads * 4 columns
    of its row, thread t columns x * threads * 4 + t * 4 .. + 3 below cols;
    threads a multiple of 32, at most ``_UNSEAL_THREADS``, fewer where the
    row is narrower than one such tile, and no tile empty."""
    threads = min(_UNSEAL_THREADS, 32 * max(1, -(-cols // (32 * _SEAL_EPT))))
    return threads, -(-cols // (threads * _SEAL_EPT))


# ---------------------------------------------------------------------------
# Key and counter of the cipher kernels
# ---------------------------------------------------------------------------
KeyArg = Union[int, torch.Tensor]


def _keys(name: str, device: torch.device, key: KeyArg, counter: KeyArg):
    """``key`` and ``counter`` as the cipher kernels read them: each a
    one-element int64 tensor on ``device``, from device memory, as the
    Pallas kernels read ``key_ref[0]`` / ``ctr_ref[0]``. A CUDA graph
    that captured the launch then ciphers under whatever the tensors hold
    when it is replayed. An int becomes such a tensor here (a host-to-
    device copy, for eager callers and the tests; a captured caller passes
    tensors); a tensor on another device raises; any other integer type is
    widened to int64 on the device (its low 32 bits are the word)."""
    out = []
    for what, v in (("key", key), ("counter", counter)):
        if isinstance(v, torch.Tensor):
            if v.device != device:
                raise ValueError(f"{name}: {what} on {v.device}, data on "
                                 f"{device}")
            check_key_tensor(v)
            v = v.reshape(1)
            if v.dtype != torch.int64:
                v = v.to(torch.int64)
            out.append(v)
        else:
            out.append(torch.tensor([u32(v)], dtype=torch.int64,
                                    device=device))
    return out


def _check_plain_keys(name: str, device: torch.device, *vals) -> None:
    for v in vals:
        if isinstance(v, torch.Tensor) and v.device != device:
            raise ValueError(f"{name}: key or counter on {v.device}, data "
                             f"on {device}")


# ---------------------------------------------------------------------------
# Quantizing activation seal (stage boundaries)
# ---------------------------------------------------------------------------
_Q8_DTYPES = (torch.float32, torch.bfloat16)


def seal(x: torch.Tensor, key: KeyArg, counter: KeyArg):
    """x [rows, cols] f32/bf16 -> (cipher uint8 [rows, cols], scales f32
    [rows, 1]): per-row int8 quantization XOR the keystream's top byte.
    ``key`` and ``counter``: ints or one-element integer tensors on x's
    device."""
    if x.dtype not in _Q8_DTYPES or x.dim() != 2:
        raise TypeError(f"seal takes a 2D float32 or bfloat16 tensor, got "
                        f"{x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        _check_plain_keys("seal", x.device, key, counter)
        return ref.seal_ref(x, key, counter)
    from .build import entry
    _check_cuda("seal", x)
    kt, ct = _keys("seal", x.device, key, counter)
    rows, cols = x.shape
    cipher = torch.empty((rows, cols), dtype=torch.uint8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    vec_ok = int(x.data_ptr() % 16 == 0 and cipher.data_ptr() % 4 == 0
                 and cols % 4 == 0)
    with torch.cuda.device(x.device):
        rc = entry("seal_q8")(
            x.data_ptr(), cipher.data_ptr(), scales.data_ptr(), rows, cols,
            kt.data_ptr(), ct.data_ptr(), x.element_size(), vec_ok,
            _seal_threads(cols), _stream(x.device))
    if rc:
        raise _launch_failed("seal", rc)
    LAUNCHES["seal"] += 1
    return cipher, scales


def unseal(cipher: torch.Tensor, scales: torch.Tensor, key: KeyArg,
           counter: KeyArg, out_dtype: torch.dtype = torch.bfloat16
           ) -> torch.Tensor:
    """Inverse of ``seal`` up to the quantization -> ``out_dtype``
    [rows, cols]."""
    if cipher.dtype != torch.uint8 or cipher.dim() != 2 \
            or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (cipher.shape[0], 1) \
            or out_dtype not in _Q8_DTYPES:
        raise TypeError(f"unseal takes uint8 [rows, cols] cipher text, f32 "
                        f"[rows, 1] scales and a float32/bfloat16 out type; "
                        f"got {cipher.dtype} {tuple(cipher.shape)}, "
                        f"{scales.dtype} {tuple(scales.shape)}, {out_dtype}")
    if not cipher.is_cuda:
        _check_plain_keys("unseal", cipher.device, key, counter)
        return ref.unseal_ref(cipher, scales, key, counter, out_dtype)
    from .build import entry
    _check_cuda("unseal", cipher, scales)
    kt, ct = _keys("unseal", cipher.device, key, counter)
    rows, cols = cipher.shape
    out = torch.empty((rows, cols), dtype=out_dtype, device=cipher.device)
    vec_ok = int(cipher.data_ptr() % 4 == 0
                 and out.data_ptr() % (4 * out.element_size()) == 0
                 and cols % 4 == 0)
    with torch.cuda.device(cipher.device):
        rc = entry("unseal_q8")(
            cipher.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, cols,
            kt.data_ptr(), ct.data_ptr(), out.element_size(), vec_ok,
            *_unseal_plan(cols),
            _stream(cipher.device))
    if rc:
        raise _launch_failed("unseal", rc)
    LAUNCHES["unseal"] += 1
    return out


# ---------------------------------------------------------------------------
# Lossless page cipher
# ---------------------------------------------------------------------------
def _window(name: str, x: torch.Tensor, col0: int, row_cols):
    """``(col0, row_cols)`` checked, or None for a whole row (the
    defaults, or a window that is the whole row)."""
    if x.dim() != 2:
        raise ValueError(f"{name} takes [rows, cols], got {tuple(x.shape)}")
    cols = x.shape[1]
    row_cols = cols if row_cols is None else int(row_cols)
    col0 = int(col0)
    if col0 == 0 and row_cols == cols:
        return None
    if col0 < 0 or col0 + cols > row_cols:
        raise ValueError(f"{name}: columns [{col0}, {col0 + cols}) outside "
                         f"rows of {row_cols}")
    if cols % 8:
        raise ValueError(f"{name}: a window of {cols} columns; the kernel "
                         f"takes a multiple of 8, so that no 16-byte vector "
                         f"straddles two rows")
    return col0, row_cols


def _bits_xor(x: torch.Tensor, key: KeyArg, counter: KeyArg,
              out_dtype: torch.dtype, window) -> torch.Tensor:
    from .build import entry
    _check_cuda("seal_bits", x)
    kt, ct = _keys("seal_bits", x.device, key, counter)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    vec_ok = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    plan = _cipher_plan(x.numel(), x.element_size(), bool(vec_ok))
    cols, (col0, row_cols) = (0, (0, 0)) if window is None \
        else (x.shape[1], window)
    with torch.cuda.device(x.device):
        rc = entry("seal_bits")(
            x.data_ptr(), out.data_ptr(), x.numel(), kt.data_ptr(),
            ct.data_ptr(), x.element_size(), vec_ok, cols, row_cols, col0,
            *plan, _stream(x.device))
    if rc:
        raise _launch_failed("seal_bits", rc)
    return out


def seal_bits(x: torch.Tensor, key: KeyArg, counter: KeyArg, col0: int = 0,
              row_cols=None) -> torch.Tensor:
    """Losslessly cipher a 2D float tensor (f32 or bf16) -> int32/int16 of
    the same bit width; ``unseal_bits`` restores it bit for bit. ``key``
    and ``counter``: ints or one-element integer tensors on x's device.
    ``col0`` and ``row_cols`` place x as columns [col0, col0 + cols) of
    rows ``row_cols`` wide (a pipeline rank's layers of a swap row): its
    cipher is those columns of the whole row's. The defaults are the whole
    row. A window's launches count as ``seal_bits_window``."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"seal_bits takes float32 or bfloat16, got {x.dtype}")
    window = _window("seal_bits", x, col0, row_cols)
    if not x.is_cuda:
        _check_plain_keys("seal_bits", x.device, key, counter)
        return ref.seal_bits_ref(x, key, counter, col0, row_cols)
    out = _bits_xor(x, key, counter, int_dtype_of(x.dtype), window)
    LAUNCHES["seal_bits" if window is None else "seal_bits_window"] += 1
    return out


def unseal_bits(cipher: torch.Tensor, key: KeyArg, counter: KeyArg,
                out_dtype: torch.dtype = torch.bfloat16, col0: int = 0,
                row_cols=None) -> torch.Tensor:
    """The inverse of ``seal_bits`` under the same key, counter and
    window."""
    if cipher.dtype != int_dtype_of(out_dtype):
        raise TypeError(f"cipher dtype {cipher.dtype} does not carry "
                        f"{out_dtype} bits")
    window = _window("unseal_bits", cipher, col0, row_cols)
    if not cipher.is_cuda:
        _check_plain_keys("unseal_bits", cipher.device, key, counter)
        return ref.unseal_bits_ref(cipher, key, counter, out_dtype, col0,
                                   row_cols)
    out = _bits_xor(cipher, key, counter, out_dtype, window)
    LAUNCHES["unseal_bits" if window is None else "unseal_bits_window"] += 1
    return out


# ---------------------------------------------------------------------------
# Paged decode attention (GQA-aware wrapper)
# ---------------------------------------------------------------------------
_PAGED_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGED_HEAD_DIMS = (16, 32, 64, 128)
_SMEM_LIMIT = 227 * 1024            # a block's shared memory on sm_90


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                    kv_head0: int = 0, rep=None):
    """q: [B, H, D] (one decode token per row); k_pages, v_pages:
    [num_pages, KVH, page_size, D]; block_tables: [B, max_pages] int32;
    seq_lens: [B] int32. Returns [B, H, D] in q's type.

    On the card the query heads are grouped as [B, KVH, rep, D] (the
    reference's ops.py does the same) so one kernel block serves every
    query head that shares a KV head. ``rep`` (default H / KVH) and
    ``kv_head0`` (default 0) give a tensor-parallel rank's launch where its
    H query heads read H / rep KV heads from ``kv_head0`` on of pools that
    hold all KVH (KV heads that stayed whole over the model axis): the
    kernel reads those heads of the pools in place. The defaults are the
    one-card launch."""
    B, H, D = q.shape
    N, KVH, Pg, Dk = k_pages.shape
    rep = H // KVH if rep is None else int(rep)
    kv_head0 = int(kv_head0)
    if rep < 1 or H % rep or kv_head0 < 0 or kv_head0 + H // rep > KVH:
        raise ValueError(f"paged_attention: {H} query heads at rep {rep} "
                         f"read KV heads [{kv_head0}, "
                         f"{kv_head0 + H // max(rep, 1)}) of {KVH}")
    if not q.is_cuda:
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       seq_lens, kv_head0, rep)
    from .build import entry
    G = H // rep                         # KV heads read: the grid's groups
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
    if v_pages.shape != k_pages.shape or Dk != D \
            or tuple(block_tables.shape) != (B, MP) \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_attention: inconsistent shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}, seq_lens "
                         f"{tuple(seq_lens.shape)}")
    # a two-page ring of K and V pages, the queries and a page of P per warp
    smem = 4 * Pg * D * q.element_size() + 4 * (rep * D + rep * 32)
    if D not in _PAGED_HEAD_DIMS or rep > 32 or Pg > 32 \
            or smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention kernel supports head_dim in "
                         f"{_PAGED_HEAD_DIMS}, rep <= 32, page_size <= 32 and "
                         f"<= 227 KB of shared memory; got D={D}, rep={rep}, "
                         f"page_size={Pg} ({smem} bytes)")
    qg = q.reshape(B, G, rep, D)         # GQA: heads grouped by KV head
    out = torch.empty_like(qg)
    _check_aligned("paged_attention", qg, k_pages, v_pages)
    splits = _page_splits(B, G, MP, _sm_count(q.device))
    scratch = (None,) * 3 if splits == 1 else _split_scratch(
        "paged_attention", q.device, B * G * splits * rep, D, B * G)
    with torch.cuda.device(q.device):
        rc = entry("paged_attention")(
            qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            *_pointers(scratch),
            B, G, rep, D, N, Pg, MP, KVH, kv_head0, 1.0 / math.sqrt(D),
            splits, _PAGED_DTYPES[q.dtype], _stream(q.device))
    if rc:
        raise _launch_failed("paged_attention", rc)
    LAUNCHES["paged_attention"] += 1
    return out.reshape(B, H, D)


# ---------------------------------------------------------------------------
# Prefill attention (flash attention, GQA-aware wrapper)
# ---------------------------------------------------------------------------
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: [B, Sq, H, D]; k, v: [B, Sk, KVH, D]. Returns [B, Sq, H, D] in
    q's type. Query i sits at absolute position ``q_offset + i`` and the
    keys at 0 .. Sk-1; query head h reads KV head ``h // (H // KVH)``.

    On the CPU the KV heads are repeated and the heads moved ahead of the
    sequence, as the reference's wrapper does, for the plain version. On
    the card the kernel reads the model's layout as it is."""
    B, Sq, H, D = q.shape
    Bk, Sk, KVH, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D or H % KVH:
        raise ValueError(f"flash_attention: inconsistent shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if q_offset < 0 or window < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} and window "
                         f"{window} must be >= 0")
    if causal and Sk < q_offset + Sq:
        raise ValueError(f"flash_attention: causal queries at positions "
                         f"{q_offset}..{q_offset + Sq - 1} need Sk >= "
                         f"{q_offset + Sq} keys, got {Sk}")
    if not q.is_cuda:
        rep = H // KVH
        kk = k.repeat_interleave(rep, dim=2) if rep > 1 else k
        vv = v.repeat_interleave(rep, dim=2) if rep > 1 else v
        out = ref.flash_attention_ref(
            q.transpose(1, 2), kk.transpose(1, 2), vv.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset)
        return out.transpose(1, 2).contiguous()
    from .build import entry
    _check_cuda("flash_attention", q, k, v)
    if q.dtype not in _FLASH_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of f32/bf16 for q, k and "
                        f"v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _FLASH_HEAD_DIMS or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention kernel supports head_dim in "
                         f"{_FLASH_HEAD_DIMS} and B, H <= 65535; got D={D}, "
                         f"B={B}, H={H}")
    refuse_untracked_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    _check_aligned("flash_attention", q, k, v)
    with torch.cuda.device(q.device):
        rc = entry("flash_attention")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KVH, D, int(bool(causal)), int(window), int(q_offset),
            1.0 / math.sqrt(D), _FLASH_DTYPES[q.dtype], _stream(q.device))
    if rc:
        raise _launch_failed("flash_attention", rc)
    LAUNCHES["flash_attention"] += 1
    return out


def refuse_untracked_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel writes its output through a raw pointer, outside autograd:
    called while autograd records, on inputs that require grad, it would
    silently cut their gradient. Raise instead; training goes through
    ``FlashAttentionFn``, whose forward runs with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel's output carries no autograd graph, "
            f"so the inputs' gradient would be dropped; call it through "
            f"FlashAttentionFn (flash_attention_train) or under "
            f"torch.no_grad()")


class FlashAttentionFn(torch.autograd.Function):
    """Prefill attention under autograd. Forward: ``flash_attention`` (the
    kernel on a CUDA tensor, the plain version on a CPU tensor). Backward:
    ``ref.flash_attention_bwd_ref`` on both devices, plain PyTorch as the
    reference's gradient is plain ``jnp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        o = flash_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = (causal, window, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = ref.flash_attention_bwd_ref(
            q, k, v, o, do, causal=causal, window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, causal: bool = True, window: int = 0,
                          q_offset: int = 0):
    """``flash_attention`` with a gradient (``FlashAttentionFn``)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
