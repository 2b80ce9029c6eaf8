#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a, one process per source in parallel); the flash library's SASS
     must hold HGMMA (wgmma) instructions, no attention, cipher or seal
     kernel may spill registers, and the cipher's, the seal's and the
     unseal's SASS instructions per element are printed;
  2. hold every kernel against its plain PyTorch version on the card at the
     serving path's shapes (paged attention: bf16 and f32 pools, 8 rows, 8
     KV heads, rep 4, head_dim 64, page 16, tables of 10 and 34 pages,
     and at head_dim 128 rep 3 over 8 KV heads, rep 16 over 2 and rep 1
     over 16, ragged seq_lens with an idle row, shared pages; page cipher:
     the swap rows of llama3.2-1b, -3b and qwen2-moe-a2.7b,
     [pages_per_slot, 131072], [pages_per_slot, 458752] and
     [pages_per_slot, 786432], f32 and bf16, bit-exact, plus every tail
     length of a vector and tensors one element past a 16-byte boundary;
     quantizing seal: the stage boundary's [4, 2048] in bf16 and f32 plus
     the reference's test shapes, widths not a multiple of 4 and
     unaligned tensors, one element, a wide row and 70,000 rows, cipher
     bytes equal but for rounding ties, scales equal, unseal bit-equal into
     bf16 and f32, also from cipher views 1 to 3 bytes past a 4-byte
     boundary; prefill attention: the reference's grid,
     ragged lengths, head_dim 128, GQA rep 4, the one-shot, packed and chunk
     shapes of full-width llama, phase 13's training shape (batch 8, seq
     128), the one-shot shapes of phases 11 and 12 (24 heads over 8, 16
     over 16, head_dim 128) and short chunks late in a long prompt, f32
     and bf16); both attention kernels must repeat their bits on a second
     call. At the training shape the flash wrapper must refuse inputs that
     require grad outside ``FlashAttentionFn``, and the Function's forward
     must equal the kernel and its plain backward autograd of the plain
     forward. The seal, the unseal and the cipher read their key and
     counter from device memory: captured once in a CUDA graph over key
     and counter tensors and replayed under two keys written into them,
     each replay must equal the plain version under its key and the two
     replays' cipher texts must differ;
  3. time each kernel, its plain version, one PyTorch library call of the
     same function where one exists, and compute the least time the card
     could take (prefill attention at its four path shapes, paged
     attention at the short and the long decode shape, in bf16; the
     training shape's plain attention backward); also a
     launch floor, a one-element ``zero_()`` under the same timing; each
     kernel and the floor are timed again inside a CUDA graph (50
     back-to-back launches captured, the graph replayed), as a captured
     serving step runs them; the seal, the unseal and the cipher take their
     key and counter as device tensors, as the serving path passes them;
  4. check the whole serving path on a small input: reduced llama3.2-1b in
     f32 serves the same greedy streams on the card as on the CPU, through
     the local backend and through the pipelined backend (sealed stage
     boundaries), each once with one-shot prefill and once with chunked and
     packed prefill (``--prefill-chunk 5 --prefill-pack 3``), whose streams
     must also equal the one-shot run's, and, on the local backend, once
     through the disaggregated pair (``--disagg``), whose streams must
     equal the one-shot run's on both devices; then llama3.2-3b cut to 2
     layers at head_dim 128, rep 3, greedy and sampled, and reduced
     qwen2-moe-a2.7b (MoE FFN, attention biases drawn nonzero) through the
     local and the unsealed pipelined backend, each card vs CPU; then the
     training path: reduced llama3.2-1b in f32, one loss and every
     gradient card vs CPU (the flash kernel launched 2 x layers), three
     steps card vs CPU, and on the card in f32 and bf16 two straight runs
     bit-equal and a checkpointed, resumed run bit-equal to them;
  5. serve full-width llama3.2-1b (16 layers, d_model 2048, vocab 128,256)
     in bf16 with seeded random weights through ``ServingEngine`` on the
     local backend: 8 slots, 16 requests with a shared system prompt, 32
     new tokens each, a page pool tight enough that demand paging
     swap-preempts. The launch counts are zeroed just before and read just
     after: paged attention must have run num_layers times per decode step,
     the cipher on every swap, and every swap-in must restore the gathered
     pages bit for bit;
  6. serve the same stream through the pipelined backend (``--stages 2
     --microbatches 2`` over two enclaves, so the planner places blocks
     (1, 15)), seal on: seal and unseal must have run nm * (S - 1) times
     per step, paged attention nm * num_layers times per step plus the
     telemetry's stage probes (graph replays, as on every engine on the
     card), no re-plan, the cipher on every swap, every swap-in
     bit-exact and every logit finite. In phases 5 to 7 prefill attention
     must have run num_layers times per prefill call;
  7. serve full-width llama3.2-1b in bf16 on the local backend with prompts
     of up to 512 tokens, chunked prefill (chunks of 128) and packed
     prefill (up to 4 prompts a call), 32 requests over a 116-page pool,
     chosen by a CPU rehearsal of the same flags so that this one stream
     chunks, packs and swap-preempts. Prints admission p50/p99, ms per
     chunk, prefill tokens/s and decode ms per step;
  8. serve phase 5's, phase 7's and phase 6's streams again, each on a
     fresh engine warmed up as CUDA graphs (``--warmup``: the decode step
     -- on the pipelined backend one per stage layout, with the stage
     probes, for the planned layout and the one the warmup tours -- every
     one-shot and packed prefill bucket, every chunk offset and the swap
     I/O captured, each later call one replay): the greedy streams, the
     schedule (stage blocks (1, 15) and no re-plan on the pipelined
     backend) and the launch counts (replays included) must equal the
     eager phase's, with no capture and no stall after warmup and every
     swap-in bit-exact. Prints warmup seconds, graphs, memory reserved,
     and host ms per decode step and per chunk beside the eager phase's;
  9. serve phase 5's stream through the disaggregated pair (``--disagg``:
     a prefill-role and a decode-role engine over phase 5's ``params``,
     each prompt's KV sealed with the page cipher under a transfer counter
     and handed over), eagerly and then on a pair warmed up as CUDA graphs:
     the streams must equal phase 5's (and, eagerly, a no-peer fallback
     orchestrator's), the handoffs the requests that did not finish at
     prefill, every sealed row a transfer-in restores the prefill role's
     gathered plaintext bit for bit; the cipher must have run twice on
     every export, transfer-in and swap, flash attention num_layers times
     per prefill call of either role and paged attention num_layers times
     per decode step; the warmed pair's launch counts (replays included)
     must equal the eager pair's, with no capture and no stall after
     warmup on either role. Prints handoffs, back-pressure events,
     COW-adopted rows, host ms per export and per transfer-in, decode ms
     per step, admission p50/p99 and memory reserved, beside phases 5 and
     8, with the card's name and power limit;
 10. the chaos fault plane and the recovery ladder, on full-width
     llama3.2-1b in f32 (phase 5's params upcast, exact; TF32 off), each
     chaotic run against a fault-free run of the same stream and flags:
     (a) phase 5's stream on the local backend warmed as CUDA graphs under
     ``FaultConfig.chaos(seed, corrupt_swap=0.5, pool_storm=0.2,
     device_death=0.3)``; (b) phase 9's pair warmed as CUDA graphs under
     ``--chaos``'s mix (tampered swaps and transfers, handoff drops and
     delays, stalls, storms); (c) phase 6's stream pipelined, sealed
     boundaries, eager, ``allow_swap`` off, one certain device death. Each
     part: streams equal the fault-free run's, every request done and none
     failed, every injected fault accounted to a recovery rung or a
     pending marker (both roles in (b)), every armed site fired, every
     adopted swap-in and transfer-in restores the gathered plaintext bit
     for bit, no block table holds a page scattered from a rejected
     payload, the cipher ran on every swap, export and scatter (rejected
     scatters included) and flash and paged attention once a layer per
     prefill call and decode step; (a) and (b) capture nothing after
     warmup; (c) re-plans once around the corpse and keeps blocks (1, 15).
     Prints injected faults and rungs, launches, decode ms per step and
     admission p50/p99 beside the fault-free run's, host ms from a device
     death to each spilled request's next token and per tamper fallback;
 11. serve full-width llama3.2-3b (28 layers, head_dim 128, rep 3) in
     bf16 over phase 5's stream and pool, sampled at temperature 0.8,
     top-k 50: local eager twice, warmed as CUDA graphs and through the
     disaggregated pair, one set of streams; then greedy eager and in
     graphs, the sampler's yardstick;
 12. serve full-width qwen2-moe-a2.7b (24 layers, 60 routed experts top-4
     plus 4 shared, no-drop dispatch, attention biases, 16 heads over 16
     KV heads at head_dim 128) in bf16, greedy, over phase 5's stream and
     pool: local eager twice and warmed as CUDA graphs (one set of
     streams, schedules and launch counts, nothing captured after
     warmup), then pipelined eager over two enclaves with two microbatches
     and sealed boundaries (blocks (4, 20), no re-plan, nm x (S - 1) seals
     a step); every swap-in bit-exact, every logit finite. Prints the
     parameters, init seconds, ms per decode step, decode tokens/s,
     admission p50/p99 and memory reserved and at peak;
 13. train full-width llama3.2-1b in bf16 through ``launch.train.main``
     (the launcher's defaults: batch 8, seq 128, lr 1e-3, warmup steps /
     10; f32 master and moments; deterministic algorithms), 30 steps, no
     checkpoint directory: every loss and grad norm finite, the mean of the
     last 5 losses below the first, the flash kernel launched 2 x 16 times
     a step (forward and remat recompute). Prints the loss curve, ms per
     step, tokens/s, memory, the bytes a checkpoint would write and a
     model-FLOP estimate against the bf16 peak;
 14. the timeline KV layout, per-token prefill and the int8 KV cache on
     full-width llama3.2-1b: (a) in f32, one stream of 8 requests (prompts
     2-42 tokens, 32 new) through the timeline, paged with per-token
     prefill and paged batched, streams equal; (b) in bf16, phase 5's
     first 8 requests on the timeline local eager, local in CUDA graphs
     (equal streams, steps and launches, nothing captured after warmup),
     pipelined at blocks (1, 15) with sealed boundaries (seal and unseal
     nm x (S - 1) a step) and paged with per-token prefill in graphs, then
     the timeline under a horizon too short for the stream (back-pressure,
     a permanent stall, every request done or queued); (c) the int8
     cache's prefill then decode on 4 x 31 tokens plus one against bf16
     (top-1 on every row, relative logit error < 0.15, cache bytes < 0.55
     x) and the reference's zero-scale int8 engine, logged. Prints ms per
     decode step and per prefill token, tokens/s, admission p50/p99,
     memory and the phase's wall time;
 15. the paper's planning and privacy path: (a) the reduced llama3.2-1b
     in f32, card against CPU (hidden states, similarity profile, private
     depth, plans), then ``StackedLM.hidden_states_fn`` of full-width
     llama3.2-1b in bf16 on a calibration batch of 8 x 128 seeded tokens
     (16 flash launches, [17, 8, 128, 2048]), ``lm_similarity_profile``,
     the private depth and the quickstart's plan over two trusted pods, a
     trusted and an untrusted pod and the paper's TEE + GPU, C2 checked on
     each; (b) TinyCNN over the five CNN tables on a 224 x 224 frame, card
     against CPU, and ``downsample_similarity`` on the card with the
     reference test's asserts; (c) the Fig. 12 speedups through the port's
     planner with the paper's claims asserted, ``simulate_pipeline`` =
     Eq. 1-2 on every chosen plan, and the attestation stub over the
     full-width params' payload digest. Prints the forward's host ms, the
     profile, the plans, the speedups and the phase's wall time.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and convolutions,
so f32 products are full f32. Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA H100 datasheet)
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# 32-bit integer ALU ops: 64 INT32 lanes per SM (Hopper white paper)
# x 132 SMs x 1.98 GHz boost clock — the same clock the 67 TFLOP/s f32
# figure assumes (128 lanes x 2 FLOP x 132 x 1.98 GHz)
INT32_OP_PER_S = 64 * 132 * 1.98e9
KEYSTREAM_OPS = 18               # 32-bit ops per element of the cipher
# per element of the quantizing seal, beyond the keystream: int32 (top
# byte shift, low byte mask, XOR, sign extension) and f32 (abs, max, divide,
# rint, two clamps / a multiply and a convert)
SEAL_INT_OPS, SEAL_F32_OPS = KEYSTREAM_OPS + 3, 6
UNSEAL_INT_OPS, UNSEAL_F32_OPS = KEYSTREAM_OPS + 3, 2
BF16_TC_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` by CUDA events behind a spin kernel:
    ``repro_torch.launch.timing.time_ms``, which the plan sweeps share."""
    from repro_torch.launch.timing import time_ms as timed
    return timed(fn, iters, warmup)


def graph_ms(fn) -> float:
    """Mean device time of one call of ``fn`` among 50 back-to-back calls
    captured in a CUDA graph (``repro_torch.launch.timing.graph_time_ms``):
    a kernel's cost inside a captured serving step."""
    from repro_torch.launch.timing import graph_time_ms
    return graph_time_ms(fn)


def bound(bytes_moved: float, *work):
    """ms the card needs at least: the larger of the bytes over the memory
    rate and the operations over their peak rates; ``work`` is pairs
    (operations, operations per second), one per type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(ops / rate for ops, rate in zip(work[::2], work[1::2])) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def sass_opcodes(build, name):
    """{function (mangled) name: [opcode, ...]} of the library built from
    ``csrc/<name>.cu``, from ``cuobjdump --dump-sass`` (NOPs dropped)."""
    import re
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(build._target(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+"
                     r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and cur is not None and m.group(1) != "NOP":
            cur.append(m.group(1))
    return funcs


def _one(funcs, key):
    hits = [ops for fn, ops in funcs.items() if key in fn]
    assert len(hits) == 1, f"{key}: {len(hits)} functions in {list(funcs)}"
    return hits[0]


def marginal(more, fewer, elems):
    """SASS instructions per element that more elements a thread add: the
    difference of two instantiations that differ in the elements a thread
    moves, over the elements they differ by (set-up and tail cancel), in
    total and by opcode."""
    from collections import Counter
    a, b = Counter(more), Counter(fewer)
    by_op = {op: (a[op] - b[op]) / elems for op in a | b if a[op] != b[op]}
    return (len(more) - len(fewer)) / elems, dict(
        sorted(by_op.items(), key=lambda kv: -kv[1]))


def check_redesigned_build(build):
    """The bf16 flash kernel must run on the tensor cores: its library's
    SASS holds HGMMA (wgmma) instructions. No redesigned kernel (flash and
    paged attention, the page cipher, the quantizing seal) may spill
    registers. Prints the SASS instructions per element of the cipher, the
    seal and the unseal."""
    import re
    for name in ("flash_attention", "paged_attention", "seal_bits",
                 "seal_q8"):
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill",
                                             build.BUILD_LOG.get(name, ""))]
        assert spills and not any(spills), f"{name}: register spills {spills}"
    flash = sass_opcodes(build, "flash_attention")
    hgmma = sum(op == "HGMMA" for ops in flash.values() for op in ops)
    log(f"  flash_attention SASS: {hgmma} HGMMA instructions; no spills in "
        f"the attention, cipher and seal kernels")
    assert hgmma > 0, "the bf16 flash kernel is not on the tensor cores"
    # bits_xor_kernel<T, VEC>: u16 't' / u32 'j'; a 16-byte vector (VEC =
    # true, 'Lb1E') against one element (VEC = false, 'Lb0E') a thread
    bits = sass_opcodes(build, "seal_bits")
    for label, vec, scalar, per in (
            ("seal_bits bf16", "bits_xor_kernelItLb1E",
             "bits_xor_kernelItLb0E", 8),
            ("seal_bits f32", "bits_xor_kernelIjLb1E",
             "bits_xor_kernelIjLb0E", 4)):
        n, by_op = marginal(_one(bits, vec), _one(bits, scalar), per - 1)
        top = ", ".join(f"{op} {k:g}" for op, k in list(by_op.items())[:8])
        log(f"  {label} SASS: {n:g} instructions per element, the vector "
            f"thread's beyond the one-element thread's ({top})")
    # seal_q8_kernel<bf16, VEC = true>: its whole code over the 4 elements
    # a thread holds, the later-tile loops included (the length prefix of
    # the mangled name tells it from unseal_q8_kernel)
    q8 = sass_opcodes(build, "seal_q8")
    seal = _one(q8, "14seal_q8_kernelI13__nv_bfloat16Lb1E")
    log(f"  seal bf16 SASS: {len(seal)} instructions in the kernel, "
        f"{len(seal) / 4:g} per element held (an upper bound: the loops "
        f"over later tiles do not run at 2048 columns)")
    # unseal_q8_kernel<T, VEC>: each thread opens 4 elements, with no loop,
    # so the vector kernel's whole code over 4 is its cost per element,
    # set-up included; the scalar kernel (byte loads, element stores)
    # beside it
    for label, t in (("bf16", "I13__nv_bfloat16"), ("f32", "If")):
        vec = _one(q8, f"16unseal_q8_kernel{t}Lb1E")
        scalar = _one(q8, f"16unseal_q8_kernel{t}Lb0E")
        n, by_op = marginal(vec, [], 4)
        top = ", ".join(f"{op} {k:g}" for op, k in list(by_op.items())[:8])
        log(f"  unseal {label} SASS: {len(vec)} instructions in the vector "
            f"kernel, {n:g} per element, set-up included ({top}); the "
            f"scalar kernel {len(scalar)}")
    log(f"  the cipher's bound counts KEYSTREAM_OPS = {KEYSTREAM_OPS} "
        f"32-bit operations per element")


# paged attention shapes: phase 5's decode (128-token prompts, MP = 10)
# and phase 7's (512-token prompts + 32 new tokens: MP = 34 over 116 pages)
PAGED_SHORT = dict(MP=10, N=30)
PAGED_LONG = dict(MP=34, N=116, seq_lens=(544, 0, 1, 16, 17, 300, 543, 129))
# head_dim 128: phase 11's decode (llama3.2-3b, 8 KV heads, rep 3, the
# same 10-page tables over 30 pages), glm4-9b's grouping (2 KV heads,
# rep 16) and phase 12's decode (qwen2-moe-a2.7b, 16 KV heads, rep 1: one
# warp a block)
PAGED_D128 = {"d128 rep3": dict(KVH=8, rep=3, D=128, MP=10, N=30),
              "d128 rep16": dict(KVH=2, rep=16, D=128, MP=10, N=30),
              "d128 rep1": dict(KVH=16, rep=1, D=128, MP=10, N=30)}
# the page cipher's row on the swap and handoff paths (``gather_pages``:
# [pages, layers x KV heads x page size x head_dim]) for the three served
# models; the first is the kernels line's shape
CIPHER_COLS = {"llama3.2-1b": 16 * 8 * 16 * 64,
               "llama3.2-3b": 28 * 8 * 16 * 128,
               "qwen2-moe-a2.7b": 24 * 16 * 16 * 128}


def paged_inputs(torch, dtype, B=8, KVH=8, rep=4, D=64, Pg=16, MP=10, N=30,
                 seed=0, seq_lens=None):
    """Serving-shaped paged-attention inputs: ragged seq_lens with an idle
    row, random tables that alias pages across rows, and one row whose
    table repeats another's prefix (copy-on-write sharing)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, KVH * rep, D).astype(np.float32))
    k = torch.from_numpy(rng.randn(N, KVH, Pg, D).astype(np.float32))
    v = torch.from_numpy(rng.randn(N, KVH, Pg, D).astype(np.float32))
    k[0] = 0
    v[0] = 0
    if seq_lens is None:
        seq_lens = (MP * Pg, 0, 1, 17, 100, 128, MP * Pg - 1, 64)
    sl = np.array(seq_lens, np.int32)[:B]
    bt = rng.randint(1, N, size=(B, MP)).astype(np.int32)
    bt[5, :4] = bt[4, :4]                          # shared prefix pages
    bt[1] = 0                                      # idle row: null table
    for b in range(B):
        bt[b, -(-int(sl[b]) // Pg):] = 0           # null tail past the length
    dev = "cuda"
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bt).to(dev), torch.from_numpy(sl).to(dev))


def check_paged_attention(torch, ops, ref):
    """Kernel vs plain version on the card, at the short and the long
    decode shape (the long one's seq_lens 0, 1, 16, 17 and MP * Pg leave
    splits past a row's length). Rows with seq_len > 0 must agree: bf16
    within atol 1e-3 + rtol 1e-2 (both sides accumulate in f32 and round
    once to bf16, whose spacing is 2**-8..2**-7 of the value, so they may
    land one bf16 step apart), f32 within atol = rtol = 3e-5. Idle rows:
    the kernel writes zeros (the engine ignores them), the plain version
    the reference's uniform mean; both must be finite. A second call must
    give the same bits (splits merge in split order). Returns the largest
    error per type at the short shape."""
    results = {}
    for dtype, tol in ((torch.bfloat16, dict(atol=1e-3, rtol=1e-2)),
                       (torch.float32, dict(atol=3e-5, rtol=3e-5))):
        for name, shape in (("short", PAGED_SHORT), ("long", PAGED_LONG),
                            *PAGED_D128.items()):
            q, k, v, bt, sl = paged_inputs(torch, dtype, **shape)
            got = ops.paged_attention(q, k, v, bt, sl)
            again = ops.paged_attention(q, k, v, bt, sl)
            want = ref.paged_attention_ref(q, k, v, bt, sl)
            torch.cuda.synchronize()
            live = sl > 0
            assert torch.isfinite(got.float()).all() and \
                torch.isfinite(want.float()).all()
            assert torch.equal(got, again), "repeated call not bit-equal"
            assert not got[~live].float().any(), "idle rows must be zero"
            err = (got[live].float() - want[live].float()).abs().max().item()
            torch.testing.assert_close(got[live].float(), want[live].float(),
                                       **tol)
            if name == "short":
                results[str(dtype)] = err
            splits = ops._page_splits(q.shape[0], k.shape[1], bt.shape[1],
                                      ops._sm_count(q.device))
            log(f"check paged_attention {dtype} {name} (KVH={k.shape[1]}, "
                f"rep={q.shape[1] // k.shape[1]}, D={q.shape[2]}, MP="
                f"{bt.shape[1]}, {splits} splits): max_abs_err={err:.3e} "
                f"({tol}) rows="
                f"{int(live.sum())} live + {int((~live).sum())} idle, "
                f"repeat bit-equal")
    return results


def check_cipher(torch, ops, ref, sealing, cols, MP=10):
    """Page cipher kernel vs plain version: bit-exact cipher text, and a
    bit-exact round trip in both directions."""
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(MP, cols, generator=g, device="cuda").to(dtype)
        idt = torch.int32 if dtype == torch.float32 else torch.int16
        for seq, part in ((0, 0), (7, 1), (0x3FFFFFFF, 1)):
            ctr = sealing._swap_counter(seq, part)
            ck = ops.seal_bits(x, 0xC0FFEE, ctr)
            cr = ref.seal_bits_ref(x, 0xC0FFEE, ctr)
            assert ck.dtype == idt and torch.equal(ck, cr), \
                f"seal_bits {dtype} ctr {ctr:#x}: cipher differs from ref"
            back = ops.unseal_bits(cr, 0xC0FFEE, ctr, dtype)
            assert torch.equal(back.view(idt), x.view(idt)), "round trip"
            back_ref = ref.unseal_bits_ref(ck, 0xC0FFEE, ctr, dtype)
            assert torch.equal(back_ref.view(idt), x.view(idt))
            assert not torch.equal(ck, x.view(idt)), "cipher == plaintext"
        log(f"check seal_bits/unseal_bits {dtype} [{MP}, {cols}]: "
            f"bit-exact (3 counters, both directions)")
        # every tail length of a 16-byte vector, and contiguous tensors that
        # start one element past a 16-byte boundary (the scalar path)
        ctr = sealing._swap_counter(5, 1)
        cases = [((1, 8 * 37 + r), 0) for r in range(1, 8)] + \
            [((MP, cols), 1), ((3, 2047), 1)]
        for shape, offset in cases:
            n = shape[0] * shape[1]
            base = torch.randn(n + offset, generator=g, device="cuda")
            x = base.to(dtype)[offset:].view(shape)
            assert (x.data_ptr() % 16 == 0) == (offset == 0)
            ck = ops.seal_bits(x, 0xC0FFEE, ctr)
            assert torch.equal(ck, ref.seal_bits_ref(x, 0xC0FFEE, ctr)), \
                f"seal_bits {dtype} {shape} offset {offset}: cipher differs"
            back = ops.unseal_bits(ck, 0xC0FFEE, ctr, dtype)
            assert torch.equal(back.view(idt), x.view(idt)), "round trip"
        log(f"check seal_bits/unseal_bits {dtype}: {len(cases)} odd and "
            f"unaligned cases bit-exact (tails of 1..7, offset by one "
            f"element at [{MP}, {cols}] and [3, 2047])")


# (shape, dtype, offset): offset 1 is a contiguous tensor that starts one
# element past a 16-byte boundary; such tensors and widths not a multiple
# of 4 take the kernel's scalar path
SEAL_Q8_CASES = [((4, 2048), "bfloat16", 0), ((4, 2048), "float32", 0),
                 ((64, 128), "float32", 0), ((256, 512), "bfloat16", 0),
                 ((100, 48), "float32", 0), ((8, 2048), "bfloat16", 0),
                 ((1, 16), "float32", 0), ((3, 2047), "bfloat16", 0),
                 ((5, 7), "float32", 0), ((3, 2052), "bfloat16", 0),
                 ((4, 2048), "bfloat16", 1), ((3, 2047), "bfloat16", 1),
                 ((5, 7), "float32", 1), ((1, 1), "float32", 0),
                 ((1, 5000), "bfloat16", 0), ((64, 8192), "bfloat16", 0),
                 ((70000, 4), "float32", 0)]
# unseal also opens each case's cipher from views this many bytes past a
# 4-byte boundary (1 to 3: the kernel's scalar path), into both out types
UNSEAL_OFFSETS = (0, 1, 2, 3)


def check_seal_q8(torch, ops, ref):
    """Quantizing seal kernel vs plain version: cipher bytes equal but for
    rounding ties (at most 1e-3 of them, the reference's own allowance),
    row scales equal, and unseal of one cipher bit-equal into bf16 and f32,
    from the cipher at each of ``UNSEAL_OFFSETS``. Returns the
    largest difference that the tie mismatches make in the opened values,
    over every case."""
    g = torch.Generator(device="cuda").manual_seed(3)
    err = 0.0
    for shape, dt, offset in SEAL_Q8_CASES:
        dtype = getattr(torch, dt)
        n = shape[0] * shape[1]
        x = (3 * torch.randn(n + offset, generator=g, device="cuda")).to(
            dtype)[offset:].view(shape)
        assert (x.data_ptr() % 16 == 0) == (offset == 0)
        for key, ctr in ((0xC0FFEE + 5, 65537 * 3), (0xFFFFFFFF, 7)):
            c, s = ops.seal(x, key, ctr)
            wc, ws = ref.seal_ref(x, key, ctr)
            mismatch = (c != wc).float().mean().item()
            assert mismatch <= 1e-3, (shape, dt, offset, mismatch)
            assert torch.equal(s, ws), f"seal {shape} {dt}: scales differ"
            assert torch.equal(s.cpu(), ref.seal_ref(x.cpu(), key, ctr)[1]), \
                f"seal {shape} {dt}: scales differ from the CPU's"
            for off in UNSEAL_OFFSETS:
                buf = torch.empty(n + off, dtype=torch.uint8, device="cuda")
                buf[off:] = wc.flatten()
                cv = buf[off:].view(shape)
                assert (cv.data_ptr() % 4 == 0) == (off == 0)
                for out_dt, idt in ((torch.bfloat16, torch.int16),
                                    (torch.float32, torch.int32)):
                    got = ops.unseal(cv, ws, key, ctr, out_dt)
                    want = ref.unseal_ref(wc, ws, key, ctr, out_dt)
                    assert torch.equal(got.view(idt), want.view(idt)), \
                        f"unseal {shape} {out_dt} offset {off} not bit-equal"
            opened = ref.unseal_ref(c, s, key, ctr, torch.float32)
            err = max(err, (opened - ref.unseal_ref(
                wc, ws, key, ctr, torch.float32)).abs().max().item())
        log(f"check seal/unseal {dt} {list(shape)}"
            f"{' offset 1' if offset else ''}: cipher mismatch "
            f"{mismatch:.1e} (<= 1e-3), scales equal, unseal bit-equal "
            f"(cipher offsets {UNSEAL_OFFSETS}, bf16 and f32 out)")
    return err


def check_captured_keys(torch, ops, ref, sealing):
    """The seal, the unseal and the cipher read key and counter from device
    memory: one CUDA graph captures all three over key and counter
    tensors at the path's shapes ([4, 2048] and [10, 131072] bf16), and is
    replayed under two keys written into the key tensor. Each replay must
    equal the plain version under its key (cipher bytes equal but for
    rounding ties, at most 1e-3 of them, and scales equal for the seal;
    bit for bit for the unseal of the replay's own cipher and for the
    cipher), and the two replays' cipher texts must differ: a captured
    launch that kept one keystream would fail here."""
    g = torch.Generator(device="cuda").manual_seed(6)
    x = (3 * torch.randn(4, 2048, generator=g, device="cuda")).to(
        torch.bfloat16)
    pages = torch.randn(10, 131072, generator=g, device="cuda").to(
        torch.bfloat16)
    kt = torch.zeros(1, dtype=torch.int64, device="cuda")
    seal_ctr = torch.tensor([sealing._leaf_counter(2, 0)], device="cuda")
    swap_ctr = torch.tensor([sealing._swap_counter(11, 1)], device="cuda")

    def calls():
        c, s = ops.seal(x, kt, seal_ctr)
        return c, s, ops.unseal(c, s, kt, seal_ctr, torch.bfloat16), \
            ops.seal_bits(pages, kt, swap_ctr)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calls()
    torch.cuda.current_stream().wait_stream(stream)
    counts = dict(ops.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            c, s, opened, b = calls()
    finally:
        ops.LAUNCHES.update(counts)         # a capture launches nothing
    seen = []
    for key in (0xC0FFEE + 1, 0xFFFFFFFF):
        kt.fill_(key)
        graph.replay()
        torch.cuda.synchronize()
        wc, ws = ref.seal_ref(x, key, int(seal_ctr))
        mismatch = (c != wc).float().mean().item()
        assert mismatch <= 1e-3, ("captured seal", key, mismatch)
        assert torch.equal(s, ws), f"captured seal, key {key:#x}: scales"
        want = ref.unseal_ref(c, s, key, int(seal_ctr), torch.bfloat16)
        assert torch.equal(opened.view(torch.int16), want.view(torch.int16)), \
            f"captured unseal, key {key:#x}: not bit-equal"
        assert torch.equal(b, ref.seal_bits_ref(pages, key, int(swap_ctr))), \
            f"captured seal_bits, key {key:#x}: cipher differs"
        seen.append((c.clone(), b.clone(), mismatch))
    assert not torch.equal(seen[0][0], seen[1][0]), "seal replayed one key"
    assert not torch.equal(seen[0][1], seen[1][1]), "cipher replayed one key"
    log(f"check captured seal/unseal/seal_bits (one CUDA graph, key and "
        f"counter in device memory, replayed under 2 keys): each replay "
        f"equals the plain version under its key (seal mismatch "
        f"{max(m for _, _, m in seen):.1e} <= 1e-3, unseal and cipher "
        f"bit-exact), the replays' cipher texts differ")


# prefill attention: B, Sq, Sk, H, KVH, D, causal, window, q_offset
FLASH_PATH = {"one-shot": (1, 512, 512, 32, 8, 64, 1, 0, 0),
              "packed": (4, 128, 128, 32, 8, 64, 1, 0, 0),
              "chunk": (1, 128, 512, 32, 8, 64, 1, 0, 384),
              # phase 13's training step: every layer's attention, forward
              # and remat recompute (llama3.2-1b, batch 8, seq 128)
              "train": (8, 128, 128, 32, 8, 64, 1, 0, 0)}
FLASH_CASES = ([(B, S, S, H, H, D, int(c), w, 0) for B, H, S, D, w, c in (
    (2, 4, 256, 64, 0, True), (1, 2, 128, 32, 64, True),
    (2, 2, 64, 16, 0, True), (1, 1, 512, 64, 0, True),
    (1, 2, 128, 32, 0, False))]                    # tests/test_kernels.py
    + [(2, 77, 77, 4, 2, 64, 1, 0, 0), (1, 1, 1, 4, 1, 64, 1, 0, 0),
       (1, 100, 100, 8, 2, 128, 1, 0, 0), (2, 96, 96, 16, 4, 64, 1, 0, 0),
       (1, 8, 45, 4, 2, 64, 1, 0, 37)]
    + list(FLASH_PATH.values())
    # phase 10's recompute of a resumed prompt: the request_capacity bucket
    + [(1, 160, 160, 32, 8, 64, 1, 0, 0)]
    # short chunks late in a long prompt, one windowed: few query tiles
    + [(1, 64, 512, 32, 8, 64, 1, 0, 448), (1, 48, 400, 8, 2, 64, 1, 100, 352),
       (1, 40, 300, 4, 2, 128, 1, 64, 260)]
    # head_dim 128 at full width: phase 11's one-shot prefill and its
    # resumed-prompt bucket (llama3.2-3b, 24 heads over 8), glm4-9b's
    # grouping (32 heads over 2) and phase 12's one-shot prefill
    # (qwen2-moe-a2.7b, 16 heads over 16)
    + [(1, 128, 128, 24, 8, 128, 1, 0, 0), (1, 160, 160, 24, 8, 128, 1, 0, 0),
       (1, 128, 128, 32, 2, 128, 1, 0, 0),
       (1, 128, 128, 16, 16, 128, 1, 0, 0)])
# phases 11's and 12's one-shot prefill shapes, timed beside FLASH_PATH's
FLASH_D128 = {"one-shot d128": (1, 128, 128, 24, 8, 128, 1, 0, 0),
              "one-shot d128 mha": (1, 128, 128, 16, 16, 128, 1, 0, 0)}


def flash_inputs(torch, case, dtype, seed=4):
    B, Sq, Sk, H, KVH, D = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype),
            torch.randn(B, Sk, KVH, D, generator=g, device="cuda").to(dtype),
            torch.randn(B, Sk, KVH, D, generator=g, device="cuda").to(dtype))


def flash_plain(ref, q, k, v, causal=True, window=0, q_offset=0):
    """The wrapper's plain path: KV heads repeated, heads ahead of the
    sequence, the plain version, and back to [B, Sq, H, D]."""
    rep = q.shape[2] // k.shape[2]
    return ref.flash_attention_ref(
        q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
        v.repeat_interleave(rep, 2).transpose(1, 2), causal=causal,
        window=window, q_offset=q_offset).transpose(1, 2)


def check_flash_attention(torch, ops, ref):
    """Prefill attention kernel vs plain version on the card: f32 within
    atol = rtol = 3e-5 (sums in another order), bf16 within atol 1e-3 +
    rtol 1e-2 (both sides accumulate in f32 and round the output once to
    bf16, whose spacing is 2**-8..2**-7 of the value, so they may land one
    bf16 step apart; the kernel feeds P to P.V as two bf16 parts, hi + lo,
    which keep about 16 bits, so the output's one rounding is what the
    tolerance covers). A second call must give the same bits. Returns the
    largest bf16 error at each path shape."""
    errs = {}
    for dtype, tol in ((torch.float32, dict(atol=3e-5, rtol=3e-5)),
                       (torch.bfloat16, dict(atol=1e-3, rtol=1e-2))):
        worst = 0.0
        for case in FLASH_CASES:
            causal, window, off = bool(case[6]), case[7], case[8]
            q, k, v = flash_inputs(torch, case, dtype)
            got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=off)
            again = ops.flash_attention(q, k, v, causal=causal,
                                        window=window, q_offset=off)
            want = flash_plain(ref, q, k, v, causal, window, off)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), case
            assert torch.equal(got, again), f"{case}: repeat not bit-equal"
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m: f"{case}: {m}")
            worst = max(worst, err)
            for name, shape in FLASH_PATH.items():
                if shape == case and dtype == torch.bfloat16:
                    errs[name] = err
        log(f"check flash_attention {dtype}: {len(FLASH_CASES)} cases, "
            f"max_abs_err={worst:.3e} ({tol}), repeats bit-equal")
    return errs


def check_flash_train(torch, ops, ref):
    """Prefill attention under autograd at phase 13's shape (B=8, S=128,
    32 heads over 8, D=64): ``ops.flash_attention`` refuses CUDA inputs
    that require grad while autograd records (its output has no graph);
    ``FlashAttentionFn`` gives the kernel's output bit for bit, and its
    plain backward's dq, dk, dv agree with autograd through the plain
    forward: f32 within 1e-4 of the largest gradient (the kernel's output,
    within 3e-5, enters delta = rowsum(dO·O)), bf16 within 1.6e-2 of it
    (two bf16 steps: the kernel's bf16 output may sit one step from the
    plain one's). A second backward gives the same bits."""
    case = FLASH_PATH["train"]
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)):
        q, k, v = (t.requires_grad_() for t in flash_inputs(torch, case,
                                                            dtype, seed=6))
        do = torch.randn(q.shape, generator=torch.Generator(
            device="cuda").manual_seed(7), device="cuda").to(dtype)
        try:
            ops.flash_attention(q, k, v)
        except RuntimeError as e:
            assert "FlashAttentionFn" in str(e), e
        else:
            raise AssertionError("flash_attention launched on inputs that "
                                 "require grad outside FlashAttentionFn")
        out = ops.flash_attention_train(q, k, v)
        with torch.no_grad():
            kernel = ops.flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), do)
        again = torch.autograd.grad(ops.flash_attention_train(q, k, v),
                                    (q, k, v), do)
        want = torch.autograd.grad(flash_plain(ref, q, k, v), (q, k, v), do)
        torch.cuda.synchronize()
        assert torch.equal(out, kernel), "Function forward != kernel"
        errs = []
        for name, a, b, c in zip("qkv", got, again, want):
            assert torch.equal(a, b), f"d{name}: second backward differs"
            err = (a.float() - c.float()).abs().max().item()
            top = c.float().abs().max().item()
            assert err <= rel * top, (dtype, name, err, top)
            errs.append(f"d{name} {err:.2e} (max {top:.2f})")
        log(f"check flash_attention under autograd {dtype} B=8 S=128 H=32 "
            f"KVH=8 D=64: refused outside FlashAttentionFn, forward = "
            f"kernel bit for bit, {', '.join(errs)} <= {rel} x max, second "
            f"backward bit-equal")


def visible_keys(torch, case) -> float:
    """Keys all queries of one (batch row, head) see, summed: Sq * Sk_eff
    for these inputs' causal and window masks."""
    _, Sq, Sk, _, _, _, causal, window, off = case
    qp = off + torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return float(mask.sum().item())


def time_flash(torch, ops, ref, F):
    """ms of the prefill kernel, its plain version and SDPA at the three
    path shapes and phase 11's head_dim-128 one-shot shape in bf16, with
    the bound."""
    out = {}
    for name, case in {**FLASH_PATH, **FLASH_D128}.items():
        B, Sq, Sk, H, KVH, D, causal, window, off = case
        q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=5)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, q_offset=off))
        in_graph = graph_ms(lambda: ops.flash_attention(q, k, v,
                                                        q_offset=off))
        plain = time_ms(lambda: flash_plain(ref, q, k, v, q_offset=off), 20)
        # library yardstick: SDPA with heads ahead and KV heads repeated
        # beforehand (not timed); is_causal aligns top-left, so the
        # offset case takes an explicit mask
        qh = q.transpose(1, 2).contiguous()
        kh = k.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
        vh = v.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
        if off == 0 and Sq == Sk:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))
        else:
            mask = (torch.arange(Sk, device="cuda")[None, :]
                    <= off + torch.arange(Sq, device="cuda")[:, None])
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask))
        esz = q.element_size()
        nbytes = esz * (2 * q.numel() + k.numel() + v.numel())
        flops = 4.0 * B * H * D * visible_keys(torch, case)
        b_ms, b_by = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops, graph_ms=in_graph)
        log(f"time flash_attention {name} bf16 B={B} Sq={Sq} Sk={Sk} H={H} "
            f"KVH={KVH} D={D} q_offset={off}: kernel {ms * 1e3:.2f} us, "
            f"in a graph {in_graph * 1e3:.2f} us, plain {plain * 1e3:.1f} "
            f"us, sdpa {lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
            f"({b_by}, {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    return out


def time_paged(torch, ops, ref, F, shape):
    """ms of the paged decode kernel, its plain version and SDPA over K/V
    gathered beforehand, in bf16, with the bound."""
    q, k, v, bt, sl = paged_inputs(torch, torch.bfloat16, **shape)
    B, H, D = q.shape
    N, KVH, Pg, _ = k.shape
    MP = bt.shape[1]
    rep = H // KVH
    ms = time_ms(lambda: ops.paged_attention(q, k, v, bt, sl))
    in_graph = graph_ms(lambda: ops.paged_attention(q, k, v, bt, sl))
    plain = time_ms(lambda: ref.paged_attention_ref(q, k, v, bt, sl), 20)
    # library yardstick: SDPA over K/V gathered beforehand (not timed)
    btl = bt.long()
    kg = k[btl].permute(0, 2, 1, 3, 4).reshape(B, KVH, MP * Pg, D)
    vg = v[btl].permute(0, 2, 1, 3, 4).reshape(B, KVH, MP * Pg, D)
    kg = kg.repeat_interleave(rep, dim=1)
    vg = vg.repeat_interleave(rep, dim=1)
    mask = torch.arange(MP * Pg, device="cuda")[None, :] < sl[:, None]
    mask[:, 0] = True
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg,
                                                         attn_mask=mask))
    # bytes this data needs: q, out, tables, seq_lens, and each distinct
    # (page, kv head) K/V tile that some row's live length reaches
    need = set()
    for b in range(B):
        for p in range(-(-int(sl[b]) // Pg)):
            need.add(int(bt[b, p]))
    esz = q.element_size()
    kv_bytes = 2 * len(need) * KVH * Pg * D * esz
    nbytes = kv_bytes + 2 * q.numel() * esz + bt.numel() * 4 + sl.numel() * 4
    flops = 4.0 * H * D * float(sl.clamp_min(0).sum().item())
    b_ms, b_by = bound(nbytes, flops, F32_FLOP_PER_S)
    res = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
               bound_by=b_by, bytes=nbytes, flops=flops, graph_ms=in_graph)
    log(f"time paged_attention bf16 B={B} KVH={KVH} rep={rep} D={D} Pg={Pg} "
        f"MP={MP} N={N}: kernel {ms * 1e3:.2f} us, in a graph "
        f"{in_graph * 1e3:.2f} us, plain "
        f"{plain * 1e3:.1f} us, sdpa {lib * 1e3:.2f} us, bound "
        f"{b_ms * 1e3:.3f} us ({b_by}, "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")
    return res


def time_kernels(torch, ops, ref, sealing, F):
    """ms of each kernel, its plain version and a library call, at the
    checked shapes, plus the bound."""
    out = {"paged_attention": time_paged(torch, ops, ref, F, PAGED_SHORT),
           "paged_attention long": time_paged(torch, ops, ref, F,
                                              PAGED_LONG)}
    for name, shape in PAGED_D128.items():
        out[f"paged_attention {name}"] = time_paged(torch, ops, ref, F, shape)

    g = torch.Generator(device="cuda").manual_seed(2)
    for model, cols in CIPHER_COLS.items():
        x = torch.randn(10, cols, generator=g,
                        device="cuda").to(torch.bfloat16)
        # key and counter as device tensors, as the swap path passes them
        kt = torch.tensor([0xC0FFEE], device="cuda")
        ctr = torch.tensor([sealing._swap_counter(3, 0)], device="cuda")
        c = ops.seal_bits(x, kt, ctr)
        ks = ref.seal_bits_ref(torch.zeros_like(x), kt, ctr)
        xi = x.view(torch.int16)
        nbytes = 2.0 * x.numel() * x.element_size()
        b_ms, b_by = bound(nbytes, KEYSTREAM_OPS * x.numel(), INT32_OP_PER_S)
        lib = time_ms(lambda: torch.bitwise_xor(xi, ks))
        for name, fn, plain_fn in (
                ("seal_bits", lambda: ops.seal_bits(x, kt, ctr),
                 lambda: ref.seal_bits_ref(x, kt, ctr)),
                ("unseal_bits",
                 lambda: ops.unseal_bits(c, kt, ctr, torch.bfloat16),
                 lambda: ref.unseal_bits_ref(c, kt, ctr, torch.bfloat16))):
            ms = time_ms(fn)
            in_graph = graph_ms(fn)
            plain = time_ms(plain_fn, 20)
            key = name if cols == CIPHER_COLS["llama3.2-1b"] \
                else f"{name} {model}"
            out[key] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            graph_ms=in_graph)
            log(f"time {name} bf16 [10, {cols}] ({model}'s row): kernel "
                f"{ms * 1e3:.2f} us, in a graph {in_graph * 1e3:.2f} us, "
                f"plain {plain * 1e3:.1f} us, xor {lib * 1e3:.2f} us, bound "
                f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB)")

    # quantizing seal at the stage boundary: [B_mb = 4, d_model = 2048] bf16
    x = torch.randn(4, 2048, generator=g, device="cuda").to(torch.bfloat16)
    key = torch.tensor([0xC0FFEE + 9], device="cuda")
    ctr = torch.tensor([65537 * 2], device="cuda")
    c, sc = ops.seal(x, key, ctr)
    n, rows, esz = x.numel(), x.shape[0], x.element_size()
    for name, fn, plain_fn, nbytes, work in (
            ("seal", lambda: ops.seal(x, key, ctr),
             lambda: ref.seal_ref(x, key, ctr),
             n * esz + n + 4 * rows,
             (SEAL_INT_OPS * n, INT32_OP_PER_S, SEAL_F32_OPS * n,
              F32_FLOP_PER_S)),
            ("unseal", lambda: ops.unseal(c, sc, key, ctr, torch.bfloat16),
             lambda: ref.unseal_ref(c, sc, key, ctr, torch.bfloat16),
             n + 4 * rows + n * esz,
             (UNSEAL_INT_OPS * n, INT32_OP_PER_S, UNSEAL_F32_OPS * n,
              F32_FLOP_PER_S))):
        b_ms, b_by = bound(nbytes, *work)
        ms = time_ms(fn)
        in_graph = graph_ms(fn)
        plain = time_ms(plain_fn, 20)
        # no single PyTorch call quantizes and ciphers: no library yardstick
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         graph_ms=in_graph)
        log(f"time {name} bf16 [4, 2048]: kernel {ms * 1e3:.2f} us, in a "
            f"graph {in_graph * 1e3:.2f} us, plain {plain * 1e3:.1f} us, "
            f"bound {b_ms * 1e3:.4f} us ({b_by}, {nbytes / 1e3:.1f} KB)")
    # what any launch costs under time_ms, and inside a graph: a
    # one-element zero_(); a floor to read the small kernels' times
    # against, not a bound, and not in the kernels line
    z = torch.zeros(1, device="cuda")
    log(f"launch floor (one-element zero_(), same timing): "
        f"{time_ms(lambda: z.zero_()) * 1e3:.2f} us, in a graph "
        f"{graph_ms(lambda: z.zero_()) * 1e3:.2f} us")
    out["flash_attention"] = time_flash(torch, ops, ref, F)
    # the training step's attention backward (plain PyTorch, no kernel in
    # the reference either), at phase 13's shape
    case = FLASH_PATH["train"]
    q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=5)
    o = ops.flash_attention(q, k, v)
    bwd = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, o), 20)
    log(f"time flash_attention train backward (plain, bf16 B=8 S=128 H=32 "
        f"KVH=8 D=64): {bwd * 1e3:.1f} us")
    return out


def small_reference_check(torch):
    """The whole serving path on a small input: reduced llama3.2-1b, f32,
    the same weights and prompts on the card and on the CPU, a pool tight
    enough to swap, through the local backend and through the pipelined
    one (stage boundaries sealed; telemetry too rare to re-plan, so both
    devices keep the planned layout). Greedy streams and paging decisions
    must be equal. A third run per backend adds chunked and packed prefill
    (``--prefill-chunk 5 --prefill-pack 3``; a CPU rehearsal of these
    flags chunks 7 admissions and packs 3 into 2 calls): its streams must
    be equal on both devices and equal to the one-shot run's."""
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    small = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
             "--slots", "4", "--requests", "10", "--prompt-len", "16",
             "--max-new", "8", "--page-size", "4", "--num-pages", "12",
             "--f32", "--shared-system-prompt", "0.5",
             "--telemetry-interval", "1000"]
    for backend in ("local", "pipelined"):
        streams = {}
        for extra in ([], ["--prefill-chunk", "5", "--prefill-pack", "3"]):
            args = serve.build_parser().parse_args(
                small + ["--backend", backend] + extra)
            cpu_api, params = serve.build_params(args)
            prompts = serve.gen_prompts(args, cpu_api.cfg.vocab_size)
            runs = []
            for device in ("cpu", "cuda"):
                api = build_model(cpu_api.cfg, device=device,
                                  dtype=torch.float32)
                eng = serve.make_engine(api, _to(torch, params, device), args)
                reqs = serve.serve_stream(eng, args, prompts)
                runs.append(([r.generated for r in reqs], eng.stats()))
            (a, sa), (b, sb) = runs
            what = f"{backend}{' ' + ' '.join(extra) if extra else ''}"
            assert a == b, f"{what}: greedy streams differ card vs CPU:\n" \
                           f"{a}\n{b}"
            for key in ("preemptions", "swap_outs", "swap_ins", "cow_hits",
                        "steps", "stage_blocks", "backend",
                        "chunked_admissions", "prefill_chunks",
                        "packed_admissions", "packed_prefills",
                        "prefill_calls"):
                assert sa[key] == sb[key], (what, key, sa[key], sb[key])
            assert sb["backend"] == backend
            streams[bool(extra)] = b
            if extra:
                assert b == streams[False], \
                    f"{backend}: chunked/packed streams differ from one-shot"
                assert sb["chunked_admissions"] > 0, sb
                assert sb["packed_admissions"] > sb["packed_prefills"] > 0, \
                    sb
            else:
                assert sb["swap_ins"] > 0, "small check never swapped"
            log(f"check serving path, reduced f32 card vs CPU, {what} "
                f"(stage blocks {sb['stage_blocks']}): {len(a)} streams "
                f"equal{', equal to one-shot' if extra else ''}, "
                f"swap_outs={sb['swap_outs']} swap_ins={sb['swap_ins']} "
                f"cow_hits={sb['cow_hits']} chunked="
                f"{sb['chunked_admissions']} in {sb['prefill_chunks']} "
                f"chunks, packed={sb['packed_admissions']} in "
                f"{sb['packed_prefills']} calls")
        if backend == "local":
            # the disaggregated pair (``--disagg``) on both devices: its
            # streams are the one-shot run's
            args = serve.build_parser().parse_args(
                small + ["--backend", backend, "--disagg"])
            cpu_api, params = serve.build_params(args)
            prompts = serve.gen_prompts(args, cpu_api.cfg.vocab_size)
            for device in ("cpu", "cuda"):
                api = build_model(cpu_api.cfg, device=device,
                                  dtype=torch.float32)
                orch = serve.make_disagg(api, _to(torch, params, device),
                                         args)
                reqs = serve.serve_stream_orch(orch, args, prompts)
                orch.check_invariants()
                st = orch.stats()
                assert [r.generated for r in reqs] == streams[False], \
                    f"disagg on {device}: streams differ from one-shot"
                assert st["handoffs"] == len(prompts), st["handoffs"]
            log(f"check serving path, reduced f32 card vs CPU, local "
                f"--disagg: {len(reqs)} streams equal the one-shot run's "
                f"on both, {st['handoffs']} sealed handoffs, "
                f"cow_hits={st['cow_hits']} swap_outs={st['swap_outs']}")


def small_d128_check(torch):
    """Phase 4 at head_dim 128: llama3.2-3b reduced to 2 layers of width
    256 but keeping head_dim 128 and its grouping (rep 3: 6 query heads over
    2 KV heads), f32, seeded weights. The same stream, greedy and then
    sampled (temperature 0.8, top-k 50, sample seed 11), through the local
    backend on the card and on the CPU: the streams must be equal, the
    pool must swap, and the sampled streams must differ from the greedy
    ones."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-3b")), num_layers=2,
                              d_model=256, num_heads=6, num_kv_heads=2,
                              head_dim=128, d_ff=512)
    cpu_api = build_model(cfg, device="cpu", dtype=torch.float32)
    params = cpu_api.init(torch.Generator().manual_seed(0))
    argv = ["--arch", "llama3.2-3b", "--device", "cpu", "--backend", "local",
            "--slots", "4", "--requests", "10", "--prompt-len", "16",
            "--max-new", "8", "--page-size", "4", "--num-pages", "12",
            "--shared-system-prompt", "0.5", "--telemetry-interval", "1000"]
    streams = {}
    for label, extra, seed in (("greedy", [], 0),
                               ("sampled", ["--temperature", "0.8",
                                            "--top-k", "50"], 11)):
        args = serve.build_parser().parse_args(argv + extra)
        prompts = serve.gen_prompts(args, cfg.vocab_size)
        runs = []
        for device in ("cpu", "cuda"):
            api = build_model(cfg, device=device, dtype=torch.float32)
            eng = serve.make_engine(api, _to(torch, params, device), args,
                                    sample_seed=seed)
            reqs = serve.serve_stream(eng, args, prompts)
            runs.append(([r.generated for r in reqs], eng.stats()))
        (a, sa), (b, sb) = runs
        assert a == b, f"d128 rep 3 {label}: streams differ card vs " \
                       f"CPU:\n{a}\n{b}"
        for key in ("preemptions", "swap_outs", "swap_ins", "steps"):
            assert sa[key] == sb[key], (label, key, sa[key], sb[key])
        assert sb["swap_ins"] > 0, sb
        streams[label] = b
        log(f"check serving path, llama3.2-3b reduced to 2 layers, d_model "
            f"256, head_dim 128, 6 heads over 2 KV heads (rep 3), f32, "
            f"{label}: {len(a)} streams equal card vs CPU, swap_outs="
            f"{sb['swap_outs']} swap_ins={sb['swap_ins']}")
    assert streams["sampled"] != streams["greedy"]


def small_moe_check(torch):
    """Phase 4 on the MoE family: reduced qwen2-moe-a2.7b (3 layers, 8
    experts top-2 plus 1 shared, no-drop dispatch), f32, seeded weights
    with the attention biases drawn nonzero (the initializer's zeros would
    hide them), phase 4's stream and pool through the local backend and
    the unsealed pipelined backend, on the card and on the CPU: the greedy
    streams and paging decisions must be equal and the pool must swap."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    g = torch.Generator().manual_seed(0)
    params = build_model(cfg, device="cpu", dtype=torch.float32).init(g)
    for b in ("bq", "bk", "bv"):
        params["blocks"]["attn"][b].normal_(generator=g)
    argv = ["--arch", "qwen2-moe-a2.7b", "--device", "cpu", "--slots", "4",
            "--requests", "10", "--prompt-len", "16", "--max-new", "8",
            "--page-size", "4", "--num-pages", "12",
            "--shared-system-prompt", "0.5", "--telemetry-interval", "1000"]
    for extra in (["--backend", "local"],
                  ["--backend", "pipelined", "--no-seal"]):
        args = serve.build_parser().parse_args(argv + extra)
        prompts = serve.gen_prompts(args, cfg.vocab_size)
        runs = []
        for device in ("cpu", "cuda"):
            api = build_model(cfg, device=device, dtype=torch.float32)
            eng = serve.make_engine(api, _to(torch, params, device), args)
            reqs = serve.serve_stream(eng, args, prompts)
            runs.append(([r.generated for r in reqs], eng.stats()))
        (a, sa), (b, sb) = runs
        what = " ".join(extra[1:])
        assert a == b, f"reduced qwen2-moe {what}: streams differ card vs " \
                       f"CPU:\n{a}\n{b}"
        for key in ("preemptions", "swap_outs", "swap_ins", "cow_hits",
                    "steps", "stage_blocks", "backend"):
            assert sa[key] == sb[key], (what, key, sa[key], sb[key])
        assert sb["swap_ins"] > 0, sb
        log(f"check serving path, qwen2-moe-a2.7b reduced (3 layers, 8 "
            f"experts top-2 + 1 shared, biases nonzero), f32, {what} (stage "
            f"blocks {sb['stage_blocks']}): {len(a)} streams equal card vs "
            f"CPU, swap_outs={sb['swap_outs']} swap_ins={sb['swap_ins']}")


TRAIN_OPT = dict(lr=3e-3, warmup_steps=2, total_steps=60, weight_decay=0.01)


def _train_run(torch, api, params, steps, ckpt=None, resume=False,
               ckpt_every=50):
    """``steps`` train steps of reduced llama3.2-1b through ``TrainLoop``
    from a copy of ``params`` on the model's device (batch 4, seq 32,
    ``TRAIN_OPT``): (loop, result)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
    from repro_torch.tree import map_tree
    p = map_tree(lambda t: t.to(api.device, copy=True), params)
    step = make_train_step(api, AdamWConfig(**TRAIN_OPT),
                           ShapeConfig("t", 32, 4, "train"),
                           device=api.device)
    loop = TrainLoop(train_step=step, params=p, opt_state=adamw.init(p),
                     data=SyntheticTokenStream(api.cfg.vocab_size, 4, 32,
                                               seed=1),
                     ckpt=ckpt, cfg=TrainLoopConfig(total_steps=steps,
                                                    ckpt_every=ckpt_every))
    if resume:
        assert loop.try_restore(), "no checkpoint to resume from"
    return loop, loop.run(steps)


def small_train_check(torch, ops):
    """Phase 4 on the training path: reduced llama3.2-1b in f32 (TF32 off)
    from the same params on the card and on the CPU. (a) One loss and its
    gradient: loss rtol 1e-5, every parameter's gradient within 5e-4 of
    the leaf's largest (the attention weights' included: a dropped
    attention gradient would leave wq and wk at zero), the flash kernel
    launched 2 x num_layers times (forward and remat recompute). (b) Three
    steps through ``TrainLoop``: losses rtol 1e-5, grad norms rtol 1e-3,
    every parameter within twice the steps' summed learning rates and 95%
    of each leaf within 1e-5 (the tolerances of tests/test_torch_train.py
    against the reference). (c) On the card, in f32 and in bf16: two
    straight runs of 6 steps give the same bits, and 3 steps, a checkpoint
    and 3 resumed steps on fresh junk state end bit-equal to them."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves, map_tree, named_leaves
    cfg = reduced(get_arch("llama3.2-1b"))
    cpu = build_model(cfg, device="cpu", dtype=torch.float32)
    params = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device="cuda", dtype=torch.float32)

    batch = SyntheticTokenStream(cfg.vocab_size, 4, 32, seed=1).batch_at(0)
    res = {}
    for api in (cpu, card):
        tracked = map_tree(
            lambda t: t.to(api.device, copy=True).requires_grad_(), params)
        names = list(named_leaves(tracked))
        b = {k: torch.from_numpy(v).to(api.device) for k, v in batch.items()}
        ops.reset_launch_counts()
        loss = api.loss_fn(tracked, b)
        grads = torch.autograd.grad(loss, leaves(tracked))
        res[api.device.type] = (float(loss.detach()), [g.cpu() for g in grads],
                                ops.LAUNCHES["flash_attention"])
    (loss_c, grads_c, _), (loss_g, grads_g, launched) = res["cpu"], \
        res["cuda"]
    assert launched == 2 * cfg.num_layers, launched
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), (loss_g, loss_c)
    worst = 0.0
    for name, a, b in zip(names, grads_g, grads_c):
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        assert err <= 5e-4 * top, (name, err, top)
        assert top > 0, name
        worst = max(worst, err / top)
    log(f"check training, reduced llama3.2-1b f32 card vs CPU: loss "
        f"{loss_g:.7f} vs {loss_c:.7f}, {len(names)} gradients within "
        f"{worst:.2e} of each leaf's largest (<= 5e-4; wq, wk, wv "
        f"nonzero), flash launched {launched} = 2 x {cfg.num_layers} layers")

    runs = {dev: _train_run(torch, api, params, 3)
            for dev, api in (("cpu", cpu), ("cuda", card))}
    (lc, rc), (lg, rg) = runs["cpu"], runs["cuda"]
    for a, b in zip(rg["losses"], rc["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b), (rg["losses"], rc["losses"])
    for a, b in zip(rg["gnorms"], rc["gnorms"]):
        assert abs(a - b) <= 1e-3 * abs(b), (rg["gnorms"], rc["gnorms"])
    lrs = AdamWConfig(**TRAIN_OPT)
    bound = 2 * sum(float(adamw.schedule(lrs, i)) for i in range(3))
    for (name, a), b in zip(named_leaves(lg.params).items(),
                            leaves(lc.params)):
        d = (a.cpu() - b).abs()
        assert d.max().item() <= bound, (name, d.max().item(), bound)
        assert (d <= 1e-5).float().mean().item() >= 0.95, (name, d)
    log(f"check training, reduced f32, 3 steps card vs CPU: losses "
        f"{[round(x, 6) for x in rg['losses']]} vs "
        f"{[round(x, 6) for x in rc['losses']]}, gnorms within 1e-3, params "
        f"within {bound:.1e} and 95% of each leaf within 1e-5")

    for dtype in (torch.float32, torch.bfloat16):
        api = build_model(cfg, device="cuda", dtype=dtype)
        p = map_tree(lambda t: t.to(dtype), params)
        straight, _ = _train_run(torch, api, p, 6)
        twice, _ = _train_run(torch, api, p, 6)
        with tempfile.TemporaryDirectory() as d:
            ck = CheckpointManager(d, async_save=False)
            _train_run(torch, api, p, 3, ckpt=ck, ckpt_every=3)
            junk = map_tree(lambda t: t.to(dtype), card.init(
                torch.Generator(device="cuda").manual_seed(9)))
            resumed, _ = _train_run(torch, api, junk, 3, ckpt=ck,
                                    resume=True)
        assert resumed.step == 6
        for (name, a), b, c in zip(named_leaves(straight.params).items(),
                                   leaves(twice.params),
                                   leaves(resumed.params)):
            assert a.dtype == dtype and torch.equal(a, b), \
                f"{dtype} {name}: a second straight run differs"
            assert torch.equal(a, c), f"{dtype} {name}: resumed != straight"
        for (name, x), y in zip(named_leaves(straight.opt_state).items(),
                                leaves(resumed.opt_state)):
            assert torch.equal(x, y), f"{dtype} opt {name}: resumed"
        assert straight.losses[3:] == resumed.losses, \
            (straight.losses, resumed.losses)
        log(f"check training on the card, reduced {dtype}: two straight "
            f"runs of 6 steps bit-equal, 3 + checkpoint + 3 resumed "
            f"bit-equal to them (params, master, moments, losses "
            f"{[round(x, 5) for x in straight.losses]})")


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return tree.to(device)


FULL_WIDTH = ["--arch", "llama3.2-1b", "--device", "cuda", "--slots", "8",
              "--requests", "16", "--prompt-len", "128", "--max-new", "32",
              "--page-size", "16", "--num-pages", "30",
              "--shared-system-prompt", "0.75"]
# phase 7: a CPU rehearsal of these flags (the schedule depends on the
# prompts, arrivals and pool, not on the model) chunks 25 admissions, packs
# 7 admissions into 6 calls and swaps 14 requests out and back in
PREFILL_WIDE = ["--arch", "llama3.2-1b", "--device", "cuda", "--backend",
                "local", "--prompt-len", "512", "--prefill-chunk", "128",
                "--prefill-pack", "4", "--slots", "8", "--max-new", "32",
                "--page-size", "16", "--shared-system-prompt", "0.5",
                "--requests", "32", "--num-pages", "116"]


class TimedPrefill:
    """Every prefill call of an engine (one-shot, packed, chunk) timed by
    the host clock between two device synchronises, and its prompt tokens
    counted (a packed call's dummy rows have length 1; the stream's prompts
    have at least 2 tokens). It wraps the engine's managed calls
    (``serving/aot.py``) from outside, so under CUDA graphs it times the
    input copies and the replay, never inside a captured region."""

    def __init__(self, torch, eng):
        self._torch = torch
        self.seconds, self.tokens, self.chunk_ms = 0.0, 0, []
        for owner, attr, count in (
                (eng, "_prefill_at", lambda a: a[1].sum()),
                (eng, "_prefill_at_packed", lambda a: a[1][a[1] > 1].sum()),
                (eng.backend, "_chunk", lambda a: a[2].sum())):
            setattr(owner, attr, self._timed(getattr(owner, attr), count,
                                             attr == "_chunk"))

    def _timed(self, fn, count, chunk):
        torch = self._torch

        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.seconds += dt
            self.tokens += int(count(a))
            if chunk:
                self.chunk_ms.append(dt * 1e3)
            return out
        return call


class SamplerTimes:
    """An engine's sampling timed from outside (``ServingEngine._sample``):
    the device is synchronised first, so the decode step's own work is not
    counted. Host ms is the host clock around the call, which ends with the
    tokens on the host; device ms is the time between two CUDA events
    recorded around ``_sample_fn`` (on a warmed sampled engine one graph
    replay; eagerly, as fast as the host launches its kernels)."""

    def __init__(self, torch, eng):
        self.host, self.events = [], []
        dev_fn, host_fn = eng._sample_fn, eng._sample

        def sample_fn(logits, rows):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = dev_fn(logits, rows)
            end.record()
            self.events.append((logits.shape[0], start, end))
            return out

        def sample(logits, rids, idxs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = host_fn(logits, rids, idxs)
            self.host.append((logits.shape[0],
                              (time.perf_counter() - t0) * 1e3))
            return out

        eng._sample_fn, eng._sample = sample_fn, sample

    def per_step(self, rows):
        """(device ms, host ms) per sampling of ``rows`` rows (a decode
        step's), means over the run."""
        dev = [s.elapsed_time(e) for b, s, e in self.events if b == rows]
        host = [ms for b, ms in self.host if b == rows]
        return sum(dev) / len(dev), sum(host) / len(host)

    def describe(self) -> str:
        rows = max(b for b, _ in self.host)
        dev, host = self.per_step(rows)
        return (f"{dev:.3f} device ms and {host:.3f} host ms per decode "
                f"step's sampling ({rows} rows, means over "
                f"{sum(b == rows for b, _ in self.host)} steps)")


class GcPauses:
    """Around a timed run: everything allocated before it is collected and
    then frozen out of the collector's scans (``gc.freeze``), so a
    collection during the run walks only the run's own objects; each
    collection's host pause is recorded (``gc.callbacks``). An eager stage
    probe times the host's launch pace, and a long pause inside the
    one-layer stage's probe would read as a straggler."""

    def __enter__(self):
        gc.collect()
        gc.freeze()
        self.ms, self._t = [], 0.0
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.ms.append((time.perf_counter() - self._t) * 1e3)

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)
        gc.unfreeze()

    def describe(self) -> str:
        return (f"{len(self.ms)} collections, longest "
                f"{max(self.ms, default=0.0):.2f} ms")


# the counters two runs of one stream must agree on, eager or in graphs
SCHEDULE = ("steps", "swap_outs", "swap_ins", "preemptions", "cow_hits",
            "forks", "prefill_calls", "chunked_admissions", "prefill_chunks",
            "packed_admissions", "packed_prefills", "completed",
            "tokens_out", "stage_blocks", "replans", "swaps")


def serve_full_width(torch, ops, api, params, argv, phase, overrides=None,
                     time_sampler=False, plan=(1, 15)):
    """Phases 5 (local backend), 6 (pipelined backend), 7 (local, long
    prompts, chunked and packed prefill), 8 (5's and 7's streams on an
    engine warmed up as CUDA graphs), 11 (full-width llama3.2-3b,
    sampled) and 12 (full-width qwen2-moe-a2.7b): the main path at full
    width, with launch counts zeroed just before and read just after.
    ``overrides`` replace fields of the engine's config; ``time_sampler``
    times its sampling (``SamplerTimes``); ``plan`` is the stage blocks
    the planner must give on the pipelined backend. Returns the launch
    counts, the streams, the schedule's counters, the host clock's ms per
    decode step and per chunk, decode tokens/s and memory reserved and at
    peak."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(argv)
    backend = serve.backend_of(args)
    wide = args.prefill_chunk > 0
    # the earlier phases' garbage, collected now rather than by a pause
    # inside a timed stage probe
    gc.collect()
    # warm-up: a short stream on its own eager engine (cuBLAS handles,
    # allocator)
    warm = serve.build_parser().parse_args(
        [a for a in argv if a != "--warmup"] + ["--requests", "2"])
    serve.serve_stream(serve.make_engine(api, params, warm), warm,
                       serve.gen_prompts(warm, api.cfg.vocab_size))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = serve.make_engine(api, params, args, **(overrides or {}))
    if args.warmup:
        st = eng.stats()
        assert st["warmed"] and st["graphs"] > 0, st
        log(f"serve phase {phase}: warmup {st['warmup_s']:.2f} s, "
            f"{st['graphs']} CUDA graphs captured "
            f"({', '.join(f'{n} {f.graphs}' for n, f in eng.aot.fns.items())}"
            f"), memory reserved {torch.cuda.memory_reserved() / 2**30:.2f} "
            f"GiB, peak {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
    timed = TimedPrefill(torch, eng) if wide else None
    sampler = SamplerTimes(torch, eng) if time_sampler else None
    planned = eng.stage_blocks
    be = eng.backend
    gathered, restored = {}, []
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    probe_layers = [0]
    orig_gather, orig_scatter, orig_step = (be.gather_pages,
                                            be.scatter_pages, be.step)

    def gather(pages, key, ctr):
        pg = torch.from_numpy(pages.astype("int64")).cuda()
        gathered[ctr] = [pool[:, pg].clone() for pool in be.cache["blocks"]]
        return orig_gather(pages, key, ctr)

    def scatter(ck, cv, pages, key, ctr):
        orig_scatter(ck, cv, pages, key, ctr)
        for i, pg in enumerate(pages):
            if pg < be.num_pages:
                for pool, rows in zip(be.cache["blocks"], gathered[ctr]):
                    assert torch.equal(pool[:, int(pg)], rows[:, i]), \
                        f"swap-in of page {pg} (row {i}) not bit-exact"
                restored.append(int(pg))

    def step(tokens, key):
        logits = orig_step(tokens, key)
        bad.add_((~torch.isfinite(logits)).sum())
        return logits

    be.gather_pages, be.scatter_pages, be.step = gather, scatter, step
    samples = []                        # (engine step, probe ms per stage)
    if backend == "pipelined":
        orig_times = be.stage_times

        def stage_times():
            # a telemetry probe runs every stage's layers once
            probe_layers[0] += api.cfg.num_layers
            times = orig_times()
            samples.append((eng.steps, [round(t * 1e3, 3) for t in times]))
            return times

        be.stage_times = stage_times
    prompts = serve.gen_prompts(args, api.cfg.vocab_size)
    with GcPauses() as pauses:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = serve.serve_stream(eng, args, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = eng.stats()
    n_layers = api.cfg.num_layers
    S, nm = args.stages, args.microbatches

    assert len(reqs) == args.requests
    assert all(r.status == "done" and len(r.generated) == args.max_new
               for r in reqs), "a request did not complete"
    assert all(0 <= t < api.cfg.vocab_size for r in reqs for t in r.generated)
    assert int(bad.item()) == 0, "non-finite logits"
    assert st["preemptions"] >= 1 and st["swap_outs"] >= 1, st
    assert st["swap_ins"] >= 1 and restored, st
    assert st["backend"] == backend, st["backend"]
    assert launches["seal_bits"] == 2 * st["swap_outs"], launches
    assert launches["unseal_bits"] == 2 * st["swap_ins"], launches
    assert launches["seal_bits"] + launches["unseal_bits"] >= 4, launches
    assert launches["flash_attention"] == n_layers * st["prefill_calls"], \
        (launches, st["prefill_calls"])
    if backend == "local":
        assert launches["paged_attention"] == be.steps * n_layers, \
            (launches, be.steps)
        assert launches["seal"] == launches["unseal"] == 0, launches
    else:
        assert planned == plan, (planned, plan)
        assert st["stage_blocks"] == eng.spec.stage_sizes() == planned, \
            (st["stage_blocks"], eng.spec.stage_sizes(), st["replans"])
        assert st["replans"] == 0 and st["swaps"] == 0, \
            (st["replans"], st["swaps"], pauses.describe(),
             [e.step for e in eng.events if e.kind == "replan"], samples)
        assert launches["seal"] == launches["unseal"] \
            == be.steps * nm * (S - 1), (launches, be.steps)
        assert launches["paged_attention"] == \
            be.steps * nm * n_layers + probe_layers[0], \
            (launches, be.steps, probe_layers[0])
    if args.warmup:
        assert st["post_warmup_compiles"] == 0, st["post_warmup_compiles"]
        assert st["compile_stalls"] == [], st["compile_stalls"]
    else:
        assert st["post_warmup_compiles"] is None and not st["graphs"], st
    if wide:
        assert st["chunked_admissions"] > 0, st
        assert st["packed_admissions"] > st["packed_prefills"] > 0, st
    eng.check_page_invariants()
    step_ms = st["decode_wall_s"] / max(be.steps, 1) * 1e3
    log(f"serve phase {phase} ({backend}"
        f"{', CUDA graphs' if args.warmup else ''}): {st['completed']} "
        f"requests, {st['tokens_out']} tokens, {be.steps} decode steps of "
        f"{st['steps']}, {st['tok_per_s']:.1f} tok/s decode, {step_ms:.2f} "
        f"ms/decode step (host clock, {args.slots} slots), wall {wall:.2f} "
        f"s incl. admission prefill; garbage collector "
        f"{pauses.describe()}")
    probe = "" if backend == "local" else \
        " stage probe EMA " + ", ".join(
            f"{t * 1e3:.3f}" for t in eng.telemetry._stage_ema.values()) + \
        " ms; per stage p50 / max of its samples " + ", ".join(
            f"{sorted(v)[len(v) // 2]:.3f} / {max(v):.3f}"
            for v in zip(*(t for _, t in samples))) + " ms"
    log(f"serve phase {phase}: stage_blocks={st['stage_blocks']} "
        f"placement={st['placement']} replans={st['replans']} "
        f"swaps={st['swaps']}{probe}")
    log(f"serve phase {phase}: preemptions={st['preemptions']} "
        f"swap_outs={st['swap_outs']} swap_ins={st['swap_ins']} pages "
        f"restored bit-exact={len(restored)} cow_hits={st['cow_hits']} "
        f"forks={st['forks']} admission_p50="
        f"{st.get('admission_p50_ms', 0):.1f} ms p99="
        f"{st.get('admission_p99_ms', 0):.1f} ms, prefill_calls="
        f"{st['prefill_calls']}")
    chunk_ms = None
    if wide:
        chunk = sorted(timed.chunk_ms)
        chunk_ms = sum(chunk) / len(chunk)
        log(f"serve phase {phase}: chunked {st['chunked_admissions']} "
            f"admissions in {st['prefill_chunks']} chunks of "
            f"{args.prefill_chunk}, packed {st['packed_admissions']} "
            f"admissions in {st['packed_prefills']} calls of up to "
            f"{args.prefill_pack}; ms per chunk p50 "
            f"{chunk[len(chunk) // 2]:.2f} mean {chunk_ms:.2f} (host clock "
            f"between device synchronises); prefill {timed.tokens} tokens "
            f"in {timed.seconds:.3f} s = "
            f"{timed.tokens / timed.seconds:.0f} tokens/s")
    detail = f"{be.steps} steps x {n_layers} layers" if backend == "local" \
        else (f"{be.steps} steps x {nm} microbatches x {n_layers} layers + "
              f"{probe_layers[0]} probe layer runs; seal = {be.steps} x "
              f"{nm} x {S - 1}")
    log(f"serve phase {phase}: launches {launches} (paged attention "
        f"{detail}; flash attention {st['prefill_calls']} prefill calls x "
        f"{n_layers} layers)")
    if sampler is not None:
        log(f"serve phase {phase}: sampler {sampler.describe()}")
    return dict(launches=launches, streams=[list(r.generated) for r in reqs],
                schedule={k: st[k] for k in SCHEDULE}, steps=be.steps,
                step_ms=step_ms, chunk_ms=chunk_ms, tok_per_s=st["tok_per_s"],
                admission=(st.get("admission_p50_ms", 0.0),
                           st.get("admission_p99_ms", 0.0)),
                sampler=sampler and sampler.per_step(eng.config.num_slots),
                reserved_gib=torch.cuda.memory_reserved() / 2**30,
                peak_gib=torch.cuda.max_memory_reserved() / 2**30,
                peak_alloc_gib=torch.cuda.max_memory_allocated() / 2**30)


def serve_in_graphs(torch, ops, api, params, argv, phase, eager,
                    label="8", **kw):
    """Phase 8 (and 11b): ``argv``'s stream again on a fresh engine warmed
    up as CUDA graphs (``--warmup``). Its streams, schedule and launch
    counts (graph replays included) must equal the eager phase's
    ``eager``, with no capture and no stall after warmup
    (``serve_full_width`` asserts those and the bit-exact swap-ins); ``kw``
    goes to ``serve_full_width``."""
    res = serve_full_width(torch, ops, api, params, argv + ["--warmup"],
                           f"{label} (phase {phase}'s stream)", **kw)
    assert res["streams"] == eager["streams"], \
        f"phase {phase}'s stream differs under CUDA graphs"
    assert res["schedule"] == eager["schedule"] and \
        res["steps"] == eager["steps"], (res["schedule"], eager["schedule"])
    assert res["launches"] == eager["launches"], \
        (res["launches"], eager["launches"])
    log(f"serve phase {label} (phase {phase}'s stream): streams, schedule and "
        f"launches equal the eager run's; host ms per decode step "
        f"{res['step_ms']:.2f} in graphs against {eager['step_ms']:.2f} "
        f"eager" + (f"; ms per chunk {res['chunk_ms']:.2f} against "
                    f"{eager['chunk_ms']:.2f}" if res["chunk_ms"] else ""))
    gc.collect()                # the engine's graphs and their memory pool
    torch.cuda.empty_cache()
    return res


class RowProbe:
    """Clones, on the card, the plaintext rows each ``gather_pages`` reads
    and each ``scatter_pages`` writes, keyed by the cipher counter, and
    checks decode logits finite; ``compare`` holds every restore to the
    rows its payload was gathered from, bit for bit, after the run."""

    def __init__(self, torch, device):
        self.torch = torch
        self.gathered, self.restored = {}, []
        self.bad = torch.zeros((), dtype=torch.int64, device=device)

    def _gather(self, be, fn):
        torch = self.torch

        def gather(pages, key, ctr):
            pg = torch.from_numpy(pages.astype("int64")).to(be.device)
            self.gathered[int(ctr)] = [pool[:, pg].clone()
                                       for pool in be.cache["blocks"]]
            return fn(pages, key, ctr)
        return gather

    def _scatter(self, be, fn):
        torch = self.torch

        def scatter(ck, cv, pages, key, ctr):
            fn(ck, cv, pages, key, ctr)
            # every scatter is recorded (a manifest of shared rows only
            # scatters none, but its unseal still runs)
            live = [i for i, p in enumerate(pages) if p < be.num_pages]
            pg = torch.tensor([int(pages[i]) for i in live],
                              dtype=torch.int64, device=be.device)
            self.restored.append((int(ctr), live, [
                pool[:, pg].clone() for pool in be.cache["blocks"]]))
        return scatter

    def _finite(self, fn):
        def step(tokens, key):
            logits = fn(tokens, key)
            self.bad.add_((~self.torch.isfinite(logits)).sum())
            return logits
        return step

    def compare(self, skip=()):
        """``(counter, rows)`` of every restore whose counter is not in
        ``skip``, each checked bit-exact against its gathered rows."""
        torch, out = self.torch, []
        for ctr, live, got in self.restored:
            if ctr in skip:
                continue
            idx = torch.tensor(live, dtype=torch.int64, device=got[0].device)
            for want, have in zip(self.gathered[ctr], got):
                assert torch.equal(want[:, idx], have), \
                    f"restore under counter {ctr} not bit-exact"
            out.append((ctr, len(live)))
        assert int(self.bad.item()) == 0, "non-finite logits"
        return out


class DisaggProbe(RowProbe):
    """Instruments a disaggregated pair (phase 9) from outside: every
    export and transfer-in is timed by the host clock between two device
    synchronises, the rows of every gather (the prefill role's exports,
    either role's swap-outs) and scatter (transfer-ins, swap-ins) are
    cloned and compared after the run, and every decode step's logits are
    checked finite. Until ``close()``, each SHA-256 of a host payload
    (``sealing.payload_digest``: one per export, transfer-in, swap-out and
    swap-in) is timed by the host clock."""

    def __init__(self, torch, orch, sealing):
        pe, de = orch.eng_prefill, orch.decode
        super().__init__(torch, de.device)
        self.sealing = sealing
        self.export_ms, self.transfer_in_ms, self.digest_ms = [], [], []
        self._digest = sealing.payload_digest
        sealing.payload_digest = self._timed(self._digest, self.digest_ms,
                                             sync=False)
        self.sealed_rows = 0            # manifest rows that transfer-ins
        #                                 must scatter (not COW-adopted)
        for be in (pe.backend, de.backend):
            be.gather_pages = self._gather(be, be.gather_pages)
            be.scatter_pages = self._scatter(be, be.scatter_pages)
        pe.export_transfer = self._timed(pe.export_transfer, self.export_ms)
        transfer_in = self._timed(de._transfer_in, self.transfer_in_ms)

        def counted_transfer_in(slot, req, t0):
            self.sealed_rows += \
                de.pool.transfer_manifest[req.rid].sealed_pages
            return transfer_in(slot, req, t0)

        de._transfer_in = counted_transfer_in
        de.backend.step = self._finite(de.backend.step)

    def _timed(self, fn, into, sync=True):
        torch = self.torch

        def call(*a):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            if sync:
                torch.cuda.synchronize()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def close(self) -> None:
        self.sealing.payload_digest = self._digest

    def check(self) -> dict:
        """Every restored row equals the row its manifest was gathered
        from, bit for bit. Returns restored rows by kind."""
        rows = {"transfer": 0, "swap": 0}
        for ctr, n in self.compare():
            rows["transfer" if ctr >= self.sealing.TRANSFER_SEQ_BASE
                 else "swap"] += n
        return rows


def serve_disagg(torch, ops, api, params, argv, phase5, phase8, smi,
                 overrides=None, warms=(False, True), label="9"):
    """Phase 9 (and 11c): phase 5's stream through the disaggregated pair
    (``--disagg``: a prefill-role and a decode-role engine over the same
    ``params``, every prompt's KV handed over sealed with the page cipher),
    eagerly and then on a pair warmed up as CUDA graphs. Streams must equal
    phase 5's and a no-peer fallback orchestrator's; the handoffs must
    equal the requests that did not finish at prefill; the cipher must run
    on every export, transfer-in and swap, each restore bit-exact; the
    flash and paged kernels must run once a layer per prefill call and per
    decode step. ``overrides`` replace fields of both roles' config,
    ``warms`` picks the eager and warmed runs, ``label`` names the phase.
    Returns the runs' launch counts."""
    from repro_torch.enclave import sealing
    from repro_torch.launch import serve
    from repro_torch.serving import DisaggOrchestrator
    n_layers = api.cfg.num_layers
    out = []
    overrides = overrides or {}
    for warm in warms:
        args = serve.build_parser().parse_args(
            argv + (["--warmup"] if warm else []))
        prompts = serve.gen_prompts(args, api.cfg.vocab_size)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        orch = serve.make_disagg(api, params, args, **overrides)
        pe, de = orch.eng_prefill, orch.decode
        assert pe.params is de.params is params
        probe = DisaggProbe(torch, orch, sealing)
        with GcPauses():
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                reqs = serve.serve_stream_orch(orch, args, prompts)
            finally:
                probe.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        orch.check_invariants()
        st, ps, ds = orch.stats(), pe.stats(), de.stats()
        rows = probe.check()
        streams = [list(r.generated) for r in reqs]
        what = "CUDA graphs" if warm else "eager"

        assert len(reqs) == args.requests
        assert all(r.status == "done" and len(r.generated) == args.max_new
                   for r in reqs), "a request did not complete"
        assert streams == phase5["streams"], \
            f"phase {label} ({what}): streams differ from the monolithic " \
            f"run's"
        at_prefill = sum(1 for r in reqs if r.max_new_tokens == 1
                         or r.generated[0] == r.eos_id)
        assert st["prefill_completed"] == at_prefill, st
        assert st["handoffs"] == args.requests - at_prefill \
            == ps["transfers_out"] == ds["transfers_in"], (st, ps)
        assert ds["recovery"]["unseal_fallback_transfer"] == 0, ds
        assert st["in_flight_handoffs"] == st["pending_handoffs"] == 0, st
        assert rows["transfer"] == probe.sealed_rows > 0, \
            (rows, probe.sealed_rows)
        assert len(probe.export_ms) == ps["transfers_out"]
        assert len(probe.transfer_in_ms) == ds["transfers_in"]
        outs = ps["transfers_out"] + ps["swap_outs"] + ds["swap_outs"]
        ins = ds["transfers_in"] + ds["swap_ins"] + ps["swap_ins"]
        assert launches["seal_bits"] == 2 * outs, (launches, outs)
        assert launches["unseal_bits"] == 2 * ins, (launches, ins)
        assert len(probe.digest_ms) == outs + ins, (len(probe.digest_ms),
                                                    outs, ins)
        assert launches["flash_attention"] == n_layers * (
            ps["prefill_calls"] + ds["prefill_calls"]), launches
        assert pe.backend.steps == 0, "the prefill role decoded"
        assert launches["paged_attention"] == n_layers * de.backend.steps, \
            (launches, de.backend.steps)
        assert launches["seal"] == launches["unseal"] == 0, launches
        for role, s in (("prefill", ps), ("decode", ds)):
            assert not s["stalled"], (role, s["stall_reason"])
            if warm:
                assert s["post_warmup_compiles"] == 0, (role, s)
                assert s["compile_stalls"] == [], (role, s)
                assert s["graphs"] > 0, (role, s)
            else:
                assert s["post_warmup_compiles"] is None, (role, s)
        if warm:
            eager = out[0]
            assert launches == eager["launches"], \
                (launches, eager["launches"])
            assert st["handoffs"] == eager["handoffs"]
        else:
            fb = DisaggOrchestrator(serve.make_engine(api, params, args,
                                                      **overrides))
            fb_reqs = serve.serve_stream_orch(fb, args, prompts)
            assert [list(r.generated) for r in fb_reqs] == streams, \
                f"phase {label}: the no-peer fallback's streams differ"
            assert fb.stats()["handoffs"] == 0
        adopted = sum(e.detail["shared"] for e in de.events
                      if e.kind == "handoff_in")
        step_ms = ds["decode_wall_s"] / max(de.backend.steps, 1) * 1e3
        exp, tin = sorted(probe.export_ms), sorted(probe.transfer_in_ms)
        dig = sorted(probe.digest_ms)
        if warm:
            log(f"serve phase {label} (CUDA graphs): warmup prefill role "
                f"{ps['warmup_s']:.2f} s, {ps['graphs']} graphs; decode "
                f"role {ds['warmup_s']:.2f} s, {ds['graphs']} graphs; no "
                f"capture and no stall after warmup on either role; "
                f"streams and launches equal the eager pair's")
        also = "" if warm else " and the no-peer fallback orchestrator's"
        log(f"serve phase {label} ({what}): {st['completed']} requests, "
            f"{st['tokens_out']} tokens, streams equal the monolithic "
            f"run's{also}; "
            f"handoffs={st['handoffs']} (requests not finished at "
            f"prefill: {args.requests - at_prefill}), backpressure events="
            f"{st['backpressure_events']}, COW-adopted rows={adopted}, "
            f"sealed rows restored bit-exact={rows['transfer']}; decode "
            f"role swap_outs={ds['swap_outs']} swap_ins={ds['swap_ins']} "
            f"(rows bit-exact {rows['swap']}), prefill role swap_outs="
            f"{ps['swap_outs']}; wall {wall:.2f} s")
        log(f"serve phase {label} ({what}): host ms per export p50 "
            f"{exp[len(exp) // 2]:.3f} mean {sum(exp) / len(exp):.3f}, per "
            f"transfer-in p50 {tin[len(tin) // 2]:.3f} mean "
            f"{sum(tin) / len(tin):.3f} (between device synchronises), of "
            f"which the payload's SHA-256 p50 {dig[len(dig) // 2]:.3f} "
            f"mean {sum(dig) / len(dig):.3f} ({len(dig)} digests); "
            f"decode {step_ms:.2f} ms/step over {de.backend.steps} steps "
            f"({ds['tok_per_s']:.1f} tok/s decode); admission p50 "
            f"{ds.get('admission_p50_ms', 0):.2f} p99 "
            f"{ds.get('admission_p99_ms', 0):.2f} ms (decode role, "
            f"transfer-ins), prefill role p50 "
            f"{ps.get('admission_p50_ms', 0):.2f} p99 "
            f"{ps.get('admission_p99_ms', 0):.2f} ms; memory reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, peak "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")
        log(f"serve phase {label} ({what}): launches {launches} (paged "
            f"attention {de.backend.steps} decode steps x {n_layers}; "
            f"flash {ps['prefill_calls']} + {ds['prefill_calls']} prefill "
            f"calls x {n_layers}; cipher 2 x ({ps['transfers_out']} "
            f"exports + {ps['swap_outs'] + ds['swap_outs']} swap-outs), "
            f"2 x ({ds['transfers_in']} transfer-ins + "
            f"{ds['swap_ins'] + ps['swap_ins']} swap-ins))")
        out.append(dict(launches=launches, handoffs=st["handoffs"],
                        step_ms=step_ms, tok_per_s=ds["tok_per_s"],
                        admission=(ds.get("admission_p50_ms", 0.0),
                                   ds.get("admission_p99_ms", 0.0)),
                        peak_gib=torch.cuda.max_memory_reserved() / 2**30))
        del orch, probe
    if len(out) < 2:
        return out
    for name, r in (("phase 5 (eager)", phase5),
                    ("phase 8 (phase 5's stream, CUDA graphs)", phase8),
                    ("phase 9 (eager pair)", out[0]),
                    ("phase 9 (pair in CUDA graphs)", out[1])):
        log(f"serve {name}: decode {r['step_ms']:.2f} ms/step, admission "
            f"p50 {r['admission'][0]:.2f} p99 {r['admission'][1]:.2f} ms, "
            f"peak memory reserved {r['peak_gib']:.2f} GiB [{smi}]")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 10's fault seeds, chosen so that every site a part arms fires at
# least once in this stream (a CPU rehearsal of the same schedules at
# reduced width and full vocabulary, then the card): 10a fires a death,
# stalls, corrupt and truncated swaps and storms; 10b stalls, both tampers
# on both paths, handoff drops and delays and a storm; 10c its one death
CHAOS_LOCAL_SEED = 12
CHAOS_DISAGG_SEED = 9
CHAOS_PIPE_SEED = 0


class ChaosProbe(RowProbe):
    """Instruments the engines of one phase-10 run from outside: as
    ``DisaggProbe``, every gather's and scatter's rows by counter and
    finite logits. Besides: the counter of every payload that fails a
    check (``_integrity_reject``), whose freshly scattered pages must then
    be in no host or device block table and back on the free list; the
    host ms (between device synchronises) of each admission that fell back
    to a re-prefill; and the host ms from each device death to the next
    token of every request it spilled."""

    def __init__(self, torch, engines):
        super().__init__(torch, engines[0].device)
        self.rejected = set()
        self.fallback_ms, self.death_ms = [], []
        self._victims = []              # (t0, request, tokens at the death)
        for eng in engines:
            be = eng.backend
            be.gather_pages = self._gather(be, be.gather_pages)
            be.scatter_pages = self._scatter(be, be.scatter_pages)
            be.step = self._finite(be.step)
            eng._integrity_reject = self._reject(eng, eng._integrity_reject)
            eng._prefill_slot = self._admit(eng, eng._prefill_slot)
            eng._recover_device_loss = self._death(eng,
                                                   eng._recover_device_loss)
            eng.step = self._step(eng.step)

    def _reject(self, eng, fn):
        torch = self.torch

        def reject(req, path, fresh, e):
            ledger = eng.pool.swap_manifest if path == "swap" \
                else eng.pool.transfer_manifest
            self.rejected.add(int(ledger[req.rid].counter))
            held = {p for pages in eng.slot_pages.values() for p in pages}
            assert not held & set(fresh), (path, req.rid, fresh)
            if fresh:
                bt = eng.backend.cache["block_tables"]
                assert not torch.isin(bt, torch.tensor(
                    fresh, dtype=bt.dtype, device=bt.device)).any(), \
                    f"a device block table holds a rejected page {fresh}"
            out = fn(req, path, fresh, e)
            for pg in fresh:
                assert eng.pool.refcount[pg] == 0 and \
                    pg not in eng.pool._page_key, (pg, path)
            return out
        return reject

    def _admit(self, eng, fn):
        torch = self.torch

        def fallbacks():
            return (eng.recovery["unseal_fallback_swap"]
                    + eng.recovery["unseal_fallback_transfer"])

        def admit(slot, req):
            n = fallbacks()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(slot, req)
            if fallbacks() > n:
                torch.cuda.synchronize()
                self.fallback_ms.append((time.perf_counter() - t) * 1e3)
        return admit

    def _death(self, eng, fn):
        def death(victim):
            t0 = time.perf_counter()
            self._victims += [(t0, req, len(req.generated))
                              for _, req in eng.scheduler.active()]
            return fn(victim)
        return death

    def _step(self, fn):
        def step():
            out = fn()
            now = time.perf_counter()
            still = []
            for t0, req, n in self._victims:
                if len(req.generated) > n:
                    self.death_ms.append((now - t0) * 1e3)
                else:
                    still.append((t0, req, n))
            self._victims = still
            return out
        return step

    def check(self) -> dict:
        """Every adopted restore equals its gathered rows bit for bit.
        Returns restored rows of adopted payloads and the scatters of
        rejected ones."""
        adopted = self.compare(skip=self.rejected)
        assert not self._victims, "a spilled request never resumed"
        return dict(rows=sum(n for _, n in adopted),
                    rejected_scatters=len(self.restored) - len(adopted))


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def _chaos_run(torch, ops, build, drive, pipelined_layers=0):
    """One phase-10 run: ``build()`` gives (what to drive, its engines),
    decode engine first; launch counts are zeroed just before ``drive``
    and read just after."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    obj, engines = build()
    probe = ChaosProbe(torch, engines)
    probes = [0]
    if pipelined_layers:
        be = engines[0].backend
        orig = be.stage_times

        def stage_times():
            probes[0] += pipelined_layers   # every stage's layers once
            return orig()

        be.stage_times = stage_times
    with GcPauses() as pauses:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = drive(obj)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return dict(reqs=reqs, streams=[list(r.generated) for r in reqs],
                gc=pauses.describe(), launches=launches, served=obj,
                engines=engines,
                stats=[e.stats() for e in engines], probe=probe,
                restore=probe.check(), wall=wall, probe_layers=probes[0])


def _check_chaos(run, n_layers, max_new, n_requests, warm, armed=None,
                 pipelined=None):
    """The assertions every phase-10 run (chaotic or fault-free) meets."""
    from repro_torch.launch import serve
    stats, launches = run["stats"], run["launches"]
    assert len(run["reqs"]) == n_requests
    assert all(r.status == "done" and len(r.generated) == max_new
               for r in run["reqs"]), "a request did not complete"

    def total(key):
        return sum(st.get(key, 0) for st in stats)

    injected = {}
    for st in stats:
        assert not st["failed_requests"], st["failed_requests"]
        assert not st["stalled"], st["stall_reason"]
        if armed is not None:
            serve.assert_recovery_accounted(st)
            for k, v in st["faults"].items():
                injected[k] = injected.get(k, 0) + v
        if warm:
            assert st["post_warmup_compiles"] == 0, st["compile_stalls"]
            assert st["compile_stalls"] == [], st["compile_stalls"]
            assert st["graphs"] > 0, st
    for site in armed or ():
        assert injected[site] >= 1, f"site {site} never fired: {injected}"
    dec = run["engines"][0].backend
    assert launches["flash_attention"] == n_layers * total("prefill_calls"), \
        launches
    assert launches["seal_bits"] == 2 * (total("swap_outs")
                                         + total("transfers_out")), launches
    corrupt = injected.get("corrupt_swap", 0) \
        + injected.get("corrupt_transfer", 0)
    assert run["restore"]["rejected_scatters"] == corrupt, \
        (run["restore"], injected)
    assert launches["unseal_bits"] == 2 * (total("swap_ins")
                                           + total("transfers_in")
                                           + corrupt), launches
    if pipelined is None:
        assert launches["paged_attention"] == n_layers * dec.steps, launches
        assert launches["seal"] == launches["unseal"] == 0, launches
    else:
        nm, S = pipelined
        assert launches["seal"] == launches["unseal"] \
            == dec.steps * nm * (S - 1), (launches, dec.steps)
        assert launches["paged_attention"] == \
            dec.steps * nm * n_layers + run["probe_layers"], launches
    for eng in run["engines"][1:]:
        assert eng.backend.steps == 0, "the prefill role decoded"
    return injected


def serve_chaos(torch, ops, api, params, smi):
    """Phase 10: the fault plane and the recovery ladder at full width in
    f32, local (a), disaggregated (b) and pipelined (c), each chaotic run
    against a fault-free run of the same stream and flags. Returns the six
    runs (launch counts included)."""
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.serving import FaultConfig
    api = build_model(api.cfg, device=api.device, dtype=torch.float32)
    params = _to_f32(params)
    n_layers = api.cfg.num_layers
    out = []

    def report(part, what, chaos, calm, injected):
        dst, cst = chaos["stats"][0], calm["stats"][0]
        rec = {}
        for st in chaos["stats"]:
            for k, v in st["recovery"].items():
                rec[k] = rec.get(k, 0) + v
        steps = [r["engines"][0].backend.steps for r in (chaos, calm)]
        ms = [r["stats"][0]["decode_wall_s"] / max(n, 1) * 1e3
              for r, n in zip((chaos, calm), steps)]
        pr = chaos["probe"]
        log(f"serve phase 10{part} ({what}): {len(chaos['reqs'])} requests,"
            f" streams equal the fault-free run's, none failed, every fault "
            f"accounted; injected "
            f"{ {k: v for k, v in injected.items() if v} }; rungs "
            f"{ {k: v for k, v in rec.items() if v} }; pending "
            f"{dst['faults_pending']}; failure_replans "
            f"{dst['failure_replans']} excluded {dst['excluded_devices']} "
            f"stage_blocks {dst['stage_blocks']}")
        log(f"serve phase 10{part}: launches {chaos['launches']} (fault-free "
            f"{calm['launches']}); restored bit-exact rows "
            f"{chaos['restore']['rows']}, rejected scatters "
            f"{chaos['restore']['rejected_scatters']}")
        log(f"serve phase 10{part}: decode {ms[0]:.2f} ms/step over "
            f"{steps[0]} steps (fault-free {ms[1]:.2f} over {steps[1]}); "
            f"admission p50 {dst.get('admission_p50_ms', 0):.2f} p99 "
            f"{dst.get('admission_p99_ms', 0):.2f} ms (fault-free "
            f"{cst.get('admission_p50_ms', 0):.2f} / "
            f"{cst.get('admission_p99_ms', 0):.2f}); host ms device death "
            f"-> spilled request's next token p50 {_pct(pr.death_ms, .5):.2f}"
            f" p99 {_pct(pr.death_ms, .99):.2f} ({len(pr.death_ms)} "
            f"requests); per tamper fallback p50 "
            f"{_pct(pr.fallback_ms, .5):.2f} p99 "
            f"{_pct(pr.fallback_ms, .99):.2f} ({len(pr.fallback_ms)}); wall "
            f"{chaos['wall']:.2f} s (fault-free {calm['wall']:.2f}); garbage "
            f"collector {chaos['gc']} [{smi}]")

    # 10a: phase 5's stream, local, CUDA graphs
    args = serve.build_parser().parse_args(
        FULL_WIDTH + ["--backend", "local", "--warmup"])
    prompts = serve.gen_prompts(args, api.cfg.vocab_size)
    runs = {}
    for name, faults in (("calm", None), ("chaos", FaultConfig.chaos(
            CHAOS_LOCAL_SEED, corrupt_swap=0.5, pool_storm=0.2,
            device_death=0.3))):
        def build(faults=faults):
            eng = serve.make_engine(api, params, args, faults=faults)
            return eng, [eng]
        runs[name] = _chaos_run(torch, ops, build, lambda eng: serve
                                .serve_stream(eng, args, prompts))
    armed = ("device_death", "stage_stall", "corrupt_swap", "truncate_swap",
             "pool_storm")
    _check_chaos(runs["calm"], n_layers, args.max_new, args.requests, True)
    inj = _check_chaos(runs["chaos"], n_layers, args.max_new, args.requests,
                       True, armed)
    assert runs["chaos"]["streams"] == runs["calm"]["streams"], \
        "phase 10a: chaotic streams differ from the fault-free run's"
    dst = runs["chaos"]["stats"][0]
    assert dst["recovery"]["device_loss_spills"] > 0, dst["recovery"]
    assert runs["chaos"]["probe"].death_ms and \
        runs["chaos"]["probe"].fallback_ms
    report("a", "local, CUDA graphs", runs["chaos"], runs["calm"], inj)
    out += [runs["calm"], runs["chaos"]]

    # 10b: phase 9's pair under --chaos's mix, CUDA graphs
    args = serve.build_parser().parse_args(
        FULL_WIDTH + ["--backend", "local", "--warmup", "--disagg"])
    runs = {}
    for name, faults in (("calm", None),
                         ("chaos", FaultConfig.chaos(CHAOS_DISAGG_SEED))):
        def build(faults=faults):
            orch = serve.make_disagg(api, params, args, faults=faults)
            return orch, [orch.decode, orch.eng_prefill]
        runs[name] = _chaos_run(torch, ops, build, lambda orch: serve
                                .serve_stream_orch(orch, args, prompts))
    armed = ("stage_stall", "corrupt_swap", "truncate_swap",
             "corrupt_transfer", "truncate_transfer", "drop_handoff",
             "delay_handoff", "pool_storm")
    _check_chaos(runs["calm"], n_layers, args.max_new, args.requests, True)
    inj = _check_chaos(runs["chaos"], n_layers, args.max_new, args.requests,
                       True, armed)
    assert runs["chaos"]["streams"] == runs["calm"]["streams"], \
        "phase 10b: chaotic streams differ from the fault-free run's"
    for r in runs.values():
        orch = r["served"]
        assert not orch._in_flight and orch.decode.pending_external == 0
        assert orch.decode.pool.pending_transfers == 0
    assert runs["chaos"]["probe"].fallback_ms
    report("b", "disaggregated pair, CUDA graphs", runs["chaos"],
           runs["calm"], inj)
    out += [runs["calm"], runs["chaos"]]

    # 10c: phase 6's stream pipelined, sealed boundaries, eager, no live
    # swap, one certain device death
    args = serve.build_parser().parse_args(
        FULL_WIDTH + ["--backend", "pipelined"])
    runs = {}
    for name, faults in (("calm", None), ("chaos", FaultConfig(
            CHAOS_PIPE_SEED, device_death=1.0, max_device_deaths=1))):
        def build(faults=faults):
            eng = serve.make_engine(api, params, args, faults=faults,
                                    allow_swap=False)
            assert eng.stage_blocks == (1, 15), eng.stage_blocks
            return eng, [eng]
        runs[name] = _chaos_run(torch, ops, build, lambda eng: serve
                                .serve_stream(eng, args, prompts),
                                pipelined_layers=n_layers)
    pipe = (args.microbatches, args.stages)
    _check_chaos(runs["calm"], n_layers, args.max_new, args.requests, False,
                 pipelined=pipe)
    inj = _check_chaos(runs["chaos"], n_layers, args.max_new, args.requests,
                       False, ("device_death",), pipelined=pipe)
    assert runs["chaos"]["streams"] == runs["calm"]["streams"], \
        "phase 10c: chaotic streams differ from the fault-free run's"
    dst = runs["chaos"]["stats"][0]
    assert dst["failure_replans"] == 1, dst["failure_replans"]
    assert len(dst["excluded_devices"]) == 1, dst["excluded_devices"]
    assert dst["stage_blocks"] == (1, 15) and dst["swaps"] == 0, dst
    assert dst["recovery"]["device_loss_replans"] == 1, dst["recovery"]
    assert dst["recovery"]["device_loss_spills"] > 0, dst["recovery"]
    report("c", "pipelined (1, 15), sealed, eager; a real H100 does not "
           "die: the plane marks a planner domain unhealthy and both "
           "domains are this one card", runs["chaos"], runs["calm"], inj)
    out += [runs["calm"], runs["chaos"]]
    # only the launch counts leave: a run also holds its engines (their f32
    # params, caches and graph pools), which must not outlive this phase
    out = [dict(launches=r["launches"]) for r in out]
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 11: full-width llama3.2-3b over phase 5's stream and pool (a CPU
# rehearsal of these flags at reduced width and the full vocabulary, sampled
# as below: 105 decode steps, 16 one-shot prefills, 6 swaps out and in)
FULL_3B = ["--arch", "llama3.2-3b", "--device", "cuda", "--backend", "local",
           "--slots", "8", "--requests", "16", "--prompt-len", "128",
           "--max-new", "32", "--page-size", "16", "--num-pages", "30",
           "--shared-system-prompt", "0.75"]
SAMPLED = ["--temperature", "0.8", "--top-k", "50"]
SAMPLE_SEED = 11


def serve_sampled(torch, ops, smi):
    """Phase 11: full-width llama3.2-3b (28 layers, head_dim 128, 24 heads
    over 8 KV heads) in bf16 with seeded random weights, phase 5's stream
    and pool, sampled at temperature 0.8, top-k 50, sample seed 11: (a) the
    local backend eager, twice; (b) the same warmed as CUDA graphs; (c) the
    disaggregated pair eager; then the same stream greedy, eager and in
    graphs, as the sampler's yardstick. (a)'s second run, (b) and (c) must
    give (a)'s streams, (b) its schedule and launches;
    ``serve_full_width`` and ``serve_disagg`` hold the launch counts
    (paged = 28 x decode steps, flash = 28 x prefill calls), the bit-exact
    restores and the absence of captures after warmup. Returns the runs'
    launch counts."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    api, params = serve.build_params(serve.build_parser().parse_args(FULL_3B))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve phase 11: llama3.2-3b full width, {api.cfg.num_layers} "
        f"layers, d_model {api.cfg.d_model}, {api.cfg.num_heads} heads over "
        f"{api.cfg.num_kv_heads} KV heads, head_dim {api.cfg.head_dim}, "
        f"vocab {api.cfg.vocab_size}, {n_params / 1e9:.3f} B params bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    seed = {"sample_seed": SAMPLE_SEED}
    sampled = FULL_3B + SAMPLED
    a = serve_full_width(torch, ops, api, params, sampled, "11a", seed,
                         time_sampler=True)
    again = serve_full_width(torch, ops, api, params, sampled,
                             "11a (second run)", seed)
    assert again["streams"] == a["streams"], \
        "phase 11a: a second run's sampled streams differ"
    assert again["schedule"] == a["schedule"] and \
        again["launches"] == a["launches"], (again["schedule"], a["schedule"])
    b = serve_in_graphs(torch, ops, api, params, sampled, "11a", a,
                        label="11b", overrides=seed, time_sampler=True)
    c = serve_disagg(torch, ops, api, params, sampled + ["--disagg"], a, b,
                     smi, overrides=seed, warms=(False,), label="11c")
    greedy = serve_full_width(torch, ops, api, params, FULL_3B,
                              "11 (greedy)", time_sampler=True)
    greedy_b = serve_in_graphs(torch, ops, api, params, FULL_3B,
                               "11 (greedy)", greedy, label="11 (greedy)",
                               time_sampler=True)
    assert greedy["streams"] != a["streams"]
    for name, r in (("11a sampled, eager", a), ("11b sampled, CUDA graphs", b),
                    ("11c sampled, eager pair", c[0]),
                    ("11 greedy, eager", greedy),
                    ("11 greedy, CUDA graphs", greedy_b)):
        smp = "" if r.get("sampler") is None else \
            (f", sampler {r['sampler'][0]:.3f} device ms and "
             f"{r['sampler'][1]:.3f} host ms a step")
        log(f"serve phase {name}: {r['tok_per_s']:.1f} tok/s decode, "
            f"{r['step_ms']:.2f} ms/decode step, admission p50 "
            f"{r['admission'][0]:.2f} p99 {r['admission'][1]:.2f} ms{smp} "
            f"[{smi}]")
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    return [a, again, b, *c, greedy, greedy_b]


# phase 12: full-width qwen2-moe-a2.7b over phase 5's stream and pool (a CPU
# rehearsal of these flags at reduced width with 2 layers and the full
# vocabulary: 99 decode steps, 16 one-shot prefills, 10 swaps out and in,
# on the local backend and on the pipelined one)
FULL_MOE = ["--arch", "qwen2-moe-a2.7b", "--device", "cuda", "--slots", "8",
            "--requests", "16", "--prompt-len", "128", "--max-new", "32",
            "--page-size", "16", "--num-pages", "30",
            "--shared-system-prompt", "0.75"]


def serve_moe(torch, ops, smi):
    """Phase 12: full-width qwen2-moe-a2.7b (24 layers, 60 routed experts
    top-4 plus 4 shared, 16 heads over 16 KV heads, head_dim 128, biases)
    in bf16 with seeded random weights, greedy, phase 5's stream and pool:
    (a) the local backend eager, twice; (b) the same warmed as CUDA
    graphs; (c) pipelined eager over two enclaves with two microbatches
    and sealed boundaries. (a)'s second run and (b) must give (a)'s
    streams, schedule and launches; ``serve_full_width`` holds the launch
    counts (paged = 24 x decode steps, flash = 24 x prefill calls, seals
    nm x (S - 1) a step), the bit-exact restores, the finite logits, (b)'s
    absence of captures after warmup and (c)'s blocks (4, 20) with no
    re-plan. (c)'s streams are not compared with (a)'s: the quantizing
    seal is lossy. Returns the runs' launch counts."""
    from repro_torch.launch import serve
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    api, params = serve.build_params(serve.build_parser().parse_args(
        FULL_MOE))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()            # the init's f32 draws
    cfg = api.cfg
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve phase 12: qwen2-moe-a2.7b full width, {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok} + {cfg.num_shared_experts} shared, "
        f"moe_d_ff {cfg.moe_d_ff}, {cfg.num_heads} heads over "
        f"{cfg.num_kv_heads} KV heads, head_dim {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params bf16 (config "
        f"count {cfg.total_params() / 1e9:.3f} B without biases), init "
        f"{init_s:.2f} s, memory allocated {before:.2f} GiB before init and "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB after")
    local = FULL_MOE + ["--backend", "local"]
    a = serve_full_width(torch, ops, api, params, local, "12a")
    again = serve_full_width(torch, ops, api, params, local,
                             "12a (second run)")
    assert again["streams"] == a["streams"], \
        "phase 12a: a second run's streams differ"
    assert again["schedule"] == a["schedule"] and \
        again["launches"] == a["launches"], (again["schedule"], a["schedule"])
    b = serve_in_graphs(torch, ops, api, params, local, "12a", a,
                        label="12b")
    c = serve_full_width(torch, ops, api, params, FULL_MOE + [
        "--backend", "pipelined", "--stages", "2", "--microbatches", "2"],
        "12c", plan=(4, 20))
    for name, r in (("12a eager", a), ("12a eager, second run", again),
                    ("12b CUDA graphs", b), ("12c pipelined (4, 20), eager",
                                             c)):
        log(f"serve phase {name}: {r['tok_per_s']:.1f} tok/s decode, "
            f"{r['step_ms']:.2f} ms/decode step, admission p50 "
            f"{r['admission'][0]:.2f} p99 {r['admission'][1]:.2f} ms, "
            f"memory reserved {r['reserved_gib']:.2f} GiB, peak "
            f"{r['peak_gib']:.2f} GiB, peak allocated "
            f"{r['peak_alloc_gib']:.2f} GiB [{smi}]")
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    return [a, again, b, c]


# phase 13: the launcher's defaults (batch 8, seq 128, lr 1e-3, warmup
# steps / 10), 30 steps, no checkpoint directory
FULL_TRAIN = ["--arch", "llama3.2-1b", "--steps", "30", "--batch", "8",
              "--seq", "128", "--lr", "1e-3"]


def train_full_width(torch, ops, smi):
    """Phase 13: ``launch.train.main`` on full-width llama3.2-1b in bf16
    (16 layers, d_model 2048, vocab 128,256, tied; weights from a seeded
    ``torch.Generator`` on the card), 30 steps. Every loss and grad norm
    finite, the mean of the last 5 losses below the first, and the flash
    kernel launched 2 x 16 times a step (each block's forward and its
    remat recompute). Prints the loss curve, ms per step (median after
    step 2), tokens/s, parameters, memory reserved and at peak, the bytes
    a checkpoint would write (not written), and model FLOPs a step over
    the step time against the bf16 peak, as an estimate. Returns the
    launch counts."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import train
    from repro_torch.models.api import build_model
    from repro_torch.tree import leaves
    args = train.build_parser().parse_args(FULL_TRAIN)
    cfg = reduced(get_arch(args.arch)) if args.reduced else get_arch(args.arch)
    n_params = sum(math.prod(spec.shape) for spec in leaves(
        build_model(cfg, device="cuda").param_specs()))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(FULL_TRAIN)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.memory_reserved() / 2**30
    losses, gnorms, times = out["losses"], out["gnorms"], out["step_times"]
    steps = args.steps
    assert out["step"] == steps and len(losses) == steps, out["step"]
    assert all(x == x and abs(x) != float("inf") for x in losses + gnorms), \
        (losses, gnorms)
    tail = sum(losses[-5:]) / 5
    assert tail < losses[0], (losses[0], tail)
    assert launches["flash_attention"] == 2 * cfg.num_layers * steps, \
        launches
    assert sum(launches.values()) == launches["flash_attention"], launches
    ms = sorted(times[2:])[len(times[2:]) // 2] * 1e3
    tokens = args.batch * args.seq
    # model FLOPs (no recompute): 6 N per token for the weights, and the
    # causal attention's scores and weighted sums, 2 S D H per layer per
    # token forward, three times that with the backward
    flops = 6.0 * n_params * tokens \
        + 6.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim * args.seq \
        * tokens
    ckpt_bytes = 4 * 4 * n_params      # params widened to f32, master, m, v
    log(f"train phase 13: llama3.2-1b full width, {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params bf16 (f32 master and moments), "
        f"batch {args.batch} x seq {args.seq}, lr {args.lr}, "
        f"{steps} steps in {wall:.1f} s (init, build and first step "
        f"included)")
    log(f"train phase 13: losses {[round(x, 4) for x in losses]}")
    log(f"train phase 13: grad norms {[round(x, 3) for x in gnorms]}")
    log(f"train phase 13: loss {losses[0]:.4f} -> mean of last 5 "
        f"{tail:.4f}; ms per step {ms:.2f} (median of steps 3-{steps}; "
        f"first step {times[0] * 1e3:.1f}, step 2 {times[1] * 1e3:.1f}), "
        f"{tokens / ms * 1e3:.0f} tokens/s; flash launches "
        f"{launches['flash_attention']} = 2 x {cfg.num_layers} layers x "
        f"{steps} steps")
    log(f"train phase 13: memory peak allocated {peak:.2f} GiB, reserved "
        f"{reserved:.2f} GiB; a checkpoint of this state would write "
        f"{ckpt_bytes} bytes of npz ({ckpt_bytes / 1e9:.1f} GB; not "
        f"written)")
    log(f"train phase 13: model FLOPs a step {flops / 1e12:.3f} TFLOP "
        f"(6 N T + causal attention, no recompute) over {ms:.2f} ms = "
        f"{flops / ms / 1e9:.1f} TFLOP/s, an estimate of "
        f"{flops / ms / 1e9 / (BF16_TC_FLOP_PER_S / 1e12) * 100:.1f}% of "
        f"the 989 TFLOP/s bf16 peak [{smi}]")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches}


# phase 14: the timeline KV layout, per-token prefill and the int8 cache at
# full width. 14a: one short stream in f32 through three engines (a CPU
# rehearsal of these flags: 8 prompts of 2-42 tokens, 168 per-token
# prefill steps, auto horizon 144); 14b: phase 5's first 8 requests (its
# stream trimmed from 16 to keep the phase's time: 746 per-token prefill
# steps a run) in bf16; 14c: the int8 cache against bf16.
TIMELINE_F32 = ["--arch", "llama3.2-1b", "--device", "cuda", "--backend",
                "local", "--slots", "8", "--requests", "8", "--prompt-len",
                "48", "--max-new", "32", "--page-size", "16"]
TIMELINE_BF16 = ["--arch", "llama3.2-1b", "--device", "cuda", "--slots",
                 "8", "--requests", "8", "--prompt-len", "128", "--max-new",
                 "32", "--page-size", "16", "--shared-system-prompt", "0.75"]
# a horizon that admits the stream's first requests only: past 8 decode
# steps no request's 32 new tokens fit under it
SHORT_HORIZON = 128 + 40


class TimedTokens:
    """An engine's per-token prefill timed from outside: the host clock
    around each admission's token loop (``_prefill_tokens``), between two
    device synchronises, and its tokens counted."""

    def __init__(self, torch, eng):
        self.seconds, self.tokens = 0.0, 0
        fn = eng._prefill_tokens

        def timed(tokens, S):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tokens, S)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.tokens += len(tokens)
            return out

        eng._prefill_tokens = timed

    def ms(self) -> float:
        return self.seconds / max(self.tokens, 1) * 1e3


def serve_layout(torch, ops, api, params, argv, label, overrides=None):
    """One engine of phase 14 over ``argv``'s stream, launch counts zeroed
    just before and read just after. Every request must complete with
    finite logits. Returns the launch counts, the streams, the engine's
    stats, decode steps, host ms per decode step and per prefill token,
    and memory reserved and at peak."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(argv)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = serve.make_engine(api, params, args, **(overrides or {}))
    if args.warmup:
        st = eng.stats()
        assert st["warmed"] and st["graphs"] > 0, st
    timed = TimedTokens(torch, eng)
    be = eng.backend
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    orig_step = be.step

    def step(tokens, key):
        logits = orig_step(tokens, key)
        bad.add_((~torch.isfinite(logits)).sum())
        return logits

    be.step = step
    prompts = serve.gen_prompts(args, api.cfg.vocab_size)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = serve.serve_stream(eng, args, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = eng.stats()
    assert len(reqs) == args.requests, (len(reqs), st["stall_reason"])
    assert all(r.status == "done" and len(r.generated) == args.max_new
               for r in reqs), "a request did not complete"
    assert int(bad.item()) == 0, "non-finite logits"
    if args.warmup:
        assert st["post_warmup_compiles"] == 0, st["compile_stalls"]
        assert st["compile_stalls"] == [], st["compile_stalls"]
    step_ms = st["decode_wall_s"] / max(be.steps, 1) * 1e3
    log(f"timeline phase {label} ({st['kv_layout']}, {st['backend']}"
        f"{', CUDA graphs' if args.warmup else ''}"
        f"{', per-token prefill' if not st['batched_prefill'] else ''}): "
        f"{st['completed']} requests, {st['tokens_out']} tokens, "
        f"{be.steps} decode steps, {step_ms:.2f} ms/decode step, "
        f"{st['tok_per_s']:.1f} tok/s decode, admission p50 "
        f"{st.get('admission_p50_ms', 0):.1f} p99 "
        f"{st.get('admission_p99_ms', 0):.1f} ms, prefill "
        f"{st['prefill_calls']} calls, {timed.ms():.3f} ms per prefill "
        f"token over {timed.tokens} tokens, wall {wall:.2f} s, memory "
        f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB, peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {launches}")
    return dict(launches=launches, streams=[list(r.generated) for r in reqs],
                st=st, steps=be.steps, step_ms=step_ms,
                token_ms=timed.ms(), tokens=timed.tokens)


def serve_timeline(torch, ops, smi):
    """Phase 14 on full-width llama3.2-1b (seeded bf16 weights, 8 slots):
    (a) in f32 (upcast, exact), one stream of 8 requests through the
    timeline (per-token prefill, horizon sized to the stream), the paged
    engine with per-token prefill and the paged engine with batched
    prefill: equal greedy streams, per-token prefill one call a token;
    (b) in bf16, phase 5's first 8 requests on the timeline local eager,
    local in CUDA graphs (streams, steps and launches equal to eager,
    nothing captured after warmup), pipelined at blocks (1, 15) with sealed
    boundaries (seal and unseal each microbatches x (stages - 1) a step),
    and paged with per-token prefill in graphs (paged attention a layer a
    decode step, no flash), then the timeline in graphs under a horizon
    too short for the stream: back-pressure fires, the engine stalls, and
    every request is done or still queued; (c) the int8 cache's
    ``prefill_fn`` then ``decode_fn`` on 4 x 31 tokens plus one against
    bf16 (top-1 on every row, relative logit error < 0.15, cache bytes <
    0.55 x), and the reference's zero-scale behaviour after per-token
    prefill, logged. Returns the runs' launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import SEGMENT
    t_phase = time.perf_counter()
    api, params = serve.build_params(serve.build_parser().parse_args(
        TIMELINE_BF16))
    cfg = api.cfg
    n_layers = cfg.num_layers
    runs = []

    # 14a: f32 stream identity
    api32 = build_model(cfg, device="cuda", dtype=torch.float32)
    params32 = _to_f32(params)
    a = [serve_layout(torch, ops, api32, params32, TIMELINE_F32 + flags,
                      f"14a {name}")
         for name, flags in (("timeline", ["--kv-layout", "timeline"]),
                             ("paged per-token", ["--per-token-prefill"]),
                             ("paged batched", []))]
    assert a[0]["streams"] == a[1]["streams"] == a[2]["streams"], \
        "phase 14a: timeline, paged per-token and paged batched streams differ"
    assert a[0]["st"]["prefill_calls"] == a[1]["st"]["prefill_calls"] \
        == a[0]["tokens"] and a[2]["st"]["prefill_calls"] == 8, \
        [r["st"]["prefill_calls"] for r in a]
    assert a[0]["launches"]["paged_attention"] == 0
    assert a[1]["launches"]["paged_attention"] == a[1]["steps"] * n_layers
    assert a[1]["launches"]["flash_attention"] == 0
    assert a[2]["launches"]["flash_attention"] == 8 * n_layers
    log(f"timeline phase 14a: {len(a[0]['streams'])} f32 streams equal "
        f"across timeline (max_seq {a[0]['st']['max_seq']}), paged "
        f"per-token and paged batched prefill; prefill calls "
        f"{[r['st']['prefill_calls'] for r in a]}")
    runs += a
    del api32, params32
    gc.collect()
    torch.cuda.empty_cache()

    # 14b: bf16, phase 5's first 8 requests
    tl = TIMELINE_BF16 + ["--kv-layout", "timeline"]
    eager = serve_layout(torch, ops, api, params, tl + ["--backend", "local"],
                         "14b local, eager")
    graphs = serve_layout(torch, ops, api, params,
                          tl + ["--backend", "local", "--warmup"],
                          "14b local, CUDA graphs")
    assert graphs["streams"] == eager["streams"], \
        "phase 14b: the timeline's streams differ under CUDA graphs"
    assert graphs["steps"] == eager["steps"] and \
        graphs["launches"] == eager["launches"], (graphs["steps"],
                                                  eager["steps"])
    pipe = serve_layout(torch, ops, api, params,
                        tl + ["--backend", "pipelined", "--stages", "2",
                              "--microbatches", "2"], "14b pipelined, sealed")
    st = pipe["st"]
    assert st["stage_blocks"] == (1, 15) and st["replans"] == 0, st
    assert pipe["launches"]["seal"] == pipe["launches"]["unseal"] \
        == pipe["steps"] * 2 * 1, (pipe["launches"], pipe["steps"])
    paged = serve_layout(torch, ops, api, params,
                         TIMELINE_BF16 + ["--backend", "local",
                                          "--per-token-prefill", "--warmup"],
                         "14b paged per-token, CUDA graphs")
    assert paged["launches"]["paged_attention"] == paged["steps"] * n_layers
    assert paged["launches"]["flash_attention"] == 0
    same = sum(x == y for x, y in zip(paged["streams"], eager["streams"]))
    log(f"timeline phase 14b: {same} of {len(eager['streams'])} bf16 "
        f"streams of the paged per-token engine equal the timeline's (not "
        f"required: other attention kernels, bf16); seal "
        f"{pipe['launches']['seal']} = unseal = {pipe['steps']} steps x 2 "
        f"microbatches x 1 "
        f"boundary; host ms per decode step eager {eager['step_ms']:.2f}, "
        f"graphs {graphs['step_ms']:.2f}, pipelined {pipe['step_ms']:.2f}, "
        f"paged per-token graphs {paged['step_ms']:.2f}; ms per prefill "
        f"token eager {eager['token_ms']:.3f}, graphs "
        f"{graphs['token_ms']:.3f}, paged graphs {paged['token_ms']:.3f} "
        f"[{smi}]")
    runs += [eager, graphs, pipe, paged]

    # 14b: horizon back-pressure under a short horizon, in graphs
    args = serve.build_parser().parse_args(
        tl + ["--backend", "local", "--warmup", "--max-seq",
              str(SHORT_HORIZON)])
    eng = serve.make_engine(api, params, args)
    prompts = serve.gen_prompts(args, cfg.vocab_size)
    ops.reset_launch_counts()
    reqs = serve.serve_stream(eng, args, prompts)
    # the stream stopped at the stall: the rest queue behind the head
    reqs += [eng.submit(p, args.max_new) for p in prompts[len(reqs):]]
    eng.step()
    launches = dict(ops.LAUNCHES)
    st = eng.stats()
    done = [r for r in reqs if r.status == "done"]
    queued = [r for r in reqs if r.status == "queued"]
    assert len(done) + len(queued) == len(prompts) and done and queued, \
        [r.status for r in reqs]
    assert all(len(r.generated) == args.max_new for r in done)
    assert eng.stalled and st["stall_reason"] == "permanent", st
    assert any(e.kind == "backpressure" and e.detail["waiting_on"] ==
               "timeline" for e in eng.events)
    assert st["global_len"] <= SHORT_HORIZON - 1, st["global_len"]
    assert st["post_warmup_compiles"] == 0, st["compile_stalls"]
    agree = sum(r.generated == eager["streams"][r.rid] for r in done)
    log(f"timeline phase 14b (max_seq {SHORT_HORIZON}, CUDA graphs): "
        f"back-pressure at global_len {st['global_len']}; {len(done)} "
        f"requests done ({agree} streams equal to the full horizon's), "
        f"{len(queued)} queued behind the blocked head, none lost; stalled "
        f"({st['stall_reason']})")
    runs.append({"launches": launches})
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # 14c: the int8 cache, the reference's test of it
    # (tests/test_perf_features.py::test_int8_cache_decode_top1_agrees):
    # prefill 4 x 31 tokens, pad one position, decode one token, int8
    # against bf16 at full width; and the int8 path card against CPU at the
    # reduced config, in f32
    from repro_torch.configs import reduced

    def int8_path(m_cfg, m_params, toks, new, quant, dtype, device):
        m = build_model(m_cfg, device=device, dtype=dtype, max_seq=32,
                        cache_quant=quant)
        _, c = m.prefill_fn(m_params, {"tokens": toks.to(device)})
        c[SEGMENT] = tuple(torch.nn.functional.pad(x, (0, 0, 0, 1))
                           if x.dim() == 5 else x for x in c[SEGMENT])
        logits = m.decode_fn(m_params, c, {"tokens": new.to(device)})[0]
        return logits.float().cpu(), [x.cpu() for x in c[SEGMENT]]

    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 31), generator=g,
                         device="cuda")
    new = torch.randint(0, cfg.vocab_size, (4, 1), generator=g,
                        device="cuda")
    ops.reset_launch_counts()
    (lf, cf), (lq, cq) = (int8_path(cfg, params, toks, new, quant,
                                    torch.bfloat16, "cuda")
                          for quant in (False, True))
    launches = dict(ops.LAUNCHES)
    assert launches["flash_attention"] == 2 * n_layers, launches
    nbytes = [sum(x.numel() * x.element_size() for x in c) for c in (cf, cq)]
    top1 = int((lf.argmax(-1) == lq.argmax(-1)).sum())
    rel = float((lf - lq).abs().max() / (lf.abs().max() + 1e-9))
    assert top1 == 4, (lf.argmax(-1), lq.argmax(-1))
    assert nbytes[1] < 0.55 * nbytes[0], nbytes
    small = reduced(get_arch("llama3.2-1b"))
    small_params = build_model(small, device="cpu", dtype=torch.float32
                               ).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, small.vocab_size, (4, 31), generator=g)
    new = torch.randint(0, small.vocab_size, (4, 1), generator=g)
    (l_cpu, c_cpu), (l_gpu, c_gpu) = (
        int8_path(small, _to(torch, small_params, dev), toks, new, True,
                  torch.float32, dev) for dev in ("cpu", "cuda"))
    lerr = float((l_gpu - l_cpu).abs().max() / l_cpu.abs().max())
    assert lerr < 1e-4, lerr
    ties = 0
    for a, b in zip(c_gpu, c_cpu):
        if a.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            assert int(d.max()) <= 1, int(d.max())
            ties += int((d > 0).sum())
        else:
            assert torch.allclose(a, b, rtol=1e-5, atol=0), \
                float((a - b).abs().max())
    written = sum(x.numel() for x in c_cpu if x.dim() == 5)
    assert ties <= 0.01 * written, (ties, written)
    log(f"timeline phase 14c: int8 cache, prefill 4 x 31 then decode 1, "
        f"full width: top-1 agrees with bf16 on {top1} of 4 rows, cache "
        f"{nbytes[1]} bytes against {nbytes[0]} bf16 "
        f"({nbytes[1] / nbytes[0]:.4f} x, < 0.55), relative logit error "
        f"{rel:.4f} (printed, not bounded: the reference's int8 scheme "
        f"exceeds 0.15 at full width too, tests/test_torch_timeline.py); "
        f"the reduced config in f32, card against CPU: logits within "
        f"{lerr:.2e} of the largest (< 1e-4), int8 payloads equal but for "
        f"{ties} rounding ties of {written} elements, scales within 1e-5")
    runs.append({"launches": launches})
    # the reference's engine prefills a token at a time from a zero cache,
    # scales included, and only prefill_fn sets them: every K/V is
    # quantized against 0 (logged, not checked: the port reproduces it)
    del small_params
    api_q = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                        cache_quant=True)
    qargs = serve.build_parser().parse_args(
        tl + ["--backend", "local", "--requests", "1", "--max-new", "4"])
    prompt = serve.gen_prompts(qargs, cfg.vocab_size)[:1]
    streams = []
    for m in (api_q, api):
        e = serve.make_engine(m, params, qargs)
        streams.append(serve.serve_stream(e, qargs, prompt)[0].generated)
        if m is api_q:
            k_q, _, k_s, v_s = e.backend.cache[SEGMENT]
            written = k_q[:, 0, :, 128 - len(prompt[0]):128 + 3]
            frac = float((written.abs() == 127).float().mean())
            scale_max = float(torch.maximum(k_s.abs().max(),
                                            v_s.abs().max()))
        del e
    log(f"timeline phase 14c (the reference's zero-scale int8 engine, "
        f"reproduced, not checked): after per-token prefill of "
        f"{len(prompt[0])} tokens and 3 decode steps the scales' largest "
        f"|value| is {scale_max}, {frac:.3f} of slot 0's written K payload "
        f"is +-127; first tokens int8 {streams[0]} against bf16 "
        f"{streams[1]}")
    del api, params, api_q
    gc.collect()
    torch.cuda.empty_cache()
    log(f"timeline phase 14: wall {time.perf_counter() - t_phase:.1f} s "
        f"[{smi}]")
    return runs


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# phase 15: the paper's planning and privacy path. 15a: the LM similarity
# profile of full-width llama3.2-1b on a calibration batch at phase 13's
# flash shape (B=8, S=128), planned as the quickstart plans; 15b: TinyCNN
# over the five CNN tables and the image metric; 15c: the Fig. 12 claims
# through the port's planner, the simulator, the attestation stub.
CALIB_BATCH, CALIB_SEQ = 8, 128
PLAN_N = 10_000                         # the quickstart's chunk of frames
FIG12_N = 10_800                        # tests/test_placement.py's
# card against CPU: f32 on both sides, TF32 off; raw hidden states are
# held relative to their layer's largest |value| (they grow to hundreds)
HIDDEN_TOL = 1e-4
CNN_TOL = 1e-4                          # TinyCNN maps, atol x max(1, |map|)
METRIC_TOL = 1e-5                       # downsample_similarity


def _c2_violations(best, profiles, graph, delta):
    """Layers on an untrusted device whose input similarity is >= delta
    (the planner's C2: layer x reads layer x-1's output, layer 0 the
    input, similarity 1)."""
    bad = []
    for s in best.placement.stages:
        if graph.devices[s.device].trusted:
            continue
        for x in range(s.start, s.end):
            sim = 1.0 if x == 0 else profiles[x - 1].similarity
            if sim >= delta:
                bad.append((x, sim))
    return bad


def _lm_graphs():
    """The resource graphs phase 15a plans over: the quickstart's two
    trusted pods, a trusted and an untrusted pod, and the paper's TEE and
    GPU over a 30 Mbit/s link, where the untrusted device is fast enough
    that every layer C2 frees leaves the enclave."""
    from repro_torch.core import cost_model as CM
    from repro_torch.core.placement import ResourceGraph
    from repro_torch.enclave.domain import (default_two_pod_manager,
                                            two_enclave_manager)
    return {"two enclaves": two_enclave_manager().resource_graph(),
            "trusted + untrusted pod":
                default_two_pod_manager().resource_graph(),
            "TEE + GPU over 30 Mbit/s": ResourceGraph(
                {"tee1": CM.TEE, "gpu": CM.GPU}, {}, CM.WAN_30MBPS)}


def _plan_lm(cfg, sims, graphs):
    """The quickstart's plan (``profiles_from_arch`` at seq_len 256, the
    shim's exhaustive ``solve`` at n = PLAN_N, delta = LM_SIM_DELTA) over
    each graph; C2 is checked on every plan: no layer on an untrusted
    device reads an input at similarity >= delta, so none sits before the
    private depth."""
    from repro_torch.core.placement import profiles_from_arch, solve
    from repro_torch.core.privacy import LM_SIM_DELTA, private_depth
    profiles = profiles_from_arch(cfg, seq_len=256, similarities=sims)
    depth = private_depth(sims, LM_SIM_DELTA)
    plans = {}
    for name, g in graphs.items():
        best, evals = solve(profiles, g, n=PLAN_N, delta=LM_SIM_DELTA)
        assert best.feasible, (name, best)
        bad = _c2_violations(best, profiles, g, LM_SIM_DELTA)
        assert not bad and best.max_similarity < LM_SIM_DELTA, (name, bad)
        untrusted = [s.start for s in best.placement.stages
                     if not g.devices[s.device].trusted]
        assert all(x >= depth for x in untrusted), (name, untrusted, depth)
        plans[name] = (best, len(evals), untrusted)
    return plans


def _fig12_speedups(model):
    """Fig. 12's bars for one CNN through the port's planner: the one-TEE
    baseline's chunk time over 2 TEEs', TEE+GPU's, the proposed
    placement's and no pipelining's (tests/test_placement.py). Returns the
    speedups and the chosen plans."""
    import dataclasses
    from repro_torch.core import cost_model as CM
    from repro_torch.core.placement import (Placement, ResourceGraph, Stage,
                                            evaluate, profiles_from_cnn,
                                            solve)
    from repro_torch.core.privacy import resolution_similarity
    from repro_torch.models.cnn import CNN_MODELS
    delta = resolution_similarity(20)
    tee2 = dataclasses.replace(CM.TEE, name="tee2")
    graphs = {"tee+gpu": {"tee1": CM.TEE, "gpu": CM.GPU},
              "2tee": {"tee1": CM.TEE, "tee2": tee2},
              "proposed": {"tee1": CM.TEE, "tee2": tee2, "gpu": CM.GPU}}
    graphs = {k: ResourceGraph(v, {}, CM.WAN_30MBPS)
              for k, v in graphs.items()}
    profs = profiles_from_cnn(CNN_MODELS[model])
    g_all = graphs["proposed"]
    base = evaluate(Placement((Stage("tee1", 0, len(profs)),)), profs, g_all,
                    FIG12_N, delta)
    out, plans = {}, {}
    for name, g in graphs.items():
        b, _ = solve(profs, g, n=FIG12_N, delta=delta)
        out[name], plans[name] = base.t_chunk / b.t_chunk, b
    b, _ = solve(profs, g_all, n=FIG12_N, delta=delta, pipelined=False)
    out["nopipe"] = base.t_chunk / evaluate(b.placement, profs, g_all,
                                            FIG12_N, delta).t_chunk
    return out, plans


def _host_payload(torch, params):
    """The params as a host payload (numpy arrays, bf16 as its int16
    bits) for ``sealing.payload_digest``."""
    return {k: _host_payload(torch, v) if isinstance(v, dict) else
            (v.view(torch.int16) if v.dtype == torch.bfloat16 else v)
            .cpu().numpy() for k, v in params.items()}


def plan_privacy(torch, ops, smi):
    """Phase 15: (a) the LM similarity profile. First the reduced
    llama3.2-1b in f32, card against CPU: ``hidden_states_fn`` (flash a
    layer on the card), the similarity profile, the private depth and the
    plan must agree. Then full-width llama3.2-1b in bf16 (seeded weights,
    phase 5's draw) on a calibration batch of 8 x 128 seeded tokens: 16
    flash launches, [17, 8, 128, 2048] bf16, finite; the profile, the
    private depth and the quickstart's plan over two trusted pods and over
    a trusted and an untrusted pod, C2 on both; host ms of the forward
    between two synchronises, twice. (b) TinyCNN (8 channels) over the five
    CNN tables on a 224 x 224 ``VideoChunkStream`` frame, card against CPU
    with the same weights, every map at its table entry's resolution, the
    antialiased resize a CUDA kernel; ``downsample_similarity`` at 112,
    56, 28, 14 and 7 on the card equal to the CPU's, with the reference
    test's asserts. (c) The Fig. 12 speedups through the port's planner
    with the claims' asserts, ``simulate_pipeline`` = Eq. 1-2 on every
    chosen plan, and the attestation stub over the full-width params'
    payload digest: it verifies, and fails after one flipped byte.
    Returns the full-width forwards' launch counts."""
    import numpy as np
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import privacy as P
    from repro_torch.core.pipeline_sim import (closed_form_completion,
                                               simulate_pipeline)
    from repro_torch.data.stream import VideoChunkStream
    from repro_torch.enclave import sealing
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    from repro_torch.models.cnn import CNN_MODELS, TinyCNN
    t_phase = time.perf_counter()
    graphs = _lm_graphs()

    # 15a, reduced config in f32: card against the CPU's plain path
    small = reduced(get_arch("llama3.2-1b"))
    api_cpu = build_model(small, device="cpu", dtype=torch.float32)
    p_cpu = api_cpu.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, small.vocab_size, (4, 64),
                         generator=torch.Generator().manual_seed(3))
    h_ref = api_cpu.model.hidden_states_fn(p_cpu, {"tokens": toks})
    api_gpu = build_model(small, device="cuda", dtype=torch.float32)
    ops.reset_launch_counts()
    h_card = api_gpu.model.hidden_states_fn(_to(torch, p_cpu, "cuda"),
                                            {"tokens": toks.cuda()}).cpu()
    assert ops.LAUNCHES["flash_attention"] == small.num_layers, ops.LAUNCHES
    herr = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(h_card, h_ref))
    assert herr < HIDDEN_TOL, herr
    sims_ref, sims_card = (P.lm_similarity_profile(h) for h in (h_ref,
                                                                h_card))
    serr = float(np.abs(sims_card - sims_ref).max())
    assert serr < HIDDEN_TOL, (sims_card, sims_ref)
    d_ref, d_card = (P.private_depth(s, P.LM_SIM_DELTA)
                     for s in (sims_ref, sims_card))
    plans_ref, plans_card = (_plan_lm(small, s, graphs)
                             for s in (sims_ref, sims_card))
    assert d_ref == d_card, (d_ref, d_card)
    for name in graphs:
        assert plans_ref[name][0].placement == \
            plans_card[name][0].placement, name
    log(f"privacy phase 15a (reduced llama3.2-1b, f32, card against CPU): "
        f"hidden states [{', '.join(map(str, h_card.shape))}] within "
        f"{herr:.2e} of each layer's largest |value| (< {HIDDEN_TOL}), "
        f"similarities within {serr:.2e}, private depth {d_card} both, "
        f"placements equal: "
        + "; ".join(f"{n}: {plans_card[n][0].placement.describe()}"
                    for n in graphs))
    del api_cpu, api_gpu, p_cpu, h_ref, h_card

    # 15a at full width, bf16
    api, params = serve.build_params(serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--device", "cuda"]))
    cfg = api.cfg
    g = torch.Generator(device="cuda").manual_seed(15)
    calib = torch.randint(0, cfg.vocab_size, (CALIB_BATCH, CALIB_SEQ),
                          generator=g, device="cuda")
    runs, fwd_ms = [], []
    for _ in range(2):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        h = api.model.hidden_states_fn(params, {"tokens": calib})
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        assert launches["flash_attention"] == cfg.num_layers and \
            sum(launches.values()) == cfg.num_layers, launches
        runs.append({"launches": launches})
    assert tuple(h.shape) == (cfg.num_layers + 1, CALIB_BATCH, CALIB_SEQ,
                              cfg.d_model) and h.dtype == torch.bfloat16
    assert bool(torch.isfinite(h).all())
    assert torch.equal(h[0], params["embed"][calib])
    sims = P.lm_similarity_profile(h)
    depth = P.private_depth(sims, P.LM_SIM_DELTA)
    assert sims.shape == (cfg.num_layers,) and np.isfinite(sims).all()
    assert (sims >= 0).all() and (sims <= 1 + 1e-6).all(), sims
    plans = _plan_lm(cfg, sims, graphs)
    log(f"privacy phase 15a (llama3.2-1b full width, bf16, calibration "
        f"batch {CALIB_BATCH} x {CALIB_SEQ}): hidden states "
        f"[{', '.join(map(str, h.shape))}] {h.dtype}, "
        f"{h.numel() * h.element_size() / 1e6:.1f} MB; flash launches "
        f"{launches['flash_attention']} a forward; host ms of the forward "
        f"{fwd_ms[0]:.3f} (first), {fwd_ms[1]:.3f} (second), between two "
        f"synchronises; peak allocated {peak / 2**30:.2f} GiB [{smi}]")
    log(f"privacy phase 15a: similarity to the input embedding per block "
        f"{[round(float(s), 6) for s in sims]}; private depth "
        f"{depth} of {cfg.num_layers} at delta {P.LM_SIM_DELTA}")
    for name, (best, n_eval, untrusted) in plans.items():
        log(f"privacy phase 15a plan over {name} ({n_eval} tree paths; the "
            f"planner's device model of core/cost_model.py, not a "
            f"measurement): {best.placement.describe()}, t_chunk "
            f"{best.t_chunk:.6g} s for n = {PLAN_N}, bottleneck "
            f"{best.bottleneck * 1e6:.3f} us, max_similarity "
            f"{best.max_similarity:.6f} < {P.LM_SIM_DELTA}; C2 holds "
            f"(untrusted stages start at {untrusted or 'none'}, private "
            f"depth {depth})")

    # 15c's attestation, while the full-width params are here
    code = b"".join(open(os.path.join(SRC, "repro_torch", "models", f),
                         "rb").read()
                    for f in ("transformer.py", "layers.py"))
    t0 = time.perf_counter()
    payload = _host_payload(torch, params)
    _, digest = sealing.payload_digest(payload)
    digest_s = time.perf_counter() - t0
    quote = sealing.measure(code, digest)
    assert sealing.verify(sealing.measure(code, sealing.payload_digest(
        payload)[1]), quote)
    leaf = payload["blocks"]["attn"]["wq"]
    leaf.view(np.uint8).reshape(-1)[12345] ^= 1
    tampered = sealing.measure(code, sealing.payload_digest(payload)[1])
    assert not sealing.verify(tampered, quote)
    assert not sealing.verify(sealing.measure(code + b" ", digest), quote)
    n_bytes = sum(a.nbytes for a in sealing._leaves(payload))
    log(f"privacy phase 15c: attestation over the full-width params' "
        f"payload digest ({n_bytes} bytes, host copy and SHA-256 "
        f"{digest_s:.2f} s): measurement {quote.hex()[:16]}... verifies; "
        f"one flipped byte of blocks.attn.wq and one changed byte of code "
        f"each fail it")
    del api, params, h, payload, leaf, calib
    gc.collect()
    torch.cuda.empty_cache()

    # 15b: TinyCNN over the five tables, card against CPU
    frame = torch.from_numpy(VideoChunkStream(resolution=224).frame(0, 0))
    worst = {}
    for i, (name, table) in enumerate(CNN_MODELS.items()):
        cnn = TinyCNN(table, 8, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(7 + i))
        ref = TinyCNN(table, 8, device="cpu",
                      kernels=[w.detach().cpu() for w in cnn.kernels])
        if i == 0:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                got = cnn.intermediates(frame.cuda())
                torch.cuda.synchronize()
            kernels = sorted({e.key for e in prof.key_averages()
                              if e.device_type ==
                              torch.autograd.DeviceType.CUDA})
            resize = sorted({m.group(0) for m in (
                re.search(r"upsample\w*", k) for k in kernels) if m})
            assert resize, kernels
        else:
            got = cnn.intermediates(frame.cuda())
        want = ref.intermediates(frame)
        assert len(got) == len(want) == len(table)
        err = 0.0
        for a, b, layer in zip(got, want, table):
            res = max(2, layer.resolution)
            assert a.is_cuda and tuple(a.shape) == tuple(b.shape) == \
                (res, res, 8), (name, layer.name, a.shape)
            e = float((a.cpu() - b).abs().max()) / max(1.0, float(
                b.abs().max()))
            assert e < CNN_TOL, (name, layer.name, e)
            err = max(err, e)
        worst[name] = err
    log(f"privacy phase 15b: TinyCNN (8 channels, 224 x 224 frame) on the "
        f"card against the CPU, every map at its table entry's resolution, "
        f"largest error relative to the map's largest |value| "
        f"(< {CNN_TOL}): "
        + ", ".join(f"{k} {v:.2e} ({len(CNN_MODELS[k])} maps)"
                    for k, v in worst.items())
        + f"; the resize ran on the card as {resize}")
    sims_img = {}
    for res in (112, 224):
        img = torch.from_numpy(VideoChunkStream(resolution=res).frame(0, 0)
                               [:, :, 0].copy())
        card = [P.downsample_similarity(img.cuda(), r)
                for r in (112, 56, 28, 14, 7)]
        host = [P.downsample_similarity(img, r) for r in (112, 56, 28, 14, 7)]
        merr = max(abs(a - b) for a, b in zip(card, host))
        assert merr < METRIC_TOL, (card, host)
        sims_img[res] = (card, merr)
    card = sims_img[112][0]                 # the reference test's frame
    assert all(a >= b - 0.02 for a, b in zip(card, card[1:])), card
    assert card[0] > 0.95 and card[-1] < card[0] - 0.2, card
    log("privacy phase 15b: downsample_similarity (ssim) at 112, 56, 28, "
        "14, 7 on the card: "
        + "; ".join(f"{r} x {r} frame {[round(s, 6) for s in c]} (card - "
                    f"CPU within {e:.1e})" for r, (c, e) in sims_img.items())
        + "; the reference test's asserts hold on the 112 frame")

    # 15c: the Fig. 12 claims through the port's planner
    t0 = time.perf_counter()
    sp, n_sims = {}, 0
    for name in CNN_MODELS:
        sp[name], plans = _fig12_speedups(name)
        for b in plans.values():
            sim = simulate_pipeline(b.stage_times, b.link_times, FIG12_N)
            cf = closed_form_completion(b.stage_times, b.link_times, FIG12_N)
            assert abs(sim.completion_time - cf) <= 1e-9 * cf, (name, b)
            assert abs(cf - b.t_chunk) <= 1e-9 * cf, (name, b)
            n_sims += 1
    plan_s = time.perf_counter() - t0
    for m in ("googlenet", "mobilenet", "squeezenet"):
        assert sp[m]["2tee"] > sp[m]["tee+gpu"], (m, sp[m])
        assert 1.5 < sp[m]["2tee"] < 2.1, (m, sp[m])
    assert sp["alexnet"]["tee+gpu"] > sp["alexnet"]["2tee"], sp["alexnet"]
    assert 2.2 <= sp["alexnet"]["tee+gpu"] <= 3.6, sp["alexnet"]
    for m, s in sp.items():
        assert s["proposed"] >= max(s["2tee"], s["tee+gpu"]) - 1e-9, (m, s)
    headline = max(s["proposed"] for s in sp.values())
    assert 3.5 < headline < 5.5, headline
    log("privacy phase 15c: Fig. 12 speedups over one TEE (the planner's "
        "calibrated TEE/GPU/WAN model, n = 10800; host planning "
        f"{plan_s:.2f} s): "
        + "; ".join(f"{m} " + ", ".join(f"{k} {v:.4f}" for k, v in s.items())
                    for m, s in sp.items())
        + f"; headline {headline:.4f} (claim: in (3.5, 5.5)); 2 TEEs beat "
        f"TEE+GPU for googlenet, mobilenet, squeezenet, TEE+GPU wins for "
        f"alexnet; simulate_pipeline = Eq. 1-2 = t_chunk on {n_sims} plans")
    log(f"privacy phase 15: wall {time.perf_counter() - t_phase:.1f} s "
        f"[{smi}]")
    return runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # deterministic cuBLAS for the train step, before cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.nn.functional as F

    from repro_torch.enclave import sealing
    from repro_torch.kernels import build, ops, ref

    smi = []
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible; "
        f"TF32 off (matmul allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn allow_tf32="
        f"{torch.backends.cudnn.allow_tf32})")

    # phase 1: build
    t0 = time.perf_counter()
    build.build_all(force=True)
    log(f"build: {len(build.SOURCES)} CUDA libraries in "
        f"{time.perf_counter() - t0:.1f} s ({build.BUILD_DIR})")
    for name in build.SOURCES:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    check_redesigned_build(build)

    # phase 2: kernels vs plain versions
    pa_err = check_paged_attention(torch, ops, ref)
    for cols in CIPHER_COLS.values():
        check_cipher(torch, ops, ref, sealing, cols=cols)
    q8_err = check_seal_q8(torch, ops, ref)
    check_captured_keys(torch, ops, ref, sealing)
    fa_err = check_flash_attention(torch, ops, ref)
    check_flash_train(torch, ops, ref)
    # phase 3: timings and bounds
    times = time_kernels(torch, ops, ref, sealing, F)
    # phase 4: whole serving path on a small input, card vs CPU, and at
    # head_dim 128, rep 3, greedy and sampled
    small_reference_check(torch)
    small_d128_check(torch)
    small_moe_check(torch)
    small_train_check(torch, ops)
    # phases 5 to 7: the main path at full width, local then pipelined,
    # then long prompts with chunked and packed prefill
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    api, params = serve.build_params(serve.build_parser().parse_args(
        FULL_WIDTH))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: llama3.2-1b full width, {api.cfg.num_layers} layers, "
        f"d_model {api.cfg.d_model}, vocab {api.cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    local = FULL_WIDTH + ["--backend", "local"]
    runs = [serve_full_width(torch, ops, api, params, local, 5)]
    runs += [serve_full_width(torch, ops, api, params,
                              FULL_WIDTH + ["--backend", "pipelined"], 6),
             serve_full_width(torch, ops, api, params, PREFILL_WIDE, 7)]
    # phase 8: phases 5, 7 and 6 again, on engines warmed up as CUDA graphs
    runs += [serve_in_graphs(torch, ops, api, params, local, 5, runs[0]),
             serve_in_graphs(torch, ops, api, params, PREFILL_WIDE, 7,
                             runs[2]),
             serve_in_graphs(torch, ops, api, params,
                             FULL_WIDTH + ["--backend", "pipelined"], 6,
                             runs[1])]
    # phase 9: phase 5's stream through the disaggregated pair, eager and
    # in CUDA graphs
    runs += serve_disagg(torch, ops, api, params, local + ["--disagg"],
                         runs[0], runs[3], smi[0] if smi else "unavailable")
    # phase 10: the fault plane and the recovery ladder, f32, local,
    # disaggregated and pipelined
    runs += serve_chaos(torch, ops, api, params,
                        smi[0] if smi else "unavailable")
    # phase 11: full-width llama3.2-3b sampled at temperature 0.8, top-k
    # 50: local eager and in graphs, and the disaggregated pair
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    runs += serve_sampled(torch, ops, smi[0] if smi else "unavailable")
    # phase 12: full-width qwen2-moe-a2.7b: local eager and in graphs, and
    # pipelined with sealed boundaries
    runs += serve_moe(torch, ops, smi[0] if smi else "unavailable")
    # phase 13: full-width llama3.2-1b training through the launcher
    runs.append(train_full_width(torch, ops,
                                 smi[0] if smi else "unavailable"))
    # phase 14: the timeline KV layout, per-token prefill and the int8
    # cache on full-width llama3.2-1b
    runs += serve_timeline(torch, ops, smi[0] if smi else "unavailable")
    # phase 15: the paper's planning and privacy path: the LM similarity
    # profile of full-width llama3.2-1b (flash a layer), TinyCNN and the
    # image metric, the Fig. 12 claims, the attestation stub
    runs += plan_privacy(torch, ops, smi[0] if smi else "unavailable")
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}

    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, source, replaces, err in (
            ("paged_attention", src + "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:33",
             pa_err["torch.bfloat16"]),
            ("seal_bits", src + "seal_bits.cu",
             "src/repro/kernels/seal.py:106", 0.0),
            ("unseal_bits", src + "seal_bits.cu",
             "src/repro/kernels/seal.py:106", 0.0),
            ("seal", src + "seal_q8.cu", "src/repro/kernels/seal.py:48",
             q8_err),
            ("unseal", src + "seal_q8.cu", "src/repro/kernels/seal.py:67",
             0.0),
            ("flash_attention", src + "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:28",
             fa_err["one-shot"])):
        # prefill attention: the one-shot shape's numbers in this line,
        # all three path shapes in the log above
        t = times[name] if name != "flash_attention" \
            else times[name]["one-shot"]
        assert launches[name] > 0, (name, launches)
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    log("nvidia-smi: " + (smi[0] if smi else "unavailable"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
