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
     warmup), then pipelined in CUDA graphs over two enclaves with two
     microbatches and sealed boundaries (blocks (4, 20), no re-plan, nm x
     (S - 1) seals a step); every swap-in bit-exact, every logit finite. Prints the
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
     pipelined in CUDA graphs at blocks (1, 15) with sealed boundaries
     (seal and unseal nm x (S - 1) a step) and paged with per-token prefill in graphs, then
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
     profile, the plans, the speedups and the phase's wall time;
 16. three more model families and glm4-9b, each at its published width
     and the depth ``DEPTH`` gives it: first the kernels at their
     new shapes against their plain versions, timed (flash at qwen2-vl's
     prefill, 28 heads over 4 at D=128, at hymba's, 25 over 5 at D=64
     with its 2048-token window biting at S=4096, at moonshot's, and at
     phase 24's head shards; paged at qwen2-vl's decode, rep 7); (a)
     qwen2-vl-7b (``VlmLM``: M-RoPE,
     patch embeddings), reduced f32 card against CPU, then full width:
     prefill of 2 x (1024 patches + 128 tokens), prefill S+1 against
     decode one, 16 greedy steps on the timeline and on pages held
     against each other, the runtime pipelined decoder unsealed and
     sealed; (b) hymba-1.5b (attention + selective SSM), reduced through
     the engine card against CPU (local, pipelined, sealed and unsealed),
     then full width: prefill of 4096 tokens, the rolling window's
     eviction, prefill S+1 against decode one, and 3 requests on the
     timeline local eager, in CUDA graphs, pipelined unsealed (= local)
     and sealed; (d) glm4-9b served at full width on the paged local
     engine, eager and in CUDA graphs (rep 16); (c) moonshot-v1-16b-a3b
     at full width (52.9 GiB of bf16 weights drawn on the card; a dense
     stem segment, then 47 MoE blocks): prefill, prefill S+1 against
     decode one, 8 greedy steps on each layout held against each other,
     the engine's refusal by name, peak memory; (the kernel checks also
     hold flash at whisper-small's three shapes: its encoder, B=2 over
     1500 frames, and its cross-attention, 224 queries over 1500 keys,
     both non-causal, and its causal decoder self-attention at 224);
 17. the last two families: (a) xlstm-125m, first reduced in f32, card
     against CPU (every path, the engine's streams local and pipelined,
     sealed and unsealed), then at full width (2 of its 6 sLSTM/mLSTM
     pairs, recurrent state, no attention): prefill of 2 x 1024 tokens,
     prefill S+1 against decode one (bf16 printed; f32 on the reference's init
     printed at S = 8 to 1024 beside an embedding nudge's effect, since
     that init amplifies rounding to order one; f32 on the weights
     rescaled to their contraction's fan-in held within 1e-3), block 0's
     sLSTM scan against its steps and mLSTM chunks against steps held
     tightly, the sealed pipelined step against the plain int8 round trip
     at its boundary, the bf16 state of ``cache_quant`` against the f32
     state over 16 steps (top-1 agreement printed), then phase 5's first
     4 requests on the timeline: local eager, in CUDA graphs, pipelined
     over 2 stages in graphs unsealed (all three streams equal) and
     sealed (seal = unseal = one a step);
     (b) whisper-small, first reduced in f32, card against CPU, then at
     full width (12 + 12 blocks) in bf16 and f32: encode, prefill of
     2 x 224 tokens over 1500 frames (36 flash launches), 16 decode steps
     on a grown cache, prefill S+1 against decode one (printed; f32 held
     within 1e-3 on the rescaled weights), decoder block 0 alone held
     tightly; prints encoder, prefill and decode-step ms;
 18. the mesh, the sharding trees, the serve steps, the calibration and
     the dry-run on full-width llama3.2-1b in bf16: (a) ``make_mesh((1,
     1), ("data", "model"))`` is a real one-rank ``DeviceMesh`` on the
     card, every param, cache and batch leaf resolves to replicated and
     the per-device argument bytes equal the total; (b) ``make_prefill_step``
     on 8 x 512 tokens (16 flash launches) and ``make_decode_step`` for 16
     greedy steps, logits and caches bit-equal to ``prefill_fn`` /
     ``decode_fn`` on a copy, host ms per prefill and decode step; (c) the
     decode step at batch 1 counted on meta tensors, ``hlo_calibration``
     equal to the CPU's (eff, act_scale), the same step counted on the
     card's tensors equal, and the engine's plan with and without the
     calibration; (d) ``dryrun.main`` over every llama3.2-1b cell on the
     logical 16 x 16 mesh, rc 0;
 19. the pod axis over ranks: processes spawned on the card, joined by
     gloo (NCCL refuses two ranks on one device), the parent's models
     freed first: (a) full-width llama3.2-1b in bf16 at 4 of its 16
     layers, 8 slots, 4 microbatches, paged, sealed, 8 greedy decode
     steps with stage s on rank s at blocks (2, 2) and (1, 3): logits and
     tokens bit-equal to the one-card sealed ``PipelinedDecoder``, seal
     launches on stage 0 and unseal launches on stage 1 each 4 x 8, paged
     launches the stage's layers x 4 x 8, host ms a step, sealed bytes a
     boundary and one boundary crossing's host ms; (b) the compressed
     train step of full-width llama3.2-1b at 4 layers, pods 2 x data 1,
     batch 8 x 128, 3 steps: finite losses, both ranks' params the same
     bits after every step, the error feedback finite and nonzero, 2 x 4
     x 3 flash launches a rank, int8 bytes exchanged a step against
     f32's, host ms a step, each rank's peak memory; (c) reduced
     llama3.2-1b in f32 on (2, 2) ranks, plain and compressed, the card
     against the CPU;
 20. the serving engine over pod ranks (``ServingEngine(mesh=)``): phase
     6's stream on two ranks spawned on the card over gloo, each holding
     its stage's layers of params and pools: (a) sealed, streams bit-equal
     to phase 6's, swap-outs with every swap-in restored bit-exactly,
     launches per rank as its layers say; (b) unsealed, with and without
     ``--inject-straggler 1:10``, on the stream's first 8 requests: a
     swap migrates layers between the ranks, the streams stay; (c) the ranks' first swap-out parts side by
     side are phase 6's payload with its digest; (d) no (key, counter)
     pair ciphers twice; host ms a decode step, admission, a prefill
     crossing, a restage, swap-out and swap-in;
 21. the data axis over ranks, a 2 x 2 pod x data mesh of four gloo ranks
     on the card in one spawn (the reference's engine layout): one stage's
     decode step at 4 rows held against its 2-row halves first; (a) phase
     6's stream sealed through ``ServingEngine(mesh=)``, 2 rows a data rank
     a microbatch: streams equal phase 6's (or, if the 2-row products
     differ, each data rank's first step equal to the one-card 2-row run),
     swap-ins bit-exact on every rank, the data ranks of each pod with
     equal cache digests, no (key, counter) pair twice over the four
     ranks, launches per rank as its layers and data index say; (b) the
     prefill and decode serve steps over the same ranks at phase 18's
     prefill shape (1 decode step), each rank holding its blocks of the
     params over data (the reference's FSDP), bit-equal to the one-card
     step on its rows; host ms a decode step, admission, the KV
     exchange's bytes and host ms, a crossing, swap-out and swap-in, the
     serve steps and their gather bytes;
 22. warmup over ranks (phase 21's stream as CUDA graphs on the 2 x 2
     ranks); 23. the disaggregated pair over the same ranks;
 24. the model axis over ranks (tensor parallelism of the serve steps):
     one spawn of four gloo ranks on the card, a (1, 4) ("data", "model")
     mesh, each rank drawing only its shard of seeded weights, 8 x 128
     prefill tokens and 4 greedy decode steps, after the port's one-card
     steps on the same draw: (a) glm4-9b at full width, 4 layers, f32 and
     (c) qwen2-moe-a2.7b at full width, 4 layers, f32 (15 experts a
     rank), each within 1e-3 of the one-card logits, greedy tokens equal;
     (b) glm4-9b at full width and 10 of its 40 layers in bf16, its
     error, host ms, bytes messaged a step, param bytes against the shard
     shapes, peak memory and 10 flash launches a prefill a rank printed;
     the whole logits the same bits on every rank;
 25. the train step over ranks with the reference's layout (tensor
     parallelism's backward, every leaf with an embed dim split over data
     too, its AdamW state with it): four gloo ranks on the card, each
     drawing only its blocks of seeded weights (``rank_jobs.train``): (a)
     full-width llama3.2-1b at full depth in bf16 on a (2, 2) ("data",
     "model") mesh, phase 13's batch (8 x 128), stream, seed and
     schedule, 2 steps: finite losses that fall, param and AdamW shapes
     (and param bytes) the whole mesh's ``param_shardings`` blocks, each
     rank's data blocks gathered equal to its model index's shard of the
     draw, the data ranks holding different blocks and each block the
     same bits wherever it is held after every step, 2 x 16 x 2 flash
     launches a rank, peak memory a rank under the whole-over-data
     layout's 16.38 GiB; each
     step's loss and grad norm printed beside phase 13's, host ms a step,
     bytes a step (gathers, reduce-scatters, model-axis collectives, the
     rest) a rank; (b) f32 at 2 layers on (1, 4): glm4-9b (two KV heads
     whole over 4) and qwen2-moe-a2.7b (15 experts a rank); (c)
     qwen2-moe-a2.7b f32 at 1 layer on (2, 2), router, experts and
     shared experts over data, its MoE routing over the whole batch's
     rows; (b) and (c) on the seeded draw's block weights rescaled to
     their contractions (the reference's init amplifies f32 rounding to
     order one in the gradient at full width), one step each at index 0
     against the one-card step on the same weights: loss within 1e-5,
     grad norm within 1e-4, each rank's gradient blocks (AdamW's first
     moment) within 1e-4 of each leaf's largest, errors printed. Phase 2
     holds ``FlashAttentionFn`` and flash at 25a's and 25c's shards, and
     phase 16 times flash at both;
 26. the residual stream's sequence split over the model axis
     (``SP_ACT_RULES``, Megatron-SP: between blocks each model rank holds
     its block of the sequence), one spawn of four gloo ranks on the
     card: (a) 25a under it, losses and grad norms printed beside 25a's,
     step 0's loss 25a's bits and its grad norm within 1e-5 of 25a's,
     each block the same bits wherever it is held, 2 x 16 x 2 flash
     launches a rank, bytes a step of the sequence's gathers, its
     reduce-scatters and the norms' model sum, the saved block inputs
     reckoned, peak memory beside 25a's; (b) 25b's two cases under it
     against the same one-card steps, gradients within 1e-5 of each
     leaf's largest; (c) glm4-9b f32 at 4 layers on (1, 4): the
     SP prefill step within 1e-3 of phase 24's one-card step with equal
     greedy tokens, each decode step the same bits as the plain decode
     step on the same cache.
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


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on its own line behind the seconds since the script
    started, so each phase's share of the time limit shows."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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
# a rank's shard over a model axis (phase 27): glm4-9b's 8 query heads a
# rank of 4 read KV head 1 of its 2, whole on every rank, in place
# (kv_head0 = 1, the rank's rep 8; the query heads of rank 2); llama3.2-1b's
# 16 query heads a rank of 2 over its 4 KV heads (the plain launch)
PAGED_RANK = {"glm4 rank kv_head0": dict(KVH=2, rep=16, D=128, MP=10, N=30,
                                         heads=(16, 24), kv0=1),
              "llama rank": dict(KVH=4, rep=4, D=64, MP=10, N=30)}
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


def paged_rank_inputs(torch, dtype, shape):
    """``paged_inputs`` at a ``PAGED_RANK`` shape: (q, pools, tables,
    seq_lens, the launch's kv_head0 / rep keywords); q holds the rank's
    query heads ``heads`` of the whole model's where it reads KV heads
    from ``kv0`` of pools that hold them all."""
    shape = dict(shape)
    heads, kv0 = shape.pop("heads", None), shape.pop("kv0", None)
    q, k, v, bt, sl = paged_inputs(torch, dtype, **shape)
    if heads is None:
        return q, k, v, bt, sl, {}
    q = q[:, heads[0]:heads[1]].contiguous()
    return q, k, v, bt, sl, dict(kv_head0=kv0, rep=heads[1] - heads[0])


def check_paged_rank(torch, ops, ref):
    """The paged kernel at a model-axis rank's shapes (``PAGED_RANK``):
    against the plain version with the same ``kv_head0`` and rep, and that
    against the plain version on the pool cut to those heads, bf16 and
    f32 at ``check_paged_attention``'s tolerances; a repeat bit-equal.
    Returns the largest bf16 error."""
    worst = 0.0
    for dtype, tol in ((torch.bfloat16, dict(atol=1e-3, rtol=1e-2)),
                       (torch.float32, dict(atol=3e-5, rtol=3e-5))):
        for name, shape in PAGED_RANK.items():
            q, k, v, bt, sl, kw = paged_rank_inputs(torch, dtype, shape)
            got = ops.paged_attention(q, k, v, bt, sl, **kw)
            again = ops.paged_attention(q, k, v, bt, sl, **kw)
            want = ref.paged_attention_ref(q, k, v, bt, sl, **kw)
            if kw:
                g = q.shape[1] // kw["rep"]
                cut = [t[:, kw["kv_head0"]:kw["kv_head0"] + g].contiguous()
                       for t in (k, v)]
                assert torch.equal(want, ref.paged_attention_ref(
                    q, *cut, bt, sl)), name
            torch.cuda.synchronize()
            live = sl > 0
            assert torch.equal(got, again), "repeated call not bit-equal"
            assert not got[~live].float().any(), "idle rows must be zero"
            err = (got[live].float() - want[live].float()).abs().max().item()
            torch.testing.assert_close(got[live].float(), want[live].float(),
                                       **tol)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            log(f"check paged_attention {dtype} {name} (H={q.shape[1]}, "
                f"pools KVH={k.shape[1]}, {kw or 'plain launch'}, "
                f"D={q.shape[2]}): max_abs_err={err:.3e} ({tol}), plain "
                f"with kv_head0 = plain on the cut pool, repeat bit-equal")
    return worst


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


# a pipeline rank's window of llama3.2-1b's swap row at stage (1, 15): its
# layers' columns of [pages_per_slot, 16 x 8 x 16 x 64]
WINDOW_LAYER = 8 * 16 * 64
WINDOW_STAGES = ((0, 1), (1, 16))


def check_cipher_window(torch, ops, ref, sealing, MP=10):
    """Page cipher over a window of a row (a rank's layers of a swap row)
    against its plain version: bit-exact cipher at each stage's window,
    equal to those columns of the whole row's cipher, and a bit-exact
    round trip; also a window one element past a 16-byte boundary (the
    scalar path)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    row = 16 * WINDOW_LAYER
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(MP, row, generator=g, device="cuda").to(dtype)
        idt = torch.int32 if dtype == torch.float32 else torch.int16
        ctr = sealing._swap_counter(11, 1)
        whole = ops.seal_bits(x, 0xC0FFEE, ctr)
        for lo, hi in WINDOW_STAGES:
            part = x[:, lo * WINDOW_LAYER:hi * WINDOW_LAYER].contiguous()
            args = (0xC0FFEE, ctr, lo * WINDOW_LAYER, row)
            ck = ops.seal_bits(part, *args)
            assert torch.equal(ck, ref.seal_bits_ref(part, *args)), \
                f"seal_bits window {dtype} {lo, hi}: differs from ref"
            assert torch.equal(
                ck, whole[:, lo * WINDOW_LAYER:hi * WINDOW_LAYER]), \
                "a window's cipher is not the whole row's columns"
            back = ops.unseal_bits(ck, 0xC0FFEE, ctr, dtype,
                                   lo * WINDOW_LAYER, row)
            assert torch.equal(back.view(idt), part.view(idt))
        odd = torch.empty(MP * WINDOW_LAYER + 1, dtype=dtype,
                          device="cuda")[1:].view(MP, WINDOW_LAYER)
        odd.copy_(x[:, :WINDOW_LAYER])
        args = (0xC0FFEE, ctr, 3 * WINDOW_LAYER, row)
        assert torch.equal(ops.seal_bits(odd, *args),
                           ref.seal_bits_ref(odd, *args))
        log(f"check seal_bits/unseal_bits window {dtype}: stages "
            f"{WINDOW_STAGES} of [{MP}, {row}] bit-exact, each the whole "
            f"row's columns, and an unaligned window")


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
# phase 25a's training shard over (2, 2) data x model ranks
FLASH_TRAIN_SHARD = (4, 128, 128, 16, 4, 64, 1, 0, 0)
# phase 25c's: qwen2-moe-a2.7b's 4 rows a data rank, 8 heads over 8 a
# model rank (f32 there)
FLASH_MOE_SHARD = (4, 128, 128, 8, 8, 128, 1, 0, 0)
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
       (1, 128, 128, 16, 16, 128, 1, 0, 0)]
    # phase 17's whisper-small: its encoder and cross-attention over 1500
    # frames (non-causal, a 28-key tail) and its causal decoder
    + [(2, 1500, 1500, 12, 12, 64, 0, 0, 0),
       (2, 224, 1500, 12, 12, 64, 0, 0, 0),
       (2, 224, 224, 12, 12, 64, 1, 0, 0)]
    # phase 24's head shards over a model axis of 4: glm4-9b's 8 query
    # heads of one KV head (rep 16 kept), qwen2-moe-a2.7b's 4 over 4
    + [(8, 128, 128, 8, 1, 128, 1, 0, 0), (8, 128, 128, 4, 4, 128, 1, 0, 0)]
    # phase 25a's shard: llama3.2-1b's 4 rows a data rank, 16 heads over 4
    # a model rank; phase 25c's
    + [FLASH_TRAIN_SHARD, FLASH_MOE_SHARD])
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
    32 heads over 8, D=64) and phase 25a's shard of it (B=4, 16 heads over
    4): ``ops.flash_attention`` refuses CUDA inputs
    that require grad while autograd records (its output has no graph);
    ``FlashAttentionFn`` gives the kernel's output bit for bit, and its
    plain backward's dq, dk, dv agree with autograd through the plain
    forward: f32 within 1e-4 of the largest gradient (the kernel's output,
    within 3e-5, enters delta = rowsum(dO·O)), bf16 within 1.6e-2 of it
    (two bf16 steps: the kernel's bf16 output may sit one step from the
    plain one's). A second backward gives the same bits."""
    for case, dtype, rel in (
            (c, d, r) for c in (FLASH_PATH["train"], FLASH_TRAIN_SHARD)
            for d, r in ((torch.float32, 1e-4), (torch.bfloat16, 1.6e-2))):
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
        log(f"check flash_attention under autograd {dtype} B={case[0]} "
            f"S={case[1]} H={case[3]} KVH={case[4]} D={case[5]}: refused "
            f"outside FlashAttentionFn, forward = "
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


def time_flash_case(torch, ops, ref, F, name, case):
    """ms of the prefill kernel, its plain version and SDPA at one shape
    in bf16, eagerly and in a graph, with the bound."""
    B, Sq, Sk, H, KVH, D, causal, window, off = case
    causal = bool(causal)
    q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=5)

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=off)

    ms = time_ms(kernel)
    in_graph = graph_ms(kernel)
    plain = time_ms(lambda: flash_plain(ref, q, k, v, causal=causal,
                                        window=window, q_offset=off), 20)
    # library yardstick: SDPA with heads ahead and KV heads repeated
    # beforehand (not timed); is_causal aligns top-left, so the offset and
    # windowed cases take an explicit mask; non-causal takes none
    qh = q.transpose(1, 2).contiguous()
    kh = k.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(H // KVH, 2).transpose(1, 2).contiguous()
    if not causal and not window:
        lib = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    elif off == 0 and Sq == Sk and not window:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
    else:
        kp = torch.arange(Sk, device="cuda")[None, :]
        qp = off + torch.arange(Sq, device="cuda")[:, None]
        mask = kp <= qp if causal else torch.ones_like(kp <= qp)
        if window:
            mask &= kp > qp - window
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask))
    esz = q.element_size()
    nbytes = esz * (2 * q.numel() + k.numel() + v.numel())
    flops = 4.0 * B * H * D * visible_keys(torch, case)
    b_ms, b_by = bound(nbytes, flops, BF16_TC_FLOP_PER_S)
    log(f"time flash_attention {name} bf16 B={B} Sq={Sq} Sk={Sk} H={H} "
        f"KVH={KVH} D={D} q_offset={off}{'' if causal else ' non-causal'}"
        f"{f' window={window}' if window else ''}: kernel "
        f"{ms * 1e3:.2f} us, in a graph {in_graph * 1e3:.2f} us, plain "
        f"{plain * 1e3:.1f} us, sdpa {lib * 1e3:.1f} us, bound "
        f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, flops=flops, graph_ms=in_graph)


def time_flash(torch, ops, ref, F):
    """``time_flash_case`` at the three path shapes and phases 11's and
    12's head_dim-128 one-shot shapes."""
    return {name: time_flash_case(torch, ops, ref, F, name, case)
            for name, case in {**FLASH_PATH, **FLASH_D128}.items()}


def time_paged(torch, ops, ref, F, shape, inputs=None, kw=None):
    """ms of the paged decode kernel, its plain version and SDPA over K/V
    gathered beforehand, in bf16, with the bound, at ``paged_inputs``'s
    ``shape`` or on the given ``inputs``; ``kw`` a rank's ``kv_head0`` /
    ``rep`` launch (the bytes and SDPA then count the KV heads it
    reads)."""
    q, k, v, bt, sl = inputs or paged_inputs(torch, torch.bfloat16, **shape)
    kw = kw or {}
    B, H, D = q.shape
    N, KVH, Pg, _ = k.shape
    MP = bt.shape[1]
    ms = time_ms(lambda: ops.paged_attention(q, k, v, bt, sl, **kw))
    in_graph = graph_ms(lambda: ops.paged_attention(q, k, v, bt, sl, **kw))
    plain = time_ms(lambda: ref.paged_attention_ref(q, k, v, bt, sl, **kw),
                    20)
    if kw:                                # the KV heads the launch reads
        KVH = H // kw["rep"]
        k = k[:, kw["kv_head0"]:kw["kv_head0"] + KVH]
        v = v[:, kw["kv_head0"]:kw["kv_head0"] + KVH]
    rep = H // KVH
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
        f"MP={MP} N={N}{' ' + str(kw) if kw else ''}: kernel "
        f"{ms * 1e3:.2f} us, in a graph "
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
    for name, shape in PAGED_RANK.items():
        q, k, v, bt, sl, kw = paged_rank_inputs(torch, torch.bfloat16, shape)
        out[f"paged_attention {name}"] = time_paged(
            torch, ops, ref, F, None, (q, k, v, bt, sl), kw)

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

    # the windowed cipher at stage (1, 15)'s rank 1: [10, 15 layers] of
    # llama3.2-1b's swap row
    lo, hi = WINDOW_STAGES[1]
    row = 16 * WINDOW_LAYER
    x = torch.randn(10, (hi - lo) * WINDOW_LAYER, generator=g,
                    device="cuda").to(torch.bfloat16)
    kt = torch.tensor([0xC0FFEE], device="cuda")
    ctr = torch.tensor([sealing._swap_counter(3, 0)], device="cuda")
    win = (lo * WINDOW_LAYER, row)
    c = ops.seal_bits(x, kt, ctr, *win)
    ks = ref.seal_bits_ref(torch.zeros_like(x), kt, ctr, *win)
    xi = x.view(torch.int16)
    nbytes = 2.0 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, KEYSTREAM_OPS * x.numel(), INT32_OP_PER_S)
    lib = time_ms(lambda: torch.bitwise_xor(xi, ks))
    for name, fn, plain_fn in (
            ("seal_bits_window", lambda: ops.seal_bits(x, kt, ctr, *win),
             lambda: ref.seal_bits_ref(x, kt, ctr, *win)),
            ("unseal_bits_window",
             lambda: ops.unseal_bits(c, kt, ctr, torch.bfloat16, *win),
             lambda: ref.unseal_bits_ref(c, kt, ctr, torch.bfloat16,
                                         *win))):
        ms = time_ms(fn)
        in_graph = graph_ms(fn)
        plain = time_ms(plain_fn, 20)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         graph_ms=in_graph)
        log(f"time {name} bf16 [10, {x.shape[1]}] (rank 1's window of "
            f"llama3.2-1b's row at stage (1, 15), from column {win[0]} of "
            f"{row}): kernel {ms * 1e3:.2f} us, in a graph "
            f"{in_graph * 1e3:.2f} us, plain {plain * 1e3:.1f} us, xor "
            f"{lib * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us ({b_by}, "
            f"{nbytes / 1e6:.2f} MB)")

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
                reqs = serve.serve_stream_orch(
                    orch, serve.stream_of(args, prompts), args.arrival_every)
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
    gathered, restored, first_swap = {}, [], {}
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    probe_layers = [0]
    orig_gather, orig_scatter, orig_step = (be.gather_pages,
                                            be.scatter_pages, be.step)

    def gather(pages, key, ctr):
        from repro_torch.enclave import sealing
        pg = torch.from_numpy(pages.astype("int64")).cuda()
        gathered[ctr] = [pool[:, pg].clone() for pool in be.cache["blocks"]]
        out = orig_gather(pages, key, ctr)
        if not first_swap:          # phase 20 holds the ranks' parts to it
            first_swap.update(counter=ctr, payload=tuple(
                sealing.cipher_to_host(c) for c in out))
        return out

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
                first_swap=first_swap,
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
                reqs = serve.serve_stream_orch(
                    orch, serve.stream_of(args, prompts), args.arrival_every)
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
            fb_reqs = serve.serve_stream_orch(
                fb, serve.stream_of(args, prompts), args.arrival_every)
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
                        export_ms=exp[len(exp) // 2],
                        transfer_in_ms=tin[len(tin) // 2],
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
        runs[name] = _chaos_run(torch, ops, build, lambda orch: (
            serve.serve_stream_orch(orch, serve.stream_of(args, prompts),
                                    args.arrival_every)))
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
    graphs; (c) pipelined in CUDA graphs over two enclaves with two
    microbatches and sealed boundaries. (a)'s second run and (b) must give
    (a)'s
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
    # in graphs: eager, the pipelined engine took about 30 s of the
    # script's time (phase 6 and 10c run pipelined eager)
    c = serve_full_width(torch, ops, api, params, FULL_MOE + [
        "--backend", "pipelined", "--stages", "2", "--microbatches", "2",
        "--warmup"], "12c", plan=(4, 20))
    for name, r in (("12a eager", a), ("12a eager, second run", again),
                    ("12b CUDA graphs", b),
                    ("12c pipelined (4, 20), CUDA graphs", c)):
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
    return {"launches": launches, "losses": losses, "gnorms": gnorms}


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
    bad = torch.zeros((), dtype=torch.int64, device=api.device)
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
    SEGMENT = "blocks"                  # llama's served segment
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
    # in graphs: eager, the stream's 746 per-token prefill steps through
    # two stages take about 26 s of the script's time (phase 16b runs the
    # pipelined timeline eager)
    pipe = serve_layout(torch, ops, api, params,
                        tl + ["--backend", "pipelined", "--stages", "2",
                              "--microbatches", "2", "--warmup"],
                        "14b pipelined, sealed, CUDA graphs")
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
        f"graphs {graphs['step_ms']:.2f}, pipelined graphs "
        f"{pipe['step_ms']:.2f}, "
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
    if isinstance(tree, (dict, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
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



# ---------------------------------------------------------------------------
# phase 16: three more families at full width (qwen2-vl-7b, hymba-1.5b,
# moonshot-v1-16b-a3b) and glm4-9b served. Device, configs and sizes are
# names here so that a CPU rehearsal can run the same code at reduced width.
DEV = "cuda"
FAMILY_ARCH = None          # None: the full configs; a callable maps them
# prefill attention at the three families' prefill shapes: B, Sq, Sk, H,
# KVH, D, causal, window, q_offset
FLASH_FAMILIES = {
    # 16a: qwen2-vl-7b, 1024 patches + 128 text tokens, 28 heads over 4
    "vlm d128 rep7": (2, 1152, 1152, 28, 4, 128, 1, 0, 0),
    # 16b: hymba-1.5b, 25 heads over 5, its 2048-token window biting
    "hymba d64 rep5 window": (1, 4096, 4096, 25, 5, 64, 1, 2048, 0),
    # 16c: moonshot-v1-16b-a3b, 16 heads over 16 behind the dense stem
    "moonshot d128 rep1": (2, 256, 256, 16, 16, 128, 1, 0, 0),
    # 17b: whisper-small, 12 heads over 12: the encoder over 1500 frames
    # and the cross-attention of 224 decoder tokens over them, both
    # non-causal (a 28-key tail past 23 tiles of 64), and the decoder's
    # causal self-attention
    "whisper encoder": (2, 1500, 1500, 12, 12, 64, 0, 0, 0),
    "whisper cross": (2, 224, 1500, 12, 12, 64, 0, 0, 0),
    "whisper decoder": (2, 224, 224, 12, 12, 64, 1, 0, 0),
    # 24: a rank's head shard over a model axis of 4 at the 8 x 128
    # prefill: glm4-9b's 8 query heads on their one KV head, qwen2-moe's 4
    # over 4
    "glm4 head shard": (8, 128, 128, 8, 1, 128, 1, 0, 0),
    "qwen2-moe head shard": (8, 128, 128, 4, 4, 128, 1, 0, 0),
    # 25a: llama3.2-1b's training shard on (2, 2) data x model; 25c:
    # qwen2-moe-a2.7b's
    "llama train shard": FLASH_TRAIN_SHARD,
    "qwen2-moe train shard": FLASH_MOE_SHARD}
# paged attention at 16a's decode: 2 rows of 1152..1167 tokens over tables
# of 73 pages of 16 (their own pages), 28 heads over 4 KV heads (rep 7)
PAGED_VLM = dict(B=2, KVH=4, rep=7, D=128, Pg=16, lens=(1160, 1167), MP=73)
VLM_TEXT, VLM_B, VLM_STEPS, VLM_PIPE_STEPS = 128, 2, 16, 8
HYMBA_S, HYMBA_EVICT_S = 4096, 2048
MOON_B, MOON_S, MOON_STEPS = 2, 256, 8
PAGE = 16
# the reduced configs card against CPU, f32 on both (TF32 off)
F32_LOGIT_TOL = 1e-4
# f32 paths held against each other at full width (sums in other orders
# over 28-48 layers; an error of the port would show as order one)
F32_FULL_TOL = 1e-3
# 16b: 3 requests of 2-48 tokens, 16 new each, on 4 timeline slots (the
# stream trimmed from 6 to keep the whole script's time); the
# pipelined runs take one microbatch, so their GEMMs have the local run's
# shapes and the unsealed run's arithmetic is the local run's
HYMBA_SERVE = ["--arch", "hymba-1.5b", "--device", "cuda", "--slots", "4",
               "--requests", "3", "--prompt-len", "48", "--max-new", "16",
               "--telemetry-interval", "1000"]
# the reduced config's engine runs, card against CPU, at 2 of its 4 layers
# (one a stage when pipelined; the script's time)
HYMBA_REDUCED_LAYERS = 2
HYMBA_REDUCED = ["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
                 "--slots", "4", "--requests", "6", "--prompt-len", "40",
                 "--max-new", "8", "--f32", "--telemetry-interval", "1000"]
# 16d: phase 5's flags, 6 requests, glm4-9b
GLM4_SERVE = ["--arch", "glm4-9b", "--device", "cuda", "--slots", "8",
              "--requests", "6", "--prompt-len", "128", "--max-new", "32",
              "--page-size", "16", "--num-pages", "30",
              "--shared-system-prompt", "0.75"]


# phases 16-17: the depth each full-width family runs at (widths whole),
# cut to keep the whole script inside its time with phase 24 added:
# qwen2-vl-7b 28 -> 4 layers, hymba-1.5b 32 -> 4, glm4-9b 40 -> 10 (16d;
# phase 24 serves it at full depth), xlstm-125m 12 blocks (6 pairs) -> 4
# (2 pairs)
DEPTH = {"qwen2-vl-7b": 4, "hymba-1.5b": 4, "glm4-9b": 10, "xlstm-125m": 4}


def _family_cfg(name):
    """``name``'s config (FAMILY_ARCH's map of it in a rehearsal) at its
    phase's depth (``DEPTH``)."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    cfg = FAMILY_ARCH(cfg) if FAMILY_ARCH else cfg
    if name in DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=min(DEPTH[name],
                                                      cfg.num_layers))
    return cfg


def _build_params(torch, argv):
    """``serve.build_params`` of ``argv`` on ``_family_cfg``'s config of
    its ``--arch`` (its phase's depth; ``--reduced`` maps it in a
    rehearsal, where FAMILY_ARCH is set too)."""
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    args = serve.build_parser().parse_args(argv)
    api = build_model(_family_cfg(args.arch), device=args.device,
                      dtype=torch.float32 if args.f32 else torch.bfloat16)
    return api, api.init(torch.Generator(device=args.device).manual_seed(
        args.seed))


def _sync(torch):
    if DEV == "cuda":
        torch.cuda.synchronize()


def _mem(torch) -> str:
    if DEV != "cuda":
        return "memory not measured (CPU)"
    return (f"memory allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB, peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB, reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")


def _free(torch):
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def served_paged_inputs(torch, dtype, B, KVH, rep, D, Pg, lens, MP, seed=3):
    """Paged-attention inputs as a served decode lays them out: each row on
    its own pages (1 + b * MP onwards), tables of MP pages, page 0 null."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    N = 1 + B * MP
    q = torch.randn(B, KVH * rep, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(N, KVH, Pg, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(N, KVH, Pg, D, generator=g, device="cuda").to(dtype)
    k[0] = 0
    v[0] = 0
    bt = (1 + torch.arange(B * MP, device="cuda", dtype=torch.int32)
          ).reshape(B, MP)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, k, v, bt, sl


def check_family_kernels(torch, ops, ref, F):
    """Phase 16's kernel shapes, each against its plain version on the
    card (bf16 within atol 1e-3 + rtol 1e-2, phase 2's tolerance) and
    timed as phase 3 times: flash at qwen2-vl-7b's prefill (rep 7),
    hymba-1.5b's (rep 5, window 2048 of 4096: the windowed kernel and the
    full-causal one each match their plain version, and the two plain
    versions differ beyond that tolerance on the queries past the window,
    so the window bites), moonshot's (rep 1) and phase 17's whisper-small
    (its encoder over 1500 frames and its cross-attention of 224 queries
    over them, both non-causal, and its decoder's causal self-attention);
    paged at qwen2-vl's decode (rep 7, 73-page tables, each row on its own
    pages). A repeat call gives the same bits. These launches are checks,
    outside every counted run. Returns the timings."""
    tol = dict(atol=1e-3, rtol=1e-2)
    out = {}
    for name, case in FLASH_FAMILIES.items():
        causal, window, off = bool(case[6]), case[7], case[8]
        q, k, v = flash_inputs(torch, case, torch.bfloat16)
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=off)
        again = ops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=off)
        want = flash_plain(ref, q, k, v, causal, window, off)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{name}: repeat not bit-equal"
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"{name}: {m}")
        note = ""
        if window:
            full = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
            full_want = flash_plain(ref, q, k, v, causal, 0, off)
            torch.testing.assert_close(full.float(), full_want.float(),
                                       **tol)
            late, early = slice(window, None), slice(0, window)
            bite = (full_want[:, late].float()
                    - want[:, late].float()).abs().max().item()
            assert not torch.allclose(full_want[:, late].float(),
                                      want[:, late].float(), **tol), \
                f"{name}: the window does not bite"
            torch.testing.assert_close(full[:, early].float(),
                                       got[:, early].float(), **tol)
            note = (f"; the window bites: queries {window}.. differ from "
                    f"full causal by up to {bite:.4f}, earlier ones agree")
            del full, full_want
        log(f"check flash_attention bf16 {name} (B={case[0]}, Sq={case[1]}, "
            f"Sk={case[2]}, H={case[3]}, KVH={case[4]}, D={case[5]}, "
            f"causal={causal}, window={window}): "
            f"max_abs_err={err:.3e} ({tol}), repeat bit-equal{note}")
        del q, k, v, got, again, want
        torch.cuda.empty_cache()
        out[f"flash {name}"] = dict(
            time_flash_case(torch, ops, ref, F, name, case),
            max_abs_err=err)
    inputs = served_paged_inputs(torch, torch.bfloat16, **PAGED_VLM)
    q, k, v, bt, sl = inputs
    got = ops.paged_attention(q, k, v, bt, sl)
    again = ops.paged_attention(q, k, v, bt, sl)
    want = ref.paged_attention_ref(q, k, v, bt, sl)
    torch.cuda.synchronize()
    assert torch.equal(got, again), "paged rep 7: repeat not bit-equal"
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    log(f"check paged_attention bf16 vlm d128 rep7 ({PAGED_VLM}): "
        f"max_abs_err={err:.3e} ({tol}), repeat bit-equal")
    out["paged vlm d128 rep7"] = dict(
        time_paged(torch, ops, ref, F, None, inputs=inputs),
        max_abs_err=err)
    return out


def _grow(torch, body, extra):
    """A prefill's timeline cache tree with ``extra`` more zero positions
    on every [L, B, KVH, S, D] leaf (new tensors: the prefill's stay)."""
    if isinstance(body, tuple):
        return tuple(_grow(torch, t, extra) for t in body)
    return torch.nn.functional.pad(body, (0, 0, 0, extra))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(t) for t in tree)
    return tree.clone()


def _paged_from(torch, api, caches, S, steps):
    """A paged cache holding a prefill's K/V (every segment's (k, v)
    [L, B, KVH, S, D], S a multiple of the page size): row b on pages
    1 + b * MP onwards, tables of MP pages for S + steps tokens, seq_lens
    S, page 0 null."""
    B = caches[api.model.segments[0].name][0].shape[1]
    assert S % PAGE == 0, S
    MP = -(-(S + steps) // PAGE)
    cache = api.init_paged_cache(B, 1 + B * MP, PAGE, MP)
    cache["block_tables"].copy_(1 + torch.arange(
        B * MP, dtype=torch.int32, device=api.device).reshape(B, MP))
    cache["seq_lens"].fill_(S)
    n = S // PAGE
    for seg in api.model.segments:
        for pool, kv in zip(cache[seg.name], caches[seg.name]):
            L, _, KVH, _, D = kv.shape
            for b in range(B):
                pool[:, 1 + b * MP:1 + b * MP + n] = kv[:, b].reshape(
                    L, KVH, n, PAGE, D).transpose(1, 2)
    return cache


def _text_pos3(torch, B, pos, device):
    return torch.full((B, 1, 3), pos, dtype=torch.int32, device=device)


def decode_paths(torch, api, params, caches, S, first, steps):
    """Greedy decodes from one prefill (its caches, its greedy tokens
    ``first`` [B]): ``decode_fn`` over the timeline cache grown by
    ``steps`` positions, and ``decode_paged_fn`` over pages holding the
    same K/V; a VLM decodes at text positions (p, p, p). Returns
    ((timeline logits, tokens), (paged logits, tokens)), each a list of
    [B, V] f32 and [B] over the steps."""
    mrope = api.cfg.pos_type == "mrope"
    B = first.shape[0]
    tl = {name: _grow(torch, body, steps) for name, body in caches.items()
          if name != "len"}
    tl["len"] = caches["len"].clone()
    pg = _paged_from(torch, api, caches, S, steps)
    out = []
    for cache, fn in ((tl, api.decode_fn), (pg, api.decode_paged_fn)):
        tok, logits, toks = first, [], []
        for i in range(steps):
            batch = {"tokens": tok[:, None]}
            if mrope:
                batch["pos3"] = _text_pos3(torch, B, S + i, api.device)
            lg, cache = fn(params, cache, batch)
            tok = lg.argmax(-1)
            logits.append(lg)
            toks.append(tok)
        out.append((logits, toks))
    return out


def hold_paths(a, b, tol, what):
    """Two greedy decodes from one state, row by row: while a row's inputs
    agree (equal tokens so far) its logits must agree within ``tol`` of
    the largest |logit|; where its argmaxes part, ``a``'s top-two margin
    must be within twice that step's largest difference (a near-tie,
    which rounding may break either way). Returns (rows whose streams are
    equal, the largest relative difference, the partings as (row, step,
    margin / scale))."""
    (la, ta), (lb, tb) = a, b
    B = ta[0].shape[0]
    scale = max(float(x.abs().max()) for x in la)
    worst, equal, parts = 0.0, 0, []
    for r in range(B):
        for i in range(len(la)):
            d = float((la[i][r] - lb[i][r]).abs().max())
            worst = max(worst, d / scale)
            assert d <= tol * scale, (what, r, i, d, scale)
            if int(ta[i][r]) != int(tb[i][r]):
                top = la[i][r].topk(2).values
                margin = float(top[0] - top[1])
                assert margin <= 2 * d + 1e-6 * scale, \
                    (what, "parted off a near-tie", r, i, margin, d)
                parts.append((r, i, margin / scale))
                break
        else:
            equal += 1
    return equal, worst, parts


def pipelined_paths(torch, ops, api, params, caches, first, tl_tokens,
                    steps):
    """The runtime ``PipelinedDecoder`` over two stages and two
    microbatches on the timeline, from a prefill's caches, fed ``first``
    then the timeline's greedy tokens: unsealed, then with sealed stage
    boundaries (the seal and unseal kernels on the card). Returns the two
    runs' logits and the sealed run's seal and unseal launches."""
    from repro_torch.runtime.pipeline import PipelinedDecoder
    res = {}
    for seal in (False, True):
        dec = PipelinedDecoder(api, num_stages=2, num_microbatches=2,
                               seal_boundary=seal)
        step = dec.build(paged=False, per_slot_start=False)
        body = (_grow(torch, caches[api.model.served_segment.name], steps),
                caches["len"].clone())
        before = dict(ops.LAUNCHES)
        tok, logits = first, []
        for i in range(steps):
            lg, body = step(params, body, {"tokens": tok[:, None]},
                            0xC0FFEE + i)
            logits.append(lg)
            tok = tl_tokens[i]
        _sync(torch)
        res[seal] = (logits, {k: ops.LAUNCHES[k] - before[k]
                              for k in ("seal", "unseal")})
    return res


def vlm_run(torch, ops, api, params, text, steps, pipe_steps, seed=1):
    """16a's path on one model: seeded tokens, patch embeddings and
    (t, h, w) positions (the P patches on a square grid at t = 0, then
    text at (p, p, p)); ``prefill_fn``; ``prefill_fn`` of S + 1 tokens
    against the first decode step; both greedy decodes; the pipelined
    decoder unsealed and sealed."""
    cfg, dev = api.cfg, api.device
    P = cfg.num_patches
    S = P + text
    side = int(math.ceil(math.sqrt(P)))
    # drawn on the host, so that the card and the CPU get the same inputs
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (VLM_B, S),
                           generator=g).to(dev)
    patches = torch.randn(VLM_B, P, cfg.d_model, generator=g).to(
        dev, api.dtype)
    i = torch.arange(P, device=dev)
    img = torch.stack([torch.zeros_like(i), i // side, i % side], -1)
    p = torch.arange(P, S + 1, device=dev)
    txt = torch.stack([p, p, p], -1)
    pos3 = torch.cat([img, txt])[None].expand(VLM_B, S + 1, 3).to(
        torch.int32).contiguous()
    batch = {"tokens": tokens, "patches": patches, "pos3": pos3[:, :S]}
    logits, caches = api.prefill_fn(params, batch)
    first = logits.argmax(-1)
    longer, _ = api.prefill_fn(params, {
        "tokens": torch.cat([tokens, first[:, None]], 1),
        "patches": patches, "pos3": pos3})
    tl, pg = decode_paths(torch, api, params, caches, S, first, steps)
    pipe = pipelined_paths(torch, ops, api, params, caches, first, tl[1],
                           pipe_steps)
    _sync(torch)
    return dict(S=S, logits=logits, longer=longer, tl=tl, pg=pg, pipe=pipe)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _vlm_report(r, tol):
    """16a's cross-path numbers of one run, each asserted below ``tol`` of
    the largest |logit| when ``tol`` is given: prefill S+1 against decode
    one, timeline against paged decode (``hold_paths``), pipelined
    unsealed against unpipelined; sealed against unsealed, printed."""
    cons = _rel(r["tl"][0][0], r["longer"])
    paths = hold_paths(r["tl"], r["pg"], tol or float("inf"), "16a")
    (ul, _), (sl, sealed) = r["pipe"][False], r["pipe"][True]
    unsealed = max(_rel(ul[i], r["tl"][0][i]) for i in range(len(ul)))
    seal_diff = max(_rel(sl[i], ul[i]) for i in range(len(sl)))
    if tol:
        assert cons < tol and unsealed < tol, (cons, unsealed, tol)
    return (f"prefill S+1 vs decode one {cons:.2e}; timeline vs paged "
            f"({len(r['tl'][0])} steps): {paths[0]} of {VLM_B} streams "
            f"equal, largest difference {paths[1]:.2e}, partings "
            f"{paths[2]}; pipelined (2 stages, 2 microbatches) unsealed vs "
            f"unpipelined {unsealed:.2e}, sealed vs unsealed {seal_diff:.2e}"
            f" ({sealed['seal']} seals, {sealed['unseal']} unseals)")


def family_vlm(torch, ops, smi):
    """16a. qwen2-vl-7b (``VlmLM``: M-RoPE, the stub patch frontend),
    first reduced in f32 card against CPU (logits within F32_LOGIT_TOL of
    the largest, the greedy streams of both decode layouts equal, on both
    devices), then at full width from a seeded generator, in bf16 and in
    f32 (the same weights upcast, exactly): one prefill of 2 x (1024
    patches + 128 text tokens), 28 flash launches at D=128, 28 heads over
    4; prefill of S + 1 against decode one; 16 greedy steps of
    ``decode_fn`` (timeline) and of ``decode_paged_fn`` (the paged kernel
    at rep 7) held against each other (``hold_paths``); the runtime
    pipelined decoder, 2 stages, unsealed against the unpipelined decode,
    and sealed (the seal kernels), its largest difference printed. The
    f32 run asserts these within F32_FULL_TOL; the bf16 run's rounding
    through 28 layers of random weights reaches a few percent of the
    largest logit, so it prints them. Returns both runs' launch
    counts."""
    from repro_torch.configs import reduced
    from repro_torch.models.api import build_model
    t_phase = time.perf_counter()
    cfg = _family_cfg("qwen2-vl-7b")
    rcfg = reduced(cfg)
    g = torch.Generator().manual_seed(0)
    rparams = build_model(rcfg, device="cpu", dtype=torch.float32).init(g)
    for b in ("bq", "bk", "bv"):
        rparams["blocks"]["attn"][b].normal_(generator=g)
    small = {}
    for device in ("cpu", DEV):
        api = build_model(rcfg, device=device, dtype=torch.float32)
        small[device] = vlm_run(torch, ops, api, _to(torch, rparams, device),
                                text=8, steps=6, pipe_steps=4)
    c, d = small["cpu"], small[DEV]
    worst = 0.0
    for x, y in ([(d["logits"], c["logits"]), (d["longer"], c["longer"])]
                 + list(zip(d["tl"][0] + d["pg"][0] + d["pipe"][False][0],
                            c["tl"][0] + c["pg"][0]
                            + c["pipe"][False][0]))):
        worst = max(worst, _rel(x.cpu(), y))
    assert worst < F32_LOGIT_TOL, worst
    assert [t.tolist() for t in d["tl"][1]] == \
        [t.tolist() for t in c["tl"][1]], "reduced: card vs CPU streams"
    log(f"family phase 16a reduced qwen2-vl-7b ({rcfg.num_layers} layers, "
        f"{rcfg.num_patches} patches, f32): card = CPU, largest logit "
        f"difference {worst:.2e} of the largest |logit| (< "
        f"{F32_LOGIT_TOL}); on the card: {_vlm_report(d, F32_FULL_TOL)}")
    del small, rparams
    _free(torch)

    t0 = time.perf_counter()
    api = build_model(cfg, device=DEV, dtype=torch.bfloat16)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    _sync(torch)
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    _free(torch)
    L = cfg.num_layers
    runs, notes = [], []
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32:
            params = _to_f32(params)
            api = build_model(cfg, device=DEV, dtype=dtype)
            _free(torch)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = vlm_run(torch, ops, api, params, text=VLM_TEXT, steps=VLM_STEPS,
                    pipe_steps=VLM_PIPE_STEPS)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        assert launches["flash_attention"] == 2 * L, launches
        assert launches["paged_attention"] == VLM_STEPS * L, launches
        assert launches["seal"] == launches["unseal"] \
            == VLM_PIPE_STEPS * 2, launches
        assert all(torch.isfinite(x).all() for x in
                   [r["logits"], r["longer"]] + r["tl"][0] + r["pg"][0]
                   + r["pipe"][True][0])
        f32 = dtype == torch.float32
        notes.append(f"{'f32' if f32 else 'bf16'}: "
                     f"{_vlm_report(r, F32_FULL_TOL if f32 else None)}; "
                     f"launches {launches}; wall {wall:.2f} s, "
                     f"{_mem(torch)}")
        runs.append({"launches": launches})
        del r
    log(f"family phase 16a qwen2-vl-7b full width: {L} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV "
        f"heads, head_dim {cfg.head_dim}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params (config count "
        f"{cfg.total_params() / 1e9:.3f} B without biases), bf16 init "
        f"{init_s:.1f} s; prefill B={VLM_B} S={cfg.num_patches + VLM_TEXT} "
        f"({cfg.num_patches} patches + {VLM_TEXT} text), "
        f"{VLM_STEPS} decode steps, {VLM_PIPE_STEPS} pipelined; "
        + "; ".join(notes) + f" [{smi}]")
    log(f"family phase 16a: {time.perf_counter() - t_phase:.1f} s")
    del api, params
    _free(torch)
    return runs


def _engine_streams(torch, api, params, argv, label):
    """One engine over ``argv``'s stream on the model's device: the greedy
    streams and the stats."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(argv)
    eng = serve.make_engine(api, params, args)
    reqs = serve.serve_stream(eng, args, serve.gen_prompts(
        args, api.cfg.vocab_size))
    st = eng.stats()
    assert st["kv_layout"] == "timeline" and st["completed"] == len(reqs), \
        (label, st["kv_layout"], st["completed"])
    return [list(r.generated) for r in reqs], st


def family_hymba(torch, ops, smi):
    """16b. hymba-1.5b (parallel attention + selective SSM, window 2048): the
    reduced config at HYMBA_REDUCED_LAYERS layers in f32 served through
    ``ServingEngine`` on the timeline, local and pipelined, unsealed and
    sealed, card against CPU (streams equal); then at full width in bf16:
    ``prefill_fn`` at B=1, S=4096 (32 flash launches, D=64, 25 heads over 5,
    the window biting), a prefill of 2048 then one decode step (only slot 0 of
    the rolling buffer changes: the oldest token evicted) against a prefill of
    2049, in bf16 (printed) and f32 (within F32_FULL_TOL); then 3 requests on 4
    timeline slots: local eager, local in CUDA graphs (equal streams, steps and
    launches), pipelined over 2 stages with one microbatch unsealed (= local)
    and sealed (its first parting from local printed; seals = unseals = decode
    steps). Returns the runs' launch counts."""
    from repro_torch.configs import reduced
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    SEGMENT = "blocks"                  # Hymba's served segment
    import dataclasses
    t_phase = time.perf_counter()
    cfg = _family_cfg("hymba-1.5b")
    rcfg = dataclasses.replace(reduced(cfg), num_layers=HYMBA_REDUCED_LAYERS)
    rparams = build_model(rcfg, device="cpu", dtype=torch.float32).init(
        torch.Generator().manual_seed(0))
    for seal in ([], ["--no-seal"]):
        for backend in ("local", "pipelined"):
            if backend == "local" and not seal:
                continue
            argv = HYMBA_REDUCED + ["--backend", backend] + seal
            got = {}
            for device in ("cpu", DEV):
                api = build_model(rcfg, device=device, dtype=torch.float32,
                                  max_seq=64)
                got[device] = _engine_streams(
                    torch, api, _to(torch, rparams, device),
                    [a if a != "cpu" else device for a in argv],
                    f"16b reduced {backend}")
            assert got["cpu"][0] == got[DEV][0], \
                f"16b reduced {backend} {seal}: streams differ card vs CPU"
            log(f"family phase 16b reduced hymba-1.5b ({backend}"
                f"{', unsealed' if seal else ', sealed'}, f32): "
                f"{len(got['cpu'][0])} streams equal card vs CPU, stage "
                f"blocks {got[DEV][1]['stage_blocks']}")
    del rparams

    t0 = time.perf_counter()
    api, params = _build_params(torch, [a if a != "cuda" else DEV
                                        for a in HYMBA_SERVE]
                                + (["--reduced"] if FAMILY_ARCH else []))
    _sync(torch)
    cfg = api.cfg
    L = cfg.num_layers
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    _free(torch)
    g = torch.Generator(device=DEV).manual_seed(1)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = torch.randint(0, cfg.vocab_size, (1, HYMBA_S), generator=g,
                         device=DEV)
    logits, cache = api.prefill_fn(params, {"tokens": toks})
    assert tuple(cache[SEGMENT][0][0].shape) == \
        (L, 1, cfg.num_kv_heads, cfg.sliding_window, cfg.head_dim)
    assert torch.isfinite(logits).all()
    _sync(torch)
    long_s = time.perf_counter() - t0
    long_peak = _mem(torch)
    del cache
    # the window's eviction, and prefill S then decode one against prefill
    # S + 1, at the window's length: bf16 printed, f32 (the same weights
    # upcast, exactly) asserted
    S = HYMBA_EVICT_S
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :S]})
    k_before = cache[SEGMENT][0][0][0, 0].clone()
    dec, cache = api.decode_fn(params, cache, {"tokens": toks[:, S:S + 1]})
    k_after = cache[SEGMENT][0][0][0, 0]
    changed = ((k_after.float() - k_before.float()).abs().amax(dim=(0, 2))
               > 0).nonzero().flatten().tolist()
    assert changed == [S % cfg.sliding_window], changed
    longer, _ = api.prefill_fn(params, {"tokens": toks[:, :S + 1]})
    cons16 = _rel(dec, longer)
    del cache
    api32 = build_model(cfg, device=DEV, dtype=torch.float32)
    p32 = _to_f32(params)
    _, cache = api32.prefill_fn(p32, {"tokens": toks[:, :S]})
    dec, _ = api32.decode_fn(p32, cache, {"tokens": toks[:, S:S + 1]})
    longer, _ = api32.prefill_fn(p32, {"tokens": toks[:, :S + 1]})
    cons = _rel(dec, longer)
    assert cons < F32_FULL_TOL, cons
    del api32, p32
    _sync(torch)
    launches = dict(ops.LAUNCHES)
    assert launches["flash_attention"] == 5 * L, launches
    del cache
    _free(torch)
    log(f"family phase 16b hymba-1.5b full width: {L} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} KV "
        f"heads, head_dim {cfg.head_dim}, window {cfg.sliding_window}, SSM "
        f"state {cfg.ssm_state}, {n_params / 1e9:.3f} B params bf16, init "
        f"{init_s:.1f} s; prefill B=1 S={HYMBA_S} {long_s * 1e3:.1f} ms "
        f"(first call, with the scan), {long_peak}; prefill {S} + decode "
        f"one: only slot {changed} of layer 0's K changed (the oldest "
        f"token evicted), against prefill {S + 1}: {cons16:.2e} in bf16, "
        f"{cons:.2e} in f32 (< {F32_FULL_TOL}); launches {launches} "
        f"[{smi}]")
    runs = [{"launches": launches}]
    argv = [a if a != "cuda" else DEV for a in HYMBA_SERVE] \
        + (["--reduced"] if FAMILY_ARCH else [])
    local = serve_layout(torch, ops, api, params,
                         argv + ["--backend", "local"], "16b local, eager")
    graphs = serve_layout(torch, ops, api, params,
                          argv + ["--backend", "local", "--warmup"],
                          "16b local, CUDA graphs")
    assert graphs["streams"] == local["streams"], \
        "16b: the local streams differ under CUDA graphs"
    assert graphs["steps"] == local["steps"] and \
        graphs["launches"] == local["launches"]
    pipe = ["--backend", "pipelined", "--stages", "2", "--microbatches", "1"]
    plain = serve_layout(torch, ops, api, params, argv + pipe + ["--no-seal"],
                         "16b pipelined, unsealed")
    assert plain["streams"] == local["streams"], \
        "16b: unsealed pipelined streams differ from local"
    sealed = serve_layout(torch, ops, api, params, argv + pipe,
                          "16b pipelined, sealed")
    assert sealed["launches"]["seal"] == sealed["launches"]["unseal"] \
        == sealed["steps"], (sealed["launches"], sealed["steps"])
    part = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            for a, b in zip(sealed["streams"], local["streams"])]
    log(f"family phase 16b serving: local eager = local graphs = "
        f"pipelined unsealed ({len(local['streams'])} streams, stage "
        f"blocks {plain['st']['stage_blocks']}); sealed run's first "
        f"parting from local per request {part}; ms per decode step "
        f"eager {local['step_ms']:.2f}, graphs {graphs['step_ms']:.2f}, "
        f"pipelined unsealed {plain['step_ms']:.2f}, sealed "
        f"{sealed['step_ms']:.2f}; ms per prefill token eager "
        f"{local['token_ms']:.3f}, graphs {graphs['token_ms']:.3f} [{smi}]")
    log(f"family phase 16b: {time.perf_counter() - t_phase:.1f} s")
    runs += [local, graphs, plain, sealed]
    del api, params
    _free(torch)
    return runs


def family_glm4(torch, ops, smi, phase5_ms):
    """16d. glm4-9b at full width (its depth cut to DEPTH's 10 layers of 40; 2
    KV heads, rep 16, untied head), phase 5's flags with 6 requests on the
    paged local engine, eager and warmed as CUDA graphs: equal streams, steps
    and launches (paged attention at rep 16 a layer a decode step). Returns the
    runs' launch counts."""
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    argv = [a if a != "cuda" else DEV for a in GLM4_SERVE] \
        + (["--reduced"] if FAMILY_ARCH else [])
    t0 = time.perf_counter()
    api, params = _build_params(torch, argv)
    _sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    _free(torch)
    eager = serve_layout(torch, ops, api, params, argv + ["--backend",
                                                         "local"],
                         "16d glm4-9b local, eager")
    graphs = serve_layout(torch, ops, api, params,
                          argv + ["--backend", "local", "--warmup"],
                          "16d glm4-9b local, CUDA graphs")
    assert graphs["streams"] == eager["streams"], \
        "16d: glm4-9b's streams differ under CUDA graphs"
    assert graphs["launches"] == eager["launches"]
    L = api.cfg.num_layers
    assert eager["launches"]["paged_attention"] == eager["steps"] * L
    log(f"family phase 16d glm4-9b full width: {L} layers, "
        f"{api.cfg.num_heads} heads over {api.cfg.num_kv_heads} KV heads "
        f"(rep {api.cfg.q_per_kv}), {n_params / 1e9:.3f} B params bf16, "
        f"init {init_s:.1f} s; {eager['steps']} decode steps, ms per step "
        f"eager {eager['step_ms']:.2f}, graphs {graphs['step_ms']:.2f} "
        f"(phase 5's llama3.2-1b: {phase5_ms:.2f} eager), tok/s "
        f"{eager['st']['tok_per_s']:.1f} / {graphs['st']['tok_per_s']:.1f}; "
        f"paged launches {eager['launches']['paged_attention']} a run "
        f"[{smi}]")
    log(f"family phase 16d: {time.perf_counter() - t_phase:.1f} s")
    del api, params
    _free(torch)
    return [eager, graphs]


def moon_run(torch, api, params, S, steps):
    """16c's path on one model: seeded tokens [MOON_B, S + 1] drawn on
    the card; ``prefill_fn`` of S, of S + 1 against decode one, and both
    greedy decodes (``decode_paths``)."""
    g = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, api.cfg.vocab_size, (MOON_B, S + 1),
                         generator=g, device=DEV)
    logits, caches = api.prefill_fn(params, {"tokens": toks[:, :S]})
    first = logits.argmax(-1)
    longer, _ = api.prefill_fn(params, {"tokens": torch.cat(
        [toks[:, :S], first[:, None]], 1)})
    tl, pg = decode_paths(torch, api, params, caches, S, first, steps)
    _sync(torch)
    assert all(torch.isfinite(x).all() for x in [logits, longer] + tl[0]
               + pg[0])
    return dict(longer=longer, tl=tl, pg=pg)


def _moon_report(r, tol):
    cons = _rel(r["tl"][0][0], r["longer"])
    equal, worst, parts = hold_paths(r["tl"], r["pg"], tol or float("inf"),
                                     "16c timeline vs paged")
    if tol:
        assert cons < tol, (cons, tol)
    return (f"prefill S+1 vs decode one {cons:.2e}; timeline vs paged "
            f"({len(r['tl'][0])} steps): {equal} of {MOON_B} streams equal,"
            f" largest difference {worst:.2e}, partings {parts}")


def family_moonshot(torch, ops, smi):
    """16c. moonshot-v1-16b-a3b (a dense stem block, then 47 MoE blocks of
    64 experts top-6 plus 2 shared; 28.4 B parameters, 52.9 GiB in bf16).
    First at full width in f32 with the depth cut to the stem and 3 MoE
    blocks (f32 at full depth would need 106 GiB): prefill of S + 1
    against decode one, and 8 greedy steps of ``decode_fn`` and of
    ``decode_paged_fn`` held against each other, within F32_FULL_TOL.
    Then every earlier tensor freed and the full model in bf16, each
    weight drawn on the card: ``prefill_fn`` at B=2, S=256 through both
    segments (48 flash launches, D=128, rep 1), the same checks printed
    (bf16 rounding through 48 layers), the serving engine's refusal of
    the two-segment model by name, the peak memory. Returns both runs'
    launch counts."""
    import dataclasses
    from repro_torch.models.api import build_model
    from repro_torch.serving import EngineConfig, ServingEngine
    t_phase = time.perf_counter()
    _free(torch)
    cfg = _family_cfg("moonshot-v1-16b-a3b")
    runs, notes = [], []
    cut = dataclasses.replace(cfg, num_layers=cfg.first_k_dense + 3)
    api = build_model(cut, device=DEV, dtype=torch.float32)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    ops.reset_launch_counts()
    r = moon_run(torch, api, params, MOON_S, MOON_STEPS)
    launches = dict(ops.LAUNCHES)
    assert launches["flash_attention"] == 2 * cut.num_layers, launches
    assert launches["paged_attention"] == MOON_STEPS * cut.num_layers, \
        launches
    notes.append(f"f32, {cut.num_layers} layers (stem + 3 MoE): "
                 f"{_moon_report(r, F32_FULL_TOL)}")
    runs.append({"launches": launches})
    del api, params, r
    _free(torch)

    before = _mem(torch)
    t0 = time.perf_counter()
    api = build_model(cfg, device=DEV, dtype=torch.bfloat16)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    _sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    assert [s.name for s in api.model.segments] == ["stem", "blocks"]
    try:
        ServingEngine(api, EngineConfig(), params, device=DEV)
    except ValueError as e:
        assert "single homogeneous segment" in str(e), e
        refused = str(e)
    else:
        raise AssertionError("16c: the engine served a two-segment model")
    _free(torch)
    after_init = _mem(torch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = moon_run(torch, api, params, MOON_S, MOON_STEPS)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    L = cfg.num_layers
    assert launches["flash_attention"] == 2 * L, launches
    assert launches["paged_attention"] == MOON_STEPS * L, launches
    notes.append(f"bf16, {L} layers: {_moon_report(r, None)}; wall "
                 f"{wall:.2f} s, {_mem(torch)}")
    runs.append({"launches": launches})
    log(f"family phase 16c moonshot-v1-16b-a3b full width: segments "
        f"{[(s.name, s.n) for s in api.model.segments]}, d_model "
        f"{cfg.d_model}, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok} + {cfg.num_shared_experts} shared, "
        f"stem d_ff {cfg.dense_stem_d_ff}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params bf16 (config count "
        f"{cfg.total_params() / 1e9:.3f} B), init {init_s:.1f} s; {before} "
        f"before init, {after_init} after; prefill B={MOON_B} S={MOON_S}, "
        f"{MOON_STEPS} decode steps; " + "; ".join(notes)
        + f"; engine refused: {refused!r}; launches {runs} [{smi}]")
    log(f"family phase 16c: {time.perf_counter() - t_phase:.1f} s")
    del api, params, r
    _free(torch)
    return runs


# ---------------------------------------------------------------------------
# phase 17: the last two families at full width: xlstm-125m (sLSTM/mLSTM
# pairs, recurrent state, served on the timeline) and whisper-small
# (encoder-decoder through the model API, its three attentions on the flash
# kernel). Sizes are names, as phase 16's, for a CPU rehearsal.
XLSTM_B, XLSTM_S, XLSTM_STEPS, XLSTM_SHORT = 2, 1024, 16, 16
# block 0's long scan-against-steps checks: steps of one token (cut from
# 1024 to keep the script's time: two of the mLSTM's 256-token chunks, so
# the C and n carried from the first chunk into the second are checked)
XLSTM_BLOCK_S = 512
# The reference's initializer takes a weight's leading axis as its fan-in.
# For a stacked block weight that axis is the block count, so every block
# projection draws at std 1/sqrt(6) (xLSTM's pairs) or 1/sqrt(12)
# (Whisper's blocks): 6 to 16 times the usual 1/sqrt(fan-in). At full
# width the whole model then amplifies f32 rounding until two correct
# paths part by about what an embedding scaled by 1 + 1e-6 does to the
# logits, so no tolerance there tells a fault from rounding. 17a prints
# that model-level reading at each length of XLSTM_SWEEP, beside the
# nudge's. What phase 17 asserts in f32:
# * the reduced configs, card against CPU, within F32_LOGIT_TOL (Whisper's
#   on the contraction-scaled weights below, its reference init printed);
# * one block at full width on the reference's weights: the sLSTM's scan
#   against its steps over XLSTM_SHORT tokens and Whisper's decoder block
#   0, prefill S+1 against prefill S then decode one, within BLOCK_TOL;
#   the mLSTM's chunks against its steps over XLSTM_BLOCK_S tokens, C and n
#   within MLSTM_STATE_TOL;
# * a sealed pipelined step against the unpipelined step with the plain
#   int8 round trip (``seal_ref``, ``unseal_ref``) at the same boundary,
#   within F32_LOGIT_TOL;
# * the whole model at full width on the same weights with each stacked
#   one rescaled to std 1/sqrt(the count its product contracts)
#   (``_contraction_scaled``): prefill S then decode one against prefill
#   S+1 within F32_FULL_TOL.
XLSTM_SWEEP = (8, 16, 64, 256)
# one block on the reference's weights: within this share of the largest
# |value|, the CPU tests' bound for Whisper's prefill (PREFILL_REL in
# tests/test_torch_whisper.py): its scores reach 150 under that init, so
# an ulp of a score moves its softmax weight by about 1e-5
BLOCK_TOL = 2e-4
# the mLSTM's matrix memory and normalizer, chunks of 256 against single
# steps: within this share of their largest |value| (sums in another order)
MLSTM_STATE_TOL = 1e-4
# phase 5's first 4 requests (up to 128 tokens, 32 new, 8 slots; about
# 350 per-token prefill steps; the stream trimmed from 8 to keep the
# whole script's time) on the timeline; telemetry off so that no
# re-plan moves a pipelined run's stage boundaries
XLSTM_SERVE = ["--arch", "xlstm-125m", "--device", "cuda", "--slots", "8",
               "--requests", "4", "--prompt-len", "128", "--max-new", "32",
               "--shared-system-prompt", "0.75",
               "--telemetry-interval", "1000"]
XLSTM_REDUCED = ["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                 "--slots", "4", "--requests", "6", "--prompt-len", "24",
                 "--max-new", "8", "--f32", "--telemetry-interval", "1000"]
# the reduced configs' prompts, card against CPU
SMALL_B, SMALL_S = 2, 20
WHISPER_B, WHISPER_S, WHISPER_STEPS, WHISPER_MAX_SEQ = 2, 224, 16, 448


def _at0(tree):
    """Layer 0 of a tree of stacked block weights."""
    if isinstance(tree, dict):
        return {k: _at0(v) for k, v in tree.items()}
    return tree[0]


def _contraction_scaled(params, stacks):
    """``params`` with every stacked block weight under the keys
    ``stacks`` (rank 3 and up: [n blocks, ...]) rescaled from the
    reference's std 1/sqrt(n) to 1/sqrt(k), k the count its product
    contracts: all but the last axis for an output projection ``wo``, the
    input axis for the sLSTM's recurrent ``r`` [4, H, dh, dh], the first
    axis after the stack for the others. Zero leaves stay zero."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if tree.dim() < 3:
            return tree
        shape = tree.shape[1:]
        k = math.prod(shape[:-1]) if name == "wo" else \
            shape[-2] if name == "r" else shape[0]
        return tree * math.sqrt(tree.shape[0] / k)
    return {k: walk(v, k) if k in stacks else v for k, v in params.items()}


def _draw_zeros(torch, tree, names, g, std):
    """``tree`` with its all-zero leaves whose key is in ``names`` (the
    gates and biases the initializer zeroes) drawn N(0, std^2) from
    ``g``."""
    if isinstance(tree, dict):
        return {k: (torch.randn(v.shape, generator=g) * std
                    if k in names and not isinstance(v, dict)
                    and not v.any() else _draw_zeros(torch, v, names, g, std))
                for k, v in tree.items()}
    return tree


def pipe_step_mirror(torch, api, params, cache, tok, key=0xC0FFEE):
    """One decode step of ``tok`` [B, 1] from copies of a timeline cache
    (a prefill's): the runtime ``PipelinedDecoder`` over 2 stages and one
    microbatch, unsealed then sealed (the seal kernels at the boundary),
    and the same step unpipelined with the boundary activation through
    the plain int8 round trip (``seal_ref`` then ``unseal_ref``, in the
    model's type). Returns (unsealed, sealed, mirrored) logits."""
    from repro_torch.enclave import sealing
    from repro_torch.kernels import ref
    from repro_torch.runtime.pipeline import PipelinedDecoder
    model, name = api.model, api.model.served_segment.name
    out = []
    for seal in (False, True):
        dec = PipelinedDecoder(api, num_stages=2, num_microbatches=1,
                               seal_boundary=seal)
        step = dec.build(paged=False, per_slot_start=False)
        out.append(step(params, (_clone(cache[name]), cache["len"].clone()),
                        {"tokens": tok}, key)[0])
    body, n, k = _clone(cache[name]), cache["len"].clone(), dec.ranges[0][1]
    h = model.decode_timeline_blocks(params, body, model.embed(params, tok),
                                     n, None, 0, k)
    ctr = sealing.leaf_counters(2, api.device)[1:2]   # tick 0 seals at 1
    flat = h.reshape(-1, api.cfg.d_model)
    h = ref.unseal_ref(*ref.seal_ref(flat, key, ctr), key, ctr,
                       out_dtype=api.dtype).reshape(h.shape)
    h = model.decode_timeline_blocks(params, body, h, n, None, k)
    out.append(model.head(params, h))
    return out


def xlstm_small_run(torch, api, params, toks):
    """17a's paths on one reduced model: prefill S, decode one from its
    cache, prefill S+1, S+1 decode steps from ``init_cache`` (the engine's
    m = 0 start), and ``pipe_step_mirror`` from the prefill's state."""
    S = toks.shape[1] - 1
    logits, cache = api.prefill_fn(params, {"tokens": toks[:, :S]})
    pipe = pipe_step_mirror(torch, api, params, cache, toks[:, S:])
    dec, _ = api.decode_fn(params, _clone(cache), {"tokens": toks[:, S:]})
    longer, _ = api.prefill_fn(params, {"tokens": toks})
    c0 = api.init_cache(toks.shape[0])
    for t in range(S + 1):
        zero, c0 = api.decode_fn(params, c0, {"tokens": toks[:, t:t + 1]})
    return dict(logits=logits, dec=dec, longer=longer, zero=zero,
                state=list(_leaves(cache["pairs"])), pipe=pipe)


def xlstm_reduced(torch, ops, cfg):
    """17a on the reduced config in f32 (2 pairs; the mLSTM gates and
    sLSTM bias the initializer zeroes drawn N(0, 0.2^2), as the CPU tests
    draw them), card against CPU: every path of ``xlstm_small_run``
    within F32_LOGIT_TOL of the largest |value|; on the card, decode one
    against prefill S+1 and the unsealed pipelined step against it within
    F32_LOGIT_TOL, the sealed step against its mirror within
    F32_LOGIT_TOL; then ``ServingEngine`` on the timeline, local and
    pipelined over 2 stages, unsealed and sealed: streams equal card
    against CPU."""
    from repro_torch.configs import reduced
    from repro_torch.models.api import build_model
    rcfg = reduced(cfg)
    g = torch.Generator().manual_seed(0)
    rparams = build_model(rcfg, device="cpu", dtype=torch.float32).init(g)
    rparams = _draw_zeros(torch, rparams, ("wi", "wf", "b"), g, 0.2)
    toks = torch.randint(0, rcfg.vocab_size, (SMALL_B, SMALL_S + 1),
                         generator=g)
    small = {}
    for device in ("cpu", DEV):
        api = build_model(rcfg, device=device, dtype=torch.float32,
                          max_seq=64)
        small[device] = xlstm_small_run(torch, api,
                                        _to(torch, rparams, device),
                                        toks.to(device))
    c, d = small["cpu"], small[DEV]
    worst = 0.0
    for x, y in ([(d[k], c[k]) for k in ("logits", "dec", "longer", "zero")]
                 + list(zip(d["state"], c["state"]))
                 + list(zip(d["pipe"], c["pipe"]))):
        worst = max(worst, _rel(x.cpu(), y))
    assert worst < F32_LOGIT_TOL, worst
    cons, plain = _rel(d["dec"], d["longer"]), _rel(d["pipe"][0], d["dec"])
    mirror = _rel(d["pipe"][1], d["pipe"][2])
    assert max(cons, plain, mirror) < F32_LOGIT_TOL, (cons, plain, mirror)
    sealed = _rel(d["pipe"][1], d["pipe"][0])
    log(f"family phase 17a reduced xlstm-125m ({rcfg.num_layers // 2} "
        f"pairs, d_model {rcfg.d_model}, f32, S={SMALL_S}): card = CPU, "
        f"largest difference {worst:.2e} of the largest |value| over "
        f"prefill, decode one, prefill S+1, decode from init_cache (m = "
        f"0), the state and the pipelined steps (< {F32_LOGIT_TOL}); on "
        f"the card: prefill S + decode one against prefill S+1 {cons:.2e}, "
        f"pipelined (2 stages) unsealed against unpipelined {plain:.2e}, "
        f"sealed against the plain int8 round trip at its boundary "
        f"{mirror:.2e} (each < {F32_LOGIT_TOL}), sealed against unsealed "
        f"{sealed:.2e}")
    del small
    for seal in ([], ["--no-seal"]):
        for backend in ("local", "pipelined"):
            if backend == "local" and not seal:
                continue
            argv = XLSTM_REDUCED + ["--backend", backend] + seal
            got = {}
            for device in ("cpu", DEV):
                api = build_model(rcfg, device=device, dtype=torch.float32,
                                  max_seq=64)
                got[device] = _engine_streams(
                    torch, api, _to(torch, rparams, device),
                    [a if a != "cpu" else device for a in argv],
                    f"17a reduced {backend}")
            assert got["cpu"][0] == got[DEV][0], \
                f"17a reduced {backend} {seal}: streams differ card vs CPU"
            log(f"family phase 17a reduced xlstm-125m ({backend}"
                f"{', unsealed' if seal else ', sealed'}, f32): "
                f"{len(got['cpu'][0])} streams equal card vs CPU, stage "
                f"blocks {got[DEV][1]['stage_blocks']}")
    _free(torch)


def family_xlstm(torch, ops, smi):
    """17a. xlstm-125m: first ``xlstm_reduced`` (f32, card against CPU), then
    at full width in bf16 (d 768, 4 heads x 192, untied head; its depth cut to
    DEPTH's 2 (sLSTM, mLSTM) pairs of 6): ``prefill_fn`` at B=2, S=1024 (mLSTM
    chunks of 256), prefill S then decode one against prefill S+1 (S+1 = 1025
    runs chunks of 1) in bf16, printed; in f32 on the same weights upcast, the
    same at each S of XLSTM_SWEEP beside an embedding nudge's effect, printed;
    block 0 alone in f32: the sLSTM over XLSTM_SHORT tokens, scan against steps
    (output and state within BLOCK_TOL; over XLSTM_BLOCK_S printed), the mLSTM
    over XLSTM_BLOCK_S, chunks against steps (C and n within MLSTM_STATE_TOL);
    the model with ``_contraction_scaled`` weights in f32 at S = 16 and 1024
    (within F32_FULL_TOL); the bf16 recurrent state of ``cache_quant`` against
    the f32 state over 16 decode steps fed the f32 run's greedy tokens (top-1
    agreement printed); the sealed pipelined step against its mirror
    (``pipe_step_mirror``) in bf16 and f32; then phase 5's first 4 requests
    through ``ServingEngine`` on the timeline: local eager, local in CUDA
    graphs (equal streams, steps and launches), pipelined over 2 stages with
    one microbatch in CUDA graphs, unsealed (= local) and sealed (seal = unseal
    = one a decode step). Returns the runs' launch counts."""
    from repro_torch.launch import serve
    from repro_torch.models import xlstm as X
    from repro_torch.models.api import build_model
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    xlstm_reduced(torch, ops, _family_cfg("xlstm-125m"))
    t_reduced = time.perf_counter() - t_phase
    argv = [a if a != "cuda" else DEV for a in XLSTM_SERVE] \
        + (["--reduced"] if FAMILY_ARCH else [])
    t0 = time.perf_counter()
    api, params = _build_params(torch, argv)
    _sync(torch)
    cfg = api.cfg
    seg = api.model.served_segment
    n_params = sum(t.numel() for t in _leaves(params))
    init_s = time.perf_counter() - t0
    _free(torch)
    B, S = XLSTM_B, XLSTM_S
    H, dh = cfg.num_heads, cfg.head_dim
    g = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=DEV)
    ops.reset_launch_counts()
    _sync(torch)
    t0 = time.perf_counter()
    logits, cache = api.prefill_fn(params, {"tokens": toks[:, :S]})
    _sync(torch)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    assert seg.name == "pairs" and seg.n == cfg.num_layers // 2
    s_state, m_state = cache["pairs"]
    assert tuple(m_state[0].shape) == (seg.n, B, H, dh, dh)
    assert tuple(m_state[2].shape) == (seg.n, B, H)
    assert all(t.dtype == torch.float32 for t in s_state + m_state)
    assert torch.isfinite(logits).all()
    peak = _mem(torch)
    pipe16 = pipe_step_mirror(torch, api, params, cache, toks[:, S:])
    dec, _ = api.decode_fn(params, cache, {"tokens": toks[:, S:]})
    longer, _ = api.prefill_fn(params, {"tokens": toks})
    cons16 = _rel(dec, longer)
    del cache
    # f32 on the same weights upcast: the reference init's model-level
    # readings, printed
    api32 = build_model(cfg, device=DEV, dtype=torch.float32)
    p32 = _to_f32(params)
    nudged = dict(p32, embed=p32["embed"] * (1 + 1e-6))
    sweep = []
    for n in XLSTM_SWEEP:
        _, cache = api32.prefill_fn(p32, {"tokens": toks[:, :n]})
        dec, _ = api32.decode_fn(p32, cache, {"tokens": toks[:, n:n + 1]})
        longer, _ = api32.prefill_fn(p32, {"tokens": toks[:, :n + 1]})
        moved, _ = api32.prefill_fn(nudged, {"tokens": toks[:, :n + 1]})
        sweep.append(f"S={n} {_rel(dec, longer):.2e} (nudge "
                     f"{_rel(moved, longer):.2e})")
    del nudged, moved
    _, cache = api32.prefill_fn(p32, {"tokens": toks[:, :S]})
    pipe32 = pipe_step_mirror(torch, api32, p32, cache, toks[:, S:])
    mirror32 = _rel(pipe32[1], pipe32[2])
    assert mirror32 < F32_LOGIT_TOL, mirror32
    # block 0 alone in f32 on seeded normal inputs: the sLSTM's scan
    # against its steps (GEMMs of S rows and of one), the mLSTM's chunks
    # of 256 against single steps
    x = torch.randn(B, S, cfg.d_model, generator=g, device=DEV)
    blocks = []
    for kind, fn, n in (("slstm", X.slstm_apply, XLSTM_SHORT),
                        ("slstm", X.slstm_apply, XLSTM_BLOCK_S),
                        ("mlstm", X.mlstm_apply, XLSTM_BLOCK_S)):
        pb = _at0(p32["pairs"][kind])
        full, st_full = fn(cfg, pb, x[:, :n], mode="train")
        st, outs = None, []
        for t in range(n):
            o, st = fn(cfg, pb, x[:, t:t + 1], mode="decode", state=st)
            outs.append(o)
        out_err = _rel(torch.cat(outs, 1), full)
        errs = [_rel(a, b) for a, b in zip(st, st_full)]
        if kind == "mlstm":
            assert max(errs[:2]) < MLSTM_STATE_TOL, errs
        elif n == XLSTM_SHORT:
            assert max(errs + [out_err]) < BLOCK_TOL, (out_err, errs)
        blocks.append(f"{kind} over {n}: output {out_err:.2e}, state "
                      + ", ".join(f"{e:.2e}" for e in errs))
    del x, full, outs
    # the model on the contraction-scaled weights
    pc = _contraction_scaled(p32, ("pairs",))
    nudged = dict(pc, embed=pc["embed"] * (1 + 1e-6))
    scaled = []
    for n in (XLSTM_SHORT, S):
        _, cache = api32.prefill_fn(pc, {"tokens": toks[:, :n]})
        dec, _ = api32.decode_fn(pc, cache, {"tokens": toks[:, n:n + 1]})
        longer, _ = api32.prefill_fn(pc, {"tokens": toks[:, :n + 1]})
        moved, _ = api32.prefill_fn(nudged, {"tokens": toks[:, :n + 1]})
        cons = _rel(dec, longer)
        assert cons < F32_FULL_TOL, (n, cons)
        scaled.append(f"S={n} {cons:.2e} (nudge {_rel(moved, longer):.2e})")
    del api32, p32, pc, nudged, cache, moved
    # the bf16 state against the f32 state, fed the same tokens
    apiq = build_model(cfg, device=DEV, dtype=api.dtype, cache_quant=True)
    _, cache = api.prefill_fn(params, {"tokens": toks[:, :S]})
    qcache = apiq.init_cache(B)
    for dst, src in zip(leaves(qcache["pairs"]), leaves(cache["pairs"])):
        dst.copy_(src)                  # each leaf keeps its own dtype
    qcache["len"].fill_(S)
    assert qcache["pairs"][1][0].dtype == torch.bfloat16 and \
        qcache["pairs"][1][2].dtype == torch.float32
    tok, agree, worst = toks[:, S], 0, 0.0
    for _ in range(XLSTM_STEPS):
        lf, cache = api.decode_fn(params, cache, {"tokens": tok[:, None]})
        lq, qcache = apiq.decode_fn(params, qcache, {"tokens": tok[:, None]})
        top = lf.argmax(-1)
        agree += int((lq.argmax(-1) == top).sum())
        worst = max(worst, _rel(lq, lf))
        tok = top
    _sync(torch)
    launches = dict(ops.LAUNCHES)
    assert launches["flash_attention"] == 0, launches   # no attention
    del cache, qcache, apiq
    _free(torch)
    log(f"family phase 17a xlstm-125m full width: {seg.n} pairs "
        f"({cfg.num_layers} blocks), d_model {cfg.d_model}, {H} heads x "
        f"{dh}, vocab {cfg.vocab_size}, {n_params / 1e6:.1f} M params bf16, "
        f"init {init_s:.1f} s; prefill B={B} S={S} {prefill_ms:.1f} ms "
        f"(first call), {peak}; prefill S + decode one against prefill "
        f"S+1: S={S} {cons16:.2e} in bf16; in f32, the reference's init "
        f"(printed): " + ", ".join(sweep) + "; block 0 in f32, whole "
        f"sequence against one step at a time: " + "; ".join(blocks)
        + f" (sLSTM over {XLSTM_SHORT} < {BLOCK_TOL}, mLSTM C, n < "
        f"{MLSTM_STATE_TOL}); contraction-scaled weights in f32: "
        + ", ".join(scaled) + f" (< {F32_FULL_TOL}); pipelined step from "
        f"prefill {S} (2 stages): sealed against the plain int8 round trip "
        f"{_rel(pipe16[1], pipe16[2]):.2e} bf16, {mirror32:.2e} f32 (< "
        f"{F32_LOGIT_TOL}), sealed against unsealed "
        f"{_rel(pipe16[1], pipe16[0]):.2e} bf16, "
        f"{_rel(pipe32[1], pipe32[0]):.2e} f32; the bf16 state (cache_quant) "
        f"against the f32 state over {XLSTM_STEPS} steps fed the same "
        f"tokens: top-1 agreement {agree}/{B * XLSTM_STEPS}, largest logit "
        f"difference {worst:.2e} of the largest |logit|; launches "
        f"{launches}; reduced checks {t_reduced:.1f} s [{smi}]")
    del pipe16, pipe32
    runs = [{"launches": launches}]
    local = serve_layout(torch, ops, api, params,
                         argv + ["--backend", "local"], "17a local, eager")
    graphs = serve_layout(torch, ops, api, params,
                          argv + ["--backend", "local", "--warmup"],
                          "17a local, CUDA graphs")
    assert graphs["streams"] == local["streams"], \
        "17a: the local streams differ under CUDA graphs"
    assert graphs["steps"] == local["steps"] and \
        graphs["launches"] == local["launches"]
    pipe = ["--backend", "pipelined", "--stages", "2", "--microbatches", "1",
            "--warmup"]
    plain = serve_layout(torch, ops, api, params, argv + pipe + ["--no-seal"],
                         "17a pipelined, unsealed, CUDA graphs")
    assert plain["streams"] == local["streams"], \
        "17a: unsealed pipelined streams differ from local"
    assert sum(plain["st"]["stage_blocks"]) == seg.n, plain["st"]
    sealed = serve_layout(torch, ops, api, params, argv + pipe,
                          "17a pipelined, sealed, CUDA graphs")
    assert sealed["launches"]["seal"] == sealed["launches"]["unseal"] \
        == sealed["steps"] > 0, (sealed["launches"], sealed["steps"])
    part = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
            for a, b in zip(sealed["streams"], local["streams"])]
    log(f"family phase 17a serving: local eager = local graphs = "
        f"pipelined unsealed ({len(local['streams'])} streams, stage "
        f"blocks {plain['st']['stage_blocks']} of {seg.n} pairs); sealed "
        f"run's first parting from local per request {part}; seal / unseal "
        f"launches {sealed['launches']['seal']} / "
        f"{sealed['launches']['unseal']} over {sealed['steps']} steps; ms "
        f"per decode step eager {local['step_ms']:.2f}, graphs "
        f"{graphs['step_ms']:.2f}, pipelined in graphs unsealed "
        f"{plain['step_ms']:.2f}, sealed {sealed['step_ms']:.2f}; tok/s "
        f"eager {local['st']['tok_per_s']:.1f}, graphs "
        f"{graphs['st']['tok_per_s']:.1f}; admission p50 / p99 ms eager "
        f"{local['st'].get('admission_p50_ms', 0):.1f} / "
        f"{local['st'].get('admission_p99_ms', 0):.1f}, graphs "
        f"{graphs['st'].get('admission_p50_ms', 0):.1f} / "
        f"{graphs['st'].get('admission_p99_ms', 0):.1f}; ms per prefill "
        f"token eager {local['token_ms']:.3f}, graphs "
        f"{graphs['token_ms']:.3f} [{smi}]")
    log(f"family phase 17a: {time.perf_counter() - t_phase:.1f} s")
    runs += [local, graphs, plain, sealed]
    del api, params
    _free(torch)
    return runs


def whisper_small_run(torch, api, params, toks, frames):
    """17b's paths on one reduced model: encode, prefill S (logits and
    both caches), decode one on the cache grown by 8 positions and on the
    prefill's own cache (the clamp), prefill S+1."""
    S = toks.shape[1] - 1
    mem = api.model.encode(params, frames)
    logits, cache = api.prefill_fn(params, {"tokens": toks[:, :S],
                                            "frames": frames})
    caches = list(_leaves({"kv": cache["kv"], "xkv": cache["xkv"]}))
    grown = dict(_clone(cache), kv=_grow(torch, cache["kv"], 8))
    dec, _ = api.decode_fn(params, grown, {"tokens": toks[:, S:]})
    clamped, _ = api.decode_fn(params, _clone(cache), {"tokens": toks[:, S:]})
    longer, _ = api.prefill_fn(params, {"tokens": toks, "frames": frames})
    return dict(mem=mem, logits=logits, dec=dec, clamped=clamped,
                longer=longer, caches=caches)


def whisper_reduced(torch, cfg):
    """17b on the reduced config in f32 (2 encoder and 4 decoder blocks,
    24 frames; the MLP biases drawn N(0, 0.1^2), as the CPU tests draw
    them), card against CPU, on the reference's init (printed: its
    stacked weights draw at std 1/sqrt(2) and 1/sqrt(4)) and on the same
    weights ``_contraction_scaled``: there ``whisper_small_run``'s
    outputs within F32_LOGIT_TOL of their largest |value|, and on the
    card decode on the grown cache against prefill S+1 within
    F32_LOGIT_TOL."""
    from repro_torch.configs import reduced
    from repro_torch.models.api import build_model
    rcfg = reduced(cfg)
    g = torch.Generator().manual_seed(0)
    rparams = build_model(rcfg, device="cpu", dtype=torch.float32,
                          max_seq=64).init(g)
    rparams = _draw_zeros(torch, rparams, ("bi", "bo"), g, 0.1)
    toks = torch.randint(0, rcfg.vocab_size, (SMALL_B, SMALL_S + 1),
                         generator=g)
    frames = torch.randn(SMALL_B, rcfg.encoder_seq, rcfg.d_model,
                         generator=g)
    notes = []
    for label, p in (("reference init", rparams),
                     ("contraction-scaled",
                      _contraction_scaled(rparams, ("enc", "dec")))):
        small = {}
        for device in ("cpu", DEV):
            api = build_model(rcfg, device=device, dtype=torch.float32,
                              max_seq=64)
            small[device] = whisper_small_run(
                torch, api, _to(torch, p, device), toks.to(device),
                frames.to(device))
        c, d = small["cpu"], small[DEV]
        worst = 0.0
        for x, y in ([(d[k], c[k]) for k in ("mem", "logits", "dec",
                                             "clamped", "longer")]
                     + list(zip(d["caches"], c["caches"]))):
            worst = max(worst, _rel(x.cpu(), y))
        cons = _rel(d["dec"], d["longer"])
        if label != "reference init":
            assert worst < F32_LOGIT_TOL and cons < F32_LOGIT_TOL, \
                (worst, cons)
        notes.append(f"{label}: card = CPU within {worst:.2e} of the "
                     f"largest |value|, on the card prefill S + decode one "
                     f"on the grown cache against prefill S+1 {cons:.2e}, "
                     f"on the prefill's own cache (the clamp) "
                     f"{_rel(d['clamped'], d['longer']):.2e}")
        del small
    log(f"family phase 17b reduced whisper-small ({rcfg.encoder_layers} + "
        f"{rcfg.num_layers} blocks, d_model {rcfg.d_model}, "
        f"{rcfg.encoder_seq} frames, f32, S={SMALL_S}), over encode, "
        f"prefill logits and caches, decode on the grown cache and on the "
        f"prefill's own, prefill S+1: " + "; ".join(notes)
        + f" (contraction-scaled < {F32_LOGIT_TOL})")
    del rparams
    _free(torch)


def whisper_block(torch, model, p, mem, g, S):
    """Decoder block 0 in f32 on seeded normal inputs [B, S+1, d] against
    ``mem``: prefill S then decode one on the self-attention cache grown
    by 8 positions, against prefill S+1 (its last position, and the first
    S). Returns the two relative differences."""
    B = mem.shape[0]
    x = torch.randn(B, S + 1, mem.shape[2], generator=g, device=mem.device)
    pos = torch.arange(S + 1, device=mem.device)[None, :]
    want = model._dec_block(p, x, pos, mem, mode="train")
    part, ((k, v), xkv) = model._dec_block(p, x[:, :S], pos[:, :S], mem,
                                           mode="prefill")
    kv = _grow(torch, (k, v), 8)
    xkv = tuple(t.contiguous() for t in xkv)
    n = torch.tensor(S, dtype=torch.int32, device=mem.device)
    got = model._dec_block(p, x[:, S:], pos[:, S:], None, mode="decode",
                           cache=kv, cache_len=n, xkv=xkv)
    return _rel(got[:, 0], want[:, S]), _rel(part, want[:, :S])


def family_whisper(torch, ops, smi):
    """17b. whisper-small: first ``whisper_reduced`` (f32, card against
    CPU), then at full width (12 encoder + 12 decoder blocks, d 768, 12
    heads x 64, vocab 51,865, 1500 frames, ``max_seq`` 448), bf16 then the
    same weights in f32: ``encode`` of B=2 seeded frame embeddings alone
    (12 flash launches, non-causal over 1500 frames), then ``prefill_fn``
    of 224 tokens (36 flash launches: the encoder's, the decoder's causal
    self-attention and its non-causal cross-attention of 224 queries over
    1500 keys), 16 greedy decode steps on the cache grown by 16 positions
    (decode writes at ``min(len, S - 1)``, so the prefill's own cache,
    exactly S long, would overwrite the prompt's last position), the first
    against prefill S+1, printed beside an embedding nudge's effect in
    f32. In f32 also: decoder block 0 alone (``whisper_block``, within
    BLOCK_TOL) and the model with ``_contraction_scaled`` weights, prefill
    S then decode one on the grown cache against prefill S+1 within
    F32_FULL_TOL. Prints encoder ms, prefill ms and ms per decode step.
    Returns the runs' launch counts."""
    from repro_torch.models.api import build_model
    t_phase = time.perf_counter()
    cfg = _family_cfg("whisper-small")
    whisper_reduced(torch, cfg)
    t_reduced = time.perf_counter() - t_phase
    api = build_model(cfg, device=DEV, dtype=torch.bfloat16,
                      max_seq=WHISPER_MAX_SEQ)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    _sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    B, S, L = WHISPER_B, WHISPER_S, cfg.num_layers
    g = torch.Generator(device=DEV).manual_seed(2)
    frames = torch.randn(B, cfg.encoder_seq, cfg.d_model, generator=g,
                         device=DEV)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g,
                         device=DEV)
    runs, notes = [], []
    for dtype in (torch.bfloat16, torch.float32):
        a = api if dtype == torch.bfloat16 else build_model(
            cfg, device=DEV, dtype=dtype, max_seq=WHISPER_MAX_SEQ)
        p = params if dtype == torch.bfloat16 else _to_f32(params)
        batch = {"tokens": toks[:, :S], "frames": frames}
        a.prefill_fn(p, batch)                     # first call, untimed
        ops.reset_launch_counts()
        _sync(torch)
        t0 = time.perf_counter()
        mem = a.model.encode(p, frames)
        _sync(torch)
        enc_ms = (time.perf_counter() - t0) * 1e3
        assert tuple(mem.shape) == (B, cfg.encoder_seq, cfg.d_model)
        assert torch.isfinite(mem).all()
        assert ops.LAUNCHES["flash_attention"] == cfg.encoder_layers
        t0 = time.perf_counter()
        logits, cache = a.prefill_fn(p, batch)
        _sync(torch)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        n_flash = ops.LAUNCHES["flash_attention"] - cfg.encoder_layers
        assert n_flash == cfg.encoder_layers + 2 * L, n_flash
        assert torch.isfinite(logits).all()
        assert [tuple(t.shape) for t in cache["xkv"]] == \
            [(L, B, cfg.num_kv_heads, cfg.encoder_seq, cfg.head_dim)] * 2
        longer, _ = a.prefill_fn(p, {"tokens": toks, "frames": frames})
        grown = dict(cache, kv=_grow(torch, cache["kv"], WHISPER_STEPS))
        tok, step_s = toks[:, S], 0.0
        for i in range(WHISPER_STEPS):
            _sync(torch)
            t0 = time.perf_counter()
            lg, grown = a.decode_fn(p, grown, {"tokens": tok[:, None]})
            _sync(torch)
            step_s += time.perf_counter() - t0
            assert torch.isfinite(lg).all()
            if i == 0:
                cons = _rel(lg, longer)
            tok = lg.argmax(-1)
        assert int(grown["len"]) == S + WHISPER_STEPS
        _sync(torch)
        launches = dict(ops.LAUNCHES)
        runs.append({"launches": launches})
        more = ""
        if dtype == torch.float32:
            moved, _ = a.prefill_fn(dict(p, embed=p["embed"] * (1 + 1e-6)),
                                    {"tokens": toks, "frames": frames})
            blk = whisper_block(torch, a.model, _at0(p["dec"]), mem, g, S)
            assert max(blk) < BLOCK_TOL, blk
            pc = _contraction_scaled(p, ("enc", "dec"))
            _, c2 = a.prefill_fn(pc, batch)
            c2 = dict(c2, kv=_grow(torch, c2["kv"], 8))
            d2, _ = a.decode_fn(pc, c2, {"tokens": toks[:, S:]})
            l2, _ = a.prefill_fn(pc, {"tokens": toks, "frames": frames})
            cons_c = _rel(d2, l2)
            assert cons_c < F32_FULL_TOL, cons_c
            more = (f" (an embedding nudged by 1e-6 moves prefill {S + 1} "
                    f"by {_rel(moved, longer):.2e}: printed); decoder block "
                    f"0 alone, decode one on the grown cache against "
                    f"prefill S+1 {blk[0]:.2e}, prefixes {blk[1]:.2e} (< "
                    f"{BLOCK_TOL}); contraction-scaled weights: {cons_c:.2e}"
                    f" (< {F32_FULL_TOL})")
            del moved, pc, c2, d2, l2
        notes.append(
            f"{str(dtype).split('.')[-1]}: encode {enc_ms:.2f} ms, prefill "
            f"(encode + decoder) {prefill_ms:.2f} ms, {n_flash} flash "
            f"launches a prefill, {step_s / WHISPER_STEPS * 1e3:.2f} ms per "
            f"decode step (eager), prefill {S} + decode one against prefill "
            f"{S + 1}: {cons:.2e}" + more + f"; launches {launches}")
        del a, p, cache, grown, longer, mem
        _free(torch)
    log(f"family phase 17b whisper-small full width: {cfg.encoder_layers} "
        f"+ {L} blocks, d_model {cfg.d_model}, {cfg.num_heads} heads x "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.encoder_seq} frames, "
        f"max_seq {WHISPER_MAX_SEQ}, {n_params / 1e6:.1f} M params bf16, "
        f"init {init_s:.1f} s; B={B} S={S}; " + "; ".join(notes)
        + f"; reduced checks {t_reduced:.1f} s [{smi}]")
    log(f"family phase 17b: {time.perf_counter() - t_phase:.1f} s")
    del api, params
    _free(torch)
    return runs


# ---------------------------------------------------------------------------
# phase 18: the mesh, the sharding trees, the serve steps, the calibration
# and the dry-run (ROADMAP item 12) on full-width llama3.2-1b. Sizes are
# names, for a CPU rehearsal as phases 16 and 17.
MESH_B, MESH_S, MESH_STEPS = 8, 512, 16
# (eff, act_scale) of ``hlo_calibration(cfg, 1, count)`` for the decode
# step of full-width llama3.2-1b at batch 1 over a cache of MESH_S +
# MESH_STEPS positions, counted on meta tensors on the CPU
# (``utils.cost_analysis.cost_summary``; the count reads shapes only, so
# the card's meta count must give these bits)
CALIB_CPU = (0.7660441601320677, 2.6914203317162406)


def _tree_equal(torch, a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def mesh_steps(torch, ops, smi):
    """18. The mesh and the serve steps on full-width llama3.2-1b in bf16
    (seeded weights): (a) ``make_mesh((1, 1), ("data", "model"))`` is a
    real one-rank ``DeviceMesh`` on the card; every param, cache and batch
    leaf resolves to replicated and the per-device argument bytes equal
    the tensors' total; (b) ``make_prefill_step`` at ``ShapeConfig("p18",
    MESH_S, MESH_B, "prefill")`` (16 flash launches), then
    ``make_decode_step`` for MESH_STEPS greedy steps on the cache grown by
    MESH_STEPS positions: logits and caches bit-equal to
    ``api.prefill_fn`` / ``api.decode_fn`` called on a copy, host ms per
    prefill and per decode step between synchronises; (c) the decode step
    at batch 1 counted on meta tensors: ``hlo_calibration`` must give
    CALIB_CPU, and the same step counted on the card's tensors the same
    FLOPs; the engine's plan over its default topology with and without
    the calibration; (d) ``dryrun.main`` over every llama3.2-1b cell on
    the logical 16 x 16 mesh, rc 0. Returns the step run's launch counts
    (the prefill and decode steps only)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.planner.profiling import (hlo_calibration,
                                                    profiles_from_arch)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models.api import build_model
    from repro_torch.runtime import steps as S
    from repro_torch.runtime.ft import OnlineReplanner
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.engine import block_profiles
    from repro_torch.enclave.domain import two_enclave_manager
    from repro_torch.sharding import rules as R
    from repro_torch.utils.cost_analysis import cost_summary
    t_phase = time.perf_counter()
    cfg = _family_cfg("llama3.2-1b")
    B, Sq, steps, L = MESH_B, MESH_S, MESH_STEPS, cfg.num_layers
    # (a) the mesh and the trees
    mesh = make_mesh((1, 1), ("data", "model"), device=DEV)
    assert isinstance(mesh, DeviceMesh) and mesh.device_type == DEV, mesh
    assert dist.get_world_size() == 1, dist.get_world_size()
    api = build_model(cfg, device=DEV, dtype=torch.bfloat16,
                      max_seq=Sq + steps)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    pre_shape = ShapeConfig("p18", Sq, B, "prefill")
    dec_shape = ShapeConfig("d18", Sq + steps, B, "decode")
    trees = [S.param_shardings(api, mesh),
             S.batch_shardings(api, pre_shape, mesh),
             S.batch_shardings(api, dec_shape, mesh),
             S.zip_specs(lambda s, a: R.logical_sharding(
                 s[0], a, mesh, R.ACT_RULES),
                 api.init_cache_specs(B, Sq + steps),
                 api.init_cache_axes(B, Sq + steps))]
    n_leaves = 0
    for tree in trees:
        for sh in _sharding_leaves(tree):
            assert sh.is_replicated, sh
            n_leaves += 1
    g = torch.Generator(device=DEV).manual_seed(18)
    toks = torch.randint(0, cfg.vocab_size, (B, Sq), generator=g,
                         device=DEV, dtype=torch.int32)
    batch = {"tokens": toks}
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    mem = dryrun.memory(api, pre_shape, mesh, R.ACT_RULES, R.PARAM_RULES)
    assert mem["argument_bytes"] == total + toks.numel() * 4, \
        (mem["argument_bytes"], total)
    # (b) the serve steps against the direct calls on a copy
    prefill_step = S.make_prefill_step(api, mesh, pre_shape)
    decode_step = S.make_decode_step(api, mesh, dec_shape)
    prefill_step(params, batch)                    # first call, untimed
    _sync(torch)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, batch)
    _sync(torch)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    assert ops.LAUNCHES["flash_attention"] == L, ops.LAUNCHES
    prefill_out = (logits.clone(), _clone(cache))
    cache = dict(cache, blocks=_grow(torch, cache["blocks"], steps))
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    # first call, untimed, on a copy (the timeline decode runs no kernel)
    decode_step(params, _clone(cache), {"tokens": tok})
    step_logits, step_s = [], 0.0
    for _ in range(steps):
        _sync(torch)
        t0 = time.perf_counter()
        lg, cache = decode_step(params, cache, {"tokens": tok})
        _sync(torch)
        step_s += time.perf_counter() - t0
        assert torch.isfinite(lg).all()
        step_logits.append(lg.clone())
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    launches = dict(ops.LAUNCHES)
    assert launches["flash_attention"] == L, launches
    ref_logits, ref_cache = api.prefill_fn(params, batch)
    assert torch.equal(ref_logits, prefill_out[0])
    assert _tree_equal(torch, ref_cache, prefill_out[1])
    ref_cache = dict(ref_cache, blocks=_grow(torch, ref_cache["blocks"],
                                             steps))
    tok = ref_logits.argmax(-1)[:, None].to(torch.int32)
    for lg_step in step_logits:
        lg, ref_cache = api.decode_fn(params, ref_cache, {"tokens": tok})
        assert torch.equal(lg, lg_step)
        tok = lg.argmax(-1)[:, None].to(torch.int32)
    assert _tree_equal(torch, ref_cache, cache)
    assert int(cache["len"]) == Sq + steps
    del ref_cache, prefill_out, step_logits
    # (c) calibration: the decode step at batch 1, counted
    c_shape = ShapeConfig("c18", Sq + steps, 1, "decode")
    meta_api = build_model(cfg, device="meta", max_seq=Sq + steps)
    ab = S.abstract_inputs(meta_api, c_shape)
    count = cost_summary(S.make_decode_step(meta_api, None, c_shape),
                         ab["params"], ab["cache"], ab["batch"])
    calib = hlo_calibration(cfg, 1, count)
    if FAMILY_ARCH is None:
        assert calib == CALIB_CPU, (calib, CALIB_CPU)
    # the same step on the card's tensors: nothing of it runs a ctypes
    # kernel (timeline decode attention is plain), so the count is equal
    one = api.init_cache(1, Sq + steps, fill_len=Sq)
    on_dev = cost_summary(S.make_decode_step(api, mesh, c_shape), params,
                          one, {"tokens": tok[:1]})
    assert on_dev == count, (on_dev, count)
    ec = EngineConfig()
    profiles = {}
    for name, kw in (("constants", {}),
                     ("calibrated", {"calibrate_from_hlo": True,
                                     "compiled": count})):
        profiles[name] = block_profiles(
            profiles_from_arch(cfg, seq_len=1, **kw), L)
    plans = {}
    for name, prof in profiles.items():
        rp = OnlineReplanner(two_enclave_manager(), prof, n=ec.plan_n,
                             delta=ec.delta, solver=ec.solver,
                             space=ec.space, min_stages=ec.num_stages)
        spec = rp.plan()
        assert rp.current.feasible, (name, rp.current)
        plans[name] = f"{spec.describe()}, t_chunk {rp.current.t_chunk!r} s"
    assert profiles["calibrated"][0].eff == calib[0]
    # (d) the dry-run over every llama3.2-1b cell on the 16 x 16 mesh
    t0 = time.perf_counter()
    assert R.mesh_size(make_production_mesh()) == 256
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "all"])
    dry_s = time.perf_counter() - t0
    log(f"phase 18 mesh + serve steps, llama3.2-1b ({L} layers, "
        f"{cfg.d_model} wide) bf16: mesh {mesh} on {DEV}, {n_leaves} "
        f"leaves replicated, per-device argument bytes "
        f"{mem['argument_bytes']} = total; prefill step B={B} S={Sq}: "
        f"{prefill_ms:.2f} ms host, "
        f"{launches['flash_attention']} flash launches; {steps} decode "
        f"steps: {step_s / steps * 1e3:.3f} ms per step host; logits and "
        f"caches bit-equal to prefill_fn / decode_fn [{smi}]")
    log(f"phase 18c calibration: decode step B=1 over {Sq + steps} "
        f"positions counted on meta: {count['flops']:.6e} FLOPs, "
        f"{count['bytes']:.6e} bytes (the card's tensors: equal); "
        f"(eff, act_scale) = {calib} (CPU {CALIB_CPU}); plan with the "
        f"constants: {plans['constants']}; calibrated: "
        f"{plans['calibrated']} (model outputs on the reference's device "
        f"profiles, not measurements)")
    log(f"phase 18d dry-run llama3.2-1b on the logical 16 x 16 mesh: rc 0, "
        f"{dry_s:.1f} s")
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    del api, params, cache, one
    dist.destroy_process_group()
    _free(torch)
    return [{"launches": launches}]


# ---------------------------------------------------------------------------
# phase 19: the pod axis over ranks (ROADMAP item 10a). Ranks are processes
# on the one card (``launch.ranks.spawn``), joined by gloo: NCCL refuses
# two ranks on one device. Sizes are names, for a CPU rehearsal as phases
# 16 to 18.
# 19a at llama3.2-1b's full width, its depth cut from 16 layers to 8 and
# its decode steps from 16 to 8 (the script's time, with phase 24 added),
# then to 4 layers (with phase 26 added)
RANKS_SLOTS, RANKS_NM, RANKS_PROMPT, RANKS_STEPS = 8, 4, 128, 8
RANKS_LAYERS = 4
RANKS_LAYOUTS = ((2, 2), (1, 3))       # even, and one layer on stage 0
RANKS_KEY = 0xC0FFEE
RANKS_PING = 50                        # round trips of one boundary
# 19b: the compressed step at pods 2 x data 1 over a global batch of
# 8 x 128 (4 rows a pod), full width, depth cut from 16 layers to 4, its
# steps from 5 to 3 (the script's time, with phase 26 added)
RANKS_TRAIN = dict(steps=3, batch=8, seq=128)
RANKS_TRAIN_LAYERS = 4
# 19c: reduced llama3.2-1b in f32 on (2, 2) ranks, card against CPU
RANKS_SMALL = dict(steps=3, batch=8, seq=32)
# card against CPU: losses within rtol RANKS_TOL at every step. The plain
# step's params within RANKS_TOL of each leaf's largest |value| at all but
# RANKS_SHARE of its elements: AdamW's first steps move an element by
# about lr whatever its gradient's size, so a rounding-level gradient (an
# embedding row of a rare token) can point either way (0.452% of the
# embedding on an H100 against its machine's CPU). The compressed step's
# int8 exchange turns rounding-level gradient differences into whole
# quantization steps at rounding ties, which AdamW's next steps move by
# up to lr (on the CPU a 1e-7 nudge of the weights moves 3% of a norm's
# elements past 1e-4 in three steps), so its params are held within
# twice the CPU run's largest move, and its error feedback after step 1
# (equal weights: lr is 0 at step 0) within RANKS_EF_TOL of its largest
# |value| at all but RANKS_EF_SHARE of the elements (a tie moves one by
# a whole scale)
RANKS_TOL, RANKS_SHARE = 1e-4, 1e-2
RANKS_EF_TOL, RANKS_EF_SHARE = 2.5e-2, 5e-3


def _ranks_decode(torch, api, params, layouts, steps):
    """19a's one-card path: a prefill of RANKS_SLOTS x RANKS_PROMPT seeded
    tokens, its K/V on pages, then for each layout RANKS_STEPS greedy
    steps of the sealed one-card ``PipelinedDecoder`` from a copy of the
    pages. Returns (first tokens, the CPU pages, {layout: (logits,
    tokens, host ms a step)})."""
    from repro_torch.runtime.pipeline import PipelinedDecoder
    g = torch.Generator(device=DEV).manual_seed(19)
    toks = torch.randint(0, api.cfg.vocab_size, (RANKS_SLOTS, RANKS_PROMPT),
                         generator=g, device=DEV, dtype=torch.int32)
    logits, caches = api.prefill_fn(params, {"tokens": toks})
    first = logits.argmax(-1)[:, None].to(torch.int32)
    pages = _paged_from(torch, api, caches, RANKS_PROMPT, steps)
    del caches
    out = {}
    for blocks in layouts:
        dec = PipelinedDecoder(api, num_stages=2,
                               num_microbatches=RANKS_NM,
                               seal_boundary=True, stage_blocks=blocks)
        step = dec.build(paged=True)
        cache = _clone(pages)
        tok, lgs, tks, ms = first, [], [], []
        for i in range(steps):
            _sync(torch)
            t0 = time.perf_counter()
            lg, cache = step(params, cache, {"tokens": tok}, RANKS_KEY + i)
            _sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
            lgs.append(lg.cpu())
            tks.append(tok[:, 0].cpu())
        out[blocks] = (lgs, tks, ms)
        del cache
    return first.cpu(), {k: (tuple(t.cpu() for t in v)
                             if isinstance(v, tuple) else v.cpu())
                         for k, v in pages.items()}, out


def _held_share(torch, got, want, tol, share, what):
    """``got`` within ``tol`` of each leaf's largest |value| of ``want``
    at all but ``share`` of the elements; returns the worst share."""
    worst = 0.0
    for g, w in zip(_leaves(got), _leaves(want)):
        g, w = g.double(), w.double()
        off = float(((g - w).abs() > tol * w.abs().max()).double().mean())
        assert off <= share, (what, off)
        worst = max(worst, off)
    return worst


def _beside(fn, *args, **kw):
    """Start ``fn(*args, **kw)`` on a thread; returns a function that
    waits for it and returns its result or raises its exception."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kw)
        except BaseException as e:       # re-raised by the caller's wait
            box["err"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def wait():
        th.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return wait


def pod_ranks(torch, ops, smi):
    """19. The pod axis over ranks on the card, ranks spawned on ``cuda:0``
    over gloo (the parent's models freed first):
    (a) full-width llama3.2-1b in bf16 at RANKS_LAYERS layers (seeded
    weights, every rank draws the same), 8 slots, 4 microbatches, paged,
    sealed, RANKS_STEPS greedy decode steps on 2 pod ranks at stage
    blocks RANKS_LAYOUTS from one prefill (the parent's): logits and
    tokens bit-equal to the
    one-card sealed ``PipelinedDecoder``; seal launches on stage 0 and
    unseal launches on stage 1 each microbatches x steps, paged launches
    the stage's layers x microbatches x steps; host ms a step, sealed
    bytes a boundary a step and one boundary crossing's host ms;
    (b) the compressed train step of full-width llama3.2-1b in bf16 at
    RANKS_TRAIN_LAYERS layers, pods 2 x data 1, global batch 8 x 128, 3
    steps: losses finite, both
    ranks' params the same bits after every step (``param_digest``), the
    error feedback finite and nonzero, flash launches a rank 2 x layers x
    steps, bytes sent a step sum(numel + 4) against 4 x sum(numel)
    uncompressed, host ms a step and each rank's peak memory;
    (c) reduced llama3.2-1b in f32 on (2, 2) ranks, the plain and the
    compressed step: the card against the same ranks on the CPU (the two
    spawns side by side), held as the constants above say. (a) and (b)
    share one spawn. Returns the runs' launch counts (the ranks' own,
    summed)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import rank_jobs
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.launch.ranks import spawn
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import exchanged_bytes
    from repro_torch.runtime import steps as S
    t_phase = time.perf_counter()
    backend = "gloo"
    log(f"phase 19: ranks are processes on {DEV} (cuda:0 on the card), "
        f"backend={backend} (NCCL refuses two ranks on one device)")
    _free(torch)
    import dataclasses
    full = _family_cfg("llama3.2-1b")
    cfg = dataclasses.replace(full, num_layers=min(RANKS_LAYERS,
                                                   full.num_layers))
    L = cfg.num_layers
    layouts = RANKS_LAYOUTS if FAMILY_ARCH is None else ((L // 2, L // 2),
                                                         (1, L - 1))
    # (a) the one-card reference, then the ranks
    api = build_model(cfg, device=DEV, dtype=torch.bfloat16)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    first, pages, one = _ranks_decode(torch, api, params, layouts,
                                      RANKS_STEPS)
    del api, params
    _free(torch)
    t0 = time.perf_counter()
    job = rank_jobs.DecodeJob(cfg, ((2, 1), ("pod", "data")), pages, first,
                              layouts=layouts, seals=(True,),
                              num_microbatches=RANKS_NM, steps=RANKS_STEPS,
                              key=RANKS_KEY, dtype=torch.bfloat16, seed=0,
                              ping_iters=RANKS_PING)
    # (b)'s ranks are (a)'s: one spawn runs both
    tcfg = dataclasses.replace(full, num_layers=min(RANKS_TRAIN_LAYERS,
                                                    full.num_layers))
    tj = rank_jobs.TrainJob(
        tcfg, ((2, 1), ("pod", "data")), RANKS_TRAIN["steps"],
        RANKS_TRAIN["batch"], RANKS_TRAIN["seq"],
        opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                        total_steps=RANKS_TRAIN["steps"]),
        compressed=True, dtype=torch.bfloat16, seed=0, keep=())
    both = spawn(rank_jobs.chain, 2, backend=backend, device=DEV,
                 args=([(rank_jobs.decode, job), (rank_jobs.train, tj)],))
    dec_ranks, tr = [b[0] for b in both], [b[1] for b in both]
    ab_s = time.perf_counter() - t0
    launches = {k: 0 for k in ops.LAUNCHES}
    rows = RANKS_SLOTS // RANKS_NM
    for li, blocks in enumerate(layouts):
        lgs, tks, ms = one[blocks]
        per_rank = []
        for rank, res in enumerate(dec_ranks):
            r = res[li]
            assert r["stage"] == rank and r["range"][1] - r["range"][0] \
                == blocks[rank], (r["stage"], r["range"], blocks)
            for i in range(RANKS_STEPS):
                assert torch.equal(r["logits"][i], lgs[i]), \
                    ("19a: logits differ from the one-card decoder",
                     blocks, rank, i)
                assert torch.equal(r["tokens"][i], tks[i]), (blocks, rank, i)
            n = RANKS_NM * RANKS_STEPS
            lc = r["launches"]
            if DEV == "cuda":
                assert lc["seal"] == (n if rank == 0 else 0), lc
                assert lc["unseal"] == (n if rank == 1 else 0), lc
                assert lc["paged_attention"] == blocks[rank] * n, lc
            for k in launches:
                launches[k] += lc[k]
            want_bytes = RANKS_NM * rows * (cfg.d_model + 4) \
                if rank == 0 else 0
            assert r["sent_per_step"] == want_bytes, r["sent_per_step"]
            per_rank.append(sum(r["host_ms"][1:]) / (RANKS_STEPS - 1))
        log(f"phase 19a llama3.2-1b ({L} layers) bf16, stage blocks "
            f"{blocks} on 2 ranks, {RANKS_NM} microbatches of {rows} rows, "
            f"paged, sealed, {RANKS_STEPS} steps: logits and tokens "
            f"bit-equal to the one-card PipelinedDecoder; host ms a step "
            f"(steps 2-{RANKS_STEPS}) rank 0 {per_rank[0]:.3f}, rank 1 "
            f"{per_rank[1]:.3f}, one card {sum(ms[1:]) / (len(ms) - 1):.3f};"
            f" sealed bytes a boundary a step "
            f"{RANKS_NM * rows * (cfg.d_model + 4)} (raw bf16 would be "
            f"{RANKS_NM * rows * cfg.d_model * 2}); launches rank 0 "
            f"{dec_ranks[0][li]['launches']}, rank 1 "
            f"{dec_ranks[1][li]['launches']} [{smi}]")
    ping = [res[-1]["boundary"] for res in dec_ranks]
    copies = " / ".join(f"{p['copy_ms']:.4f} ms" for p in ping
                        if "copy_ms" in p) or "not measured (CPU)"
    log(f"phase 19a: one sealed microbatch ({rows} x {cfg.d_model} cipher "
        f"bytes + {rows} scales) across the boundary, card to pinned host "
        f"to gloo to pinned host to card: {ping[0]['ms']:.4f} / "
        f"{ping[1]['ms']:.4f} ms (rank 0 / rank 1, mean of {RANKS_PING} "
        f"round trips); the same message between host tensors (gloo "
        f"alone) {ping[0]['host_ms']:.4f} / {ping[1]['host_ms']:.4f} ms; "
        f"the card-to-pinned and pinned-to-card copies of it {copies}; "
        f"the spawn with its {len(layouts)} runs and (b) {ab_s:.1f} s")
    del dec_ranks, one, pages
    # (b) the compressed step at full width over two pods
    cfg, L = tcfg, tcfg.num_layers
    meta = build_model(cfg, device="meta", dtype=torch.float32)
    numel = sum(p.numel() for p in _leaves(meta.abstract_params()))
    sent = exchanged_bytes(meta.abstract_params())
    for rank, r in enumerate(tr):
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        assert r["digests"] == tr[0]["digests"], \
            ("19b: the pods' params differ", rank)
        assert r["losses"] == tr[0]["losses"]
        assert r["ef_finite"] and r["ef_nonzero"] > 0, r
        if DEV == "cuda":
            assert r["launches"]["flash_attention"] == \
                2 * L * RANKS_TRAIN["steps"], r["launches"]
        assert r["sent_per_step"] == sent, (r["sent_per_step"], sent)
        for k in launches:
            launches[k] += r["launches"][k]
    peaks = [r.get("peak_bytes", 0) / 2**30 for r in tr]
    log(f"phase 19b compressed train step, llama3.2-1b full width ({L} "
        f"layers) bf16 "
        f"(new params f32 from step 1, as the reference's update casts to "
        f"the reduced gradient's dtype), pods 2 x data 1, global batch "
        f"{RANKS_TRAIN['batch']} x {RANKS_TRAIN['seq']}, "
        f"{RANKS_TRAIN['steps']} steps: losses "
        f"{[round(x, 4) for x in tr[0]['losses']]}, both ranks' params "
        f"equal after every step, ef max |value| {tr[0]['ef_absmax']:.3e}, "
        f"{tr[0]['ef_nonzero']} of {numel} nonzero; bytes sent a step "
        f"{sent} (int8 + a scale a leaf) against {4 * numel} in f32; "
        f"host ms a step rank 0 {[round(x, 1) for x in tr[0]['host_ms']]}, "
        f"rank 1 {[round(x, 1) for x in tr[1]['host_ms']]}; flash "
        f"launches a rank {tr[0]['launches']['flash_attention']}; peak "
        f"allocated {peaks[0]:.2f} / {peaks[1]:.2f} GiB; in (a)'s spawn "
        f"[{smi}]")
    del tr
    # (c) reduced, f32, (2, 2) ranks: the card against the CPU
    t0 = time.perf_counter()
    small = reduced(get_arch("llama3.2-1b"))
    sapi = build_model(small, device="cpu", dtype=torch.float32)
    sparams = sapi.init(torch.Generator().manual_seed(0))
    mesh = ((2, 2), ("pod", "data"))
    jobs = [rank_jobs.TrainJob(
        small, mesh, RANKS_SMALL["steps"],
        RANKS_SMALL["batch"], RANKS_SMALL["seq"],
        opt=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10),
        compressed=c, params=sparams) for c in (False, True)]
    # the CPU's ranks run beside the card's (their own store and group)
    on_cpu = _beside(spawn, rank_jobs.train_each, 4, backend=backend,
                     device="cpu", args=(jobs,))
    on_card = spawn(rank_jobs.train_each, 4, backend=backend, device=DEV,
                    args=(jobs,))
    on_cpu = on_cpu()
    worst, ef_worst, moved = {}, 0.0, 0.0
    for i, c in enumerate((False, True)):
        for rank in range(4):
            card, cpu = on_card[rank][i], on_cpu[rank][i]
            for x, y in zip(card["losses"], cpu["losses"]):
                assert abs(x - y) <= RANKS_TOL * abs(y), (c, rank, x, y)
            worst[c] = max(worst.get(c, 0.0), _held_share(
                torch, card["params"], cpu["params"], RANKS_TOL,
                1.0 if c else RANKS_SHARE, f"19c compressed={c} {rank}"))
            for k in launches:
                launches[k] += card["launches"][k]
            if not c:
                continue
            ef_worst = max(ef_worst, _held_share(
                torch, card["ef_steps"][0], cpu["ef_steps"][0],
                RANKS_EF_TOL, RANKS_EF_SHARE, f"19c ef, rank {rank}"))
            # the rank's blocks of the draw (every embed dim over data)
            first = S.shard_params(sapi, LogicalMesh(*mesh), sparams,
                                   coords=_rank_coords(rank, mesh))
            for g, w, p0 in zip(_leaves(card["params"]),
                                _leaves(cpu["params"]), _leaves(first)):
                d, m = float((g - w).abs().max()), float((w - p0).abs().max())
                assert d <= 2 * m, ("19c: compressed params apart", d, m)
                moved = max(moved, d / m)
    log(f"phase 19c reduced llama3.2-1b f32 on (2, 2) pod x data ranks, "
        f"{RANKS_SMALL['steps']} steps of batch {RANKS_SMALL['batch']} x "
        f"{RANKS_SMALL['seq']}: card against CPU, losses within rtol "
        f"{RANKS_TOL} (plain {on_card[0][0]['losses']} vs "
        f"{on_cpu[0][0]['losses']}; compressed {on_card[0][1]['losses']} vs "
        f"{on_cpu[0][1]['losses']}); params past {RANKS_TOL} of their "
        f"leaf's largest |value| at {worst[False]:.5f} (plain) and "
        f"{worst[True]:.5f} (compressed, at most {moved:.3f} of the CPU "
        f"run's largest move) of a leaf's elements at most; the compressed "
        f"step's error feedback after step 1 past {RANKS_EF_TOL} at "
        f"{ef_worst:.5f}; {time.perf_counter() - t0:.1f} s")
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return [{"launches": launches}]


# ---------------------------------------------------------------------------
# the engine over ranks (phases 21 to 23 and 27; phase 20, the engine on 2
# pod ranks, was cut for the script's time): phase 6's flags, its
# straggler, and the cut of its stream the live re-plans serve (the swap
# comes within its first requests)
RANKS_SERVE = FULL_WIDTH + ["--backend", "pipelined"]      # phase 6's flags
RANKS_STRAGGLER = (1, 10.0)          # serve's --inject-straggler 1:10
RANKS_REPLAN_REQUESTS = 8


def _p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


# phase 21: the data axis over ranks (ROADMAP item 10d, steps 1-2): phase
# 6's stream on a 2 x 2 pod x data mesh, the reference's engine layout,
# and the serve steps over the same mesh at phase 18's shapes; four gloo
# ranks on the one card, in one spawn
DATA_MESH = (2, 2)
# 21b's decode steps: each gathers the params' data blocks over gloo (1.24
# GB a rank, 3.26 to 4.88 s a step on an H100 80GB HBM3 at 700.00 W), so
# 21b runs one, not phase 18's MESH_STEPS
DATA_STEPS = 1
# 21's check of the row split: one stage's decode step at 4 rows (phase
# 6's microbatch) against its two 2-row halves (a data rank's), after a
# prefill of DATA_PROMPT tokens a row
DATA_PROMPT = 32


def _split_bits(torch, api, params):
    """Whether one stage's decode step at 4 rows equals its two 2-row
    halves bit for bit: stage 0 (layer 0) and stage 1 (layers 1-15) of
    phase 6's plan over a paged cache from a prefill of 4 seeded prompts,
    then the f32 head (cuBLAS may take another kernel for a 2-row
    product than for a 4-row one). Returns the count of differing
    elements and the largest difference of the outputs, per part."""
    from repro_torch.runtime.pipeline import PipelinedDecoder
    L = api.cfg.num_layers
    g = torch.Generator(device=DEV).manual_seed(21)
    toks = torch.randint(0, api.cfg.vocab_size, (4, DATA_PROMPT),
                         generator=g, device=DEV, dtype=torch.int32)
    _, caches = api.prefill_fn(params, {"tokens": toks})
    pages = _paged_from(torch, api, caches, DATA_PROMPT, 1)
    del caches
    dec = PipelinedDecoder(api, 2, 1, stage_blocks=(1, L - 1))
    run = dec.build_stage_probe(paged=True)
    seg = api.model.served_segment.name
    x = api.model.embed(params, toks[:, -1:])
    out = {}
    for s in range(2):
        whole = run(params, _clone(pages)[seg], s, x,
                    pages["block_tables"], pages["seq_lens"])
        halves = torch.cat([run(params, _clone(pages)[seg], s, x[i:i + 2],
                                pages["block_tables"][i:i + 2],
                                pages["seq_lens"][i:i + 2])
                            for i in (0, 2)])
        out[f"stage {s}"] = whole, halves
        x = whole
    head = api.model.head(params, x)
    out["head"] = head, torch.cat([api.model.head(params, x[i:i + 2])
                                   for i in (0, 2)])
    return {k: (int((a != b).sum()), float((a.float() - b.float()).abs()
                                           .max()))
            for k, (a, b) in out.items()}


def _first_step_logits(torch, api, params, argv, microbatches):
    """The one-card pipelined engine on ``argv``'s stream at
    ``microbatches`` microbatches, driven to its first decode step:
    that step's logits (on the CPU)."""
    from repro_torch.launch import rank_jobs, serve
    args = serve.build_parser().parse_args(
        argv + ["--microbatches", str(microbatches)])
    eng = serve.make_engine(api, params, args)
    probe = rank_jobs.Probe(eng, 1)
    prompts = serve.gen_prompts(args, api.cfg.vocab_size)
    k = 0
    while not probe.logits:
        if k < len(prompts) and eng.steps % args.arrival_every == 0:
            eng.submit(prompts[k], args.max_new)
            k += 1
        eng.step()
    return probe.logits[0]


def serve_data_ranks(torch, ops, smi, phase6=None, also=None):
    """21. The data axis over ranks, ``make_mesh((2, 2), ("pod",
    "data"))`` on four gloo ranks spawned on the card in one spawn (the
    reference's own engine layout, ``tests/test_serving.py:392``):
    (a) ``ServingEngine(mesh=)`` serves phase 6's stream (full-width
    llama3.2-1b in bf16, pipelined (1, 15), sealed, 8 slots, 2
    microbatches, so 2 rows a data rank, 30 pages): swap-outs > 0 and
    every swap-in restored bit for bit on every rank; the two data ranks
    of each pod end with equal cache digests; no (key, counter) pair
    sealed twice over the four ranks; seals on (pod 0, d) = unseals on
    (pod 1, d) = microbatches x decode steps; per rank paged launches =
    its layers x (microbatches x steps, + its stage probes on data rank
    0), flash = its layers x prefill calls, the windowed cipher 2 x
    swap-outs on data rank 0 and its inverse 2 x swap-ins on every rank,
    the whole-row cipher one crossing a prefill call on pod 0 plus one KV
    exchange a decode step (its inverse the same on pod 1's side). The
    streams: the phase first holds one stage's decode step at 4 rows
    against its 2-row halves (``_split_bits``); if they agree the streams
    must equal phase 6's, and (c) data rank 0 of each pod seals its pod's
    part of a swap, the parts side by side phase 6's first payload byte
    for byte with its ``payload_digest`` (phase 20 held this on two pod
    ranks before it was cut: 21, 22 and 27a serve over the pod axis); if
    not, each data rank's first decode step's
    logits must equal the one-card engine's at 4 microbatches (2-row
    stage calls) bit for bit, and the phase prints how many of the 16
    streams equal phase 6's. (b) ``make_prefill_step`` at 8 x MESH_S and
    DATA_STEPS ``make_decode_step`` calls over MESH_S + DATA_STEPS
    positions over the same ranks, each holding its blocks of the params
    over data (the reference's FSDP; half the bytes, each layer gathered
    before use): each rank's logits rows and cache rows bit-equal to the
    one-card ``prefill_fn`` / ``decode_fn`` on its 2 rows, the whole [8,
    V] logits the same on every rank. Prints host ms
    a decode step on each rank beside phase 6's,
    admission p50 / p99, the KV exchange's bytes and host ms a step, a
    prefill crossing's host ms and bytes, swap-out and swap-in host ms a
    rank and the serve steps' host ms and gather bytes. Returns the ranks'
    launch counts, summed, phase 21's eager figures (``eager``) and, for
    ``also`` (``warm_jobs``' jobs and context, run in the same spawn after
    21's: one start-up for both phases), their results a rank and the
    context (``also``)."""
    import numpy as np

    from repro_torch.enclave import sealing
    from repro_torch.launch import rank_jobs, serve
    from repro_torch.launch.ranks import spawn
    from repro_torch.models.api import build_model
    from repro_torch.tree import map_tree
    t_phase = time.perf_counter()
    _free(torch)
    argv = [DEV if a == "cuda" else a for a in RANKS_SERVE]
    args = serve.build_parser().parse_args(argv)
    cfg = _family_cfg("llama3.2-1b")
    api = build_model(cfg, device=DEV, dtype=torch.bfloat16)
    params = api.init(torch.Generator(device=DEV).manual_seed(args.seed))
    if phase6 is None:                    # run alone: phase 6 first
        phase6 = serve_full_width(torch, ops, api, params, argv, 6,
                                  plan=(1, cfg.num_layers - 1))
    L, nm = cfg.num_layers, args.microbatches
    P, D = DATA_MESH
    split = _split_bits(torch, api, params)
    halves_equal = all(n == 0 for n, _ in split.values())
    log(f"phase 21: one stage's decode step at 4 rows against its two "
        f"2-row halves (differing elements, largest difference): "
        f"{split}; {'bit-equal' if halves_equal else 'NOT bit-equal'}")
    reqs = [(p, args.max_new)
            for p in serve.gen_prompts(args, cfg.vocab_size)]
    run = rank_jobs.ServeRun(serve.make_config(args), reqs,
                             every=args.arrival_every, check_swaps=True,
                             keep_logits=1)
    g = torch.Generator(device=DEV).manual_seed(18)
    toks = torch.randint(0, cfg.vocab_size, (MESH_B, MESH_S), generator=g,
                         device=DEV, dtype=torch.int32)
    steps_job = rank_jobs.StepsJob(cfg, (DATA_MESH, ("pod", "data")),
                                   toks.cpu(), steps=DATA_STEPS,
                                   dtype=torch.bfloat16, seed=args.seed)
    _free(torch)
    t0 = time.perf_counter()
    more = list(also[0]) if also else []
    out = spawn(rank_jobs.chain, P * D, backend="gloo", device=DEV, args=([
        (rank_jobs.serve, rank_jobs.ServeJob(cfg, [run],
                                             dtype=torch.bfloat16,
                                             seed=args.seed, data=D)),
        (rank_jobs.serve_steps, steps_job)] + more,))
    spawn_s = time.perf_counter() - t0
    later = ([res[2:] for res in out], also[1]) if also else None
    a = [res[0][0] for res in out]
    b = [res[1] for res in out]
    launches = {k: 0 for k in ops.LAUNCHES}
    for r in a + b:
        for k in launches:
            launches[k] += r["launches"][k]
    # (a) phase 6's stream on the 2 x 2 ranks
    assert [(r["stage"], r["data"]) for r in a] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    st = a[0]["stats"]
    for r in a[1:]:
        assert r["events"] == a[0]["events"] and r["stats"] == st
    bad = rank_jobs.keystream_reuse([r["keys"] for r in a])
    assert not bad, ("21a: a (key, counter) pair ciphered twice", bad[:3])
    assert st["stage_blocks"] == (1, L - 1) and st["swaps"] == 0, st
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0, st
    for pod in range(P):
        digests = {r["data"]: r["cache_digest"] for r in a
                   if r["stage"] == pod}
        assert digests[0] == digests[1], ("21a: the data ranks of pod "
                                          f"{pod} hold other caches")
    for r in a:
        assert r["status"] == ["done"] * len(reqs), r["status"]
        assert r["restored"] > 0 and r["moved"] == 0, r["restored"]
        lo, hi = r["range"]
        steps, lc, d = r["decode_steps"], r["launches"], r["data"]
        if DEV == "cuda":
            first, last = r["stage"] == 0, r["stage"] == P - 1
            assert lc["paged_attention"] == (hi - lo) * (
                nm * steps + (r["probes"] if d == 0 else 0)), \
                (r["stage"], d, lc, steps, r["probes"])
            assert lc["flash_attention"] == (hi - lo) * st["prefill_calls"]
            assert lc["seal"] == (nm * steps if first else 0), lc
            assert lc["unseal"] == (nm * steps if last else 0), lc
            assert lc["seal_bits_window"] == (
                2 * st["swap_outs"] if d == 0 else 0), lc
            assert lc["unseal_bits_window"] == 2 * st["swap_ins"], lc
            assert lc["seal_bits"] == steps + (
                st["prefill_calls"] if first else 0), lc
            assert lc["unseal_bits"] == (D - 1) * steps + (
                st["prefill_calls"] if last else 0), lc
    same = sum(x == y for x, y in zip(a[0]["streams"], phase6["streams"]))
    if halves_equal:
        assert same == len(reqs), \
            ("21a: streams differ from phase 6's one-card engine", same)
        # (c) data rank 0 of each pod seals its pod's part of a swap: the
        # parts side by side are phase 6's first payload, byte for byte
        want = phase6["first_swap"]
        parts = [r["first_swap"] for r in a if r["data"] == 0]
        assert all(p["counter"] == want["counter"] for p in parts), parts
        whole = tuple(np.concatenate([p["payload"][i] for p in parts],
                                     axis=1) for i in range(2))
        for got, exp in zip(whole, want["payload"]):
            assert got.dtype == exp.dtype and got.shape == exp.shape and \
                bytes(got.tobytes()) == bytes(exp.tobytes()), \
                "21c: the pods' parts are not phase 6's payload"
        assert sealing.payload_digest(whole) == \
            sealing.payload_digest(want["payload"])
        assert all(r["first_swap"]["payload"][0].shape[1] == 0
                   for r in a if r["data"] > 0)
        log(f"phase 21c: first swap-out (counter {want['counter']}): data "
            f"rank 0's parts of the two pods {[p['payload'][0].shape for p in parts]} "
            f"per plane, side by side, byte-equal to phase 6's "
            f"{want['payload'][0].shape} with the same payload_digest; the "
            f"other data ranks seal none")
    else:
        want = _first_step_logits(torch, api, params, argv, nm * D)
        for r in a:
            assert torch.equal(r["logits"][0], want), \
                ("21a: first decode step differs from the one-card 2-row "
                 "run", r["stage"], r["data"])
    cross = a[0]["crossings"]
    step_p50 = ", ".join(f"{_p50(r['step_ms']):.3f}" for r in a)
    parity = "" if halves_equal else (
        " (not held: the 2-row products differ; each data rank's first "
        "decode step bit-equal to the one-card 2-row run)")
    log(f"phase 21a llama3.2-1b ({L} layers) bf16, phase 6's stream on "
        f"2 x 2 pod x data ranks (stage blocks {st['stage_blocks']}), "
        f"sealed: {same} of {len(reqs)} streams equal phase 6's{parity}; "
        f"{st['completed']} requests, {a[0]['decode_steps']} decode "
        f"steps, swap-outs {st['swap_outs']}, swap-ins {st['swap_ins']} "
        f"(pages restored bit-exact {[r['restored'] for r in a]}); cache "
        f"digests equal within each pod; host ms a decode step p50 "
        f"(pod, data) order {step_p50} (phase 6 one card "
        f"{phase6['step_ms']:.3f} mean); "
        f"admission p50 / p99 {st['admission_p50_ms']:.1f} / "
        f"{st['admission_p99_ms']:.1f} ms (phase 6 "
        f"{phase6['admission'][0]:.1f} / {phase6['admission'][1]:.1f}) "
        f"[{smi}]")
    ex_ms = [[m for m, _ in r["exchanges"]] for r in a]
    ex_bytes = [{n for _, n in r["exchanges"]} for r in a]
    # one exchange a decode step, of one size a rank (its layers' K and V
    # of its rows)
    assert all(len(n) == 1 for n in ex_bytes) and all(
        len(e) == a[0]["decode_steps"] for e in ex_ms), ex_bytes
    def p50s(key, digits=3):
        return ", ".join(f"{_p50(r[key]):.{digits}f}" for r in a)

    log(f"phase 21a: the KV exchange between the data ranks of a pod (page "
        f"cipher, one a decode step), (pod, data) order: bytes a step "
        f"{[n.pop() for n in ex_bytes]}, host ms p50 "
        f"{', '.join(f'{_p50(e):.4f}' for e in ex_ms)}; a prefill "
        f"crossing (pod 0 -> 1, data rank 0): host ms p50 {_p50([c[0] for c in cross]):.4f} over {len(cross)}, "
        f"bytes {cross[0][1]} for the first; swap-out host ms p50 "
        f"{p50s('swap_out_ms')}; swap-in {p50s('swap_in_ms')}; (key, "
        f"counter) pairs sealed a rank {[len(r['keys']) for r in a]}, none "
        f"twice; launches {[r['launches'] for r in a]}")
    # (b) the serve steps over the same ranks, each against one card on
    # its rows

    def on_cpu(tree):
        return map_tree(lambda t: t.cpu(), tree)

    for rank, r in enumerate(b):
        assert r["rows"] == slice(rank * MESH_B // (P * D),
                                  (rank + 1) * MESH_B // (P * D)), r["rows"]
        for x, y in zip(r["logits"], b[0]["logits"]):
            assert torch.equal(x, y), "21b: the ranks' [B, V] logits differ"
        rows = r["rows"]
        lg, cache = api.prefill_fn(params, {"tokens": toks[rows]})
        assert torch.equal(r["logits"][0][rows], lg.cpu()), \
            ("21b: prefill logits", rank)
        assert _tree_equal(torch, r["prefill_cache"], on_cpu(cache)), \
            ("21b: prefill cache", rank)
        cache = rank_jobs.grow_cache(api, cache, DATA_STEPS)
        for i in range(DATA_STEPS):
            tok = r["logits"][i].argmax(-1)[:, None].to(torch.int32)
            lg, cache = api.decode_fn(params, cache,
                                      {"tokens": tok[rows].to(DEV)})
            assert torch.equal(r["logits"][i + 1][rows], lg.cpu()), \
                ("21b: decode logits", rank, i)
        assert _tree_equal(torch, r["cache"], on_cpu(cache)), \
            ("21b: decode cache", rank)
        if DEV == "cuda":
            assert r["launches"]["flash_attention"] == L, r["launches"]
    prefill_ms = ", ".join(f"{r['prefill_ms']:.2f}" for r in b)
    decode_ms = ", ".join(f"{_p50(r['decode_ms']):.3f}" for r in b)
    whole = sum(t.numel() * t.element_size() for t in _leaves(params))
    for r in b:
        # every leaf with an embed dim over data: half the params a rank
        assert r["param_bytes"] * D == whole, (r["param_bytes"], whole)
        assert r["decode_gather_bytes"] and all(
            n == r["prefill_gather_bytes"] > 0
            for n in r["decode_gather_bytes"]), r["decode_gather_bytes"]
    log(f"phase 21b serve steps over the 2 x 2 ranks, {MESH_B} x {MESH_S} "
        f"prefill and {DATA_STEPS} decode steps over "
        f"{MESH_S + DATA_STEPS} positions, {MESH_B // (P * D)} rows a "
        f"rank, params split over data (the reference's FSDP: "
        f"{b[0]['param_bytes']} bytes a rank of {whole}, each layer "
        f"gathered before use): each rank's logits and cache rows "
        f"bit-equal to the one-card prefill_fn / decode_fn on its rows, "
        f"the [{MESH_B}, V] logits equal on every rank; host ms, rank "
        f"order, prefill {prefill_ms}, a decode step p50 {decode_ms} (with "
        f"the gathers and the logits' gather); gather bytes a step a rank "
        f"{b[0]['prefill_gather_bytes']} [{smi}]")
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s (the spawn "
        f"{spawn_s:.1f} s" + (", with phase 22)" if also else ")"))
    eager = {"streams": a[0]["streams"],
             "step_ms": [_p50(r["step_ms"]) for r in a],
             "admission": (st["admission_p50_ms"], st["admission_p99_ms"]),
             "exchange_ms": [_p50(e) for e in ex_ms],
             "crossing_ms": _p50([c[0] for c in cross])}
    del api, params, out, a, b
    _free(torch)
    return [{"launches": launches, "eager": eager, "also": later}]


# phase 22: warmup over ranks (ROADMAP item 10d, step 3): phase 21's
# stream on the 2 x 2 ranks with each rank's stage work captured as CUDA
# graphs between its messages, and the reference's live re-plan line
# (``--inject-straggler 1:10 --verify-swap --warmup --assert-no-recompile``)
# at full width
# the straggler moves (1, 15) to (15, 1) (phase 20b): a tour of every
# composition of 16 blocks into two stages (15 layouts) holds it
WARM_TOUR = 14
# (b)'s cut of phase 6's stream: its first requests
WARM_REPLAN_REQUESTS = 8
# stats each rank keeps of its own
PER_RANK = ("graphs", "warmup_s")


def _same_decisions(ranks, what):
    """Every rank's events and stats (but ``PER_RANK``) equal."""
    def mine(st):
        return {k: v for k, v in st.items() if k not in PER_RANK}
    for r in ranks[1:]:
        assert r["events"] == ranks[0]["events"], (what, "events")
        assert mine(r["stats"]) == mine(ranks[0]["stats"]), (what, "stats")


def _warmed(ranks, what):
    """Zero post-warmup captures and no stall on every rank."""
    for r in ranks:
        assert r["post_warmup_compiles"] == 0 and r["stalls"] == [], \
            (what, r["stage"], r["data"], r["post_warmup_compiles"],
             r["stalls"][:4])
        if DEV == "cuda":
            assert r["graphs"] > 0, (what, r["graphs"])


def warm_jobs(torch, alone: bool = False):
    """Phase 22's rank job (``rank_jobs.serve`` on four ranks: its runs,
    with phase 21's eager run last when the phase runs ``alone``) and the
    context its checks read."""
    import dataclasses

    from repro_torch.launch import rank_jobs, serve
    args = _phase6_args()
    cfg = _family_cfg("llama3.2-1b")
    reqs = [(p, args.max_new)
            for p in serve.gen_prompts(args, cfg.vocab_size)]
    sealed = serve.make_config(args, warmup=True)
    calm = dataclasses.replace(sealed, seal_boundary=False,
                               telemetry_interval=args.telemetry_interval)
    cut = reqs[:WARM_REPLAN_REQUESTS]
    every = args.arrival_every
    runs = [rank_jobs.ServeRun(sealed, reqs, every=every, check_swaps=True),
            rank_jobs.ServeRun(calm, cut, every=every),
            rank_jobs.ServeRun(dataclasses.replace(
                calm, warmup_layouts=WARM_TOUR), cut, every=every,
                inject=RANKS_STRAGGLER)]
    if alone:                             # phase 21's run too
        runs.append(rank_jobs.ServeRun(serve.make_config(args), reqs,
                                       every=every))
    job = rank_jobs.ServeJob(cfg, runs, dtype=torch.bfloat16,
                             seed=args.seed, data=DATA_MESH[1])
    return [(rank_jobs.serve, job)], dict(args=args, cfg=cfg, reqs=reqs,
                                          cut=cut)


def serve_warm_ranks(torch, ops, smi, phase6=None, phase21=None,
                     served=None):
    """22. ``ServingEngine(mesh=, config=EngineConfig(warmup=True))`` on
    the four gloo ranks of phase 21 (``DATA_MESH``), in one spawn: every
    rank runs the warmup passes in lockstep and then serves with its
    stage's device work replayed from CUDA graphs, the messages posted
    eagerly between replays. (a) Phase 21's stream (full-width
    llama3.2-1b in bf16, pipelined (1, 15), sealed, 8 slots, 2
    microbatches, 30 pages) warmed: streams bit-equal to phase 21's eager
    rank streams (``phase21``, or an eager run in the same spawn when the
    phase runs alone) and, where those equal phase 6's, to phase 6's;
    every swap-in restored bit for bit on every rank; equal cache digests
    within each pod; no (key, counter) pair twice over the four ranks
    across warmup and serve (the ledger sees replays); zero post-warmup
    captures and no stall on every rank; launches as phase 21's formulas
    (replays add what their capture launched). (b) The reference's live
    re-plan line at full width: unsealed, warmed, ``--inject-straggler
    1:10`` over a tour of every layout (``WARM_TOUR``), on phase 6's first
    ``WARM_REPLAN_REQUESTS`` requests: a live swap onto a toured layout
    with zero post-warmup captures on every rank, streams equal to the
    warmed undisturbed run's. Prints, beside phase 21's eager figures,
    host ms a decode step per rank split into segment replays and message
    waits, admission p50 / p99, graphs and warmup seconds per rank, the
    KV exchange's and a crossing's host ms. ``served``: the job's results
    a rank and its context (``warm_jobs``), from phase 21's spawn; with
    None the phase spawns its own ranks. Returns the ranks' launch counts,
    summed."""
    from repro_torch.launch import rank_jobs
    from repro_torch.launch.ranks import spawn
    t_phase = time.perf_counter()
    _free(torch)
    argv = [DEV if a == "cuda" else a for a in RANKS_SERVE]
    cfg = _family_cfg("llama3.2-1b")
    if phase6 is None:                    # run alone: phase 6 first
        from repro_torch.models.api import build_model
        api = build_model(cfg, device=DEV, dtype=torch.bfloat16)
        params = api.init(torch.Generator(device=DEV).manual_seed(
            args.seed))
        phase6 = serve_full_width(torch, ops, api, params, argv, 6,
                                  plan=(1, cfg.num_layers - 1))
        del api, params
        _free(torch)
    P, D = DATA_MESH
    spawn_s = None
    if served is None:
        if DEV == "cuda":
            free, total = torch.cuda.mem_get_info()
            log(f"phase 22: device memory free {free / 2**30:.2f} of "
                f"{total / 2**30:.2f} GiB before the spawn (this process "
                f"reserves {torch.cuda.memory_reserved() / 2**30:.2f} GiB)")
        jobs, ctx = warm_jobs(torch, alone=phase21 is None)
        t0 = time.perf_counter()
        served = (spawn(rank_jobs.chain, P * D, backend="gloo", device=DEV,
                        args=(jobs,)), ctx)
        spawn_s = time.perf_counter() - t0
    out = [res[0] for res in served[0]]
    args, reqs, cut = (served[1][k] for k in ("args", "reqs", "cut"))
    L, nm = cfg.num_layers, args.microbatches
    launches = {k: 0 for k in ops.LAUNCHES}
    for res in out:
        for r in res:
            for k in launches:
                launches[k] += r["launches"][k]
    a, calm_b, tour_b = ([res[i] for res in out] for i in range(3))
    eager = phase21 or {"streams": out[0][3]["streams"],
                        "step_ms": [_p50(res[3]["step_ms"]) for res in out],
                        "admission": (out[0][3]["stats"]["admission_p50_ms"],
                                      out[0][3]["stats"]["admission_p99_ms"]),
                        "exchange_ms": [_p50([m for m, _ in res[3][
                            "exchanges"]]) for res in out],
                        "crossing_ms": _p50([c[0] for c in out[0][3][
                            "crossings"]])}
    # (a) phase 21's stream, warmed
    assert [(r["stage"], r["data"]) for r in a] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    for ranks, what in ((a, "22a"), (calm_b, "22b calm"),
                        (tour_b, "22b straggler")):
        _same_decisions(ranks, what)
        _warmed(ranks, what)
        bad = rank_jobs.keystream_reuse([r["keys"] for r in ranks])
        assert not bad, (what, "a (key, counter) pair ciphered twice",
                         bad[:3])
    st = a[0]["stats"]
    assert st["stage_blocks"] == (1, L - 1) and st["swaps"] == 0, st
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0, st
    for pod in range(P):
        digests = {r["data"]: r["cache_digest"] for r in a
                   if r["stage"] == pod}
        assert digests[0] == digests[1], ("22a: the data ranks of pod "
                                          f"{pod} hold other caches")
    for r in a:
        assert r["status"] == ["done"] * len(reqs), r["status"]
        assert r["streams"] == eager["streams"], \
            ("22a: streams differ from phase 21's eager ranks",
             r["stage"], r["data"])
        assert r["restored"] > 0 and r["moved"] == 0, r["restored"]
        lo, hi = r["range"]
        steps, lc, d = r["decode_steps"], r["launches"], r["data"]
        if DEV == "cuda":
            first, last = r["stage"] == 0, r["stage"] == P - 1
            assert lc["paged_attention"] == (hi - lo) * (
                nm * steps + (r["probes"] if d == 0 else 0)), \
                (r["stage"], d, lc, steps, r["probes"])
            assert lc["flash_attention"] == (hi - lo) * st["prefill_calls"]
            assert lc["seal"] == (nm * steps if first else 0), lc
            assert lc["unseal"] == (nm * steps if last else 0), lc
            assert lc["seal_bits_window"] == (
                2 * st["swap_outs"] if d == 0 else 0), lc
            assert lc["unseal_bits_window"] == 2 * st["swap_ins"], lc
            assert lc["seal_bits"] == steps + (
                st["prefill_calls"] if first else 0), lc
            assert lc["unseal_bits"] == (D - 1) * steps + (
                st["prefill_calls"] if last else 0), lc
    same6 = eager["streams"] == phase6["streams"]
    if same6:
        assert a[0]["streams"] == phase6["streams"]
    splits = [list(zip(*r["step_splits"])) for r in a]
    assert all(len(r["step_splits"]) == r["decode_steps"] for r in a)

    def row(xs, digits=3):
        return ", ".join(f"{x:.{digits}f}" for x in xs)

    log(f"phase 22a llama3.2-1b ({L} layers) bf16, phase 21's stream on "
        f"2 x 2 pod x data ranks warmed as CUDA graphs (stage blocks "
        f"{st['stage_blocks']}), sealed: streams bit-equal to phase 21's "
        f"eager ranks{' and to phase 6' if same6 else ''}"
        f"{'' if same6 else ' (phase 21 differs from phase 6)'}; "
        f"{st['completed']} requests, {a[0]['decode_steps']} decode steps, "
        f"swap-outs {st['swap_outs']}, swap-ins {st['swap_ins']} (pages "
        f"restored bit-exact {[r['restored'] for r in a]}); cache digests "
        f"equal within each pod; post-warmup captures 0 and no stall on "
        f"every rank; graphs a rank {[r['graphs'] for r in a]}, warmup s "
        f"{row([r['warmup_s'] for r in a], 2)}, peak reserved GiB "
        f"{row([r['peak_reserved'] / 2**30 for r in a], 2)} [{smi}]")
    log(f"phase 22a: host ms a decode step p50, (pod, data) order "
        f"{row([_p50(r['step_ms']) for r in a])} (phase 21 eager ranks "
        f"{row(eager['step_ms'])}); of which segment replays p50 "
        f"{row([_p50(x[0]) for x in splits])} and message waits p50 "
        f"{row([_p50(x[1]) for x in splits])}; admission p50 / p99 "
        f"{st['admission_p50_ms']:.1f} / {st['admission_p99_ms']:.1f} ms "
        f"(phase 21 {eager['admission'][0]:.1f} / "
        f"{eager['admission'][1]:.1f}); the KV exchange host ms p50 "
        f"{row([_p50([m for m, _ in r['exchanges']]) for r in a], 4)} "
        f"(phase 21 {row(eager['exchange_ms'], 4)}); a prefill crossing "
        f"(pod 0 -> 1, data rank 0) host ms p50 "
        f"{_p50([c[0] for c in a[0]['crossings']]):.4f} (phase 21 "
        f"{eager['crossing_ms']:.4f}); (key, "
        f"counter) pairs a rank {[len(r['keys']) for r in a]}, none twice; "
        f"launches {[r['launches'] for r in a]}")
    # (b) the live re-plan line, warmed
    for r, c in zip(tour_b, calm_b):
        assert r["streams"] == c["streams"], \
            ("22b: streams differ across the live swap", r["stage"],
             r["data"])
        assert r["status"] == ["done"] * len(cut), r["status"]
    sb = tour_b[0]["stats"]
    swaps = [(d["from"], d["to"]) for _, kind, d in tour_b[0]["events"]
             if kind == "swap"]
    assert sb["swaps"] >= 1 and swaps and all(
        d["migrated"] for _, kind, d in tour_b[0]["events"]
        if kind == "swap"), tour_b[0]["events"]
    log(f"phase 22b: unsealed, warmed over a tour of every layout "
        f"(warmup_layouts {WARM_TOUR}), --inject-straggler 1:10, phase 6's "
        f"first {len(cut)} requests: live swaps "
        f"{', '.join(f'{x}->{y}' for x, y in swaps)} with post-warmup "
        f"captures 0 and no stall on every rank; streams equal the warmed "
        f"undisturbed run's; warmup s "
        f"{row([r['warmup_s'] for r in tour_b], 2)} (undisturbed, planned "
        f"tour: "
        f"{row([r['warmup_s'] for r in calm_b], 2)}); graphs a rank "
        f"{[r['graphs'] for r in tour_b]}, peak reserved GiB "
        f"{row([r['peak_reserved'] / 2**30 for r in tour_b], 2)}; a "
        f"restage's host ms "
        f"{row([m for m, _ in tour_b[0]['restages']], 1)}; host ms a decode "
        f"step p50 {row([_p50(r['step_ms']) for r in tour_b])}")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s" + (
        f" (the spawn {spawn_s:.1f} s)" if spawn_s is not None
        else " reading its ranks' results (run in phase 21's spawn)"))
    del out, a, calm_b, tour_b
    _free(torch)
    return [{"launches": launches}]


# phase 23: the disaggregated pair over ranks (ROADMAP item 10d, step 4):
# phase 21's stream through the pair on the 2 x 2 ranks, eager and warmed,
# and the reference's chaos-over-disagg line at full width in f32
DISAGG_CHAOS = ["--arch", "llama3.2-1b", "--device", "cuda", "--ranks",
                "gloo", "--mesh", "2x2", "--stages", "2", "--microbatches",
                "2", "--slots", "4", "--requests", "8", "--prompt-len", "8",
                "--max-new", "10", "--page-size", "4", "--no-seal", "--f32",
                "--seed", "7", "--disagg", "--chaos", "--verify-recovery"]


def _one_card_pair(torch, api, params, args):
    """The one-card pipelined pair on ``args``' stream, eager, instrumented
    as the ranks' (``rank_jobs.PairProbe``): its streams, its first
    handoff and every export's and transfer-in's host ms."""
    from repro_torch.launch import rank_jobs, serve
    orch = serve.make_disagg(api, params, args)
    probe = rank_jobs.PairProbe(orch)
    reqs = serve.serve_stream_orch(
        orch, serve.stream_of(args, serve.gen_prompts(
            args, api.cfg.vocab_size)), args.arrival_every)
    out = {"streams": [list(r.generated) for r in reqs],
           "first_handoff": probe.first_handoff,
           "export_ms": [e[0] for e in probe.exports],
           "transfer_in_ms": [t[0] for t in probe.transfers_in]}
    del orch, probe
    return out


def serve_disagg_ranks(torch, ops, smi, phase6=None, phase21=None,
                       phase9=None):
    """23. ``build_disagg(mesh=)`` on the four gloo ranks of phase 21
    (``DATA_MESH``): a prefill-role and a decode-role rank engine on every
    rank, stage s on the ranks of pod s, the orchestrator on every rank.
    (a) Phase 21's stream (full-width llama3.2-1b in bf16, pipelined (1,
    15), sealed, 8 slots, 2 microbatches, 30 pages) through the pair,
    eager: streams bit-equal to phase 21's eager rank engine
    (``phase21``, or run in the same spawn when the phase runs alone) and,
    where those equal phase 6's, to phase 6's; handoffs = requests -
    finished at prefill = transfers out = transfers in; every transferred
    (layer, page row) restored bit for bit on every rank
    (``rank_jobs.rows_restored``); equal decode-cache digests within each
    pod after every tick; the first handoff's four parts side by side =
    the payload and digest of the same manifest exported by a one-card
    pipelined pair; no (key, counter) pair twice over four ranks and both
    roles; every rank's events, decisions and stats equal. (b) The same
    with ``--warmup``: streams = (a)'s, zero post-warmup captures and
    stalls on every rank on both roles. (c) The reference's
    chaos-over-disagg flags at full width in f32 (``DISAGG_CHAOS``)
    through ``serve.main``: ``RECOVERY-EXACT OK``, at least one tampered
    transfer falling back, the same on all four ranks (``serve`` asserts
    it over the world). Prints host ms per export and per transfer-in a
    rank (p50) beside the one-card pipelined pair's on the same stream,
    eager, and phase 9's (the local backend on phase 5's stream);
    handoffs, the decode
    role's admission p50 / p99, host ms a decode step a rank, graphs and
    warmup s a rank a role, peak reserved memory a rank, the phase's
    seconds. Returns the ranks' launch counts over (a) and (b),
    summed."""
    import dataclasses

    from repro_torch.enclave import sealing
    from repro_torch.launch import rank_jobs, serve
    from repro_torch.launch.ranks import spawn
    from repro_torch.models.api import build_model
    t_phase = time.perf_counter()
    _free(torch)
    argv = [DEV if a == "cuda" else a for a in RANKS_SERVE]
    args = serve.build_parser().parse_args(argv)
    cfg = _family_cfg("llama3.2-1b")
    api = build_model(cfg, device=DEV, dtype=torch.bfloat16)
    params = api.init(torch.Generator(device=DEV).manual_seed(args.seed))
    if phase6 is None:                    # run alone: phase 6 first
        phase6 = serve_full_width(torch, ops, api, params, argv, 6,
                                  plan=(1, cfg.num_layers - 1))
    one = _one_card_pair(torch, api, params, args)
    want = one["first_handoff"]
    del api, params
    _free(torch)
    L, nm = cfg.num_layers, args.microbatches
    P, D = DATA_MESH
    reqs = [(p, args.max_new)
            for p in serve.gen_prompts(args, cfg.vocab_size)]
    every = args.arrival_every
    runs = [rank_jobs.DisaggRun(serve.make_config(args, warmup=warm), reqs,
                                every=every) for warm in (False, True)]
    calls = [(rank_jobs.disagg, rank_jobs.DisaggJob(
        cfg, runs, dtype=torch.bfloat16, seed=args.seed, data=D))]
    if phase21 is None:                   # run alone: phase 21's run too
        calls.append((rank_jobs.serve, rank_jobs.ServeJob(
            cfg, [rank_jobs.ServeRun(serve.make_config(args), reqs,
                                     every=every)],
            dtype=torch.bfloat16, seed=args.seed, data=D)))
    t0 = time.perf_counter()
    out = spawn(rank_jobs.chain, P * D, backend="gloo", device=DEV,
                args=(calls,))
    spawn_s = time.perf_counter() - t0
    a, b = ([res[0][i] for res in out] for i in range(2))
    eager = phase21 or {"streams": out[0][1][0]["streams"]}
    launches = {k: 0 for k in ops.LAUNCHES}
    for r in a + b:
        for k in launches:
            launches[k] += r["launches"][k]

    def mine(st):
        return {k: v for k, v in st.items() if k not in PER_RANK}

    assert [(r["decode"]["stage"], r["decode"]["data"]) for r in a] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for ranks, what in ((a, "23a"), (b, "23b")):
        r0 = ranks[0]
        for r in ranks[1:]:
            assert r["decisions"] == r0["decisions"], (what, "decisions")
            assert mine(r["orch"]) == mine(r0["orch"]), (what, "stats")
            for role in ("decode", "prefill"):
                assert r[role]["events"] == r0[role]["events"], \
                    (what, role, "events")
                assert mine(r[role]["stats"]) == mine(r0[role]["stats"]), \
                    (what, role, "stats")
        bad = rank_jobs.keystream_reuse([r["keys"] for r in ranks])
        assert not bad, (what, "a (key, counter) pair ciphered twice",
                         bad[:3])
        restored = rank_jobs.rows_restored(ranks)
        assert all(n > 0 for n in restored), (what, restored)
        for pod in range(P):
            x, y = (r for r in ranks if r["decode"]["stage"] == pod)
            assert x["digests"] == y["digests"] \
                and x["cache_digest"] == y["cache_digest"], \
                (what, f"the data ranks of pod {pod} hold other caches")
        st = r0["orch"]
        ps, ds = r0["prefill"]["stats"], r0["decode"]["stats"]
        assert st["stage_blocks"] == (1, L - 1) and st["swaps"] == 0, st
        assert ps["stage_blocks"] == (1, L - 1)
        assert st["handoffs"] == len(reqs) - st["prefill_completed"] \
            == ps["transfers_out"] == st["transfers_in"], (what, st)
        assert st["recovery"]["unseal_fallback_transfer"] == 0, st
        for r in ranks:
            assert r["status"] == ["done"] * len(reqs), r["status"]
            assert r["streams"] == eager["streams"], \
                (what, "streams differ from phase 21's eager ranks",
                 r["decode"]["stage"], r["decode"]["data"])
            assert r["relayouts"] == 0 and all(t[3] for t in
                                               r["transfers_in"])
            if DEV == "cuda":
                lo, hi = r["decode"]["range"]
                steps, lc = r["decode"]["decode_steps"], r["launches"]
                d, first = r["decode"]["data"], r["decode"]["stage"] == 0
                last = r["decode"]["stage"] == P - 1
                calls_ = ps["prefill_calls"] + ds["prefill_calls"]
                outs = ps["transfers_out"] + ps["swap_outs"] \
                    + ds["swap_outs"]
                ins = ds["transfers_in"] + ds["swap_ins"] + ps["swap_ins"]
                assert lc["paged_attention"] == (hi - lo) * (
                    nm * steps + (r["probes"] if d == 0 else 0)), \
                    (what, d, lc, steps, r["probes"])
                assert lc["flash_attention"] == (hi - lo) * calls_, lc
                assert lc["seal"] == (nm * steps if first else 0), lc
                assert lc["unseal"] == (nm * steps if last else 0), lc
                assert lc["seal_bits_window"] == (
                    2 * outs if d == 0 else 0), lc
                assert lc["unseal_bits_window"] == 2 * ins, lc
                assert lc["seal_bits"] == steps + (calls_ if first
                                                   else 0), lc
                assert lc["unseal_bits"] == (D - 1) * steps + (
                    calls_ if last else 0), lc
    for r in b:
        for role in ("decode", "prefill"):
            assert r[role]["post_warmup_compiles"] == 0 \
                and r[role]["stalls"] == [], \
                ("23b", role, r[role]["post_warmup_compiles"],
                 r[role]["stalls"][:4])
            if DEV == "cuda":
                assert r[role]["graphs"] > 0, ("23b", role)
    same6 = eager["streams"] == phase6["streams"]
    if same6:
        assert a[0]["streams"] == phase6["streams"]
    # the first handoff: the pods' parts side by side = the one-card pair's
    parts = {(r["decode"]["stage"], r["decode"]["data"]): r["first_handoff"]
             for r in a}
    assert all(p["counter"] == want["counter"] == sealing.transfer_seq(0)
               for p in parts.values())
    import numpy as np
    whole = tuple(np.concatenate([parts[(pod, 0)]["payload"][i]
                                  for pod in range(P)], axis=1)
                  for i in range(2))
    for x, y in zip(whole, want["payload"]):
        assert x.dtype == y.dtype and np.array_equal(x, y), \
            "23a: the ranks' first handoff is not the one-card payload"
    assert sealing.payload_digest(whole) == want["digest"]
    assert all(p["payload"][0].shape[1] == 0
               for (_, d), p in parts.items() if d > 0)

    def row(xs, digits=3):
        return ", ".join(f"{x:.{digits}f}" for x in xs)

    def p9(key, i):
        return f"{phase9[i][key]:.3f}" if phase9 and len(phase9) > i \
            else "not run"

    adm9 = phase9[0]["admission"] if phase9 else (math.nan, math.nan)

    st = a[0]["orch"]
    ds = a[0]["decode"]["stats"]
    log(f"phase 23a llama3.2-1b ({L} layers) bf16, phase 21's stream "
        f"through the disaggregated pair on 2 x 2 pod x data ranks (both "
        f"roles on every rank, stage blocks {st['stage_blocks']}), sealed, "
        f"eager: streams bit-equal to phase 21's eager ranks"
        f"{' and to phase 6' if same6 else ' (phase 21 differs from phase 6)'}"
        f"; {len(reqs)} requests, handoffs {st['handoffs']} (finished at "
        f"prefill {st['prefill_completed']}), transfers out "
        f"{a[0]['prefill']['stats']['transfers_out']} = in "
        f"{st['transfers_in']}; transferred (layer, row) pairs restored "
        f"bit-exact a rank {rank_jobs.rows_restored(a)}; decode caches "
        f"equal within each pod after every tick; the first handoff's parts "
        f"side by side = the one-card pair's payload and digest (counter "
        f"{want['counter']}); (key, counter) pairs a rank "
        f"{[len(r['keys']) for r in a]}, none twice over both roles; "
        f"peak reserved GiB a rank "
        f"{row([r['peak_reserved'] / 2**30 for r in a], 2)} [{smi}]")
    log(f"phase 23a: the one-card pipelined pair on the same stream, "
        f"eager (the first handoff's source): streams "
        f"{'equal' if one['streams'] == eager['streams'] else 'differ from'}"
        f" the ranks'; {len(one['export_ms'])} exports, host ms p50 "
        f"{_p50(one['export_ms']):.3f}; {len(one['transfer_in_ms'])} "
        f"transfer-ins, p50 {_p50(one['transfer_in_ms']):.3f}")
    for ranks, what in ((a, "23a eager"), (b, "23b warmed")):
        ds = ranks[0]["decode"]["stats"]
        log(f"phase {what}: host ms per export p50, (pod, data) order "
            f"{row([_p50([e[0] for e in r['exports']]) for r in ranks])} "
            f"(the one-card pipelined pair, eager, same stream: "
            f"{_p50(one['export_ms']):.3f}; phase 9, local backend on phase "
            f"5's stream: eager {p9('export_ms', 0)}, graphs "
            f"{p9('export_ms', 1)}), bytes a rank's part "
            f"{[r['exports'][0][1] for r in ranks]}; per transfer-in p50 "
            f"{row([_p50([t[0] for t in r['transfers_in']]) for r in ranks])} "
            f"(one-card pipelined pair {_p50(one['transfer_in_ms']):.3f}; "
            f"phase 9: {p9('transfer_in_ms', 0)}, "
            f"{p9('transfer_in_ms', 1)}), bytes sent a transfer-in "
            f"{[r['transfers_in'][0][2] for r in ranks]}; handoffs "
            f"{ranks[0]['orch']['handoffs']}; decode-role admission p50 / "
            f"p99 {ds['admission_p50_ms']:.1f} / {ds['admission_p99_ms']:.1f}"
            f" ms (phase 9 eager {adm9[0]:.1f} / {adm9[1]:.1f});"
            f" host ms a decode step p50 "
            f"{row([_p50(r['step_ms']) for r in ranks])} (phase 9 eager "
            f"{p9('step_ms', 0)} mean); graphs a rank decode / prefill "
            f"role {[r['decode']['graphs'] for r in ranks]} / "
            f"{[r['prefill']['graphs'] for r in ranks]}, warmup s "
            f"{row([r['decode']['warmup_s'] for r in ranks], 2)} / "
            f"{row([r['prefill']['warmup_s'] for r in ranks], 2)}; peak "
            f"reserved GiB a rank "
            f"{row([r['peak_reserved'] / 2**30 for r in ranks], 2)}; "
            f"launches {[r['launches'] for r in ranks]}")
    del out, a, b
    _free(torch)
    # (c) the reference's chaos-over-disagg line at full width, f32
    t0 = time.perf_counter()
    cargv = [DEV if x == "cuda" else x for x in DISAGG_CHAOS]
    cst = serve.main(cargv)
    chaos_s = time.perf_counter() - t0
    inj, rec = cst["faults"], cst["recovery"]
    assert rec["unseal_fallback_transfer"] >= 1 \
        and rec["unseal_fallback_transfer"] == inj["corrupt_transfer"] \
        + inj["truncate_transfer"], (inj, rec)
    assert not cst["failed_requests"] and cst["in_flight_handoffs"] == 0
    log(f"phase 23c: the reference's chaos-over-disagg flags at full width "
        f"in f32 on 2 x 2 ranks through serve.main: RECOVERY-EXACT OK, "
        f"injected {dict((k, v) for k, v in inj.items() if v)}, rungs "
        f"{dict((k, v) for k, v in rec.items() if v)}, the same on every "
        f"rank; {cst['handoffs']} handoffs, {cst['transfers_in']} "
        f"transfers in; {chaos_s:.1f} s [{smi}]")
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s (the spawn of "
        f"(a) and (b) {spawn_s:.1f} s, (c) {chaos_s:.1f} s)")
    return [{"launches": launches}]


# ---------------------------------------------------------------------------
# phase 24: the model axis over ranks (ROADMAP item 10d, step 5a): the
# prefill and decode serve steps with tensor parallelism, four gloo ranks
# on the card, each holding its shard of seeded weights. Sizes are names,
# for a CPU rehearsal as phases 16 to 23.
MODEL_MESH = ((1, 4), ("data", "model"))
MODEL_B, MODEL_S, MODEL_STEPS, MODEL_SEED = 8, 128, 4, 0
# (name, config, layers (None: all), dtype): (a) and (c) cut to 4 layers,
# (a) also at 1 and 2 (how the f32 error grows with depth); (b) cut from
# 40 layers to 10 (the script's time, with phase 26 added)
MODEL_CASES = (("24a1", "glm4-9b", 1, "f32"),
               ("24a2", "glm4-9b", 2, "f32"),
               ("24a", "glm4-9b", 4, "f32"),
               ("24b", "glm4-9b", 10, "bf16"),
               ("24c", "qwen2-moe-a2.7b", 4, "f32"))
# the embedding scaled by 1 + MODEL_NUDGE: how far an f32 rounding of the
# input moves the one-card step's logits on these weights
MODEL_NUDGE = 1e-6


def _held(torch, got, want):
    """Each step's error of the logits ``got`` against ``want`` over the
    rows fed the same tokens so far, and the rows whose greedy tokens
    agreed at every step."""
    rows, errs = torch.ones(len(want[0]), dtype=torch.bool), []
    for a, b in zip(got, want):
        errs.append(_rel(a[rows], b[rows]) if rows.any() else math.nan)
        rows &= a.argmax(-1) == b.argmax(-1)
    return errs, int(rows.sum())


def _one_card_steps(torch, api, params, toks, steps):
    """The port's one-card prefill and decode serve steps on ``toks``
    [B, S] then ``steps`` greedy steps, timed as ``rank_jobs.serve_steps``
    times a rank's (first calls untimed): logits on the CPU, host ms."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import rank_jobs
    from repro_torch.runtime import steps as S
    B, Sq = tuple(toks.shape)
    pre = S.make_prefill_step(api, None, ShapeConfig("p", Sq, B, "prefill"))
    dec = S.make_decode_step(api, None, ShapeConfig("d", Sq + steps, B,
                                                     "decode"))
    tok = toks.to(DEV)
    logits, cache = pre(params, {"tokens": tok})
    dec(params, rank_jobs.grow_cache(api, cache, steps),
        {"tokens": logits.argmax(-1)[:, None].to(torch.int32)})
    del logits, cache
    _sync(torch)
    t0 = time.perf_counter()
    logits, cache = pre(params, {"tokens": tok})
    _sync(torch)
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
           "logits": [logits.cpu()], "decode_ms": []}
    cache = rank_jobs.grow_cache(api, cache, steps)
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache = dec(params, cache, {
            "tokens": logits.argmax(-1)[:, None].to(torch.int32)})
        _sync(torch)
        out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(logits.cpu())
    return out


def model_jobs(torch):
    """Phase 24's rank jobs (``rank_jobs.serve_steps``, one a case of
    MODEL_CASES) and what its checks read: the port's one-card serve steps
    of each case on seeded weights (run here, freed after; for bf16 the
    f32 step on the same draw too), and each case's config and dtype."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import rank_jobs
    from repro_torch.models.api import build_model
    _free(torch)
    horizon = MODEL_S + MODEL_STEPS
    jobs, one, cfgs = [], {}, {}
    for name, arch, layers, dt in MODEL_CASES:
        cfg = get_arch(arch)
        cfg = FAMILY_ARCH(cfg) if FAMILY_ARCH else cfg
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=min(layers,
                                                          cfg.num_layers))
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        toks = torch.randint(0, cfg.vocab_size, (MODEL_B, MODEL_S),
                             generator=torch.Generator().manual_seed(24))
        # the case's dtype, then (for bf16) the f32 step on the same draw
        for run in dict.fromkeys((dtype, torch.float32)):
            api = build_model(cfg, device=DEV, dtype=run, max_seq=horizon)
            params = api.init(torch.Generator(device=DEV).manual_seed(
                MODEL_SEED))
            key = name if run is dtype else f"{name} f32"
            one[key] = _one_card_steps(torch, api, params, toks,
                                       MODEL_STEPS)
            one[key]["param_bytes"] = sum(t.numel() * t.element_size()
                                          for t in _leaves(params))
            if run is torch.float32:
                nudged = dict(params,
                              embed=params["embed"] * (1 + MODEL_NUDGE))
                one[key]["nudge"] = _held(torch, _one_card_steps(
                    torch, api, nudged, toks, MODEL_STEPS)["logits"],
                    one[key]["logits"])[0]
                del nudged
            del api, params
            _free(torch)
        cfgs[name] = (cfg, dtype)
        jobs.append((rank_jobs.serve_steps, rank_jobs.StepsJob(
            cfg, MODEL_MESH, toks, steps=MODEL_STEPS, dtype=dtype,
            seed=MODEL_SEED, max_seq=horizon)))
    return jobs, dict(one=one, cfgs=cfgs)


def model_ranks(torch, ops, smi, served=None):
    """24. The model axis over ranks: for each of MODEL_CASES, the port's
    one-card serve steps on seeded weights first (``model_jobs``), then
    one spawn of four gloo ranks on the card on a (1, 4) ("data", "model")
    mesh running them all (``rank_jobs.serve_steps`` chained), each rank
    drawing only its shard (``steps.draw_params``) from the same seed:
    MODEL_B x MODEL_S prefill tokens, MODEL_STEPS greedy decode steps. Every
    step's whole logits are the same bits on the four ranks; f32 cases
    within F32_FULL_TOL of the one-card step's largest |logit| with equal
    greedy tokens, printed beside how far an embedding nudged by
    MODEL_NUDGE moves the one-card step; bf16 printed, beside the one-card
    bf16 step's and the ranks' errors against the one-card f32 step on
    the same draw (the precision's own gap); each rank's param shapes the shard
    shapes of ``param_shardings`` on the model axis and its param bytes
    their sum; flash launches a rank = layers (one prefill). Prints host
    ms a prefill and a decode step against one card, bytes messaged a
    step, param GiB and peak memory a rank. Returns the ranks' launch
    counts, summed, and the one-card steps by case name (``one``: phase
    26c holds its ranks against them). ``served``: the jobs' results a rank and their context
    (``model_jobs``), from another phase's spawn (phase 25's); with None
    the phase spawns its own ranks."""
    from repro_torch.launch import rank_jobs
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.launch.ranks import spawn
    from repro_torch.models.api import build_model
    from repro_torch.runtime import steps as S
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    M = dict(zip(MODEL_MESH[1], MODEL_MESH[0]))["model"]
    horizon = MODEL_S + MODEL_STEPS
    spawn_s = None
    if served is None:
        jobs, ctx = model_jobs(torch)
        t0 = time.perf_counter()
        ranks = spawn(rank_jobs.chain, M, backend="gloo", device=DEV,
                      args=(jobs,))
        spawn_s = time.perf_counter() - t0
    else:
        ranks, ctx = served
    one, cfgs = ctx["one"], ctx["cfgs"]
    launches = {k: 0 for k in ops.LAUNCHES}
    lm = LogicalMesh((M,), ("model",))

    def row(xs, fmt="{:.3f}"):
        return ", ".join(fmt.format(x) for x in xs)

    for i, (name, arch, _, dt) in enumerate(MODEL_CASES):
        cfg, dtype = cfgs[name]
        rs, o = [r[i] for r in ranks], one[name]
        for r in rs[1:]:
            assert all(torch.equal(a, b) for a, b in
                       zip(r["logits"], rs[0]["logits"])), \
                f"{name}: the ranks' logits differ"
        errs, agree = _held(torch, rs[0]["logits"], o["logits"])
        if dt == "f32":
            assert max(errs) < F32_FULL_TOL and agree == MODEL_B, \
                (name, errs, agree)
            control = (f"; an embedding nudged by {MODEL_NUDGE:g} moves the "
                       f"one-card step {row(o['nudge'], '{:.2e}')}")
        else:
            f32 = one[f"{name} f32"]
            (e1, a1), (e2, a2) = (_held(torch, o["logits"], f32["logits"]),
                                  _held(torch, rs[0]["logits"],
                                        f32["logits"]))
            control = (f"; against the one-card f32 step on the same draw: "
                       f"the one-card {dt} step {row(e1, '{:.2e}')} "
                       f"(tokens equal on {a1} of {MODEL_B} rows), the "
                       f"ranks {row(e2, '{:.2e}')} (on {a2}); an embedding "
                       f"nudged by {MODEL_NUDGE:g} moves the f32 step "
                       f"{row(f32['nudge'], '{:.2e}')}")
        meta = build_model(cfg, device="meta", dtype=dtype)
        want = [sh.shard_shape(sp.shape) for sh, sp in zip(
            leaves(S.param_shardings(meta, lm)), leaves(meta.param_specs()))]
        esz = torch.empty((), dtype=dtype).element_size()
        want_bytes = sum(math.prod(w) for w in want) * esz
        for r in rs:
            assert r["param_shapes"] == want, name
            assert r["param_bytes"] == want_bytes, (name, r["param_bytes"])
            if DEV == "cuda":
                assert r["launches"]["flash_attention"] == cfg.num_layers, \
                    (name, r["launches"])
            for k in launches:
                launches[k] += r["launches"][k]
        experts = ""
        if cfg.num_experts:
            wi = meta.param_specs()["blocks"]["moe"]["wi"]
            e_loc = S.param_shardings(meta, lm)["blocks"]["moe"][
                "wi"].shard_shape(wi.shape)[1]
            experts = f", {e_loc} of {cfg.num_experts} experts a rank"
            if FAMILY_ARCH is None:
                assert e_loc == 15, e_loc
        peaks = [r["peak_bytes"] / 2**30 if r["peak_bytes"] else math.nan
                 for r in rs]
        # the decode cache a rank holds (ROADMAP item 10d, step 5c's
        # repair): its KV heads where they divide over model, else its
        # block of the positions where the horizon divides
        kv_rank = [sum(t.numel() * t.element_size()
                       for t in _leaves(r["cache"]["blocks"])) for r in rs]
        per_pos = cfg.num_layers * 2 * MODEL_B * cfg.head_dim * esz
        if cfg.num_kv_heads % M == 0:
            reckoned = per_pos * (cfg.num_kv_heads // M) * horizon
        elif horizon % M == 0:
            reckoned = per_pos * cfg.num_kv_heads * (horizon // M)
        else:
            reckoned = per_pos * cfg.num_kv_heads * horizon
        assert kv_rank == [reckoned] * M, (name, kv_rank, reckoned)
        cache = (f"; decode cache bytes a rank {kv_rank[0]} = reckoned "
                 f"(one card {per_pos * cfg.num_kv_heads * horizon}, "
                 f"{cfg.num_kv_heads} KV heads over {M} ranks, "
                 f"{horizon} positions)")
        log(f"phase {name} {arch} full width, {cfg.num_layers} layers, "
            f"{dt} on {M} model ranks ({MODEL_MESH[1]} mesh "
            f"{MODEL_MESH[0]}){experts}: prefill {MODEL_B} x {MODEL_S} and "
            f"{MODEL_STEPS} greedy decode steps; logits against the "
            f"one-card step {row(errs, '{:.2e}')} of its largest |logit| "
            f"over the rows fed the same tokens (limit "
            f"{F32_FULL_TOL if dt == 'f32' else 'printed'}), greedy tokens "
            f"equal on {agree} of {MODEL_B} rows at every step{control}; "
            f"the whole logits the same bits on every rank; host ms a prefill "
            f"step a rank {row([r['prefill_ms'] for r in rs])} (one card "
            f"{o['prefill_ms']:.3f}), a decode step p50 a rank "
            f"{row([_p50(r['decode_ms']) for r in rs])} (one card "
            f"{_p50(o['decode_ms']):.3f}); bytes messaged a rank, the "
            f"prefill {rs[0]['prefill_bytes']}, a decode step "
            f"{rs[0]['decode_bytes']}; param GiB a rank "
            f"{row([r['param_bytes'] / 2**30 for r in rs])} = the shard "
            f"shapes of param_shardings on the model axis (one card "
            f"{o['param_bytes'] / 2**30:.3f}); peak allocated GiB a rank "
            f"{row(peaks, '{:.2f}')}; flash launches a rank "
            f"{[r['launches']['flash_attention'] for r in rs]}{cache} "
            f"[{smi}]")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s" + (
        f" (the spawn {spawn_s:.1f} s)" if spawn_s is not None
        else " reading its ranks' results (run in phase 25's spawn)"))
    return [{"launches": launches, "one": one}]


# ---------------------------------------------------------------------------
# phase 25: the train step over a model axis of ranks (ROADMAP item 10d,
# step 5b): tensor parallelism's backward, and (step 8) every leaf with an
# embed dim split over the data axis, its AdamW state with it (the
# reference's FSDP): four gloo ranks on the card, each drawing only its
# blocks. Sizes are names, for a CPU rehearsal as phases 16 to 24.
# 25a: full-width llama3.2-1b at full depth in bf16 on (2, 2) data x
# model, phase 13's batch, stream, seed and schedule, 2 steps (3 until the
# data axis's gathers made a step 7.4 to 13.0 s a rank)
TRAIN_MESH = ((2, 2), ("data", "model"))
TRAIN_STEPS = 2
# 25b: f32 at cut depth on (1, 4), one step at index 0 against the
# one-card step on the same draw; 25c: qwen2-moe-a2.7b the same on
# TRAIN_MESH, its router, experts and shared experts split over data, its
# depth cut from 2 layers to 1 (the script's time, with phase 26 added)
TRAIN_F32_MESH = ((1, 4), ("data", "model"))
TRAIN_F32_CASES = (("25b glm4", "glm4-9b", 2, TRAIN_F32_MESH),
                   ("25b moe", "qwen2-moe-a2.7b", 2, TRAIN_F32_MESH),
                   ("25c moe", "qwen2-moe-a2.7b", 1, TRAIN_MESH))
TRAIN_F32_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=30)
# on ``_conditioned`` weights (the reference's init amplifies f32 rounding
# to order one in the gradient at full width: on an H100 the ranks'
# gradient of 2-layer glm4-9b stood 0.16 of a leaf's largest off one
# card's, and at 1 layer the card's one-card gradient 1.0 off the CPU's);
# the gradient is held through AdamW's first moment after the step (m =
# (1 - b1) g from zero moments; the schedule's lr is 0 at step 0, and at
# a moving step Adam moves an element whose gradient sits at rounding
# level by up to lr either way, so new params would show little more)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-4
# 25a on (2, 2) with every leaf whole over data, the layout before the
# data axis split (H100 80GB HBM3, 700.00 W): bytes a step a rank of the
# data reduce and of the model axis's collectives, and the peak
# allocated a rank
WHOLE_DATA_BYTES, WHOLE_MODEL_BYTES, WHOLE_PEAK_GIB = \
    2471763972, 343945260, 16.38


def _rank_coords(rank, mesh):
    """{axis: index} of ``rank`` on ``mesh`` (sizes, names), row-major."""
    import numpy as np
    shape, names = mesh
    return {a: int(c) for a, c in zip(names, np.unravel_index(rank, shape))}


def _rank_at(coords, mesh):
    """The rank at ``coords`` ({axis: index}) of ``mesh``, row-major."""
    import numpy as np
    shape, names = mesh
    return int(np.ravel_multi_index([coords[a] for a in names], shape))


def _holder(rank, mesh, axes):
    """The lowest rank of ``mesh`` holding ``rank``'s block of a leaf
    split over ``axes``: its coordinates on those, 0 on the rest."""
    c = _rank_coords(rank, mesh)
    return _rank_at({a: c[a] if a in axes else 0 for a in mesh[1]}, mesh)


def _conditioned(api, params):
    """``params`` (whole, or a rank's shards) with every stacked block
    weight rescaled in place from the reference's std 1/sqrt(n blocks) to
    1/sqrt(k), k the count its product contracts: the ``embed`` axis of
    an input projection (q, k, v, the router, ``wi``, ``wg``), the heads
    and head_dim or ``mlp`` axes of an output projection ``wo``. The
    factor comes from the whole leaf's spec, so a shard scales as its
    leaf does, bit for bit. At full width the reference's init saturates
    attention and amplifies f32 rounding to order one in the gradient (as
    phase 17's ``_contraction_scaled`` finds for its families); these
    weights keep the step well conditioned."""
    from repro_torch.tree import leaves, named_leaves
    specs = named_leaves(api.param_specs())
    for (name, sp), t in zip(specs.items(), leaves(params)):
        if sp.init != "normal" or not sp.axes or sp.axes[0] != "layers":
            continue
        axes = ("heads", "head_dim", "mlp") if name.endswith("wo") \
            else ("embed",)
        k = math.prod(n for n, a in zip(sp.shape, sp.axes) if a in axes)
        t.mul_(math.sqrt(sp.shape[0] / k))
    return params


def _model_cfg(arch, layers=None):
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    cfg = FAMILY_ARCH(cfg) if FAMILY_ARCH else cfg
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=min(layers,
                                                      cfg.num_layers))
    return cfg


def _one_card_train(torch, cfg, opt_cfg, seq, batch, moment=None,
                    prepare=None):
    """The port's one-card f32 train step on ``cfg``'s seeded draw (the
    ranks' seed, MODEL_SEED; then ``prepare(api, params)`` when given) at
    step index 0: loss, grad norm, host ms; with ``moment`` (a path) AdamW's
    first moment after it is saved there (``torch.save`` of its leaves,
    what ``rank_jobs.TrainJob.against`` reads)."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import SyntheticTokenStream
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps as S
    from repro_torch.tree import leaves
    api = build_model(cfg, device=DEV, dtype=torch.float32, max_seq=seq)
    params = api.init(torch.Generator(device=DEV).manual_seed(MODEL_SEED))
    if prepare is not None:
        params = prepare(api, params)
    opt = adamw.init(params)
    step = S.make_train_step(api, adamw.AdamWConfig(**opt_cfg),
                             ShapeConfig("t", seq, batch, "train"),
                             device=DEV)
    data = SyntheticTokenStream(cfg.vocab_size, batch, seq)
    _sync(torch)
    t0 = time.perf_counter()
    loss, params, opt, gnorm = step(params, opt, data.batch_at(0),
                                    np.int32(0))
    loss, gnorm = float(loss), float(gnorm)
    ms = (time.perf_counter() - t0) * 1e3
    del params
    out = {"loss": loss, "gnorm": gnorm, "ms": ms, "m": moment}
    if moment:
        torch.save([t.cpu() for t in leaves(opt.m)], moment)
    del opt, step, api
    _free(torch)
    return out


def model_train_ranks(torch, ops, smi, phase13=None, also=None):
    """25. The train step over a model axis (tensor parallelism's backward)
    with every leaf that has an embed dim split over the data axis, its
    AdamW state with it (the reference's FSDP: each layer's blocks
    gathered before use, the gradient reduce-scattered), four gloo ranks
    on the card, each drawing only its blocks of seeded weights
    (``steps.draw_params``) through ``rank_jobs.train``. (a) full-width
    llama3.2-1b in bf16 at full depth on TRAIN_MESH, phase 13's batch (8 x
    128), stream, seed and schedule, TRAIN_STEPS steps: finite losses that
    fall; param bytes a rank, and the shapes of params and AdamW's master,
    m and v, = the shard shapes of ``param_shardings`` on the whole mesh;
    before step 1 each rank's data blocks gathered over its data group =
    its model index's shard of the draw, bit for bit; the two data ranks
    of each model index hold different blocks; after every step each
    block the same bits on every rank that holds it; flash launches a
    rank = 2 x layers x steps (forward and remat recompute); prints each
    step's loss and grad norm beside phase 13's one-card run, host ms a
    step a rank, bytes a step a rank (the gathers, the reduce-scatters,
    the model axis's collectives, the rest of the data reduce) and peak
    memory a rank beside the whole-over-data layout's. (b), (c): f32 at
    cut depth (TRAIN_F32_CASES: glm4-9b with two KV heads whole over 4
    and qwen2-moe-a2.7b on (1, 4); qwen2-moe-a2.7b on TRAIN_MESH, router,
    experts and shared experts over data too) on the seeded draw's
    ``_conditioned`` weights, one step each
    at index 0 against the one-card step on the same weights: loss within
    TRAIN_LOSS_RTOL, grad norm within TRAIN_GNORM_RTOL, each rank's
    gradient blocks (AdamW's first moment after the step) within
    TRAIN_GRAD_TOL of the one-card leaf's largest, errors printed before
    they are asserted. All run in one spawn (``rank_jobs.chain``), each
    one-card step before it, its first moment saved to a file that each
    rank holds its blocks against (``TrainJob.against``), and after them
    the jobs ``also(ones)`` gives (phase 26's; one start-up for both).
    Returns the ranks' launch counts, summed, and what phase 26 reads:
    ``also``'s results a rank, the one-card steps (``ones``), 25a's
    results a rank and (b) and (c)'s gradient errors by case name."""
    import dataclasses
    import tempfile

    from repro_torch.launch import rank_jobs, train
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.launch.ranks import spawn
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import steps as S
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    _free(torch)
    launches = {k: 0 for k in ops.LAUNCHES}
    moments = tempfile.TemporaryDirectory(prefix="chip_smoke_moments_")

    def row(xs, fmt="{:.3f}"):
        return ", ".join(fmt.format(x) for x in xs)

    # (a) llama3.2-1b at full depth in bf16, phase 13's run on ranks
    args = train.build_parser().parse_args(FULL_TRAIN)
    cfg = _model_cfg(args.arch)
    n = math.prod(TRAIN_MESH[0])
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    jobs = [(rank_jobs.train, rank_jobs.TrainJob(
        cfg, TRAIN_MESH, TRAIN_STEPS, args.batch, args.seq, opt=opt,
        dtype=torch.bfloat16, seed=MODEL_SEED, keep=(), check_layout=True))]
    # the precision's own gap: the one-card f32 step on the same draw
    f32 = _one_card_train(torch, cfg, dataclasses.asdict(opt), args.seq,
                          args.batch)
    # (b) and (c)'s one-card steps and jobs, so that one spawn runs them all
    B, Sq = args.batch, args.seq
    ones = {}
    for name, arch, layers, mesh in TRAIN_F32_CASES:
        assert math.prod(mesh[0]) == n
        cfg_b = _model_cfg(arch, layers)
        if (arch, layers) not in ones:
            ones[arch, layers] = _one_card_train(
                torch, cfg_b, TRAIN_F32_OPT, Sq, B, prepare=_conditioned,
                moment=os.path.join(moments.name, f"{arch}-{layers}.pt"))
        jobs.append((rank_jobs.train, rank_jobs.TrainJob(
            cfg_b, mesh, 1, B, Sq, opt=AdamWConfig(**TRAIN_F32_OPT),
            dtype=torch.float32, seed=MODEL_SEED, keep=(),
            prepare=_conditioned, against=ones[arch, layers]["m"])))
    extra = also(ones) if also is not None else []
    t0 = time.perf_counter()
    chained = spawn(rank_jobs.chain, n, backend="gloo", device=DEV,
                    args=(jobs + extra,))
    spawn_s = time.perf_counter() - t0
    moments.cleanup()
    rs = [r[0] for r in chained]
    out = {"also": [r[len(jobs):] for r in chained], "ones": ones,
           "25a": rs, "worst": {}}
    meta = build_model(cfg, device="meta", dtype=torch.bfloat16)
    specs = leaves(meta.param_specs())
    want = [sh.shard_shape(sp.shape) for sh, sp in zip(
        leaves(S.param_shardings(meta, LogicalMesh(*TRAIN_MESH))), specs)]
    want_bytes = 2 * sum(math.prod(w) for w in want)
    one_bytes = 2 * sum(math.prod(sp.shape) for sp in specs)
    for r in rs:
        assert r["param_bytes"] == want_bytes, (r["param_bytes"], want_bytes)
        assert r["param_shapes"] == want, "25a: not the reference's blocks"
        assert r["opt_shapes"] == [want] * 3, "25a: AdamW's blocks"
        assert r["layout_ok"], "25a: data blocks are not the model shard"
        assert all(math.isfinite(x) for x in r["losses"] + r["gnorms"]), r
        assert r["losses"] == rs[0]["losses"], "the ranks' losses differ"
        assert r["gnorms"] == rs[0]["gnorms"], "the ranks' grad norms differ"
        if DEV == "cuda":
            assert r["launches"]["flash_attention"] == \
                2 * cfg.num_layers * TRAIN_STEPS, r["launches"]
        for k in launches:
            launches[k] += r["launches"][k]
    losses, gnorms = rs[0]["losses"], rs[0]["gnorms"]
    assert losses[-1] < losses[0], losses
    split = rs[0]["split"]
    assert all("data" in a for a in split), split
    drawn = [sp.init not in ("ones", "zeros") for sp in specs]
    for rank, r in enumerate(rs):
        twin = _rank_coords(rank, TRAIN_MESH)
        twin["data"] = 1 - twin["data"]
        twin = rs[_rank_at(twin, TRAIN_MESH)]
        for i, mine in enumerate(r["digests"]):
            for k, axes in enumerate(split):
                assert mine[k] == rs[_holder(rank, TRAIN_MESH, axes)][
                    "digests"][i][k], ("25a: a block differs", rank, i, k)
                # the data twin holds another block of each drawn leaf
                assert not drawn[k] or mine[k] != twin["digests"][i][k], \
                    ("25a: data ranks hold one block", rank, i, k)
    one = ""
    if phase13 is not None:
        one = (f"; phase 13's one-card steps: losses "
               f"{row(phase13['losses'][:TRAIN_STEPS], '{:.4f}')}, grad "
               f"norms {row(phase13['gnorms'][:TRAIN_STEPS])}")
    one += (f"; the one-card f32 step 1 on the same draw: loss "
            f"{f32['loss']:.4f}, grad norm {f32['gnorm']:.3f}")
    peaks = [r["peak_bytes"] / 2**30 if r.get("peak_bytes") else math.nan
             for r in rs]
    per = lambda key: row([r[key] for r in rs], "{:.0f}")
    log(f"phase 25a {args.arch} full width, {cfg.num_layers} layers, bf16 "
        f"on {n} ranks ({TRAIN_MESH[1]} mesh {TRAIN_MESH[0]}), batch "
        f"{args.batch} x {args.seq}, lr {args.lr}, {TRAIN_STEPS} steps: "
        f"losses {row(losses, '{:.4f}')}, grad norms {row(gnorms)}{one}; "
        f"param bytes a rank {rs[0]['param_bytes']} = the shard shapes of "
        f"param_shardings on the whole mesh, AdamW's master, m and v the "
        f"same blocks (one card {one_bytes}); each rank's data blocks "
        f"gathered = its model index's shard of the draw; each block the "
        f"same bits on every rank that holds it after every step; host ms "
        f"a step a rank "
        f"{'; '.join(row(r['host_ms'], '{:.1f}') for r in rs)}; bytes a "
        f"step a rank: gathers {per('gather_bytes_per_step')}, "
        f"reduce-scatters {per('scatter_bytes_per_step')}, model-axis "
        f"collectives {per('model_bytes_per_step')}, the rest of the data "
        f"reduce {per('data_bytes_per_step')} (every leaf whole over "
        f"data: data reduce {WHOLE_DATA_BYTES}, model axis "
        f"{WHOLE_MODEL_BYTES}); peak allocated GiB a rank "
        f"{row(peaks, '{:.2f}')} (whole over data: {WHOLE_PEAK_GIB}); "
        f"flash launches "
        f"a rank {[r['launches']['flash_attention'] for r in rs]} [{smi}]")
    if DEV == "cuda":
        assert max(peaks) < WHOLE_PEAK_GIB, ("25a: peak", peaks)

    # (b), (c) f32 at cut depth against one card on the same draw
    gib = "{:.2f}"
    for c, (name, arch, layers, mesh) in enumerate(TRAIN_F32_CASES):
        cfg = _model_cfg(arch, layers)
        o = ones[arch, layers]
        rs = [r[c + 1] for r in chained]
        loss_err = abs(rs[0]["losses"][0] - o["loss"]) / abs(o["loss"])
        gnorm_err = abs(rs[0]["gnorms"][0] - o["gnorm"]) / abs(o["gnorm"])
        worst = max(max(r["m_err"]) for r in rs)
        for rank, r in enumerate(rs):
            assert r["losses"] == rs[0]["losses"], name
            assert r["gnorms"] == rs[0]["gnorms"], name
            if DEV == "cuda":
                assert r["launches"]["flash_attention"] == \
                    2 * cfg.num_layers, (name, r["launches"])
            for k in launches:
                launches[k] += r["launches"][k]
        dims = dict(zip(mesh[1], mesh[0]))
        M = dims["model"]
        experts = ""
        if cfg.num_experts:
            experts = (f", {cfg.num_experts // M} of {cfg.num_experts} "
                       f"experts a rank")
        if dims["data"] > 1:
            experts += (", every leaf with an embed dim over data (router, "
                        "experts, shared experts)")
        log(f"phase {name} {arch} full width, {cfg.num_layers} layers, f32 "
            f"on {n} ranks ({mesh[1]} mesh {mesh[0]}){experts}, batch {B} x "
            f"{Sq}, the seeded draw's block weights rescaled to their "
            f"contractions, one step at index 0: loss "
            f"{rs[0]['losses'][0]:.6f} against one card's {o['loss']:.6f} "
            f"(rel {loss_err:.2e}, limit {TRAIN_LOSS_RTOL}), grad norm "
            f"{rs[0]['gnorms'][0]:.4f} against {o['gnorm']:.4f} (rel "
            f"{gnorm_err:.2e}, limit {TRAIN_GNORM_RTOL}), each rank's "
            f"gradient blocks (AdamW's first moment) within {worst:.2e} of "
            f"each one-card leaf's largest (limit {TRAIN_GRAD_TOL}); host ms "
            f"the step a rank "
            f"{row([r['host_ms'][0] for r in rs], '{:.1f}')} (one card "
            f"{o['ms']:.1f}, its first step); bytes a rank: model-axis "
            f"collectives {rs[0]['model_bytes_per_step']:.0f}, gathers "
            f"{rs[0]['gather_bytes_per_step']:.0f}, reduce-scatters "
            f"{rs[0]['scatter_bytes_per_step']:.0f}; peak allocated GiB a "
            f"rank {row([r.get('peak_bytes', 0) / 2**30 for r in rs], gib)}"
            f"; flash launches a rank "
            f"{[r['launches']['flash_attention'] for r in rs]} [{smi}]")
        assert loss_err <= TRAIN_LOSS_RTOL, (name, loss_err)
        assert gnorm_err <= TRAIN_GNORM_RTOL, (name, gnorm_err)
        assert worst <= TRAIN_GRAD_TOL, (name, worst)
        out["worst"][name] = worst
    del chained
    _free(torch)
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s (the spawn "
        f"{spawn_s:.1f} s)")
    return [dict(out, launches=launches)]


# ---------------------------------------------------------------------------
# phase 26: the residual stream's sequence split over the model axis of
# ranks (ROADMAP item 10d, step 5b's rest; SP_ACT_RULES, Megatron-SP) in
# the train step and both serve steps. Its jobs run in phase 25's spawn
# (one start-up for both); every rank holds its first moment against the
# one-card one in a file, so that no rank returns its moment (with them,
# phases 25 and 26 in one spawn passed the host's 96 GiB). Sizes are
# names, for a CPU rehearsal as phases 16 to 25. 26a: phase 25a's run
# under SP_ACT_RULES; 26b: 25b's two f32 cases under SP_ACT_RULES
# against the same one-card steps; 26c: the serve
# steps of glm4-9b in f32 at SP_SERVE_LAYERS on MODEL_MESH (phase 24a's
# deepest case; 24a1 and 24a2 show the error's growth with depth) under
# SP_ACT_RULES, against phase 24's one-card step
SP_SERVE_LAYERS = (4,)
SP_GRAD_TOL = 1e-5
# 25a's losses and grad norms as recorded before the sequence split
# (PERF.md §6; H100 80GB HBM3, 700.00 W)
RECORDED_25A_LOSSES = (12.2170, 12.1860)
RECORDED_25A_GNORMS = (192.173, 198.076)
# 26a's first step against 25a's in the same spawn (the same draw and
# batch): the loss the same bits (each sum over the two model ranks the
# same partials in the same order), the grad norm within SP_GNORM_RTOL
# (the norms' gradients are summed in another order; both read 192.173,
# H100 80GB HBM3, 700.00 W)
SP_GNORM_RTOL = 1e-5


def sp_jobs(torch, ones):
    """Phase 26's rank jobs, in the order ``sp_ranks`` reads them: 26a,
    26b's cases (each held against phase 25's one-card first moment,
    ``ones``), then 26c's."""
    from repro_torch.launch import rank_jobs, train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.sharding.rules import SP_ACT_RULES
    args = train.build_parser().parse_args(FULL_TRAIN)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    jobs = [(rank_jobs.train, rank_jobs.TrainJob(
        _model_cfg(args.arch), TRAIN_MESH, TRAIN_STEPS, args.batch,
        args.seq, opt=opt, dtype=torch.bfloat16, seed=MODEL_SEED, keep=(),
        act_rules=SP_ACT_RULES))]
    for _, arch, layers, mesh in TRAIN_F32_CASES:
        if mesh is TRAIN_F32_MESH:
            jobs.append((rank_jobs.train, rank_jobs.TrainJob(
                _model_cfg(arch, layers), mesh, 1, args.batch, args.seq,
                opt=AdamWConfig(**TRAIN_F32_OPT), dtype=torch.float32,
                seed=MODEL_SEED, keep=(), prepare=_conditioned,
                act_rules=SP_ACT_RULES, against=ones[arch, layers]["m"])))
    for layers in SP_SERVE_LAYERS:
        cfg = _model_cfg("glm4-9b", layers)
        toks = torch.randint(0, cfg.vocab_size, (MODEL_B, MODEL_S),
                             generator=torch.Generator().manual_seed(24))
        jobs.append((rank_jobs.serve_steps, rank_jobs.StepsJob(
            cfg, MODEL_MESH, toks, steps=MODEL_STEPS, dtype=torch.float32,
            seed=MODEL_SEED, max_seq=MODEL_S + MODEL_STEPS,
            act_rules=SP_ACT_RULES, plain_decode=True)))
    return jobs


def sp_ranks(torch, ops, smi, phase24, phase25):
    """26. The residual stream's sequence split over the model axis
    (``SP_ACT_RULES``): between blocks each model rank holds its block of
    the sequence (``sharding.tensor_parallel``: ``gather_seq`` before each
    product, ``reduce_scatter_seq`` after, the norms on the block, their
    gradients summed over the model group once a step), four gloo ranks
    on the card running ``sp_jobs`` in phase 25's spawn (``phase25``'s
    ``also``). (a) phase 25a's run (full-width
    llama3.2-1b, bf16, full depth, TRAIN_MESH, phase 13's batch, stream,
    seed and schedule) under SP_ACT_RULES: finite losses that fall, the
    same on every rank, step 0's loss 25a's bits and its grad norm within
    SP_GNORM_RTOL of 25a's (the same spawn, draw and batch), each block
    the same bits on every rank that holds it after every step, flash
    launches a rank = 2 x layers x steps; prints losses and grad norms beside 25a's in this run and recorded,
    host ms a step a rank, bytes a step a rank (the sequence's gathers,
    its reduce-scatters, the norms' sum, the model axis's other
    collectives, beside 25a's model-axis bytes), the saved block inputs
    reckoned from the shapes and peak memory a rank beside 25a's. (b) 25b's
    f32 cases under SP_ACT_RULES, one step on the same ``_conditioned``
    weights: loss within TRAIN_LOSS_RTOL, grad norm within
    TRAIN_GNORM_RTOL and each rank's gradient blocks (AdamW's first moment)
    within SP_GRAD_TOL of the one-card leaf's largest, beside 25b's
    errors. (c) glm4-9b f32 at SP_SERVE_LAYERS: the SP prefill step's
    logits within F32_FULL_TOL of phase 24's one-card step with equal
    greedy tokens at every decode step, the same bits on every rank, each
    SP decode step the same bits as the non-SP decode step on the same
    cache and tokens; flash launches a rank = layers. Errors are printed
    before they are asserted. Returns the ranks' launch counts, summed."""
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    launches = {k: 0 for k in ops.LAUNCHES}
    chained = phase25["also"]

    def row(xs, fmt="{:.3f}"):
        return ", ".join(fmt.format(x) for x in xs)

    def count(rs):
        for r in rs:
            for k in launches:
                launches[k] += r["launches"][k]

    # (a) 25a under SP_ACT_RULES
    args = train.build_parser().parse_args(FULL_TRAIN)
    cfg = _model_cfg(args.arch)
    rs, base = [r[0] for r in chained], phase25["25a"]
    split = rs[0]["split"]
    for rank, r in enumerate(rs):
        assert all(math.isfinite(x) for x in r["losses"] + r["gnorms"]), r
        assert r["losses"] == rs[0]["losses"], "26a: the ranks' losses"
        assert r["gnorms"] == rs[0]["gnorms"], "26a: the ranks' grad norms"
        for i, mine in enumerate(r["digests"]):
            for k, axes in enumerate(split):
                assert mine[k] == rs[_holder(rank, TRAIN_MESH, axes)][
                    "digests"][i][k], ("26a: a block differs", rank, i, k)
        if DEV == "cuda":
            assert r["launches"]["flash_attention"] == \
                2 * cfg.num_layers * TRAIN_STEPS, r["launches"]
        assert r["seq_gather_bytes_per_step"] > 0 \
            and r["seq_scatter_bytes_per_step"] > 0 \
            and r["norms_bytes_per_step"] > 0, r
    count(rs)
    losses, gnorms = rs[0]["losses"], rs[0]["gnorms"]
    assert losses[-1] < losses[0], losses
    gnorm0_err = abs(gnorms[0] - base[0]["gnorms"][0]) \
        / abs(base[0]["gnorms"][0])
    dims = dict(zip(TRAIN_MESH[1], TRAIN_MESH[0]))
    M, rows = dims["model"], args.batch // dims["data"]
    # what each layer's remat checkpoint saves: its input, a rank's rows
    # and its block of the sequence (the whole sequence without SP)
    saved = cfg.num_layers * rows * (args.seq // M) * cfg.d_model * 2
    peaks = [r["peak_bytes"] / 2**30 if r.get("peak_bytes") else math.nan
             for r in rs]
    base_peaks = [r["peak_bytes"] / 2**30 if r.get("peak_bytes")
                  else math.nan for r in base]
    per = lambda key: row([r[key] for r in rs], "{:.0f}")
    log(f"phase 26a {args.arch} full width, {cfg.num_layers} layers, bf16 "
        f"on {math.prod(TRAIN_MESH[0])} ranks ({TRAIN_MESH[1]} mesh "
        f"{TRAIN_MESH[0]}) under SP_ACT_RULES (each model rank "
        f"{args.seq // M} of {args.seq} positions between blocks), batch "
        f"{args.batch} x "
        f"{args.seq}, {TRAIN_STEPS} steps: losses {row(losses, '{:.4f}')}, "
        f"grad norms {row(gnorms)} (25a in this run: losses "
        f"{row(base[0]['losses'], '{:.4f}')}, grad norms "
        f"{row(base[0]['gnorms'])}; 25a recorded: "
        f"{row(RECORDED_25A_LOSSES, '{:.4f}')}, "
        f"{row(RECORDED_25A_GNORMS)}); "
        f"step 0's loss {losses[0] - base[0]['losses'][0]:+.3e} from "
        f"25a's (limit 0), its grad norm {gnorm0_err:.2e} (limit "
        f"{SP_GNORM_RTOL}); each block the same bits on every rank that holds it "
        f"after every step; host ms a step a rank "
        f"{'; '.join(row(r['host_ms'], '{:.1f}') for r in rs)} (25a "
        f"{'; '.join(row(r['host_ms'], '{:.1f}') for r in base)}); bytes "
        f"a step a rank: sequence gathers {per('seq_gather_bytes_per_step')}"
        f", sequence reduce-scatters {per('seq_scatter_bytes_per_step')}, "
        f"the norms' model sum {per('norms_bytes_per_step')}, the model "
        f"axis's other collectives {per('model_bytes_per_step')} (25a's "
        f"model axis "
        f"{row([r['model_bytes_per_step'] for r in base], '{:.0f}')}), "
        f"data gathers {per('gather_bytes_per_step')}, reduce-scatters "
        f"{per('scatter_bytes_per_step')}; saved block inputs a rank "
        f"{saved} bytes reckoned ({saved * M} without SP); peak allocated "
        f"GiB a rank {row(peaks, '{:.2f}')} (25a {row(base_peaks, '{:.2f}')})"
        f"; flash launches a rank "
        f"{[r['launches']['flash_attention'] for r in rs]} [{smi}]")
    assert losses[0] == base[0]["losses"][0], \
        ("26a: step 0's loss is not 25a's", losses[0], base[0]["losses"][0])
    assert gnorm0_err <= SP_GNORM_RTOL, ("26a: step 0's grad norm",
                                         gnorms[0], base[0]["gnorms"][0])

    # (b) 25b's f32 cases under SP_ACT_RULES
    c = 1
    for name, arch, layers, mesh in TRAIN_F32_CASES:
        if mesh is not TRAIN_F32_MESH:
            continue
        cfg = _model_cfg(arch, layers)
        o = phase25["ones"][arch, layers]
        rs = [r[c] for r in chained]
        c += 1
        loss_err = abs(rs[0]["losses"][0] - o["loss"]) / abs(o["loss"])
        gnorm_err = abs(rs[0]["gnorms"][0] - o["gnorm"]) / abs(o["gnorm"])
        worst = max(max(r["m_err"]) for r in rs)
        for r in rs:
            assert r["losses"] == rs[0]["losses"], name
            assert r["gnorms"] == rs[0]["gnorms"], name
            if DEV == "cuda":
                assert r["launches"]["flash_attention"] == \
                    2 * cfg.num_layers, (name, r["launches"])
        count(rs)
        log(f"phase 26b {arch} full width, {cfg.num_layers} layers, f32 on "
            f"{math.prod(mesh[0])} ranks ({mesh[1]} mesh {mesh[0]}) under "
            f"SP_ACT_RULES, 25b's weights, batch {args.batch} x "
            f"{args.seq}, one step at index 0: loss "
            f"{rs[0]['losses'][0]:.6f} against one card's {o['loss']:.6f} "
            f"(rel {loss_err:.2e}, limit {TRAIN_LOSS_RTOL}), grad norm "
            f"{rs[0]['gnorms'][0]:.4f} against {o['gnorm']:.4f} (rel "
            f"{gnorm_err:.2e}, limit {TRAIN_GNORM_RTOL}), each rank's "
            f"gradient blocks within {worst:.2e} of each one-card leaf's "
            f"largest (limit {SP_GRAD_TOL}; 25b without SP "
            f"{phase25['worst'][name]:.2e}); host ms the step a rank "
            f"{row([r['host_ms'][0] for r in rs], '{:.1f}')}; bytes a rank: "
            f"sequence gathers {rs[0]['seq_gather_bytes_per_step']:.0f}, "
            f"reduce-scatters {rs[0]['seq_scatter_bytes_per_step']:.0f}, "
            f"the norms' sum {rs[0]['norms_bytes_per_step']:.0f}, the model "
            f"axis's other collectives "
            f"{rs[0]['model_bytes_per_step']:.0f}; flash launches a rank "
            f"{[r['launches']['flash_attention'] for r in rs]} [{smi}]")
        assert loss_err <= TRAIN_LOSS_RTOL, (name, loss_err)
        assert gnorm_err <= TRAIN_GNORM_RTOL, (name, gnorm_err)
        assert worst <= SP_GRAD_TOL, (name, worst)

    # (c) the serve steps of glm4-9b f32 under SP_ACT_RULES, against
    # phase 24's one-card steps of its f32 glm4-9b cases by depth
    M = dict(zip(MODEL_MESH[1], MODEL_MESH[0]))["model"]
    by_depth = {layers: name for name, arch, layers, dt in MODEL_CASES
                if arch == "glm4-9b" and dt == "f32"}
    for layers in SP_SERVE_LAYERS:
        one = phase24["one"][by_depth[layers]]
        rs = [r[c] for r in chained]
        c += 1
        cfg = _model_cfg("glm4-9b", layers)
        for r in rs:
            assert all(torch.equal(a, b) for a, b in
                       zip(r["logits"], rs[0]["logits"])), \
                f"26c {layers}: the ranks' logits differ"
            assert len(r["plain_decode_logits"]) == MODEL_STEPS
            assert all(torch.equal(a, b) for a, b in zip(
                r["logits"][1:], r["plain_decode_logits"])), \
                f"26c {layers}: SP decode differs from the plain decode"
            assert r["prefill_seq_bytes"][0] > 0, r["prefill_seq_bytes"]
            assert all(b == (0, 0) for b in r["decode_seq_bytes"])
            if DEV == "cuda":
                assert r["launches"]["flash_attention"] == cfg.num_layers, \
                    (layers, r["launches"])
        count(rs)
        errs, agree = _held(torch, rs[0]["logits"], one["logits"])
        log(f"phase 26c glm4-9b full width, {cfg.num_layers} layers, f32 on "
            f"{M} model ranks under SP_ACT_RULES: "
            f"prefill {MODEL_B} x {MODEL_S} ({MODEL_S // M} positions a rank "
            f"between blocks) and {MODEL_STEPS} greedy decode steps; logits "
            f"against phase 24's one-card step {row(errs, '{:.2e}')} of its "
            f"largest |logit| (limit {F32_FULL_TOL}), greedy tokens equal on "
            f"{agree} of {MODEL_B} rows at every step; each decode step the "
            f"same bits as the non-SP decode step on the same cache; the "
            f"whole logits the same bits on every rank; host ms a prefill "
            f"step a rank {row([r['prefill_ms'] for r in rs])} (one card "
            f"{one['prefill_ms']:.3f}); the prefill's bytes a rank: sequence "
            f"gathers {rs[0]['prefill_seq_bytes'][0]}, reduce-scatters "
            f"{rs[0]['prefill_seq_bytes'][1]}, in all "
            f"{rs[0]['prefill_bytes']}; flash launches a rank "
            f"{[r['launches']['flash_attention'] for r in rs]} [{smi}]")
        assert max(errs) < F32_FULL_TOL and agree == MODEL_B, \
            (layers, errs, agree)
    log(f"phase 26: {time.perf_counter() - t_phase:.1f} s after its jobs "
        f"ran in phase 25's spawn")
    return [{"launches": launches}]


# ---------------------------------------------------------------------------
# phase 27: the serving engine and the pipelined decoder over a model axis
# of ranks (ROADMAP item 10d, step 5c's first part): each stage's layers
# split over its model ranks (tensor parallelism inside a pod), four gloo
# ranks on the card, in phase 25's spawn. Sizes are names, for a CPU
# rehearsal as phases 16 to 26.
# 27a: phase 6's model and flags on (2, 1, 2) pod x data x model, sealed,
# on its first RANKS_REPLAN_REQUESTS requests, with phase 20's straggler
# (one live re-plan)
MODEL_SERVE_MESH = (2, 1, 2)
# 27b: f32 at full width, MODEL_SERVE_LAYERS layers, one stage: llama3.2-1b
# on (1, 2, 2) (the KV exchange beside the model axis) and glm4-9b on (1,
# 1, 4) (its 2 KV heads whole over 4: the paged kernel at kv_head0, the
# timeline's positions split), paged and timeline, against the one-card
# engine on the same draw; short prompts (the timeline prefills one token
# a step, each a round of the model group's messages)
MODEL_SERVE_LAYERS = 2
MODEL_SERVE_F32 = (("27b llama3.2-1b", "llama3.2-1b", (1, 2, 2)),
                   ("27b glm4-9b", "glm4-9b", (1, 1, 4)))
MODEL_SERVE_STREAM = dict(requests=4, prompt=(4, 13), max_new=8, seed=27)
MODEL_SERVE_CFG = dict(num_slots=8, num_stages=1, num_microbatches=2,
                       max_seq=128, prompt_capacity=48, page_size=16,
                       telemetry_interval=1000)
# 27c: the eager live re-plan held on the card (phase 20b held it on pod
# ranks before it was cut): llama3.2-1b in f32 at full width,
# MODEL_REPLAN_LAYERS layers on (2, 1, 2), unsealed, phase 20's straggler
# on stage 1 from the first telemetry tick, on 27b's prompts decoded
# longer; streams held equal to the one-card engine's, which serves the
# same draw undisturbed
MODEL_REPLAN = ("27c llama3.2-1b", "llama3.2-1b", (2, 1, 2))
MODEL_REPLAN_LAYERS = 4
MODEL_REPLAN_CFG = dict(MODEL_SERVE_CFG, num_stages=2, seal_boundary=False,
                        telemetry_interval=6)
MODEL_REPLAN_NEW = 24
# prefill kinds that run the flash kernel (``prefill_token`` decodes)
FLASH_PREFILLS = ("prefill_at", "prefill_packed", "prefill_chunk")


def _model_bytes(r):
    """Per decode step, the bytes a rank put into its model group's
    collectives: (all, the flash-decode's query gathers, its partial
    combines)."""
    return [sum(b) for b in r["model_bytes"]], \
        [b[1] for b in r["model_bytes"]], [b[2] for b in r["model_bytes"]]


def _reckoned_model_bytes(cfg, stage, layers, nm, b, esz):
    """Bytes a rank of pipelined stage ``stage`` (of 2) over ``layers``
    layers puts into the model group's collectives in one decode step of
    ``nm`` microbatches of ``b`` rows, over a model axis of 2 (from the
    code, ``sharding/tensor_parallel.py``): two f32 [b, 1, d]
    ``reduce_model`` a layer; on stage 0 the vocab-split embedding's rows
    (a reduce), on stage 1 the opened activation broadcast from model
    rank 0 in the model's dtype and the head's f32 [b, V / 2] columns
    gathered."""
    d, V = cfg.d_model, cfg.vocab_size
    per = 2 * layers * b * d * 4
    per += b * d * 4 if stage == 0 else b * d * esz + b * (V // 2) * 4
    return nm * per


def model_serve_jobs(torch, ops):
    """Phase 27's rank jobs (``rank_jobs.serve``, four ranks) and what its
    checks read: 27a's run, and 27b's runs with the one-card engine's
    streams, logits and host ms on the same draw (run here, before the
    spawn)."""
    import dataclasses

    import numpy as np

    from repro_torch.launch import rank_jobs, serve
    from repro_torch.models.api import build_model
    from repro_torch.serving import EngineConfig, ServingEngine
    args = _phase6_args()
    cfg = _family_cfg("llama3.2-1b")
    reqs = [(p, args.max_new) for p in serve.gen_prompts(
        args, cfg.vocab_size)][:RANKS_REPLAN_REQUESTS]
    run_a = rank_jobs.ServeRun(serve.make_config(args), reqs,
                               every=args.arrival_every,
                               inject=RANKS_STRAGGLER, check_swaps=True)
    jobs = [(rank_jobs.serve, rank_jobs.ServeJob(
        cfg, [run_a], dtype=torch.bfloat16, seed=args.seed,
        data=MODEL_SERVE_MESH[1], model=MODEL_SERVE_MESH[2]))]
    rng = np.random.RandomState(MODEL_SERVE_STREAM["seed"])
    stream = [(rng.randint(1, 500, size=int(rng.randint(
        *MODEL_SERVE_STREAM["prompt"]))).tolist(),
        MODEL_SERVE_STREAM["max_new"])
        for _ in range(MODEL_SERVE_STREAM["requests"])]
    one = {}
    for name, arch, mesh in MODEL_SERVE_F32:
        cf = get_arch_at(arch, MODEL_SERVE_LAYERS)
        runs = [rank_jobs.ServeRun(EngineConfig(kv_layout=kv,
                                                **MODEL_SERVE_CFG), stream,
                                   keep_logits=True)
                for kv in ("paged", "timeline")]
        api = build_model(cf, device=DEV, dtype=torch.float32, max_seq=128)
        params = api.init(torch.Generator(device=DEV).manual_seed(0))
        for kv, run in zip(("paged", "timeline"), runs):
            config = dataclasses.replace(
                run.config, num_microbatches=mesh[1] * run.config
                .num_microbatches)
            eng = ServingEngine(api, config, params, device=DEV,
                                backend="pipelined")
            probe = rank_jobs.Probe(eng, True)
            got = rank_jobs.drive(eng, dataclasses.replace(run,
                                                           config=config))
            body = eng.backend.body if kv == "paged" else \
                eng.backend.cache[api.model.served_segment.name]
            one[(name, kv)] = dict(
                streams=[list(r.generated) for r in got],
                logits=probe.logits, step_ms=probe.step_ms,
                kv_bytes=sum(t.numel() * t.element_size()
                             for t in _leaves(body)))
            del eng, probe
        del api, params
        _free(torch)
        jobs.append((rank_jobs.serve, rank_jobs.ServeJob(
            cf, runs, dtype=torch.float32, seed=0, max_seq=128,
            data=mesh[1], model=mesh[2])))
    # 27c: the one-card engine undisturbed, the ranks with the straggler
    name, arch, mesh = MODEL_REPLAN
    cf = get_arch_at(arch, MODEL_REPLAN_LAYERS)
    longer = [(p, MODEL_REPLAN_NEW) for p, _ in stream]
    api = build_model(cf, device=DEV, dtype=torch.float32, max_seq=128)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    calm = EngineConfig(**dict(MODEL_REPLAN_CFG, telemetry_interval=1000))
    eng = ServingEngine(api, calm, params, device=DEV, backend="pipelined")
    one[name] = dict(streams=[list(r.generated) for r in rank_jobs.drive(
        eng, rank_jobs.ServeRun(calm, longer))])
    del eng, api, params
    _free(torch)
    jobs.append((rank_jobs.serve, rank_jobs.ServeJob(
        cf, [rank_jobs.ServeRun(EngineConfig(**MODEL_REPLAN_CFG), longer,
                                inject=RANKS_STRAGGLER)],
        dtype=torch.float32, seed=0, max_seq=128, data=mesh[1],
        model=mesh[2])))
    return jobs, dict(args=args, cfg=cfg, reqs=reqs, one=one)


def serve_model_ranks(torch, ops, smi, phase6=None, served=None):
    """27. ``ServingEngine(mesh=)`` over a pod x data x model mesh of four
    gloo ranks on the card, from ``model_serve_jobs`` (``served``: the
    jobs' ranks' results and their context, from phase 25's spawn; run
    here in a spawn of their own when None). (a) Phase 6's model
    (full-width llama3.2-1b, bf16, 16 layers, stage blocks (1, 15) as
    phase 6 plans them) and flags on (2, 1, 2), sealed, its first
    RANKS_REPLAN_REQUESTS requests, with phase 20's straggler: model rank
    0 of each stage seals and sends the crossings, the model ranks split
    each stage's heads, columns and vocab. Held: one live re-plan that
    migrates layers; swap-outs > 0 and every swapped page restored bit
    for bit (``Probe``); paged launches a rank = microbatches x the layers
    it held at each decode step + the layers at each of its stage probes,
    flash = the layers at each prefill call, seals on stage 0's model rank
    0 only (microbatches x steps), unseals on stage 1's; the model group's
    bytes a rank over the run = the reckoned count at each step's layers
    (``_reckoned_model_bytes``); every rank's events and stats equal; no
    (key, counter) pair twice. Printed, not held (bf16 over a model axis:
    ROADMAP §3): how many streams equal phase 6's, host ms a decode step
    a rank, param and KV bytes a rank. (b) f32, MODEL_SERVE_LAYERS
    layers, one stage: MODEL_SERVE_F32 paged and timeline against the
    one-card engine on the same draw at microbatches x data
    microbatches: streams equal, decode logits within F32_FULL_TOL of
    each step's largest |logit|; glm4-9b's ranks hold the whole pool (2
    KV heads) and a quarter of the timeline's positions, and its
    timeline steps send the flash-decode's query gathers and partial
    combines. (c) MODEL_REPLAN: f32, unsealed, on (2, 1, 2) with the
    straggler: a live re-plan that migrates layers, every rank's streams
    equal to the undisturbed one-card engine's on the same draw. Returns
    the ranks' launch counts, summed."""
    from repro_torch.launch import rank_jobs
    from repro_torch.launch.ranks import spawn
    from repro_torch.models.api import build_model
    t_phase = time.perf_counter()
    if phase6 is None:                    # run alone: phase 6 first
        args0 = _phase6_args()
        cfg0 = _family_cfg("llama3.2-1b")
        api = build_model(cfg0, device=DEV, dtype=torch.bfloat16)
        params = api.init(torch.Generator(device=DEV).manual_seed(
            args0.seed))
        phase6 = serve_full_width(torch, ops, api, params,
                                  [DEV if a == "cuda" else a
                                   for a in RANKS_SERVE], 6,
                                  plan=(1, cfg0.num_layers - 1))
        del api, params
        _free(torch)
    if served is None:
        jobs, ctx = model_serve_jobs(torch, ops)
        out = spawn(rank_jobs.chain, 4, backend="gloo", device=DEV,
                    args=(jobs,))
    else:
        out, ctx = served
    args, cfg, reqs, one = ctx["args"], ctx["cfg"], ctx["reqs"], ctx["one"]
    L, nm = cfg.num_layers, args.microbatches
    launches = {k: 0 for k in ops.LAUNCHES}
    for res in out:
        for job in res:
            for r in job:
                for k in launches:
                    launches[k] += r["launches"][k]
    for j, job in enumerate(out[0]):      # decisions and keys, every run
        for i in range(len(job)):
            rs = [res[j][i] for res in out]
            for r in rs[1:]:
                assert r["events"] == rs[0]["events"] and \
                    r["stats"] == rs[0]["stats"], ("27: decisions", j, i)
            bad = rank_jobs.keystream_reuse([r["keys"] for r in rs])
            assert not bad, ("27: a (key, counter) pair ciphered twice", j,
                             i, bad[:3])
    # (a) phase 6's model on (2, 1, 2) with a live re-plan
    a = [res[0][0] for res in out]
    st = a[0]["stats"]
    assert st["swaps"] >= 1 and any(kind == "swap" and e["migrated"]
                                    for _, kind, e in a[0]["events"]), st
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0, st
    esz, b = 2, args.slots // nm
    for r in a:
        assert r["status"] == ["done"] * len(reqs), r["status"]
        assert r["restored"] > 0 and r["restored"] == a[0]["restored"]
        steps, lc, lead = r["decode_steps"], r["launches"], r["model"] == 0
        assert len(r["step_layers"]) == steps, (steps, r["step_layers"])
        if DEV == "cuda":
            assert lc["paged_attention"] == nm * sum(r["step_layers"]) + \
                sum(r["probe_layers"]), (r["stage"], r["model"], lc)
            assert lc["flash_attention"] == sum(
                n for kind, n in r["prefill_layers"]
                if kind in FLASH_PREFILLS), (r["stage"], r["model"], lc)
            assert lc["seal"] == (nm * steps if r["stage"] == 0 and lead
                                  else 0), lc
            assert lc["unseal"] == (nm * steps if r["stage"] == 1 and lead
                                    else 0), lc
        total, qg, comb = _model_bytes(r)
        assert not any(qg) and not any(comb), "27a: no flash-decode here"
        r["reckoned"] = sum(_reckoned_model_bytes(
            cfg, r["stage"], n, nm, b, esz) for n in r["step_layers"])
        assert sum(total) == r["reckoned"], (r["stage"], r["model"],
                                              sum(total), r["reckoned"])
    swaps = ", ".join(f"{e['from']}->{e['to']}" for _, kind, e
                      in a[0]["events"] if kind == "swap")
    same = sum(x == y for x, y in zip(a[0]["streams"], phase6["streams"]))
    log(f"phase 27a llama3.2-1b ({L} layers) bf16 on (2, 1, 2) pod x data "
        f"x model ranks, sealed, phase 6's first {len(reqs)} requests with "
        f"--inject-straggler 1:10: {st['swaps']} live swaps ({swaps}), final "
        f"stage blocks {st['stage_blocks']}, every model rank moving its own "
        f"blocks (a restage's host ms and bytes a rank "
        f"{[[(round(m, 2), n) for m, n in r['restages']] for r in a]}); "
        f"{same} of {len(reqs)} streams equal phase 6's one-card streams "
        f"(bf16 over a model axis, and the int8 boundary moved: printed, "
        f"not held); {st['completed']} requests, {a[0]['decode_steps']} "
        f"decode steps, swap-outs {st['swap_outs']}, swap-ins "
        f"{st['swap_ins']}, {a[0]['restored']} pages restored bit-exact on "
        f"every rank ({a[0]['relayouts']} swap-ins across the re-plan); "
        f"host ms a decode step p50 a rank (stage, model) "
        f"{[(r['stage'], r['model'], round(_p50(r['step_ms']), 3)) for r in a]}"
        f" (phase 6 one card {phase6['step_ms']:.3f} mean); model-group "
        f"bytes a rank over the run "
        f"{[(r['stage'], r['model'], sum(_model_bytes(r)[0])) for r in a]} = "
        f"reckoned, p50 a step {[_p50(_model_bytes(r)[0]) for r in a]}; "
        f"crossing bytes sent a step p50 {[_p50(r['step_bytes']) for r in a]}"
        f"; param GiB a rank {[round(r['param_bytes'] / 2**30, 3) for r in a]}"
        f", KV GiB a rank {[round(r['kv_bytes'] / 2**30, 3) for r in a]}; "
        f"admission p50 / p99 {st['admission_p50_ms']:.1f} / "
        f"{st['admission_p99_ms']:.1f} ms; paged / flash launches a rank "
        f"{[(r['launches']['paged_attention'], r['launches']['flash_attention']) for r in a]}"
        f" [{smi}]")
    # (b) f32 against one card
    for j, (name, arch, mesh) in enumerate(MODEL_SERVE_F32):
        cf = get_arch_at(arch, MODEL_SERVE_LAYERS)
        for i, kv in enumerate(("paged", "timeline")):
            rs, o = [res[j + 1][i] for res in out], one[(name, kv)]
            errs = []
            for r in rs:
                assert r["streams"] == o["streams"], (name, kv)
                assert len(r["logits"]) == len(o["logits"]) > 0
                errs.append(max(_rel(x, y) for x, y in
                                zip(r["logits"], o["logits"])))
                if DEV == "cuda" and kv == "paged":
                    assert r["launches"]["paged_attention"] > 0 and \
                        r["launches"]["flash_attention"] > 0, r["launches"]
            assert max(errs) < F32_FULL_TOL, (name, kv, errs)
            total, qg, comb = _model_bytes(rs[0])
            heads = rs[0]["kv_shapes"][0][2]
            if kv == "timeline" and cf.num_kv_heads % mesh[2]:
                assert all(s[3] == 128 // mesh[2]
                           for s in rs[0]["kv_shapes"]), rs[0]["kv_shapes"]
                assert all(qg) and all(comb), (qg, comb)
            log(f"phase {name} f32, {cf.num_layers} layers, {kv}, on "
                f"{mesh} pod x data x model ranks: streams equal the "
                f"one-card engine's on the same draw ({len(o['streams'])} "
                f"requests); decode logits within {max(errs):.2e} of each "
                f"step's largest |logit| (limit {F32_FULL_TOL}); KV heads a "
                f"rank {heads} of {cf.num_kv_heads}"
                + (f", positions a rank {rs[0]['kv_shapes'][0][3]} of 128"
                   if kv == "timeline" else "")
                + f"; KV bytes a rank {rs[0]['kv_bytes']} (one card "
                f"{o['kv_bytes']}); host ms a decode step p50 a rank "
                f"{[round(_p50(r['step_ms']), 3) for r in rs]} (one card "
                f"{_p50(o['step_ms']):.3f}); model-group bytes a step p50 "
                f"{_p50(total)}, of them query gathers {_p50(qg)} and "
                f"partial combines {_p50(comb)}; paged launches a rank "
                f"{[r['launches']['paged_attention'] for r in rs]} [{smi}]")
    # (c) the eager live re-plan in f32 against one card
    name, arch, mesh = MODEL_REPLAN
    rs = [res[len(MODEL_SERVE_F32) + 1][0] for res in out]
    st = rs[0]["stats"]
    for r in rs:
        assert r["streams"] == one[name]["streams"], \
            ("27c: the streams differ from the one-card engine's across "
             "the live re-plan", r["stage"], r["model"])
    moved = [f"{e['from']}->{e['to']}" for _, kind, e in rs[0]["events"]
             if kind == "swap" and e["migrated"]]
    assert st["swaps"] >= 1 and moved, rs[0]["events"]
    log(f"phase {name} f32, {MODEL_REPLAN_LAYERS} layers, unsealed, on "
        f"{mesh} pod x data x model ranks with --inject-straggler 1:10: "
        f"live swaps {', '.join(moved)} (final stage blocks "
        f"{st['stage_blocks']}), every model rank moving its own blocks; "
        f"streams equal the undisturbed one-card engine's on the same draw "
        f"({len(rs[0]['streams'])} requests, {rs[0]['decode_steps']} decode "
        f"steps); a restage's host ms and bytes a rank "
        f"{[[(round(m, 2), n) for m, n in r['restages']] for r in rs]} "
        f"[{smi}]")
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s reading the "
        f"jobs' results" + (" (run in phase 25's spawn)" if served else ""))
    return [{"launches": launches}]


def _phase6_args():
    """Phase 6's parsed flags at ``DEV``."""
    from repro_torch.launch import serve
    return serve.build_parser().parse_args(
        [DEV if a == "cuda" else a for a in RANKS_SERVE])


def get_arch_at(arch, layers):
    """``arch``'s config (FAMILY_ARCH's map of it in a rehearsal) cut to
    ``layers`` layers."""
    import dataclasses

    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    cfg = FAMILY_ARCH(cfg) if FAMILY_ARCH else cfg
    return dataclasses.replace(cfg, num_layers=min(layers, cfg.num_layers))


def _sharding_leaves(tree):
    from repro_torch.sharding.rules import NamedSharding
    if isinstance(tree, NamedSharding):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _sharding_leaves(v)
    else:
        for v in tree:
            yield from _sharding_leaves(v)


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
    check_paged_rank(torch, ops, ref)
    for cols in CIPHER_COLS.values():
        check_cipher(torch, ops, ref, sealing, cols=cols)
    check_cipher_window(torch, ops, ref, sealing)
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
    phase13 = train_full_width(torch, ops, smi[0] if smi else "unavailable")
    runs.append(phase13)
    # phase 14: the timeline KV layout, per-token prefill and the int8
    # cache on full-width llama3.2-1b
    runs += serve_timeline(torch, ops, smi[0] if smi else "unavailable")
    # phase 15: the paper's planning and privacy path: the LM similarity
    # profile of full-width llama3.2-1b (flash a layer), TinyCNN and the
    # image metric, the Fig. 12 claims, the attestation stub
    runs += plan_privacy(torch, ops, smi[0] if smi else "unavailable")
    # phase 16: qwen2-vl-7b, hymba-1.5b and moonshot-v1-16b-a3b at full
    # width, and glm4-9b served; the new kernel shapes first
    t16 = time.perf_counter()
    smi0 = smi[0] if smi else "unavailable"
    check_family_kernels(torch, ops, ref, F)
    runs += family_vlm(torch, ops, smi0)
    runs += family_hymba(torch, ops, smi0)
    runs += family_glm4(torch, ops, smi0, runs[0]["step_ms"])
    runs += family_moonshot(torch, ops, smi0)
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")
    # phase 17: xlstm-125m served on the timeline and whisper-small through
    # the model API at full width (Whisper's flash shapes were held in
    # phase 16's kernel checks)
    t17 = time.perf_counter()
    runs += family_xlstm(torch, ops, smi0)
    runs += family_whisper(torch, ops, smi0)
    log(f"phase 17: {time.perf_counter() - t17:.1f} s")
    # phase 18: the mesh, the sharding trees, the serve steps, the
    # calibration and the dry-run on full-width llama3.2-1b
    runs += mesh_steps(torch, ops, smi0)
    # phase 19: the pod axis over ranks on the card (gloo): the pipelined
    # decoder one stage a rank, the compressed train step over two pods
    runs += pod_ranks(torch, ops, smi0)
    # phase 20 (the engine on 2 pod ranks) was cut for the script's time:
    # 21, 22 and 27a serve over the pod axis, and 21c holds its payload
    # check
    # phase 21: the data axis over ranks: phase 6's stream and the serve
    # steps on a 2 x 2 pod x data mesh
    # (phase 22's engines run in its spawn)
    runs += serve_data_ranks(torch, ops, smi0, runs[1],
                             also=warm_jobs(torch))
    phase21_eager = runs[-1]["eager"]
    # phase 22: warmup over ranks: phase 21's stream warmed as CUDA graphs
    # on the 2 x 2 ranks, and the live re-plan line warmed
    runs += serve_warm_ranks(torch, ops, smi0, runs[1], runs[-1]["eager"],
                             runs[-1]["also"])
    # phase 23: the disaggregated pair over ranks: phase 21's stream
    # through the pair on the 2 x 2 ranks, eager and warmed, and the
    # reference's chaos-over-disagg line
    runs += serve_disagg_ranks(torch, ops, smi0, runs[1], phase21_eager,
                               runs[6:8])
    # phases 24 to 27 run their rank jobs in one spawn of four ranks (one
    # start-up), phase 25's: 24's and 27's one-card runs first
    t27 = time.perf_counter()
    jobs24, ctx24 = model_jobs(torch)
    t24, t27 = time.perf_counter() - t27, time.perf_counter()
    jobs27, ctx27 = model_serve_jobs(torch, ops)
    t27 = time.perf_counter() - t27
    log(f"phases 24 and 27: their one-card steps and engines {t24:.1f} s "
        f"and {t27:.1f} s before phase 25's spawn")
    n24, n27 = len(jobs24), len(jobs27)
    # phase 25: the model axis's train step over ranks: llama3.2-1b at full
    # depth on (2, 2) data x model, glm4-9b and qwen2-moe-a2.7b in f32;
    # phases 24, 27 and 26's jobs run in its spawn
    runs += model_train_ranks(
        torch, ops, smi0, phase13,
        also=lambda ones: jobs24 + jobs27 + sp_jobs(torch, ones))
    phase25 = runs[-1]
    chained = phase25["also"]
    phase25["also"] = [r[n24 + n27:] for r in chained]
    # phase 24: the model axis over ranks: the serve steps with tensor
    # parallelism on four ranks, glm4-9b and qwen2-moe-a2.7b
    runs += model_ranks(torch, ops, smi0,
                        served=([r[:n24] for r in chained], ctx24))
    # phase 26: the sequence split over the model axis (SP_ACT_RULES): 25a
    # and 25b under it, glm4-9b's serve steps at 4 layers
    runs += sp_ranks(torch, ops, smi0, runs[-1], phase25)
    # phase 27: the serving engine over a pod x data x model mesh: phase
    # 6's model sealed on (2, 1, 2) with a live re-plan, llama3.2-1b and
    # glm4-9b in f32 against one card, and a live re-plan in f32
    runs += serve_model_ranks(torch, ops, smi0, runs[1], (
        [r[n24:n24 + n27] for r in chained], ctx27))
    del chained
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
            ("seal_bits_window", src + "seal_bits.cu",
             "src/repro/kernels/seal.py:106", 0.0),
            ("unseal_bits_window", src + "seal_bits.cu",
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
