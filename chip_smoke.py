#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a, one process per source in parallel);
  2. hold every kernel against its plain PyTorch version on the card at the
     serving path's shapes (paged attention: bf16 pools, 8 rows, 8 KV heads,
     rep 4, head_dim 64, page 16, ragged seq_lens with an idle row, shared
     pages; page cipher: [pages_per_slot, 131072] f32 and bf16, bit-exact);
  3. time each kernel, its plain version, one PyTorch library call of the
     same function, and compute the least time the card could take;
  4. check the whole serving path on a small input: reduced llama3.2-1b in
     f32 serves the same greedy streams on the card as on the CPU;
  5. serve full-width llama3.2-1b (16 layers, d_model 2048, vocab 128,256)
     in bf16 with seeded random weights through ``ServingEngine``: 8 slots,
     16 requests with a shared system prompt, 32 new tokens each, a page
     pool tight enough that demand paging swap-preempts. The launch counts
     are zeroed just before and read just after: paged attention must have
     run num_layers times per decode step, the cipher on every swap, and
     every swap-in must restore the gathered pages bit for bit.
The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and convolutions,
so f32 products are full f32. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
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


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events. A spin kernel keeps the stream busy while the host
    enqueues the calls, so host launch overhead does not show up as device
    time; operands stay L2-resident between calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda._sleep(int(min(3 * iters * host_s, 2.0) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, op_rate: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def paged_inputs(torch, dtype, B=8, KVH=8, rep=4, D=64, Pg=16, MP=10, N=30,
                 seed=0):
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
    sl = np.array([MP * Pg, 0, 1, 17, 100, 128, MP * Pg - 1, 64], np.int32)
    sl = sl[:B]
    bt = rng.randint(1, N, size=(B, MP)).astype(np.int32)
    bt[5, :4] = bt[4, :4]                          # shared prefix pages
    bt[1] = 0                                      # idle row: null table
    for b in range(B):
        bt[b, -(-int(sl[b]) // Pg):] = 0           # null tail past the length
    dev = "cuda"
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.from_numpy(bt).to(dev), torch.from_numpy(sl).to(dev))


def check_paged_attention(torch, ops, ref):
    """Kernel vs plain version on the card. Rows with seq_len > 0 must
    agree: bf16 within atol 1e-3 + rtol 1e-2 (both sides accumulate in f32
    and round once to bf16, whose spacing is 2**-8..2**-7 of the value, so
    they may land one bf16 step apart), f32 within atol = rtol = 3e-5.
    Idle rows: the kernel writes zeros (the engine ignores them), the plain
    version the reference's uniform mean; both must be finite."""
    results = {}
    for dtype, tol in ((torch.bfloat16, dict(atol=1e-3, rtol=1e-2)),
                       (torch.float32, dict(atol=3e-5, rtol=3e-5))):
        q, k, v, bt, sl = paged_inputs(torch, dtype)
        got = ops.paged_attention(q, k, v, bt, sl)
        want = ref.paged_attention_ref(q, k, v, bt, sl)
        torch.cuda.synchronize()
        live = sl > 0
        assert torch.isfinite(got.float()).all() and \
            torch.isfinite(want.float()).all()
        assert not got[~live].float().any(), "idle rows must be zero"
        err = (got[live].float() - want[live].float()).abs().max().item()
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   **tol)
        results[str(dtype)] = err
        log(f"check paged_attention {dtype}: max_abs_err={err:.3e} "
            f"({tol}) rows={int(live.sum())} live + {int((~live).sum())} idle")
    return results


def check_cipher(torch, ops, ref, sealing, MP=10, cols=131072):
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


def time_kernels(torch, ops, ref, sealing, F):
    """ms of each kernel, its plain version and a library call, at the
    checked shapes, plus the bound."""
    out = {}
    q, k, v, bt, sl = paged_inputs(torch, torch.bfloat16)
    B, H, D = q.shape
    N, KVH, Pg, _ = k.shape
    MP = bt.shape[1]
    rep = H // KVH
    ms = time_ms(lambda: ops.paged_attention(q, k, v, bt, sl))
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
    out["paged_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                  bound_ms=b_ms, bound_by=b_by,
                                  bytes=nbytes, flops=flops)
    log(f"time paged_attention bf16 B={B} KVH={KVH} rep={rep} D={D} Pg={Pg} "
        f"MP={MP}: kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
        f"sdpa {lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}, "
        f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP)")

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(10, 131072, generator=g, device="cuda").to(torch.bfloat16)
    ctr = sealing._swap_counter(3, 0)
    c = ops.seal_bits(x, 0xC0FFEE, ctr)
    ks = ref.seal_bits_ref(torch.zeros_like(x), 0xC0FFEE, ctr)
    xi = x.view(torch.int16)
    nbytes = 2.0 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, KEYSTREAM_OPS * x.numel(), INT32_OP_PER_S)
    lib = time_ms(lambda: torch.bitwise_xor(xi, ks))
    for name, fn, plain_fn in (
            ("seal_bits", lambda: ops.seal_bits(x, 0xC0FFEE, ctr),
             lambda: ref.seal_bits_ref(x, 0xC0FFEE, ctr)),
            ("unseal_bits",
             lambda: ops.unseal_bits(c, 0xC0FFEE, ctr, torch.bfloat16),
             lambda: ref.unseal_bits_ref(c, 0xC0FFEE, ctr, torch.bfloat16))):
        ms = time_ms(fn)
        plain = time_ms(plain_fn, 20)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, bytes=nbytes)
        log(f"time {name} bf16 [10, 131072]: kernel {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, xor {lib * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB)")
    return out


def small_reference_check(torch):
    """The whole serving path on a small input: reduced llama3.2-1b, f32,
    the same weights and prompts on the card and on the CPU, a pool tight
    enough to swap. Greedy streams and paging decisions must be equal."""
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    args = serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
         "--slots", "4", "--requests", "10", "--prompt-len", "16",
         "--max-new", "8", "--page-size", "4", "--num-pages", "12", "--f32",
         "--shared-system-prompt", "0.5"])
    cpu_api, params, _ = serve.build(args)
    prompts = serve.gen_prompts(args, cpu_api.cfg.vocab_size)
    runs = []
    for device in ("cpu", "cuda"):
        api = build_model(cpu_api.cfg, device=device, dtype=torch.float32)
        eng = serve.ServingEngine(api, serve.make_config(args),
                                  _to(torch, params, device), device=device)
        reqs = serve.serve_stream(eng, args, prompts)
        runs.append(([r.generated for r in reqs], eng.stats()))
    (a, sa), (b, sb) = runs
    assert a == b, f"greedy streams differ card vs CPU:\n{a}\n{b}"
    for key in ("preemptions", "swap_outs", "swap_ins", "cow_hits", "steps"):
        assert sa[key] == sb[key], (key, sa[key], sb[key])
    assert sb["swap_ins"] > 0, "small check never swapped"
    log(f"check serving path, reduced f32 card vs CPU: {len(a)} streams "
        f"equal, swap_outs={sb['swap_outs']} swap_ins={sb['swap_ins']} "
        f"cow_hits={sb['cow_hits']}")


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    return tree.to(device)


def serve_full_width(torch, ops, sealing):
    """Phase 5: the main path at full width, with launch counts."""
    from repro_torch.launch import serve
    argv = ["--arch", "llama3.2-1b", "--device", "cuda", "--slots", "8",
            "--requests", "16", "--prompt-len", "128", "--max-new", "32",
            "--page-size", "16", "--num-pages", "30",
            "--shared-system-prompt", "0.75"]
    args = serve.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    api, params, _ = serve.build(args)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: llama3.2-1b full width, {api.cfg.num_layers} layers, "
        f"d_model {api.cfg.d_model}, vocab {api.cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.1f} s")
    # warm-up: a short stream on its own engine (cuBLAS handles, allocator)
    warm = serve.build_parser().parse_args(argv + ["--requests", "2"])
    weng = serve.ServingEngine(api, serve.make_config(warm), params,
                               device="cuda")
    serve.serve_stream(weng, warm, serve.gen_prompts(warm, api.cfg.vocab_size))
    del weng

    eng = serve.ServingEngine(api, serve.make_config(args), params,
                              device="cuda")
    be = eng.backend
    gathered, restored = {}, []
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
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

    def step(tokens):
        logits = orig_step(tokens)
        bad.add_((~torch.isfinite(logits)).sum())
        return logits

    be.gather_pages, be.scatter_pages, be.step = gather, scatter, step
    prompts = serve.gen_prompts(args, api.cfg.vocab_size)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = serve.serve_stream(eng, args, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    st = eng.stats()
    n_layers = api.cfg.num_layers

    assert len(reqs) == args.requests
    assert all(r.status == "done" and len(r.generated) == args.max_new
               for r in reqs), "a request did not complete"
    assert all(0 <= t < api.cfg.vocab_size for r in reqs for t in r.generated)
    assert int(bad.item()) == 0, "non-finite logits"
    assert st["preemptions"] >= 1 and st["swap_outs"] >= 1, st
    assert st["swap_ins"] >= 1 and restored, st
    assert launches["paged_attention"] == be.steps * n_layers, \
        (launches, be.steps)
    assert launches["seal_bits"] == 2 * st["swap_outs"], launches
    assert launches["unseal_bits"] == 2 * st["swap_ins"], launches
    assert launches["seal_bits"] + launches["unseal_bits"] >= 4, launches
    eng.check_page_invariants()
    step_ms = st["decode_wall_s"] / max(st["steps"], 1) * 1e3
    log(f"serve: {st['completed']} requests, {st['tokens_out']} tokens, "
        f"{st['steps']} decode steps, {st['tok_per_s']:.1f} tok/s decode, "
        f"{step_ms:.2f} ms/decode step (host clock, 8 slots), "
        f"wall {wall:.2f} s incl. admission prefill")
    log(f"serve: preemptions={st['preemptions']} swap_outs={st['swap_outs']} "
        f"swap_ins={st['swap_ins']} pages restored bit-exact="
        f"{len(restored)} cow_hits={st['cow_hits']} forks={st['forks']} "
        f"admission_p50={st.get('admission_p50_ms', 0):.1f} ms")
    log(f"serve: launches {launches} (paged_attention = {be.steps} steps x "
        f"{n_layers} layers)")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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

    # phase 2: kernels vs plain versions
    pa_err = check_paged_attention(torch, ops, ref)
    check_cipher(torch, ops, ref, sealing)
    # phase 3: timings and bounds
    times = time_kernels(torch, ops, ref, sealing, F)
    # phase 4: whole serving path on a small input, card vs CPU
    small_reference_check(torch)
    # phase 5: the main path at full width
    launches = serve_full_width(torch, ops, sealing)

    src = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, source, replaces, err in (
            ("paged_attention", src + "paged_attention.cu",
             "src/repro/kernels/paged_attention.py:33",
             pa_err["torch.bfloat16"]),
            ("seal_bits", src + "seal_bits.cu",
             "src/repro/kernels/seal.py:106", 0.0),
            ("unseal_bits", src + "seal_bits.cu",
             "src/repro/kernels/seal.py:106", 0.0)):
        t = times[name]
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
