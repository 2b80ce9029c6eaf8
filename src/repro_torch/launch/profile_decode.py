"""Where a decode step's (or a prefill chunk's) time goes on the card.

    python -m repro_torch.launch.profile_decode [--steps 8]
        [--backend local|pipelined] [--trace decode_trace.json]
    python -m repro_torch.launch.profile_decode --prefill [--steps 8]

Builds full-width llama3.2-1b (bf16, seeded random weights), fills all 8
slots with 128-token prompts, runs a few warm-up steps, then traces
``--steps`` engine steps with ``torch.profiler`` (CPU + CUDA activities)
on the chosen backend (``pipelined``: the planned two stages, two
microbatches, sealed boundaries). Telemetry ticks are kept out of the
traced window, so it holds decode steps only.
Prints the host-clock time per step, the device-busy time per step (sum
of kernel time) and the idle share, then the kernels by device time and
the operators by host time. With ``--prefill`` the traced unit is one
``prefill_chunk_fn`` call instead: a 512-token prompt in four 128-token
chunks (the last three attend over a prefix gathered from the pools),
repeated until ``--steps`` chunks ran. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine

SLOTS, PROMPT_LEN, WARMUP_STEPS, TOP = 8, 128, 4, 20
CHUNK, CHUNKED_PROMPT, PAGE = 128, 512, 16


def _dev_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--backend", default="local",
                    choices=["local", "pipelined"])
    ap.add_argument("--trace", default="")
    ap.add_argument("--prefill", action="store_true",
                    help="profile 128-token prefill chunks, not decode steps")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("llama3.2-1b")
    api = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    if args.prefill:
        return profile_chunks(api, params, args)
    max_new = WARMUP_STEPS + args.steps + 8
    eng = ServingEngine(api, EngineConfig(
        num_slots=SLOTS, prompt_capacity=PROMPT_LEN,
        request_capacity=PROMPT_LEN + max_new, telemetry_interval=10_000),
        params, device="cuda", backend=args.backend)
    rng = np.random.RandomState(0)
    for _ in range(SLOTS):
        eng.submit(rng.randint(0, cfg.vocab_size, size=PROMPT_LEN).tolist(),
                   max_new)
    for _ in range(WARMUP_STEPS):          # admits every slot, then decodes
        eng.step()
    assert len(eng.scheduler.active()) == SLOTS
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, args, f"decode step ({SLOTS} slots, "
           f"{cfg.num_layers} layers, {args.backend} backend, stage blocks "
           f"{eng.stage_blocks})")


def profile_chunks(api, params, args):
    """Trace ``args.steps`` prefill chunks of a 512-token prompt written
    into pages 1..32 of a fresh pool, after one untraced pass."""
    n_chunks = CHUNKED_PROMPT // CHUNK
    pools = api.init_paged_cache(1, CHUNKED_PROMPT // PAGE + 1, PAGE,
                                 CHUNKED_PROMPT // PAGE)
    bt = torch.arange(1, CHUNKED_PROMPT // PAGE + 1, dtype=torch.int32,
                      device="cuda")[None]
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, api.cfg.vocab_size, size=(1, CHUNKED_PROMPT))).to("cuda")

    def chunk(i):
        pos = (i % n_chunks) * CHUNK
        idx = pos + np.arange(CHUNK)
        api.prefill_chunk_fn(params, {"blocks": pools["blocks"]}, {
            "tokens": toks[:, pos:pos + CHUNK], "offset": pos,
            "chunk_len": CHUNK, "bt_row": bt, "pages": 1 + idx // PAGE,
            "offs": idx % PAGE})

    for i in range(n_chunks):
        chunk(i)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            chunk(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(prof, wall, args, f"prefill chunk ({CHUNK} tokens at offsets "
           f"0..{CHUNKED_PROMPT - CHUNK}, {api.cfg.num_layers} layers)")


def report(prof, wall, args, what):
    if args.trace:
        prof.export_chrome_trace(args.trace)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if _dev_time(e) > 0]
    busy_us = sum(_dev_time(e) for e in kernels)
    step_ms = wall / args.steps * 1e3
    busy_ms = busy_us / args.steps / 1e3
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"{what}: host clock {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / step_ms:.3f}")
    print(f"-- kernels by device time per step (ms), top {TOP}")
    for e in sorted(kernels, key=_dev_time, reverse=True)[:TOP]:
        print(f"{_dev_time(e) / args.steps / 1e3:9.4f}  "
              f"x{e.count // args.steps:<4d} {e.key[:110]}")
    print(f"-- operators by host time per step (ms), top {TOP}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:TOP]:
        print(f"{e.self_cpu_time_total / args.steps / 1e3:9.4f}  "
              f"x{e.count // args.steps:<4d} {e.key[:110]}")


if __name__ == "__main__":
    main()
