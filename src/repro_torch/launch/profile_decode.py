"""Where a decode step's time goes on the card.

    python -m repro_torch.launch.profile_decode [--steps 8]
        [--trace decode_trace.json]

Builds full-width llama3.2-1b (bf16, seeded random weights), fills all 8
slots with 128-token prompts, runs a few warm-up steps, then traces
``--steps`` engine steps with ``torch.profiler`` (CPU + CUDA activities).
Prints the host-clock time per step, the device-busy time per step (sum
of kernel time) and the idle share, then the kernels by device time and
the operators by host time. Needs a CUDA card.
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


def _dev_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("llama3.2-1b")
    api = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    max_new = WARMUP_STEPS + args.steps + 8
    eng = ServingEngine(api, EngineConfig(
        num_slots=SLOTS, prompt_capacity=PROMPT_LEN,
        request_capacity=PROMPT_LEN + max_new), params, device="cuda")
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
    if args.trace:
        prof.export_chrome_trace(args.trace)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if _dev_time(e) > 0]
    busy_us = sum(_dev_time(e) for e in kernels)
    step_ms = wall / args.steps * 1e3
    busy_ms = busy_us / args.steps / 1e3
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"decode step ({SLOTS} slots, {cfg.num_layers} layers): "
          f"host clock {step_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / step_ms:.3f}")
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
