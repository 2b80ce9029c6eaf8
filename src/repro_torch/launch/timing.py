"""Device time of a short kernel call on the card, as ``chip_smoke.py``
phase 3 and the plan sweeps (``repro_torch.launch.sweep_seal``) read it."""
from __future__ import annotations

import time

import torch


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events. A spin kernel keeps the stream busy while the host
    enqueues the calls, so host launch overhead does not show up as device
    time; operands stay L2-resident between calls."""
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
