"""Device time of a short kernel call on the card, launched eagerly or
replayed inside a CUDA graph, as ``chip_smoke.py`` phase 3 and the plan
sweeps (``repro_torch.launch.sweep_seal``) read it."""
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


def graph_time_ms(fn, launches: int = 50, replays: int = 10) -> float:
    """Mean device time of one call of ``fn`` inside a CUDA graph:
    ``launches`` back-to-back calls captured once (after three eager calls
    on the capture stream), the graph replayed ``replays`` times behind a
    spin kernel, by CUDA events, over every call replayed. What a kernel
    costs in a captured serving step, where the host's launch overhead is
    gone but each kernel still starts and drains on the device."""
    from repro_torch.kernels import ops
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    counts = dict(ops.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(launches):
                fn()
    finally:
        ops.LAUNCHES.update(counts)         # a capture launches nothing
    graph.replay()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e7))             # ~10 ms of spin to enqueue behind
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)
