"""Where a decode step's (or a prefill chunk's) time goes on the card.

    python -m repro_torch.launch.profile_decode [--arch llama3.2-1b]
        [--steps 8] [--backend local|pipelined] [--graphs]
        [--trace decode_trace.json]
    python -m repro_torch.launch.profile_decode --prefill [--graphs]
        [--steps 8]

Builds a full-width ``--arch`` (default llama3.2-1b; bf16, seeded random
weights), fills all 8
slots with 128-token prompts, runs a few warm-up steps, then traces
``--steps`` engine steps with ``torch.profiler`` (CPU + CUDA activities)
on the chosen backend (``pipelined``: the planned two stages, two
microbatches, sealed boundaries), after timing as many steps without the
profiler. Telemetry ticks are kept out of both windows, so they hold decode
steps only.
Prints the host-clock time per step (without and under the profiler), the
device-busy time per step (the trace's device rows: kernels and copies,
each counted once) and the idle share, the kernels and the host's launch
calls per step, then the kernels by device time and the operators by host
time.
With ``--prefill`` the traced unit is one ``prefill_chunk_fn`` call
instead: a 512-token prompt in four 128-token chunks (the last three
attend over a prefix gathered from the pools), repeated until ``--steps``
chunks ran. ``--graphs`` replays CUDA graphs: the engine warms up
(``EngineConfig.warmup``, on either backend) before the prompts arrive, and the chunk runs
through a capturing ``AotRegistry`` (one graph per offset, captured in
the untraced pass); without it both run eagerly through the same code.
For an MoE arch it also splits one block's MoE FFN
(``models/moe.py::moe_mlp_apply``, no-drop dispatch) at the decode step's
8 rows and at a 128-token prefill bucket: device ms of the whole FFN, of
its expert products (``expert_ffn``) and of its shared experts, each 10
calls captured in a CUDA graph and replayed (``launch/timing.py``), on
block 0's weights; the dispatch (routing, scatter, gather, combine) is
the rest, and each is multiplied by the block count for a step.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.models.moe import expert_ffn, moe_mlp_apply
from repro_torch.device import to_device
from repro_torch.launch.timing import graph_time_ms
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.aot import AotRegistry

SLOTS, PROMPT_LEN, WARMUP_STEPS, TOP = 8, 128, 4, 20
CHUNK, CHUNKED_PROMPT, PAGE = 128, 512, 16
# host calls that put work on the device, as the CUDA runtime and driver
# name them in the trace
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _dev_time(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _on_device(evt) -> bool:
    """A row of work on the device (a kernel, a copy, a memset). An
    operator's row also carries the device time of the kernels it launched
    (eagerly; a graph replay's kernels belong to no operator), so summing
    every row with device time would count eager kernels twice."""
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--backend", default="local",
                    choices=["local", "pipelined"])
    ap.add_argument("--trace", default="")
    ap.add_argument("--prefill", action="store_true",
                    help="profile 128-token prefill chunks, not decode steps")
    ap.add_argument("--graphs", action="store_true",
                    help="replay CUDA graphs (warmup) instead of eager "
                         "launches")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    api = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    if cfg.is_moe:
        moe_split(api, params)
    if args.prefill:
        return profile_chunks(api, params, args)
    max_new = WARMUP_STEPS + 2 * args.steps + 8
    eng = ServingEngine(api, EngineConfig(
        num_slots=SLOTS, prompt_capacity=PROMPT_LEN,
        request_capacity=PROMPT_LEN + max_new, telemetry_interval=10_000,
        warmup=args.graphs), params, device="cuda", backend=args.backend)
    rng = np.random.RandomState(0)
    for _ in range(SLOTS):
        eng.submit(rng.randint(0, cfg.vocab_size, size=PROMPT_LEN).tolist(),
                   max_new)
    for _ in range(WARMUP_STEPS):          # admits every slot, then decodes
        eng.step()
    assert len(eng.scheduler.active()) == SLOTS
    bare, prof, wall = traced(lambda i: eng.step(), args)
    assert len(eng.scheduler.active()) == SLOTS
    st = eng.stats()
    assert not args.graphs or (st["post_warmup_compiles"] == 0
                               and st["graphs"] > 0), st
    report(prof, bare, wall, args, f"{cfg.name} decode step ({SLOTS} slots, "
           f"{cfg.num_layers} layers, {args.backend} backend, stage blocks "
           f"{eng.stage_blocks}, {mode(args)})")


def moe_split(api, params):
    """Device ms of block 0's MoE FFN and of its parts, in CUDA graphs, at
    a decode step's rows and at a 128-token prefill bucket, per block and
    per step (times the block count)."""
    cfg = api.cfg
    p = api.model._layer(params, 0)["moe"]
    sh = p["shared"]
    g = torch.Generator(device="cuda").manual_seed(1)
    for what, rows, seq in (("decode step", SLOTS, 1),
                            (f"prefill bucket of {CHUNK}", 1, CHUNK)):
        x = torch.randn(rows, seq, cfg.d_model, generator=g,
                        device="cuda").to(api.dtype)
        T = rows * seq * cfg.num_experts_per_tok
        C = max(8, -(-T // 8) * 8)
        buf = torch.randn(cfg.num_experts, C, cfg.d_model, generator=g,
                          device="cuda").to(api.dtype)
        full = graph_time_ms(lambda: moe_mlp_apply(
            cfg, p, x, drop_tokens=False, aux=False), launches=10)
        experts = graph_time_ms(lambda: expert_ffn(p, buf), launches=10)
        shared = graph_time_ms(lambda: L.swiglu(x, sh["wi"], sh["wg"],
                                                sh["wo"]), launches=10)
        n = cfg.num_layers
        print(f"moe ffn, {what} ({rows * seq} tokens, [E, C, D] = "
              f"[{cfg.num_experts}, {C}, {cfg.d_model}]): whole {full:.4f} "
              f"ms a block, {full * n:.3f} ms a step; expert products "
              f"{experts:.4f} / {experts * n:.3f}; shared experts "
              f"{shared:.4f} / {shared * n:.3f}; dispatch (routing, "
              f"scatter, gather, combine) {full - experts - shared:.4f} / "
              f"{(full - experts - shared) * n:.3f}")


def mode(args) -> str:
    return "CUDA graphs" if args.graphs else "eager"


def traced(run, args):
    """Host seconds of ``args.steps`` calls of ``run(i)`` without the
    profiler, then the profiler over as many more: (bare, prof, wall)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    out = []
    for window in (contextlib.nullcontext(), prof):
        torch.cuda.synchronize()
        with window:
            t0 = time.perf_counter()
            for i in range(args.steps):
                run(i)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
    return out[0], prof, out[1]


def profile_chunks(api, params, args):
    """Trace ``args.steps`` prefill chunks of a 512-token prompt written
    into pages 1..32 of a fresh pool, after one untraced pass."""
    n_chunks = CHUNKED_PROMPT // CHUNK
    pools = api.init_paged_cache(1, CHUNKED_PROMPT // PAGE + 1, PAGE,
                                 CHUNKED_PROMPT // PAGE)
    bt = torch.arange(1, CHUNKED_PROMPT // PAGE + 1, dtype=torch.int32,
                      device="cuda")[None]
    toks = np.random.RandomState(0).randint(0, api.cfg.vocab_size,
                                            size=(1, CHUNKED_PROMPT))
    dev = torch.device("cuda")
    fn = AotRegistry(capture=args.graphs).wrap(
        "prefill_chunk", lambda t, pos, n, b, pg, off: api.prefill_chunk_fn(
            params, {"blocks": pools["blocks"]}, {
                "tokens": t, "offset": pos, "chunk_len": n, "bt_row": b,
                "pages": pg, "offs": off})[0])

    def chunk(i):
        # the engine's call: host arrays copied in (pinned, asynchronous),
        # the offset selecting the graph
        pos = (i % n_chunks) * CHUNK
        idx = pos + np.arange(CHUNK)
        fn(to_device(toks[:, pos:pos + CHUNK], dev), pos,
           to_device([CHUNK], dev), bt, to_device(1 + idx // PAGE, dev),
           to_device(idx % PAGE, dev))

    for i in range(n_chunks):
        chunk(i)
    bare, prof, wall = traced(chunk, args)
    assert fn.graphs == (n_chunks if args.graphs else 0), fn.graphs
    report(prof, bare, wall, args, f"{api.cfg.name} prefill chunk ({CHUNK} "
           f"tokens at "
           f"offsets 0..{CHUNKED_PROMPT - CHUNK}, {api.cfg.num_layers} "
           f"layers, {mode(args)})")


def report(prof, bare, wall, args, what):
    if args.trace:
        prof.export_chrome_trace(args.trace)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if _on_device(e) and _dev_time(e) > 0]
    busy_us = sum(_dev_time(e) for e in kernels)
    step_ms = bare / args.steps * 1e3
    prof_ms = wall / args.steps * 1e3
    busy_ms = busy_us / args.steps / 1e3
    n_kernels = sum(e.count for e in kernels) / args.steps
    calls = {e.key: e.count / args.steps for e in avgs
             if e.key in LAUNCH_CALLS}
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"{what}: host clock {step_ms:.3f} ms ({prof_ms:.3f} under the "
          f"profiler), device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / step_ms:.3f} ({1 - busy_ms / prof_ms:.3f} under "
          f"the profiler)")
    print(f"per step: {n_kernels:g} device kernels and copies; host launch "
          f"calls {sum(calls.values()):g} "
          f"({', '.join(f'{k} {v:g}' for k, v in sorted(calls.items()))})")
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
