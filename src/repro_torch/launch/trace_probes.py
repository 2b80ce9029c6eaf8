"""What paces an eager stage probe of the pipelined backend: one stream
served with every telemetry tick's probes run eagerly (the probe's own
function, not its graph) and traced by ``torch.profiler``.

    python -m repro_torch.launch.trace_probes [serve flags]

On the card the engine replays its stage probes from graphs; run eagerly,
a probe's CUDA events time the host's launch pace, and this script shows
what that pace is made of. With no flags it serves ``chip_smoke.py``
phase 6's stream (full-width llama3.2-1b, bf16, pipelined, 8 slots, 16
requests), after a two-request warm-up stream on an engine of its own. The
profiler records CPU activity only, and is started and stopped around
each tick, so the rest of the step is not slowed; a first range inside
each trace takes the profiler's own start-up, and each stage's probe is a
``record_function`` range. Garbage made before the run is collected and
frozen out of the collector's scans (``gc.freeze``), as phase 6 does.

Prints the re-plans the traced run made, the median device ms (the probe's
CUDA events) and host ms (its range) per stage, and, for the three ticks
whose fastest stage read slowest, that stage's device ms, the host ms of
its range, the longest host operators inside it and the longest gaps
between them (host time in no operator: Python, a ctypes kernel launch,
or a pause of the thread) with the operators on either side. Asserts
nothing of the schedule. Needs a CUDA card.
"""
from __future__ import annotations

import gc
import sys

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.launch import serve

PHASE6 = ["--arch", "llama3.2-1b", "--device", "cuda", "--backend",
          "pipelined", "--slots", "8", "--requests", "16", "--prompt-len",
          "128", "--max-new", "32", "--page-size", "16", "--num-pages", "30",
          "--shared-system-prompt", "0.75"]


def _stage_range(events, s):
    hits = [e for e in events if e.name == f"probe_stage{s}"]
    return hits[0] if hits else None


def _anatomy(ev):
    """(host ms of the range, its three longest gaps, ms in no operator,
    its four longest operators) of one probe range."""
    kids = sorted(ev.cpu_children, key=lambda e: e.time_range.start)
    names = ["(start)"] + [k.name for k in kids] + ["(end)"]
    edges = [ev.time_range.start] + [
        x for k in kids for x in (k.time_range.start, k.time_range.end)
    ] + [ev.time_range.end]
    # gap i lies between names[i] and names[i + 1]
    gaps = [(edges[2 * i + 1] - edges[2 * i]) / 1e3
            for i in range(len(kids) + 1)]
    top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:3]
    where = "; ".join(f"{gaps[i]:.3f} ms after op {i} of {len(kids)} "
                      f"({names[i]} -> {names[i + 1]})" for i in top)
    slow = sorted(kids, key=lambda e: -e.time_range.elapsed_us())[:4]
    return (ev.time_range.elapsed_us() / 1e3, where, sum(gaps),
            ", ".join(f"{k.name} {k.time_range.elapsed_us() / 1e3:.3f}"
                      for k in slow))


def trace(argv):
    args = serve.build_parser().parse_args(argv)
    api, params = serve.build_params(args)
    warm = serve.build_parser().parse_args(argv + ["--requests", "2"])
    serve.serve_stream(serve.make_engine(api, params, warm), warm,
                       serve.gen_prompts(warm, api.cfg.vocab_size))
    eng = serve.make_engine(api, params, args)
    be = eng.backend
    ticks = []                  # (engine step, device ms per stage, trace)
    orig_times = be.stage_times

    def stage_times():
        managed = be._probe     # the layout's probe under graph management

        def probe(s, sl):
            with record_function(f"probe_stage{s}"):
                return managed.fn(s, sl)

        be._probe = probe
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("profiler_start_up"):
                torch.empty(0)
            times = orig_times()
        be._probe = managed
        ticks.append((eng.steps, [t * 1e3 for t in times], prof.events()))
        return times

    be.stage_times = stage_times
    gc.collect()
    gc.freeze()
    try:
        serve.serve_stream(eng, args, serve.gen_prompts(args,
                                                        api.cfg.vocab_size))
    finally:
        gc.unfreeze()
    torch.cuda.synchronize()
    st = eng.stats()

    S = len(ticks[0][1])
    med = [sorted(t[1][s] for t in ticks)[len(ticks) // 2] for s in range(S)]
    host_med = []
    for s in range(S):
        hs = sorted(_stage_range(t[2], s).time_range.elapsed_us() / 1e3
                    for t in ticks if _stage_range(t[2], s) is not None)
        host_med.append(hs[len(hs) // 2] if hs else float("nan"))
    print(f"trace probes: {len(ticks)} ticks, replans {st['replans']} under "
          f"the profiler; median device ms per stage "
          f"{[round(m, 3) for m in med]}, median host ms per stage range "
          f"{[round(m, 3) for m in host_med]}", flush=True)
    small = min(range(S), key=lambda s: med[s])
    for step, dev, events in sorted(ticks, key=lambda t: -t[1][small])[:3]:
        ev = _stage_range(events, small)
        if ev is None:
            continue
        host, where, idle, slow = _anatomy(ev)
        print(f"trace probe at step {step}: stage {small} device "
              f"{dev[small]:.3f} ms, host {host:.3f} ms ({idle:.3f} ms in no "
              f"op); longest gaps: {where}; longest ops: {slow}", flush=True)


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("trace_probes: needs a CUDA device")
    argv = sys.argv[1:] if argv is None else argv
    trace(argv or PHASE6)


if __name__ == "__main__":
    main()
