"""Serving launcher of the port: continuous batching on the paged KV path,
planned over trust domains, pipelined with sealed stage boundaries.

  python -m repro_torch.launch.serve --arch llama3.2-1b --device cuda \\
      --stages 2 --microbatches 2 --slots 8 --requests 16 \\
      --prompt-len 128 --max-new 32 --num-pages 30 \\
      --shared-system-prompt 0.75

Builds the model with random weights from a seeded ``torch.Generator``,
serves a synthetic request stream (the reference launcher's: uniform
prompt lengths 2..N, a fraction extending one fixed system prompt, one
arrival every two engine steps) and prints the engine's counters. The
flags mean what they mean in ``repro.launch.serve``: ``--backend auto``
pipelines when ``--stages`` > 1, ``--inject-straggler S:F`` with
``--verify-swap --no-seal`` forces a live boundary swap and checks that
the token streams equal an undisturbed run's, ``--prefill-chunk N`` streams
prompts longer than N in N-token chunks, ``--prefill-pack K`` admits up to
K short prompts in one prefill call, and ``--verify-chunked`` serves the
stream again with one-shot prefill and checks the streams are equal
(prints ``CHUNK-EXACT OK``). ``--warmup`` captures every serving shape as
a CUDA graph before serving, on either backend (pipelined: the step and
stage probes of the planned layout and of every toured one, and the swap
I/O; on the CPU the same passes run eagerly), and
``--assert-no-recompile`` then fails unless steady-state serving captured
nothing new (prints ``NO-RECOMPILE OK``). Runs on ``cuda`` unless
``--device cpu`` is given; without a card it raises.

  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --prompt-len 24 --prefill-chunk 5 --prefill-pack 3 \\
      --f32 --verify-chunked
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --backend local --warmup --assert-no-recompile
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --stages 2 --microbatches 2 --slots 4 --requests 6 \\
      --max-new 8 --no-seal --f32 --inject-straggler 1:10 --verify-swap \\
      --warmup --assert-no-recompile
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.core.privacy import LM_SIM_DELTA
from repro_torch.device import resolve_device
from repro_torch.enclave.domain import sandwich_manager, two_enclave_manager
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine

ARRIVAL_EVERY = 2       # one request every 2 engine steps (the reference
#                         launcher's default --arrival-every)
TOPOLOGIES = {
    "two-enclave": lambda stages: two_enclave_manager(),
    # 1 trusted pod + (stages - 1) full-rate untrusted pods: the optimal
    # placement pipelines several untrusted segments (non-prefix)
    "sandwich": lambda stages: sandwich_manager(max(1, stages - 1)),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots == decode batch")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="max synthetic prompt length (uniform 2..N)")
    ap.add_argument("--max-new", type=int, default=8,
                    help="tokens to generate per request")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="shared page-pool size (0 = all slots at full "
                         "request capacity; smaller pools preempt)")
    ap.add_argument("--shared-system-prompt", type=float, default=0.0,
                    metavar="RATIO",
                    help="fraction of synthetic prompts extending one "
                         "fixed system prompt (drives COW page sharing)")
    ap.add_argument("--no-seal", action="store_true",
                    help="pass stage-boundary activations unsealed")
    ap.add_argument("--topology", default="two-enclave",
                    choices=sorted(TOPOLOGIES),
                    help="trust-domain registry the planner places over")
    ap.add_argument("--solver", default="dp",
                    choices=["dp", "exhaustive", "beam"])
    ap.add_argument("--space", default="segment",
                    choices=["segment", "prefix"],
                    help="placement search space (segment = PlacementSpec)")
    ap.add_argument("--delta", type=float, default=LM_SIM_DELTA,
                    help="privacy threshold for untrusted segments")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "local", "pipelined"],
                    help="auto: pipelined when --stages > 1")
    ap.add_argument("--telemetry-interval", type=int, default=4)
    ap.add_argument("--inject-straggler", default=None, metavar="STAGE:FACTOR",
                    help="multiply stage STAGE's measured time by FACTOR")
    ap.add_argument("--verify-swap", action="store_true",
                    help="run twice (with/without straggler) and assert "
                         "identical token streams across the live swap")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="stream prompts longer than N in N-token chunks, "
                         "one chunk per engine step between decode ticks "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--prefill-pack", type=int, default=0,
                    help="pack up to K queued short prompts into one "
                         "bucketed prefill call (0 = off)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture every serving shape (decode step, all "
                         "prefill buckets one-shot and packed, every chunk "
                         "offset, swap I/O; pipelined: the step and stage "
                         "probes of every toured layout) as a CUDA graph "
                         "before serving")
    ap.add_argument("--assert-no-recompile", action="store_true",
                    help="with --warmup: fail unless steady-state serving "
                         "captured no new graph")
    ap.add_argument("--verify-chunked", action="store_true",
                    help="with --prefill-chunk: serve the stream again "
                         "unchunked and assert identical token streams")
    ap.add_argument("--f32", action="store_true",
                    help="float32 weights and KV (default bfloat16)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def make_config(args) -> EngineConfig:
    return EngineConfig(
        num_slots=args.slots, num_stages=args.stages,
        num_microbatches=args.microbatches, prompt_capacity=args.prompt_len,
        page_size=args.page_size, num_pages=args.num_pages,
        request_capacity=args.prompt_len + args.max_new,
        seal_boundary=not args.no_seal, solver=args.solver, space=args.space,
        delta=args.delta, telemetry_interval=args.telemetry_interval,
        prefill_chunk=args.prefill_chunk, prefill_pack=args.prefill_pack,
        warmup=args.warmup)


def backend_of(args) -> str:
    if args.backend != "auto":
        return args.backend
    return "pipelined" if args.stages > 1 else "local"


def make_engine(api, params, args) -> ServingEngine:
    """The engine the parsed arguments describe (config, topology and
    backend), on the model's device."""
    return ServingEngine(api, make_config(args), params, device=api.device,
                         rm=TOPOLOGIES[args.topology](args.stages),
                         backend=backend_of(args))


def gen_prompts(args, vocab_size: int):
    """The reference launcher's synthetic prompts (same seed, same draws)."""
    rng = np.random.RandomState(args.seed)
    sys_prompt = rng.randint(0, vocab_size,
                             size=max(2, args.prompt_len // 2)).tolist()
    prompts = []
    for _ in range(args.requests):
        if rng.rand() < args.shared_system_prompt:
            tail = rng.randint(
                0, vocab_size,
                size=int(rng.randint(0, args.prompt_len
                                     - len(sys_prompt) + 1))).tolist()
            prompts.append(sys_prompt + tail)
        else:
            prompts.append(rng.randint(
                0, vocab_size,
                size=int(rng.randint(2, args.prompt_len + 1))).tolist())
    return prompts


def serve_stream(eng: ServingEngine, args, prompts):
    """Submit the prompt stream with its arrival gaps and drain it."""
    reqs, k = [], 0
    while k < len(prompts) or eng.scheduler.has_work():
        if k < len(prompts) and eng.steps % ARRIVAL_EVERY == 0:
            reqs.append(eng.submit(prompts[k], args.max_new))
            k += 1
        moved = eng.step()
        if eng.stalled:
            break
        if k < len(prompts) and not moved and not eng.scheduler.has_work():
            reqs.append(eng.submit(prompts[k], args.max_new))
            k += 1
    return reqs


def build_params(args):
    """(api, params) for the parsed arguments: the model on its device with
    random weights drawn from ``--seed``."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    api = build_model(cfg, device=device, dtype=dtype)
    params = api.init(torch.Generator(device=device).manual_seed(args.seed))
    return api, params


def parse_straggler(spec):
    if not spec:
        return None
    s, f = spec.split(":")
    return int(s), float(f)


def run_once(api, params, args, inject=None):
    """One engine over the prompt stream: ``(engine, requests)``."""
    eng = make_engine(api, params, args)
    if inject:
        eng.telemetry.inject(*inject)
    reqs = serve_stream(eng, args, gen_prompts(args, api.cfg.vocab_size))
    return eng, reqs


def report(eng, api, reqs) -> None:
    st = eng.stats()
    print(f"device={st['device']} arch={api.cfg.name} dtype={api.dtype} "
          f"backend={st['backend']} stage_blocks={st['stage_blocks']} "
          f"placement={st['placement']}")
    for e in eng.events:
        if e.kind in ("replan", "swap", "swap_skipped"):
            print(f"  step {e.step}: {e.kind} {e.detail}")
    print(f"served {st['completed']} requests, {st['tokens_out']} tokens in "
          f"{st['decode_wall_s']:.3f}s decode ({st['tok_per_s']:.1f} tok/s), "
          f"steps={st['steps']} replans={st['replans']} swaps={st['swaps']} "
          f"prefill_calls={st['prefill_calls']} "
          f"admission_p50={st.get('admission_p50_ms', 0):.1f}ms")
    print(f"paging: policy={st['page_policy']}/{st['preempt_policy']} "
          f"preemptions={st['preemptions']} swap_outs={st['swap_outs']} "
          f"swap_ins={st['swap_ins']} cow_hits={st['cow_hits']} "
          f"forks={st['forks']} peak_pages={st['peak_pages_in_use']}/"
          f"{st['num_pages'] - 1}")
    if st["prefill_chunk"]:
        print(f"chunked prefill: {st['chunked_admissions']} admissions in "
              f"{st['prefill_chunks']} chunks of {st['prefill_chunk']} "
              f"tokens")
    if st["prefill_pack"] > 1:
        print(f"packed prefill: {st['packed_admissions']} admissions in "
              f"{st['packed_prefills']} calls of up to {st['prefill_pack']} "
              f"prompts")
    if reqs:
        print("sample tokens:", reqs[0].generated)


def main(argv=None):
    args = build_parser().parse_args(argv)
    inject = parse_straggler(args.inject_straggler)
    if args.verify_swap:
        assert args.no_seal, "--verify-swap needs --no-seal: the quantizing " \
            "seal makes streams depend on the stage boundaries"
        assert inject, "--verify-swap needs --inject-straggler"
    api, params = build_params(args)
    eng, reqs = run_once(api, params, args, inject)
    report(eng, api, reqs)
    st = eng.stats()
    if args.assert_no_recompile:
        # checked before any --verify-* rerun, as the reference does
        assert args.warmup, "--assert-no-recompile needs --warmup"
        n = st["post_warmup_compiles"]
        assert n == 0, f"{n} graph captures after warmup; stalls: " \
            f"{st['compile_stalls']}"
        assert not st["compile_stalls"], st["compile_stalls"]
        print(f"NO-RECOMPILE OK: post_warmup_compiles={n}, 0 stalls "
              f"({st['graphs']} graphs, warmup {st['warmup_s']:.2f} s)")
    if args.verify_swap:
        eng2, reqs2 = run_once(api, params, copy.copy(args))
        assert eng.swaps >= 1, \
            f"straggler injection produced no live swap (events: " \
            f"{[e.kind for e in eng.events]})"
        for a, b in zip(reqs, reqs2):
            assert a.generated == b.generated, \
                f"req {a.rid} diverged across live swap:\n  {a.generated}" \
                f"\n  {b.generated}"
        print(f"SWAP-EXACT OK: {len(reqs)} token streams identical across "
              f"live re-plan ({st['stage_blocks']} vs "
              f"{eng2.stats()['stage_blocks']})")
    if args.verify_chunked:
        assert args.prefill_chunk > 0, \
            "--verify-chunked needs --prefill-chunk N"
        assert st["chunked_admissions"] > 0, \
            "no prompt exceeded --prefill-chunk: nothing verified " \
            "(raise --prompt-len or lower --prefill-chunk)"
        unchunked = copy.copy(args)
        unchunked.prefill_chunk = 0
        _, reqs3 = run_once(api, params, unchunked, inject)
        for a, b in zip(reqs, reqs3):
            assert a.generated == b.generated, \
                f"req {a.rid} diverged under chunked prefill:\n" \
                f"  {a.generated}\n  {b.generated}"
        print(f"CHUNK-EXACT OK: {len(reqs)} token streams identical, "
              f"chunked ({args.prefill_chunk}) vs one-shot prefill")
    return st


if __name__ == "__main__":
    main()
