"""Serving launcher of the port: continuous batching on the paged KV path
(or the legacy timeline), planned over trust domains, pipelined with
sealed stage boundaries.

  python -m repro_torch.launch.serve --arch llama3.2-1b --device cuda \\
      --stages 2 --microbatches 2 --slots 8 --requests 16 \\
      --prompt-len 128 --max-new 32 --num-pages 30 \\
      --shared-system-prompt 0.75

Builds the model with random weights from a seeded ``torch.Generator``,
serves a synthetic request stream (the reference launcher's: uniform
prompt lengths 2..N, a fraction extending one fixed system prompt, one
arrival every ``--arrival-every`` engine steps) and prints the engine's
counters. The
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
nothing new (prints ``NO-RECOMPILE OK``). ``--page-policy``,
``--preempt-policy``, ``--no-prefix-sharing`` and ``--no-decode-cow`` set
the paging policies; ``--verify-preempt`` (with ``--preempt-policy swap``
and a pool that swaps) serves the stream again under the recompute oracle
and on a roomy pool and checks the three streams are equal (prints
``PREEMPT-EXACT OK``). ``--disagg`` serves through a prefill-role and a
decode-role engine over shared params, every prompt's KV handed over
sealed with the page cipher (``serving/disagg.py``); with
``--verify-disagg`` the stream is served again monolithically and through
an orchestrator with no prefill peer, and the three must be equal (prints
``DISAGG-EXACT OK``); ``--assert-no-recompile`` then checks both roles.
``--chaos`` arms the seeded fault plane (``FaultConfig.chaos(--seed)``:
tampered swap and transfer payloads, stage stalls, handoff drops and
delays, pool storms; ``--chaos-death P`` adds a device death per telemetry
tick with probability P, at most one), monolithic or ``--disagg``;
``--verify-recovery`` serves the stream again fault-free and checks that
the streams are equal, that no request failed and that every injected
fault is accounted to a recovery rung or a pending marker, on both roles
under ``--disagg`` (prints ``RECOVERY-EXACT OK``). ``--temperature T``
and ``--top-k K`` switch greedy decoding to seeded sampling (each token
keyed by request id and position, as the reference's sampler does;
sampled streams equal the reference's token for token), and
``--require-non-prefix`` fails unless the planned placement is outside
the legacy trusted-prefix space (prints ``NON-PREFIX OK``).
``--ranks gloo`` (or ``nccl``, one card a rank) runs the pipelined serve
with one process a pod of ``--mesh`` (pods = ``--stages``, data 1), stage
s on rank s (``ServingEngine(mesh=)``, ``serving/ranked.py``); rank 0
prints, every ``--verify-*`` check included. Without it the stages run in
sequence on one device.
``--kv-layout timeline`` serves on the reference's shared-position
timeline (horizon ``--max-seq``, 0 = sized to the stream as the
reference sizes it; per-token prefill, admission back-pressure at the
horizon), and ``--per-token-prefill`` prefills the paged layout one token
a step instead of in one call. ``--arch``
takes every registered config: the dense llama3.2-1b, llama3.2-3b,
glm4-9b and command-r-35b, the MoE qwen2-moe-a2.7b (60 routed experts
top-4 plus 4 shared, attention biases; dispatched without capacity
dropping, as the reference serves it), hymba-1.5b (served on the
timeline: rolling window, conv and SSM state) and xlstm-125m (served on
the timeline: each slot's sLSTM/mLSTM state). The engine refuses
moonshot-v1-16b-a3b (two segments), whisper-small (no segments: an
encoder-decoder) and qwen2-vl-7b (no ``pos3`` in serving) by name, as
the reference's engine cannot serve them either.
Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises.

  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --prompt-len 24 --prefill-chunk 5 --prefill-pack 3 \\
      --f32 --verify-chunked
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --backend local --warmup --assert-no-recompile
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --stages 2 --microbatches 2 --slots 4 --requests 6 \\
      --max-new 8 --no-seal --f32 --inject-straggler 1:10 --verify-swap \\
      --warmup --assert-no-recompile
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --backend local --slots 4 --microbatches 1 \\
      --requests 6 --prompt-len 8 --max-new 8 --page-size 4 --no-seal \\
      --f32 --warmup --disagg --verify-disagg --assert-no-recompile
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --backend local --slots 4 --microbatches 1 \\
      --requests 10 --prompt-len 8 --max-new 12 --page-size 4 \\
      --num-pages 12 --no-seal --f32 --warmup --seed 3 --chaos \\
      --chaos-death 0.4 --verify-recovery --assert-no-recompile
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --backend local --slots 4 --microbatches 1 \\
      --requests 8 --prompt-len 8 --max-new 10 --page-size 4 --no-seal \\
      --f32 --seed 7 --disagg --chaos --verify-recovery
  python -m repro_torch.launch.serve --arch llama3.2-3b --reduced \\
      --device cpu --backend local --temperature 0.8 --top-k 50 --f32
  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --reduced \\
      --device cpu --backend local --f32
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --mesh 3x1 --stages 3 --microbatches 2 --slots 4 \\
      --requests 6 --max-new 8 --no-seal --f32 --topology sandwich \\
      --delta 2.0 --require-non-prefix --inject-straggler 2:10 --verify-swap
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --kv-layout timeline --stages 2 --microbatches 2 \\
      --slots 4 --requests 6 --max-new 8 --no-seal --f32 \\
      --inject-straggler 1:10 --verify-swap --warmup --assert-no-recompile
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --backend local --per-token-prefill --f32
  python -m repro_torch.launch.serve --arch llama3.2-1b --reduced \\
      --device cpu --stages 2 --mesh 2x1 --ranks gloo --microbatches 2 \\
      --slots 4 --requests 6 --max-new 8 --no-seal --f32 \\
      --inject-straggler 1:10 --verify-swap
"""
from __future__ import annotations

import argparse
import copy
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.core.privacy import LM_SIM_DELTA
from repro_torch.device import resolve_device
from repro_torch.enclave.domain import sandwich_manager, two_enclave_manager
from repro_torch.models.api import build_model
from repro_torch.serving import (DisaggOrchestrator, EngineConfig,
                                 FaultConfig, ServingEngine, build_disagg,
                                 plan_disagg_roles)

TOPOLOGIES = {
    "two-enclave": lambda stages: two_enclave_manager(),
    # 1 trusted pod + (stages - 1) full-rate untrusted pods: the optimal
    # placement pipelines several untrusted segments (non-prefix)
    "sandwich": lambda stages: sandwich_manager(max(1, stages - 1)),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
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
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="submit one request every K engine steps")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="legacy timeline horizon (0 = auto-size)")
    ap.add_argument("--kv-layout", default="paged",
                    choices=["paged", "timeline"],
                    help="paged per-slot KV cache (unbounded lifetime) or "
                         "the legacy shared-position timeline")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="shared page-pool size (0 = all slots at full "
                         "request capacity; smaller pools preempt)")
    ap.add_argument("--page-policy", default="demand",
                    choices=["demand", "reserve"],
                    help="demand: pages as generation reaches them, COW "
                         "prefix sharing, preemption when the pool runs "
                         "dry; reserve: worst case at admission")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the COW prefix index (demand policy)")
    ap.add_argument("--preempt-policy", default="auto",
                    choices=["auto", "swap", "recompute"],
                    help="swap (auto): seal a victim's pages to host "
                         "memory and restore them on resume; recompute: "
                         "drop them and re-prefill on resume")
    ap.add_argument("--no-decode-cow", action="store_true",
                    help="don't register decode-completed pages in the "
                         "COW prefix index")
    ap.add_argument("--verify-preempt", action="store_true",
                    help="with --preempt-policy swap: serve the stream "
                         "again under the recompute oracle and on a roomy "
                         "pool and assert all three token streams are "
                         "identical (use with --f32)")
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
    ap.add_argument("--require-non-prefix", action="store_true",
                    help="assert the planned PlacementSpec is NOT "
                         "expressible in the legacy trusted-prefix space")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the top-k logits (0 = off)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "local", "pipelined"],
                    help="auto: pipelined when --stages > 1")
    ap.add_argument("--mesh", default="2x1",
                    help="pod x data, as the reference's: one card runs "
                         "the pods' stages in sequence and computes the "
                         "data axis whole; with --ranks one process a pod "
                         "(see check_mesh)")
    ap.add_argument("--ranks", default=None, choices=["gloo", "nccl"],
                    help="serve with one rank a pipeline stage over this "
                         "process-group backend (pipelined backend, data "
                         "axis 1)")
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
    ap.add_argument("--per-token-prefill", action="store_true",
                    help="disable one-call batched prefill (admission-"
                         "latency baseline)")
    ap.add_argument("--prefill-pack", type=int, default=0,
                    help="pack up to K queued short prompts into one "
                         "bucketed prefill call (paged + batched prefill "
                         "only; 0 = off)")
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
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: a prefill-role engine "
                         "seals each prompt's KV pages and hands them to "
                         "a decode-role engine over shared params")
    ap.add_argument("--verify-disagg", action="store_true",
                    help="with --disagg: serve the same stream "
                         "disaggregated, monolithic and through an "
                         "orchestrator with no prefill peer, and assert "
                         "all three token streams are identical")
    ap.add_argument("--chaos", action="store_true",
                    help="arm the seeded chaos fault plane "
                         "(FaultConfig.chaos(seed=--seed)): sealed-payload "
                         "corruption and truncation, stage stalls, handoff "
                         "drops and delays (--disagg), pool storms")
    ap.add_argument("--chaos-death", type=float, default=0.0, metavar="P",
                    help="with --chaos: per-telemetry-tick probability of "
                         "killing a staged trust domain (at most one; "
                         "recovery = spill + re-plan + swap-in)")
    ap.add_argument("--verify-recovery", action="store_true",
                    help="with --chaos: serve the same stream fault-free "
                         "and assert identical token streams, no failed "
                         "request and every injected fault accounted to a "
                         "recovery counter (use with --f32)")
    ap.add_argument("--f32", action="store_true",
                    help="float32 weights and KV (default bfloat16)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def make_config(args, **overrides) -> EngineConfig:
    """The engine config the parsed arguments describe; ``overrides`` set
    fields that have no flag (``sample_seed``, as the reference's serve has
    none) or replace what a flag set. ``--max-seq 0`` sizes the horizon
    as the reference's launcher does: the longest prompt, the arrivals'
    spread, the decode steps the stream takes on its slots, one request's
    new tokens, and 16."""
    max_seq = args.max_seq or (
        args.prompt_len + args.requests * args.arrival_every
        + args.max_new * args.requests // args.slots + args.max_new + 16)
    return dataclasses.replace(EngineConfig(
        num_slots=args.slots, num_stages=args.stages,
        num_microbatches=args.microbatches, max_seq=max_seq,
        prompt_capacity=args.prompt_len, kv_layout=args.kv_layout,
        page_size=args.page_size, num_pages=args.num_pages,
        page_policy=args.page_policy,
        prefix_sharing=not args.no_prefix_sharing,
        preempt_policy=args.preempt_policy,
        decode_cow=not args.no_decode_cow,
        request_capacity=args.prompt_len + args.max_new,
        batched_prefill=not args.per_token_prefill,
        seal_boundary=not args.no_seal, solver=args.solver, space=args.space,
        delta=args.delta, telemetry_interval=args.telemetry_interval,
        temperature=args.temperature, top_k=args.top_k,
        prefill_chunk=args.prefill_chunk, prefill_pack=args.prefill_pack,
        warmup=args.warmup,
        faults=(FaultConfig.chaos(seed=args.seed,
                                  device_death=args.chaos_death)
                if args.chaos else None)), **overrides)


def assert_recovery_accounted(st) -> None:
    """Every injected fault maps to a named recovery rung or a pending
    marker (the reference's accounting property)."""
    inj, rec, pend = st["faults"], st["recovery"], st["faults_pending"]
    assert inj["corrupt_swap"] + inj["truncate_swap"] \
        == rec["unseal_fallback_swap"], (inj, rec)
    assert inj["corrupt_transfer"] + inj["truncate_transfer"] \
        == rec["unseal_fallback_transfer"], (inj, rec)
    assert inj["device_death"] \
        == rec["device_loss_replans"] + (1 if pend["death"] else 0), (inj, rec)
    assert inj["stage_stall"] \
        == rec["stall_replans"] + (1 if pend["stall"] else 0), (inj, rec)
    assert inj["pool_storm"] \
        == rec["storm_reclaims"] + (1 if pend["storm"] else 0), (inj, rec)


def _rungs(st) -> dict:
    return {k: v for k, v in st["recovery"].items() if v}


def check_mesh(args):
    """``--mesh`` as (pods, data). The reference's pipelined serve runs
    stage s on pod s of a ``pod x data`` mesh (its engine asserts a mesh
    for the pipelined backend, src/repro/serving/engine.py:1013-1025, and
    its decoder one stage per pod, src/repro/runtime/pipeline.py:95-106),
    so there the pods must equal ``--stages``. One card runs those stages
    in sequence, as every pipelined serve of the port does; the data axis
    is a layout of the batch that one card computes whole, so the streams
    do not depend on it. Refused by name: a mesh that is not ``P`` or
    ``PxD`` with positive sizes, and pods other than ``--stages`` on the
    pipelined backend. The local backend ignores the mesh, as the
    reference's does. With ``--ranks``, pod s is a process (data 1: a
    data axis over ranks is ROADMAP item 10d)."""
    try:
        dims = tuple(int(x) for x in args.mesh.split("x"))
    except ValueError:
        dims = ()
    if not 1 <= len(dims) <= 2 or min(dims) < 1:
        raise ValueError(f"--mesh {args.mesh}: the serving mesh is pod x "
                         f"data (e.g. 2x1), positive sizes")
    pods, data = dims[0], (dims[1] if len(dims) > 1 else 1)
    if backend_of(args) == "pipelined" and pods != args.stages:
        raise ValueError(f"--mesh {args.mesh}: {pods} pods but --stages "
                         f"{args.stages}; the pipelined serve runs stage s "
                         f"on pod s")
    if args.ranks:
        if backend_of(args) != "pipelined":
            raise ValueError("--ranks runs one rank a stage of the "
                             "pipelined backend")
        if data > 1:
            raise NotImplementedError(
                f"--mesh {args.mesh} --ranks: a data axis of {data} over "
                f"ranks (ROADMAP item 10d)")
    return pods, data


def backend_of(args) -> str:
    if args.backend != "auto":
        return args.backend
    return "pipelined" if args.stages > 1 else "local"


def make_engine(api, params, args, **overrides) -> ServingEngine:
    """The engine the parsed arguments describe (config, topology and
    backend), on the model's device; ``overrides`` as ``make_config``."""
    return ServingEngine(api, make_config(args, **overrides), params,
                         device=api.device,
                         rm=TOPOLOGIES[args.topology](args.stages),
                         backend=backend_of(args),
                         mesh=getattr(args, "rank_mesh", None))


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
        if k < len(prompts) and eng.steps % args.arrival_every == 0:
            reqs.append(eng.submit(prompts[k], args.max_new))
            k += 1
        moved = eng.step()
        if eng.stalled:
            break
        if k < len(prompts) and not moved and not eng.scheduler.has_work():
            reqs.append(eng.submit(prompts[k], args.max_new))
            k += 1
    return reqs


def serve_stream_orch(orch: DisaggOrchestrator, args, prompts):
    """The orchestrator twin of ``serve_stream``: the same prompts in the
    same order on the decode engine's clock, so the rids match a
    monolithic run's."""
    reqs, k = [], 0
    while k < len(prompts) or orch.has_work():
        if k < len(prompts) and orch.decode.steps % args.arrival_every == 0:
            reqs.append(orch.submit(prompts[k], args.max_new))
            k += 1
        orch.step()
        if orch.stalled:
            break
        if k < len(prompts) and not orch.has_work():
            reqs.append(orch.submit(prompts[k], args.max_new))
            k += 1
    return reqs


def make_disagg(api, params, args, **overrides) -> DisaggOrchestrator:
    """The prefill/decode pair the parsed arguments describe, over the
    shared ``params``, on the model's device; ``overrides`` as
    ``make_config``."""
    return build_disagg(api, params, config=make_config(args, **overrides),
                        backend=backend_of(args), device=api.device,
                        rm=TOPOLOGIES[args.topology](args.stages))


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
    if args.require_non_prefix:
        assert not eng.spec.is_prefix(eng.rm.resource_graph()), \
            f"planned placement is prefix-expressible: {eng.spec.describe()}"
        print("NON-PREFIX OK: placement not expressible in the "
              "trusted-prefix space")
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
    if st["kv_layout"] == "paged":
        print(f"paging: policy={st['page_policy']}/{st['preempt_policy']} "
              f"preemptions={st['preemptions']} swap_outs={st['swap_outs']} "
              f"swap_ins={st['swap_ins']} cow_hits={st['cow_hits']} "
              f"forks={st['forks']} peak_pages={st['peak_pages_in_use']}/"
              f"{st['num_pages'] - 1}")
    else:
        print(f"timeline: max_seq={st['max_seq']} "
              f"global_len={st['global_len']} "
              f"preempt_policy={st['preempt_policy']} "
              f"stalled={st['stalled']}")
    if st["prefill_chunk"]:
        print(f"chunked prefill: {st['chunked_admissions']} admissions in "
              f"{st['prefill_chunks']} chunks of {st['prefill_chunk']} "
              f"tokens")
    if st["prefill_pack"] > 1:
        print(f"packed prefill: {st['packed_admissions']} admissions in "
              f"{st['packed_prefills']} calls of up to {st['prefill_pack']} "
              f"prompts")
    if eng.faults is not None:
        print(f"chaos: injected={st['faults']} recovery={_rungs(st)} "
              f"pending={st['faults_pending']} "
              f"failed={st['failed_requests']}")
    if reqs:
        print("sample tokens:", reqs[0].generated)


def _assert_no_recompile(st, role: str = "") -> None:
    n = st["post_warmup_compiles"]
    assert n == 0, f"{role}{n} graph captures after warmup; stalls: " \
        f"{st['compile_stalls']}"
    assert not st["compile_stalls"], st["compile_stalls"]


def disagg_main(api, params, args):
    """``--disagg``: serve through the prefill/decode orchestrator; with
    ``--verify-disagg`` serve again monolithically and through the no-peer
    fallback orchestrator and assert the three streams are equal."""
    plan = plan_disagg_roles(TOPOLOGIES[args.topology](args.stages),
                             api.cfg, prompt_len=max(args.prompt_len, 16),
                             max_new=args.max_new, page_size=args.page_size)
    print(f"role plan: {plan.describe()}")
    orch = make_disagg(api, params, args)
    prompts = gen_prompts(args, api.cfg.vocab_size)
    reqs = serve_stream_orch(orch, args, prompts)
    orch.check_invariants()
    st = orch.stats()
    ps = st["prefill_stats"]
    print(f"disagg: device={st['device']} arch={api.cfg.name} "
          f"dtype={api.dtype} backend={st['backend']}; served "
          f"{st['completed'] + st['prefill_completed']} requests, "
          f"{st['tokens_out']} tokens ({st['tok_per_s']:.1f} tok/s) "
          f"handoffs={st['handoffs']} "
          f"backpressure={st['backpressure_events']} "
          f"finished_at_prefill={st['prefill_completed']} "
          f"cow_hits={st['cow_hits']} transfers_in={st['transfers_in']}")
    print(f"prefill side: admissions={ps['admissions']} "
          f"prefill_calls={ps['prefill_calls']} "
          f"transfers_out={ps['transfers_out']} "
          f"packed={ps['packed_admissions']}")
    if reqs:
        print("sample tokens:", reqs[0].generated)
    if args.assert_no_recompile:
        assert args.warmup, "--assert-no-recompile needs --warmup"
        _assert_no_recompile(orch.decode.stats(), "decode role: ")
        _assert_no_recompile(orch.eng_prefill.stats(), "prefill role: ")
        print("NO-RECOMPILE OK: zero post-warmup captures and no stall on "
              "both roles")
    if args.verify_disagg:
        mono = serve_stream(make_engine(api, params, args), args, prompts)
        fb = DisaggOrchestrator(make_engine(api, params, args))
        fb_reqs = serve_stream_orch(fb, args, prompts)
        assert fb.stats()["handoffs"] == 0
        assert len(reqs) == len(mono) == len(fb_reqs) == len(prompts)
        for a, b, c in zip(reqs, mono, fb_reqs):
            assert a.generated == b.generated == c.generated, \
                f"req {a.rid} diverged across serving modes:\n" \
                f"  disagg     {a.generated}\n  monolithic {b.generated}\n" \
                f"  fallback   {c.generated}"
        print(f"DISAGG-EXACT OK: {len(reqs)} token streams identical "
              f"across disaggregated / monolithic / fallback "
              f"({st['handoffs']} sealed handoffs)")
    if args.chaos:
        ds = orch.decode.stats()
        print(f"chaos: injected={ds['faults']} recovery={_rungs(ds)} "
              f"prefill role injected={orch.eng_prefill.faults.snapshot()} "
              f"in_flight={st['in_flight_handoffs']}")
    if args.verify_recovery:
        assert args.chaos, "--verify-recovery needs --chaos"
        ds, ps = orch.decode.stats(), orch.eng_prefill.stats()
        total = orch.decode.faults.total_injected() + \
            orch.eng_prefill.faults.total_injected()
        assert total > 0, "chaos armed but no fault landed"
        assert st["in_flight_handoffs"] == 0
        calm = copy.copy(args)
        calm.chaos = False
        calm_reqs = serve_stream_orch(make_disagg(api, params, calm), calm,
                                      prompts)
        assert len(reqs) == len(calm_reqs) == len(prompts)
        for a, b in zip(reqs, calm_reqs):
            assert a.generated == b.generated, \
                f"req {a.rid} diverged under chaos:\n" \
                f"  chaotic    {a.generated}\n  fault-free {b.generated}"
        for role in (ds, ps):
            assert not role["failed_requests"], role["failed_requests"]
            assert_recovery_accounted(role)
        print(f"RECOVERY-EXACT OK: {len(reqs)} token streams identical "
              f"under {total} injected faults across both roles "
              f"({_rungs(ds)})")
    return st


def _rank_main(ctx, argv):
    """``main`` on one rank of ``--ranks``: the engines take the pod mesh
    of the world's ranks; rank 0 prints."""
    import contextlib
    import os
    from repro_torch.launch.mesh import make_mesh
    args = build_parser().parse_args(argv)
    args.rank_mesh = make_mesh((ctx.world, 1), ("pod", "data"),
                               device=ctx.device)
    if ctx.rank == 0:
        return serve_main(args)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return serve_main(args)


def main(argv=None):
    import sys
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    pods, data = check_mesh(args)
    if args.ranks:
        from repro_torch.launch.ranks import spawn
        print(f"mesh {args.mesh}: {pods} pods x {data} data, one rank a "
              f"pod over {args.ranks} (stage s on rank s)")
        return spawn(_rank_main, pods, backend=args.ranks,
                     device=args.device, args=(argv,))[0]
    if backend_of(args) == "pipelined":
        print(f"mesh {args.mesh}: {pods} pods x {data} data on one card "
              f"(stages in sequence, the data axis computed whole)")
    return serve_main(args)


def serve_main(args):
    """Serve the parsed arguments' stream and run the checks they ask for;
    returns the engine's stats."""
    if args.disagg:
        return disagg_main(*build_params(args), args)
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
        _assert_no_recompile(st)
        print(f"NO-RECOMPILE OK: post_warmup_compiles="
              f"{st['post_warmup_compiles']}, 0 stalls "
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
    if args.verify_preempt:
        assert args.preempt_policy == "swap", \
            "--verify-preempt compares the swap path against its oracles"
        assert st["swap_outs"] > 0, \
            "pool never swap-preempted: nothing verified (shrink " \
            "--num-pages or raise --requests)"
        oracle = copy.copy(args)
        oracle.preempt_policy = "recompute"
        _, reqs_rc = run_once(api, params, oracle, inject)
        roomy = copy.copy(args)
        roomy.num_pages = 0      # all slots at full capacity: no preemption
        eng_ud, reqs_ud = run_once(api, params, roomy, inject)
        assert eng_ud.stats()["preemptions"] == 0
        for a, b, c in zip(reqs, reqs_rc, reqs_ud):
            assert a.generated == b.generated == c.generated, \
                f"req {a.rid} diverged across preempt policies:\n" \
                f"  swap      {a.generated}\n  recompute {b.generated}\n" \
                f"  undisturbed {c.generated}"
        print(f"PREEMPT-EXACT OK: {len(reqs)} token streams identical "
              f"across swap resume / recompute oracle / undisturbed "
              f"({st['swap_outs']} swap-outs)")
    if args.verify_recovery:
        assert args.chaos, "--verify-recovery needs --chaos"
        total = eng.faults.total_injected()
        assert total > 0, \
            "chaos armed but no fault landed: nothing verified (raise " \
            "--requests, shrink --num-pages, or set --chaos-death)"
        calm = copy.copy(args)
        calm.chaos = False
        _, calm_reqs = run_once(api, params, calm, inject)
        assert len(reqs) == len(calm_reqs)
        for a, b in zip(reqs, calm_reqs):
            assert a.generated == b.generated, \
                f"req {a.rid} diverged under chaos:\n" \
                f"  chaotic    {a.generated}\n  fault-free {b.generated}"
        assert not st["failed_requests"], st["failed_requests"]
        assert_recovery_accounted(st)
        print(f"RECOVERY-EXACT OK: {len(reqs)} token streams identical "
              f"under {total} injected faults, every fault accounted "
              f"({_rungs(st)})")
    return st


if __name__ == "__main__":
    main()
