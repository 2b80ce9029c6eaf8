"""Serving launcher of the port: continuous batching on the paged KV path.

  python -m repro_torch.launch.serve --arch llama3.2-1b --device cuda \\
      --slots 8 --requests 16 --prompt-len 128 --max-new 32 \\
      --num-pages 30 --shared-system-prompt 0.75

Builds the model with random weights from a seeded ``torch.Generator``,
serves a synthetic request stream (the reference launcher's: uniform
prompt lengths 2..N, a fraction extending one fixed system prompt, one
arrival every two engine steps) and prints the engine's
counters. The flags mean what they mean in ``repro.launch.serve``. Runs
on ``cuda`` unless ``--device cpu`` is given; without a card it raises.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import reduced as reduce_cfg
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine

ARRIVAL_EVERY = 2       # one request every 2 engine steps (the reference
#                         launcher's default --arrival-every)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
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
    ap.add_argument("--f32", action="store_true",
                    help="float32 weights and KV (default bfloat16)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def make_config(args) -> EngineConfig:
    return EngineConfig(
        num_slots=args.slots, prompt_capacity=args.prompt_len,
        page_size=args.page_size, num_pages=args.num_pages,
        request_capacity=args.prompt_len + args.max_new)


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


def build(args):
    """(api, params, engine) for the parsed arguments."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    api = build_model(cfg, device=device, dtype=dtype)
    params = api.init(torch.Generator(device=device).manual_seed(args.seed))
    eng = ServingEngine(api, make_config(args), params, device=device)
    return api, params, eng


def main(argv=None):
    args = build_parser().parse_args(argv)
    api, _, eng = build(args)
    reqs = serve_stream(eng, args, gen_prompts(args, api.cfg.vocab_size))
    st = eng.stats()
    print(f"device={st['device']} arch={api.cfg.name} dtype={api.dtype}")
    print(f"served {st['completed']} requests, {st['tokens_out']} tokens in "
          f"{st['decode_wall_s']:.3f}s decode ({st['tok_per_s']:.1f} tok/s), "
          f"steps={st['steps']} prefill_calls={st['prefill_calls']} "
          f"admission_p50={st.get('admission_p50_ms', 0):.1f}ms")
    print(f"paging: policy={st['page_policy']}/{st['preempt_policy']} "
          f"preemptions={st['preemptions']} swap_outs={st['swap_outs']} "
          f"swap_ins={st['swap_ins']} cow_hits={st['cow_hits']} "
          f"forks={st['forks']} peak_pages={st['peak_pages_in_use']}/"
          f"{st['num_pages'] - 1}")
    if reqs:
        print("sample tokens:", reqs[0].generated)
    return st


if __name__ == "__main__":
    main()
