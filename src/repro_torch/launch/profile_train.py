"""Where a training step's time goes on the card.

    python -m repro_torch.launch.profile_train [--arch llama3.2-1b]
        [--batch 8] [--seq 128] [--steps 5] [--trace train_trace.json]

Builds full-width ``--arch`` in bf16 (seeded random weights, f32 master
and moments), takes 3 warm-up steps of ``make_train_step`` on
``SyntheticTokenStream`` batches, then times ``--steps`` steps by the
host clock and as many again under ``torch.profiler`` (CPU + CUDA): host
ms per step, device-busy ms and idle share, kernels and launch calls per
step, the kernels by device time and the operators by host time (the
report of ``profile_decode``). Then it splits a step with CUDA events,
each part 5 times after a warm-up: the loss and its gradient
(``loss_fn`` + autograd), with deterministic algorithms on (as the step
runs) and off; the loss alone; ``adamw.update``; the loss head alone
(``chunked_softmax_xent`` forward and backward on the final hidden
states, f32 logits). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import ARCHS, ShapeConfig, get_arch
from repro_torch.data import SyntheticTokenStream
from repro_torch.launch.profile_decode import report, traced
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as S
from repro_torch.tree import leaves, map_tree

WARMUP = 3


def event_ms(fn, reps: int = 5) -> float:
    """Mean device ms of ``fn`` between two CUDA events, after one call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", S.CUBLAS_WORKSPACE)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    dev = torch.device("cuda")
    api = build_model(cfg, device=dev, dtype=torch.bfloat16)
    params = api.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw.init(params)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=30)
    step = S.make_train_step(api, opt_cfg,
                             ShapeConfig("p", args.seq, args.batch, "train"),
                             device=dev)
    data = SyntheticTokenStream(cfg.vocab_size, args.batch, args.seq)
    state = {"params": params, "opt": opt_state, "i": 0}

    def run(_):
        loss, state["params"], state["opt"], _g = step(
            state["params"], state["opt"], next(data), state["i"])
        state["i"] += 1
        float(loss)                  # the loop's one sync a step

    for i in range(WARMUP):
        run(i)
    bare, prof, wall = traced(run, args)
    report(prof, bare, wall, args,
           f"{cfg.name} train step (batch {args.batch} x seq {args.seq}, "
           f"{cfg.num_layers} layers, bf16, remat, eager)")

    batch = S.batch_to_device(data.batch_at(0), dev)
    params = state["params"]

    def loss_and_grad():
        tracked = map_tree(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = api.loss_fn(tracked, batch)
            return torch.autograd.grad(loss, leaves(tracked))

    def deterministic_grad():
        with S.deterministic(True):
            return loss_and_grad()

    with torch.no_grad():
        x, _, _ = api.model._blocks(params, batch["tokens"], train=True)
        h = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]

    def head():
        hh = h.detach().requires_grad_()
        ww = w.detach().requires_grad_()
        with torch.enable_grad():
            loss = L.chunked_softmax_xent(hh, ww, batch["labels"])
            return torch.autograd.grad(loss, (hh, ww))

    def loss_alone():
        with torch.no_grad():
            return api.loss_fn(params, batch)

    grads = loss_and_grad()
    it = iter(grads)
    gtree = map_tree(lambda _: next(it), params)
    scratch = adamw.init(params)
    parts = {
        "loss + gradient, deterministic (as the step)": deterministic_grad,
        "loss + gradient, nondeterministic": loss_and_grad,
        "loss alone (no grad)": loss_alone,
        "adamw.update (in place, as the step)": lambda: adamw.update(
            opt_cfg, gtree, scratch, 5, params=params),
        "head: chunked_softmax_xent forward + backward": head,
    }
    print(f"-- a step split by CUDA events (ms, mean of 5) "
          f"[{torch.cuda.get_device_name(0)}]")
    for name, fn in parts.items():
        print(f"{event_ms(fn):9.3f}  {name}")


if __name__ == "__main__":
    main()
