"""Training launcher of the port (``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --steps 200 --batch 8 --seq 64 --lr 3e-3 --device cpu

Trains on one device: ``cuda`` unless ``--device cpu`` is asked for
(without a card and without it, it raises). Weights are drawn from a
seeded ``torch.Generator`` on the device, bf16 unless ``--f32``; data is
``SyntheticTokenStream``. Supports resume from ``--ckpt-dir`` (the
reference's checkpoint layout, readable by both packages) and a final
blocking save on SIGTERM. The reference's meshes (``--mesh`` other than
``1x1``, ``--production-mesh``, ``--multi-pod``) and its compressed
cross-pod gradients (``--compress-pod-grads``) are refused by name.
"""
from __future__ import annotations

import argparse
import os
import signal

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_arch, reduced as reduce_cfg
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as S
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

SEED = 0          # the reference draws its weights from PRNGKey(0)

_REFUSED = {
    "production_mesh": "--production-mesh needs a device mesh "
                       "(ROADMAP queue 1, item 12)",
    "multi_pod": "--multi-pod needs several pods of cards "
                 "(ROADMAP queue 1, items 10 and 12)",
    "compress_pod_grads": "--compress-pod-grads (optim/compression.py) "
                          "exists only across pods (ROADMAP queue 1, "
                          "item 10)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default="", help="only '1x1' (one device)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--f32", action="store_true",
                    help="f32 weights (default bf16)")
    return ap


def check_args(args) -> None:
    """Refuse the reference's multi-device options by name."""
    if args.mesh and tuple(args.mesh.split("x")) != ("1", "1"):
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes "
            f"come with ROADMAP queue 1, items 10 and 12")
    for flag, why in _REFUSED.items():
        if getattr(args, flag):
            raise NotImplementedError(why)


def main(argv=None):
    # deterministic cuBLAS needs this before cuBLAS starts (runtime/steps.py)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", S.CUBLAS_WORKSPACE)
    args = build_parser().parse_args(argv)
    check_args(args)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    dtype = torch.float32 if args.f32 else torch.bfloat16

    api = build_model(cfg, device=dev, dtype=dtype)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    params = api.init(torch.Generator(device=dev).manual_seed(SEED))
    opt_state = adamw.init(params)
    data = SyntheticTokenStream(cfg.vocab_size, args.batch, args.seq)
    step = S.make_train_step(api, opt_cfg, shape, device=dev)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    loop = TrainLoop(train_step=step, params=params, opt_state=opt_state,
                     data=data, ckpt=ckpt,
                     cfg=TrainLoopConfig(total_steps=args.steps,
                                         ckpt_every=args.ckpt_every))
    previous = loop.install_signal_handler()
    try:
        if loop.try_restore():
            print(f"resumed from step {loop.step}")
        result = loop.run(args.steps - loop.step)
    finally:
        signal.signal(signal.SIGTERM, previous)

    losses = result["losses"]
    if losses:
        print(f"arch={cfg.name} device={dev.type} dtype={dtype} "
              f"steps={result['step']} loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f} stragglers={len(result['stragglers'])}")
    return result


if __name__ == "__main__":
    main()
