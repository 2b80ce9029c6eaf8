"""Training launcher of the port (``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --steps 200 --batch 8 --seq 64 --lr 3e-3 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --steps 3 --device cpu --mesh 2x2 --multi-pod \\
      --compress-pod-grads --backend gloo

Trains on ``cuda`` unless ``--device cpu`` is asked for (without a card
and without it, it raises). Weights are drawn from a seeded
``torch.Generator`` on the device, bf16 unless ``--f32``; data is
``SyntheticTokenStream``. Supports resume from ``--ckpt-dir`` (the
reference's checkpoint layout, readable by both packages) and a final
blocking save on SIGTERM.

``--mesh`` names the axes as the reference's launcher does without
``--multi-pod``: ``DxM`` is (data, model). With ``--multi-pod`` it reads
``PxD[xM]``: (pod, data[, model]) from the left. (The reference takes the
last names of (pod, data, model), so its two-dim ``--multi-pod`` mesh has
no pod axis; three dims agree.) A mesh of more than one device runs one
rank per device, which the launcher spawns itself (``launch.ranks``) over
the backend ``--backend`` names (required then; ``nccl`` needs a card per
rank); each rank trains on its rows of the global batch and rank 0 prints
and writes checkpoints. ``--compress-pod-grads`` on a mesh with pods runs
the compressed step (int8 error-feedback exchange between pods); without
a pod axis it is the plain step, as in the reference. A ``model`` axis
above 1 (tensor parallelism, ROADMAP item 10b) and ``--production-mesh``
(512 chips) are refused by name.
"""
from __future__ import annotations

import argparse
import math
import os
import signal
import sys
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_arch, reduced as reduce_cfg
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.device import resolve_device
from repro_torch.launch import ranks as RK
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import init_error_feedback
from repro_torch.runtime import steps as S
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

SEED = 0          # the reference draws its weights from PRNGKey(0)


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
    ap.add_argument("--mesh", default="",
                    help="DxM (data x model), or PxD[xM] with --multi-pod")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--backend", choices=RK.BACKENDS, default=None,
                    help="process group of a mesh of several devices "
                         "(required then)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--f32", action="store_true",
                    help="f32 weights (default bf16)")
    return ap


def mesh_axes(args) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(sizes, names) of ``--mesh``; (1, 1) over (data, model) without it,
    the reference's default."""
    if not args.mesh:
        return (1, 1), ("data", "model")
    try:
        dims = tuple(int(x) for x in args.mesh.split("x"))
    except ValueError:
        dims = ()
    if not 1 <= len(dims) <= (3 if args.multi_pod else 2) \
            or min(dims) < 1:
        raise ValueError(f"--mesh {args.mesh}: want "
                         f"{'PxD[xM]' if args.multi_pod else 'DxM'}")
    names = ("pod", "data", "model")[:len(dims)] if args.multi_pod \
        else ("data", "model")[-len(dims):]
    return dims, names


def check_args(args) -> None:
    """Refuse what the port does not run, by name, before anything
    starts."""
    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the 16x16 (512-chip with --multi-pod) "
            "production mesh is logical here (launch/mesh.py); the port "
            "trains over ranks of pod and data (ROADMAP queue 1, item 10b)")
    dims, names = mesh_axes(args)
    sizes = dict(zip(names, dims))
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"--mesh {args.mesh}: a model axis of {sizes['model']} is "
            f"tensor parallelism (ROADMAP queue 1, item 10b)")
    n = math.prod(dims)
    if n > 1:
        if args.backend is None:
            raise ValueError(f"--mesh {args.mesh}: {n} devices run as {n} "
                             f"ranks; name their backend with --backend "
                             f"gloo or --backend nccl")
        RK.check_backend(args.backend, n, args.device)


def _run(args, dev: torch.device, mesh, names) -> dict:
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
    compressed = args.compress_pod_grads and "pod" in names \
        and mesh is not None
    step = S.make_train_step(api, opt_cfg, shape, device=dev, mesh=mesh,
                             compress_pod_grads=compressed)
    extra = (init_error_feedback(params),) if compressed else ()

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    loop = TrainLoop(train_step=step, params=params, opt_state=opt_state,
                     data=data, ckpt=ckpt,
                     cfg=TrainLoopConfig(total_steps=args.steps,
                                         ckpt_every=args.ckpt_every),
                     extra_step_args=extra)
    lead = mesh is None or dist.get_rank() == 0
    previous = loop.install_signal_handler()
    try:
        if loop.try_restore() and lead:
            print(f"resumed from step {loop.step}")
        result = loop.run(args.steps - loop.step)
    finally:
        signal.signal(signal.SIGTERM, previous)

    losses = result["losses"]
    if losses and lead:
        where = "" if mesh is None else \
            f" mesh={dict(zip(names, mesh.mesh.shape))} " \
            f"backend={dist.get_backend()}{' compressed' * compressed}"
        print(f"arch={cfg.name} device={dev.type} dtype={dtype}{where} "
              f"steps={result['step']} loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f} stragglers={len(result['stragglers'])}")
    return result


def rank_main(ctx: RK.RankContext, argv) -> dict:
    """One rank of a mesh run (``main`` spawns one per device)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", S.CUBLAS_WORKSPACE)
    args = build_parser().parse_args(argv)
    dims, names = mesh_axes(args)
    mesh = make_mesh(dims, names, device=ctx.device)
    return _run(args, ctx.device, mesh, names)


def main(argv=None):
    # deterministic cuBLAS needs this before cuBLAS starts (runtime/steps.py)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", S.CUBLAS_WORKSPACE)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    check_args(args)
    dev = resolve_device(args.device)
    dims, names = mesh_axes(args)
    n = math.prod(dims)
    if n == 1:
        return _run(args, dev, None, names)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()          # once, before the ranks load it
    return RK.spawn(rank_main, n, backend=args.backend, device=dev,
                    args=(argv,))[0]


if __name__ == "__main__":
    main()
