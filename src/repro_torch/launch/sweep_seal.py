"""Launch plans of the quantizing seal and unseal, timed on the card.

    python -m repro_torch.launch.sweep_seal [--repeats 3]

Times ``ops.seal`` and ``ops.unseal`` at the pipeline boundary's [4, 2048]
and at [8, 2048] in bf16 for each candidate plan: the seal's threads per
block (``ops._seal_threads``: one block per row, a row wider than one
tile of threads x 4 columns reads its later tiles again) and the unseal's
most threads per block (``ops._unseal_plan``). Each time is
``repro_torch.launch.timing.time_ms``, the timing of ``chip_smoke.py``
phase 3: a spin kernel holds the stream while the host enqueues the
calls, operands stay L2-resident. Candidates take
turns, ``--repeats`` rounds, and each round also times a launch floor (a
one-element ``zero_()`` under the same timing). Every candidate's output is
first held against the plain version: cipher bytes equal but for rounding
ties and scales equal (seal), bit-equal (unseal). Prints the card's name
and power limit, one line per reading, and the mean per candidate. Needs
a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import shutil
import subprocess

import torch

from repro_torch.kernels import ops, ref
from repro_torch.launch.timing import time_ms

SHAPES = ((4, 2048), (8, 2048))
SEAL_THREADS = (128, 256, 512, 1024)
UNSEAL_THREADS = (32, 64, 128, 256, 512)
KEY, CTR = 0xC0FFEE + 9, 65537 * 2


def card() -> str:
    if not shutil.which("nvidia-smi"):
        return f"{torch.cuda.get_device_name(0)}, power limit unavailable"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plan(seal_threads=None, unseal_most=None):
    """The wrappers' plans set to one candidate for the block's calls."""
    saved = ops._seal_threads, ops._UNSEAL_THREADS
    if seal_threads:
        ops._seal_threads = lambda cols: seal_threads
    if unseal_most:
        ops._UNSEAL_THREADS = unseal_most
    try:
        yield
    finally:
        ops._seal_threads, ops._UNSEAL_THREADS = saved


def candidates(x, c, sc):
    """(label, plan arguments, fn) for every candidate, each held against
    the plain version under its plan. Key and counter are device tensors,
    as the serving path passes them."""
    rows, cols = x.shape
    key = torch.tensor([KEY], device=x.device)
    ctr = torch.tensor([CTR], device=x.device)
    wc, ws = ref.seal_ref(x, KEY, CTR)
    want = ref.unseal_ref(c, sc, KEY, CTR, torch.bfloat16)
    out = []
    for threads in SEAL_THREADS:
        with plan(seal_threads=threads):
            got, gs = ops.seal(x, key, ctr)
        assert torch.equal(gs, ws) and (got != wc).float().mean() <= 1e-3, \
            ("seal", threads)
        out.append((f"seal threads={threads}", dict(seal_threads=threads),
                    lambda: ops.seal(x, key, ctr)))
    for most in UNSEAL_THREADS:
        with plan(unseal_most=most):
            got = ops.unseal(c, sc, key, ctr, torch.bfloat16)
            threads, tiles = ops._unseal_plan(cols)
        assert torch.equal(got, want), ("unseal", most)
        out.append((f"unseal threads={most} ({tiles} tiles of {threads} "
                    f"threads x {rows} rows)", dict(unseal_most=most),
                    lambda: ops.unseal(c, sc, key, ctr, torch.bfloat16)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_seal: needs a CUDA device")
    print(f"card: {card()}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(2)
    z = torch.zeros(1, device="cuda")
    for shape in SHAPES:
        x = (3 * torch.randn(*shape, generator=g, device="cuda")).to(
            torch.bfloat16)
        c, sc = ops.seal(x, KEY, CTR)
        runs = candidates(x, c, sc)
        sums = {label: 0.0 for label, _, _ in runs}
        floor = 0.0
        for r in range(args.repeats):
            for label, kw, fn in runs:
                with plan(**kw):
                    ms = time_ms(fn)
                sums[label] += ms
                print(f"{list(shape)} round {r}: {label}: {ms * 1e3:.4f} us",
                      flush=True)
            f = time_ms(lambda: z.zero_())
            floor += f
            print(f"{list(shape)} round {r}: launch floor {f * 1e3:.4f} us",
                  flush=True)
        for label, total in sums.items():
            print(f"{list(shape)} mean of {args.repeats}: {label}: "
                  f"{total / args.repeats * 1e3:.4f} us", flush=True)
        print(f"{list(shape)} mean of {args.repeats}: launch floor "
              f"{floor / args.repeats * 1e3:.4f} us", flush=True)


if __name__ == "__main__":
    main()
