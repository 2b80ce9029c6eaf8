"""Device time of the cipher kernels at the serving path's shapes, launched
eagerly and replayed inside a CUDA graph, as ``chip_smoke.py`` phase 3
times them.

    python -m repro_torch.launch.time_ciphers [--repeats 3] [--label NAME]
    PYTHONPATH=<other checkout>/src python <this file> --label parent

Times the quantizing seal and unseal at the stage boundary's [4, 2048]
bf16, the page cipher (``seal_bits`` / ``unseal_bits``) at the swap's
[10, 131072] bf16, and a launch floor (a one-element ``zero_()``), each
with ``repro_torch.launch.timing.time_ms`` (eager, behind a spin kernel)
and ``graph_time_ms`` (50 launches captured in one graph), in turns over
``--repeats`` rounds. Whatever ``repro_torch`` is on the path is timed, so
two trees compare in one call by running this file under each one's
``src`` in turns (A B B A). Key and counter are one-element device tensors
where the package's wrappers take them so (its kernels read them from
device memory), else ints (a tree whose kernels take them as launch
arguments). Every output is first held against the plain version. Prints
the card's name and power limit, one line per reading, then the means.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess

import torch

from repro_torch.kernels import ops, ref
from repro_torch.launch.timing import graph_time_ms, time_ms

KEY, SEAL_CTR, SWAP_CTR = 0xC0FFEE + 9, 65537 * 2, 0xA5A50000 ^ 6


def card() -> str:
    if not shutil.which("nvidia-smi"):
        return f"{torch.cuda.get_device_name(0)}, power limit unavailable"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def kernels():
    """(name, fn) of each cipher call, checked against its plain version;
    the key ABI the package offers ("device" or "host")."""
    device_keys = hasattr(ops, "KeyArg")
    g = torch.Generator(device="cuda").manual_seed(2)
    x = (3 * torch.randn(4, 2048, generator=g, device="cuda")).to(
        torch.bfloat16)
    pages = torch.randn(10, 131072, generator=g, device="cuda").to(
        torch.bfloat16)

    def arg(v):
        return torch.tensor([v], device="cuda") if device_keys else v

    k, sc, wc = arg(KEY), arg(SEAL_CTR), arg(SWAP_CTR)
    c, s = ops.seal(x, k, sc)
    want_c, want_s = ref.seal_ref(x, KEY, SEAL_CTR)
    assert torch.equal(s, want_s) and (c != want_c).float().mean() <= 1e-3
    assert torch.equal(ops.unseal(c, s, k, sc, torch.bfloat16),
                       ref.unseal_ref(c, s, KEY, SEAL_CTR, torch.bfloat16))
    b = ops.seal_bits(pages, k, wc)
    assert torch.equal(b, ref.seal_bits_ref(pages, KEY, SWAP_CTR))
    assert torch.equal(ops.unseal_bits(b, k, wc, torch.bfloat16), pages)
    z = torch.zeros(1, device="cuda")
    return [("seal [4, 2048]", lambda: ops.seal(x, k, sc)),
            ("unseal [4, 2048]",
             lambda: ops.unseal(c, s, k, sc, torch.bfloat16)),
            ("seal_bits [10, 131072]", lambda: ops.seal_bits(pages, k, wc)),
            ("unseal_bits [10, 131072]",
             lambda: ops.unseal_bits(b, k, wc, torch.bfloat16)),
            ("launch floor", lambda: z.zero_())], \
        "device" if device_keys else "host"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_ciphers: needs a CUDA device")
    runs, abi = kernels()
    tag = f"{args.label} ({abi} keys)" if args.label else f"{abi} keys"
    print(f"card: {card()}; {tag}", flush=True)
    sums = {name: [0.0, 0.0] for name, _ in runs}
    for r in range(args.repeats):
        for name, fn in runs:
            eager, graph = time_ms(fn), graph_time_ms(fn)
            sums[name][0] += eager
            sums[name][1] += graph
            print(f"{tag} round {r}: {name}: eager {eager * 1e3:.4f} us, in "
                  f"a graph {graph * 1e3:.4f} us", flush=True)
    for name, (eager, graph) in sums.items():
        print(f"{tag} mean of {args.repeats}: {name}: eager "
              f"{eager / args.repeats * 1e3:.4f} us, in a graph "
              f"{graph / args.repeats * 1e3:.4f} us", flush=True)


if __name__ == "__main__":
    main()
