"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library under ``<repo>/build/repro_torch_kernels/`` (listed in
``.gitignore``), named by a hash of its source and of the shared headers
(``csrc/*.cuh``) so an edited kernel or header rebuilds and an unchanged
one loads as is. All sources compile in
parallel, one ``nvcc`` each. The build runs at first use, never at import:
this module imports on hosts that have no ``nvcc`` and no card.

    python -m repro_torch.kernels.build      # build everything, print ptxas
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "repro_torch_kernels"
SOURCES = ("paged_attention", "seal_bits", "seal_q8", "flash_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
# entry -> (source, C function, argtypes); pointers and the stream are
# c_void_p, or ctypes would pass them as 32-bit ints
SIGNATURES = {
    "paged_attention": ("paged_attention", "repro_paged_attention",
                        [_P] * 9 + [_I] * 7 + [_F, _I, _I, _P]),
    # the cipher kernels read key and counter from device memory: two
    # pointers, each to one int64
    "seal_bits": ("seal_bits", "repro_bits_xor",
                  [_P, _P, _LL, _P, _P, _I, _I, _LL, _LL, _LL, _I, _I, _P]),
    "seal_q8": ("seal_q8", "repro_seal_q8", [_P, _P, _P, _I, _I, _P, _P]
                + [_I] * 3 + [_P]),
    "unseal_q8": ("seal_q8", "repro_unseal_q8", [_P, _P, _P, _I, _I, _P, _P]
                  + [_I] * 4 + [_P]),
    "flash_attention": ("flash_attention", "repro_flash_attention",
                        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _F, _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}          # source -> nvcc/ptxas output


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every shared header (any of them may be included) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(force: bool = False) -> float:
    """Compile every source that has no up-to-date library, all in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if force or not _target(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc {proc.returncode}) ---\n{out}")
            continue
        # atomic: a reader never sees a partly written library
        os.replace(tmp, _target(name))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _target(name).exists():
                build_all()
            lib = ctypes.CDLL(str(_target(name)))
            for source, fn_name, argtypes in SIGNATURES.values():
                if source == name:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def entry(name: str):
    """The C entry point ``name`` (a key of ``SIGNATURES``) with its
    argtypes set."""
    source, fn_name, _ = SIGNATURES[name]
    return getattr(load(source), fn_name)


if __name__ == "__main__":
    secs = build_all(force=True)
    for n in SOURCES:
        print(f"== {n}.cu ==\n{BUILD_LOG.get(n, '')}")
    print(f"built {len(SOURCES)} libraries in {secs:.1f} s into {BUILD_DIR}")
