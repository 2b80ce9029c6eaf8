"""Checkpointing with atomic commit, async save and retention (the port of
``repro/checkpoint/manager.py``), in the reference's on-disk layout, so a
checkpoint moves between the two packages in both directions.

Layout:  <dir>/step_<N>/  arrays.npz + manifest.json + manifest.sha256
         <dir>/LATEST     -> committed step number (written last = atomic)

``arrays.npz`` names each leaf by its path as JAX's key path prints it:
dict keys sorted, sequence indices, and ``.field`` for a NamedTuple field
(``opt/.master/embed``, ``params/blocks/ln1``). bfloat16, which numpy
cannot hold, is widened to f32 on save (lossless) and cast back on
restore. Restore takes a tree of tensors (or ``TensorSpec``s, the
reference's ``ShapeDtypeStruct``) and puts each leaf on that leaf's device
in its dtype; re-sharding onto a mesh comes with ROADMAP item 12.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import map_tree, named_leaves


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape, dtype and device of a leaf to restore, without its data."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: Union[str, torch.device] = "cuda"


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a leaf as the numpy array the reference writes: bf16
    widened to f32 (numpy has no bfloat16). Always a copy, a CPU leaf too,
    since the caller may update its tensors while the save runs."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        """Copy every leaf to the host now (the caller may update its
        tensors in place right after), then write and commit, on a thread
        unless ``block`` or the manager is synchronous."""
        self.wait()
        host = {k: _to_host(v) for k, v in named_leaves(tree).items()}

        def commit():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {
                "step": step,
                "time": time.time(),
                "extra": extra or {},
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in host.items()},
            }
            blob = json.dumps(manifest, indent=1).encode()
            with open(os.path.join(tmp, "manifest.json"), "wb") as f:
                f.write(blob)
            with open(os.path.join(tmp, "manifest.sha256"), "w") as f:
                f.write(hashlib.sha256(blob).hexdigest())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic commit
            with open(os.path.join(self.dir, "LATEST"), "w") as f:
                f.write(str(step))
            self._gc()

        if self.async_save and not block:
            self._pending = threading.Thread(target=commit, daemon=True)
            self._pending.start()
        else:
            commit()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            s = int(f.read().strip())
        return s if s in self.all_steps() else (self.all_steps() or [None])[-1]

    def restore(self, step: int, like: Any, verify: bool = True) -> Any:
        """``like``: a tree of tensors or ``TensorSpec``s giving structure,
        and each leaf's shape, dtype and device (a CUDA device without a
        card raises). Returns a new tree of tensors."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json"), "rb") as f:
            blob = f.read()
        if verify:
            with open(os.path.join(d, "manifest.sha256")) as f:
                if hashlib.sha256(blob).hexdigest() != f.read().strip():
                    raise AssertionError("checkpoint manifest corrupted")
        names = iter(named_leaves(like))
        with np.load(os.path.join(d, "arrays.npz")) as data:
            def one(leaf):
                name = next(names)
                dev = resolve_device(leaf.device)
                arr = data[name]
                want = tuple(leaf.shape)
                if tuple(arr.shape) != want:
                    raise ValueError(f"{name}: checkpoint shape {arr.shape} "
                                     f"!= {want}")
                return torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)
            return map_tree(one, like)

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self.dir, f"step_{step}",
                               "manifest.json")) as f:
            return json.load(f)
