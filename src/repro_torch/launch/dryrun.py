"""Dry-run of every (arch x shape) cell on the production mesh (the port
of ``repro/launch/dryrun.py``).

For each cell this builds the REAL step (the train step with its AdamW
update, or the prefill / decode serve step) over ``abstract_inputs``'
meta tensors, which hold no memory, on the logical production mesh
(16 x 16, or 2 x 16 x 16 with ``--multi-pod``), runs it once under
``utils.cost_analysis.cost_summary`` and records:

* ``raw_cost_analysis``: the counted FLOPs and unfused bytes (on meta,
  where every kernel wrapper takes its plain version, so attention is
  visible to the counter);
* ``memory``: per-device bytes from the sharding trees, exact for the
  arguments (params, opt state, batch and cache shards) and the outputs;
  ``temp_gb`` is null, since nothing is compiled;
* the ``analytic_cost.estimate`` terms, its ``Roofline`` on the H100's
  datasheet figures, ``model_flops``, ``useful_flops_ratio`` and
  ``tokens``;
* ``collectives``: null, with the reason (the reference parses them from
  the partitioned HLO; the port has none, ROADMAP item 10).

Writes one JSON per cell under ``experiments/dryrun_torch/``; a failed
cell is recorded with its traceback and makes the run exit 1.

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ARCHS, SHAPES, get_arch, get_shape,
                                 shape_applicable)
from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as S
from repro_torch.sharding import rules as R
from repro_torch.tree import leaves
from repro_torch.utils import analytic_cost as AC
from repro_torch.utils import cost_analysis as CA

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "experiments", "dryrun_torch")

NO_COLLECTIVES = ("collective bytes need the model running as DTensors over "
                  "a mesh of several ranks (ROADMAP item 10); the port counts "
                  "on one device")


def _mesh_tag(mesh) -> str:
    return "pod" + "x".join(str(n) for n in
                            R.mesh_axis_sizes(mesh).values())


def _shard_bytes(tensors, shardings) -> int:
    """Per-device bytes of ``tensors`` laid out by ``shardings`` (two
    trees of one structure)."""
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for t, sh in zip(leaves(tensors), leaves(shardings)))


def lower_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
               act_rules=None, param_rules=None, extra_tag: str = "",
               cache_quant: bool = False, sharded_logits: bool = False,
               mesh=None, cfg=None, shape=None):
    """Returns (step, its meta arguments, the model, meta dict); the step
    is None for a skipped cell. ``mesh``, ``cfg`` and ``shape`` replace the
    production mesh and the registered config and shape (the tests' small
    cells)."""
    cfg = cfg or get_arch(arch_name)
    shape = shape or get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, None, None, {"skipped": why}

    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    api = build_model(cfg, device="meta", max_seq=shape.seq_len,
                      cache_quant=cache_quant)
    abstract = S.abstract_inputs(api, shape)
    t0 = time.time()
    with mesh_context(mesh):
        if shape.kind == "train":
            step = S.make_train_step(api, AdamWConfig(), shape,
                                     device="meta", mesh=mesh,
                                     act_rules=act_rules,
                                     param_rules=param_rules)
            args = (abstract["params"], abstract["opt"], abstract["batch"],
                    torch.empty((), dtype=torch.int32, device="meta"))
        elif shape.kind == "prefill":
            step = S.make_prefill_step(api, mesh, shape, act_rules=act_rules,
                                       param_rules=param_rules,
                                       sharded_logits=sharded_logits)
            args = (abstract["params"], abstract["batch"])
        else:  # decode
            step = S.make_decode_step(api, mesh, shape, act_rules=act_rules,
                                      param_rules=param_rules,
                                      sharded_logits=sharded_logits)
            args = (abstract["params"], abstract["cache"], abstract["batch"])
    meta = {"arch": arch_name, "shape": shape_name,
            "mesh": _mesh_tag(mesh), "build_s": round(time.time() - t0, 1),
            "tag": extra_tag, "cache_quant": cache_quant,
            "sharded_logits": sharded_logits}
    return step, args, api, meta


def memory(api, shape, mesh, act_rules, param_rules,
           sharded_logits: bool = False) -> Dict[str, Any]:
    """Per-device bytes from the sharding trees: the step's arguments and
    outputs (the reference's ``out_shardings``), and what the outputs
    alias (the buffers the reference donates: params and opt state to
    train, the cache to decode)."""
    abstract = S.abstract_inputs(api, shape)
    ps = S.param_shardings(api, mesh, param_rules)
    params = _shard_bytes(abstract["params"], ps)
    batch = _shard_bytes(abstract["batch"],
                         S.batch_shardings(api, shape, mesh, act_rules))
    B, V = shape.global_batch, api.cfg.vocab_size
    if sharded_logits:
        logits = 4 * math.prod(R.logical_sharding(
            (B, V), ("act_batch", "act_vocab"), mesh, act_rules
        ).shard_shape((B, V)))
    else:
        logits = 4 * B * V
    if shape.kind == "train":
        opt = 3 * _shard_bytes(abstract["opt"].master, ps)
        arg = params + opt + batch + 4            # + the int32 step
        out = 4 + params + opt + 4                # loss, params, opt, gnorm
        alias = params + opt
    else:
        one = lambda spec, axes: math.prod(R.logical_sharding(
            spec[0], axes, mesh, act_rules).shard_shape(spec[0])) * \
            torch.empty((), dtype=spec[1]).element_size()
        cache = sum(leaves(S.zip_specs(
            one, api.init_cache_specs(shape.global_batch, shape.seq_len),
            api.init_cache_axes(shape.global_batch, shape.seq_len))))
        if shape.kind == "prefill":
            arg, out, alias = params + batch, logits + cache, 0
        else:
            arg, out, alias = params + cache + batch, logits + cache, cache
    gb = 1e9
    return {"argument_bytes": arg, "argument_gb": arg / gb,
            "output_gb": out / gb, "temp_gb": None, "alias_gb": alias / gb,
            "per_device_gb": (arg + out - alias) / gb}


def analyze(step, args, api, meta, cfg, shape, mesh, act_rules,
            param_rules) -> Dict[str, Any]:
    t0 = time.time()
    raw_cost = CA.cost_summary(step, *args)
    count_s = time.time() - t0
    est = AC.estimate(cfg, shape,
                      cache_bytes=1 if meta.get("cache_quant") else 2,
                      state_bytes=2 if meta.get("cache_quant") else 4)
    roof = CA.Roofline(est.flops, est.hbm_bytes, 0.0, R.mesh_size(mesh))
    rec = dict(meta)
    rec.update({
        "count_s": round(count_s, 1),
        "memory": memory(api, shape, mesh, act_rules, param_rules,
                         meta.get("sharded_logits", False)),
        "raw_cost_analysis": raw_cost,
        "collectives": None,
        "collectives_note": NO_COLLECTIVES,
        "roofline": roof.as_dict(),
        "model_flops": est.model_flops,
        "useful_flops_ratio": est.useful_ratio,
        "tokens": shape.tokens,
    })
    return rec


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             save: bool = True, act_rules=None, param_rules=None,
             tag: str = "", cache_quant: bool = False,
             sharded_logits: bool = False, out_dir: Optional[str] = None,
             mesh=None, cfg=None, shape=None) -> dict:
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    act_rules = act_rules or R.ACT_RULES
    param_rules = param_rules or R.PARAM_RULES
    try:
        cfg = cfg or get_arch(arch_name)
        shape = shape or get_shape(shape_name)
        step, args, api, meta = lower_cell(
            arch_name, shape_name, multi_pod=multi_pod,
            act_rules=act_rules, param_rules=param_rules, extra_tag=tag,
            cache_quant=cache_quant, sharded_logits=sharded_logits,
            mesh=mesh, cfg=cfg, shape=shape)
        if step is None:
            rec = {"arch": arch_name, "shape": shape_name,
                   "mesh": _mesh_tag(mesh), **meta}
        else:
            rec = analyze(step, args, api, meta, cfg, shape, mesh,
                          act_rules, param_rules)
    except Exception as e:  # record failures: they are bugs to fix
        rec = {"arch": arch_name, "shape": shape_name,
               "mesh": _mesh_tag(mesh), "error": str(e),
               "trace": traceback.format_exc()[-2000:]}
    if save:
        out_dir = out_dir or OUT_DIR
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = (f"{arch_name.replace('.', '_')}__{shape_name}__"
              f"{_mesh_tag(mesh)}{suffix}.json")
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--cache-quant", action="store_true")
    ap.add_argument("--sharded-logits", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence-parallel residual stream (train)")
    ap.add_argument("--out-dir", default=None,
                    help="where the JSON records go (default "
                         "experiments/dryrun_torch/ in the checkout)")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = sorted(SHAPES) if args.shape == "all" else [args.shape]

    failures = 0
    for a in archs:
        for s in shapes:
            t0 = time.time()
            act = R.SP_ACT_RULES if args.sp else None
            rec = run_cell(a, s, multi_pod=args.multi_pod, tag=args.tag,
                           cache_quant=args.cache_quant,
                           sharded_logits=args.sharded_logits,
                           act_rules=act, out_dir=args.out_dir)
            dt = time.time() - t0
            if "error" in rec:
                failures += 1
                print(f"FAIL {a:24s} {s:12s} {rec['mesh']}: "
                      f"{rec['error'][:120]}", flush=True)
            elif "skipped" in rec:
                print(f"skip {a:24s} {s:12s}: {rec['skipped'][:80]}",
                      flush=True)
            else:
                r = rec["roofline"]
                c = rec["raw_cost_analysis"]
                print(f"ok   {a:24s} {s:12s} {rec['mesh']} "
                      f"[{dt:5.1f}s] dom={r['dominant']:10s} "
                      f"comp={r['compute_s']:.2e}s mem={r['memory_s']:.2e}s "
                      f"coll=none "
                      f"useful={rec['useful_flops_ratio']:.2f} "
                      f"dev_gb={rec['memory']['per_device_gb']:.2f} "
                      f"counted_flops={c['flops']:.3e} "
                      f"analytic_flops={r['flops']:.3e}", flush=True)
    if failures:
        print(f"{failures} FAILURES", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
