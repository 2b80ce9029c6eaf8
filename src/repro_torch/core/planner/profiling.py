"""Planner layer 1 — profiling (paper Sec. IV 'NN Layer Profile').

``LayerProfile`` and ``ResourceGraph`` describe the workload and the trust
topology; ``CostTables`` turns them into O(1)-queryable cost structure:

* per-device prefix sums of the roofline layer time ``max(compute, memory)``,
  so a contiguous stage's base execution time is one subtraction;
* a prefix sum of parameter bytes and a sparse-table range-max of activation
  traffic, so the EPC working set (params + peak activation + runtime
  footprint) — and hence the paging factor — is O(1) per candidate stage;
* boundary ``out_bytes`` lookups for seal/unseal and link-transfer times;
* a range-max over input similarities, so the privacy constraint over an
  untrusted suffix is one query instead of a per-layer scan.

The paging factor multiplies every layer of a stage uniformly (it depends
only on the stage's working set), so it factors out of the per-layer sum and
the prefix-sum trick is exact, not an approximation:

    stage_time = per_frame_overhead
               + paging_factor(ws) * (base[e] - base[s])
               + (e - s) * per_layer_overhead

Solvers (layer 2, ``solvers.py``) evaluate tens of thousands of candidate
stages; with these tables each costs O(1) instead of O(layers).

A copy of ``repro/core/planner/profiling.py``; its ``hlo_calibration``
reads a ``utils.cost_analysis`` count where the reference's reads an XLA
artifact.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from ..cost_model import (RUNTIME_FOOTPRINT, DeviceProfile, LinkProfile,
                          layer_exec_time, paging_factor, seal_time,
                          transmit_time)


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Per-layer profile (paper Sec. IV 'NN Layer Profile')."""
    name: str
    flops: float
    out_bytes: float
    similarity: float          # Sim(input of next layer, original input)
    params_bytes: float = 0.0
    act_bytes: float = 0.0     # activation traffic (defaults to out_bytes)
    eff: float = 1.0           # CPU/TEE execution efficiency

    def traffic(self) -> float:
        return self.act_bytes if self.act_bytes else self.out_bytes


@dataclasses.dataclass(frozen=True)
class ResourceGraph:
    """Devices + links. The segment-space solvers place any device anywhere
    in the chain; the legacy prefix solvers read ``trusted()`` as the fixed
    stage order and ``untrusted()`` as suffix candidates."""
    devices: Dict[str, DeviceProfile]
    links: Dict[Tuple[str, str], LinkProfile]
    default_link: LinkProfile

    def trusted(self) -> List[str]:
        return [n for n, d in self.devices.items() if d.trusted]

    def untrusted(self) -> List[str]:
        return [n for n, d in self.devices.items() if not d.trusted]

    def link(self, a: str, b: str) -> LinkProfile:
        return self.links.get((a, b), self.default_link)


class _RangeMax:
    """Sparse-table range maximum: O(n log n) build, O(1) query over [s, e)."""

    def __init__(self, values: Sequence[float]):
        self._levels: List[List[float]] = [list(values)]
        width = 1
        while 2 * width <= len(values):
            prev = self._levels[-1]
            self._levels.append(
                [max(prev[i], prev[i + width])
                 for i in range(len(prev) - width)])
            width *= 2

    def query(self, s: int, e: int) -> float:
        if e <= s:
            return 0.0
        k = (e - s).bit_length() - 1
        lvl = self._levels[k]
        return max(lvl[s], lvl[e - (1 << k)])


class BoundedCache(OrderedDict):
    """LRU-bounded memo for planner tables (ROADMAP follow-up (c)).

    Every telemetry-driven derate mints a fresh ``DeviceProfile``, and the
    per-device table key includes the profile — so under repeated straggler
    observations an unbounded cache gains one ``DeviceTable`` per observe().
    Capping with least-recently-used eviction keeps re-plan storms bounded
    while still serving the common hit (same profiles, surviving devices)."""

    def __init__(self, max_entries: int = 64):
        super().__init__()
        self.max_entries = max_entries

    def get(self, key, default=None):
        if key in self:
            self.move_to_end(key)
            return self[key]
        return default

    def __setitem__(self, key, value):
        if key not in self and len(self) >= self.max_entries:
            self.popitem(last=False)
        super().__setitem__(key, value)


@dataclasses.dataclass(frozen=True)
class DeviceTable:
    """Per-device prefix sums of the roofline layer time."""
    device: DeviceProfile
    base: Tuple[float, ...]    # base[i] = Σ_{x<i} max(compute_x, memory_x)


def _build_device_table(profiles: Sequence[LayerProfile],
                        device: DeviceProfile) -> DeviceTable:
    acc = [0.0]
    for l in profiles:
        eff = 1.0 if device.gemm_engine else l.eff
        compute = l.flops / (device.flops_per_s * eff)
        memory = l.traffic() / device.mem_bw
        acc.append(acc[-1] + max(compute, memory))
    return DeviceTable(device, tuple(acc))


class CostTables:
    """O(1) stage/boundary cost queries for one (profiles, graph) pair.

    ``cache`` (optional dict) memoizes per-device tables across re-plans: when
    a trust domain dies the graph shrinks but every surviving device's prefix
    table is unchanged, so ``ResourceManager.replan_on_failure`` passes a
    persistent cache and only the solver re-runs.
    """

    def __init__(self, profiles: Sequence[LayerProfile], graph: ResourceGraph,
                 input_similarity: float = 1.0,
                 cache: Optional[dict] = None):
        self.profiles = tuple(profiles)
        self.graph = graph
        self.input_similarity = input_similarity
        M = len(self.profiles)
        self.num_layers = M

        key = self.profiles
        layer_key = ("layers", key)
        layer = None if cache is None else cache.get(layer_key)
        if layer is None:
            params = [0.0]
            for l in self.profiles:
                params.append(params[-1] + l.params_bytes)
            traffic = _RangeMax([l.traffic() for l in self.profiles])
            # sims[x] = similarity of the input of layer x, for x >= 1
            sims = _RangeMax([self.profiles[x - 1].similarity
                              for x in range(1, M)]) if M > 1 else None
            layer = (tuple(params), traffic, sims)
            if cache is not None:
                cache[layer_key] = layer
        self._params, self._traffic, self._sims = layer

        self.dev: Dict[str, DeviceTable] = {}
        for name, device in graph.devices.items():
            # the device is part of the key, so a hit is never stale —
            # derated/replaced profiles hash to a fresh entry
            dev_key = ("device", key, device)
            table = None if cache is None else cache.get(dev_key)
            if table is None:
                table = _build_device_table(self.profiles, device)
                if cache is not None:
                    cache[dev_key] = table
            self.dev[name] = table

    # -- O(1) queries -------------------------------------------------------
    def working_set(self, name: str, s: int, e: int) -> float:
        d = self.graph.devices[name]
        ws = (self._params[e] - self._params[s]) + self._traffic.query(s, e)
        if d.trusted:
            ws += RUNTIME_FOOTPRINT
        return ws

    def stage_time(self, name: str, s: int, e: int) -> float:
        """Execution time of contiguous layers [s, e) on device ``name``."""
        d = self.graph.devices[name]
        pf = paging_factor(d, self.working_set(name, s, e))
        base = self.dev[name].base
        return (d.per_frame_overhead + (base[e] - base[s]) * pf
                + (e - s) * d.per_layer_overhead)

    def seal(self, name: str, boundary: int) -> float:
        """Seal (or unseal) time of the activation crossing ``boundary``
        (i.e. the output of layer boundary-1), paid by device ``name``."""
        return seal_time(self.profiles[boundary - 1].out_bytes,
                         self.graph.devices[name])

    def link_time(self, a: str, b: str, boundary: int) -> float:
        return transmit_time(self.profiles[boundary - 1].out_bytes,
                             self.graph.link(a, b))

    def max_sim(self, s: int, e: int) -> float:
        """Max input-similarity over layers [s, e) — the privacy exposure of
        running that range on an untrusted device."""
        if e <= s:
            return 0.0
        out = 0.0
        if s == 0:
            out = self.input_similarity
            s = 1
        if self._sims is not None and e > s:
            out = max(out, self._sims.query(s - 1, e - 1))
        return out


# ---------------------------------------------------------------------------
# Profile constructors: CNN tables / LM configs
# ---------------------------------------------------------------------------
def profiles_from_cnn(table, input_resolution: int = 224) -> List[LayerProfile]:
    from ..privacy import resolution_similarity
    out = []
    for l in table:
        out.append(LayerProfile(
            name=l.name, flops=l.flops, out_bytes=l.out_bytes,
            similarity=resolution_similarity(l.resolution, input_resolution),
            params_bytes=l.params_bytes, act_bytes=l.out_bytes, eff=l.eff))
    return out


def _cost_of(compiled) -> Optional[Mapping]:
    """The ``{"flops", "bytes"}`` count an artifact carries: the dict
    itself, or an object's ``cost`` (a dry-run record's
    ``raw_cost_analysis``, ``utils.cost_analysis.cost_summary``'s)."""
    if isinstance(compiled, Mapping):
        return compiled
    cost = getattr(compiled, "cost", None)
    return cost if isinstance(cost, Mapping) else None


def hlo_calibration(cfg, seq_len: int, compiled,
                    compiled_batch: int = 1) -> Optional[Tuple[float, float]]:
    """(eff, act_scale) for ``profiles_from_arch`` from a counted step (the
    reference's formula and clamps; it reads XLA's ``cost_analysis()``).

    ``compiled`` is a ``utils.cost_analysis.cost_summary`` count, ``{"flops",
    "bytes"}``, or an object that carries one as ``cost``. When the count
    holds more FLOPs than the analytic per-sequence model, the device's
    effective efficiency on this model is proportionally lower (eff < 1),
    and activation traffic is rescaled by the counted bytes-to-analytic
    ratio. ``compiled_batch`` names the count's batch size: its totals
    cover the whole batch while a profile models one sequence. Returns
    None, and callers fall back to the constant defaults, when no count is
    given, it cannot be read, or it is degenerate (no FLOPs)."""
    cs = _cost_of(compiled) if compiled is not None else None
    if cs is None:
        return None
    analytic_flops = sum(2.0 * cfg.block_active_params(i) * seq_len
                         for i in range(cfg.num_layers))
    analytic_bytes = sum(cfg.block_params(i) * 2.0 + cfg.d_model * seq_len * 2
                         for i in range(cfg.num_layers))
    batch = max(1, compiled_batch)
    measured_flops = cs.get("flops", 0.0) / batch
    measured_bytes = cs.get("bytes", 0.0) / batch
    if measured_flops <= 0.0 or analytic_flops <= 0.0:
        return None
    # eff multiplies flops_per_s in the roofline, so extra counted work
    # (beyond the embed/head share the block model ignores) lowers it
    eff = min(1.0, max(0.05, analytic_flops / measured_flops))
    act_scale = 1.0
    if measured_bytes > 0.0 and analytic_bytes > 0.0:
        act_scale = min(100.0, max(0.1, measured_bytes / analytic_bytes))
    return eff, act_scale


def profiles_from_arch(cfg, seq_len: int, similarities: Optional[Sequence[float]]
                       = None, bytes_per_el: int = 1, *,
                       calibrate_from_hlo: bool = False,
                       compiled=None,
                       compiled_batch: int = 1) -> List[LayerProfile]:
    """Per-block profiles for an assigned LM arch (decode-token costs).

    similarities: per-block representation similarity; defaults to a
    geometric decay fit. ``calibrate_from_hlo`` with ``compiled`` (a
    ``cost_summary`` count of a decode step, e.g. from
    ``cost_summary(make_decode_step(...), *args)`` on meta tensors) sets
    ``LayerProfile.eff`` and the activation traffic from
    ``hlo_calibration``; without a usable count it falls back to the
    constant defaults, as the reference's does. ``compiled_batch`` names
    the count's batch size (batch 1 calibrates most faithfully).
    """
    eff, act_scale = 1.0, 1.0
    if calibrate_from_hlo:
        calib = hlo_calibration(cfg, seq_len, compiled,
                                compiled_batch=compiled_batch)
        if calib is not None:
            eff, act_scale = calib
    out = []
    for i in range(cfg.num_layers):
        sim = (similarities[i] if similarities is not None
               else max(0.05, 0.985 ** (i + 1) - 0.0))
        flops = 2.0 * cfg.block_active_params(i) * seq_len
        out_bytes = float(cfg.d_model * seq_len * bytes_per_el * 2)
        out.append(LayerProfile(
            name=f"block{i}", flops=flops, out_bytes=out_bytes,
            similarity=float(sim),
            params_bytes=cfg.block_params(i) * 2.0,
            act_bytes=out_bytes * act_scale, eff=eff))
    return out


def stage_exec_direct(profiles: Sequence[LayerProfile], start: int, end: int,
                      device: DeviceProfile) -> float:
    """O(layers) reference stage time — the oracle the tables must match."""
    layers = profiles[start:end]
    working_set = sum(l.params_bytes for l in layers) + \
        max((l.traffic() for l in layers), default=0.0)
    if device.trusted:
        working_set += RUNTIME_FOOTPRINT
    return device.per_frame_overhead + sum(
        layer_exec_time(l.flops, l.traffic(), device, working_set, l.eff)
        for l in layers)
