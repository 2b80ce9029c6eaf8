"""Per-layer execution cost model over heterogeneous trust domains.

Faithful to Sec. IV of the paper: each layer L_x has a profile — execution
time on every device class, output bytes D_Lx, transmission time
tr = D_Lx / B + latency, and a similarity (privacy) value. The TEE model
includes the 128 MB EPC paging penalty (the paper's Fig. 13 observation that
splitting AlexNet across two enclaves makes the *sum* of times drop).

Device classes for the faithful CNN reproduction are calibrated to the
paper's own measurements (Sec. VI-D): SqueezeNet ~1.1 s and ResNet ~7.2 s
per frame in one TEE; AES sealing <2.5 ms/frame; tx 0.01–0.12 s at 30 Mbps.
The same machinery is reused at TPU scale with pod-level constants.

A copy of ``repro/core/cost_model.py``. Its device classes (``TEE``,
``CPU``, ``GPU``, the ``TPU_POD*`` pods and the links) are the reference
planner's model inputs, kept verbatim so that the port plans the same
placement as the reference. They are not measurements of the card the port
runs on; H100 profiles come only once an H100 has been measured.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

MB = 1e6
EPC_BYTES = 128 * MB


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    trusted: bool
    flops_per_s: float                 # effective sustained throughput
    mem_bw: float                      # effective activation-traffic bandwidth
    sealed_memory: Optional[float] = None   # EPC size (TEE only)
    paging_penalty: float = 0.5        # extra slowdown per 1x EPC overflow
    per_layer_overhead: float = 2e-3   # dispatch/ECALL cost per layer
    per_frame_overhead: float = 0.0    # dataflow-engine dispatch per frame
    seal_bw: float = 1.2e9             # AES-CTR sealing bandwidth (bytes/s)
    gemm_engine: bool = False          # dedicated engine: per-layer eff = 1


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    name: str
    bandwidth: float                   # bytes/s
    latency: float = 5e-3


# --- calibrated device classes (see EXPERIMENTS.md §Calibration) ----------
RUNTIME_FOOTPRINT = 30 * MB        # TFLite + Asylo runtime resident in EPC

TEE = DeviceProfile("tee", True, flops_per_s=1.05e9, mem_bw=2e9,
                    sealed_memory=EPC_BYTES, per_frame_overhead=0.08)
CPU = DeviceProfile("cpu", False, flops_per_s=9e9, mem_bw=8e9,
                    per_layer_overhead=3e-4, per_frame_overhead=0.04)
GPU = DeviceProfile("gpu", False, flops_per_s=80e9, mem_bw=60e9,
                    per_layer_overhead=2e-4, per_frame_overhead=0.04,
                    gemm_engine=True)
WAN_30MBPS = LinkProfile("wan", bandwidth=30e6 / 8, latency=10e-3)

# TPU-scale trust domains (beyond-paper: pods as domains)
TPU_POD_TRUSTED = DeviceProfile(
    "tpu-pod-cc", True, flops_per_s=0.6 * 197e12 * 256, mem_bw=0.6 * 819e9 * 256,
    sealed_memory=None, per_layer_overhead=5e-6, seal_bw=400e9)
TPU_POD = DeviceProfile(
    "tpu-pod", False, flops_per_s=197e12 * 256, mem_bw=819e9 * 256,
    per_layer_overhead=5e-6, seal_bw=400e9)
DCN_LINK = LinkProfile("dcn", bandwidth=25e9, latency=1e-4)


def paging_factor(device: DeviceProfile, working_set: float) -> float:
    """TEE slowdown once the per-device working set spills out of the EPC."""
    if device.sealed_memory is None or working_set <= device.sealed_memory:
        return 1.0
    overflow = working_set / device.sealed_memory - 1.0
    return 1.0 + device.paging_penalty * overflow


def layer_exec_time(flops: float, act_bytes: float, device: DeviceProfile,
                    working_set: float, eff: float = 1.0) -> float:
    """Roofline-style max(compute, memory) + fixed overhead, derated by
    EPC paging for the working set of the layers co-resident on the device."""
    pf = paging_factor(device, working_set)
    if device.gemm_engine:
        eff = 1.0
    compute = flops / (device.flops_per_s * eff)
    memory = act_bytes / device.mem_bw
    return max(compute, memory) * pf + device.per_layer_overhead


def seal_time(out_bytes: float, device: DeviceProfile) -> float:
    """AES-CTR seal (or unseal) of a stage boundary tensor."""
    return out_bytes / device.seal_bw


def transmit_time(out_bytes: float, link: LinkProfile) -> float:
    return out_bytes / link.bandwidth + link.latency
