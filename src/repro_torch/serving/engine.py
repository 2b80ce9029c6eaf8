"""Continuous-batching serving engine of the port (port of
``repro/serving/engine.py``), on two KV layouts: the paged cache, the
default, and the reference's legacy shared-position timeline.

What this slice keeps from the reference, with the same host-side
decisions so that greedy token streams are equal:

* a placement planned over the trust domains on every backend
  (``OnlineReplanner`` over ``rm``, two enclaves by default), and every
  ``telemetry_interval`` steps a telemetry tick: per-stage times feed
  ``StageTelemetry.maybe_observe``; a re-plan swaps the stage boundaries
  live (``try_swap``) and decode continues token-exactly;
* two decode backends: ``PagedLocalBackend`` runs ``decode_paged_fn``
  over every layer at once (stage boundaries are metadata there), and
  ``PagedPipelinedBackend`` runs the planned stages in sequence on the
  card, microbatch by microbatch, sealing every stage boundary with the
  quantizing ``seal`` kernel (``runtime/pipeline.py``);
* a paged per-slot KV cache: shared page pools ``[L, N, KVH, Pg, D]`` and
  per-slot block tables, page 0 the immutable null page;
* ``page_policy="demand"`` (block tables grow a page at a time, identical
  prompt-prefix pages shared copy-on-write, decode-completed pages frozen
  into the prefix index with ``decode_cow``) and ``"reserve"`` (worst case
  at admission, the oracle);
* bucketed, right-padded whole-prompt admission through ``prefill_at_fn``;
  ``prefill_pack`` K > 1 admits up to K short queued prompts in one
  ``prefill_packed_fn`` call, and ``prefill_chunk`` C > 0 streams prompts
  longer than C in C-token chunks (``prefill_chunk_fn``), at most one chunk
  per engine step between decode ticks, the slot in the PREFILL state
  until its last chunk lands;
* preemption when the pool runs dry: ``"swap"`` gathers the victim's
  private pages, seals them with the ``seal_bits`` kernel into host memory
  and restores them bit for bit at resume with ``unseal_bits``;
  ``"recompute"`` re-prefills prompt + generated tokens (the oracle).

On the card every prefill (one-shot, packed or chunk) runs the CUDA
flash-attention kernel in every layer, every decode step's attention the
CUDA paged-attention kernel, every stage boundary the CUDA quantizing seal
and every swap the CUDA page cipher; on the CPU the same calls take the
plain PyTorch versions.

``warmup=True`` is the reference's AOT warmup as CUDA graphs
(``serving/aot.py``), on both backends: ``warmup()`` captures every shape
the steady-state loop dispatches -- the decode step (on the pipelined
backend one per stage layout, ``step{layout}``, with its per-stage
telemetry probe, ``probe{layout}``, for the planned layout and every
layout of the reference's tour), one-shot and packed prefill at every
bucket, a prefill chunk at every chunk offset, and the swap I/O
(``gather_pages`` / ``scatter_pages``); on the timeline the decode step,
the per-token prefill step (``prefill_token``, one graph per cache width)
and the slot ``insert`` -- and from then on each of those calls is one
graph replay, holding the paged, flash, seal and cipher kernels. Per-call numbers (tokens, prompt lengths, write targets,
block-table rows, page vectors, swap payloads, keys and swap sequence
numbers) reach the device through pinned, non-blocking copies into the
graphs' static buffers: the seal and cipher kernels read their key and
counter from device memory, so a replayed step seals under the key copied
in for it. What stays eager: page-table maintenance (``insert_slot``,
``commit_slot``, ``clear_slot``, ``set_table_entry``, ``copy_page``), a
few small launches per admission or fork. On a rank engine
(``serving/ranked.py``) every rank runs the warmup passes in lockstep and
manages the device work between its messages instead of whole calls;
there the prefills are a stage layout's own, so the tour warms them for
each layout too.

``disagg_role`` is the reference's disaggregated prefill/decode
(``serving/disagg.py`` drives a pair): a ``"prefill"`` engine prefills,
samples the first token and seals every KV page of the slot with the page
cipher under a counter from the transfer space (``export_transfer``); a
``"decode"`` engine resolves the manifest's rows against its own prefix
index (``ingest_transfer``), unseals and scatters the sealed rows in one
``scatter_pages`` call at admission (``_transfer_in``) and decodes on. A
tampered payload falls back to a teacher-forced re-prefill of prompt plus
first token. The prefill role draws its swap sequence numbers and stage
boundary keys from the upper half of each space, so the two roles, which
seal under one key, never cipher under one (key, counter) pair.

``faults`` arms the reference's chaos fault plane (``serving/faults.py``)
at the reference's points of the step: a pool-exhaustion storm drawn first
thing in every step, a tamper of a swap payload at the top of every
swap-in, and a stage stall and a device death at every telemetry tick,
between the heartbeat pass and the replanner's observation. Each injected
fault lands on a named rung of the recovery ladder (``stats()["recovery"]``)
or on a pending marker (``stats()["faults_pending"]``): a tampered payload
fails its digest and re-prefills teacher-forced, a device death spills
every active slot through the page cipher and re-plans around the corpse,
a storm's pages come back on a timer or to the deadlock breaker. Nothing
draws during warmup, and the warmup reset re-seeds the plane, so a warmed
engine and a cold one replay one fault schedule.

Sampling at ``temperature > 0`` (``top_k``, ``sample_seed``) keys each
row by its (rid, index) as the reference does (``serving/sampling.py``);
a warmed engine captures the sampler as one graph per batch shape.

``kv_layout="timeline"`` (and any model without a paged cache: an int8
KV cache, ``build_model(cache_quant=True)``) serves on the reference's
legacy timeline: one cache ``[L, num_slots, KVH, max_seq, D]`` whose
position ``len`` every slot shares, starting at ``prompt_capacity``. A
prompt is prefilled one token at a time (``decode_fn`` on a static
private ``[1, max_seq]`` cache, the managed ``prefill_token``) so that it
ends at the timeline's tip, and copied into its slot with a per-slot
``start`` mask (``insert``). The horizon is enforced by admission back-
pressure: a request whose worst case would run past ``max_seq`` waits,
and once nothing can ever fit the engine stalls. There is no page pool:
no swap, no COW, no handoff (asking for them raises by name), and
``preempt_policy="auto"`` resolves to ``recompute``. The local backend is
``LocalDecodeBackend``, the pipelined one ``PipelinedDecodeBackend``.
``batched_prefill=False`` prefills the paged layout one token at a time
too, through the same ``prefill_token`` over a ``[1, bucket]`` cache.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.planner import (InfeasibleError, LayerProfile,
                                      PlacementSpec, profiles_from_arch)
from repro_torch.core.privacy import LM_SIM_DELTA
from repro_torch.device import resolve_device, to_device
from repro_torch.enclave import sealing
from repro_torch.enclave.domain import ResourceManager, two_enclave_manager
from repro_torch.runtime.ft import HeartbeatMonitor, OnlineReplanner
from repro_torch.runtime.pipeline import PipelinedDecoder, pipeline_applicable
from repro_torch.serving.aot import AotRegistry
from repro_torch.serving.faults import FaultConfig, FaultPlane
from repro_torch.serving.sampling import TokenSampler
from repro_torch.serving.scheduler import (QUEUED, RUNNING, PagePool,
                                           Request, SlotScheduler,
                                           TransferManifest)
from repro_torch.serving.telemetry import StageTelemetry
from repro_torch.tree import leaves


def pipelined_backend_available() -> bool:
    """Whether ``backend="pipelined"`` can run here. The reference's
    needs JAX's shard_map APIs; the port's pipelined backends run their
    stages in sequence on one device with nothing optional behind them,
    so on one card (or the CPU) the answer is always True."""
    return True


@dataclasses.dataclass
class EngineConfig:
    """The reference's ``EngineConfig`` (same names, same meanings), less
    the mesh's ``use_kernel`` (the card's kernels run whenever the tensors
    are on it)."""
    num_slots: int = 4                  # decode batch == KV slots
    num_stages: int = 2                 # pipeline stages the plan asks for
    num_microbatches: int = 2           # decode microbatches per step
    max_seq: int = 256                  # the timeline's horizon
    prompt_capacity: int = 32           # max admissible prompt length
    kv_layout: str = "paged"            # "paged" | "timeline"
    page_size: int = 16                 # tokens per KV page
    request_capacity: int = 0           # max prompt+max_new (0 = auto)
    num_pages: int = 0                  # pool size (0 = every slot at full
    #                                     request_capacity, + the null page)
    page_policy: str = "demand"         # "demand" | "reserve"
    preempt_policy: str = "auto"        # "auto" ("swap" paged,
    #                                     "recompute" on the timeline) |
    #                                     "swap" | "recompute"
    prefix_sharing: bool = True         # COW prefix index (demand only)
    decode_cow: bool = True             # freeze decode-filled pages too
    batched_prefill: bool = True        # whole-prompt prefill in one call
    #                                     (False: one decode step a token)
    seal_boundary: bool = True          # quantizing seal at stage boundaries
    solver: str = "dp"
    space: str = "segment"              # PlacementSpec search space
    plan_n: int = 10_000
    delta: float = LM_SIM_DELTA
    telemetry_interval: int = 8
    deviation_threshold: float = 1.5
    heartbeat_timeout_s: float = 10.0
    allow_swap: bool = True             # apply a re-plan's boundaries live
    temperature: float = 0.0            # 0 = greedy argmax
    top_k: int = 0                      # 0 = no top-k restriction
    sample_seed: int = 0                # PRNGKey of the sampler
    events_cap: int = 4096              # host-history ring-buffer caps
    finished_cap: int = 4096
    step_times_cap: int = 4096
    admission_cap: int = 4096
    prefill_pack: int = 0               # pack up to this many short prompts
    #                                     into one prefill call (0/1 = off)
    prefill_chunk: int = 0              # prompts longer than this prefill
    #                                     in chunks of this many tokens, one
    #                                     chunk per step (0 = one-shot)
    warmup: bool = False                # capture every serving shape as a
    #                                     CUDA graph at startup; steady
    #                                     state then captures nothing new
    #                                     (asserted via
    #                                     stats()["post_warmup_compiles"])
    warmup_layouts: int = 8             # swap-target stage layouts to prewarm
    # disaggregated prefill/decode (serving/disagg.py): "" = monolithic,
    # "prefill" = this engine seals and exports finished prefills
    # (export_transfer), "decode" = it ingests TransferManifests from a
    # prefill peer (ingest_transfer); either role needs demand paging
    disagg_role: str = ""
    # the chaos fault plane (serving/faults.py): a FaultConfig, or None to
    # serve fault-free. Injections surface in stats()["faults"], their
    # recovery in stats()["recovery"]
    faults: Optional[FaultConfig] = None


# The prefill role of a disaggregated pair seals under the decode role's key
# (0xC0FFEE). Its swap sequence numbers start at the middle of the swap
# space (still below sealing.TRANSFER_SEQ_BASE) and its stage-boundary
# keys at key + 2^31, so neither its swaps, nor its warmup's swap I/O and
# decode ticks, reuse a (key, counter) pair of the decode role's. On ranks
# its crossings, restages and exchanges draw from that upper half too
# (``sealing``, ``prefill=True``).
_PREFILL_SWAP_SEQ = sealing.PREFILL_SEQ_SHIFT
_PREFILL_KEY_SHIFT = 1 << 31


def block_profiles(profiles: Sequence[LayerProfile],
                   n: int) -> List[LayerProfile]:
    """The planner's per-layer profiles (``profiles_from_arch``, one per
    layer of the config) as ``n`` profiles, one per block of the served
    segment: the identity when every block is one layer; an xLSTM block
    is an (sLSTM, mLSTM) pair, two layers. A block adds its layers'
    FLOPs, parameter and activation bytes, and keeps its last layer's
    output bytes, similarity and efficiency (what leaves the block). The
    reference plans over layers, so its pipelined decoder cannot run
    xLSTM's six pairs (its stage sizes sum to 12); its local engine only
    records them."""
    k, rem = divmod(len(profiles), n)
    if rem:
        raise ValueError(f"{len(profiles)} layer profiles do not group "
                         f"into {n} blocks")
    if k == 1:
        return list(profiles)
    out = []
    for b in range(n):
        part = profiles[b * k:(b + 1) * k]
        last = part[-1]
        out.append(dataclasses.replace(
            last, name=f"block{b}", flops=sum(p.flops for p in part),
            params_bytes=sum(p.params_bytes for p in part),
            act_bytes=sum(p.traffic() for p in part)))
    return out


# ---------------------------------------------------------------------------
# Decode backends
# ---------------------------------------------------------------------------
class _Backend:
    """What every decode backend shares: host arrays onto the device, the
    managed decode step ``decode_step`` (``_decode`` on the backend's cache;
    one graph replay once warmed) and, on a backend whose stage boundaries
    are metadata, a ``swap`` that records them and a ``stage_times`` that
    measures nothing, so the engine attributes each step's wall time by the
    plan's predicted shares."""

    migrates_cache = False

    @property
    def body(self):
        """The cache body of the model's ``served_segment`` (``"blocks"``,
        or xLSTM's ``"pairs"``)."""
        return self.cache[self.api.model.served_segment.name]

    def _init_step(self) -> None:
        self._step = self.aot.wrap("decode_step", self._decode)

    def _idx(self, a) -> torch.Tensor:
        return to_device(a, self.device)

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return self._idx(np.asarray(tokens)[:, None])

    def _key_tensor(self, key) -> torch.Tensor:
        """A key or swap sequence number as a one-element int64 device
        tensor (a graph's input; an int is copied in)."""
        return key if isinstance(key, torch.Tensor) else self._idx([key])

    def step(self, tokens: np.ndarray, key) -> torch.Tensor:
        """One decode step; ``key`` (a one-element device tensor or an int)
        is the step's boundary key, which seals nothing on a local backend.
        The logits are a static output under a graph, read before the next
        managed call."""
        logits = self._step(self._tokens(tokens))
        self.steps += 1
        return logits

    def warm_probes(self) -> None:
        """Stage probes to warm: none, stage boundaries are metadata here."""

    def swap_layout(self):
        """The stage layout a swap payload is sealed under where each rank
        holds its own layers' columns (``serving/ranked.py``); None on one
        device, which seals whole rows."""
        return None

    def swap(self, stage_blocks: Sequence[int]) -> bool:
        self.stage_blocks = tuple(stage_blocks)
        return True

    def stage_times(self) -> Optional[List[float]]:
        return None                     # engine falls back to attribution


class LocalDecodeBackend(_Backend):
    """Single-device timeline backend (the reference's
    ``LocalDecodeBackend``): ``decode_fn`` over one shared-position cache,
    ``[L, num_slots, KVH, max_seq, D]`` (int8 with per-(head, channel)
    scales for a ``cache_quant`` model), whose ``len`` every row shares
    and whose per-slot ``start`` masks what a slot's row holds before its
    own prompt. The cache starts at ``len`` = ``prompt_capacity`` (so every
    admitted prompt ends at the timeline's tip) and is reset in place,
    never reallocated: a captured graph holds its addresses. ``insert_slot``
    copies a per-token-prefilled private cache into a slot's row through
    the managed ``insert`` (the slot index is a device tensor, so one graph
    serves every slot). Stage boundaries are metadata here."""

    def __init__(self, api, params, cfg: EngineConfig,
                 stage_blocks: Optional[Sequence[int]] = None,
                 aot: Optional[AotRegistry] = None):
        self.api, self.params, self.cfg = api, params, cfg
        self.device = api.device
        self.stage_blocks = tuple(stage_blocks
                                  or (api.model.served_segment.n,))
        self.steps = 0
        self.cache = api.init_cache(cfg.num_slots, cfg.max_seq)
        self.cache["start"] = torch.zeros(cfg.num_slots, dtype=torch.int32,
                                          device=self.device)
        self.reset_state()
        self.aot = aot or AotRegistry(capture=False)
        self._insert = self.aot.wrap("insert", self._insert_fn)
        self._init_step()

    def reset_state(self) -> None:
        """A fresh engine's timeline, in place: the body zeroed (the int8
        cache's scales and Hymba's conv and SSM state too, as the
        reference's ``init_cache`` makes them), ``len`` and every ``start``
        at ``prompt_capacity``."""
        for t in leaves(self.body):
            t.zero_()
        self.cache["len"].fill_(self.cfg.prompt_capacity)
        self.cache["start"].fill_(self.cfg.prompt_capacity)
        self.steps = 0

    def _decode(self, toks: torch.Tensor) -> torch.Tensor:
        return self.api.decode_fn(self.params, self.cache,
                                  {"tokens": toks})[0]

    def insert_slot(self, slot: int, private_cache: Dict[str, Any]) -> None:
        """Copy a one-row private cache (every leaf of the body [L, 1, ...],
        ``start`` [1]) into row ``slot``."""
        self._insert(private_cache[self.api.model.served_segment.name],
                     private_cache["start"], self._idx([slot]))

    def _insert_fn(self, body, start: torch.Tensor,
                   slot: torch.Tensor) -> None:
        """The reference's ``dynamic_update_slice`` along the batch dim of
        every leaf of the body tree: a leaf's update lands at ``min(slot,
        rows - n)`` for its n rows, so the int8 cache's scales ([L, KVH,
        D], no batch dim: the update spans the whole dim) are overwritten
        by the private cache's, as the reference's insert does, and
        Hymba's conv and SSM state (no time axis) are copied whole into the
        slot's row: a reused slot starts from its own prefill's state."""
        for g, u in zip(leaves(self.body), leaves(body)):
            n = u.shape[1]
            idx = torch.clamp(slot, max=g.shape[1] - n) + torch.arange(
                n, device=g.device)
            g.index_copy_(1, idx, u)
        self.cache["start"].index_copy_(0, slot, start)


class PagedLocalBackend(_Backend):
    """Single-device paged backend: ``decode_paged_fn`` over shared page
    pools + per-slot block tables / seq_lens, all on ``api.device``. The
    device state is updated in place, and never reallocated: a captured
    graph holds its addresses. Index vectors, keys and swap sequence
    numbers arrive from the host; the decode step, the prefill chunk and
    the swap I/O go through the engine's ``AotRegistry`` (``decode_step``,
    ``prefill_chunk``, ``gather_pages``, ``scatter_pages``: one graph
    replay each once warmed), with their drop-sentinel rows aimed at the
    null page on the device; the eager page-table maintenance drops
    sentinel rows on the host, as the reference's ``mode="drop"`` scatters
    drop them on the device. Stage boundaries are metadata here."""

    def __init__(self, api, params, cfg: EngineConfig, num_pages: int,
                 pages_per_slot: int,
                 stage_blocks: Optional[Sequence[int]] = None,
                 aot: Optional[AotRegistry] = None):
        self.api, self.params, self.cfg = api, params, cfg
        self.device = api.device
        self.num_pages = num_pages
        self.pages_per_slot = pages_per_slot
        self.stage_blocks = tuple(stage_blocks
                                  or (api.model.served_segment.n,))
        self._shape = (cfg.num_slots, num_pages, cfg.page_size,
                       pages_per_slot)
        self.steps = 0                  # decode steps run on this backend
        self.cache = self.api.init_paged_cache(*self._shape)
        self.aot = aot or AotRegistry(capture=False)
        self._chunk = self.aot.wrap("prefill_chunk", self._prefill_chunk)
        self._gather = self.aot.wrap("gather_pages", self._gather_fn)
        self._scatter = self.aot.wrap("scatter_pages", self._scatter_fn)
        self._init_step()

    def reset_state(self) -> None:
        """Zero the pools, block tables and seq_lens in place (the warmup
        reset): graphs captured over them stay valid."""
        for pool in self.body:
            pool.zero_()
        self.cache["block_tables"].zero_()
        self.cache["seq_lens"].zero_()
        self.steps = 0

    def _decode(self, toks: torch.Tensor) -> torch.Tensor:
        return self.api.decode_paged_fn(self.params, self.cache,
                                        {"tokens": toks})[0]

    def _prefill_chunk(self, toks, offset: int, chunk_len, bt_row, pages,
                       offs) -> torch.Tensor:
        return self.api.prefill_chunk_fn(
            self.params, {self.api.model.served_segment.name: self.body},
            {"tokens": toks, "offset": offset, "chunk_len": chunk_len,
             "bt_row": bt_row, "pages": pages, "offs": offs})[0]

    def prefill_chunk(self, toks: np.ndarray, offset: int, chunk_len: int,
                      bt_row: np.ndarray, pages: np.ndarray,
                      offs: np.ndarray) -> torch.Tensor:
        """One prefill chunk against the live pools (``prefill_chunk_fn``):
        block tables and seq_lens stay as they are, so the slot stays idle
        in the decode batch until ``commit_slot`` after its last chunk.
        ``pages``/``offs`` are the [C] write targets (the sentinel
        ``num_pages`` drops a row on the device). ``offset`` selects the
        graph. Returns the logits at the chunk's last valid token: a
        static output under a graph, read before the next managed call."""
        d = self._idx
        return self._chunk(d(toks), int(offset), d([chunk_len]), d(bt_row),
                           d(pages), d(offs))

    def warm_chunk(self, offset: int) -> None:
        """Warm the chunk at ``offset`` against an all-null block table with
        every write target on the drop sentinel: it reads only the null
        page and writes nothing but zeros there."""
        C, d = self.cfg.prefill_chunk, self._idx
        self._chunk.warm(d(np.zeros((1, C))), int(offset), d([C]),
                         d(np.zeros((1, self.pages_per_slot))),
                         d(np.full(C, self.num_pages)), d(np.zeros(C)))

    def _set_row(self, slot: int, bt_row: np.ndarray, seq_len: int) -> None:
        self.cache["block_tables"][slot] = to_device(bt_row, self.device,
                                                     np.int32)
        self.cache["seq_lens"][slot] = int(seq_len)

    def insert_slot(self, slot: int, kv, pages: np.ndarray, offs: np.ndarray,
                    bt_row: np.ndarray, seq_len: int) -> None:
        """kv: (kk, vv) [L, KVH, S_pad, D]; prompt position i lands in
        (pages[i], offs[i]) unless pages[i] is the sentinel (padding and
        COW-adopted shared pages are never written)."""
        kk, vv = kv
        keep = np.nonzero(np.asarray(pages) < self.num_pages)[0]
        pos, pg, off = (self._idx(keep), self._idx(pages[keep]),
                        self._idx(offs[keep]))
        k_pool, v_pool = self.body
        # advanced indices split by the head slice: [n, L, KVH, D]
        k_pool[:, pg, :, off] = kk[:, :, pos].permute(2, 0, 1, 3)
        v_pool[:, pg, :, off] = vv[:, :, pos].permute(2, 0, 1, 3)
        self._set_row(slot, bt_row, seq_len)

    def commit_slot(self, slot: int, bt_row: np.ndarray,
                    seq_len: int) -> None:
        self._set_row(slot, bt_row, seq_len)

    def clear_slot(self, slot: int) -> None:
        self.cache["block_tables"][slot] = 0
        self.cache["seq_lens"][slot] = 0

    def set_table_entry(self, slot: int, idx: int, page: int) -> None:
        self.cache["block_tables"][slot, idx] = int(page)

    def copy_page(self, dst: int, src: int) -> None:
        """Fork: clone one physical page across every layer."""
        for pool in self.body:
            pool[:, dst] = pool[:, src]

    def gather_pages(self, pages: np.ndarray, key: int, ctr: int):
        """Seal ``pages`` (fixed [pages_per_slot] vector; 0 = the null page,
        for shared and padding rows) out of the pools with the page cipher,
        under ``key`` and swap sequence number ``ctr``. Rows are laid out
        ``[MP, L*KVH*Pg*D]`` exactly as the reference lays them out, so a
        payload unseals under either package. Returns (k_cipher, v_cipher)
        on the device: static outputs under a graph, read before the next
        managed call."""
        return self._gather(self._idx(pages), self._key_tensor(key),
                            self._key_tensor(ctr))

    def _gather_fn(self, pg: torch.Tensor, key: torch.Tensor,
                   seq: torch.Tensor):
        out = []
        for part, pool in enumerate(self.body):
            rows = pool[:, pg].transpose(0, 1).reshape(pg.shape[0], -1)
            out.append(sealing.seal_pages(rows, key, seq, part=part))
        return tuple(out)

    def scatter_pages(self, ck: torch.Tensor, cv: torch.Tensor,
                      pages: np.ndarray, key: int, ctr: int) -> None:
        """Unseal payload rows (device cipher text, fixed [pages_per_slot]
        rows) under ``key`` and swap sequence number ``ctr`` and write row
        i into page ``pages[i]`` (sentinel ``num_pages`` = skip the row)."""
        self._scatter(ck, cv, self._idx(pages), self._key_tensor(key),
                      self._key_tensor(ctr))

    def _scatter_fn(self, ck: torch.Tensor, cv: torch.Tensor,
                    pages: torch.Tensor, key: torch.Tensor,
                    seq: torch.Tensor) -> None:
        """The scatter on the device, at a fixed shape: a sentinel row is
        aimed at the null page with zeros (as ``chunk_write_targets`` does
        for a chunk's writes), so nothing depends on how many rows land
        (no host sync; the call can be captured) and page 0 stays zero.
        Live rows name distinct fresh pages."""
        keep = pages < self.num_pages
        target = torch.where(keep, pages, torch.zeros_like(pages))
        for part, (pool, c) in enumerate(zip(self.body, (ck, cv))):
            rows = sealing.unseal_pages(c, key, seq, pool.dtype, part=part)
            g = rows.reshape(pages.shape[0], pool.shape[0], *pool.shape[2:])
            g = torch.where(keep.view(-1, *[1] * (g.dim() - 1)), g,
                            torch.zeros_like(g))
            pool[:, target] = g.transpose(0, 1)


class _Pipelined:
    """The pipelined decoder's half of a backend, for either KV layout: the
    planned stages run one after another on the card, microbatch by
    microbatch, and every stage boundary is sealed with the quantizing seal
    (``seal_boundary``) under the step's key, a one-element device tensor.
    The cache keeps the local backend's layout -- a stage is a range of
    layers -- so admission and a live boundary swap (``restage_cache``)
    move nothing.

    Each stage layout has its own managed step, ``step{layout}``, and
    per-stage probe, ``probe{layout}`` (one graph per stage: the stage
    index is a host int that selects the graph), the reference's
    per-layout entry points; a layout is built once and kept, so a swap
    back, or onto a layout the warmup toured, finds its graphs. The layout
    hooks: ``paged`` (which ``PipelinedDecoder.build`` to take),
    ``_step_cache()`` (what the step updates), ``_probe_arg()`` (the live
    state a probe reads, copied into its graph) and ``_run_probe``."""

    migrates_cache = True
    paged = True

    def _init_step(self) -> None:
        # layout -> (decoder, step, probe, the probe's timing events)
        self._layouts: Dict[Tuple[int, ...], Tuple[Any, ...]] = {}
        # the stage probes replay graphs on the card even on an engine
        # without warmup: an eager probe's events time the host's launch
        # pace, whose jitter reads as a straggler and re-plans. Its own
        # registry keeps them out of the engine's graph count
        self._probe_aot = self.aot if self.aot.capture else AotRegistry()
        self._build(self.stage_blocks)
        if self._probe_aot is not self.aot:
            self.warm_probes()

    def _build(self, stage_blocks: Sequence[int]) -> None:
        self.stage_blocks = key = tuple(stage_blocks)
        hit = self._layouts.get(key)
        if hit is None:
            cfg = self.cfg
            dec = PipelinedDecoder(self.api, num_stages=cfg.num_stages,
                                   num_microbatches=cfg.num_microbatches,
                                   seal_boundary=cfg.seal_boundary,
                                   stage_blocks=key)
            step_fn, probe = dec.build(paged=self.paged), \
                dec.build_stage_probe(paged=self.paged)

            def step(toks, step_key):
                return step_fn(self.params, self._step_cache(),
                               {"tokens": toks}, step_key)[0]

            # on the card, two timing events per stage around its layers,
            # recorded as nodes of the probe's graph once captured
            events = [tuple(torch.cuda.Event(enable_timing=True,
                                             external=True)
                            for _ in range(2))
                      for _ in range(cfg.num_stages)] \
                if self.device.type == "cuda" else None

            def run_probe(s: int, arg: torch.Tensor) -> torch.Tensor:
                if events:
                    events[s][0].record()
                x = torch.zeros((self._probe_rows, 1, self.api.cfg.d_model),
                                dtype=self.api.dtype, device=self.device)
                out = self._run_probe(probe, s, x, arg)
                if events:
                    events[s][1].record()
                return out

            hit = self._layouts[key] = (
                dec, self.aot.wrap(f"step{key}", step),
                self._probe_aot.wrap(f"probe{key}", run_probe), events)
        self.dec, self._step, self._probe, self._events = hit

    @property
    def _probe_rows(self) -> int:
        """Rows of one microbatch, the probe's batch."""
        return self.cfg.num_slots // self.cfg.num_microbatches

    def step(self, tokens: np.ndarray, key) -> torch.Tensor:
        """One pipelined decode step, its boundaries sealed under ``key``
        (a one-element device tensor, or an int copied in)."""
        logits = self._step(self._tokens(tokens), self._key_tensor(key))
        self.steps += 1
        return logits

    def swap(self, stage_blocks: Sequence[int]) -> bool:
        """Rebuild on the new boundaries; the cache is already valid there
        (``PipelinedDecoder.restage_cache``)."""
        old_dec = self.dec
        self._build(stage_blocks)
        self._restage(old_dec)
        return True

    def warm_probes(self) -> None:
        """Warm this layout's stage probes (state-neutral), so the telemetry
        ticks of the warmup's traffic time replays, not captures: their
        samples stay in the stage EMA after the warmup reset, as in the
        reference."""
        arg = self._probe_arg()
        for s in range(self.cfg.num_stages):
            self._probe.warm(s, arg)

    def stage_times(self) -> List[float]:
        """Seconds of each stage's layer range on one microbatch of the live
        state, by a probe that leaves the serving state as it found it
        (``_run_probe``). On the card it is a graph replay, warmed or not
        (an engine without warmup captures the planned layout's probes at
        construction and a new layout's at its first tick), and a stage's
        time is the device's, between two CUDA events the probe records
        around the stage's layers (nodes of its graph), waited for: a
        replay times the stage's kernels alone, where eagerly the device
        would follow the host's launches and time the host's pace (only a
        new layout's first tick on an engine without warmup runs so).
        Events around the call would also time the host's submission of
        one standalone replay, a fixed cost of the order of a one-layer
        stage's replay: the small stage would read as a straggler and
        re-plan. On the CPU it is the host clock. The decode step has run
        every kernel of the probe at its shapes already, so no untimed
        warm-up call precedes it. The probe runs exactly a stage's layers
        (the reference's pads a stage to the widest and scales its time by
        ``stage_counts[s] / bps``; here that factor is 1)."""
        arg = self._probe_arg()
        per_stage = []
        for s in range(self.cfg.num_stages):
            if self._events:
                self._probe(s, arg)
                start, end = self._events[s]
                end.synchronize()
                per_stage.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                self._probe(s, arg)
                per_stage.append(time.perf_counter() - t0)
        return per_stage


class PagedPipelinedBackend(_Pipelined, PagedLocalBackend):
    """The pipelined decoder over the shared page pools (``_Pipelined``).
    The pools keep the local backend's ``[L, N, KVH, Pg, D]`` layout, so
    admission, prefill chunks, forks and the sealed page swap are the local
    backend's (the reference stages a chunk's pools because its pools are
    staged; these are not), and a live boundary swap moves no pages: block
    tables, seq_lens and the host's refcounts ride along unchanged."""

    def _step_cache(self):
        return self.cache

    def _restage(self, old_dec: PipelinedDecoder) -> None:
        self.cache = old_dec.restage_cache(self.cache, self.dec)

    def _probe_arg(self) -> torch.Tensor:
        """Seq_lens of the first microbatch's rows: a view of the live
        cache, which a probe reads (copied into its graph's input)."""
        return self.cache["seq_lens"][:self._probe_rows]

    def _run_probe(self, probe, s: int, x: torch.Tensor,
                   sl: torch.Tensor) -> torch.Tensor:
        """Null block-table rows: every write dropped, every read the zero
        page (see ``PipelinedDecoder.build_stage_probe``)."""
        bt = torch.zeros((sl.shape[0], self.pages_per_slot),
                         dtype=torch.int32, device=sl.device)
        return probe(self.params, self.body, s, x, bt, sl)


class PipelinedDecodeBackend(_Pipelined, LocalDecodeBackend):
    """The pipelined decoder over the timeline cache (the reference's
    ``PipelinedDecodeBackend``, ``_Pipelined``): the step takes the staged
    triple ``(body, len, start)`` of the local backend's cache
    (``per_slot_start``), so admission (``insert_slot``) is the local
    backend's and a live boundary swap moves nothing. A stage probe runs
    on a scratch body of one microbatch's rows at the live ``len``: its
    writes land there and its attention spans the live horizon."""

    paged = False

    def _init_step(self) -> None:
        cfg = self.cfg
        self._probe_body = self.api.init_cache(
            self._probe_rows, cfg.max_seq)[self.api.model.served_segment.name]
        super()._init_step()

    def _step_cache(self):
        return self.body, self.cache["len"], self.cache["start"]

    def _restage(self, old_dec: PipelinedDecoder) -> None:
        body, n, start = old_dec.restage_cache(self._step_cache(), self.dec)
        self.cache.update({self.api.model.served_segment.name: body,
                           "len": n, "start": start})

    def _probe_arg(self) -> torch.Tensor:
        return self.cache["len"]

    def _run_probe(self, probe, s: int, x: torch.Tensor,
                   n: torch.Tensor) -> torch.Tensor:
        return probe(self.params, self._probe_body, s, x, n)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineEvent:
    step: int
    kind: str                  # admit | finish | preempt | fork | ...
    detail: Any = None


@dataclasses.dataclass
class _ChunkState:
    """Host state of one slot's in-flight chunked prefill: the full token
    sequence being streamed in, the pages acquired so far (the device block
    table stays unset until the final chunk commits), and the COW ledger —
    ``registered`` counts pages already frozen into the prefix index (a page
    is registered only once fully written, so another admission can never
    adopt a half-prefilled page)."""

    req: Request
    tokens: List[int]
    keys: List[tuple]                   # COW prefix keys, one per page
    t0: float                           # admission wall-clock start
    pos: int = 0                        # tokens prefilled so far
    chunks: int = 0
    pages: List[int] = dataclasses.field(default_factory=list)
    shared: List[bool] = dataclasses.field(default_factory=list)
    registered: int = 0
    logits: Any = None                  # last chunk's logits [1, V]


class ServingEngine:
    """Continuous-batching serving over a paged KV cache (or the legacy
    timeline, ``kv_layout``), planned over trust domains.

    The placement is a ``PlacementSpec`` (``self.spec``) from the segment-
    space solver over ``rm`` (two enclaves by default); its stage block
    counts (``self.stage_blocks``) drive the pipelined backend and are
    metadata on the local one. ``backend`` is ``"local"`` (the default, as
    the reference resolves it without a mesh) or ``"pipelined"``.
    ``device`` defaults to ``cuda`` and must be the model's device; pass
    ``device="cpu"`` (with a CPU model) for the plain-PyTorch path."""

    def __init__(self, api, config: Optional[EngineConfig] = None,
                 params=None,
                 device: Optional[Union[str, torch.device]] = None,
                 rm: Optional[ResourceManager] = None,
                 backend: Optional[str] = None, mesh=None):
        cfg = config or EngineConfig()
        self.device = resolve_device(device)
        if api.device != self.device:
            raise ValueError(f"engine device {self.device} but the model "
                             f"lives on {api.device}")
        if cfg.faults is not None and not isinstance(cfg.faults, FaultConfig):
            raise TypeError(f"EngineConfig.faults must be None or a "
                            f"FaultConfig, not {type(cfg.faults).__name__}")
        if not pipeline_applicable(api):
            raise ValueError(f"{api.cfg.name}: serving needs a single "
                             f"homogeneous segment")
        if api.cfg.pos_type == "mrope":
            # the reference's engine builds no pos3 and fails at the first
            # admission (attn_qkv: "mrope needs 3-component positions");
            # the port refuses at construction
            raise ValueError(f"{api.cfg.name}: serving a VLM (M-RoPE) needs "
                             f"3-component positions, which the engine "
                             f"does not build; run it through the model API "
                             f"or runtime.pipeline.PipelinedDecoder")
        if cfg.kv_layout not in ("paged", "timeline"):
            raise ValueError(f"kv_layout {cfg.kv_layout!r}: 'paged' or "
                             f"'timeline'")
        # a model without a paged cache (an int8 cache) keeps the timeline
        self.kv_layout = cfg.kv_layout if api.paged_ok else "timeline"
        if self.kv_layout == "timeline":
            if not cfg.prompt_capacity < cfg.max_seq:
                raise ValueError(f"prompt_capacity {cfg.prompt_capacity} "
                                 f"must be below max_seq {cfg.max_seq}")
            # features that need a page pool fail here, by name
            why = ("kv_layout='timeline' was requested" if api.paged_ok
                   else f"model '{api.cfg.name}' has no paged-cache support "
                        f"(sliding-window / quantized / recurrent cache)")
            if cfg.preempt_policy == "swap":
                raise ValueError(
                    f"preempt_policy='swap' requires the paged KV layout, "
                    f"but this engine runs the legacy timeline layout "
                    f"({why}): sealed page swap has no page pool to gather "
                    f"from. Use preempt_policy='auto' (resolves to "
                    f"'recompute' here) or 'recompute'.")
            if cfg.disagg_role:
                raise ValueError(
                    f"disagg_role='{cfg.disagg_role}' requires the paged KV "
                    f"layout, but this engine runs the legacy timeline "
                    f"layout ({why}): the prefill/decode handoff transfers "
                    f"sealed KV *pages* between page pools. Serve this "
                    f"model monolithically.")
        if cfg.num_slots % cfg.num_microbatches:
            raise ValueError(f"num_slots {cfg.num_slots} is not a multiple "
                             f"of num_microbatches {cfg.num_microbatches}")
        if cfg.page_policy not in ("demand", "reserve"):
            raise ValueError(f"page_policy {cfg.page_policy!r}")
        if cfg.preempt_policy not in ("auto", "swap", "recompute"):
            raise ValueError(f"preempt_policy {cfg.preempt_policy!r}")
        if cfg.disagg_role not in ("", "prefill", "decode"):
            raise ValueError(f"disagg_role {cfg.disagg_role!r}: '', "
                             f"'prefill' or 'decode'")
        if cfg.disagg_role and cfg.page_policy != "demand":
            raise ValueError(
                f"disagg_role={cfg.disagg_role!r} needs page_policy="
                f"'demand' (COW adoption and per-row allocation at "
                f"transfer-in), not {cfg.page_policy!r}")
        if cfg.prefill_chunk < 0 or cfg.prefill_pack < 0:
            raise ValueError(f"prefill_chunk {cfg.prefill_chunk} and "
                             f"prefill_pack {cfg.prefill_pack} must be >= 0")
        backend = backend or ("pipelined" if mesh is not None
                              and cfg.num_stages > 1 else "local")
        if backend not in ("local", "pipelined"):
            raise ValueError(f"backend {backend!r}: 'local' or 'pipelined'")
        # a mesh of ranks: stage s on the ranks of pod s (serving/ranked.py)
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.serving import ranked
            ranked.check_rank_mesh(mesh, cfg, backend, api)
        self.api, self.config = api, cfg
        self.rm = rm or two_enclave_manager()
        self.params = params if params is not None else api.init(
            torch.Generator(device=self.device).manual_seed(0))
        if mesh is not None:
            # the whole tree on the host; the backend cuts its stage's
            # layers onto the device, at construction and at every swap
            self.params = ranked.host_copy(self.params)
        paged = self.kv_layout == "paged"
        self.preempt_policy = cfg.preempt_policy \
            if cfg.preempt_policy != "auto" else \
            ("swap" if paged else "recompute")

        # --- plan over the trust domains ----------------------------------
        # min_stages: ask for a placement that uses every pipeline stage
        # (falls back when the topology cannot supply that many)
        self.profiles = block_profiles(
            profiles_from_arch(api.cfg, seq_len=1), api.model.served_segment.n)
        self.replanner = OnlineReplanner(
            self.rm, self.profiles, n=cfg.plan_n, delta=cfg.delta,
            deviation_threshold=cfg.deviation_threshold, solver=cfg.solver,
            space=cfg.space, min_stages=cfg.num_stages)
        try:
            spec = self.replanner.plan()
        except InfeasibleError:
            self.replanner.min_stages = None
            spec = self.replanner.plan()
        self.spec = spec
        self.stage_blocks = self._blocks_from(spec)
        if mesh is None:
            monitor = HeartbeatMonitor(self.rm,
                                       timeout_s=cfg.heartbeat_timeout_s)
        else:
            # global rank 0's verdict on every rank of the world
            monitor = ranked.AgreedMonitor(
                self.rm, timeout_s=cfg.heartbeat_timeout_s)
        self.telemetry = StageTelemetry(
            self.replanner,
            monitor=monitor,
            interval=cfg.telemetry_interval,
            step_times_cap=cfg.step_times_cap)

        self.slot_pages: Dict[int, List[int]] = {}
        # host mirror of each active slot's device seq_len (= the next
        # decode write position); drives demand growth / fork decisions
        self.slot_len: Dict[int, int] = {}
        self.pool: Optional[PagePool] = None
        if paged:
            self.request_capacity = cfg.request_capacity or \
                (cfg.prompt_capacity + 64)
            if self.request_capacity <= cfg.prompt_capacity:
                raise ValueError(
                    "request_capacity must exceed prompt_capacity")
            self.pages_per_slot = -(-self.request_capacity // cfg.page_size)
            num_pages = cfg.num_pages or \
                (cfg.num_slots * self.pages_per_slot + 1)
            self.pool = PagePool(num_pages, cfg.page_size)
        # the timeline's shared position: every admitted prompt ends here
        self.global_len = cfg.prompt_capacity
        self.preemptions = 0
        self.peak_running = 0
        # monotone swap sequence keys the cipher keystream: no (key,
        # counter) pair is ever reused across swap events
        prefill = cfg.disagg_role == "prefill"
        self._swap_seq = _PREFILL_SWAP_SEQ if prefill else 0
        self.swap_fallbacks = 0
        # disaggregated handoff: transfer sequence numbers key the cipher
        # in the dedicated transfer counter space (sealing.transfer_seq),
        # so handoff seals never collide with swap or activation seals
        self._transfer_seq = 0
        self.transfers_out = 0
        # the chaos fault plane and the recovery ladder: every injected
        # fault lands on a named rung of self.recovery, on a pending marker
        # (death, stall, storm) or in self.failed as an explicit
        # per-request failure. pending_external is set by an orchestrator
        # holding in-flight handoffs for this engine, so a head-of-line
        # stall while one is pending classifies as recoverable.
        self.faults = FaultPlane(cfg.faults) if cfg.faults is not None \
            else None
        self.recovery = self._fresh_recovery()
        self.failed: Dict[int, str] = {}
        self.pending_external = 0
        self._storm_pages: List[int] = []
        self._storm_left = 0
        self._death_pending = False
        self._stall_stage: Optional[int] = None
        self._in_warmup = False

        # every managed entry point (decode step, prefill chunk, one-shot
        # and packed prefill) is registered here, so warmup() can capture
        # the full shape inventory as CUDA graphs and stats() can report
        # post-warmup capture stalls
        self.aot = AotRegistry(capture=cfg.warmup)
        # uint32 key: swap pages seal under it, and the n-th decode tick
        # since construction seals its stage boundaries under key + n
        # (``_step_key``)
        self._key = 0xC0FFEE
        pipelined = backend == "pipelined"
        if mesh is not None:
            # a rank's slabs hold the most layers its stage takes over the
            # planned layout and the warmup's tour
            layouts = [self.stage_blocks] + self._swap_targets()
            self.backend = ranked.RankPagedBackend(
                api, self.params, cfg, num_pages, self.pages_per_slot,
                self.stage_blocks, self.aot, mesh, self._key, layouts) \
                if paged else ranked.RankTimelineBackend(
                    api, self.params, cfg, self.stage_blocks, self.aot,
                    mesh, self._key, layouts)
        elif paged:
            backend_cls = PagedPipelinedBackend if pipelined \
                else PagedLocalBackend
            self.backend = backend_cls(api, self.params, cfg, num_pages,
                                       self.pages_per_slot,
                                       self.stage_blocks, aot=self.aot)
        else:
            backend_cls = PipelinedDecodeBackend if pipelined \
                else LocalDecodeBackend
            self.backend = backend_cls(api, self.params, cfg,
                                       self.stage_blocks, aot=self.aot)
        # packed prefill: the paged layout's batched prefill only
        self._packing = (cfg.prefill_pack > 1 and paged
                         and cfg.batched_prefill)
        # per-token prefill (the timeline; batched_prefill=False): one
        # [1, 1] decode step a token over a static private cache per width
        # (on a rank engine, per stage layout too), reset in place at every
        # admission (``_token_cache``)
        self._token_caches: Dict[Any, Dict[str, Any]] = {}
        if mesh is not None:
            # a rank's prefill entry points: its layers between messages
            self._token_caches = self.backend.token_caches
            self._prefill_at = self.backend.entry("prefill_at")
            self._prefill_at_packed = self.backend.entry("prefill_packed")
            self._prefill_token = self.backend.entry("prefill_token")
        else:
            self._prefill_at = self.aot.wrap("prefill_at",
                                             self._prefill_at_fn)
            self._prefill_at_packed = self.aot.wrap("prefill_packed",
                                                    self._prefill_packed_fn)
            if not (paged and cfg.batched_prefill):
                self._prefill_token = self.aot.wrap("prefill_token",
                                                    self._prefill_token_fn)
        self.backend_kind = backend
        self.scheduler = SlotScheduler(cfg.num_slots,
                                       finished_cap=cfg.finished_cap)
        self.pending = np.zeros(cfg.num_slots, np.int32)  # next input token
        self.steps = 0
        self.swaps = 0
        self.stalled = False
        self.stall_reason: Optional[str] = None
        self._blocked_rid = None
        self.admission_ms: Deque[float] = deque(maxlen=cfg.admission_cap)
        self.admissions = 0
        self.prefill_calls = 0
        # packed prefill: K prompts share one bucketed call
        self.packed_admissions = 0
        self.packed_prefills = 0
        # chunked prefill: slot -> _ChunkState for every admitted request
        # whose prompt is still streaming in
        self.chunking: Dict[int, _ChunkState] = {}
        self.chunked_admissions = 0
        self.chunk_steps = 0
        self.decode_wall_s = 0.0
        self.events: Deque[EngineEvent] = deque(maxlen=cfg.events_cap)
        self._step_events: List[EngineEvent] = []
        # ticks not counted by self.steps (the prefill role of a pair
        # starts 2^31 ticks on)
        self._key_shift = _PREFILL_KEY_SHIFT if prefill else 0
        self.sampler = TokenSampler(cfg.temperature, cfg.top_k,
                                    cfg.sample_seed)
        # sampled decoding runs on the device under graph management (one
        # graph per batch shape once warmed); greedy keeps its argmax
        self._sample_fn = self.sampler.sample_device if self.sampler.greedy \
            else self.aot.wrap("sample", self.sampler.sample_device)
        self.warmup_s = 0.0
        self.warmed = False
        if cfg.warmup:
            self.warmup()

    def _blocks_from(self, spec: PlacementSpec) -> Tuple[int, ...]:
        planned = spec.stage_sizes()
        n, S = self.api.model.served_segment.n, self.config.num_stages
        if len(planned) == S:
            return planned
        assert n % S == 0, \
            f"plan wants {len(planned)} stages, {n} blocks not even over {S}"
        return (n // S,) * S

    def _step_key(self) -> torch.Tensor:
        """The uint32 key that seals the next decode tick's stage
        boundaries, as a one-element device tensor (a captured step reads it
        at every replay): ``key + n`` for the n-th tick since construction.
        On a cold engine n is ``self.steps``, the reference's ``key +
        steps`` (on the prefill role of a pair, 2^31 + ``self.steps``). Unlike the reference, n keeps running across the warmup
        reset and counts the warmup's neutral ticks, so serving never seals
        a boundary under a (key, counter) pair that warmup used."""
        n = self.steps + self._key_shift
        return to_device([(self._key + n) & 0xFFFFFFFF], self.device)

    def _sample(self, logits: torch.Tensor, rids: Sequence[int],
                idxs: Sequence[int]) -> np.ndarray:
        """Tokens [B] on the host for the rows of ``logits`` [B, V], row b
        keyed by request ``rids[b]`` at its token index ``idxs[b]``
        (``TokenSampler.sample`` through ``_sample_fn``, so a warmed engine
        replays its graph)."""
        return self.sampler.sample(logits, rids, idxs, self._sample_fn)

    def _sample_one(self, logits: torch.Tensor, rid: int, index: int) -> int:
        """An admission's first token from logits [1, V]."""
        return int(self._sample(logits[:1], [rid], [index])[0])

    def _agreed(self, value: float) -> float:
        """A host clock reading as the engine records it: its own on one
        device; rank 0's on every rank of a rank engine, whose host
        decisions (re-plans read the step's wall time) and events must
        agree."""
        if self.mesh is None:
            return value
        return self.backend.share_first([value])[0]

    def _ms_since(self, t0: float) -> float:
        return self._agreed((time.perf_counter() - t0) * 1e3)

    def _agreed_integrity(self, err: Optional[Exception], context: str,
                          check: str) -> Optional[Exception]:
        """A swap-in check's failure, or None. On a rank engine each rank
        checks its own part of the payload and the verdict is every
        rank's: one failing part fails the swap-in on every rank, with one
        message, so that every rank takes the same rung."""
        if self.mesh is None:
            return err
        oks = self.backend.verdicts(err is None)
        if all(oks):
            return None
        return sealing.SealIntegrityError(
            f"{context}: the {check} of the part on rank(s) "
            f"{[r for r, ok in enumerate(oks) if not ok]} failed")

    def _emit(self, kind: str, detail: Any = None) -> None:
        ev = EngineEvent(self.steps, kind, detail)
        self.events.append(ev)
        self._step_events.append(ev)

    # -- request API -------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
        if not 1 <= len(prompt) <= self.config.prompt_capacity:
            raise ValueError(f"prompt length {len(prompt)} outside [1, "
                             f"{self.config.prompt_capacity}]")
        if self.kv_layout != "paged":
            # the timeline's horizon gates at admission (_fits)
            return self.scheduler.submit(prompt, max_new_tokens, eos_id,
                                         step=self.steps)
        total = len(prompt) + max_new_tokens
        if total > self.request_capacity:
            raise ValueError(f"prompt+max_new {total} > request_capacity "
                             f"{self.request_capacity}")
        if self.config.page_policy == "demand":
            # progress guarantee: after preempting every other slot the
            # request must fit with one page of fork headroom
            worst = self.pool.pages_needed(total) + 1
            if worst > self.pool.num_pages - 1:
                raise ValueError(
                    f"request needs {worst} pages (with fork headroom) but "
                    f"the pool holds {self.pool.num_pages - 1}: demand "
                    f"paging cannot guarantee progress; grow num_pages")
        return self.scheduler.submit(prompt, max_new_tokens, eos_id,
                                     step=self.steps)

    # -- admission gating --------------------------------------------------
    def _fits(self, req: Request) -> bool:
        """Can ``req`` be admitted now? False means the head of the queue
        waits: for pages completions will free, or, on the timeline, for
        nothing that can come back (its worst case must end inside the
        horizon, so the engine back-pressures at admission instead of
        running past ``max_seq`` mid-decode)."""
        if self.kv_layout != "paged":
            return self.global_len + req.max_new_tokens <= \
                self.config.max_seq
        if self.config.page_policy == "demand":
            if self.pool.has_transfer(req.rid):
                # handoff admission: one fresh page per sealed manifest row
                # (+1 headroom); rows resolved against this pool's COW
                # index at ingest are pinned and re-adopt for free
                need, supply = self._transfer_budget(req)
            elif self.pool.has_swap(req.rid):
                need, supply = self._swap_budget(req)
            else:
                need, supply = self._page_budget(req)
            return supply >= need
        need = self.pool.pages_needed(len(req.prompt) + req.max_new_tokens)
        return self.pool.free_pages >= need

    def _prompt_tokens(self, req: Request) -> List[int]:
        """Prompt plus any tokens generated before a preemption (teacher
        forcing reproduces the interrupted decode state)."""
        return list(req.prompt) + [int(t) for t in req.generated]

    def _prompt_page_keys(self, tokens: Sequence[int]) -> List[tuple]:
        """COW prefix-index keys: page i is keyed by every token it and its
        predecessors hold."""
        Pg = self.config.page_size
        P = len(tokens)
        n = self.pool.pages_needed(P)
        return [tuple(tokens[:min((i + 1) * Pg, P)]) for i in range(n)]

    def _page_budget(self, req: Request) -> Tuple[int, int]:
        """``(need, supply)``: fresh prompt pages + one page of headroom vs
        free + evictable pages, not counting pages this request's own
        prefix keys are about to adopt. A chunked admission (a prompt
        longer than ``prefill_chunk``) gates on its first chunk's pages
        only: later chunks allocate page by page, preempting younger slots
        when the pool runs dry (the submit-time worst case still guarantees
        progress)."""
        tokens = self._prompt_tokens(req)
        keys = self._prompt_page_keys(tokens)
        C = self.config.prefill_chunk
        if C > 0 and len(tokens) > C:
            keys = keys[:self.pool.pages_needed(C)]
        if self.config.prefix_sharing:
            hit_pages = {self.pool.prefix_index[k] for k in keys
                         if k in self.pool.prefix_index}
            fresh = sum(1 for k in keys if k not in self.pool.prefix_index)
        else:
            hit_pages, fresh = set(), len(keys)
        supply = self.pool.free_pages + sum(
            1 for p in self.pool.prefix_index.values()
            if self.pool.refcount[p] == 1 and p not in hit_pages)
        return fresh + 1, supply

    def _swap_budget(self, req: Request) -> Tuple[int, int]:
        man = self.pool.manifest(req.rid)
        supply = self.pool.free_pages + self.pool.evictable_pages
        return man.sealed_pages + 1, supply

    def _transfer_budget(self, req: Request) -> Tuple[int, int]:
        """``_swap_budget`` for an ingested handoff: one fresh page per
        sealed row plus one page of headroom; shared (COW-resolved) rows
        are pinned and free."""
        man = self.pool.transfer_manifest[req.rid]
        supply = self.pool.free_pages + self.pool.evictable_pages
        return man.sealed_pages + 1, supply

    def _bucket(self, n: int) -> int:
        """Pad prompt lengths to power-of-two buckets (capped at
        prompt_capacity, or request_capacity for resumed prompts)."""
        b = 4
        while b < n:
            b *= 2
        cap = self.config.prompt_capacity
        if n > cap:
            cap = self.request_capacity
        return min(b, cap)

    # -- admission: prefill into a free slot -------------------------------
    def _prefill_slot(self, slot: int, req: Request) -> None:
        t0 = time.perf_counter()
        if self.kv_layout != "paged":
            logits = self._prefill_timeline(slot, req)
            self._admitted(slot, req, logits, t0, {
                "rid": req.rid, "slot": slot,
                "start": self.global_len - len(req.prompt)})
            return
        if self.pool.has_transfer(req.rid):
            # handoff: restore the peer-sealed pages in one scatter, no
            # prefill and no sample (the prefill role sampled the first
            # token). A payload that fails verification drops the manifest
            # and falls through to a teacher-forced re-prefill of prompt +
            # first token.
            if self._transfer_in(slot, req, t0):
                return
        elif self.pool.has_swap(req.rid) and self._swap_in(slot, req, t0):
            return
        C = self.config.prefill_chunk
        if C > 0 and len(self._prompt_tokens(req)) > C:
            self._begin_chunked(slot, req, t0)
            return
        logits, shared = self._prefill_paged(slot, req)
        detail = {"rid": req.rid, "slot": slot,
                  "pages": len(self.slot_pages[slot]), "shared": shared}
        if req.generated:
            detail["resumed_at"] = len(req.generated)
        self._admitted(slot, req, logits, t0, detail)

    def _admitted(self, slot: int, req: Request, logits: torch.Tensor,
                  t0: float, detail: Dict[str, Any]) -> None:
        """A prefilled admission's first token: sampled from ``logits``
        [1, V] (a resumed request continues its keystream at
        ``len(generated)``), the admission timed and its event emitted."""
        first = self._sample_one(logits, req.rid, len(req.generated))
        self.pending[slot] = first
        detail["ms"] = self._ms_since(t0)
        self.admission_ms.append(detail["ms"])
        self.admissions += 1
        self._emit("admit", detail)
        fin = self.scheduler.on_token(slot, first, step=self.steps)
        if fin is not None:
            self._on_finish(fin)

    def _acquire_pages(self, req: Request) -> Tuple[List[int], List[bool]]:
        """``reserve``: worst-case pages, all private. ``demand``: one page
        per prompt page, adopting prefix-index hits first (the incref pins
        them, so fresh allocations can never evict a page a later key of
        this same admission would have shared)."""
        tokens = self._prompt_tokens(req)
        if self.config.page_policy == "reserve":
            need = self.pool.pages_needed(len(req.prompt)
                                          + req.max_new_tokens)
            pages = self.pool.alloc(need)
            assert pages is not None, "gated by _fits"
            return pages, [False] * need
        keys = self._prompt_page_keys(tokens)
        pages: List[Optional[int]] = [None] * len(keys)
        shared = [False] * len(keys)
        if self.config.prefix_sharing:
            for i, key in enumerate(keys):
                pg = self.pool.lookup_prefix(key)
                if pg is not None:
                    pages[i], shared[i] = pg, True
        for i, key in enumerate(keys):
            if pages[i] is None:
                pg = self.pool.alloc_one()
                assert pg is not None, "gated by _fits"
                if self.config.prefix_sharing:
                    self.pool.register_prefix(key, pg)
                pages[i] = pg
        return pages, shared

    def _prefill_paged(self, slot: int, req: Request):
        """Acquire the slot's pages, prefill the whole prompt in one call
        (right-padded to a bucket) and write the first P positions into the
        slot's pages; positions in adopted shared pages and the padding go
        to the drop sentinel. Returns ``(logits, shared_page_count)``."""
        tokens = self._prompt_tokens(req)
        P = len(tokens)
        pages, shared = self._acquire_pages(req)
        self.slot_pages[slot] = pages
        self.slot_len[slot] = P
        bt_row = np.zeros(self.pages_per_slot, np.int32)
        bt_row[:len(pages)] = pages
        S_pad = self._bucket(P)
        if self.config.batched_prefill:
            toks = np.zeros((1, S_pad), np.int64)
            toks[0, :P] = tokens
            logits, (kk, vv) = self._prefill_at(
                to_device(toks, self.device), to_device([P], self.device))
            self.prefill_calls += 1
        else:
            # one decode step a token from an empty [1, S_pad] cache
            cache = self._token_cache(S_pad)
            logits = self._prefill_tokens(tokens, S_pad)
            kk, vv = cache[self.api.model.served_segment.name]
        kk, vv = kk[:, 0], vv[:, 0]                    # [L, KVH, S_pad, D]
        pages_vec, offs_vec = self._write_targets(0, P, S_pad, pages, shared)
        self.backend.insert_slot(slot, (kk, vv), pages_vec, offs_vec, bt_row,
                                 P)
        return logits, int(sum(shared))

    def _prefill_at_fn(self, toks: torch.Tensor, plen: torch.Tensor):
        """One-shot prefill, graph-managed per bucket: (logits [1, V],
        (k, v) [L, 1, KVH, S_pad, D]), static outputs under a graph that
        the caller consumes (insert, sample) before its next managed
        call."""
        logits, caches = self.api.prefill_at_fn(
            self.params, {"tokens": toks, "prompt_len": plen})
        return logits, caches[self.api.model.served_segment.name]

    def _prefill_packed_fn(self, toks: torch.Tensor, plens: torch.Tensor):
        """Packed prefill, graph-managed per bucket at width K (see
        ``_prefill_at_fn``)."""
        logits, caches = self.api.prefill_packed_fn(
            self.params, {"tokens": toks, "prompt_lens": plens})
        return logits, caches[self.api.model.served_segment.name]

    # -- per-token prefill (the timeline; batched_prefill=False) ------------
    def _prefill_timeline(self, slot: int, req: Request) -> torch.Tensor:
        """Legacy offset prefill: one decode step per prompt token on a
        private one-row cache, ending at the shared timeline's tip, with a
        per-slot ``start`` mask; the cache is then copied into the slot's
        row. Returns the last token's logits [1, V], cloned (the insert is
        a managed call, whose replay may reuse a graph output's memory)."""
        P = len(req.prompt)
        start = self.global_len - P          # prompt ends at the tip
        assert start >= 0
        cache = self._token_cache(self.config.max_seq, start)
        logits = self._prefill_tokens(req.prompt,
                                      self.config.max_seq).clone()
        self.backend.insert_slot(slot, cache)
        return logits

    def _token_cache(self, S: int, start: Optional[int] = None
                     ) -> Dict[str, Any]:
        """The static private ``[1, S]`` cache of ``prefill_token`` at width
        S, made once and reset in place: zeros (the int8 cache's scales
        too, as the reference's ``init_cache`` makes them), ``len`` =
        ``start`` (0 without one) and, on the timeline, ``start``."""
        key = S if self.mesh is None else (self.backend.stage_blocks, S)
        cache = self._token_caches.get(key)
        if cache is None:
            cache = self.api.init_cache(1, S)
            if self.mesh is not None:
                seg = self.api.model.served_segment.name
                cache[seg] = self.backend.own_layers(cache[seg])
            if self.kv_layout != "paged":
                cache["start"] = torch.zeros(1, dtype=torch.int32,
                                             device=self.device)
            self._token_caches[key] = cache
        for t in leaves(cache[self.api.model.served_segment.name]):
            t.zero_()
        cache["len"].fill_(start or 0)
        if "start" in cache:
            cache["start"].fill_(start or 0)
        return cache

    def _prefill_token_fn(self, tok: torch.Tensor, S: int) -> torch.Tensor:
        """One [1, 1] decode step on the private cache of width ``S`` (a
        host int: one graph per width), graph-managed: logits [1, V], a
        static output under a graph."""
        return self.api.decode_fn(self.params, self._token_caches[S],
                                  {"tokens": tok})[0]

    def _prefill_tokens(self, tokens: Sequence[int], S: int) -> torch.Tensor:
        """Feed ``tokens`` one at a time through ``prefill_token`` at width
        S (the tokens reach the device in one copy). Returns the last
        token's logits."""
        toks = to_device(np.asarray(tokens)[:, None], self.device)
        logits = None
        for i in range(len(tokens)):
            logits = self._prefill_token(toks[i:i + 1], S)
            self.prefill_calls += 1
        return logits

    def _write_targets(self, start: int, end: int, width: int,
                       pages: Sequence[int], shared: Sequence[bool]):
        """Where each of ``width`` prefilled positions ``start + i`` lands:
        (page, offset) for ``start + i < end``; positions past ``end``
        (right padding) and positions in adopted shared pages go to the
        drop sentinel ``num_pages`` (never page 0: the null page stays
        all-zero)."""
        Pg, N = self.config.page_size, self.pool.num_pages
        idx = np.arange(width)
        abs_pos = start + idx
        page_of = np.minimum(abs_pos, end - 1) // Pg
        skip = (abs_pos >= end) | np.asarray(shared, bool)[page_of]
        pages_vec = np.where(skip, N, np.asarray(pages, np.int64)[page_of])
        offs_vec = np.where(abs_pos < end, abs_pos % Pg, 0)
        return pages_vec, offs_vec

    # -- chunked prefill: stream a long prompt in over many steps ----------
    def _begin_chunked(self, slot: int, req: Request, t0: float) -> None:
        """Admit ``req`` into ``slot`` without prefilling: the prompt's KV
        streams in one chunk per engine step (``_advance_chunks``) between
        the batch's decode ticks. Until the final chunk commits the block
        table the device row stays idle (seq_len 0) and the request sits in
        the PREFILL state: it owns pages and can be preempted, but produces
        no tokens and takes no decode work."""
        tokens = self._prompt_tokens(req)
        cs = _ChunkState(req=req, tokens=tokens,
                         keys=self._prompt_page_keys(tokens), t0=t0)
        if self.config.page_policy == "reserve":
            need = self.pool.pages_needed(len(req.prompt)
                                          + req.max_new_tokens)
            pages = self.pool.alloc(need)
            assert pages is not None, "gated by _fits"
            cs.pages, cs.shared = pages, [False] * need
        self.slot_pages[slot] = cs.pages
        self.slot_len[slot] = 0
        self.chunking[slot] = cs
        self.scheduler.mark_prefill(slot)
        self._emit("chunk_admit",
                   {"rid": req.rid, "slot": slot, "prompt": len(tokens),
                    "chunk": self.config.prefill_chunk})

    def _advance_chunks(self) -> None:
        """One chunk of ONE in-flight prompt per engine step (oldest rid
        first), scheduled before the decode tick."""
        if not self.chunking:
            return
        slot = min(self.chunking, key=lambda s: self.chunking[s].req.rid)
        cs = self.chunking[slot]
        self._run_chunk(slot, cs)
        # _run_chunk may have preempted the slot mid-acquisition
        if slot in self.chunking and cs.pos == len(cs.tokens):
            self._finish_chunked(slot, cs)

    def _run_chunk(self, slot: int, cs: _ChunkState) -> None:
        cfg = self.config
        req = cs.req
        C, Pg = cfg.prefill_chunk, cfg.page_size
        P, pos = len(cs.tokens), cs.pos
        end = min(pos + C, P)
        if cfg.page_policy == "demand":
            # pages covering [0, end): COW index hits adopt the frozen page;
            # misses allocate, preempting the youngest slot when the pool
            # runs dry — possibly this one
            while len(cs.pages) * Pg < end:
                i = len(cs.pages)
                pg, sh = None, False
                if cfg.prefix_sharing:
                    pg = self.pool.lookup_prefix(cs.keys[i])
                    sh = pg is not None
                if pg is None:
                    pg = self._alloc_or_preempt(req)
                    if pg is None:
                        return          # req itself was preempted; requeued
                cs.pages.append(pg)     # slot_pages aliases this list
                cs.shared.append(sh)
        Cp = end - pos
        toks = np.zeros((1, C), np.int64)
        toks[0, :Cp] = cs.tokens[pos:end]
        pages_vec, offs_vec = self._write_targets(pos, end, C, cs.pages,
                                                  cs.shared)
        bt_row = np.zeros((1, self.pages_per_slot), np.int32)
        bt_row[0, :len(cs.pages)] = cs.pages
        # the logits are a graph's static output: only the last chunk's are
        # read, by _finish_chunked right after this call
        cs.logits = self.backend.prefill_chunk(toks, pos, Cp, bt_row,
                                               pages_vec, offs_vec)
        self.prefill_calls += 1
        self.chunk_steps += 1
        cs.pos, cs.chunks = end, cs.chunks + 1
        if cfg.page_policy == "demand" and cfg.prefix_sharing:
            # freeze pages into the COW index only once fully written: a
            # half-prefilled page must never be adoptable
            while cs.registered < len(cs.pages):
                i = cs.registered
                if cs.pos < min((i + 1) * Pg, P):
                    break
                if not cs.shared[i]:
                    self.pool.register_prefix(cs.keys[i], cs.pages[i])
                cs.registered += 1
        self._emit("chunk", {"rid": req.rid, "slot": slot, "pos": cs.pos,
                             "of": P})

    def _finish_chunked(self, slot: int, cs: _ChunkState) -> None:
        """Last chunk landed: commit the block table and seq_len (the row
        joins the decode batch), sample the first token from the final
        chunk's logits — the position one-shot prefill reads — and flip
        the request to RUNNING."""
        req = cs.req
        P = len(cs.tokens)
        bt_row = np.zeros(self.pages_per_slot, np.int32)
        bt_row[:len(cs.pages)] = cs.pages
        self.backend.commit_slot(slot, bt_row, P)
        self.slot_len[slot] = P
        del self.chunking[slot]
        self.scheduler.mark_running(slot)
        first = self._sample_one(cs.logits, req.rid, len(req.generated))
        self.pending[slot] = first
        ms = self._ms_since(cs.t0)
        self.admission_ms.append(ms)
        self.admissions += 1
        self.chunked_admissions += 1
        self._emit("admit", {"rid": req.rid, "slot": slot,
                             "pages": len(cs.pages),
                             "shared": int(sum(cs.shared)),
                             "chunks": cs.chunks, "ms": ms})
        fin = self.scheduler.on_token(slot, first, step=self.steps)
        if fin is not None:
            self._on_finish(fin)

    def _on_finish(self, fin: Request) -> None:
        self._emit("finish", {"rid": fin.rid, "by": fin.finished_by})
        if self.kv_layout == "paged" and fin.slot in self.slot_pages:
            self.pool.release(self.slot_pages.pop(fin.slot))
            self.slot_len.pop(fin.slot, None)
            self.backend.clear_slot(fin.slot)

    # -- demand paging: preemption + per-step growth/fork ------------------
    def _preempt(self, slot: int, req: Request) -> None:
        """Evict ``req`` to reclaim pages: sealed swap of its private pages
        (``"swap"``), or drop its KV for a teacher-forced re-prefill
        (``"recompute"``, and always for a victim still mid-chunked-
        prefill). Either way it goes to the front of the queue and its
        resumed stream is bit-identical."""
        if (self.preempt_policy == "swap"
                and self.config.page_policy == "demand"
                and req.status == RUNNING and slot not in self.chunking):
            self._preempt_swap(slot, req)
            return
        req.preemptions += 1
        self.preemptions += 1
        cs = self.chunking.pop(slot, None)
        self.pool.release(self.slot_pages.pop(slot))
        self.slot_len.pop(slot)
        self.backend.clear_slot(slot)
        self.scheduler.preempt(slot)
        self.pending[slot] = 0
        detail = {"rid": req.rid, "slot": slot,
                  "generated": len(req.generated)}
        if cs is not None:
            # mid-chunked-prefill eviction: the KV written so far goes with
            # the pages; re-admission restarts from token 0 (registered
            # prefix pages survive in the COW index and are adopted back)
            detail["mid_prefill"] = True
            detail["prefilled"] = cs.pos
        if self._storm_pages:
            self.recovery["storm_preemptions"] += 1
        self._emit("preempt", detail)

    def _preempt_swap(self, slot: int, req: Request) -> None:
        """Seal the slot's private pages (refcount 1) to host memory with
        the page cipher and record a swap manifest; COW-shared pages stay
        on the device, pinned by the manifest, and are re-adopted at
        swap-in. The gather takes a fixed [pages_per_slot] vector (0 = the
        null page for shared / padding rows)."""
        assert req.generated, "RUNNING victim must hold a sampled token"
        req.preemptions += 1
        self.preemptions += 1
        pages = self.slot_pages.pop(slot)
        n_tokens = self.slot_len.pop(slot)
        entries: List[Tuple[str, Any]] = []
        gather_vec = np.zeros(self.pages_per_slot, np.int32)
        for i, pg in enumerate(pages):
            if self.pool.refcount[pg] > 1:
                key = self.pool._page_key.get(pg)
                assert key is not None, \
                    f"shared page {pg} missing from the prefix index"
                entries.append(("shared", (key, pg)))
            else:
                entries.append(("sealed", i))
                gather_vec[i] = pg
        seq = self._swap_seq
        self._swap_seq += 1
        ck, cv = self.backend.gather_pages(gather_vec, self._key, seq)
        # the swap tier is host memory: device pages free as soon as
        # release() drops their last reference below
        payload = (sealing.cipher_to_host(ck), sealing.cipher_to_host(cv))
        self.pool.swap_out(req.rid, entries, payload, n_tokens, seq,
                           digest=sealing.payload_digest(payload),
                           layout=self.backend.swap_layout())
        self.pool.release(pages)
        self.backend.clear_slot(slot)
        self.scheduler.preempt(slot, swapped=True)
        self.pending[slot] = 0
        if self._storm_pages:
            self.recovery["storm_preemptions"] += 1
        self._emit("preempt", {
            "rid": req.rid, "slot": slot, "policy": "swap",
            "generated": len(req.generated),
            "sealed_pages": sum(1 for t, _ in entries if t == "sealed"),
            "shared_pages": sum(1 for t, _ in entries if t == "shared")})

    def _integrity_reject(self, req: Request, path: str, fresh: List[int],
                          e: Exception) -> bool:
        """The failure arm of swap-in and transfer-in (``path`` ``"swap"``
        or ``"transfer"``): return the freshly allocated pages (no block
        table references them), drop the tampered manifest and count the
        fallback; the caller re-prefills teacher-forced."""
        self.pool.release(fresh)
        if path == "swap":
            self.pool.drop_swap(req.rid)
        else:
            self.pool.drop_transfer(req.rid)
        self.recovery[f"unseal_fallback_{path}"] += 1
        self._emit("unseal_fallback", {"rid": req.rid, "path": path,
                                       "error": str(e)})
        return False

    def cipher_window(self, man):
        """The columns of a whole payload row that this rank's part of a
        swap or transfer manifest holds, under the layer ranges it was
        sealed with (the fault plane's tamper window); None on one
        device."""
        if man.layout is None:
            return None
        return self.backend.cipher_window(man.layout)

    def _swap_in(self, slot: int, req: Request, t0: float) -> bool:
        """Resume a swapped-out request: one fresh page per sealed row,
        unseal + scatter the host payload into them, re-adopt the pinned
        shared pages, rebuild the block table at the saved seq_len. No
        prefill and no new sample: ``generated[-1]`` was never written to
        KV and is the next decode input, as in the undisturbed run.
        Returns False (caller recomputes) when the payload fails its
        integrity tag; nothing is adopted before the digest matches. The
        fault plane's tamper site runs first: a truncated payload fails
        ``verify_structure`` and never reaches the scatter (a captured
        graph's static input has the full shape)."""
        man = self.pool.swap_manifest[req.rid]
        context = f"swap-in rid {req.rid}"
        if self.faults is not None and not self._in_warmup:
            tampered, mode = self.faults.maybe_tamper_swap(
                man.payload, self.cipher_window(man))
            if mode is not None:
                man.payload = tampered
                self._emit("fault_tamper", {"rid": req.rid, "path": "swap",
                                            "mode": mode})
        err = None
        try:
            sealing.verify_structure(man.payload, man.digest,
                                     context=context)
        except sealing.SealIntegrityError as e:
            err = e
        err = self._agreed_integrity(err, context, "structure")
        if err is not None:
            return self._integrity_reject(req, "swap", [], err)
        N = self.pool.num_pages
        pages: List[int] = []
        fresh: List[int] = []
        scatter_vec = np.full(self.pages_per_slot, N, np.int32)
        for i, (tag, val) in enumerate(man.entries):
            if tag == "shared":
                pages.append(val[1])
            else:
                pg = self.pool.alloc_one()
                assert pg is not None, "gated by _fits/_swap_budget"
                pages.append(pg)
                fresh.append(pg)
                scatter_vec[i] = pg
        ck, cv = (sealing.cipher_to_device(a, self.device)
                  for a in man.payload)
        # the host re-hash below overlaps the asynchronously launched
        # unseal + scatter; the block table commits only after it matches
        # a rank engine's part says which layers it holds (``swap_layout``)
        self.backend.scatter_pages(ck, cv, scatter_vec, self._key,
                                   man.counter, **({} if man.layout is None
                                                   else {"layout": man.layout}))
        err = None
        try:
            sealing.verify_payload(man.payload, man.digest, context=context)
        except sealing.SealIntegrityError as e:
            err = e
        err = self._agreed_integrity(err, context, "digest")
        if err is not None:
            return self._integrity_reject(req, "swap", fresh, err)
        man = self.pool.swap_in(req.rid)
        bt_row = np.zeros(self.pages_per_slot, np.int32)
        bt_row[:len(pages)] = pages
        self.backend.commit_slot(slot, bt_row, man.n_tokens)
        self.slot_pages[slot] = pages
        self.slot_len[slot] = man.n_tokens
        self.pending[slot] = req.generated[-1]
        ms = self._ms_since(t0)
        self.admission_ms.append(ms)
        self.admissions += 1
        self._emit("admit", {"rid": req.rid, "slot": slot,
                             "resumed": "swap", "pages": len(pages),
                             "restored": len(fresh),
                             "shared": len(pages) - len(fresh), "ms": ms})
        return True

    # -- disaggregated handoff: sealed cross-engine KV transfer ------------
    def export_transfer(self, slot: int) -> Tuple[Request, TransferManifest]:
        """Prefill-side handoff: seal EVERY page of ``slot`` (shared pages
        included -- the payload keeps all rows, so decode-side pin demotion
        is lossless) in one ``gather_pages`` call under a counter from the
        transfer sequence space, copy the payload to host memory, free this
        engine's pages and vacate the slot (HANDOFF state). Returns the
        request and the manifest the orchestrator ships to the decode
        engine. The first sampled token rides in ``req.generated`` and was
        never written to KV: it is the decode engine's first input, as the
        pre-preemption token is at swap-in."""
        assert self.config.page_policy == "demand"
        req = self.scheduler.slots[slot]
        assert req is not None and req.status == RUNNING and req.generated, \
            (slot, req)
        pages = self.slot_pages.pop(slot)
        n_tokens = self.slot_len.pop(slot)
        # content keys for the decode pool's COW resolution: the tokens
        # whose KV is written (generated[-1] is pending, unwritten)
        tokens = list(req.prompt) + [int(t) for t in req.generated[:-1]]
        assert len(tokens) == n_tokens, (len(tokens), n_tokens)
        keys = self._prompt_page_keys(tokens)
        gather_vec = np.zeros(self.pages_per_slot, np.int32)
        gather_vec[:len(pages)] = pages
        entries: List[Tuple[str, Any]] = [
            ("sealed", (i, keys[i] if i < len(keys) else None))
            for i in range(len(pages))]
        seq = sealing.transfer_seq(self._transfer_seq)
        self._transfer_seq += 1
        ck, cv = self.backend.gather_pages(gather_vec, self._key, seq)
        payload = (sealing.cipher_to_host(ck), sealing.cipher_to_host(cv))
        # on a rank engine this rank's part, sealed under these layer ranges
        man = TransferManifest(req.rid, n_tokens, entries, payload, seq,
                               sealing.payload_digest(payload),
                               self.backend.swap_layout())
        self.pool.release(pages)
        self.backend.clear_slot(slot)
        self.scheduler.handoff(slot, step=self.steps)
        self.pending[slot] = 0
        self.transfers_out += 1
        self._emit("handoff_out", {"rid": req.rid, "slot": slot,
                                   "pages": len(pages),
                                   "n_tokens": n_tokens})
        return req, man

    def ingest_transfer(self, req: Request, man: TransferManifest) -> None:
        """Decode-side handoff ingestion: resolve each keyed sealed row
        against THIS pool's COW prefix index (hits become pinned shared
        entries, whose payload rows scatter to the drop sentinel), park the
        manifest and adopt the request into the admission queue. ``_fits``
        then gates on the remaining sealed rows and ``_prefill_slot``
        routes to ``_transfer_in``."""
        assert self.config.page_policy == "demand"
        total = man.n_tokens + (req.max_new_tokens - len(req.generated)) + 1
        if total > self.request_capacity:
            raise ValueError(f"handoff rid {req.rid}: {total} tokens > "
                             f"decode request_capacity "
                             f"{self.request_capacity}")
        if self.pool.pages_needed(total) + 1 > self.pool.num_pages - 1:
            raise ValueError(f"handoff rid {req.rid} cannot fit the decode "
                             f"pool of {self.pool.num_pages - 1} pages")
        entries = list(man.entries)
        adopted = 0
        if self.config.prefix_sharing:
            for i, (tag, (_row, key)) in enumerate(entries):
                assert tag == "sealed", (i, tag)
                if key is None:
                    continue
                pg = self.pool.lookup_prefix(key)
                if pg is not None:      # the lookup pinned pg (manifest ref)
                    entries[i] = ("shared", (key, pg))
                    adopted += 1
        self.pool.register_transfer(req.rid, entries, man.payload,
                                    man.n_tokens, man.counter,
                                    digest=man.digest,
                                    # a manifest of one device may have no
                                    # such field (the reference's)
                                    layout=getattr(man, "layout", None))
        self.scheduler.adopt(req)
        self._emit("handoff_in", {"rid": req.rid,
                                  "sealed": len(entries) - adopted,
                                  "shared": adopted})

    def _transfer_in(self, slot: int, req: Request, t0: float) -> bool:
        """Admit an ingested handoff: one fresh page per sealed row, the
        peer's payload unsealed and scattered into them in ONE
        ``scatter_pages`` call (swap-in's graph: the counter is an input),
        COW-resolved shared pages adopted in place, the block table rebuilt
        at the transferred seq_len, and the freshly landed prompt pages
        registered in this pool's prefix index. No sample: the prefill
        role's first token (generated[-1]) is the next decode input, so the
        stream continues as the monolithic engine's.

        Verification is swap-in's: the structure first, then the scatter
        is launched, the host re-hashes the sealed bits while the card
        unseals, and the block table commits only after the digest
        matches. Returns False (the caller re-prefills prompt + first
        token) when the payload fails either check. On a rank engine each
        rank checks its own part and the verdicts are every rank's
        (``_agreed_integrity``), and the scatter takes the layer ranges the
        part was sealed under, as a swap-in's."""
        man = self.pool.transfer_manifest[req.rid]
        context = f"transfer-in rid {req.rid}"
        err = None
        try:
            sealing.verify_structure(man.payload, man.digest, context=context)
        except sealing.SealIntegrityError as e:
            err = e
        err = self._agreed_integrity(err, context, "structure")
        if err is not None:
            return self._integrity_reject(req, "transfer", [], err)
        N = self.pool.num_pages
        pages: List[int] = []
        fresh: List[int] = []
        fresh_keys: List[Tuple[tuple, int]] = []
        scatter_vec = np.full(self.pages_per_slot, N, np.int32)
        for tag, val in man.entries:
            if tag == "shared":
                pages.append(val[1])
                continue
            row, key = val
            pg = self.pool.alloc_one()
            assert pg is not None, "gated by _fits/_transfer_budget"
            pages.append(pg)
            fresh.append(pg)
            scatter_vec[row] = pg
            if key is not None:
                fresh_keys.append((key, pg))
        ck, cv = (sealing.cipher_to_device(a, self.device)
                  for a in man.payload)
        layout = {} if man.layout is None else {"layout": man.layout}
        self.backend.scatter_pages(ck, cv, scatter_vec, self._key,
                                   man.counter, **layout)
        err = None
        try:
            sealing.verify_payload(man.payload, man.digest, context=context)
        except sealing.SealIntegrityError as e:
            err = e
        err = self._agreed_integrity(err, context, "digest")
        if err is not None:
            return self._integrity_reject(req, "transfer", fresh, err)
        man = self.pool.transfer_in(req.rid)
        bt_row = np.zeros(self.pages_per_slot, np.int32)
        bt_row[:len(pages)] = pages
        self.backend.commit_slot(slot, bt_row, man.n_tokens)
        self.slot_pages[slot] = pages
        self.slot_len[slot] = man.n_tokens
        if self.config.prefix_sharing:
            for key, pg in fresh_keys:
                self.pool.register_prefix(key, pg)     # keeps an older hit
        self.pending[slot] = req.generated[-1]
        ms = self._ms_since(t0)
        self.admission_ms.append(ms)
        self.admissions += 1
        self._emit("admit", {"rid": req.rid, "slot": slot,
                             "resumed": "transfer", "pages": len(pages),
                             "restored": len(fresh),
                             "shared": len(pages) - len(fresh), "ms": ms})
        return True

    def _maybe_break_swap_deadlock(self, nxt: Request) -> bool:
        """With nothing active no completion will free pages; only swap-
        and transfer-manifest pins and the evictable prefix index hold
        them. First demote transfer pins (lossless: the handoff payload
        keeps every row), then drop swap manifests youngest-first (the
        head's own last) until the head fits; each dropped swap reverts to
        the recompute path. An injected storm's pages come back first: the
        storm is transient noise, manifests are requests' KV."""
        if self.kv_layout != "paged":
            return False
        if self.scheduler.active() or self.chunking:
            return False                # completions can still free pages
        if self._storm_pages:
            self._release_storm(reason="deadlock")
            self.recovery["storm_reclaims"] += 1
            if self._fits(nxt):
                return True
        if not (self.pool.swap_manifest or self.pool.transfer_manifest):
            return False
        for rid in sorted(self.pool.transfer_manifest):
            if self._fits(nxt):
                break
            if self.pool.demote_transfer(rid):
                self._emit("transfer_demote", {"rid": rid})
        while not self._fits(nxt) and self.pool.swap_manifest:
            others = sorted(r for r in self.pool.swap_manifest
                            if r != nxt.rid)
            rid = others[-1] if others else nxt.rid
            self.pool.drop_swap(rid)
            self.swap_fallbacks += 1
            for q in self.scheduler.queue:
                if q.rid == rid:
                    q.status = QUEUED
            self._emit("swap_fallback", {"rid": rid})
        return self._fits(nxt)

    def _alloc_or_preempt(self, requester: Request) -> Optional[int]:
        """One page for ``requester``, preempting the youngest active slot
        while the pool is dry. Returns None iff ``requester`` itself was
        preempted (it is requeued, not lost)."""
        while True:
            pg = self.pool.alloc_one()
            if pg is not None:
                return pg
            active = self.scheduler.active()
            assert active, "pool dry with no active slots"
            victim_slot, victim = max(active, key=lambda t: t[1].rid)
            self._preempt(victim_slot, victim)
            if victim is requester:
                return None

    def _grow_active(self) -> None:
        """Before each decode step, back every decoding slot's next write
        position with a private page: grow the table when the position
        enters a new page, fork the page first when it is shared. Oldest
        request first, so the youngest is preempted first. PREFILL slots
        are skipped: their chunks acquire their own pages."""
        if self.kv_layout != "paged" or self.config.page_policy != "demand":
            return
        Pg = self.config.page_size
        for slot, req in sorted(self.scheduler.decoding(),
                                key=lambda t: t[1].rid):
            if self.scheduler.slots[slot] is not req:
                continue                 # preempted earlier in this pass
            pages = self.slot_pages[slot]
            pi = self.slot_len[slot] // Pg
            if pi >= len(pages):
                pg = self._alloc_or_preempt(req)
                if pg is None:
                    continue
                pages.append(pg)
                assert len(pages) <= self.pages_per_slot
                self.backend.set_table_entry(slot, len(pages) - 1, pg)
            elif self.pool.refcount[pages[pi]] > 1:
                pg = self._alloc_or_preempt(req)
                if pg is None:
                    continue
                self.backend.copy_page(pg, pages[pi])
                self.pool.decref(pages[pi])
                old = pages[pi]
                pages[pi] = pg
                self.pool.forks += 1
                self.backend.set_table_entry(slot, pi, pg)
                self._emit("fork", {"rid": req.rid, "slot": slot,
                                    "from": old, "to": pg})

    def _admit(self) -> None:
        while True:
            nxt = self.scheduler.peek()
            if nxt is None:
                return
            if not self._fits(nxt):
                if self._maybe_break_swap_deadlock(nxt):
                    continue
                if self._blocked_rid != nxt.rid:
                    self._blocked_rid = nxt.rid
                    self._emit("backpressure", {
                        "rid": nxt.rid, "waiting_on":
                        "pages" if self.kv_layout == "paged" else "timeline"})
                return
            self._blocked_rid = None
            if self._packing and self._packable(nxt):
                self._admit_packed()
                continue
            hit = self.scheduler.admit_next(step=self.steps)
            assert hit is not None
            self._prefill_slot(*hit)

    # -- packed prefill: several short prompts in one call -----------------
    def _packable(self, req: Request) -> bool:
        """Can ``req`` join a packed prefill group? One-shot admissions
        only: swap resumes and handoff ingests restore KV instead of
        prefilling, and chunked prompts stream over steps."""
        if self.pool.has_swap(req.rid) or self.pool.has_transfer(req.rid):
            return False
        C = self.config.prefill_chunk
        return not (C > 0 and len(self._prompt_tokens(req)) > C)

    def _admit_packed(self) -> None:
        """Greedily admit up to ``prefill_pack`` packable queued requests,
        acquiring each one's pages as it joins (so the next mate's ``_fits``
        sees the pool its own allocation will find), then prefill the group
        in one bucketed call."""
        t0 = time.perf_counter()
        group = []
        while len(group) < self.config.prefill_pack:
            nxt = self.scheduler.peek()
            if nxt is None or not self._packable(nxt) \
                    or not self._fits(nxt):
                break
            slot, req = self.scheduler.admit_next(step=self.steps)
            tokens = self._prompt_tokens(req)
            pages, shared = self._acquire_pages(req)
            self.slot_pages[slot] = pages
            self.slot_len[slot] = len(tokens)
            group.append((slot, req, tokens, pages, shared))
        assert group, "caller verified the head fits and is packable"
        self._prefill_packed(group, t0)

    def _prefill_packed(self, group, t0: float) -> None:
        """One bucketed prefill over the group: tokens padded to
        [K, S_pad] (K = prefill_pack always — dummy rows of length 1 keep
        one shape per bucket, as the reference compiles one), logits read
        per row at each prompt's own last position, KV written per slot
        with the one-shot admission's drop-sentinel rule. Rows are
        independent, so each row's stream is its solo admission's."""
        K = self.config.prefill_pack
        S_pad = self._bucket(max(len(t) for _, _, t, _, _ in group))
        toks = np.zeros((K, S_pad), np.int64)
        plens = np.ones(K, np.int64)    # dummy rows read position 0
        for b, (_, _, tokens, _, _) in enumerate(group):
            toks[b, :len(tokens)] = tokens
            plens[b] = len(tokens)
        # static outputs under a graph: every row is inserted and sampled
        # below, before the next managed call
        logits, (kk_all, vv_all) = self._prefill_at_packed(
            to_device(toks, self.device),
            to_device(plens, self.device))    # kv [L, K, KVH, S_pad, D]
        self.prefill_calls += 1
        self.packed_prefills += 1
        for b, (slot, req, tokens, pages, shared) in enumerate(group):
            P = len(tokens)
            bt_row = np.zeros(self.pages_per_slot, np.int32)
            bt_row[:len(pages)] = pages
            pages_vec, offs_vec = self._write_targets(0, P, S_pad, pages,
                                                      shared)
            self.backend.insert_slot(slot, (kk_all[:, b], vv_all[:, b]),
                                     pages_vec, offs_vec, bt_row, P)
            first = self._sample_one(logits[b:b + 1], req.rid,
                                     len(req.generated))
            self.pending[slot] = first
            ms = self._ms_since(t0)
            self.admission_ms.append(ms)
            self.admissions += 1
            self.packed_admissions += 1
            detail = {"rid": req.rid, "slot": slot, "pages": len(pages),
                      "shared": int(sum(shared)), "packed": len(group),
                      "ms": ms}
            if req.generated:
                detail["resumed_at"] = len(req.generated)
            self._emit("admit", detail)
            fin = self.scheduler.on_token(slot, first, step=self.steps)
            if fin is not None:
                self._on_finish(fin)

    # -- one decode step ---------------------------------------------------
    def step(self) -> List[EngineEvent]:
        self._step_events = []
        self._fault_storm_tick()
        self._admit()
        # chunked prefill: at most one prompt chunk per engine step, ahead
        # of the decode tick, so batch-mates keep emitting tokens while a
        # long prompt fills in
        self._advance_chunks()
        self._grow_active()
        active = self.scheduler.decoding()
        if not active:
            if self.chunking:
                # chunk-only step: prefill progressed, nothing decodes yet
                self.steps += 1
                self.stalled = False
                self.stall_reason = None
                return self._step_events
            # head-of-line blocked with nothing running: permanent unless a
            # manifest still pins pages the breaker can release, a storm
            # holds pages it will hand back, or an orchestrator still holds
            # handoffs in flight for this engine
            recoverable = self._stall_recoverable()
            self.stalled = bool(self.scheduler.queue) and not recoverable
            self.stall_reason = None if not self.scheduler.queue else \
                ("recoverable" if recoverable else "permanent")
            return self._step_events
        self.stalled = False
        self.stall_reason = None
        self.peak_running = max(self.peak_running, len(active))
        if self.kv_layout != "paged":
            # unreachable: _fits() admits only requests whose worst case
            # ends inside the horizon
            assert self.global_len < self.config.max_seq - 1, \
                "timeline horizon violated despite admission gating"
        rids = np.zeros(self.config.num_slots, np.int64)
        idxs = np.zeros(self.config.num_slots, np.int64)
        for slot, req in active:
            rids[slot] = req.rid
            idxs[slot] = len(req.generated)
        t0 = time.perf_counter()
        logits = self.backend.step(self.pending, self._step_key())
        toks = self._sample(logits, rids, idxs)    # waits for the step
        wall = self._agreed(time.perf_counter() - t0)
        self.decode_wall_s += wall
        self.steps += 1
        self.global_len += 1
        for slot, req in active:
            self.pending[slot] = toks[slot]
            if self.kv_layout == "paged":
                self.slot_len[slot] += 1   # this step's KV write landed
                self._maybe_register_decode_page(slot, req)
            fin = self.scheduler.on_token(slot, int(toks[slot]),
                                          step=self.steps)
            if fin is not None:
                self._on_finish(fin)
        self._telemetry_tick(wall)
        return self._step_events

    def _stall_recoverable(self) -> bool:
        """A head-of-line stall is recoverable while something pending can
        still free the blocking pages or deliver the blocked request:
        manifests the deadlock breaker can demote or drop, an injected
        storm (its pages come back), or handoffs an orchestrator holds in
        flight."""
        return self.pending_external > 0 or bool(self._storm_pages) or (
            self.pool is not None and bool(self.pool.swap_manifest
                                           or self.pool.transfer_manifest))

    # -- chaos fault plane: injection ticks + recovery ladder --------------
    @staticmethod
    def _fresh_recovery() -> Dict[str, int]:
        """The reference's named rungs of the recovery ladder
        (``stats()["recovery"]``): every injected fault is accounted to one
        of these or to a pending marker."""
        return {
            # sealed-payload integrity failure -> recompute fallback
            "unseal_fallback_swap": 0,
            "unseal_fallback_transfer": 0,
            # device loss: active slots spilled through the page cipher,
            # then the placement re-solved around the corpse
            "device_loss_spills": 0,
            "device_loss_replans": 0,
            # injected straggler absorbed by a telemetry-driven re-plan
            "stall_replans": 0,
            # pool-exhaustion storm: slots preempted under storm pressure,
            # seized pages handed back (timer or deadlock breaker)
            "storm_preemptions": 0,
            "storm_reclaims": 0,
            # bumped by DisaggOrchestrator on the decode engine: re-sends
            # after drops, late deliveries, demotions to re-prefill
            "handoff_retries": 0,
            "handoff_redeliveries": 0,
            "handoff_reprefills": 0,
        }

    def _release_storm(self, reason: str) -> None:
        if not self._storm_pages:
            return
        self._emit("storm_release", {"pages": len(self._storm_pages),
                                     "reason": reason})
        self.pool.release(self._storm_pages)
        self._storm_pages = []
        self._storm_left = 0

    def _fault_storm_tick(self) -> None:
        """The storm site, drawn once per step: seize a share of the free
        list for a few steps (growth and admission then go through the
        preemption machinery), then hand it back. The deadlock breaker may
        reclaim it early: a storm costs latency, never a request. The
        timeline has no pool to storm."""
        if self.faults is None or self._in_warmup \
                or self.kv_layout != "paged":
            return
        if self._storm_pages:
            self._storm_left -= 1
            if self._storm_left <= 0:
                self._release_storm(reason="timer")
                self.recovery["storm_reclaims"] += 1
            return
        n = self.faults.storm_pages(self.pool.free_pages)
        if n:
            pages = self.pool.alloc(n)
            assert pages is not None, "storm sized from the free list"
            self._storm_pages = pages
            self._storm_left = self.faults.config.storm_steps
            self._emit("fault_storm", {"pages": n,
                                       "steps": self._storm_left})

    def _fault_telemetry_tick(self) -> None:
        """The stall and device-death sites, drawn once per telemetry
        interval, after ``record_stage_times`` (whose heartbeat pass marks
        every staged domain healthy: a death injected earlier would be
        resurrected) and before ``maybe_observe``, so the replanner's next
        observation sees the fault as a real heartbeat loss or straggler
        would surface."""
        if self._stall_stage is None:   # one outstanding straggler at a time
            hit = self.faults.pick_stage_stall(self.config.num_stages)
            if hit is not None:
                stage, factor = hit
                self.telemetry.inject(stage, factor)
                self._stall_stage = stage
                self._emit("fault_stall", {"stage": stage, "factor": factor})
        cur = self.replanner.current
        healthy = {d.name for d in self.rm.healthy_domains()}
        used = sorted({s.device for s in cur.placement.stages
                       if s.device in healthy}) if cur is not None else []
        # never the last healthy domain
        candidates = used if len(healthy) > 1 else []
        victim = self.faults.pick_device_death(candidates)
        if victim is not None:
            self._recover_device_loss(victim)

    def _recover_device_loss(self, victim: str) -> None:
        """Rung 1 of the device-loss ladder: mark the domain dead and spill
        every active slot off the device tier before the replanner restages
        (swap-policy slots seal their private pages to host manifests
        through the page cipher; recompute-policy and mid-prefill slots
        requeue for a teacher-forced re-prefill). Rung 2 is this step's
        ``maybe_observe``: ``replan_on_failure`` excludes the corpse. Rung
        3 is ordinary admission resuming every victim bit-identically. On
        one card both domains are the same device: the plane marks a
        planner domain unhealthy, and the spill and re-plan run for real.
        A timeline engine spills nothing (there is no page pool), as the
        reference's does not: its slots decode on through the re-plan."""
        self._emit("fault_device_death", {"device": victim})
        self.rm.mark_unhealthy(victim)
        self._death_pending = True
        if self.kv_layout == "paged" \
                and self.config.page_policy == "demand":
            for slot, req in sorted(self.scheduler.active(),
                                    key=lambda t: t[1].rid, reverse=True):
                if self.scheduler.slots[slot] is not req:
                    continue            # already evicted by a cascade
                self._preempt(slot, req)
                self.recovery["device_loss_spills"] += 1

    def _telemetry_tick(self, wall: float) -> None:
        """Telemetry -> maybe re-plan -> maybe swap boundaries live. A
        backend without stage probes has its step wall time attributed by
        the plan's predicted shares, so only injected deviation registers."""
        self.telemetry.record_step(wall)
        if self.steps % self.telemetry.interval == 0:
            times = self.backend.stage_times()
            if times is None:
                times = [wall * s for s in self.telemetry.predicted_shares()]
            if times:
                self.telemetry.record_stage_times(times)
            if self.faults is not None and not self._in_warmup:
                self._fault_telemetry_tick()
        new_spec = self.telemetry.maybe_observe(self.steps)
        if new_spec is None:
            return
        if self._death_pending:
            self.recovery["device_loss_replans"] += 1
            self._death_pending = False
        if self._stall_stage is not None:
            # the re-plan absorbed the injected straggler: clear its factor
            # so the new placement measures clean
            self.telemetry.inject(self._stall_stage, 1.0)
            self._stall_stage = None
            self.recovery["stall_replans"] += 1
        self._emit("replan", {"blocks": new_spec.stage_sizes(),
                              "placement": new_spec.describe()})
        if self.config.allow_swap:
            self.try_swap(new_spec.stage_sizes())
        # adopt the spec only once the executing layout matches it (swap
        # applied, or sizes unchanged and only devices moved)
        if new_spec.stage_sizes() == self.stage_blocks:
            self.spec = new_spec

    # -- live boundary swap --------------------------------------------------
    def try_swap(self, blocks: Sequence[int]) -> bool:
        blocks = tuple(blocks)
        if blocks == self.stage_blocks:
            return False
        if len(blocks) != self.config.num_stages or \
                sum(blocks) != self.api.model.served_segment.n:
            self._emit("swap_skipped", {"blocks": blocks})
            return False
        migrated = self.backend.swap(blocks)
        self._emit("swap", {"from": self.stage_blocks, "to": blocks,
                            "migrated": migrated and
                            self.backend.migrates_cache})
        self.stage_blocks = blocks
        self.swaps += 1
        return True

    def _maybe_register_decode_page(self, slot: int, req: Request) -> None:
        """``decode_cow``: when this step's write filled a page, freeze it
        into the prefix index under its content key (prompt + generated
        tokens whose KV it and its predecessors hold)."""
        cfg = self.config
        if not (cfg.decode_cow and cfg.prefix_sharing
                and cfg.page_policy == "demand"):
            return
        Pg = cfg.page_size
        sl = self.slot_len[slot]
        if sl % Pg:
            return
        pi = sl // Pg - 1
        pages = self.slot_pages[slot]
        if pi >= len(pages):
            return
        pg = pages[pi]
        if self.pool.refcount[pg] != 1 or pg in self.pool._page_key:
            return
        key = tuple(req.prompt) + tuple(int(t) for t in req.generated)
        assert len(key) == sl, (len(key), sl)
        if key in self.pool.prefix_index:
            return
        self.pool.register_prefix(key, pg)

    # -- warmup: capture the serving shape inventory as CUDA graphs --------
    def warmup(self) -> float:
        """Capture every shape the steady-state loop dispatches, then freeze
        the registry: a capture after this point is a stall, counted by
        ``stats()["post_warmup_compiles"]`` and named in
        ``stats()["compile_stalls"]``. The reference's passes:

        0. *probes* -- the planned layout's stage probes (pipelined
           backend), so the traffic's telemetry ticks time replays;
        1. *traffic* -- synthetic requests through the real submit/step
           path (a prompt per bucket, a COW twin pair, one long chunked
           prompt), so the calls serving makes are the ones captured;
        2. *direct* -- every bucket through one-shot and packed prefill (at
           the fixed width K), every chunk offset, the swap I/O, a decode
           tick on idle slots and the stage probes, all state-neutral;
        3. *layouts* -- on the pipelined backend with ``allow_swap``, a tour
           of up to ``warmup_layouts`` other stage layouts
           (``_swap_targets``), so a live re-plan swaps onto captured
           steps, probes and swap I/O;
        4. *reset* -- the serving state back to a fresh engine's (the
           device cache zeroed in place), so warmed and cold engines give
           the same streams. The swap sequence and the boundary key's step
           count keep running (``_reset_state``).

        On the CPU the same passes run eagerly and keep the signature
        ledger. Meaningful only on a fresh engine, asserted below."""
        assert self.steps == 0 and not self.scheduler.has_work() \
            and not self.chunking, "warmup() must run on a fresh engine"
        t0 = time.perf_counter()
        self._in_warmup = True          # the fault plane draws nothing
        try:
            self.backend.warm_probes()
            self._warm_traffic()
            self._warm_direct()
            if self.backend_kind == "pipelined" and self.config.allow_swap:
                self._warm_layouts()
        finally:
            self._in_warmup = False
        self._reset_state()
        self.aot.freeze()
        self.warmed = True
        self.warmup_s = time.perf_counter() - t0
        return self.warmup_s

    def _bucket_inventory(self) -> List[int]:
        """Every prefill bucket ``_bucket()`` can emit: powers of two up to
        prompt_capacity, plus the resumed-prompt sizes up to
        request_capacity; none on the timeline."""
        if self.kv_layout != "paged":
            return []
        return sorted({self._bucket(n)
                       for n in range(1, self.request_capacity + 1)})

    def _warm_traffic(self) -> None:
        """Synthetic requests through the real serve path, with the
        reference's deterministic token content (so COW twin adoption and
        the fork on divergence happen). The timeline's shapes do not depend
        on a prompt's length ([1, 1] token prefill over a fixed-horizon
        cache): one short request covers them."""
        cfg = self.config
        V = self.api.cfg.vocab_size

        def toks(n: int, salt: int) -> List[int]:
            return [int((cfg.sample_seed * 7919 + salt * 31 + j) % V)
                    for j in range(n)]

        if self.kv_layout != "paged":
            self.submit(toks(2, 7),
                        max(1, min(2, cfg.max_seq - self.global_len)))
        else:
            prompts = [toks(b, i) for i, b in enumerate(
                x for x in self._bucket_inventory()
                if x <= cfg.prompt_capacity)]
            # identical twins spanning a partial tail page: COW adoption at
            # the second admission, then a fork when decode first writes
            # the tail
            twin = toks(min(cfg.page_size + 2, cfg.prompt_capacity), 101)
            prompts += [twin, list(twin)]
            if cfg.prefill_chunk and cfg.prompt_capacity > cfg.prefill_chunk:
                prompts.append(toks(cfg.prompt_capacity, 202))
            for p in prompts:
                mn = max(1, min(2, self.request_capacity - len(p)))
                if self.pool.pages_needed(len(p) + mn) + 1 > \
                        self.pool.num_pages - 1:
                    continue            # unadmittable in real serve too
                self.submit(p, mn)
        guard = 0
        while self.scheduler.has_work():
            self.step()
            assert not self.stalled, "warmup traffic stalled"
            guard += 1
            assert guard < 10_000, "warmup traffic failed to drain"

    def _warm_direct(self) -> None:
        """State-neutral warm of every managed entry point the traffic may
        have missed: the prefills (``_warm_prefills``), the swap I/O, a
        decode tick on idle slots and the stage probes. Runs after the
        traffic drained, so every slot is clear. On the timeline a decode
        tick advances the shared position, so it runs only if the traffic
        took none (the warmup reset follows)."""
        if self.kv_layout != "paged":
            if self.steps == 0:
                self._warm_step_neutral()
            self._warm_sampler()
            self.backend.stage_times()
            return
        self._warm_prefills()
        self._warm_swap_io()
        self._warm_step_neutral()
        self._warm_sampler()
        self.backend.stage_times()

    def _warm_prefills(self) -> None:
        """One-shot and packed prefill (pure functions) at every bucket, the
        chunk at every offset below request_capacity against the null
        page, per-token prefill at every bucket on its private cache. On a
        rank engine each is this stage layout's own (its layers), and the
        timeline's per-token prefill and slot insert are warmed here too:
        on one card the traffic's admission covers them for every
        layout."""
        dev = self.device
        if self.kv_layout != "paged":
            if self.mesh is not None:
                S = self.config.max_seq
                cache = self._token_cache(S, self.global_len - 1)
                self._prefill_token.warm(to_device(np.zeros((1, 1)), dev), S)
                self.backend.warm_insert(cache)
            return
        for b in self._bucket_inventory():
            if self.config.batched_prefill:
                self._prefill_at.warm(to_device(np.zeros((1, b)), dev),
                                      to_device([b], dev))
            else:
                self._token_cache(b)
                self._prefill_token.warm(to_device(np.zeros((1, 1)), dev), b)
        K = self.config.prefill_pack
        if self._packing:
            for b in self._bucket_inventory():
                self._prefill_at_packed.warm(to_device(np.zeros((K, b)), dev),
                                             to_device(np.ones(K), dev))
        C = self.config.prefill_chunk
        if C > 0:
            for offset in range(0, self.request_capacity, C):
                self.backend.warm_chunk(offset)

    def _warm_sampler(self) -> None:
        """A sampled engine samples one row at admission and ``num_slots``
        rows a decode step: both shapes, on zero logits (the sampler is a
        pure function)."""
        if self.sampler.greedy:
            return
        V = self.api.cfg.vocab_size
        for b in sorted({1, self.config.num_slots}):
            self._sample_fn.warm(
                torch.zeros((b, V), dtype=torch.float32, device=self.device),
                to_device(np.zeros((2, b)), self.device))

    def _warm_swap_io(self) -> None:
        """State-neutral warm of the swap transfer path, as the reference's:
        gather the null page for every row (seal, then the copy to host
        memory, exactly the swap-out's shapes) and scatter the payload back
        from host memory with every row on the drop sentinel (unseal and
        scatter, nothing lands; page 0 gets zeros). Runs under the planned
        layout and under each toured one (one pair of graphs serves every
        layout here: the pools are not staged). The sequence number is
        drawn from ``_swap_seq`` like a real swap's, so no page is ever
        ciphered under a (key, counter) pair that warmup used. A
        disaggregated role warms it whatever its preempt policy: handoff
        export and ingest replay exactly these graphs. The timeline has no
        swap."""
        if self.kv_layout != "paged" or (
                self.preempt_policy != "swap" and not self.config.disagg_role):
            return
        MP, N = self.pages_per_slot, self.pool.num_pages
        seq = self._swap_seq
        self._swap_seq += 1
        ck, cv = self.backend.gather_pages(np.zeros(MP, np.int32), self._key,
                                           seq)
        payload = (sealing.cipher_to_host(ck), sealing.cipher_to_host(cv))
        self.backend.scatter_pages(
            *(sealing.cipher_to_device(a, self.device) for a in payload),
            np.full(MP, N, np.int32), self._key, seq)

    def _warm_step_neutral(self) -> None:
        """One decode tick on all-idle slots: every seq_len is 0, so paged
        writes land as zeros on the null page and the state is unchanged
        (on the timeline the shared position advances: warmup only). It
        takes the next boundary key, like a real step."""
        self.backend.step(np.zeros(self.config.num_slots, np.int32),
                          self._step_key())
        self._key_shift += 1

    def _swap_targets(self) -> List[Tuple[int, ...]]:
        """Stage layouts to prewarm (the reference's): ALL compositions of
        n blocks into num_stages stages when that inventory is small
        enough, else the adjacent single-block shifts of the planned
        layout (the replanner's most likely moves), capped at
        ``warmup_layouts``."""
        n = self.api.model.served_segment.n
        S = self.config.num_stages
        planned = self.stage_blocks
        if S <= 1 or n < S:
            return []
        if math.comb(n - 1, S - 1) - 1 <= self.config.warmup_layouts:
            out = []
            for cuts in itertools.combinations(range(1, n), S - 1):
                bounds = (0,) + cuts + (n,)
                blocks = tuple(b - a for a, b in zip(bounds, bounds[1:]))
                if blocks != planned:
                    out.append(blocks)
            return out
        seen, out = {planned}, []
        for i in range(S - 1):
            for d in (1, -1):
                blocks = list(planned)
                blocks[i] -= d
                blocks[i + 1] += d
                t = tuple(blocks)
                if min(blocks) >= 1 and t not in seen:
                    seen.add(t)
                    out.append(t)
        return out[:self.config.warmup_layouts]

    def _warm_layouts(self) -> None:
        """Tour the other stage layouts: each ``try_swap`` builds (and
        keeps) the target's decoder, then its probes, two neutral decode
        ticks and the swap I/O run there (on a rank engine also the
        layout's prefills, ``_warm_prefills``), and the engine swaps home
        -- so a post-freeze re-plan onto any toured layout, and the swap
        home, replay captured graphs only. Every rank of a rank engine
        tours in lockstep, so each restage's messages pair up."""
        planned = self.stage_blocks
        for target in self._swap_targets():
            if not self.try_swap(target):
                continue
            self.backend.stage_times()
            for _ in range(2):
                self._warm_step_neutral()
            self._warm_swap_io()
            if self.mesh is not None:
                self._warm_prefills()
            self.try_swap(planned)
        assert self.stage_blocks == planned

    def _reset_state(self) -> None:
        """Reset every piece of serving state the warm traffic touched --
        scheduler (rids restart at 0), page pool, device cache (in place),
        clocks, counters, events, measured telemetry -- leaving the
        captured graphs. The fault plane is re-seeded and its storm, death
        and stall state dropped, so the serve that follows replays a cold
        engine's fault schedule. Unlike the reference, the swap and transfer
        sequences and the boundary key's tick count are not reset: they key
        the page cipher's counter and the stage seals' key, and a (key,
        counter) pair reused would cipher serving pages or activations with
        the keystream that ciphered the warm traffic's known ones. The
        streams cannot change: both ciphers open to the same values under
        any key."""
        cfg = self.config
        self.scheduler = SlotScheduler(cfg.num_slots,
                                       finished_cap=cfg.finished_cap)
        if self.pool is not None:
            self.pool = PagePool(self.pool.num_pages, cfg.page_size)
        self.global_len = cfg.prompt_capacity
        self.slot_pages.clear()
        self.slot_len.clear()
        self.chunking.clear()
        self.pending[:] = 0
        self._key_shift += self.steps
        self.steps = 0
        self.swaps = 0
        self.preemptions = 0
        self.peak_running = 0
        self.swap_fallbacks = 0
        self.transfers_out = 0
        if self.faults is not None:
            self.faults.reset()
        self.recovery = self._fresh_recovery()
        self.failed.clear()
        self.pending_external = 0
        self._storm_pages = []          # they died with the pool
        self._storm_left = 0
        self._death_pending = False
        self._stall_stage = None
        self.stalled = False
        self.stall_reason = None
        self._blocked_rid = None
        self.admission_ms.clear()
        self.admissions = 0
        self.prefill_calls = 0
        self.packed_admissions = 0
        self.packed_prefills = 0
        self.chunked_admissions = 0
        self.chunk_steps = 0
        self.decode_wall_s = 0.0
        self.events.clear()
        self._step_events = []
        self.telemetry.reset_measurements()
        self.backend.reset_state()

    # -- drive to completion ----------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        n = 0
        while self.scheduler.has_work():
            if max_steps is not None and n >= max_steps:
                break
            self.step()
            if self.stalled:
                break
            n += 1
        return list(self.scheduler.finished)

    def run_trace(self, arrivals: Sequence[Tuple[int, Sequence[int], int,
                                                 Optional[int]]],
                  max_steps: Optional[int] = None) -> List[Request]:
        """Replay a timed arrival trace: each ``(step, prompt, max_new,
        eos_id)`` is submitted once the engine clock reaches its arrival
        step; idle gaps fast-forward the clock to the next arrival. Returns
        every submitted Request."""
        arrivals = sorted(arrivals, key=lambda a: a[0])
        reqs: List[Request] = []
        k, n = 0, 0
        while k < len(arrivals) or self.scheduler.has_work():
            if max_steps is not None and n >= max_steps:
                break
            while k < len(arrivals) and arrivals[k][0] <= self.steps:
                _, prompt, max_new, eos = arrivals[k]
                reqs.append(self.submit(list(prompt), max_new, eos_id=eos))
                k += 1
            if not self.scheduler.has_work():
                self.steps = max(self.steps, arrivals[k][0])
                continue
            self.step()
            if self.stalled:
                break
            n += 1
        return reqs

    def check_page_invariants(self) -> None:
        """Audit the page pool's refcounts against the live block tables;
        pages an injected storm holds are audited as a live table. The
        timeline has no pool."""
        if self.pool is None:
            return
        tables: Dict[Any, Any] = dict(self.slot_pages)
        if self._storm_pages:
            tables["storm"] = self._storm_pages
        self.pool.check_invariants(tables)

    def stats(self) -> Dict[str, Any]:
        out = dict(self.scheduler.stats())
        wall = self.decode_wall_s
        out.update({
            "device": str(self.device),
            "steps": self.steps,
            "swaps": self.swaps,
            "replans": self.replanner.replans,
            "failure_replans": self.replanner.failure_replans,
            "excluded_devices": list(self.replanner.excluded_devices),
            "backend": self.backend_kind,
            "stage_blocks": self.stage_blocks,
            "placement": self.spec.describe(),
            "kv_layout": self.kv_layout,
            "decode_wall_s": wall,
            "tok_per_s": (out["tokens_out"] / wall) if wall > 0 else 0.0,
            "prefill_calls": self.prefill_calls,
            "admissions": self.admissions,
            "warmed": self.warmed,
            "warmup_s": self.warmup_s,
            # None until warmup() froze the registry; 0 is the steady-state
            # guarantee (graph captures after warmup)
            "post_warmup_compiles": self.aot.post_freeze_compiles,
            "compile_stalls": [s.describe()
                               for s in self.aot.post_freeze_stalls],
            "graphs": self.aot.graphs,
            "prefill_pack": self.config.prefill_pack,
            "packed_admissions": self.packed_admissions,
            "packed_prefills": self.packed_prefills,
            "prefill_chunk": self.config.prefill_chunk,
            "chunked_admissions": self.chunked_admissions,
            "prefill_chunks": self.chunk_steps,
            "stalled": self.stalled,
            "stall_reason": self.stall_reason,
            "pending_external": self.pending_external,
            "recovery": dict(self.recovery),
            "failed_requests": dict(self.failed),
            "disagg_role": self.config.disagg_role,
            "transfers_out": self.transfers_out,
            "preemptions": self.preemptions,
            "preempt_policy": self.preempt_policy,
            "swap_fallbacks": self.swap_fallbacks,
            "peak_running_slots": self.peak_running,
            "batched_prefill": self.config.batched_prefill,
        })
        if self.kv_layout == "paged":
            out.update({
                "page_size": self.config.page_size,
                "num_pages": self.pool.num_pages,
                "free_pages": self.pool.free_pages,
                "peak_pages_in_use": self.pool.peak_in_use,
                "peak_demand_pages": self.pool.peak_demand,
                "page_policy": self.config.page_policy,
                "decode_cow": self.config.decode_cow,
                "cow_hits": self.pool.cow_hits,
                "forks": self.pool.forks,
                "evictions": self.pool.evictions,
            })
            out.update(self.pool.stats())   # swap and transfer ledgers
        else:
            out.update({"max_seq": self.config.max_seq,
                        "global_len": self.global_len})
        if self.faults is not None:
            out["faults"] = self.faults.snapshot()
            # injections whose rung has not completed yet (a death or stall
            # after the last re-plan, a storm mid-lifetime): each injected
            # fault is charged to a rung or to one of these
            out["faults_pending"] = {
                "death": self._death_pending,
                "stall": self._stall_stage is not None,
                "storm": bool(self._storm_pages),
            }
        if self.admission_ms:
            arr = np.asarray(self.admission_ms)
            out["admission_p50_ms"] = float(np.percentile(arr, 50))
            out["admission_p99_ms"] = float(np.percentile(arr, 99))
        return out
