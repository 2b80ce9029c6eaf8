"""Continuous-batching serving engine of the port, on the paged KV layout
(port of the paged path of ``repro/serving/engine.py``).

What this slice keeps from the reference, with the same host-side
decisions so that greedy token streams are equal:

* a paged per-slot KV cache: shared page pools ``[L, N, KVH, Pg, D]`` and
  per-slot block tables, page 0 the immutable null page;
* ``page_policy="demand"`` (block tables grow a page at a time, identical
  prompt-prefix pages shared copy-on-write, decode-completed pages frozen
  into the prefix index with ``decode_cow``) and ``"reserve"`` (worst case
  at admission, the oracle);
* bucketed, right-padded whole-prompt admission through ``prefill_at_fn``;
* preemption when the pool runs dry: ``"swap"`` gathers the victim's
  private pages, seals them with the ``seal_bits`` kernel into host memory
  and restores them bit for bit at resume with ``unseal_bits``;
  ``"recompute"`` re-prefills prompt + generated tokens (the oracle).

On the card every decode step's attention runs the CUDA paged-attention
kernel and every swap the CUDA page cipher; on the CPU the same calls take
the plain PyTorch versions. Not in this slice, and refused by name when a
config asks for them: the legacy timeline layout, chunked and packed
prefill, warmup (CUDA graphs), sampling at temperature > 0, disaggregated
prefill/decode, the fault plane, and the planner / telemetry / pipelined
backends (see ROADMAP.md, "Next slices").
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.enclave import sealing
from repro_torch.models.transformer import SEGMENT
from repro_torch.serving.sampling import TokenSampler
from repro_torch.serving.scheduler import (QUEUED, RUNNING, PagePool,
                                           Request, SlotScheduler)


@dataclasses.dataclass
class EngineConfig:
    """The paged subset of the reference's ``EngineConfig`` (same names,
    same meanings)."""
    num_slots: int = 4                  # decode batch == KV slots
    prompt_capacity: int = 32           # max admissible prompt length
    page_size: int = 16                 # tokens per KV page
    request_capacity: int = 0           # max prompt+max_new (0 = auto)
    num_pages: int = 0                  # pool size (0 = every slot at full
    #                                     request_capacity, + the null page)
    page_policy: str = "demand"         # "demand" | "reserve"
    preempt_policy: str = "auto"        # "auto" (= "swap") | "swap" |
    #                                     "recompute"
    prefix_sharing: bool = True         # COW prefix index (demand only)
    decode_cow: bool = True             # freeze decode-filled pages too
    temperature: float = 0.0            # > 0 is not ported yet
    events_cap: int = 4096              # host-history ring-buffer caps
    finished_cap: int = 4096
    admission_cap: int = 4096
    # reference options of later slices: anything but the default raises
    kv_layout: str = "paged"
    batched_prefill: bool = True
    prefill_chunk: int = 0
    prefill_pack: int = 0
    disagg_role: str = ""
    warmup: bool = False
    faults: Any = None


_LATER = {
    "kv_layout": ("paged", "the legacy timeline KV layout"),
    "batched_prefill": (True, "per-token prefill"),
    "prefill_chunk": (0, "chunked prefill"),
    "prefill_pack": ((0, 1), "packed prefill"),
    "disagg_role": ("", "disaggregated prefill/decode"),
    "warmup": (False, "warmup (CUDA-graph capture)"),
    "faults": (None, "the chaos fault plane"),
}


def _refuse_later_slices(cfg: EngineConfig) -> None:
    for name, (ok, what) in _LATER.items():
        val = getattr(cfg, name)
        allowed = ok if isinstance(ok, tuple) else (ok,)
        if val not in allowed:
            raise NotImplementedError(
                f"EngineConfig.{name}={val!r}: {what} is not ported yet; "
                f"see ROADMAP.md, 'Next slices'")


# ---------------------------------------------------------------------------
# Decode backend
# ---------------------------------------------------------------------------
class PagedLocalBackend:
    """Single-device paged backend: ``decode_paged_fn`` over shared page
    pools + per-slot block tables / seq_lens, all on ``api.device``. The
    device state is updated in place. Index vectors arrive as host numpy
    arrays; rows carrying the out-of-range sentinel ``num_pages`` are
    dropped on the host, as the reference's ``mode="drop"`` scatters drop
    them on the device."""

    def __init__(self, api, params, cfg: EngineConfig, num_pages: int,
                 pages_per_slot: int):
        self.api, self.params = api, params
        self.device = api.device
        self.num_pages = num_pages
        self._shape = (cfg.num_slots, num_pages, cfg.page_size,
                       pages_per_slot)
        self.steps = 0                  # decode steps run on this backend
        self.reset_state()

    def reset_state(self) -> None:
        self.cache = self.api.init_paged_cache(*self._shape)

    def _idx(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(self.device)

    def step(self, tokens: np.ndarray) -> torch.Tensor:
        toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        logits, self.cache = self.api.decode_paged_fn(
            self.params, self.cache, {"tokens": toks[:, None]})
        self.steps += 1
        return logits

    def _set_row(self, slot: int, bt_row: np.ndarray, seq_len: int) -> None:
        self.cache["block_tables"][slot] = torch.from_numpy(
            np.asarray(bt_row, np.int32)).to(self.device)
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
        k_pool, v_pool = self.cache[SEGMENT]
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
        for pool in self.cache[SEGMENT]:
            pool[:, dst] = pool[:, src]

    def gather_pages(self, pages: np.ndarray, key: int, ctr: int):
        """Seal ``pages`` (fixed [pages_per_slot] vector; 0 = the null page,
        for shared and padding rows) out of the pools with the page cipher.
        Rows are laid out ``[MP, L*KVH*Pg*D]`` exactly as the reference
        lays them out, so a payload unseals under either package. Returns
        (k_cipher, v_cipher) on the device."""
        pg = self._idx(pages)
        out = []
        for part, pool in enumerate(self.cache[SEGMENT]):
            rows = pool[:, pg].transpose(0, 1).reshape(len(pages), -1)
            out.append(sealing.seal_pages(rows, key, ctr, part=part))
        return tuple(out)

    def scatter_pages(self, ck: torch.Tensor, cv: torch.Tensor,
                      pages: np.ndarray, key: int, ctr: int) -> None:
        """Unseal payload rows and write row i into page ``pages[i]``
        (sentinel ``num_pages`` = skip the row)."""
        keep = np.nonzero(np.asarray(pages) < self.num_pages)[0]
        rows_t, pg = self._idx(keep), self._idx(pages[keep])
        for part, (pool, c) in enumerate(zip(self.cache[SEGMENT], (ck, cv))):
            rows = sealing.unseal_pages(c, key, ctr, pool.dtype, part=part)
            g = rows.reshape(len(pages), pool.shape[0], *pool.shape[2:])
            pool[:, pg] = g[rows_t].transpose(0, 1)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineEvent:
    step: int
    kind: str                  # admit | finish | preempt | fork | ...
    detail: Any = None


class ServingEngine:
    """Continuous-batching greedy serving over a paged KV cache.

    ``device`` defaults to ``cuda`` and must be the model's device; pass
    ``device="cpu"`` (with a CPU model) for the plain-PyTorch path."""

    def __init__(self, api, config: Optional[EngineConfig] = None,
                 params=None,
                 device: Optional[Union[str, torch.device]] = None):
        cfg = config or EngineConfig()
        self.device = resolve_device(device)
        if api.device != self.device:
            raise ValueError(f"engine device {self.device} but the model "
                             f"lives on {api.device}")
        _refuse_later_slices(cfg)
        if cfg.page_policy not in ("demand", "reserve"):
            raise ValueError(f"page_policy {cfg.page_policy!r}")
        if cfg.preempt_policy not in ("auto", "swap", "recompute"):
            raise ValueError(f"preempt_policy {cfg.preempt_policy!r}")
        self.api, self.config = api, cfg
        self.params = params if params is not None else api.init(
            torch.Generator(device=self.device).manual_seed(0))
        self.kv_layout = "paged"
        self.preempt_policy = "swap" if cfg.preempt_policy == "auto" \
            else cfg.preempt_policy

        self.request_capacity = cfg.request_capacity or \
            (cfg.prompt_capacity + 64)
        if self.request_capacity <= cfg.prompt_capacity:
            raise ValueError("request_capacity must exceed prompt_capacity")
        self.pages_per_slot = -(-self.request_capacity // cfg.page_size)
        num_pages = cfg.num_pages or (cfg.num_slots * self.pages_per_slot + 1)
        self.pool = PagePool(num_pages, cfg.page_size)
        self.slot_pages: Dict[int, List[int]] = {}
        # host mirror of each active slot's device seq_len (= the next
        # decode write position); drives demand growth / fork decisions
        self.slot_len: Dict[int, int] = {}
        self.preemptions = 0
        self.peak_running = 0
        # monotone swap sequence keys the cipher keystream: no (key,
        # counter) pair is ever reused across swap events
        self._swap_seq = 0
        self.swap_fallbacks = 0

        self.backend = PagedLocalBackend(api, self.params, cfg, num_pages,
                                         self.pages_per_slot)
        self.scheduler = SlotScheduler(cfg.num_slots,
                                       finished_cap=cfg.finished_cap)
        self.pending = np.zeros(cfg.num_slots, np.int32)  # next input token
        self.steps = 0
        self.stalled = False
        self.stall_reason: Optional[str] = None
        self._blocked_rid = None
        self.admission_ms: Deque[float] = deque(maxlen=cfg.admission_cap)
        self.admissions = 0
        self.prefill_calls = 0
        self.decode_wall_s = 0.0
        self.events: Deque[EngineEvent] = deque(maxlen=cfg.events_cap)
        self._step_events: List[EngineEvent] = []
        self._key = 0xC0FFEE
        self.sampler = TokenSampler(cfg.temperature)

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
        if self.config.page_policy == "demand":
            if self.pool.has_swap(req.rid):
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
        prefix keys are about to adopt."""
        keys = self._prompt_page_keys(self._prompt_tokens(req))
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
        if self.pool.has_swap(req.rid) and self._swap_in(slot, req, t0):
            return
        logits, shared = self._prefill_paged(slot, req)
        detail = {"rid": req.rid, "slot": slot,
                  "pages": len(self.slot_pages[slot]), "shared": shared}
        if req.generated:
            detail["resumed_at"] = len(req.generated)
        first = self.sampler.sample_one(logits, req.rid, len(req.generated))
        self.pending[slot] = first
        detail["ms"] = (time.perf_counter() - t0) * 1e3
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
        toks = np.zeros((1, S_pad), np.int64)
        toks[0, :P] = tokens
        logits, caches = self.api.prefill_at_fn(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device),
                          "prompt_len": P})
        kk, vv = (c[:, 0] for c in caches[SEGMENT])   # [L, KVH, S_pad, D]
        self.prefill_calls += 1
        Pg, N = self.config.page_size, self.pool.num_pages
        idx = np.arange(S_pad)
        page_of = np.minimum(idx, P - 1) // Pg
        shared_of = np.asarray(shared, bool)[page_of]
        skip = (idx >= P) | shared_of
        pages_vec = np.where(skip, N, np.asarray(pages, np.int32)[page_of])
        offs_vec = np.where(idx < P, idx % Pg, 0)
        self.backend.insert_slot(slot, (kk, vv), pages_vec, offs_vec, bt_row,
                                 P)
        return logits, int(sum(shared))

    def _on_finish(self, fin: Request) -> None:
        self._emit("finish", {"rid": fin.rid, "by": fin.finished_by})
        if fin.slot in self.slot_pages:
            self.pool.release(self.slot_pages.pop(fin.slot))
            self.slot_len.pop(fin.slot, None)
            self.backend.clear_slot(fin.slot)

    # -- demand paging: preemption + per-step growth/fork ------------------
    def _preempt(self, slot: int, req: Request) -> None:
        """Evict ``req`` to reclaim pages: sealed swap of its private pages
        (``"swap"``), or drop its KV for a teacher-forced re-prefill
        (``"recompute"``). Either way it goes to the front of the queue
        and its resumed stream is bit-identical."""
        if (self.preempt_policy == "swap"
                and self.config.page_policy == "demand"
                and req.status == RUNNING):
            self._preempt_swap(slot, req)
            return
        req.preemptions += 1
        self.preemptions += 1
        self.pool.release(self.slot_pages.pop(slot))
        self.slot_len.pop(slot)
        self.backend.clear_slot(slot)
        self.scheduler.preempt(slot)
        self.pending[slot] = 0
        self._emit("preempt", {"rid": req.rid, "slot": slot,
                               "generated": len(req.generated)})

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
                           digest=sealing.payload_digest(payload))
        self.pool.release(pages)
        self.backend.clear_slot(slot)
        self.scheduler.preempt(slot, swapped=True)
        self.pending[slot] = 0
        self._emit("preempt", {
            "rid": req.rid, "slot": slot, "policy": "swap",
            "generated": len(req.generated),
            "sealed_pages": sum(1 for t, _ in entries if t == "sealed"),
            "shared_pages": sum(1 for t, _ in entries if t == "shared")})

    def _integrity_reject(self, req: Request, fresh: List[int],
                          e: Exception) -> bool:
        self.pool.release(fresh)
        self.pool.drop_swap(req.rid)
        self._emit("unseal_fallback", {"rid": req.rid, "error": str(e)})
        return False

    def _swap_in(self, slot: int, req: Request, t0: float) -> bool:
        """Resume a swapped-out request: one fresh page per sealed row,
        unseal + scatter the host payload into them, re-adopt the pinned
        shared pages, rebuild the block table at the saved seq_len. No
        prefill and no new sample: ``generated[-1]`` was never written to
        KV and is the next decode input, as in the undisturbed run.
        Returns False (caller recomputes) when the payload fails its
        integrity tag; nothing is adopted before the digest matches."""
        man = self.pool.swap_manifest[req.rid]
        try:
            sealing.verify_structure(man.payload, man.digest,
                                     context=f"swap-in rid {req.rid}")
        except sealing.SealIntegrityError as e:
            return self._integrity_reject(req, [], e)
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
        self.backend.scatter_pages(ck, cv, scatter_vec, self._key,
                                   man.counter)
        try:
            sealing.verify_payload(man.payload, man.digest,
                                   context=f"swap-in rid {req.rid}")
        except sealing.SealIntegrityError as e:
            return self._integrity_reject(req, fresh, e)
        man = self.pool.swap_in(req.rid)
        bt_row = np.zeros(self.pages_per_slot, np.int32)
        bt_row[:len(pages)] = pages
        self.backend.commit_slot(slot, bt_row, man.n_tokens)
        self.slot_pages[slot] = pages
        self.slot_len[slot] = man.n_tokens
        self.pending[slot] = req.generated[-1]
        ms = (time.perf_counter() - t0) * 1e3
        self.admission_ms.append(ms)
        self.admissions += 1
        self._emit("admit", {"rid": req.rid, "slot": slot,
                             "resumed": "swap", "pages": len(pages),
                             "restored": len(fresh),
                             "shared": len(pages) - len(fresh), "ms": ms})
        return True

    def _maybe_break_swap_deadlock(self, nxt: Request) -> bool:
        """With nothing active no completion will free pages; only swap
        manifests' pins and the evictable prefix index hold them. Drop
        manifests youngest-first (the head's own last) until the head
        fits; each dropped request reverts to the recompute path."""
        if self.scheduler.active() or not self.pool.swap_manifest:
            return False
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
        request first, so the youngest is preempted first."""
        if self.config.page_policy != "demand":
            return
        Pg = self.config.page_size
        for slot, req in sorted(self.scheduler.active(),
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
                    self._emit("backpressure",
                               {"rid": nxt.rid, "waiting_on": "pages"})
                return
            self._blocked_rid = None
            hit = self.scheduler.admit_next(step=self.steps)
            assert hit is not None
            self._prefill_slot(*hit)

    # -- one decode step ---------------------------------------------------
    def step(self) -> List[EngineEvent]:
        self._step_events = []
        self._admit()
        self._grow_active()
        active = self.scheduler.active()
        if not active:
            # head-of-line blocked with nothing running: permanent unless a
            # swap manifest still pins pages the breaker can release
            recoverable = bool(self.pool.swap_manifest)
            self.stalled = bool(self.scheduler.queue) and not recoverable
            self.stall_reason = None if not self.scheduler.queue else \
                ("recoverable" if recoverable else "permanent")
            return self._step_events
        self.stalled = False
        self.stall_reason = None
        self.peak_running = max(self.peak_running, len(active))
        rids = np.zeros(self.config.num_slots, np.int64)
        idxs = np.zeros(self.config.num_slots, np.int64)
        for slot, req in active:
            rids[slot] = req.rid
            idxs[slot] = len(req.generated)
        t0 = time.perf_counter()
        logits = self.backend.step(self.pending)
        toks = self.sampler.sample(logits, rids, idxs)    # waits for the step
        self.decode_wall_s += time.perf_counter() - t0
        self.steps += 1
        for slot, req in active:
            self.pending[slot] = toks[slot]
            self.slot_len[slot] += 1       # this step's KV write landed
            self._maybe_register_decode_page(slot, req)
            fin = self.scheduler.on_token(slot, int(toks[slot]),
                                          step=self.steps)
            if fin is not None:
                self._on_finish(fin)
        return self._step_events

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

    def check_page_invariants(self) -> None:
        """Audit the page pool's refcounts against the live block tables."""
        self.pool.check_invariants(dict(self.slot_pages))

    def stats(self) -> Dict[str, Any]:
        out = dict(self.scheduler.stats())
        wall = self.decode_wall_s
        out.update({
            "device": str(self.device),
            "steps": self.steps,
            "kv_layout": self.kv_layout,
            "decode_wall_s": wall,
            "tok_per_s": (out["tokens_out"] / wall) if wall > 0 else 0.0,
            "prefill_calls": self.prefill_calls,
            "admissions": self.admissions,
            "stalled": self.stalled,
            "stall_reason": self.stall_reason,
            "page_size": self.config.page_size,
            "num_pages": self.pool.num_pages,
            "free_pages": self.pool.free_pages,
            "peak_pages_in_use": self.pool.peak_in_use,
            "peak_demand_pages": self.pool.peak_demand,
            "page_policy": self.config.page_policy,
            "preemptions": self.preemptions,
            "preempt_policy": self.preempt_policy,
            "swap_fallbacks": self.swap_fallbacks,
            "decode_cow": self.config.decode_cow,
            "cow_hits": self.pool.cow_hits,
            "forks": self.pool.forks,
            "evictions": self.pool.evictions,
            "peak_running_slots": self.peak_running,
        })
        out.update(self.pool.stats())       # swapped_pages/swap_outs/ins
        if self.admission_ms:
            arr = np.asarray(self.admission_ms)
            out["admission_p50_ms"] = float(np.percentile(arr, 50))
            out["admission_p99_ms"] = float(np.percentile(arr, 99))
        return out
