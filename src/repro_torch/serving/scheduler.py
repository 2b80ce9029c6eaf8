"""Serving layer 1 — continuous-batching slot scheduler (port of
``repro/serving/scheduler.py``: the request queue, the slot registry with
its handoff state, and the ref-counted page pool with its copy-on-write
prefix index, host swap tier and disaggregated-transfer ledger).

The engine decodes a fixed batch of ``num_slots`` KV-cache slots every step;
the scheduler multiplexes a stream of heterogeneous requests onto those
slots: FIFO admission into free slots, per-request EOS / length completion,
and immediate slot recycling — so a short request finishing early frees its
slot for the next queued prompt instead of idling until the longest request
in a static batch drains.

Pure host-side bookkeeping, identical in both packages. The engine
(engine.py) owns the actual prefill/decode computation and calls in after
every step with the tokens each slot produced. ``PagePool`` is the matching
allocator for the paged KV layout: slots hold *running* requests, pages
hold their KV — admission waits on both (FIFO back-pressure via ``peek``),
and completions recycle both.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

QUEUED = "queued"
PREFILL = "prefill"          # admitted to a slot, prompt chunking in flight
RUNNING = "running"
SWAPPED = "swapped"          # preempted with KV sealed to the host swap tier
HANDOFF = "handoff"          # prefilled KV sealed and shipped to a peer
#                              engine (disaggregated prefill/decode)
DONE = "done"


@dataclasses.dataclass
class Request:
    """One generation request and its transcript."""

    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    eos_id: Optional[int] = None
    status: str = QUEUED
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    submit_step: int = -1               # engine step counters, for stats
    admit_step: int = -1
    finish_step: int = -1
    preemptions: int = 0                # times evicted back to the queue

    @property
    def finished_by(self) -> Optional[str]:
        if len(self.generated) >= self.max_new_tokens:
            return "length"
        if self.eos_id is not None and self.generated \
                and self.generated[-1] == self.eos_id:
            return "eos"
        return None


class SlotScheduler:
    """Admission queue + slot registry for continuous batching.

    Invariants (asserted, and covered by tests/test_serving.py):
      * every slot holds at most one RUNNING request;
      * free slots + occupied slots partition ``range(num_slots)``;
      * admission is FIFO over submission order;
      * a completed request's slot is immediately reusable.
    """

    def __init__(self, num_slots: int, finished_cap: Optional[int] = None):
        assert num_slots > 0
        self.num_slots = num_slots
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._free: Deque[int] = deque(range(num_slots))
        self._next_rid = 0
        # finished transcripts are a ring buffer when capped (a week-long
        # serve must not grow host memory with completion count); the
        # aggregates below keep stats() exact over the whole lifetime
        self.finished: Deque[Request] = deque(maxlen=finished_cap)
        self.completed_total = 0
        self.tokens_out_total = 0
        self._wait_sum = 0
        self._wait_n = 0

    # -- submission / admission -------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None, step: int = -1) -> Request:
        assert max_new_tokens >= 1 and len(prompt) >= 1
        req = Request(self._next_rid, tuple(int(t) for t in prompt),
                      max_new_tokens, eos_id, submit_step=step)
        self._next_rid += 1
        self.queue.append(req)
        return req

    def adopt(self, req: Request) -> Request:
        """Enqueue an externally-created Request, keeping its rid (the
        disaggregated orchestrator assigns rids globally so the prefill and
        decode engines' sampler keystreams match the monolithic engine's).
        The local rid counter advances past it so a later local ``submit``
        can never collide."""
        assert req.status in (QUEUED, HANDOFF), req
        req.status = QUEUED
        self._next_rid = max(self._next_rid, req.rid + 1)
        self.queue.append(req)
        return req

    def peek(self) -> Optional[Request]:
        """The request ``admit_next`` would admit, or None — so the engine
        can gate admission on resources (page-pool / timeline budget)
        without popping. Strictly FIFO: a blocked head request blocks the
        queue (no overtaking, no starvation)."""
        if not self.queue or not self._free:
            return None
        return self.queue[0]

    def admit_next(self, step: int = -1) -> Optional[Tuple[int, Request]]:
        """Pop the oldest queued request into the lowest free slot."""
        if not self.queue or not self._free:
            return None
        slot = self._free.popleft()
        req = self.queue.popleft()
        assert self.slots[slot] is None, f"slot {slot} already occupied"
        req.status, req.slot, req.admit_step = RUNNING, slot, step
        self.slots[slot] = req
        return slot, req

    # -- decode-step bookkeeping ------------------------------------------
    def active(self) -> List[Tuple[int, Request]]:
        """Every occupied slot — RUNNING decoders and PREFILL (mid-chunk)
        admissions alike (preemption victim selection spans both)."""
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def decoding(self) -> List[Tuple[int, Request]]:
        """Slots actually decoding this step (excludes PREFILL slots whose
        prompt is still chunking in — they produce no tokens yet)."""
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.status == RUNNING]

    def mark_prefill(self, slot: int) -> None:
        """Flag an admitted request as mid-chunked-prefill: it occupies the
        slot (pages, preemption priority) but is not decoding yet."""
        req = self.slots[slot]
        assert req is not None and req.status == RUNNING, (slot, req)
        req.status = PREFILL

    def mark_running(self, slot: int) -> None:
        """Chunked prefill complete: the slot joins the decode batch."""
        req = self.slots[slot]
        assert req is not None and req.status == PREFILL, (slot, req)
        req.status = RUNNING

    def on_token(self, slot: int, token: int, step: int = -1
                 ) -> Optional[Request]:
        """Record a decoded token for ``slot``; completes and recycles the
        slot when the request hits EOS or its length budget. Returns the
        finished request, if any."""
        req = self.slots[slot]
        assert req is not None and req.status == RUNNING, (slot, req)
        req.generated.append(int(token))
        if req.finished_by:
            return self.complete(slot, step=step)
        return None

    def complete(self, slot: int, step: int = -1) -> Request:
        req = self.slots[slot]
        assert req is not None, slot
        req.status, req.finish_step = DONE, step
        self.slots[slot] = None
        self._free.append(slot)
        self.completed_total += 1
        self.tokens_out_total += len(req.generated)
        if req.admit_step >= 0 and req.submit_step >= 0:
            self._wait_sum += req.admit_step - req.submit_step
            self._wait_n += 1
        self.finished.append(req)
        return req

    def handoff(self, slot: int, step: int = -1) -> Request:
        """Vacate ``slot`` because the request's prefilled KV was sealed and
        shipped to a peer decode engine (disaggregated serving): the slot
        recycles immediately, but the request is neither DONE (its decode
        continues elsewhere) nor requeued here -- it leaves this scheduler in
        the HANDOFF state and its transcript stays owned by the caller."""
        req = self.slots[slot]
        assert req is not None and req.status == RUNNING, (slot, req)
        req.status, req.slot = HANDOFF, None
        self.slots[slot] = None
        self._free.append(slot)
        if req.admit_step >= 0 and req.submit_step >= 0:
            self._wait_sum += req.admit_step - req.submit_step
            self._wait_n += 1
        return req

    def preempt(self, slot: int, swapped: bool = False) -> Request:
        """Evict a RUNNING (or mid-PREFILL) request back to the *front* of
        the queue (it was admitted before anything still queued, so FIFO
        order by rid is preserved). The request keeps its generated tokens.

        ``swapped=False`` (recompute oracle): on re-admission the engine
        prefills prompt + generated as one extended prompt and decoding
        resumes token-exactly. ``swapped=True``: the engine sealed the
        victim's KV pages to the host swap tier (PagePool.swap_out) — the
        request re-queues in the SWAPPED state and re-admission restores the
        pages (O(pages) transfer) instead of re-prefilling (O(tokens)
        recompute)."""
        req = self.slots[slot]
        assert req is not None and req.status in (RUNNING, PREFILL), \
            (slot, req)
        req.status = SWAPPED if swapped else QUEUED
        req.slot = None
        self.slots[slot] = None
        self._free.append(slot)
        self.queue.appendleft(req)
        return req

    # -- introspection -----------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def check_invariants(self) -> None:
        occupied = {i for i, r in enumerate(self.slots) if r is not None}
        free = set(self._free)
        assert occupied.isdisjoint(free), (occupied, free)
        assert occupied | free == set(range(self.num_slots)), (occupied, free)
        for i, r in enumerate(self.slots):
            if r is not None:
                assert r.slot == i and r.status in (RUNNING, PREFILL), (i, r)

    def stats(self) -> Dict[str, float]:
        # lifetime aggregates, not the (possibly capped) finished deque
        return {
            "completed": self.completed_total,
            "queued": len(self.queue),
            "running": self.num_slots - len(self._free),
            "tokens_out": self.tokens_out_total,
            "mean_queue_wait_steps": (self._wait_sum / self._wait_n)
            if self._wait_n else 0.0,
        }


@dataclasses.dataclass
class SwapManifest:
    """Host-side record of one swapped-out request's KV (two-tier paging).

    ``entries[i]`` describes logical page ``i`` of the victim's block table:
    ``("sealed", i)`` — the page was private (refcount 1); its contents were
    sealed through the lossless bit-cipher into ``payload`` row ``i`` and the
    device page was freed. ``("shared", (key, page))`` — the page is
    COW-shared; it is never spilled: the manifest pins it in the prefix
    index (one extra reference) and swap-in re-adopts it in place.

    ``payload`` is opaque to the pool: host-resident (device-fetched) sealed
    buffers the engine's backend produced; ``counter`` is the swap sequence
    number that keys the cipher keystream; ``n_tokens`` restores slot_len.
    ``digest`` (optional) commits to the sealed payload bits
    (enclave.sealing.payload_digest) — the engine verifies it before
    unsealing, because the XOR keystream cipher is malleable and would
    otherwise scatter tampered bits straight into the KV pool.
    ``layout`` is, on an engine whose pipeline stages are ranks, the stage
    layer ranges the payload was sealed under (each rank holds its own
    layers' columns); None on one device.
    """

    rid: int
    n_tokens: int
    entries: List[Tuple[str, Any]]
    payload: Any
    counter: int
    digest: Any = None
    layout: Any = None

    @property
    def sealed_pages(self) -> int:
        return sum(1 for tag, _ in self.entries if tag == "sealed")

    @property
    def shared_pages(self) -> int:
        return sum(1 for tag, _ in self.entries if tag == "shared")


@dataclasses.dataclass
class TransferManifest(SwapManifest):
    """In-flight record of one disaggregated prefill->decode KV handoff.

    Mirrors ``SwapManifest``, but crosses *engines* rather than tiers: the
    prefill engine gathers and seals **every** page of the handed-off slot
    into ``payload`` (one ``gather_pages`` call keyed by a counter from the
    dedicated transfer sequence space, see ``enclave.sealing.transfer_seq``),
    frees its own device pages, and the manifest travels to the decode
    engine.

    On the prefill side every entry is ``("sealed", (row, key))`` -- ``row``
    indexes the payload, ``key`` is the page's content key (or None for a
    page past the written tokens). At ingestion the decode engine resolves
    each keyed row against *its own* prefix index: hits become ``("shared",
    (key, page))`` (the lookup pinned the page -- one manifest reference,
    exactly like swap), misses stay sealed and are scattered from the
    payload at admission. Because the payload always retains every row,
    demoting a shared entry back to sealed (``demote_transfer``, the
    deadlock-breaker's pin-release path) is lossless.

    ``digest`` is a host-side commitment to the sealed payload, verified by
    the decode engine before any row is unsealed: a handoff crosses trust
    domains, so in-transit tampering is exactly the threat the tag is
    for."""


class PagePool:
    """Host-side ref-counted allocator over the shared KV page pools.

    Page ids index the device-side ``[num_pages, KVH, page_size, D]`` pools
    (models/transformer.paged_kv_cache_spec). Page 0 is reserved as the null
    page: zero block-table tails and idle slots point there, and the write
    path drops writes aimed at it — it is never allocated and never written.

    Two allocation regimes share this pool (DESIGN.md §Demand paging):

    * **reserve** (the PR 5 baseline, kept as the verification oracle): the
      engine grabs a request's worst-case page count at admission via
      ``alloc`` and ``release``s it whole on completion.
    * **demand** (default): block tables grow one page at a time as decode
      proceeds (``alloc_one``), every page carries a **refcount**
      (``incref``/``decref`` — a page returns to the free list only when the
      last reference drops), and identical prompt-prefix pages are shared
      across requests through the **prefix index**: a content-keyed map from
      token prefixes to immutable pages. The index itself holds one
      reference, so an indexed page survives its creator (a prefix cache);
      when the free list runs dry, ``alloc_one`` evicts index-only pages
      (refcount == 1) in LRU order before giving up. Writers must fork
      (copy) any page whose refcount exceeds 1 before writing — the engine
      enforces that; ``check_invariants`` audits the whole ledger.
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2 and page_size >= 1
        self.num_pages, self.page_size = num_pages, page_size
        self._free: Deque[int] = deque(range(1, num_pages))
        self.refcount: List[int] = [0] * num_pages
        # prefix index: token-content key -> frozen page holding that content
        # (insertion order == LRU order; move_to_end on every hit)
        self.prefix_index: "OrderedDict[Tuple, int]" = OrderedDict()
        self._page_key: Dict[int, Tuple] = {}   # reverse map for eviction
        self.peak_in_use = 0
        # peak demand excludes evictable index-only pages: the prefix cache
        # deliberately retains reclaimable pages, so peak_in_use overstates
        # real pressure once the index warms up (page-savings comparisons
        # must use this, not peak_in_use)
        self.peak_demand = 0
        self.total_allocs = 0
        self.cow_hits = 0                       # admissions served by index
        self.evictions = 0                      # index pages reclaimed
        self.forks = 0                          # copy-on-write forks
        # two-tier swap ledger: rid -> manifest of sealed/shared pages.
        # Sealed pages live on the HOST — their device pages are freed at
        # swap-out, so neither peak_in_use nor peak_demand ever counts them
        # as device pressure (the swap-aware accounting contract).
        self.swap_manifest: Dict[int, SwapManifest] = {}
        self.swap_outs = 0
        self.swap_ins = 0
        # disaggregated handoff ledger: rid -> in-flight transfer manifest
        # (decode side only -- the prefill engine hands the manifest straight
        # to the orchestrator and never registers it in its own pool)
        self.transfer_manifest: Dict[int, TransferManifest] = {}
        self.transfers_in = 0
        self.transfer_demotions = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def evictable_pages(self) -> int:
        """Index-only pages (refcount == 1): reclaimable on demand."""
        return sum(1 for p in self.prefix_index.values()
                   if self.refcount[p] == 1)

    def pages_needed(self, tokens: int) -> int:
        return max(1, -(-tokens // self.page_size))

    def _note_usage(self) -> None:
        in_use = self.num_pages - 1 - len(self._free)
        self.peak_in_use = max(self.peak_in_use, in_use)
        self.peak_demand = max(self.peak_demand, in_use - self.evictable_pages)

    # -- reserve regime (PR 5 baseline) -----------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages, or None if the pool can't supply them (caller waits)."""
        if n > len(self._free):
            return None
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            assert self.refcount[p] == 0, (p, self.refcount[p])
            self.refcount[p] = 1
        self.total_allocs += n
        self._note_usage()
        return out

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.decref(p)

    # -- demand regime: refcounts ------------------------------------------
    def incref(self, page: int) -> None:
        assert page != 0 and self.refcount[page] >= 1, (page, self.refcount)
        self.refcount[page] += 1

    def decref(self, page: int) -> None:
        assert page != 0, "null page is never allocated"
        assert self.refcount[page] >= 1, f"double free of page {page}"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            assert page not in self._page_key, \
                f"page {page} freed while still in the prefix index"
            self._free.append(page)
            assert len(self._free) <= self.num_pages - 1

    def alloc_one(self, evict: bool = True) -> Optional[int]:
        """One page at refcount 1, evicting LRU index-only pages if the free
        list is empty. None when nothing is free or evictable (the caller
        preempts or waits)."""
        if not self._free and evict:
            self.evict_one()
        if not self._free:
            return None
        p = self._free.popleft()
        assert self.refcount[p] == 0, (p, self.refcount[p])
        self.refcount[p] = 1
        self.total_allocs += 1
        self._note_usage()
        return p

    # -- demand regime: prefix index (copy-on-write sharing) ---------------
    def lookup_prefix(self, key: Tuple) -> Optional[int]:
        """Hit: incref the frozen page and hand it out for sharing."""
        page = self.prefix_index.get(key)
        if page is None:
            return None
        self.prefix_index.move_to_end(key)
        self.incref(page)
        self.cow_hits += 1
        self._note_usage()          # the hit page is no longer reclaimable
        return page

    def register_prefix(self, key: Tuple, page: int) -> None:
        """Freeze ``page`` under ``key``. The index takes its own reference,
        so registered pages outlive their creator until evicted; any later
        write to the page (refcount > 1 from the index ref alone) must fork
        first, which keeps indexed content immutable."""
        if key in self.prefix_index:            # racing admissions: keep old
            return
        assert page not in self._page_key, (page, key)
        self.prefix_index[key] = page
        self._page_key[page] = key
        self.incref(page)

    def evict_one(self) -> bool:
        """Drop the LRU index entry whose page nobody else references."""
        for key, page in self.prefix_index.items():
            if self.refcount[page] == 1:
                del self.prefix_index[key]
                del self._page_key[page]
                self.decref(page)
                self.evictions += 1
                return True
        return False

    # -- two-tier swap (sealed host tier) ----------------------------------
    def has_swap(self, rid: int) -> bool:
        return rid in self.swap_manifest

    def manifest(self, rid: int) -> SwapManifest:
        return self.swap_manifest[rid]

    @property
    def swapped_pages(self) -> int:
        """Host-resident sealed pages across all manifests (not device
        pressure — their device pages were freed at swap-out)."""
        return sum(m.sealed_pages for m in self.swap_manifest.values())

    def swap_out(self, rid: int, entries: Sequence[Tuple[str, Any]],
                 payload: Any, n_tokens: int, counter: int,
                 digest: Any = None, layout: Any = None) -> SwapManifest:
        """Record a victim's sealed spill. The caller has already gathered
        and sealed the private pages into ``payload`` (and will release the
        slot's page references afterwards); this pins every shared page with
        one manifest reference so the prefix index cannot evict it while the
        request is swapped out — re-adoption at swap-in is guaranteed."""
        assert rid not in self.swap_manifest, rid
        man = SwapManifest(rid, n_tokens, list(entries), payload, counter,
                           digest, layout)
        for tag, val in man.entries:
            if tag == "shared":
                key, page = val
                assert self._page_key.get(page) == key, \
                    f"shared page {page} not frozen under its key"
                self.incref(page)
        self.swap_manifest[rid] = man
        self.swap_outs += 1
        return man

    def swap_in(self, rid: int) -> SwapManifest:
        """Pop the manifest for restore. Shared entries' pin references
        TRANSFER to the caller (who assigns the pages into the resumed
        slot's block table) — no refcount movement here, so the pages are
        never transiently evictable during the restore."""
        man = self.swap_manifest.pop(rid)
        for tag, val in man.entries:
            if tag == "shared":
                key, page = val
                assert self._page_key.get(page) == key, (key, page)
                assert self.refcount[page] >= 2, (page, self.refcount[page])
        self.swap_ins += 1
        return man

    def drop_swap(self, rid: int) -> SwapManifest:
        """Discard a manifest (deadlock fallback: the request reverts to the
        recompute oracle). Unpins its shared pages; the sealed host payload
        is simply dropped."""
        man = self.swap_manifest.pop(rid)
        for tag, val in man.entries:
            if tag == "shared":
                self.decref(val[1])
        return man

    # -- disaggregated transfer (cross-engine handoff) ----------------------
    def has_transfer(self, rid: int) -> bool:
        return rid in self.transfer_manifest

    @property
    def pending_transfers(self) -> int:
        return len(self.transfer_manifest)

    def register_transfer(self, rid: int, entries: Sequence[Tuple[str, Any]],
                          payload: Any, n_tokens: int, counter: int,
                          digest: Any = None,
                          layout: Any = None) -> TransferManifest:
        """Park an incoming handoff manifest until the scheduler admits its
        request. Shared entries were resolved against this pool's prefix
        index by the caller -- ``lookup_prefix`` already took the manifest's
        pin reference, so this only records and validates (unlike
        ``swap_out``, which increfs itself: resolution and pinning are one
        lookup here). ``layout`` is the stage layer ranges the payload was
        sealed under on a rank engine, as a swap manifest's."""
        assert rid not in self.transfer_manifest, rid
        man = TransferManifest(rid, n_tokens, list(entries), payload, counter,
                               digest, layout)
        for tag, val in man.entries:
            if tag == "shared":
                key, page = val
                assert self._page_key.get(page) == key, \
                    f"transfer rid {rid}: shared page {page} not frozen " \
                    f"under its key"
                assert self.refcount[page] >= 2, (page, self.refcount[page])
        self.transfer_manifest[rid] = man
        return man

    def transfer_in(self, rid: int) -> TransferManifest:
        """Pop the manifest for admission. Shared entries' pins TRANSFER to
        the caller's block table (the no-movement discipline of
        ``swap_in``)."""
        man = self.transfer_manifest.pop(rid)
        for tag, val in man.entries:
            if tag == "shared":
                key, page = val
                assert self._page_key.get(page) == key, (key, page)
                assert self.refcount[page] >= 2, (page, self.refcount[page])
        self.transfers_in += 1
        return man

    def drop_transfer(self, rid: int) -> TransferManifest:
        """Abandon an in-flight handoff (its payload failed verification, or
        the request is gone): unpin its shared pages, drop the sealed
        payload."""
        man = self.transfer_manifest.pop(rid)
        for tag, val in man.entries:
            if tag == "shared":
                self.decref(val[1])
        return man

    def demote_transfer(self, rid: int) -> int:
        """Release a parked manifest's prefix-index pins without losing the
        handoff (deadlock breaker): the payload retains every row, so shared
        entries flip back to sealed and admission scatters them from the
        payload instead of adopting index pages. Returns pages released."""
        man = self.transfer_manifest[rid]
        freed = 0
        for i, (tag, val) in enumerate(man.entries):
            if tag == "shared":
                key, page = val
                man.entries[i] = ("sealed", (i, key))
                self.decref(page)
                freed += 1
        if freed:
            self.transfer_demotions += 1
        return freed

    def stats(self) -> Dict[str, int]:
        return {
            "swapped_pages": self.swapped_pages,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "pending_transfers": self.pending_transfers,
            "transfers_in": self.transfers_in,
            "transfer_demotions": self.transfer_demotions,
        }

    # -- auditing -----------------------------------------------------------
    def check_invariants(self, live_tables: Dict[int, Sequence[int]]) -> None:
        """Audit the ledger against the engine's live block tables:
        refcount(p) == (# live block-table references to p) + (1 if the
        prefix index holds p) + (# swap- or transfer-manifest pins on p);
        free/allocated partition the non-null ids; no page is both free and
        referenced; the null page is never held; every manifest-pinned
        shared page is still frozen in the index under its manifest key (so
        no device page is simultaneously free and claimed by a swapped-out
        or handed-off request)."""
        expect = [0] * self.num_pages
        for _slot, pages in live_tables.items():
            for p in pages:
                assert p != 0, f"live table references the null page"
                expect[p] += 1
        for key, p in self.prefix_index.items():
            assert self._page_key.get(p) == key, (p, key)
            expect[p] += 1
        for what, ledger in (("swapped", self.swap_manifest),
                             ("transfer", self.transfer_manifest)):
            for rid, man in ledger.items():
                assert man.rid == rid, (rid, man.rid)
                for tag, val in man.entries:
                    if tag == "shared":
                        key, p = val
                        assert p != 0, f"{what} manifest pins the null page"
                        assert self._page_key.get(p) == key, \
                            f"{what} rid {rid}: shared page {p} no longer " \
                            f"frozen under its key"
                        expect[p] += 1
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        for p in range(1, self.num_pages):
            assert self.refcount[p] == expect[p], \
                f"page {p}: refcount {self.refcount[p]} != live refs " \
                f"{expect[p]}"
            assert (self.refcount[p] == 0) == (p in free), \
                f"page {p}: refcount/free-list disagree"
        assert self.refcount[0] == 0 and 0 not in free

