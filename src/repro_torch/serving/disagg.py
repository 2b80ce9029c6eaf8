"""Disaggregated prefill/decode across trust domains (port of
``repro/serving/disagg.py``).

Prefill is compute-bound (one big batched pass over the prompt); decode is
memory-bound (the KV cache streamed past the weights a token at a time).
Serdab's partitioning argument applies to serving: run prefill on a fast,
possibly untrusted device and decode inside the trusted domain, and ship
the prompt's KV across the boundary sealed with the page cipher.

Three pieces, as in the reference:

* ``PrefillEngine`` -- a ``ServingEngine`` in the prefill role: it admits
  requests (bucketed, packed or chunked prefill, never a decode tick),
  samples each request's FIRST token, then seals every KV page of the slot
  (``export_transfer``: one ``gather_pages`` under a counter of the
  transfer space) and vacates it. Its output is a stream of ``(Request,
  TransferManifest)`` handoffs.
* ``DisaggOrchestrator`` -- owns the global rid counter (so the requests
  are numbered as a monolithic engine would number them), routes
  submissions to the prefill engine, applies back-pressure when the decode
  side has no admission room, delivers each manifest to the decode engine
  (``ingest_transfer`` resolves rows against the decode pool's COW index)
  and ticks decode. With no prefill peer it drives the decode engine
  monolithically.
* ``plan_disagg_roles`` -- scores (prefill domain, decode domain) pairs
  over the trust-domain ``ResourceManager``: roofline prefill and decode
  times, the seal and link cost of the KV handoff, and the
  ``cut_exposure`` price of letting an untrusted device see the prompt.
  Decode must be trusted; untrusted prefill is allowed.

Streams, greedy or sampled, equal the monolithic engine's: both roles
share params and sampler config, a request keeps its rid on both roles
(the sampler keys each token by rid and index), the first token is
sampled on the prefill side exactly as the monolithic engine samples it,
and ``_transfer_in`` resumes decode like a swap-in (the first token was never written to KV, so it is the next
decode input). On the card both roles run their paged, flash and cipher
CUDA kernels; with ``warmup`` each role captures its own CUDA graphs.

Over a pod x data mesh of ranks (``build_disagg(mesh=)``) both roles are
rank engines on every rank and the orchestrator runs its same host logic
on each: a handoff's fate, back-pressure and deadlines read only what
every rank holds alike (the fault plane's seeded draws, queue lengths,
the tick clock), so they agree with no message. Each rank ships its own
part of a handoff, cipher text only (``serving/ranked.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.cost_model import seal_time, transmit_time
from repro_torch.core.planner import profiles_from_arch
from repro_torch.core.privacy import cut_exposure
from repro_torch.enclave.domain import ResourceManager
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.scheduler import Request, TransferManifest


# ---------------------------------------------------------------------------
# Role planning over trust domains
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoleCandidate:
    """One scored (prefill, decode) domain assignment."""

    prefill_domain: str
    decode_domain: str
    prefill_s: float            # roofline prompt pass on the prefill device
    seal_s: float               # seal (src) + unseal (dst) of the KV pages
    link_s: float               # manifest transfer over the connecting link
    decode_s: float             # max_new roofline decode steps
    interference_s: float       # colocated only: peer prefills stalling decode
    leakage: float              # cut_exposure price of untrusted prefill

    @property
    def latency_s(self) -> float:
        return (self.prefill_s + self.seal_s + self.link_s + self.decode_s
                + self.interference_s)


@dataclasses.dataclass(frozen=True)
class RolePlan:
    prefill_domain: str
    decode_domain: str
    latency_s: float
    leakage: float
    handoff_bytes: float
    candidates: Tuple[RoleCandidate, ...]   # every legal pair, best first

    def describe(self) -> str:
        return (f"prefill@{self.prefill_domain} -> decode@"
                f"{self.decode_domain} ({self.latency_s * 1e3:.2f} ms, "
                f"leakage {self.leakage:.3g})")


def plan_disagg_roles(rm: ResourceManager, model_cfg, *,
                      prompt_len: int = 256, max_new: int = 64,
                      page_size: int = 16, concurrency: int = 16,
                      bytes_per_el: int = 2) -> RolePlan:
    """Pick which trust domain runs each role.

    The decode domain MUST be trusted: generated tokens and their KV never
    leave the enclave. The prefill domain may be untrusted; that candidate
    carries a ``cut_exposure`` leakage price (the prompt is processed in
    the clear there, similarity 1.0). Leakage is recorded on the plan,
    latency decides, as in the layer planner.

    Costs are the layer cost model's roofline terms: prefill = whole-prompt
    flops on the prefill device + per-layer dispatch; handoff = seal at the
    source + transmit page-granular KV over the link + unseal at the
    destination; decode = ``max_new`` memory-bound steps (weights + the
    growing KV) on the decode device. The colocated candidate (one domain
    for both, i.e. monolithic serving) skips the handoff but pays
    interference: at ``concurrency`` resident requests, about
    ``concurrency - 1`` peer prefills stall the shared device during this
    request's decode.
    """
    prof_prefill = profiles_from_arch(model_cfg, seq_len=prompt_len,
                                      bytes_per_el=bytes_per_el)
    prof_decode = profiles_from_arch(model_cfg, seq_len=1,
                                     bytes_per_el=bytes_per_el)
    prefill_flops = sum(p.flops for p in prof_prefill)
    params_bytes = sum(p.params_bytes for p in prof_decode)
    # per-token KV row: every layer's K and V vectors
    kv_tok = (model_cfg.num_layers * 2 * model_cfg.num_kv_heads
              * model_cfg.head_dim * bytes_per_el)
    pages = -(-prompt_len // page_size)
    handoff_bytes = float(pages * page_size * kv_tok)
    # prompt bytes seen in the clear by an untrusted prefill device
    prompt_bytes = float(prompt_len * model_cfg.d_model * bytes_per_el)
    # mean decode context: KV grows from prompt_len to prompt_len + max_new
    kv_mean = (prompt_len + max_new / 2.0) * kv_tok

    graph = rm.resource_graph()
    n_layers = model_cfg.num_layers
    cands: List[RoleCandidate] = []
    for pname, pdev in graph.devices.items():
        for dname, ddev in graph.devices.items():
            if not ddev.trusted:
                continue                 # decode stays in the enclave
            pre = (prefill_flops / pdev.flops_per_s
                   + n_layers * pdev.per_layer_overhead)
            if pname == dname:
                seal_s = link_s = 0.0    # monolithic: no handoff at all
                interf = max(0, concurrency - 1) * pre
            else:
                seal_s = (seal_time(handoff_bytes, pdev)
                          + seal_time(handoff_bytes, ddev))
                link_s = transmit_time(handoff_bytes,
                                       graph.link(pname, dname))
                interf = 0.0
            dec = max_new * ((params_bytes + kv_mean) / ddev.mem_bw
                             + n_layers * ddev.per_layer_overhead)
            leak = 0.0 if pdev.trusted else cut_exposure(1.0, prompt_bytes)
            cands.append(RoleCandidate(pname, dname, pre, seal_s, link_s,
                                       dec, interf, leak))
    if not cands:
        raise ValueError("no trusted decode domain registered")
    cands.sort(key=lambda c: (c.latency_s, c.prefill_domain,
                              c.decode_domain))
    best = cands[0]
    return RolePlan(best.prefill_domain, best.decode_domain, best.latency_s,
                    best.leakage, handoff_bytes, tuple(cands))


# ---------------------------------------------------------------------------
# The prefill role
# ---------------------------------------------------------------------------
class PrefillEngine:
    """A ``ServingEngine`` driven prefill-only.

    ``pump()`` runs one admission round (``_admit``: bucketed, packed or
    swap-resume prefill) plus one chunked-prefill advance, then exports
    every slot that reached RUNNING (prompt in, first token sampled) as a
    sealed ``TransferManifest``. The engine never takes a decode tick.
    Requests that finish at prefill (``max_new_tokens == 1``, or EOS on the
    first token) complete here and are returned separately: nothing is
    shipped for them."""

    def __init__(self, eng: ServingEngine):
        if eng.config.disagg_role != "prefill":
            raise ValueError(f"PrefillEngine needs disagg_role='prefill', "
                             f"not {eng.config.disagg_role!r}")
        self.eng = eng
        self._completed_seen = 0

    def pump(self) -> Tuple[List[Tuple[Request, TransferManifest]],
                            List[Request]]:
        """One prefill round. Returns (handoffs, completed_at_prefill)."""
        eng = self.eng
        eng._admit()
        eng._advance_chunks()
        handoffs = [eng.export_transfer(slot)
                    for slot, _ in eng.scheduler.decoding()]
        done = eng.scheduler.completed_total - self._completed_seen
        completed: List[Request] = []
        if done:
            completed = list(eng.scheduler.finished)[-done:]
            self._completed_seen = eng.scheduler.completed_total
        # the prefill clock ticks per pump, so queue-wait stats stay
        # meaningful although no decode step ever runs here
        eng.steps += 1
        return handoffs, completed

    def has_work(self) -> bool:
        return self.eng.scheduler.has_work()

    def check_invariants(self) -> None:
        self.eng.scheduler.check_invariants()
        self.eng.check_page_invariants()


# ---------------------------------------------------------------------------
# The orchestrator
# ---------------------------------------------------------------------------
class DisaggOrchestrator:
    """Routes requests across the prefill/decode engine pair.

    * **rid discipline** -- the orchestrator owns the rid counter and adopts
      each Request into the prefill engine's queue with it, so requests are
      numbered as a monolithic engine receiving the same submissions in the
      same order numbers them.
    * **back-pressure** -- the prefill engine is pumped only while the
      decode side has admission room (its queue plus the handoffs in flight
      shorter than its slot count); otherwise the round is skipped and
      counted (``backpressure_events``), and prompts wait at prefill.
    * **delivery ladder** -- every handoff rides an in-flight list with a
      delivery deadline (``DEADLINE_TICKS``) and bounded exponential
      back-off. The chaos fault plane (the decode engine's ``faults``) may
      drop a delivery attempt (re-sent after ``2^attempt`` orchestrator
      ticks, ``handoff_retries``), park it for a few ticks (counted as a
      ``handoff_redeliveries`` when it lands) or corrupt or truncate the
      sealed payload in transit (caught by the digest at ``_transfer_in``,
      which falls back to a re-prefill). A handoff that exhausts
      ``MAX_ATTEMPTS`` or blows its deadline is demoted to a decode-side
      re-prefill (``handoff_reprefills``): the request is adopted WITHOUT
      its manifest and rebuilds its KV teacher-forced, so its stream is
      unchanged. A re-sent handoff carries its original sealed manifest
      (nothing is sealed again), and the demoted re-prefill seals nothing.
      Fault-free, every handoff is delivered in the tick it was enqueued.
      ``decode.pending_external`` mirrors the in-flight count, so a decode
      stall behind a pending handoff is recoverable.
    * **fallback** -- with no prefill peer, ``submit``/``step`` drive the
      decode engine directly: same streams, one engine, zero handoffs.
    """

    # attempt k is re-sent after 2^k ticks, so a handoff is abandoned to
    # re-prefill after about 2^MAX_ATTEMPTS ticks or at its deadline,
    # whichever comes first
    MAX_ATTEMPTS = 4
    DEADLINE_TICKS = 24

    def __init__(self, decode: ServingEngine,
                 prefill: Optional[PrefillEngine] = None):
        if decode.config.disagg_role not in ("", "decode"):
            raise ValueError(f"decode engine has disagg_role "
                             f"{decode.config.disagg_role!r}")
        self.decode = decode
        self.prefill = prefill
        if prefill is not None:
            pe = prefill.eng
            if decode.config.disagg_role != "decode":
                raise ValueError("the decode engine of a pair needs "
                                 "disagg_role='decode'")
            # equal streams need the same params and sampler config
            if pe.params is not decode.params:
                raise ValueError("prefill and decode engines must share "
                                 "params")
            for f in ("temperature", "top_k", "sample_seed", "page_size"):
                if getattr(pe.config, f) != getattr(decode.config, f):
                    raise ValueError(f"prefill/decode config mismatch on "
                                     f"{f}")
            if pe.pages_per_slot != decode.pages_per_slot:
                raise ValueError("a manifest carries pages_per_slot rows: "
                                 "both roles need one request_capacity")
        self._next_rid = 0
        self.backpressure_events = 0
        self.handoffs = 0
        self.prefill_completed: List[Request] = []
        # in-flight delivery ladder: [req, man, attempt, due, deadline,
        # delayed] rows on the orchestrator tick clock (decode.steps does
        # not advance while decode idles)
        self.clock = 0
        self._in_flight: List[List[Any]] = []

    # -- submission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
        if self.prefill is None:
            req = self.decode.submit(prompt, max_new_tokens, eos_id)
            self._next_rid = req.rid + 1
            return req
        pe = self.eng_prefill
        if not 1 <= len(prompt) <= pe.config.prompt_capacity:
            raise ValueError(f"prompt length {len(prompt)} outside [1, "
                             f"{pe.config.prompt_capacity}]")
        total = len(prompt) + max_new_tokens
        for eng, role in ((pe, "prefill"), (self.decode, "decode")):
            if total > eng.request_capacity:
                raise ValueError(f"prompt+max_new {total} > {role} "
                                 f"request_capacity {eng.request_capacity}")
            worst = eng.pool.pages_needed(total) + 1
            if worst > eng.pool.num_pages - 1:
                raise ValueError(f"request needs {worst} pages but the "
                                 f"{role} pool holds "
                                 f"{eng.pool.num_pages - 1}")
        req = Request(self._next_rid, tuple(int(t) for t in prompt),
                      max_new_tokens, eos_id, submit_step=pe.steps)
        self._next_rid += 1
        pe.scheduler.adopt(req)
        return req

    @property
    def eng_prefill(self) -> ServingEngine:
        assert self.prefill is not None
        return self.prefill.eng

    # -- one orchestrator tick ---------------------------------------------
    def step(self) -> None:
        """Pump prefill (under back-pressure), deliver the handoffs due,
        tick decode."""
        self.clock += 1
        if self.prefill is not None and self.prefill.has_work():
            room = (len(self.decode.scheduler.queue) + len(self._in_flight)
                    < self.decode.config.num_slots)
            if room:
                handoffs, completed = self.prefill.pump()
                self._in_flight += [[req, man, 0, self.clock,
                                     self.clock + self.DEADLINE_TICKS, False]
                                    for req, man in handoffs]
                self.prefill_completed.extend(completed)
            else:
                self.backpressure_events += 1
        self._deliver_due()
        self.decode.pending_external = len(self._in_flight)
        self.decode.step()

    def _deliver_due(self) -> None:
        """One pass over the in-flight ladder, in order: attempt every due
        delivery. Fault-free (no plane, or none firing) every handoff
        enqueued this tick is delivered this tick."""
        plane = self.decode.faults
        rec = self.decode.recovery
        still: List[List[Any]] = []
        for entry in self._in_flight:
            req, man, attempt, due, deadline, delayed = entry
            if self.clock < due:
                still.append(entry)
                continue
            if self.clock > deadline:
                self._demote_to_reprefill(req, man, "deadline")
                continue
            fate, d = plane.handoff_fate() if plane is not None \
                else ("deliver", 0)
            if fate == "drop":
                attempt += 1
                if attempt >= self.MAX_ATTEMPTS:
                    self._demote_to_reprefill(req, man, "retries")
                    continue
                rec["handoff_retries"] += 1
                entry[2] = attempt
                entry[3] = self.clock + (1 << attempt)  # exponential back-off
                still.append(entry)
                continue
            if fate == "delay":
                entry[3] = self.clock + d
                entry[5] = True
                still.append(entry)
                continue
            if plane is not None:
                # in-transit tamper: the damage travels with the manifest
                # and the digest check at _transfer_in catches it. On
                # ranks the byte is drawn over whole rows, as one device
                # draws it, and flipped on the rank whose part holds it
                tampered, mode = plane.maybe_tamper_transfer(
                    man.payload, self.decode.cipher_window(man))
                if mode is not None:
                    man.payload = tampered
            self.decode.ingest_transfer(req, man)
            self.handoffs += 1
            if attempt > 0 or delayed:
                rec["handoff_redeliveries"] += 1
        self._in_flight = still

    def _demote_to_reprefill(self, req: Request, man: TransferManifest,
                             why: str) -> None:
        """Abandon the sealed handoff and adopt the bare request into the
        decode queue: ``_prefill_slot`` finds no manifest and re-prefills
        prompt + the prefill role's first token teacher-forced, so the
        stream is unchanged; only the handoff's O(pages) resume is lost."""
        del man      # the sealed payload is abandoned with the delivery
        self.decode.recovery["handoff_reprefills"] += 1
        self.decode.scheduler.adopt(req)
        self.decode._emit("handoff_reprefill", {"rid": req.rid, "why": why})

    def has_work(self) -> bool:
        return ((self.prefill is not None and self.prefill.has_work())
                or bool(self._in_flight)
                or self.decode.scheduler.has_work())

    @property
    def stalled(self) -> bool:
        """The decode engine is stalled and the prefill side has nothing
        left that could unblock it."""
        return self.decode.stalled and not (
            self.prefill is not None and self.prefill.has_work())

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive to completion; returns every finished request (decode-side
        completions plus requests that finished at prefill), rid-sorted."""
        n = 0
        while self.has_work():
            if max_steps is not None and n >= max_steps:
                break
            self.step()
            if self.stalled:
                break
            n += 1
        out = list(self.decode.scheduler.finished) + self.prefill_completed
        return sorted(out, key=lambda r: r.rid)

    def run_trace(self, arrivals, max_steps: Optional[int] = None
                  ) -> List[Request]:
        """Timed trace replay against the decode engine's step counter (the
        clock ``ServingEngine.run_trace`` uses), idle gaps fast-forwarded.
        Returns every submitted Request."""
        arrivals = sorted(arrivals, key=lambda a: a[0])
        reqs: List[Request] = []
        k, n = 0, 0
        while k < len(arrivals) or self.has_work():
            if max_steps is not None and n >= max_steps:
                break
            while k < len(arrivals) and arrivals[k][0] <= self.decode.steps:
                _, prompt, max_new, eos = arrivals[k]
                reqs.append(self.submit(list(prompt), max_new, eos_id=eos))
                k += 1
            if not self.has_work():
                self.decode.steps = max(self.decode.steps, arrivals[k][0])
                continue
            self.step()
            if self.stalled:
                break
            n += 1
        return reqs

    # -- introspection -----------------------------------------------------
    def check_invariants(self) -> None:
        if self.prefill is not None:
            self.prefill.check_invariants()
        self.decode.scheduler.check_invariants()
        self.decode.check_page_invariants()

    def stats(self) -> Dict[str, Any]:
        out = dict(self.decode.stats())
        out["disagg"] = self.prefill is not None
        out["handoffs"] = self.handoffs
        out["in_flight_handoffs"] = len(self._in_flight)
        out["backpressure_events"] = self.backpressure_events
        out["prefill_completed"] = len(self.prefill_completed)
        if self.prefill is not None:
            pe = self.eng_prefill
            out["pending_handoffs"] = self.decode.pool.pending_transfers
            out["prefill_stats"] = {
                "admissions": pe.admissions,
                "prefill_calls": pe.prefill_calls,
                "transfers_out": pe.transfers_out,
                "packed_admissions": pe.packed_admissions,
                "packed_prefills": pe.packed_prefills,
                "queued": len(pe.scheduler.queue),
                "post_warmup_compiles": pe.aot.post_freeze_compiles,
            }
        return out


# ---------------------------------------------------------------------------
# Convenience constructor
# ---------------------------------------------------------------------------
def build_disagg(api, params=None, *, config: Optional[EngineConfig] = None,
                 prefill_overrides: Optional[Dict[str, Any]] = None,
                 backend: Optional[str] = None, mesh=None,
                 device: Optional[Union[str, torch.device]] = None,
                 rm: Optional[ResourceManager] = None,
                 warmup: Optional[bool] = None) -> DisaggOrchestrator:
    """Build a prefill/decode engine pair over SHARED params and wire the
    orchestrator. ``config`` seeds both engines (each role builds its own
    fault plane from ``config.faults``); ``prefill_overrides``
    (e.g. ``{"prefill_pack": 4, "num_slots": 2}``) reshape the prefill
    role only. ``device`` is the engines' (``cuda`` unless the caller asks
    for the CPU). With ``mesh`` (a pod x data mesh of ranks, called on
    every rank of ``launch.ranks.spawn``) both roles are rank engines with
    stage s on the ranks of pod s (``serving/ranked.py``), over one host
    copy of the params, and the orchestrator runs on every rank. With
    ``warmup`` each role captures its own graphs in its constructor, the
    decode role first, on every rank at the same point; each registry
    counts only its own captures, so unlike the reference (whose compile
    monitor is process-global) neither needs to be frozen again once both
    have warmed up."""
    cfg = config or EngineConfig()
    if params is None:
        params = api.init(torch.Generator(device=api.device).manual_seed(0))
    if mesh is not None:
        from repro_torch.serving import ranked
        params = ranked.host_copy(params)    # one host tree for both roles
    d_cfg = dataclasses.replace(cfg, disagg_role="decode")
    p_cfg = dataclasses.replace(cfg, **{**(prefill_overrides or {}),
                                        "disagg_role": "prefill"})
    if warmup is not None:
        d_cfg = dataclasses.replace(d_cfg, warmup=warmup)
        p_cfg = dataclasses.replace(p_cfg, warmup=warmup)
    decode = ServingEngine(api, d_cfg, params, device=device, rm=rm,
                           backend=backend, mesh=mesh)
    pre = ServingEngine(api, p_cfg, params, device=device, rm=rm,
                        backend=backend, mesh=mesh)
    return DisaggOrchestrator(decode, PrefillEngine(pre))
