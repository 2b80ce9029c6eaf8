"""Disaggregated prefill/decode of the PyTorch port (``serving/disagg.py``)
against the JAX package, on the CPU in f32 at reduced width.

Mirrors tests/test_disagg.py on the port: the transfer counter space is
disjoint from the swap space; a transfer seal round-trips bit for bit and
its cipher bytes equal the reference's; the transfer ledger pins, demotes
and drops; the port's disaggregated streams equal the reference engine's
monolithic streams (basic, finished at prefill, back-pressure, COW
adoption of shared prefixes, packed prefill on the prefill role, and the
reference's three tight-pool cases with both roles' scheduler, pool and
ledger invariants audited every tick), on reduced llama3.2-1b and on a GQA
variant; the no-peer fallback equals the monolithic engine; the port's
role plan equals the reference's on its three topologies.

Beyond the reference's file: a payload flipped or truncated in transit
falls back to a re-prefill (``unseal_fallback_transfer``) and a handoff
past its deadline demotes to one (``handoff_reprefills``), streams
unchanged; ``run_trace`` of the engine and of the orchestrator equal the
reference's over idle gaps; a manifest the reference's prefill role
exported serves the reference's stream in the port's decode role; no (key,
counter) pair is ciphered twice across both roles (warmup, swaps on both
roles, handoffs; local and pipelined backends); the serve launcher's
disaggregated and preemption checks pass on the CPU.

The test marked ``cuda`` skips here: on the card a warmed pair's replayed
export and transfer-in equal eager bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops
from repro_torch.kernels.seal import u32
from repro_torch.launch import serve
from repro_torch.serving import (HANDOFF, DisaggOrchestrator, EngineConfig,
                                 FaultConfig, FaultPlane, PagePool, Request,
                                 ServingEngine, build_disagg,
                                 plan_disagg_roles)
from repro_torch.serving.scheduler import DONE
from test_torch_chunked_prefill import _models

# the reference test's engine (tests/test_disagg.py::_BASE, less the
# timeline horizon and the stage seal, which the local backend ignores)
BASE = dict(num_slots=4, num_microbatches=2, prompt_capacity=16,
            telemetry_interval=4, page_size=4, request_capacity=24)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread runs them faster and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32():
    """Exact token comparisons need f32 end to end (params and caches)."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.models.layers as L
    old = L.DEFAULT_DTYPE
    L.DEFAULT_DTYPE = jnp.float32
    yield
    L.DEFAULT_DTYPE = old


@pytest.fixture(scope="module")
def llama(f32):
    return _models(None, 0)


@pytest.fixture(scope="module")
def gqa(f32):
    return _models(2, 1)


@pytest.fixture(scope="module", params=["llama", "gqa"])
def models(request):
    return request.getfixturevalue(request.param)


def _engine(tapi, tparams, **kw):
    return ServingEngine(tapi, EngineConfig(**{**BASE, **kw}), tparams,
                         device="cpu", backend="local")


def _orch(tapi, tparams, prefill_overrides=None, backend="local", **kw):
    return build_disagg(tapi, tparams, config=EngineConfig(**{**BASE, **kw}),
                        prefill_overrides=prefill_overrides, backend=backend,
                        device="cpu")


def _jax_cfg(**kw):
    from repro.serving import EngineConfig as JCfg
    return JCfg(max_seq=128, seal_boundary=False, **{**BASE, **kw})


def _jax_engine(japi, jparams, **kw):
    from repro.serving import ServingEngine as JEngine
    return JEngine(japi, config=_jax_cfg(**kw), params=jparams,
                   backend="local")


def _drive_eng(eng, wl, max_steps=900):
    reqs, k, gap = [], 0, 0
    while k < len(wl) or eng.scheduler.has_work():
        if k < len(wl) and gap <= 0:
            prompt, max_new, eos, gap = wl[k]
            reqs.append(eng.submit(prompt, max_new, eos_id=eos))
            k += 1
        else:
            gap -= 1
        eng.step()
        assert eng.steps < max_steps, "schedule failed to drain"
    assert all(r.status == DONE for r in reqs)
    return [list(r.generated) for r in reqs]


def _drive_orch(orch, wl, max_steps=900):
    """Submit with arrival gaps; audit BOTH engines' scheduler, pool and
    transfer-ledger invariants after every orchestrator tick."""
    reqs, k, gap, steps = [], 0, 0, 0
    while k < len(wl) or orch.has_work():
        if k < len(wl) and gap <= 0:
            prompt, max_new, eos, gap = wl[k]
            reqs.append(orch.submit(prompt, max_new, eos_id=eos))
            k += 1
        else:
            gap -= 1
        orch.step()
        orch.check_invariants()
        steps += 1
        assert steps < max_steps, "disagg schedule failed to drain"
    assert all(r.status == DONE for r in reqs)
    assert not orch.decode.pool.transfer_manifest, "undrained transfers"
    return [list(r.generated) for r in reqs]


def _wl(seed, vocab, lens):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=n).tolist(), m, None, g)
            for n, m, g in lens]


def _workload(rng, vocab, n, share_ratio):
    """The reference property's schedules (tests/test_disagg.py)."""
    base = rng.randint(0, vocab, size=8).tolist()
    wl = []
    for _ in range(n):
        if rng.rand() < share_ratio:
            prompt = base + rng.randint(
                0, vocab, size=int(rng.randint(1, 5))).tolist()
        else:
            prompt = rng.randint(0, vocab,
                                 size=int(rng.randint(2, 13))).tolist()
        eos = int(rng.randint(0, vocab)) if rng.rand() < 0.4 else None
        wl.append((prompt, int(rng.randint(1, 9)), eos,
                   int(rng.randint(0, 3))))
    return wl


# ---------------------------------------------------------------------------
# counter spaces and the sealed transfer
# ---------------------------------------------------------------------------
def test_transfer_counter_space_disjoint_from_swap():
    swap = {sealing._swap_counter(s, p)
            for s in (0, 1, 7, sealing.TRANSFER_SEQ_BASE - 1) for p in (0, 1)}
    xfer = {sealing._swap_counter(sealing.transfer_seq(n), p)
            for n in (0, 1, 7, sealing.TRANSFER_SEQ_BASE - 1) for p in (0, 1)}
    assert not swap & xfer
    assert all(c & 0x80000000 for c in swap)
    assert not any(c & 0x80000000 for c in xfer)
    for bad in (sealing.TRANSFER_SEQ_BASE, -1):
        with pytest.raises(ValueError):
            sealing.transfer_seq(bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sealed_transfer_roundtrip_bit_exact_and_equals_reference(dtype):
    """A transfer seal opens bit for bit, its K and V planes and the swap
    seal at the same n differ, and its cipher bytes are the reference's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.enclave import sealing as jseal
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(5, 64).astype(np.float32)).to(dtype)
    key, seq = 0xC0FFEE, sealing.transfer_seq(2)
    ck = sealing.seal_pages(x, key, seq, part=0)
    cv = sealing.seal_pages(x, key, seq, part=1)
    assert not torch.equal(ck, cv)
    back = sealing.unseal_pages(ck, key, seq, dtype, part=0)
    assert torch.equal(back, x)
    assert not torch.equal(ck, sealing.seal_pages(x, key, 2, part=0))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(x.float().numpy()).astype(jdt)
    want = np.asarray(jseal.seal_pages(jx, jax.numpy.uint32(key), seq,
                                       part=1))
    np.testing.assert_array_equal(sealing.cipher_to_host(cv), want)


def test_transfer_manifest_ledger_pins_and_demotes():
    pool = PagePool(num_pages=16, page_size=4)
    shared = pool.alloc(1)[0]
    pool.register_prefix(("k",) * 4, shared)
    pool.release([shared])
    assert pool.lookup_prefix(("k",) * 4) == shared     # the manifest pin
    assert pool.refcount[shared] == 2
    payload = (np.zeros((3, 8), np.uint32), np.zeros((3, 8), np.uint32))
    entries = [("shared", (("k",) * 4, shared)),
               ("sealed", (1, None)), ("sealed", (2, None))]
    pool.register_transfer(7, entries, payload, n_tokens=12, counter=5)
    assert pool.has_transfer(7) and pool.pending_transfers == 1
    pool.check_invariants({})
    assert pool.demote_transfer(7) == 1
    man = pool.transfer_manifest[7]
    assert man.shared_pages == 0 and man.sealed_pages == 3
    assert man.entries == [("sealed", (0, ("k",) * 4)),
                           ("sealed", (1, None)), ("sealed", (2, None))]
    pool.check_invariants({})
    assert pool.transfer_demotions == 1
    assert pool.transfer_in(7) is man and not pool.has_transfer(7)
    assert pool.stats()["transfers_in"] == 1
    assert pool.refcount[shared] == 1           # the index's reference
    pool.check_invariants({})


def test_transfer_drop_releases_pins_and_audit_counts_them():
    pool = PagePool(num_pages=8, page_size=4)
    shared = pool.alloc(1)[0]
    pool.register_prefix(("p",) * 4, shared)
    pool.release([shared])
    pool.lookup_prefix(("p",) * 4)
    payload = (np.zeros((1, 8), np.uint32), np.zeros((1, 8), np.uint32))
    pool.register_transfer(3, [("shared", (("p",) * 4, shared))], payload,
                           n_tokens=4, counter=1)
    assert pool.refcount[shared] == 2
    pool.check_invariants({})
    pool.refcount[shared] -= 1                  # a lost pin is caught
    with pytest.raises(AssertionError):
        pool.check_invariants({})
    pool.refcount[shared] += 1
    pool.drop_transfer(3)
    assert not pool.has_transfer(3) and pool.refcount[shared] == 1
    pool.check_invariants({})


def test_scheduler_adopt_and_handoff():
    from repro_torch.serving import SlotScheduler
    sch = SlotScheduler(2)
    req = sch.adopt(Request(5, (1, 2), 3))
    assert sch.submit([3], 1).rid == 6          # rids advance past adopted
    slot, got = sch.admit_next(step=2)
    assert got is req
    req.generated.append(9)
    assert sch.handoff(slot, step=3) is req
    assert req.status == HANDOFF and req.slot is None
    assert sch.free_slots == 2 and sch.stats()["completed"] == 0
    sch.check_invariants()
    with pytest.raises(AssertionError):
        sch.adopt(Request(7, (1,), 1, status=DONE))
    assert sch.adopt(req).status == "queued"    # a demoted handoff


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_roles_accepted_later_slices_still_refused():
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import build_model
    tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                       dtype=torch.float32)
    params = tapi.init(torch.Generator().manual_seed(0))
    for role in ("", "prefill", "decode"):
        assert _engine(tapi, params, disagg_role=role).stats()[
            "disagg_role"] == role
    with pytest.raises(ValueError, match="disagg_role"):
        _engine(tapi, params, disagg_role="both")
    with pytest.raises(ValueError, match="demand"):
        _engine(tapi, params, disagg_role="decode", page_policy="reserve")
    for kw, name in ((dict(kv_layout="timeline"), "kv_layout"),
                     (dict(batched_prefill=False), "batched_prefill")):
        with pytest.raises(NotImplementedError, match=name):
            _engine(tapi, params, **kw)
    # the fault plane is ported: a FaultConfig is taken, anything else is
    # refused by name
    with pytest.raises(TypeError, match="faults"):
        _engine(tapi, params, faults=object())
    assert _engine(tapi, params, disagg_role="decode",
                   faults=FaultConfig()).stats()["faults"] == \
        FaultPlane(FaultConfig()).snapshot()
    eng = _engine(tapi, params, disagg_role="prefill")
    assert eng._swap_seq == sealing.TRANSFER_SEQ_BASE // 2
    assert set(eng.stats()["recovery"]) == {
        "unseal_fallback_swap", "unseal_fallback_transfer",
        "device_loss_spills", "device_loss_replans", "stall_replans",
        "storm_preemptions", "storm_reclaims", "handoff_retries",
        "handoff_redeliveries", "handoff_reprefills"}


# ---------------------------------------------------------------------------
# disagg == the reference's monolithic engine
# ---------------------------------------------------------------------------
def test_disagg_matches_reference_monolithic_basic(models):
    japi, jparams, tapi, tparams = models
    wl = _wl(0, tapi.cfg.vocab_size, ((5, 6, 0), (3, 4, 1), (9, 7, 0),
                                      (2, 5, 2)))
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    orch = _orch(tapi, tparams)
    assert _drive_orch(orch, wl) == mono
    st = orch.stats()
    assert st["handoffs"] == st["transfers_in"] == len(wl)
    assert st["prefill_stats"]["transfers_out"] == len(wl)
    assert st["disagg_role"] == "decode" and st["pending_handoffs"] == 0


def test_fallback_without_prefill_peer_matches_monolithic(llama):
    japi, jparams, tapi, tparams = llama
    wl = _wl(1, tapi.cfg.vocab_size, ((4, 5, 0), (7, 5, 0), (3, 5, 0)))
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    orch = DisaggOrchestrator(_engine(tapi, tparams))
    assert _drive_orch(orch, wl) == mono
    assert orch.stats()["handoffs"] == 0 and orch.stats()["disagg"] is False


def test_finished_at_prefill_never_ships(llama):
    japi, jparams, tapi, tparams = llama
    wl = _wl(2, tapi.cfg.vocab_size, ((6, 1, 0), (4, 5, 0)))
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    orch = _orch(tapi, tparams)
    assert _drive_orch(orch, wl) == mono
    st = orch.stats()
    assert st["handoffs"] == 1 and st["prefill_completed"] == 1


def test_backpressure_holds_prompts_at_prefill(llama):
    japi, jparams, tapi, tparams = llama
    rng = np.random.RandomState(3)
    wl = [(rng.randint(0, tapi.cfg.vocab_size, size=int(n)).tolist(), 6,
           None, 0) for n in rng.randint(2, 10, size=6)]
    mono = _drive_eng(_jax_engine(japi, jparams, num_slots=1,
                                  num_microbatches=1), wl)
    orch = _orch(tapi, tparams, num_slots=1, num_microbatches=1)
    assert _drive_orch(orch, wl) == mono
    assert orch.stats()["backpressure_events"] > 0


def test_disagg_adopts_shared_prefixes_cow(models):
    japi, jparams, tapi, tparams = models
    rng = np.random.RandomState(4)
    base = rng.randint(0, tapi.cfg.vocab_size, size=8).tolist()  # two pages
    wl = [(base + [1], 5, None, 0), (base + [2], 5, None, 2)]
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    orch = _orch(tapi, tparams)
    assert _drive_orch(orch, wl) == mono
    assert orch.decode.pool.cow_hits > 0
    adopted = [e.detail for e in orch.decode.events
               if e.kind == "handoff_in"]
    assert adopted[1]["shared"] == 2 and adopted[0]["shared"] == 0


def test_disagg_with_packed_prefill(models):
    japi, jparams, tapi, tparams = models
    rng = np.random.RandomState(6)
    wl = [(rng.randint(0, tapi.cfg.vocab_size, size=int(n)).tolist(), 5,
           None, 0) for n in rng.randint(2, 10, size=6)]
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    orch = _orch(tapi, tparams, prefill_overrides={"prefill_pack": 3})
    assert _drive_orch(orch, wl) == mono
    assert orch.stats()["prefill_stats"]["packed_admissions"] > 0
    # a burst queued before the first tick packs several prompts a call
    burst = _orch(tapi, tparams, prefill_overrides={"prefill_pack": 3})
    reqs = [burst.submit(p, m) for p, m, _, _ in wl]
    assert [r.rid for r in burst.run()] == [r.rid for r in reqs]
    assert [list(r.generated) for r in reqs] == mono
    ps = burst.stats()["prefill_stats"]
    assert ps["packed_admissions"] > ps["packed_prefills"] > 0


@pytest.mark.parametrize("seed,num_pages,share_ratio",
                         [(11, 9, 0.0), (23, 11, 0.5), (37, 14, 0.9)])
def test_disagg_tight_pool_matches_reference_monolithic(llama, seed,
                                                        num_pages,
                                                        share_ratio):
    """The reference's tight-pool cases: a tight decode pool swap-preempts
    transferred-in requests; streams equal the reference's roomy
    monolithic engine's and both roles' host tiers drain."""
    japi, jparams, tapi, tparams = llama
    rng = np.random.RandomState(seed)
    wl = _workload(rng, tapi.cfg.vocab_size, int(rng.randint(4, 10)),
                   share_ratio)
    mono = _drive_eng(_jax_engine(japi, jparams, page_policy="reserve"), wl)
    orch = _orch(tapi, tparams, num_pages=num_pages)
    assert _drive_orch(orch, wl) == mono
    assert not orch.decode.pool.swap_manifest
    assert not orch.eng_prefill.pool.swap_manifest


def test_disagg_property_matches_monolithic(llama):
    """The reference's property (hypothesis), few examples: randomized
    admission / EOS / shared-prefix / tight-pool schedules give the
    reference's roomy monolithic streams, every ledger drained."""
    pytest.importorskip("hypothesis", reason="hypothesis not installed")
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st
    japi, jparams, tapi, tparams = llama

    @settings(deadline=None, max_examples=3, print_blob=True,
              suppress_health_check=list(HealthCheck))
    @given(seed=st.integers(0, 2**16 - 1),
           num_pages=st.sampled_from([9, 11, 14, 0]),
           share_ratio=st.sampled_from([0.0, 0.5, 0.9]))
    def prop(seed, num_pages, share_ratio):
        rng = np.random.RandomState(seed)
        wl = _workload(rng, tapi.cfg.vocab_size, int(rng.randint(4, 10)),
                       share_ratio)
        mono = _drive_eng(_jax_engine(japi, jparams, page_policy="reserve"),
                          wl)
        orch = _orch(tapi, tparams, num_pages=num_pages)
        assert _drive_orch(orch, wl) == mono
        assert not orch.decode.pool.swap_manifest
        assert not orch.decode.pool.transfer_manifest
        assert not orch.eng_prefill.pool.swap_manifest

    prop()


# ---------------------------------------------------------------------------
# role planning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("topology,kw", [("default_two_pod_manager", {}),
                                         ("default_two_pod_manager",
                                          {"concurrency": 1}),
                                         ("two_enclave_manager", {})])
def test_plan_disagg_roles_equals_reference(topology, kw):
    pytest.importorskip("jax")
    from repro.configs import get_arch as jax_get_arch
    from repro.enclave import domain as jdomain
    from repro.serving import plan_disagg_roles as jplan
    from repro_torch.configs import get_arch
    from repro_torch.enclave import domain
    got = plan_disagg_roles(getattr(domain, topology)(),
                            get_arch("llama3.2-1b"), **kw)
    want = jplan(getattr(jdomain, topology)(), jax_get_arch("llama3.2-1b"),
                 **kw)
    assert (got.prefill_domain, got.decode_domain) == \
        (want.prefill_domain, want.decode_domain)
    np.testing.assert_allclose([got.latency_s, got.leakage,
                                got.handoff_bytes],
                               [want.latency_s, want.leakage,
                                want.handoff_bytes], rtol=1e-12)
    assert len(got.candidates) == len(want.candidates)
    for a, b in zip(got.candidates, want.candidates):
        assert (a.prefill_domain, a.decode_domain) == \
            (b.prefill_domain, b.decode_domain)
        np.testing.assert_allclose(
            [a.prefill_s, a.seal_s, a.link_s, a.decode_s, a.interference_s,
             a.leakage, a.latency_s],
            [b.prefill_s, b.seal_s, b.link_s, b.decode_s, b.interference_s,
             b.leakage, b.latency_s], rtol=1e-12)
    rm = getattr(domain, topology)()
    assert all(rm.get(c.decode_domain).trusted for c in got.candidates)
    if topology == "default_two_pod_manager" and not kw:
        assert (got.prefill_domain, got.decode_domain) == ("pod1", "pod0")
        assert got.leakage > 0


# ---------------------------------------------------------------------------
# the fallbacks: a tampered payload, a handoff past its deadline
# ---------------------------------------------------------------------------
def _flip(payload):
    ck = payload[0].copy()
    ck.reshape(-1)[3] ^= 1
    return (ck, payload[1])


def _truncate(payload):
    return (payload[0][:-1], payload[1])


@pytest.mark.parametrize("tamper", [_flip, _truncate])
def test_tampered_handoff_falls_back_to_reprefill(llama, tamper):
    japi, jparams, tapi, tparams = llama
    wl = _wl(8, tapi.cfg.vocab_size, ((9, 6, 0), (5, 4, 1), (7, 5, 0)))
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    orch = _orch(tapi, tparams)
    ingest = orch.decode.ingest_transfer
    hit = []

    def tamper_first(req, man):
        if not hit:
            hit.append(req.rid)
            man.payload = tamper(man.payload)
        ingest(req, man)

    orch.decode.ingest_transfer = tamper_first
    assert _drive_orch(orch, wl) == mono
    st = orch.stats()
    assert st["recovery"]["unseal_fallback_transfer"] == 1
    assert st["recovery"]["unseal_fallback_swap"] == 0
    assert st["transfers_in"] == len(wl) - 1 and st["handoffs"] == len(wl)
    ev = [e.detail for e in orch.decode.events if e.kind == "unseal_fallback"]
    assert [(d["rid"], d["path"]) for d in ev] == [(hit[0], "transfer")]


def test_handoff_past_deadline_demotes_to_reprefill(llama):
    japi, jparams, tapi, tparams = llama
    wl = _wl(9, tapi.cfg.vocab_size, ((6, 6, 3), (5, 4, 0), (7, 5, 0)))
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    orch = _orch(tapi, tparams)
    pump = orch.prefill.pump
    shipped = []

    def first_handoff_late():
        handoffs, done = pump()
        orch.DEADLINE_TICKS = -1 if handoffs and not shipped \
            else DisaggOrchestrator.DEADLINE_TICKS
        shipped.extend(r.rid for r, _ in handoffs)
        return handoffs, done

    orch.prefill.pump = first_handoff_late
    got = _drive_orch(orch, wl)
    assert got == mono
    st = orch.stats()
    assert st["recovery"]["handoff_reprefills"] == 1
    assert st["handoffs"] == st["transfers_in"] == len(wl) - 1
    assert [e.detail["rid"] for e in orch.decode.events
            if e.kind == "handoff_reprefill"] == [shipped[0]]


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------
def _arrivals(vocab):
    rng = np.random.RandomState(12)
    times = (0, 1, 1, 30, 31, 60)
    return [(t, rng.randint(0, vocab, size=int(rng.randint(2, 12))).tolist(),
             int(rng.randint(2, 7)),
             int(rng.randint(0, vocab)) if i == 4 else None)
            for i, t in enumerate(times)]


def test_run_trace_equals_reference(llama):
    from repro.serving import build_disagg as jax_build_disagg
    japi, jparams, tapi, tparams = llama
    arrivals = _arrivals(tapi.cfg.vocab_size)

    def out(reqs):
        return [(r.rid, list(r.generated), r.submit_step) for r in reqs]

    want = out(_jax_engine(japi, jparams).run_trace(arrivals))
    eng = _engine(tapi, tparams)
    assert out(eng.run_trace(arrivals)) == want
    assert eng.steps > 60                       # fast-forwarded, then served
    jorch = jax_build_disagg(japi, params=jparams, config=_jax_cfg(),
                             backend="local")
    want = out(jorch.run_trace(arrivals))
    orch = _orch(tapi, tparams)
    assert out(orch.run_trace(arrivals)) == want
    assert orch.stats()["handoffs"] == jorch.stats()["handoffs"] == 6
    assert [r[1] for r in want] == [r[1] for r in out(
        _engine(tapi, tparams).run_trace(arrivals))]


# ---------------------------------------------------------------------------
# a manifest from the reference's prefill role
# ---------------------------------------------------------------------------
def test_reference_manifest_ingested_by_port_decode_role(models):
    """The two packages seal a page row alike (same counter, same uint
    payload dtype, same row layout, same digest): the reference's prefill
    role exports, the port's decode role verifies, unseals and decodes
    on, and the streams are the reference's monolithic ones."""
    from repro.serving import build_disagg as jax_build_disagg
    japi, jparams, tapi, tparams = models
    rng = np.random.RandomState(13)
    base = rng.randint(0, tapi.cfg.vocab_size, size=8).tolist()
    wl = [(base + [3], 6, None, 0), (base[:5], 1, None, 0),
          (rng.randint(0, tapi.cfg.vocab_size, size=11).tolist(), 7, None,
           1), (base + [4, 5], 5, None, 0)]
    mono = _drive_eng(_jax_engine(japi, jparams), wl)
    jorch = jax_build_disagg(japi, params=jparams, config=_jax_cfg(),
                             backend="local")
    dec = _engine(tapi, tparams, disagg_role="decode")
    jreqs, port, k, gap = [], {}, 0, 0
    while k < len(wl) or jorch.prefill.has_work() \
            or dec.scheduler.has_work():
        if k < len(wl) and gap <= 0:
            prompt, max_new, eos, gap = wl[k]
            jreqs.append(jorch.submit(prompt, max_new, eos_id=eos))
            k += 1
        else:
            gap -= 1
        if jorch.prefill.has_work():
            for jreq, man in jorch.prefill.pump()[0]:
                req = Request(jreq.rid, jreq.prompt, jreq.max_new_tokens,
                              jreq.eos_id, status=HANDOFF,
                              generated=list(jreq.generated))
                port[req.rid] = req
                dec.ingest_transfer(req, man)
        dec.step()
        dec.check_page_invariants()
        assert dec.steps < 300
    got = [list(port[r.rid].generated if r.rid in port else r.generated)
           for r in jreqs]
    assert got == mono
    st = dec.stats()
    assert st["transfers_in"] == len(port) == 3
    assert st["recovery"]["unseal_fallback_transfer"] == 0
    assert st["cow_hits"] > 0


# ---------------------------------------------------------------------------
# no (key, counter) pair ciphered twice across the pair
# ---------------------------------------------------------------------------
@pytest.fixture
def pairs(monkeypatch):
    """Every (key, counter) that ``ops.seal`` (stage boundaries) and
    ``ops.seal_bits`` (swaps and handoffs) cipher under, as uint32 ints."""
    seen = []
    for name in ("seal", "seal_bits"):
        real = getattr(ops, name)

        def spy(x, key, counter, _real=real):
            seen.append((int(u32(key)), int(u32(counter))))
            return _real(x, key, counter)

        monkeypatch.setattr(ops, name, spy)
    return seen


@pytest.mark.parametrize("backend", ["local", "pipelined"])
def test_no_keystream_reuse_across_roles(pairs, backend):
    """Both roles warm up (their swap I/O, and on the pipelined backend
    their sealed decode ticks), both swap (the prefill role when a chunk
    spanning two pages finds the pool dry), and every prompt is handed
    over sealed: no (key, counter) pair occurs twice."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import build_model
    tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                       dtype=torch.float32)
    params = tapi.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(6)
    wl = [(rng.randint(0, 500, size=int(n)).tolist(), int(rng.randint(3, 8)))
          for n in rng.choice([3, 5, 8, 14, 16], size=8)]
    orch = build_disagg(
        tapi, params, config=EngineConfig(**BASE, num_pages=9),
        prefill_overrides=dict(prefill_chunk=8, num_pages=8,
                               prefix_sharing=False),
        backend=backend, device="cpu", warmup=True)
    warm = len(pairs)
    reqs = [orch.submit(p, m) for p, m in wl]
    while orch.has_work():
        orch.step()
        orch.check_invariants()
    assert all(r.status == DONE for r in reqs)
    st, ps = orch.stats(), orch.eng_prefill.stats()
    assert warm > 0 and st["swap_outs"] > 0 and ps["swap_outs"] > 0
    assert st["handoffs"] == len(wl)
    assert len(set(pairs)) == len(pairs), \
        [p for p in set(pairs) if pairs.count(p) > 1][:5]


def test_no_keystream_reuse_across_roles_under_chaos(pairs):
    """The same pair under a chaotic schedule: storms and a device death
    spill slots through new swap sequences, dropped handoffs are re-sent
    with their original sealed manifests, tampered and demoted ones
    re-prefill and seal nothing: still no (key, counter) pair twice."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import build_model
    tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                       dtype=torch.float32)
    params = tapi.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(6)
    wl = [(rng.randint(0, 500, size=int(n)).tolist(), int(rng.randint(3, 8)))
          for n in rng.choice([3, 5, 8, 14, 16], size=8)]
    orch = build_disagg(
        tapi, params, config=EngineConfig(
            **BASE, num_pages=9, faults=FaultConfig.chaos(
                seed=3, drop_handoff=0.4, pool_storm=0.3,
                device_death=0.5)),
        prefill_overrides=dict(prefill_chunk=8, num_pages=8,
                               prefix_sharing=False),
        backend="local", device="cpu", warmup=True)
    reqs = [orch.submit(p, m) for p, m in wl]
    while orch.has_work():
        orch.step()
        orch.check_invariants()
    assert all(r.status == DONE for r in reqs)
    ds = orch.decode.stats()
    inj, rec = ds["faults"], ds["recovery"]
    assert inj["drop_handoff"] > 0 and inj["pool_storm"] > 0
    assert rec["device_loss_spills"] > 0 and ds["swap_outs"] > 0
    assert rec["handoff_retries"] > 0
    assert len(set(pairs)) == len(pairs), \
        [p for p in set(pairs) if pairs.count(p) > 1][:5]


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------
def test_serve_disagg_ci_line(capsys):
    """The reference's CI disaggregated line, on the port's CPU path."""
    st = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--backend", "local", "--slots", "4", "--microbatches",
                     "1", "--requests", "6", "--prompt-len", "8",
                     "--max-new", "8", "--page-size", "4", "--no-seal",
                     "--f32", "--warmup", "--disagg", "--verify-disagg",
                     "--assert-no-recompile"])
    out = capsys.readouterr().out
    assert "DISAGG-EXACT OK" in out and "NO-RECOMPILE OK" in out
    assert st["handoffs"] == 6 and st["disagg"]
    assert st["prefill_stats"]["post_warmup_compiles"] == 0


def test_serve_verify_preempt(capsys):
    """The reference's CI preemption line, on the port's CPU path."""
    st = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--backend", "local", "--slots", "3", "--microbatches",
                     "1", "--requests", "6", "--prompt-len", "6",
                     "--max-new", "14", "--page-size", "4", "--num-pages",
                     "8", "--no-prefix-sharing", "--no-seal", "--f32",
                     "--warmup", "--preempt-policy", "swap",
                     "--verify-preempt", "--assert-no-recompile"])
    out = capsys.readouterr().out
    assert "PREEMPT-EXACT OK" in out and "NO-RECOMPILE OK" in out
    assert st["swap_outs"] > 0 and st["cow_hits"] == 0


def test_serve_arrival_every_and_policies_reach_the_engine():
    args = serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--page-policy", "reserve",
         "--preempt-policy", "recompute", "--no-prefix-sharing",
         "--no-decode-cow", "--arrival-every", "3"])
    cfg = serve.make_config(args)
    assert (cfg.page_policy, cfg.preempt_policy, cfg.prefix_sharing,
            cfg.decode_cow) == ("reserve", "recompute", False, False)
    assert args.arrival_every == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_warmed_pair_export_and_transfer_in_bit_equal_eager():
    """A pair warmed up as CUDA graphs replays every export (gather + seal)
    and transfer-in (unseal + scatter): its payloads, streams, decode
    pools and launch counts equal an eager pair's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import build_model
    cuda = torch.device("cuda")
    api = build_model(reduced(get_arch("llama3.2-1b")), device=cuda,
                      dtype=torch.float32)
    params = api.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(23)
    wl = _workload(rng, api.cfg.vocab_size, 10, 0.5)
    runs = []
    for warm in (False, True):
        orch = build_disagg(api, params,
                            config=EngineConfig(**BASE, num_pages=11),
                            backend="local", device=cuda, warmup=warm)
        sent = []
        ingest = orch.decode.ingest_transfer
        orch.decode.ingest_transfer = \
            lambda req, man: sent.append(man.payload) or ingest(req, man)
        ops.reset_launch_counts()
        streams = _drive_orch(orch, wl)
        torch.cuda.synchronize()
        runs.append((streams, sent, dict(ops.LAUNCHES), orch))
    (s0, p0, n0, cold), (s1, p1, n1, warmed) = runs
    for eng in (warmed.decode, warmed.eng_prefill):
        st = eng.stats()
        assert st["post_warmup_compiles"] == 0 and not st["compile_stalls"]
        assert st["graphs"] > 0
    assert s1 == s0 and len(p1) == len(p0) > 0
    for a, b in zip(p0, p1):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(cold.decode.backend.cache["blocks"],
                    warmed.decode.backend.cache["blocks"]):
        assert torch.equal(a, b)
    assert n1 == n0 and n1["seal_bits"] > 0 and n1["unseal_bits"] > 0
