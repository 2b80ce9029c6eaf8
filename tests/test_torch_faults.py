"""The chaos fault plane and the recovery ladder of the PyTorch port
(``serving/faults.py`` and its hooks in the engine and the orchestrator)
against the JAX package, on the CPU in f32 at reduced width.

(a) The port's ``FaultPlane`` equals the reference's draw for draw: same
    config and seed, the same sequence of site calls, equal return values
    and ledgers, and ``_tamper`` byte-equal on the same payload.
(b) The port's chaotic engines equal the reference's at the reference's
    fixed seeds (``tests/test_faults.py``, ``_chaos_paged_case`` and
    ``_chaos_disagg_case``): equal streams, ``stats()["faults"]``,
    ``stats()["recovery"]`` and sequence of fault events, and streams
    equal to the port's own fault-free run.
(c) One port case per reference rung test, chaos = fault-free with the
    reference's per-step scheduler and pool audits (``_drive_checked``):
    tampered swaps, device death on the local and the pipelined backend,
    storms, the stall classification, handoff drops past the retry
    budget, and the handoff mix.
(d) A warmed engine under chaos replays the cold engine's fault schedule
    and serves the warmed fault-free streams with no post-warmup capture.
(e) ``hypothesis`` properties: random chaos = fault-free, local and
    disaggregated, and swap = recompute = undisturbed (the premise of every
    recompute rung).
(f) The reference's two CI chaos lines on the port's serve launcher.
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.serving import (EngineConfig, FaultConfig, FaultPlane,
                                 ServingEngine, build_disagg)
from repro_torch.serving.scheduler import DONE
from test_torch_chunked_prefill import _models

# the reference test's engine (tests/test_faults.py::_engine), less the
# timeline horizon, which the paged port has no use for
ENGINE = dict(num_slots=4, num_microbatches=2, prompt_capacity=16,
              request_capacity=24, telemetry_interval=4, seal_boundary=False,
              page_size=4, page_policy="demand", preempt_policy="swap",
              allow_swap=False)
# the events the fault plane and the recovery ladder emit
FAULT_EVENTS = ("unseal_fallback", "storm_release", "handoff_reprefill")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread runs them faster and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _StepClock:
    """A host clock that advances 1 ms at every read. Both engines time a
    decode step between two reads of ``time.perf_counter`` and, on the
    local backend, attribute that wall time to the stages by the plan's
    shares; the stage EMAs, and with them the step of a re-plan after an
    injected stall and every fault draw after it, depend on the ratio of
    successive step times. Under a loaded host those ratios vary from run
    to run, so two engines could re-plan at different steps. On this clock
    every decode step takes the same time in both packages."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 1e-3
        return self.now


@pytest.fixture(autouse=True)
def _steady_clock(monkeypatch):
    """One injected clock for the reference's engine and the port's, so
    their schedules of re-plans depend on the step count alone."""
    import repro.serving.engine as jengine
    import repro_torch.serving.engine as tengine
    clock = _StepClock()
    for mod in (jengine, tengine):
        monkeypatch.setattr(mod, "time", clock)


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
def models(f32):
    return _models(None, 0)


@pytest.fixture(scope="module")
def ref():
    """The reference test module's helpers: its workload, its per-step
    audited drive (which also checks every request DONE or failed), its
    accounting property, its engine and its pair."""
    import test_faults
    return test_faults


def _engine(tapi, tparams, backend="local", **kw):
    return ServingEngine(tapi, EngineConfig(**{**ENGINE, **kw}), tparams,
                         device="cpu", backend=backend)


def _orch(tapi, tparams, faults=None):
    """The reference test's pair (tests/test_faults.py::_disagg)."""
    cfg = EngineConfig(num_slots=4, num_microbatches=2, prompt_capacity=16,
                       request_capacity=24, telemetry_interval=4,
                       seal_boundary=False, page_size=4, allow_swap=False,
                       faults=faults)
    return build_disagg(tapi, tparams, config=cfg, backend="local",
                        device="cpu")


def _fault_events(eng):
    return [(e.step, e.kind,
             {k: v for k, v in (e.detail or {}).items() if k != "error"})
            for e in eng.events
            if e.kind.startswith("fault_") or e.kind in FAULT_EVENTS]


# ---------------------------------------------------------------------------
# (a) the plane, draw for draw
# ---------------------------------------------------------------------------
def _site_trace(plane, payload, n=60):
    out = []
    for i in range(n):
        out.append(("death", plane.pick_device_death(["pod1", "pod0"])))
        out.append(("stall", plane.pick_stage_stall(1 + i % 3)))
        out.append(("fate", plane.handoff_fate()))
        out.append(("storm", plane.storm_pages(3 + i % 20)))
        for site in (plane.maybe_tamper_swap, plane.maybe_tamper_transfer):
            parts, mode = site(payload)
            out.append((mode, tuple((p.shape, p.dtype.str,
                                     p.view(np.uint8).tobytes())
                                    for p in parts)))
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=9, device_death=0.3, pool_storm=0.2, max_device_deaths=2),
    dict(seed=4, corrupt_swap=0.5, truncate_transfer=0.6, drop_handoff=0.4,
         delay_handoff=0.5, delay_steps=5, stage_stall=0.3),
    dict(seed=123)])
def test_plane_equals_reference_draw_for_draw(kw):
    from repro.serving.faults import FaultConfig as JFaultConfig
    from repro.serving.faults import FaultPlane as JFaultPlane
    rng = np.random.RandomState(kw["seed"])
    # host payloads as the swap tier holds them: the cipher's uint32 words
    payload = (rng.randint(0, 2**31, size=(3, 40)).astype(np.uint32),
               rng.randint(0, 2**31, size=(3, 40)).astype(np.uint32))
    before = [p.copy() for p in payload]
    mine = FaultPlane(FaultConfig.chaos(**kw))
    theirs = JFaultPlane(JFaultConfig.chaos(**kw))
    assert _site_trace(mine, payload) == _site_trace(theirs, payload)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.total_injected() == theirs.total_injected() > 0
    assert mine.device_deaths == theirs.device_deaths
    assert all(np.array_equal(a, b) for a, b in zip(payload, before))
    mine.reset()
    theirs.reset()
    assert _site_trace(mine, payload, 5) == _site_trace(theirs, payload, 5)


def test_tamper_modifies_copies_and_counts():
    plane = FaultPlane(FaultConfig(seed=1, corrupt_swap=1.0))
    orig = (np.zeros((4, 8), np.float32), np.zeros((4, 8), np.float32))
    out, mode = plane.maybe_tamper_swap(orig)
    assert mode == "corrupt" and plane.injected["corrupt_swap"] == 1
    diff = sum(int(np.sum(a != b)) for a, b in zip(orig, out))
    assert diff == 1 and not orig[0].any() and not orig[1].any()
    out2, mode2 = FaultPlane(FaultConfig(
        seed=1, truncate_swap=1.0)).maybe_tamper_swap(orig)
    assert mode2 == "truncate" and out2[0].shape[0] == 3
    plane = FaultPlane(FaultConfig(seed=0, device_death=1.0,
                                   max_device_deaths=1, pool_storm=1.0,
                                   storm_fraction=1.0))
    assert plane.pick_device_death(["a", "b"]) in ("a", "b")
    assert plane.pick_device_death(["a", "b"]) is None   # cap reached
    assert plane.storm_pages(3) == 0                     # never all of it
    assert 0 < plane.storm_pages(10) <= 8


# ---------------------------------------------------------------------------
# (b) the chaotic engines against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,fault_seed,num_pages,death",
                         [(0, 1, 12, True), (7, 3, 11, False),
                          (21, 9, 16, True)])
def test_chaos_paged_equals_reference(models, ref, seed, fault_seed,
                                      num_pages, death):
    from repro.serving.faults import FaultConfig as JFaultConfig
    japi, jparams, tapi, tparams = models
    rng = np.random.RandomState(seed)
    wl = ref._workload(rng, tapi.cfg.vocab_size, int(rng.randint(4, 9)),
                       lo=6, hi=16)
    kw = dict(seed=fault_seed, pool_storm=0.15,
              device_death=0.5 if death else 0.0)
    jeng = ref._engine(japi, jparams, num_pages=num_pages,
                       faults=JFaultConfig.chaos(**kw))
    want = ref._drive_checked(jeng, wl)
    eng = _engine(tapi, tparams, num_pages=num_pages,
                  faults=FaultConfig.chaos(**kw))
    got = ref._drive_checked(eng, wl)
    calm = ref._drive_checked(_engine(tapi, tparams, num_pages=num_pages), wl)
    assert got == [list(g) for g in want] == calm
    st, jst = eng.stats(), jeng.stats()
    assert st["faults"] == jst["faults"]
    assert st["recovery"] == jst["recovery"]
    assert st["faults_pending"] == jst["faults_pending"]
    assert st["failure_replans"] == jst["failure_replans"]
    assert _fault_events(eng) == _fault_events(jeng)
    assert sum(st["faults"].values()) > 0
    assert not eng.pool.swap_manifest and not eng._storm_pages
    ref._assert_accounted(eng)


@pytest.mark.parametrize("seed,fault_seed", [(2, 5), (13, 17)])
def test_chaos_disagg_equals_reference(models, ref, seed, fault_seed):
    from repro.serving.faults import FaultConfig as JFaultConfig
    japi, jparams, tapi, tparams = models
    rng = np.random.RandomState(seed)
    wl = ref._workload(rng, tapi.cfg.vocab_size, int(rng.randint(4, 8)))
    kw = dict(seed=fault_seed, drop_handoff=0.3, delay_handoff=0.25)
    jorch = ref._disagg(japi, jparams, faults=JFaultConfig.chaos(**kw))
    want = ref._run_disagg(jorch, wl)
    orch = _orch(tapi, tparams, faults=FaultConfig.chaos(**kw))
    got = ref._run_disagg(orch, wl)
    calm = ref._run_disagg(_orch(tapi, tparams), wl)
    assert got == [list(g) for g in want] == calm
    for mine, theirs in ((orch.decode, jorch.decode),
                         (orch.eng_prefill, jorch.prefill.eng)):
        st, jst = mine.stats(), theirs.stats()
        assert st["faults"] == jst["faults"]
        assert st["recovery"] == jst["recovery"]
        assert _fault_events(mine) == _fault_events(theirs)
        ref._assert_accounted(mine)
    assert orch.decode.faults.total_injected() > 0
    assert orch.handoffs == jorch.handoffs
    assert not orch._in_flight and orch.decode.pending_external == 0


# ---------------------------------------------------------------------------
# (c) one port case per reference rung test: chaos = fault-free
# ---------------------------------------------------------------------------
def test_swap_tamper_recompute_fallback_bit_identical(models, ref):
    tapi, tparams = models[2:]
    wl = ref._workload(np.random.RandomState(2), tapi.cfg.vocab_size, 8,
                       lo=8, hi=17)
    base = ref._drive_checked(_engine(tapi, tparams, num_pages=12), wl)
    eng = _engine(tapi, tparams, num_pages=12,
                  faults=FaultConfig(seed=7, corrupt_swap=0.7,
                                     truncate_swap=0.3))
    assert ref._drive_checked(eng, wl) == base
    st = eng.stats()
    assert st["faults"]["corrupt_swap"] > 0 and st["faults"]["truncate_swap"]
    assert st["recovery"]["unseal_fallback_swap"] > 0
    assert not eng.pool.swap_manifest
    ref._assert_accounted(eng)


def test_device_death_spill_replan_resume_bit_identical(models, ref):
    tapi, tparams = models[2:]
    wl = ref._workload(np.random.RandomState(3), tapi.cfg.vocab_size, 6)
    base = ref._drive_checked(_engine(tapi, tparams), wl)
    eng = _engine(tapi, tparams, faults=FaultConfig(seed=5, device_death=1.0,
                                                    max_device_deaths=1))
    assert ref._drive_checked(eng, wl) == base
    st = eng.stats()
    assert st["faults"]["device_death"] == 1
    assert st["recovery"]["device_loss_replans"] == 1
    assert st["recovery"]["device_loss_spills"] > 0
    assert st["failure_replans"] == 1 and len(st["excluded_devices"]) == 1
    ref._assert_accounted(eng)


def test_pool_storm_recovered_and_audited(models, ref):
    tapi, tparams = models[2:]
    wl = ref._workload(np.random.RandomState(4), tapi.cfg.vocab_size, 8)
    base = ref._drive_checked(_engine(tapi, tparams, num_pages=16), wl)
    eng = _engine(tapi, tparams, num_pages=16,
                  faults=FaultConfig(seed=2, pool_storm=0.3,
                                     storm_fraction=0.7, storm_steps=3))
    assert ref._drive_checked(eng, wl) == base
    st = eng.stats()
    assert st["faults"]["pool_storm"] > 0
    assert st["recovery"]["storm_reclaims"] > 0
    assert st["free_pages"] > 0           # nothing leaked to the storm
    ref._assert_accounted(eng)


def test_stall_classification_recoverable_vs_permanent(models):
    """A wedge behind an injected storm is reclaimed by the deadlock
    breaker in the same step and never reads as a stall; a wedge nothing
    in the engine can free is permanent, unless an orchestrator reports
    handoffs in flight for this engine."""
    tapi, tparams = models[2:]
    eng = _engine(tapi, tparams, num_pages=10)
    eng.faults = FaultPlane(FaultConfig(seed=0))
    eng._storm_pages = eng.pool.alloc(eng.pool.free_pages - 1)
    eng._storm_left = 10**9               # the timer never expires here
    assert eng._stall_recoverable()
    req = eng.submit([1, 2, 3, 4, 5, 6, 7, 8], 4)
    eng.step()
    assert not eng.stalled and eng.stall_reason is None
    assert eng.recovery["storm_reclaims"] == 1
    assert [e.kind for e in eng.events][:1] == ["storm_release"]
    eng.run(max_steps=60)
    assert req.status == DONE

    eng2 = _engine(tapi, tparams, num_pages=10)
    assert eng2.pool.alloc(eng2.pool.free_pages - 1) is not None
    req2 = eng2.submit([1, 2, 3, 4, 5, 6, 7, 8], 4)
    eng2.step()
    assert eng2.stalled and eng2.stall_reason == "permanent"
    assert eng2.stats()["stall_reason"] == "permanent"
    eng2.stalled = False
    eng2.pending_external = 1
    eng2.step()
    assert not eng2.stalled and eng2.stall_reason == "recoverable"
    assert eng2.stats()["pending_external"] == 1
    assert req2.status != DONE


def test_handoff_drop_exhausts_retries_then_reprefills(models, ref):
    tapi, tparams = models[2:]
    wl = ref._workload(np.random.RandomState(6), tapi.cfg.vocab_size, 5)
    base = ref._run_disagg(_orch(tapi, tparams), wl)
    orch = _orch(tapi, tparams, faults=FaultConfig(seed=1, drop_handoff=1.0))
    assert ref._run_disagg(orch, wl) == base
    rec, n = orch.decode.recovery, len(wl)
    assert rec["handoff_reprefills"] == n
    assert rec["handoff_retries"] == n * (orch.MAX_ATTEMPTS - 1)
    assert orch.decode.faults.injected["drop_handoff"] \
        == n * orch.MAX_ATTEMPTS
    assert [e.detail["why"] for e in orch.decode.events
            if e.kind == "handoff_reprefill"] == ["retries"] * n
    assert not orch._in_flight and orch.decode.pending_external == 0
    assert orch.handoffs == 0 and orch.decode.stats()["transfers_in"] == 0


def test_handoff_chaos_mix_bit_identical(models, ref):
    tapi, tparams = models[2:]
    wl = ref._workload(np.random.RandomState(8), tapi.cfg.vocab_size, 8)
    base = ref._run_disagg(_orch(tapi, tparams), wl)
    orch = _orch(tapi, tparams, faults=FaultConfig(
        seed=11, drop_handoff=0.4, delay_handoff=0.3,
        corrupt_transfer=0.4, truncate_transfer=0.2))
    assert ref._run_disagg(orch, wl) == base
    inj, rec = orch.decode.faults.snapshot(), orch.decode.recovery
    assert inj["corrupt_transfer"] + inj["truncate_transfer"] \
        == rec["unseal_fallback_transfer"] > 0
    if inj["drop_handoff"]:
        assert rec["handoff_retries"] + rec["handoff_reprefills"] > 0
    if inj["delay_handoff"]:
        assert rec["handoff_redeliveries"] + rec["handoff_reprefills"] > 0
    assert not orch._in_flight


@pytest.mark.parametrize("seal", [False, True])
def test_pipelined_device_death_streams_identical(models, seal):
    """The reference's staged-mesh device death on the port's pipelined
    backend: the stage-hosting domain dies mid-decode, active slots spill
    through the page cipher, the placement re-solves around the corpse,
    and with ``allow_swap`` off the sealed boundaries stay where they were,
    so every stream equals the undisturbed pipelined run."""
    tapi, tparams = models[2:]
    rng = np.random.RandomState(7)
    wl = [(rng.randint(1, tapi.cfg.vocab_size, size=4).tolist(), 10)
          for _ in range(4)]

    def drive(faults):
        eng = _engine(tapi, tparams, backend="pipelined", num_slots=2,
                      num_stages=2, prompt_capacity=8, request_capacity=20,
                      seal_boundary=seal, faults=faults)
        planned = eng.stage_blocks
        reqs, k = [], 0
        while k < len(wl) or eng.scheduler.has_work():
            if k < len(wl):
                reqs.append(eng.submit(*wl[k]))
                k += 1
            eng.step()
            eng.scheduler.check_invariants()
            eng.check_page_invariants()
            assert eng.steps < 400
        assert all(r.status == DONE for r in reqs)
        assert eng.stage_blocks == planned
        return eng, [list(r.generated) for r in reqs]

    _, base = drive(None)
    eng, got = drive(FaultConfig(seed=3, device_death=1.0,
                                 max_device_deaths=1))
    assert got == base
    st = eng.stats()
    assert st["faults"]["device_death"] == 1
    assert st["recovery"]["device_loss_replans"] == 1
    assert st["recovery"]["device_loss_spills"] > 0
    assert st["failure_replans"] == 1 and len(st["excluded_devices"]) == 1
    assert st["swaps"] == 0


# ---------------------------------------------------------------------------
# (d) a warmed engine replays the cold one's fault schedule
# ---------------------------------------------------------------------------
def test_warmed_chaos_zero_post_warmup_captures(models, ref):
    tapi, tparams = models[2:]
    wl = ref._workload(np.random.RandomState(5), tapi.cfg.vocab_size, 8,
                       lo=8, hi=17)
    chaos = dict(seed=13, corrupt_swap=0.5, pool_storm=0.2,
                 device_death=0.3)
    base = ref._drive_checked(_engine(tapi, tparams, num_pages=12,
                                      warmup=True), wl)
    eng = _engine(tapi, tparams, num_pages=12, warmup=True,
                  faults=FaultConfig.chaos(**chaos))
    assert eng.faults.total_injected() == 0      # warmup drew nothing
    cold = _engine(tapi, tparams, num_pages=12,
                   faults=FaultConfig.chaos(**chaos))
    assert ref._drive_checked(eng, wl) == base == ref._drive_checked(cold, wl)
    st, cst = eng.stats(), cold.stats()
    assert st["warmed"] and st["post_warmup_compiles"] == 0
    assert st["compile_stalls"] == []
    assert st["faults"] == cst["faults"] and st["recovery"] == cst["recovery"]
    assert st["faults"]["device_death"] == 1
    assert st["recovery"]["unseal_fallback_swap"] > 0
    ref._assert_accounted(eng)


# ---------------------------------------------------------------------------
# (e) properties
# ---------------------------------------------------------------------------
def _chaos_paged_case(models, ref, seed, fault_seed, num_pages, death):
    tapi, tparams = models[2:]
    rng = np.random.RandomState(seed)
    wl = ref._workload(rng, tapi.cfg.vocab_size, int(rng.randint(4, 9)),
                       lo=6, hi=16)
    base = ref._drive_checked(_engine(tapi, tparams, num_pages=num_pages), wl)
    eng = _engine(tapi, tparams, num_pages=num_pages,
                  faults=FaultConfig.chaos(seed=fault_seed, pool_storm=0.15,
                                           device_death=0.5 if death
                                           else 0.0))
    assert ref._drive_checked(eng, wl) == base
    assert not eng.pool.swap_manifest and not eng._storm_pages
    ref._assert_accounted(eng)


def test_chaos_property_paged_local(models, ref):
    from hypothesis import HealthCheck, given, settings, strategies as st

    @settings(deadline=None, max_examples=5, print_blob=True,
              suppress_health_check=list(HealthCheck))
    @given(seed=st.integers(0, 2**16 - 1),
           fault_seed=st.integers(0, 2**16 - 1),
           num_pages=st.sampled_from([11, 12, 16]), death=st.booleans())
    def prop(seed, fault_seed, num_pages, death):
        _chaos_paged_case(models, ref, seed, fault_seed, num_pages, death)

    prop()


def test_chaos_property_disagg(models, ref):
    from hypothesis import HealthCheck, given, settings, strategies as st
    tapi, tparams = models[2:]

    @settings(deadline=None, max_examples=3, print_blob=True,
              suppress_health_check=list(HealthCheck))
    @given(seed=st.integers(0, 2**16 - 1),
           fault_seed=st.integers(0, 2**16 - 1))
    def prop(seed, fault_seed):
        rng = np.random.RandomState(seed)
        wl = ref._workload(rng, tapi.cfg.vocab_size, int(rng.randint(4, 8)))
        base = ref._run_disagg(_orch(tapi, tparams), wl)
        orch = _orch(tapi, tparams, faults=FaultConfig.chaos(
            seed=fault_seed, drop_handoff=0.3, delay_handoff=0.25))
        assert ref._run_disagg(orch, wl) == base
        for eng in (orch.decode, orch.eng_prefill):
            ref._assert_accounted(eng)
        assert not orch._in_flight

    prop()


def test_swap_property_matches_recompute_and_undisturbed(models, ref):
    """The reference's property (tests/test_swap.py:293) on the port: over
    random admission, EOS, shared-prefix and tight-pool schedules, swap
    resume = the recompute oracle = an undisturbed reserve-policy run,
    audited every step, the host tier drained."""
    from hypothesis import HealthCheck, given, settings, strategies as st
    from test_swap import _shared_prefix_workload
    tapi, tparams = models[2:]
    drive = ref._drive_checked

    @settings(deadline=None, max_examples=3, print_blob=True,
              suppress_health_check=list(HealthCheck))
    @given(seed=st.integers(0, 2**16 - 1),
           num_pages=st.sampled_from([8, 9, 11, 14]),
           share_ratio=st.sampled_from([0.0, 0.5, 0.9]))
    def prop(seed, num_pages, share_ratio):
        rng = np.random.RandomState(seed)
        wl = _shared_prefix_workload(rng, tapi.cfg.vocab_size,
                                     int(rng.randint(4, 10)), share_ratio)
        undisturbed = drive(_engine(tapi, tparams, page_policy="reserve"), wl)
        recompute = drive(_engine(tapi, tparams, num_pages=num_pages,
                                  preempt_policy="recompute"), wl)
        eng = _engine(tapi, tparams, num_pages=num_pages)
        assert drive(eng, wl) == recompute == undisturbed
        assert eng.stats()["swapped_pages"] == 0
        assert not eng.pool.swap_manifest

    prop()


# ---------------------------------------------------------------------------
# (f) the reference's CI chaos lines on the port
# ---------------------------------------------------------------------------
def test_serve_chaos_ci_line(capsys):
    st = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--backend", "local", "--slots", "4", "--microbatches",
                     "1", "--requests", "10", "--prompt-len", "8",
                     "--max-new", "12", "--page-size", "4", "--num-pages",
                     "12", "--no-seal", "--f32", "--warmup", "--seed", "3",
                     "--chaos", "--chaos-death", "0.4", "--verify-recovery",
                     "--assert-no-recompile"])
    out = capsys.readouterr().out
    assert "RECOVERY-EXACT OK" in out and "NO-RECOMPILE OK" in out
    assert st["faults"]["device_death"] == 1 and not st["failed_requests"]


def test_serve_chaos_disagg_ci_line(capsys):
    st = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--backend", "local", "--slots", "4", "--microbatches",
                     "1", "--requests", "8", "--prompt-len", "8",
                     "--max-new", "10", "--page-size", "4", "--no-seal",
                     "--f32", "--seed", "7", "--disagg", "--chaos",
                     "--verify-recovery"])
    out = capsys.readouterr().out
    assert "RECOVERY-EXACT OK" in out
    assert st["disagg"] and st["in_flight_handoffs"] == 0
    assert sum(st["faults"].values()) > 0
