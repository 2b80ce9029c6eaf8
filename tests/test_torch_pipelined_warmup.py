"""Warmup as CUDA graphs on the pipelined backend, and the swap I/O as
managed functions on both backends (``ServingEngine.warmup``, the port of
the reference's layout tour, swap-I/O warm and null decode tick).

(b) ``_swap_targets`` equals the reference's own method, called unbound on
    a stub, over layer counts, stage counts, planned layouts and
    ``warmup_layouts``.
(c) On reduced llama3.2-1b in f32, seal on and off, a warmed pipelined
    engine serves a cold one's greedy streams under a churn that
    swap-preempts and forks, with no post-freeze stall; its inventory holds
    ``step{layout}`` and ``probe{layout}`` (one signature per stage) for
    the planned and every toured layout, and the swap I/O. The cold
    pipelined engine is held to the reference's streams by
    tests/test_torch_pipeline.py, so this holds the warmed one there too.
(d) After warmup, boundary swaps onto toured layouts and back record no
    stall and keep the streams; a straggler-driven live swap on a warmed
    engine keeps the undisturbed run's streams (``SWAP-EXACT``).
(e) No (key, counter) pair is sealed twice over a warmup and the serve
    that follows, fault-free and under a chaotic schedule (a device death's
    spill, storms, tampered swap-ins): every stage-boundary seal and every
    swap-out, recorded at the ops boundary.
(f) The scatter drops sentinel rows on the device, at a fixed shape: it
    equals a host-side drop of those rows and leaves the null page zero.
(g) On the card (marker ``cuda``): replayed pipelined steps and swap I/O
    give logits and final pools bit-equal to eager, with equal launches.
(h) An engine without warmup keeps its stage probes in a registry of
    their own, entered at construction, out of its graph count; on the
    card they are graphs, and every telemetry tick replays one.
"""
import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.enclave import sealing
from repro_torch.kernels import ops
from repro_torch.kernels.seal import u32
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine
from test_torch_warmup import ENGINE, _assert_zero_post_warmup, _drive, \
    _workload

# the warmup tests' engine, pipelined over two stages, telemetry too rare
# to re-plan (a re-plan from timing noise would move sealed boundaries)
PIPE = dict(ENGINE, num_stages=2, num_pages=14, telemetry_interval=1000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    api = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                      dtype=torch.float32)
    return api, api.init(torch.Generator().manual_seed(1))


def _engine(api, params, device="cpu", **kw):
    return ServingEngine(api, EngineConfig(**{**PIPE, **kw}), params,
                         device=device, backend="pipelined")


def _churn(api):
    return _workload(23, 20, api.cfg.vocab_size, 16, shared_ratio=0.5)


# ---------------------------------------------------------------------------
# (b) the layout tour's targets
# ---------------------------------------------------------------------------
def _compositions(n, S):
    for cuts in itertools.combinations(range(1, n), S - 1):
        bounds = (0,) + cuts + (n,)
        yield tuple(b - a for a, b in zip(bounds, bounds[1:]))


PLANS = [(n, S, planned) for n in (4, 16) for S in (2, 3)
         for planned in list(_compositions(n, S))[::max(1, n * S // 4)][:3]]


@pytest.mark.parametrize("warmup_layouts", [1, 8, 100])
@pytest.mark.parametrize("n,S,planned", PLANS)
def test_swap_targets_equal_the_reference(n, S, planned, warmup_layouts):
    pytest.importorskip("jax")
    from repro.serving.engine import ServingEngine as JEngine
    seg = types.SimpleNamespace(n=n)
    stub = types.SimpleNamespace(
        api=types.SimpleNamespace(
            cfg=types.SimpleNamespace(num_layers=n),
            model=types.SimpleNamespace(segments=[seg],
                                        served_segment=seg)),
        config=types.SimpleNamespace(num_stages=S,
                                     warmup_layouts=warmup_layouts),
        stage_blocks=planned)
    want = JEngine._swap_targets(stub)
    assert ServingEngine._swap_targets(stub) == want
    assert planned not in want and all(sum(t) == n for t in want)


# ---------------------------------------------------------------------------
# (c) warmed = cold, and the inventory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seal", [True, False])
def test_warmed_pipelined_engine_serves_cold_streams(model, seal):
    api, params = model
    wl = _churn(api)
    cold = _engine(api, params, seal_boundary=seal)
    want = _drive(cold, wl)
    eng = _engine(api, params, seal_boundary=seal, warmup=True)
    assert _drive(eng, wl) == want
    _assert_zero_post_warmup(eng)
    st, cs = eng.stats(), cold.stats()
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0
    assert st["cow_hits"] > 0 and st["forks"] > 0
    for k in ("steps", "swap_outs", "swap_ins", "cow_hits", "forks",
              "preemptions", "prefill_calls", "admissions", "stage_blocks",
              "swaps"):
        assert st[k] == cs[k], (k, st[k], cs[k])
    planned = eng.stage_blocks
    toured = eng._swap_targets()
    assert planned == (1, 3) and toured == [(2, 2), (3, 1)]
    sigs = {n: len(f.signatures) for n, f in eng.aot.fns.items()}
    for layout in [planned] + toured:
        assert sigs[f"step{layout}"] == 1, (layout, sigs)
        assert sigs[f"probe{layout}"] == PIPE["num_stages"], (layout, sigs)
    assert sigs["gather_pages"] == sigs["scatter_pages"] == 1
    assert "decode_step" not in sigs


# ---------------------------------------------------------------------------
# (d) tour, then swap
# ---------------------------------------------------------------------------
def test_swaps_onto_toured_layouts_record_no_stall(model):
    """Unsealed, so the streams do not depend on where the boundaries
    sit: swaps onto both toured layouts and back, with telemetry probes on
    each, keep the streams of a run that never moves, with no stall."""
    api, params = model
    wl = _churn(api)
    want = _drive(_engine(api, params, seal_boundary=False), wl)
    eng = _engine(api, params, seal_boundary=False, warmup=True)
    moves = {3: (2, 2), 7: (3, 1), 11: (1, 3)}
    orig_step = eng.step

    def step():
        if eng.steps in moves:
            assert eng.try_swap(moves[eng.steps])
            eng.backend.stage_times()
        return orig_step()

    eng.step = step
    assert _drive(eng, wl) == want
    assert eng.swaps == 3 and eng.stage_blocks == (1, 3)
    assert eng.stats()["swap_ins"] > 0
    _assert_zero_post_warmup(eng)


def test_warmed_live_swap_streams_exact():
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--stages", "2", "--microbatches", "2", "--slots", "4",
            "--requests", "6", "--max-new", "8", "--no-seal", "--f32",
            "--inject-straggler", "1:10", "--verify-swap", "--warmup",
            "--assert-no-recompile"]
    st = serve.main(argv)     # asserts SWAP-EXACT and NO-RECOMPILE
    assert st["swaps"] >= 1 and st["backend"] == "pipelined"
    assert st["warmed"] and st["post_warmup_compiles"] == 0
    assert st["stage_blocks"] == (3, 1) and st["completed"] == 6


# ---------------------------------------------------------------------------
# (e) no (key, counter) pair sealed twice
# ---------------------------------------------------------------------------
@pytest.fixture
def pairs(monkeypatch):
    """Every (key, counter) that ``ops.seal`` (stage boundaries) and
    ``ops.seal_bits`` (swap-outs) cipher under, as uint32 ints."""
    seen = []
    for name in ("seal", "seal_bits"):
        real = getattr(ops, name)

        def spy(x, key, counter, _real=real, _name=name):
            seen.append((int(u32(key)), int(u32(counter))))
            return _real(x, key, counter)

        monkeypatch.setattr(ops, name, spy)
    return seen


def test_no_keystream_reuse_across_warmup_and_serve(model, pairs):
    api, params = model
    eng = _engine(api, params, warmup=True)
    warm = len(pairs)
    _drive(eng, _churn(api))
    st = eng.stats()
    assert warm > 0 and st["swap_outs"] > 0
    assert len(pairs) - warm >= st["steps"]
    assert len(set(pairs)) == len(pairs), \
        [p for p in set(pairs) if pairs.count(p) > 1][:5]


def test_no_keystream_reuse_under_chaos(model, pairs):
    """The same warmup and churn under a chaotic schedule: a device death
    spills every active slot and storms preempt under pressure, each
    through a new swap sequence; tampered swap-ins re-prefill and seal
    nothing. Still no (key, counter) pair twice."""
    from repro_torch.serving import FaultConfig
    api, params = model
    eng = _engine(api, params, warmup=True, telemetry_interval=4,
                  allow_swap=False,
                  faults=FaultConfig.chaos(seed=2, device_death=1.0,
                                           pool_storm=0.3))
    warm = len(pairs)
    _drive(eng, _churn(api))
    st = eng.stats()
    assert warm > 0 and st["swap_outs"] > 0
    assert st["recovery"]["device_loss_spills"] > 0
    assert st["faults"]["pool_storm"] > 0
    assert st["stage_blocks"] == eng.stage_blocks
    assert len(set(pairs)) == len(pairs), \
        [p for p in set(pairs) if pairs.count(p) > 1][:5]


# ---------------------------------------------------------------------------
# (f) the device-side scatter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_scatter_equals_host_drop(model, seed):
    api, params = model
    eng = ServingEngine(api, EngineConfig(**{**PIPE, "num_pages": 12}),
                        params, device="cpu")
    be = eng.backend
    rng = np.random.RandomState(seed)
    pools = be.cache["blocks"]
    for pool in pools:
        pool.copy_(torch.from_numpy(rng.randn(*pool.shape).astype(
            np.float32)))
        pool[:, 0] = 0
    before = [p.clone() for p in pools]
    MP, N = be.pages_per_slot, be.num_pages
    # distinct live pages, the rest on the sentinel, in random order
    pages = np.full(MP, N, np.int32)
    live = rng.choice(MP, size=rng.randint(1, min(MP, N - 1)), replace=False)
    pages[live] = rng.choice(np.arange(1, N), size=len(live), replace=False)
    row = pools[0].shape[0] * int(np.prod(pools[0].shape[2:]))
    payload = [torch.from_numpy(rng.randn(MP, row).astype(np.float32))
               for _ in pools]
    key, seq = 0xC0FFEE, 9
    ciphers = [sealing.seal_pages(p, key, seq, part=i)
               for i, p in enumerate(payload)]
    be.scatter_pages(*ciphers, pages, key, seq)
    keep = np.nonzero(pages < N)[0]
    for pool, want, rows in zip(pools, before, payload):
        g = rows.reshape(MP, pool.shape[0], *pool.shape[2:])
        want[:, torch.from_numpy(pages[keep]).long()] = \
            g[torch.from_numpy(keep)].transpose(0, 1)
        assert torch.equal(pool, want)
        assert not pool[:, 0].any()


# ---------------------------------------------------------------------------
# (g) on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seal", [True, False])
def test_replayed_pipelined_step_and_swap_io_bit_equal_eager(cuda, seal):
    api = build_model(reduced(get_arch("llama3.2-1b")), device=cuda,
                      dtype=torch.float32)
    params = api.init(torch.Generator(device=cuda).manual_seed(0))
    wl = _workload(41, 14, api.cfg.vocab_size, 16, shared_ratio=0.5)
    runs = []
    for warm in (False, True):
        eng = _engine(api, params, device=cuda, seal_boundary=seal,
                      warmup=warm)
        seen, be = [], eng.backend
        step = be.step
        be.step = lambda *a: seen.append(step(*a).clone()) or seen[-1]
        ops.reset_launch_counts()
        streams = _drive(eng, wl)
        torch.cuda.synchronize()
        runs.append((streams, seen, dict(ops.LAUNCHES), eng))
    (s0, l0, n0, cold), (s1, l1, n1, warmed) = runs
    _assert_zero_post_warmup(warmed)
    assert warmed.stats()["graphs"] > 0 and cold.stats()["graphs"] == 0
    assert warmed.stats()["swap_ins"] > 0
    assert s1 == s0
    assert len(l1) == len(l0) and all(torch.equal(a, b)
                                      for a, b in zip(l0, l1))
    for a, b in zip(cold.backend.cache["blocks"],
                    warmed.backend.cache["blocks"]):
        assert torch.equal(a, b)
    assert n1 == n0 and n1["paged_attention"] > 0 and n1["seal_bits"] > 0
    assert (n1["seal"] > 0) == seal


# ---------------------------------------------------------------------------
# (h) the stage probes of an engine without warmup
# ---------------------------------------------------------------------------
def test_unwarmed_engine_enters_its_probes_apart(model):
    api, params = model
    eng = _engine(api, params)
    be = eng.backend
    assert not eng.aot.capture and be._probe_aot is not eng.aot
    assert not any(name.startswith("probe") for name in eng.aot.fns)
    probe = be._probe_aot.fns[f"probe{eng.stage_blocks}"]
    assert len(probe.signatures) == PIPE["num_stages"] and not probe.graphs
    times = be.stage_times()
    assert len(times) == PIPE["num_stages"] and min(times) > 0
    assert be._probe_aot.stalls == [] and eng.stats()["graphs"] == 0
    warmed = _engine(api, params, warmup=True)
    assert warmed.backend._probe_aot is warmed.aot


@pytest.mark.cuda
def test_unwarmed_engine_replays_its_probes(cuda):
    """Each stage's probe is captured at construction; ticks replay it and
    count its launches; the engine's own ledger stays graph-free."""
    api = build_model(reduced(get_arch("llama3.2-1b")), device=cuda,
                      dtype=torch.float32)
    params = api.init(torch.Generator(device=cuda).manual_seed(0))
    eng = _engine(api, params, device=cuda)
    be = eng.backend
    probe = be._probe_aot.fns[f"probe{eng.stage_blocks}"]
    assert probe.graphs == PIPE["num_stages"]
    captures = be._probe_aot.captures
    ops.reset_launch_counts()
    times = be.stage_times()
    assert len(times) == PIPE["num_stages"] and min(times) > 0
    assert be._probe_aot.captures == captures
    assert ops.LAUNCHES["paged_attention"] == api.cfg.num_layers
    assert eng.stats()["graphs"] == 0
