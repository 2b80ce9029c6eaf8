"""The serving engine with one pipeline stage per rank, continued
(``test_torch_engine_ranks.py`` holds it against the reference): sealed
boundaries, chunked and packed prefill, swaps, live re-plans and the serve
launcher over ranks, on reduced llama3.2-1b in f32 on gloo CPU ranks.

(a) Bit for bit against the port's one-card pipelined engine (one thread,
    as each rank runs): every decode step's logits and the streams with
    sealed boundaries on both layouts, with chunked and packed prefill,
    and on a pool tight enough to swap-preempt; there the ranks' first
    swap-out parts, side by side, are the one-card payload byte for byte
    with its digest.
(b) A live swap: an injected straggler re-plans, the layers that change
    owner move between the ranks (``migrated``), a payload swapped out
    before the swap is restored after it (its cipher columns moved first),
    and the streams equal the undisturbed run's.
(c) Every rank's events and ``stats()`` are the same, and no (key,
    counter) pair ciphers twice across swaps, restages, prefill crossings
    and decode boundaries.
(d) The serve launcher with ``--ranks gloo``: the reference's
    ``--verify-swap`` line on two ranks, its non-prefix line on three; a
    data axis, CUDA-graph warmup and the disaggregated pair are refused by
    name; ``restage_cache`` on three ranks (a layer moving past a
    neighbour) equals direct staging.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.enclave import sealing
from repro_torch.launch import rank_jobs as J
from repro_torch.launch import serve
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine
from test_torch_engine_ranks import (PIPE, _workloads, hold_one_card,
                                     hold_restage)

# a pool that swap-preempts (no prefix sharing: a shared page is pinned,
# not sealed), and a straggler whose re-plan (at the
# telemetry tick of step 6) falls between a swap-out and its swap-in (a
# CPU search over seeds and telemetry intervals). The runs held against
# one card never re-plan (NO_REPLAN): a probe's host time on a loaded CPU
# can read as a straggler, and a sealed boundary moved changes the bits
TIGHT = dict(num_slots=4, num_microbatches=2, prompt_capacity=16,
             page_size=4, num_pages=10, prefix_sharing=False,
             seal_boundary=False)
STRAGGLER_TICK = 6
NO_REPLAN = 1000
CHUNKED = dict(num_slots=4, num_microbatches=2, prompt_capacity=24,
               page_size=4, num_pages=14, prefill_chunk=5, prefill_pack=3,
               telemetry_interval=NO_REPLAN)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    cfg = reduced(get_arch("llama3.2-1b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=128)
    return api, api.init(torch.Generator().manual_seed(1))


def _runs(api):
    V = api.cfg.vocab_size
    pipe, _ = _workloads(V)
    rng = np.random.RandomState(3)
    tight = [(rng.randint(0, V, size=int(rng.randint(2, 17))).tolist(),
              int(rng.randint(6, 14))) for _ in range(10)]
    # pairs of short prompts (packed) between pairs of long ones (chunked)
    rng = np.random.RandomState(5)
    long = [(rng.randint(0, V, size=int(
        rng.randint(2, 6) if i % 4 < 2 else rng.randint(6, 25))).tolist(), 8)
        for i in range(10)]
    sealed = dict(PIPE, telemetry_interval=NO_REPLAN)
    runs = {kv: J.ServeRun(EngineConfig(kv_layout=kv, **sealed), pipe,
                           keep_logits=True, max_steps=120)
            for kv in ("paged", "timeline")}
    runs["chunked"] = J.ServeRun(EngineConfig(**CHUNKED), long, every=0,
                                 keep_logits=True)
    runs["tight"] = J.ServeRun(EngineConfig(
        telemetry_interval=NO_REPLAN, **TIGHT), tight, every=1,
        keep_logits=True, check_swaps=True)
    runs["straggler"] = J.ServeRun(EngineConfig(
        telemetry_interval=STRAGGLER_TICK, **TIGHT), tight, every=1,
        inject=(1, 25.0), check_swaps=True)
    return runs


@pytest.fixture(scope="module")
def ranked(port):
    api, params = port
    runs = _runs(api)
    out = spawn(J.serve, 2, backend="gloo", device="cpu",
                args=(J.ServeJob(api.cfg, list(runs.values()),
                                 params=params, max_seq=128),))
    return {name: [r[i] for r in out] for i, name in enumerate(runs)}


@pytest.mark.parametrize("name", ["paged", "timeline", "chunked", "tight"])
def test_sealed_chunked_and_swapping_rank_engines_equal_one_card(
        port, ranked, name):
    api, params = port
    st = hold_one_card(api, params, _runs(api)[name], ranked[name])
    assert st["stage_blocks"] == (1, api.cfg.num_layers - 1)
    assert st["replans"] == st["swaps"] == 0
    if name == "chunked":
        assert st["chunked_admissions"] > 0 and st["swap_outs"] > 0
        assert st["packed_admissions"] > st["packed_prefills"] > 0
    if name == "tight":
        assert st["swap_outs"] > 0 and st["swap_ins"] > 0
        # every swap-in restored its rank's pages bit for bit
        assert all(r["restored"] > 0 and r["moved"] == 0
                   for r in ranked[name])


def test_the_ranks_swap_parts_are_the_one_card_payload(port, ranked):
    api, params = port
    run = _runs(api)["tight"]
    eng = ServingEngine(api, run.config, params, device="cpu",
                        backend="pipelined")
    probe = J.Probe(eng, False)
    J.drive(eng, run)
    want = probe.first_swap
    parts = [r["first_swap"] for r in ranked["tight"]]
    assert want["layout"] is None
    assert all(p["counter"] == want["counter"] for p in parts)
    assert all(p["layout"] == ((0, 1), (1, 4)) for p in parts)
    whole = tuple(np.concatenate([p["payload"][i] for p in parts], axis=1)
                  for i in range(2))
    for a, b in zip(whole, want["payload"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sealing.payload_digest(whole) == want["digest"]


def test_a_live_swap_moves_layers_between_ranks(ranked):
    calm, hot = ranked["tight"], ranked["straggler"]
    for c, h in zip(calm, hot):
        assert h["streams"] == c["streams"]
        st = h["stats"]
        assert st["swaps"] >= 1 and st["swap_outs"] > 0
        assert st["stage_blocks"] != c["stats"]["stage_blocks"]
        assert any(kind == "swap" and d["migrated"]
                   for _, kind, d in h["events"])
        assert h["relayouts"] == h["moved"] >= 1    # a payload crossed it
        assert h["restored"] > 0
    # the rank that gave layers away sent them
    assert sum(b for r in hot for _, b in r["restages"]) > 0


def test_ranks_agree_and_never_reuse_a_keystream(ranked):
    for name, ranks in ranked.items():
        r0, r1 = ranks
        assert r0["events"] == r1["events"], name
        assert r0["stats"] == r1["stats"], name
        assert not J.keystream_reuse([r["keys"] for r in ranks]), name
    # crossings, swaps (windows), restages and decode boundaries all ran
    keys = [k for r in ranked["straggler"] + ranked["paged"]
            for k in r["keys"]]
    assert {k[0] for k in keys} == {"seal", "seal_bits"}
    ctrs = {k[2] for k in keys if k[0] == "seal_bits"}
    spaces = {sealing.CROSSING_SEQ_BASE: 0, sealing.RESTAGE_SEQ_BASE: 0}
    for base in spaces:
        span = range(base, base + sealing.TRANSFER_SEQ_BASE // 8)
        spaces[base] = sum(1 for c in ctrs
                           if (c ^ 0xA5A50000) // 2 in span)
    assert all(spaces.values()), spaces
    assert any(k[4] != k[5] for k in keys)          # a window


# ---------------------------------------------------------------------------
# (d) the launcher over ranks, refusals, restage on three ranks
# ---------------------------------------------------------------------------
ARGV = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
        "--microbatches", "2", "--slots", "4", "--requests", "6",
        "--max-new", "8", "--no-seal", "--f32", "--verify-swap"]


def test_serve_over_ranks_swaps_live_token_exact(capfd):
    st = serve.main(ARGV + ["--stages", "2", "--mesh", "2x1", "--ranks",
                            "gloo", "--inject-straggler", "1:10"])
    out = capfd.readouterr().out
    assert "SWAP-EXACT OK" in out
    assert st["swaps"] >= 1 and st["backend"] == "pipelined"
    assert st["stage_blocks"] == (3, 1) and st["completed"] == 6


def test_serve_non_prefix_plan_on_three_ranks(capfd):
    st = serve.main(ARGV + ["--stages", "3", "--mesh", "3x1", "--ranks",
                            "gloo", "--topology", "sandwich", "--delta",
                            "2.0", "--require-non-prefix",
                            "--inject-straggler", "2:10"])
    out = capfd.readouterr().out
    assert "NON-PREFIX OK" in out and "SWAP-EXACT OK" in out
    assert st["swaps"] >= 1 and len(st["stage_blocks"]) == 3


def refusal_body(ctx, cfg):
    """Each refused rank engine's error, by name, on a (2, 2) mesh."""
    from repro_torch.launch.mesh import make_mesh
    api = build_model(cfg, device="cpu", dtype=torch.float32)
    params = api.init(torch.Generator().manual_seed(0))
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    out = []
    for kw in ({"warmup": True}, {"disagg_role": "decode"}, {}):
        try:
            ServingEngine(api, EngineConfig(**kw), params, device="cpu",
                          backend="pipelined", mesh=mesh)
        except (NotImplementedError, ValueError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


def test_rank_engine_refusals_are_named():
    cfg = reduced(get_arch("llama3.2-1b"))
    for errs in spawn(refusal_body, 4, backend="gloo", device="cpu",
                      args=(cfg,)):
        assert len(errs) == 3, errs
        assert "warmup" in errs[0] and "item 10d" in errs[0]
        assert "disagg" in errs[1] and "item 10d" in errs[1]
        assert "data axis" in errs[2] and "item 10d" in errs[2]
    with pytest.raises(NotImplementedError, match="data axis"):
        serve.main(ARGV + ["--stages", "2", "--mesh", "2x2", "--ranks",
                           "gloo"])
    with pytest.raises(ValueError, match="pipelined"):
        serve.main(ARGV + ["--stages", "2", "--ranks", "gloo", "--backend",
                           "local"])


def test_restage_on_three_ranks_equals_direct_staging():
    hold_restage(3)
