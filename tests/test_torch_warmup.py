"""Warmup as CUDA graphs in the PyTorch port (``repro_torch/serving/aot.py``
and ``ServingEngine.warmup``), against the reference's AOT warmup.

Mirrors tests/test_aot_warmup.py on the port. The registry: a signature
tells apart shapes, dtypes and the host ints that select a graph; warm
then call stalls nowhere; a miss before ``freeze()`` is no post-freeze
stall, and a miss after it is recorded with its name and shapes.

The engine, on the CPU in f32 at reduced width (the same passes run there
eagerly, with the card's signature inventory): a warmed engine serves a
churn stream with swaps and copy-on-write, and a chunked + packed stream,
with zero post-warmup stalls and captures; warmed and cold port streams
are equal and equal the reference engine's warmed streams on the same
parameters; ``warmup()`` on a used engine raises; the device cache keeps
its storage across the warmup reset (captured graphs hold its addresses); the fixed-shape chunk write leaves page 0 zero and
shared pages untouched, and equals a host-side drop of the sentinel rows.

Tests marked ``cuda`` skip here: on the card a replayed decode step and a
replayed chunk give logits and pools bit-equal to eager on the same state,
and N replays of the decode graph count N times the eager launches; the
MoE FFN's no-drop dispatch at full-width qwen2-moe-a2.7b's shapes repeats
its bits eagerly and replays them from a CUDA graph.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from repro_torch.models.moe import moe_mlp_apply
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.aot import AotRegistry, _sig_of
from repro_torch.serving.scheduler import DONE
from repro_torch.weights import params_from_jax

# the reference test's engine (tests/test_aot_warmup.py::_engine)
ENGINE = dict(num_slots=4, num_microbatches=2, prompt_capacity=16,
              telemetry_interval=4, page_size=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread runs them faster and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """Reduced llama3.2-1b in f32: the reference's parameters, carried
    across to the port (absent on hosts without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.models.layers as L
    from repro.configs import get_arch as jax_get_arch
    from repro.configs import reduced as jax_reduced
    from repro.models.api import build_model as jax_build
    old = L.DEFAULT_DTYPE
    L.DEFAULT_DTYPE = jnp.float32
    japi = jax_build(jax_reduced(jax_get_arch("llama3.2-1b")), max_seq=128)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           japi.init(jax.random.PRNGKey(0)))
    tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                       dtype=torch.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    yield japi, jparams, tapi, tparams
    L.DEFAULT_DTYPE = old


def _engine(tapi, tparams, device="cpu", **kw):
    return ServingEngine(tapi, EngineConfig(**{**ENGINE, **kw}), tparams,
                         device=device)


def _jax_engine(japi, jparams, **kw):
    from repro.serving import EngineConfig as JCfg
    from repro.serving import ServingEngine as JEngine
    cfg = JCfg(max_seq=128, seal_boundary=False, **{**ENGINE, **kw})
    return JEngine(japi, config=cfg, params=jparams, backend="local")


def _workload(seed, n_req, vocab, prompt_cap, shared_ratio=0.0):
    """The reference test's churn (every prompt length, early EOS, slots
    and pages recycled), with a share of prompts that extend one system
    prompt, so copy-on-write pages hit."""
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, vocab, size=6).tolist()
    out = []
    for i in range(n_req):
        n = 1 + (i % prompt_cap)
        prompt = rng.randint(0, vocab, size=n).tolist()
        if rng.rand() < shared_ratio:
            prompt = (sys_prompt + prompt)[:prompt_cap]
        eos = int(rng.randint(0, vocab)) if rng.rand() < 0.5 else None
        out.append((prompt, int(rng.randint(1, 9)), eos,
                    int(rng.randint(0, 3))))
    return out


def _drive(eng, workload):
    reqs, k, gap = [], 0, 0
    while k < len(workload) or eng.scheduler.has_work():
        if k < len(workload) and gap <= 0:
            prompt, max_new, eos, gap = workload[k]
            reqs.append(eng.submit(prompt, max_new, eos_id=eos))
            k += 1
        gap -= 1
        eng.step()
        assert eng.steps < 1200, "schedule failed to drain"
    assert all(r.status == DONE for r in reqs)
    return [tuple(r.generated) for r in reqs]


def _assert_zero_post_warmup(eng):
    st = eng.stats()
    assert st["warmed"] and st["warmup_s"] > 0
    assert st["compile_stalls"] == [], st["compile_stalls"]
    assert st["post_warmup_compiles"] == 0, st["post_warmup_compiles"]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def test_sig_of_discriminates_shapes_dtypes_and_host_ints():
    a = torch.zeros(2, 3)
    assert _sig_of((a,)) == _sig_of((torch.ones(2, 3),))
    assert _sig_of((a,)) != _sig_of((torch.zeros(3, 2),))
    assert _sig_of((a,)) != _sig_of((torch.zeros(2, 3, dtype=torch.int64),))
    # a host int selects a graph (a bucket, a chunk offset): by value
    assert _sig_of((a, 128)) == _sig_of((torch.ones(2, 3), 128))
    assert _sig_of((a, 0)) != _sig_of((a, 128))
    assert _sig_of((a, 1)) != _sig_of((a, 1.0))
    # tree structure participates
    assert _sig_of(((a, a),)) != _sig_of((a, a))


def test_graphfn_warm_then_call_no_stall():
    reg = AotRegistry()
    f = reg.wrap("double", lambda x: x * 2)
    x4 = torch.arange(4, dtype=torch.float32)
    f.warm(x4)
    assert len(f.signatures) == 1 and reg.stalls == []
    reg.freeze()
    assert torch.equal(f(x4 + 1), (x4 + 1) * 2)
    assert reg.post_freeze_stalls == [] and reg.post_freeze_compiles == 0
    # a signature never warmed is a recorded post-freeze stall, but the
    # call still succeeds; the stall names the function and the shapes
    x8 = torch.arange(8, dtype=torch.float32)
    assert torch.equal(f(x8), x8 * 2)
    assert len(reg.post_freeze_stalls) == 1
    assert reg.post_freeze_stalls[0].describe() == "double[[8]]"
    # ... and only once: the signature is now in the inventory
    f(x8)
    assert len(reg.post_freeze_stalls) == 1
    # on CPU tensors nothing is captured
    assert reg.post_freeze_compiles == 0 and f.graphs == 0


def test_graphfn_prefreeze_miss_is_not_a_post_freeze_stall():
    reg = AotRegistry()
    f = reg.wrap("inc", lambda x, n: x + n)
    f(torch.zeros(3), 1)                    # cold call before freeze
    assert len(reg.stalls) == 1 and not reg.stalls[0].frozen
    assert reg.post_freeze_compiles is None  # never frozen
    reg.freeze()
    assert reg.post_freeze_stalls == []
    f(torch.zeros(3), 2)                    # another host int: a new graph
    assert [s.describe() for s in reg.post_freeze_stalls] == ["inc[[3], 2]"]


# ---------------------------------------------------------------------------
# engine: warmup then churn, zero stalls; warmup is inert
# ---------------------------------------------------------------------------
def test_warmed_engine_serves_churn_with_swaps_and_cow(models):
    _, _, tapi, tparams = models
    wl = _workload(23, 20, tapi.cfg.vocab_size, 16, shared_ratio=0.5)
    cold = _engine(tapi, tparams, num_pages=14)
    want = _drive(cold, wl)
    eng = _engine(tapi, tparams, num_pages=14, warmup=True)
    assert _drive(eng, wl) == want
    _assert_zero_post_warmup(eng)
    st, cs = eng.stats(), cold.stats()
    assert st["swap_outs"] > 0 and st["swap_ins"] > 0 and st["cow_hits"] > 0
    for k in ("steps", "swap_outs", "swap_ins", "cow_hits", "forks",
              "preemptions", "prefill_calls", "admissions"):
        assert st[k] == cs[k], (k, st[k], cs[k])
    # the inventory: one decode shape, one shape per prefill bucket and
    # the swap I/O
    buckets = eng._bucket_inventory()
    assert buckets == [4, 8, 16, 32, 64, 80]
    sigs = {n: len(f.signatures) for n, f in eng.aot.fns.items()}
    assert sigs == {"decode_step": 1, "prefill_chunk": 0,
                    "prefill_at": len(buckets), "prefill_packed": 0,
                    "gather_pages": 1, "scatter_pages": 1}


def test_warmed_chunked_packed_engine_zero_stalls(models):
    """Chunked and packed prefill add their own managed calls (a chunk per
    offset, a packed call per bucket) and chunk-only steps: warmup must
    cover all of them."""
    _, _, tapi, tparams = models
    # arrivals every step, so short prompts queue up and pack
    wl = [(p, n, eos, 0) for p, n, eos, _ in
          _workload(34, 16, tapi.cfg.vocab_size, 16)]
    kw = dict(prefill_chunk=8, prefill_pack=3, num_pages=14)
    want = _drive(_engine(tapi, tparams, **kw), wl)
    eng = _engine(tapi, tparams, warmup=True, **kw)
    assert _drive(eng, wl) == want
    _assert_zero_post_warmup(eng)
    st = eng.stats()
    assert st["chunked_admissions"] > 0
    assert st["packed_admissions"] > st["packed_prefills"] > 0
    assert len(eng.aot.fns["prefill_chunk"].signatures) == \
        eng.request_capacity // 8            # offsets 0, 8, ... < 80
    assert len(eng.aot.fns["prefill_packed"].signatures) == \
        len(eng._bucket_inventory())


def test_warmed_streams_equal_cold_and_reference_warmed(models):
    """Warmed and cold port engines, and the reference engine warmed up
    (AOT compiles), serve the same greedy streams on the same parameters."""
    japi, jparams, tapi, tparams = models
    wl = _workload(37, 12, tapi.cfg.vocab_size, 16)
    want = _drive(_jax_engine(japi, jparams, warmup=True, allow_swap=False),
                  wl)
    assert _drive(_engine(tapi, tparams), wl) == want
    warmed = _engine(tapi, tparams, warmup=True)
    assert _drive(warmed, wl) == want
    _assert_zero_post_warmup(warmed)
    assert warmed.stats()["admissions"] == len(wl)


def test_warmup_requires_fresh_engine(models):
    _, _, tapi, tparams = models
    eng = _engine(tapi, tparams)
    eng.submit([1, 2, 3], 2)
    eng.step()
    with pytest.raises(AssertionError, match="fresh engine"):
        eng.warmup()


def test_reset_state_keeps_cache_storage(models):
    """The warmup reset zeroes the device cache in place: a graph captured
    over the pools, block tables and seq_lens stays valid."""
    _, _, tapi, tparams = models
    eng = _engine(tapi, tparams)
    cache = eng.backend.cache
    ptrs = [t.data_ptr() for t in (*cache["blocks"], cache["block_tables"],
                                   cache["seq_lens"])]
    _drive(eng, _workload(5, 6, tapi.cfg.vocab_size, 16))
    assert cache["blocks"][0].any()
    eng._reset_state()
    assert eng.backend.cache is cache
    assert [t.data_ptr() for t in (*cache["blocks"], cache["block_tables"],
                                   cache["seq_lens"])] == ptrs
    assert not any(t.any() for t in (*cache["blocks"],
                                     cache["block_tables"],
                                     cache["seq_lens"]))
    assert eng.steps == 0 and eng.backend.steps == 0
    assert eng.pool.free_pages == eng.pool.num_pages - 1


def test_paged_write_chunk_fixed_shape_equals_host_drop():
    """The fixed-shape chunk write against a host-side drop of the sentinel
    rows (the write before graphs): equal pools, page 0 all-zero, a shared
    page untouched."""
    rng = np.random.RandomState(11)
    N, KVH, Pg, D, C = 12, 2, 4, 8, 10
    kp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    vp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    kp[0] = vp[0] = 0
    kn = rng.randn(C, KVH, D).astype(np.float32)
    vn = rng.randn(C, KVH, D).astype(np.float32)
    # positions 2..11 of a prompt of 10: 2-3 in shared page 5 (sentinel),
    # 4-7 in page 9, 8-9 in page 2, then two of padding (sentinel)
    pages = np.array([N, N, 9, 9, 9, 9, 2, 2, N, N])
    offs = np.array([2, 3, 0, 1, 2, 3, 0, 1, 0, 0])
    want_k, want_v = kp.copy(), vp.copy()
    keep = np.nonzero(pages < N)[0]
    want_k[pages[keep], :, offs[keep]] = kn[keep]
    want_v[pages[keep], :, offs[keep]] = vn[keep]
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    targets = TL.chunk_write_targets(torch.from_numpy(pages),
                                     torch.from_numpy(offs), N)
    TL.paged_write_chunk(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                         targets)
    assert np.array_equal(tk.numpy(), want_k)
    assert np.array_equal(tv.numpy(), want_v)
    assert not tk[0].any() and not tv[0].any()
    assert np.array_equal(tk[5].numpy(), kp[5])
    changed = {int(p) for p in np.nonzero((tk.numpy() != kp).any(
        axis=(1, 2, 3)))[0]}
    assert changed == {2, 9}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_model(device, seed=0):
    api = build_model(reduced(get_arch("llama3.2-1b")), device=device,
                      dtype=torch.float32)
    return api, api.init(torch.Generator(device=device).manual_seed(seed))


def _recorded(eng):
    """Clones of every decode step's and every chunk's logits."""
    seen, be = [], eng.backend
    step, chunk = be.step, be.prefill_chunk
    be.step = lambda *a: seen.append(step(*a).clone()) or seen[-1]
    be.prefill_chunk = lambda *a: seen.append(chunk(*a).clone()) or seen[-1]
    return seen


@pytest.mark.cuda
def test_replayed_decode_and_chunk_bit_equal_eager(cuda):
    """Same parameters, same stream: every decode step's and chunk's logits
    and the final pools of an engine replaying graphs equal the eager
    engine's bit for bit, with the same launch counts."""
    api, params = _cuda_model(cuda)
    wl = _workload(41, 14, api.cfg.vocab_size, 16, shared_ratio=0.5)
    kw = dict(prefill_chunk=4, prefill_pack=3, num_pages=14)
    runs = []
    for warm in (False, True):
        eng = _engine(api, params, device=cuda, warmup=warm, **kw)
        seen = _recorded(eng)
        ops.reset_launch_counts()
        streams = _drive(eng, wl)
        torch.cuda.synchronize()
        runs.append((streams, seen, dict(ops.LAUNCHES), eng))
    (s0, l0, n0, cold), (s1, l1, n1, warmed) = runs
    _assert_zero_post_warmup(warmed)
    assert warmed.stats()["graphs"] > 0 and cold.stats()["graphs"] == 0
    assert s1 == s0
    assert len(l1) == len(l0) and all(torch.equal(a, b)
                                      for a, b in zip(l0, l1))
    for a, b in zip(cold.backend.cache["blocks"],
                    warmed.backend.cache["blocks"]):
        assert torch.equal(a, b)
    assert n1 == n0 and n1["paged_attention"] > 0 \
        and n1["flash_attention"] > 0


@pytest.mark.cuda
def test_replay_launch_counts(cuda):
    """``ops.LAUNCHES`` counts on the host; a replay adds what its capture
    launched: N replays of the decode graph count N times the eager step's
    launches."""
    api, params = _cuda_model(cuda)
    eager = _engine(api, params, device=cuda)
    warmed = _engine(api, params, device=cuda, warmup=True)
    idle = np.zeros(ENGINE["num_slots"], np.int32)
    counts = []
    for eng, n in ((eager, 1), (warmed, 5)):
        eng.backend.step(idle, 0)           # idle slots: state-neutral
        ops.reset_launch_counts()
        for _ in range(n):
            eng.backend.step(idle, 0)
        torch.cuda.synchronize()
        counts.append(dict(ops.LAUNCHES))
    assert counts[0]["paged_attention"] == api.cfg.num_layers
    assert counts[1] == {k: 5 * v for k, v in counts[0].items()}
    assert warmed.stats()["post_warmup_compiles"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 128])
def test_moe_dispatch_repeats_and_replays_bit_equal(cuda, T):
    """The serving dispatch on the card at full width's E, K and widths
    (bf16), at a decode step's 8 tokens and a 128-token prefill bucket: a
    second eager call gives the same bits (no atomics in the scatter or
    the combine), and a CUDA graph of it replays them."""
    cfg = get_arch("qwen2-moe-a2.7b")
    g = torch.Generator(device=cuda).manual_seed(0)
    p = {"router": torch.randn(cfg.d_model, cfg.num_experts, generator=g,
                               device=cuda).to(torch.bfloat16) * 0.05}
    for k, shape in (("wi", (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)),
                     ("wg", (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)),
                     ("wo", (cfg.num_experts, cfg.moe_d_ff, cfg.d_model))):
        p[k] = (torch.randn(shape, generator=g, device=cuda) * 0.02).to(
            torch.bfloat16)
    sd = cfg.num_shared_experts * cfg.moe_d_ff
    p["shared"] = {k: (torch.randn(s, generator=g, device=cuda) * 0.02).to(
        torch.bfloat16) for k, s in (("wi", (cfg.d_model, sd)),
                                     ("wg", (cfg.d_model, sd)),
                                     ("wo", (sd, cfg.d_model)))}
    x = torch.randn(1, T, cfg.d_model, generator=g, device=cuda).to(
        torch.bfloat16)

    def run():
        return moe_mlp_apply(cfg, p, x, drop_tokens=False, aux=False)[0]

    eager, again = run(), run()
    assert torch.equal(eager, again)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.isfinite(eager.float()).all()
