"""The serving engine with one pipeline stage per rank
(``ServingEngine(mesh=)``, ``serving/ranked.py``) on the CPU over gloo,
against the reference's engine on its staged mesh and against the port's
one-card pipelined engine.

(a) ``REFERENCE``: the reference's pipelined engine on a (2, 2) pod x data
    mesh of fake XLA devices, run once in a subprocess, over the workload
    of its own ``tests/test_serving.py`` (``ENGINE_PIPE_CODE``: reduced
    llama3.2-1b in f32, 4 slots, 2 microbatches, unsealed, paged and
    timeline) and of ``tests/test_faults.py``'s device death on the staged
    mesh (the reference's own test holds that run equal to its undisturbed
    one). Two gloo ranks (stage s on rank s) serve the same streams; the
    death run's streams equal the undisturbed run's and the reference's,
    with the death re-planned. The ranks serve while the reference runs.
(b) Bit for bit against the port's one-card pipelined engine on the same
    params (one thread, as each rank runs): every decode step's logits and
    the streams, on both layouts (sealed runs, chunked and packed
    prefill and swaps: ``test_torch_serve_ranks.py``). Each rank holds its
    stage's layers only; every rank's events and ``stats()`` are the
    same, and no (key, counter) pair ciphers twice.
(c) ``restage_cache`` over ranks equals staging the whole cache directly
    under the new boundaries, paged and timeline (bf16-bit moves of the
    int8 cache included), for (old, new) pairs on 2 ranks (on 3:
    ``test_torch_serve_ranks.py``).
(d) The page cipher over a window of a row: each stage's window of the
    plain ``seal_bits`` is the matching columns of the whole row's, the
    window opens under ``unseal_bits``, and the defaults are the whole
    row's bytes; on a card (marker ``cuda``) the kernel at a window gives
    the plain version's bytes.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch.configs import get_arch, reduced
from repro_torch.enclave import sealing
from repro_torch.kernels import ops, ref
from repro_torch.launch import rank_jobs as J
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, FaultConfig, ServingEngine
from repro_torch.weights import params_from_jax

PIPE = dict(num_slots=4, num_microbatches=2, max_seq=128,
            prompt_capacity=16, telemetry_interval=4)
DEATH = dict(num_slots=2, num_stages=2, num_microbatches=2, max_seq=96,
             prompt_capacity=8, request_capacity=20, page_size=4,
             page_policy="demand", preempt_policy="swap",
             telemetry_interval=4, allow_swap=False)
DEATH_FAULTS = dict(seed=3, device_death=1.0, max_device_deaths=1)

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.launch.mesh import make_mesh
from repro.models.api import build_model
from repro.serving import EngineConfig, FaultConfig, ServingEngine

data = pickle.load(open(PATH, "rb"))
cfg = reduced(get_arch("llama3.2-1b"))
api = build_model(cfg, max_seq=128)
params = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      api.init(jax.random.PRNGKey(0)))
mesh = make_mesh((2, 2), ("pod", "data"))
out = {"params": jax.tree.map(np.asarray, params)}
for kv in ("paged", "timeline"):
    ec = EngineConfig(seal_boundary=False, kv_layout=kv, **data["pipe"])
    eng = ServingEngine(api, mesh=mesh, config=ec, params=params,
                        backend="pipelined")
    reqs = [eng.submit(p, n) for p, n in data["pipe_wl"]]
    eng.run(max_steps=120)
    assert all(r.status == "done" for r in reqs)
    out[kv] = [list(r.generated) for r in reqs]
for name, faults in (("death", FaultConfig(**data["death_faults"])),):
    ec = EngineConfig(seal_boundary=False, faults=faults, **data["death"])
    eng = ServingEngine(api, mesh=mesh, config=ec, params=params,
                        backend="pipelined")
    reqs, k = [], 0
    while k < len(data["death_wl"]) or eng.scheduler.has_work():
        if k < len(data["death_wl"]):
            reqs.append(eng.submit(*data["death_wl"][k])); k += 1
        eng.step()
        assert eng.steps < 400
    assert all(r.status == "done" for r in reqs)
    st = eng.stats()
    out[name] = ([list(r.generated) for r in reqs],
                 {k: st.get(k) for k in ("failure_replans", "faults",
                                         "recovery")})
pickle.dump(out, open(PATH, "wb"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workloads(vocab):
    """The reference's two workloads: ``ENGINE_PIPE_CODE``'s (five prompts
    of 3-8 tokens, 10 new each, all up front) and the device death's
    (four prompts of 4 tokens, 10 new each, one a step)."""
    rng = np.random.RandomState(3)
    pipe = [(rng.randint(0, vocab, size=int(rng.randint(3, 9))).tolist(),
             10) for _ in range(5)]
    rng = np.random.RandomState(7)
    death = [(rng.randint(1, vocab, size=4).tolist(), 10) for _ in range(4)]
    return pipe, death


class _Reference:
    """``REFERENCE`` running in a subprocess with 4 fake XLA devices while
    the ranks serve (``result()`` waits for it)."""

    def __init__(self, path: str):
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        self.path = path
        self.proc = subprocess.Popen(
            [sys.executable, "-c", REFERENCE.replace("PATH", repr(path))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)

    def result(self):
        if not hasattr(self, "out"):
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0 and "REFERENCE OK" in out, \
                err[-4000:]
            with open(self.path, "rb") as f:
                self.out = pickle.load(f)
            os.remove(self.path)
        return self.out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference's run, the port's model, the reference's f32 params
    in the port, the two workloads); the subprocess starts here and is
    waited for by the first test that reads its streams."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    cfg = reduced(get_arch("llama3.2-1b"))
    pipe, death = _workloads(cfg.vocab_size)
    path = str(tmp_path_factory.mktemp("engine_ranks") / "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump({"pipe": PIPE, "pipe_wl": pipe, "death": DEATH,
                     "death_wl": death, "death_faults": DEATH_FAULTS}, f)
    run = _Reference(path)
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    try:
        japi = jbuild(jreduced(jget("llama3.2-1b")), max_seq=128)
        jparams = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                               if jnp.issubdtype(x.dtype, jnp.floating)
                               else np.asarray(x),
                               japi.init(jax.random.PRNGKey(0)))
    finally:
        JL.DEFAULT_DTYPE = old
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=128)
    yield run, api, params_from_jax(jparams, "cpu"), pipe, death
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.wait()


def _runs(pipe, death):
    """name -> ServeRun, each served on two ranks (and on one card)."""
    runs = {kv: J.ServeRun(EngineConfig(seal_boundary=False, kv_layout=kv,
                                        **PIPE), pipe, keep_logits=True,
                           max_steps=120)
            for kv in ("paged", "timeline")}
    for name, faults in (("calm", None), ("death", DEATH_FAULTS)):
        runs[name] = J.ServeRun(EngineConfig(
            seal_boundary=False, faults=faults and FaultConfig(**faults),
            **DEATH), death, every=1)
    return runs


@pytest.fixture(scope="module")
def ranked(reference):
    """Every run of ``_runs`` on two gloo ranks (one spawn): name -> the
    two ranks' results."""
    _, api, params, pipe, death = reference
    runs = _runs(pipe, death)
    out = spawn(J.serve, 2, backend="gloo", device="cpu",
                args=(J.ServeJob(api.cfg, list(runs.values()),
                                 params=params, max_seq=128),))
    return {name: [r[i] for r in out] for i, name in enumerate(runs)}


def one_card(api, params, run):
    """``run`` on the port's one-card pipelined engine: (streams, logits
    of each decode step, stats)."""
    eng = ServingEngine(api, run.config, params, device="cpu",
                        backend="pipelined")
    probe = J.Probe(eng, run.keep_logits)
    reqs = J.drive(eng, run)
    return [list(r.generated) for r in reqs], probe.logits, eng.stats()


# the schedule's counters; the re-plans are left out: a stage probe's host
# time on a loaded CPU may read as a straggler in one run and not in
# another, and unsealed boundaries give the same bits wherever they sit
SCHEDULE = ("steps", "preemptions", "swap_outs", "swap_ins",
            "prefill_calls", "chunked_admissions", "packed_admissions",
            "forks", "cow_hits", "completed", "tokens_out")


def hold_one_card(api, params, run, ranks):
    """The ranks' results of ``run`` against the one-card engine's: streams
    and every decode step's logits bit for bit, the schedule's counters,
    each rank on its own layers of its final layout. Returns the one-card
    stats."""
    streams, logits, st = one_card(api, params, run)
    for r in ranks:
        assert r["streams"] == streams
        assert len(r["logits"]) == len(logits)
        for got, want in zip(r["logits"], logits):
            assert torch.equal(got, want)
        for k in SCHEDULE:
            assert r["stats"].get(k) == st.get(k), k
        blocks = r["stats"]["stage_blocks"]
        lo = sum(blocks[:r["stage"]])
        assert r["range"] == (lo, lo + blocks[r["stage"]])
    return st


@pytest.mark.parametrize("kv", ["paged", "timeline"])
def test_rank_engine_equals_one_card_bit_for_bit(reference, ranked, kv):
    _, api, params, pipe, death = reference
    hold_one_card(api, params, _runs(pipe, death)[kv], ranked[kv])


def test_every_rank_records_the_same_events_and_stats(ranked):
    for name, (r0, r1) in ranked.items():
        assert r0["events"] == r1["events"], name
        assert r0["stats"] == r1["stats"], name
        assert r0["admission_ms"] == r1["admission_ms"], name


def test_no_keystream_reuse_across_the_rank_runs(ranked):
    for name, ranks in ranked.items():
        assert not J.keystream_reuse([r["keys"] for r in ranks]), name
    # the death run's spills seal each rank's window of the swap rows
    cols = {(k[3], k[4], k[5]) for r in ranked["death"] for k in r["keys"]
            if k[0] == "seal_bits" and k[4] != k[5]}
    assert len(cols) == 2


# ---------------------------------------------------------------------------
# (c) restage over ranks = direct staging under the new boundaries
# ---------------------------------------------------------------------------
# pairs of stage layouts over 6 layers; on 3 ranks a layer moves past its
# neighbour (layer 2: stage 0 -> stage 2)
RESTAGE_PAIRS = {2: [((1, 5), (3, 3)), ((3, 3), (5, 1)), ((5, 1), (1, 5))],
                 3: [((3, 1, 2), (1, 1, 4)), ((1, 1, 4), (2, 3, 1))]}


def restage_body(ctx, cfg):
    """On each rank: for every (old, new) pair of RESTAGE_PAIRS[world],
    restage a paged cache and a timeline body from ``old`` to ``new`` and
    return them with the direct cut under ``new``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.pipeline import PipelinedDecoder
    api = build_model(cfg, device="cpu", dtype=torch.float32)
    mesh = make_mesh((ctx.world, 1), ("pod", "data"), device="cpu")
    g = torch.Generator().manual_seed(11)
    L = cfg.num_layers
    paged = api.init_paged_cache(4, 9, 4, 3)
    for pool in paged["blocks"]:
        pool.normal_(generator=g)
    paged["block_tables"].random_(0, 9, generator=g)
    body = api.init_cache(4, 16)
    for t in body["blocks"]:
        t.normal_(generator=g)
    # the int8 timeline cache: int8 K/V (moved as bf16 bits) and f32 scales
    quant = build_model(cfg, device="cpu", dtype=torch.float32,
                        cache_quant=True).init_cache(4, 16)
    for t in quant["blocks"]:
        if t.dtype == torch.int8:
            t.random_(-127, 128, generator=g)
        else:
            t.normal_(generator=g)
    out = []
    with J.KeyLedger() as ledger:
        for n, (old, new) in enumerate(RESTAGE_PAIRS[ctx.world]):
            a, b = (PipelinedDecoder(api, ctx.world, 2, stage_blocks=x,
                                     mesh=mesh) for x in (old, new))
            got_p = a.restage_cache(a.stage_paged_cache(paged), b, key=5,
                                    seq=256 * n)
            got_t = a.restage_cache(a.stage_cache(body), b, key=5,
                                    seq=256 * n + 64)
            got_q = a.restage_cache(a.stage_cache(quant), b, key=5,
                                    seq=256 * n + 128)
            out.append((got_p, b.stage_paged_cache(paged), got_t,
                        b.stage_cache(body), got_q, b.stage_cache(quant)))
    assert L == sum(RESTAGE_PAIRS[ctx.world][0][0])
    return out, ledger.records


def hold_restage(world):
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-1b")),
                              num_layers=6)
    ranks = spawn(restage_body, world, backend="gloo", device="cpu",
                  args=(cfg,))
    for rank, (pairs, _) in enumerate(ranks):
        for n, (got_p, want_p, *bodies) in enumerate(pairs):
            new = RESTAGE_PAIRS[world][n][1]
            for g, w in zip(got_p["blocks"], want_p["blocks"]):
                assert g.shape[0] == new[rank] and torch.equal(g, w)
            assert torch.equal(got_p["block_tables"],
                               want_p["block_tables"])
            for got_t, want_t in zip(bodies[::2], bodies[1::2]):
                for g, w in zip(got_t[0], want_t[0]):
                    assert g.shape[0] == new[rank] and g.dtype == w.dtype
                    assert torch.equal(g, w)
                assert int(got_t[1]) == int(want_t[1])
    assert not J.keystream_reuse([keys for _, keys in ranks])
    assert sum(len(keys) for _, keys in ranks) > 0


def test_restage_over_ranks_equals_direct_staging():
    hold_restage(2)


# ---------------------------------------------------------------------------
# (d) the page cipher over a window of a row
# ---------------------------------------------------------------------------
WINDOW_ROWS, LAYERS, PER = 5, 6, 2 * 4 * 8        # per layer: KVH x Pg x D
STAGES = [(0, 1), (1, 6), (0, 3), (3, 6), (2, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_cipher_is_the_whole_rows_columns(dtype):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(WINDOW_ROWS, LAYERS * PER, generator=g).to(dtype)
    whole = ops.seal_bits(x, 0xC0FFEE, 77)
    # the defaults, and a window that is the whole row, are today's bytes
    assert torch.equal(whole, ref.seal_bits_ref(x, 0xC0FFEE, 77))
    assert torch.equal(ops.seal_bits(x, 0xC0FFEE, 77, 0, LAYERS * PER),
                       whole)
    for lo, hi in STAGES:
        part = x[:, lo * PER:hi * PER].contiguous()
        c = sealing.seal_pages(part, 0xC0FFEE, 3, part=1, col0=lo * PER,
                               row_cols=LAYERS * PER)
        want = sealing.seal_pages(x, 0xC0FFEE, 3, part=1)
        assert torch.equal(c, want[:, lo * PER:hi * PER])
        back = sealing.unseal_pages(c, 0xC0FFEE, 3, dtype, part=1,
                                    col0=lo * PER, row_cols=LAYERS * PER)
        assert torch.equal(back, part)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.seal_bits(x[:, :12].contiguous(), 1, 2, 4, LAYERS * PER)
    with pytest.raises(ValueError, match="outside"):
        ops.seal_bits(x[:, :16].contiguous(), 1, 2, LAYERS * PER - 8,
                      LAYERS * PER)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_cipher_kernel_gives_the_plain_bytes(cuda, dtype):
    """llama3.2-1b's swap row (16 layers x 8 KV heads x 16 x 64) of 10
    pages, at stage (1, 15)'s two windows, and a window one element past a
    16-byte boundary (the kernel's scalar path)."""
    per = 8 * 16 * 64
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(10, 16 * per, generator=g, device=cuda).to(dtype)
    for lo, hi in ((0, 1), (1, 16)):
        part = x[:, lo * per:hi * per].contiguous()
        n = ops.LAUNCHES["seal_bits_window"]
        c = ops.seal_bits(part, 9, 0xA5A50001, lo * per, 16 * per)
        assert ops.LAUNCHES["seal_bits_window"] == n + 1
        assert torch.equal(c.cpu(), ref.seal_bits_ref(
            part.cpu(), 9, 0xA5A50001, lo * per, 16 * per))
        back = ops.unseal_bits(c, 9, 0xA5A50001, dtype, lo * per, 16 * per)
        assert torch.equal(back, part)
    odd = torch.empty(10 * per + 1, dtype=dtype, device=cuda)[1:]
    odd = odd.view(10, per)
    odd.copy_(x[:, :per])
    assert odd.data_ptr() % 16
    c = ops.seal_bits(odd, 9, 4, 3 * per, 16 * per)
    assert torch.equal(c.cpu(), ref.seal_bits_ref(odd.cpu(), 9, 4, 3 * per,
                                                  16 * per))


# ---------------------------------------------------------------------------
# (a) against the reference (its subprocess has run meanwhile)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv", ["paged", "timeline"])
def test_rank_engine_serves_the_reference_streams(reference, ranked, kv):
    out = reference[0].result()
    for r in ranked[kv]:
        assert r["streams"] == out[kv]
        assert r["stats"]["kv_layout"] == kv
        assert r["stats"]["backend"] == "pipelined"


def test_device_death_on_ranks_keeps_the_streams(reference, ranked):
    out = reference[0].result()
    calm, death = ranked["calm"], ranked["death"]
    want, jst = out["death"]
    for r in calm + death:
        assert r["streams"] == want
    for r in death:
        st = r["stats"]
        assert st["faults"]["device_death"] == 1, st["faults"]
        assert st["recovery"]["device_loss_replans"] == 1
        assert st["recovery"] == jst["recovery"]
        assert st["failure_replans"] == jst["failure_replans"] == 1
        assert len(st["excluded_devices"]) == 1
        assert st["swap_outs"] > 0
