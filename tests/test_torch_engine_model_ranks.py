"""The serving engine and the pipelined decoder over a ``model`` axis of
ranks: ``ServingEngine(api, mesh=make_mesh((P, D, M), ("pod", "data",
"model")), backend="pipelined")`` on four gloo CPU ranks, each stage's
layers split over its M model ranks (tensor parallelism inside a pod),
reduced configs in f32, one thread a rank. Three spawns:

- (2, 1, 2): reduced llama3.2-1b with 2 KV heads (one a model rank), the
  stage crossings sealed on model rank 0 and opened there; the live
  re-plan; a device death; reduced qwen2-moe-a2.7b (experts over
  model); and reduced llama3.2-1b itself against the reference's engine;
- (1, 2, 2): the same GQA llama, the data ranks' KV exchange beside the
  model axis;
- (1, 1, 4): reduced glm4-9b, whose 2 KV heads stay whole over 4 ranks:
  every rank keeps the whole pool and the paged kernel reads its KV head
  in place (``kv_head0``), and the timeline keeps each rank's block of
  S / 4 positions (the distributed flash-decode).

(a) Greedy streams equal the port's one-card engine's on the same params
    and requests (at ``microbatches x data`` microbatches, the rows a data
    rank runs), paged under a swapping pool with chunked and packed
    prefill, and on the timeline; unsealed decode logits within 1e-4 of
    each step's largest |logit|. Reduced llama3.2-1b's paged and timeline
    streams equal the reference's engine's (run once in a subprocess
    while the ranks serve).
(b) A swap payload is what the pod x data engine seals for the same KV:
    model rank 0 of data rank 0 of each pod seals its pod's window of
    every KV head (the model ranks' heads side by side), the other ranks
    seal nothing, the payload's bytes are ``seal_pages`` of the gathered
    rows under its (key, counter) and window with its digest, and every
    swap-in restores each rank's pages bit for bit.
(c) No (key, counter) pair ciphers twice over the four ranks: boundaries,
    crossings, swaps, the KV exchanges and the re-plan's moves (each model
    rank moves and exchanges its own blocks under its own numbers).
(d) A live re-plan (an injected straggler) moves layers between the pods
    and keeps the undisturbed run's streams; the chaos plane's device
    death and stage stalls re-plan and keep them too.
(e) Every rank takes the same decisions: events and ``stats()``.
(f) Each rank holds its stage's layers of its param blocks and its KV
    heads (all of them where they do not divide), and glm4-9b's timeline
    ranks hold S / 4 positions.
(g) The plain ``paged_attention`` with ``kv_head0`` and a rank's rep
    equals the plain version on the pool sliced to those heads; on a card
    (marker ``cuda``) the kernel equals it.
(h) What the model axis does not serve yet is refused by name with its
    step: warmup in CUDA graphs, a disaggregated role, the other
    families, the int8 cache.
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
from repro_torch.runtime import steps as S
from repro_torch.runtime.pipeline import PIPE_PARAM_RULES
from repro_torch.serving import EngineConfig, FaultConfig, ServingEngine
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax
from test_torch_engine_ranks import (DEATH, DEATH_FAULTS, PIPE, SCHEDULE,
                                     _workloads)
from test_torch_serve_ranks import (CHUNKED, NO_REPLAN, STRAGGLER_TICK,
                                    TIGHT)

F32_TOL = 1e-4
# the chaos plane's stage stall: a straggler factor at every telemetry tick
STALL_FAULTS = dict(seed=3, stage_stall=1.0)
MESHES = {"pods": (2, 1, 2), "data": (1, 2, 2), "wide": (1, 1, 4)}

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.models.api import build_model
from repro.serving import EngineConfig, ServingEngine

data = pickle.load(open(PATH, "rb"))
api = build_model(reduced(get_arch("llama3.2-1b")), max_seq=128)
params = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      api.init(jax.random.PRNGKey(0)))
out = {"params": jax.tree.map(np.asarray, params)}
for kv in ("paged", "timeline"):
    eng = ServingEngine(api, config=EngineConfig(
        seal_boundary=False, kv_layout=kv, **data["pipe"]), params=params)
    reqs = [eng.submit(p, n) for p, n in data["pipe_wl"]]
    eng.run(max_steps=120)
    assert all(r.status == "done" for r in reqs)
    out[kv] = [list(r.generated) for r in reqs]
pickle.dump(out, open(PATH, "wb"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch: str):
    cfg = reduced(get_arch(arch))
    if arch == "llama3.2-1b":            # GQA: 2 KV heads, one a model rank
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return cfg


def _model(arch: str, seed: int = 1):
    api = build_model(_cfg(arch), device="cpu", dtype=torch.float32,
                      max_seq=128)
    return api, api.init(torch.Generator().manual_seed(seed))


def _runs(V: int, stages: int):
    """name -> ServeRun of one mesh's engines (``stages`` pods)."""
    pipe, death = _workloads(V)
    rng = np.random.RandomState(5)
    # pairs of short prompts (packed) between pairs of long ones (chunked)
    long = [(rng.randint(0, V, size=int(
        rng.randint(2, 6) if i % 4 < 2 else rng.randint(6, 25))).tolist(), 8)
        for i in range(10)]
    rng = np.random.RandomState(3)
    tight = [(rng.randint(0, V, size=int(rng.randint(2, 17))).tolist(),
              int(rng.randint(6, 14))) for _ in range(10)]
    one = dict(num_stages=stages)
    runs = {
        # sealed crossings, a swapping pool, chunked and packed prefill
        "chunked": J.ServeRun(EngineConfig(**CHUNKED, **one), long,
                              keep_logits=True, check_swaps=True),
        "timeline": J.ServeRun(EngineConfig(
            kv_layout="timeline", seal_boundary=False, **one,
            **dict(PIPE, telemetry_interval=NO_REPLAN)), pipe,
            keep_logits=True, max_steps=120)}
    if stages == 2:
        runs["tight"] = J.ServeRun(EngineConfig(
            telemetry_interval=NO_REPLAN, **TIGHT), tight, every=1,
            keep_logits=True, check_swaps=True)
        runs["straggler"] = J.ServeRun(EngineConfig(
            telemetry_interval=STRAGGLER_TICK, **TIGHT), tight, every=1,
            inject=(1, 25.0), check_swaps=True)
        for name, faults in (("calm", None), ("death", DEATH_FAULTS),
                             ("stall", STALL_FAULTS)):
            runs[name] = J.ServeRun(EngineConfig(
                seal_boundary=False, faults=faults and FaultConfig(**faults),
                **DEATH), death, every=1)
    return runs


def _moe_runs(V: int):
    runs = _runs(V, 2)
    return {k: runs[k] for k in ("chunked", "timeline")}


def _reference_runs(pipe):
    return {kv: J.ServeRun(EngineConfig(seal_boundary=False, kv_layout=kv,
                                        **PIPE), pipe, max_steps=120)
            for kv in ("paged", "timeline")}


def refusal_body(ctx, _):
    """On a (1, 1, 4) pod x data x model mesh: each refused engine's error
    by case."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESHES["wide"], ("pod", "data", "model"), device="cpu")
    api = build_model(_cfg("glm4-9b"), device="cpu", dtype=torch.float32,
                      max_seq=64)
    params = api.init(torch.Generator().manual_seed(0))
    one = dict(num_stages=1, max_seq=64, prompt_capacity=8)
    cases = {"warmup": (api, params, dict(warmup=True)),
             "disagg": (api, params, dict(disagg_role="decode"))}
    for arch in ("hymba-1.5b", "xlstm-125m"):
        fam = build_model(reduced(get_arch(arch)), device="cpu",
                          dtype=torch.float32, max_seq=64)
        cases[arch] = (fam, fam.init(torch.Generator().manual_seed(0)), {})
    q8 = build_model(_cfg("glm4-9b"), device="cpu", dtype=torch.float32,
                     max_seq=64, cache_quant=True)
    cases["int8"] = (q8, params, dict(kv_layout="timeline"))
    out = {}
    for name, (a, p, kw) in cases.items():
        try:
            ServingEngine(a, EngineConfig(**one, **kw), p, device="cpu",
                          backend="pipelined", mesh=mesh)
            out[name] = "built"
        except (NotImplementedError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def _jax_params():
    """The reference's f32 init of reduced llama3.2-1b, as the port's."""
    import jax
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    try:
        japi = jbuild(jreduced(jget("llama3.2-1b")), max_seq=128)
        tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                            if jnp.issubdtype(x.dtype, jnp.floating)
                            else np.asarray(x),
                            japi.init(jax.random.PRNGKey(0)))
    finally:
        JL.DEFAULT_DTYPE = old
    return params_from_jax(tree, "cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """({key: {run name: the four ranks' results}}, the port's models by
    arch, the reference's streams, the refusals a rank)."""
    pytest.importorskip("jax")
    llama = reduced(get_arch("llama3.2-1b"))
    V = llama.vocab_size
    pipe, _ = _workloads(V)
    path = str(tmp_path_factory.mktemp("model_ranks") / "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump({"pipe": PIPE, "pipe_wl": pipe}, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.replace("PATH", repr(path))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        models = {a: _model(a) for a in ("llama3.2-1b", "glm4-9b",
                                         "qwen2-moe-a2.7b")}
        ref_params = _jax_params()

        def job(arch, runs, mesh, params=None, cfg=None):
            _, d, m = MESHES[mesh]
            return J.ServeJob(cfg or _cfg(arch), list(runs.values()),
                              params=models[arch][1] if params is None
                              else params, max_seq=128, data=d, model=m)

        pods = spawn(J.chain, 4, backend="gloo", device="cpu", args=([
            (J.serve, job("llama3.2-1b", _runs(V, 2), "pods")),
            (J.serve, job("qwen2-moe-a2.7b", _moe_runs(V), "pods")),
            (J.serve, job("llama3.2-1b", _reference_runs(pipe), "pods",
                          params=ref_params, cfg=llama))],))
        data = spawn(J.chain, 4, backend="gloo", device="cpu", args=([
            (J.serve, job("llama3.2-1b", _runs(V, 1), "data"))],))
        wide = spawn(J.chain, 4, backend="gloo", device="cpu", args=([
            (J.serve, job("glm4-9b", _runs(V, 1), "wide")),
            (refusal_body, None)],))
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REFERENCE OK" in out, err[-4000:]
        with open(path, "rb") as f:
            reference = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    def by_run(out, i, runs):
        return {name: [r[i][k] for r in out] for k, name in enumerate(runs)}

    ranks = {"pods": by_run(pods, 0, _runs(V, 2)),
             "moe": by_run(pods, 1, _moe_runs(V)),
             "reference": by_run(pods, 2, _reference_runs(pipe)),
             "data": by_run(data, 0, _runs(V, 1)),
             "wide": by_run(wide, 0, _runs(V, 1))}
    return ranks, models, reference, [r[1] for r in wide]


# the spawn a (mesh, arch) ran in: its results' key and its mesh
CASES = {("pods", "llama3.2-1b"): "pods", ("moe", "qwen2-moe-a2.7b"): "pods",
         ("data", "llama3.2-1b"): "data", ("wide", "glm4-9b"): "wide"}


def one_card(api, params, run, microbatches):
    """``run`` on the port's one-card pipelined engine at ``microbatches``
    microbatches: (streams, decode logits, stats)."""
    config = dataclasses.replace(run.config, num_microbatches=microbatches)
    eng = ServingEngine(api, config, params, device="cpu",
                        backend="pipelined")
    if run.inject:
        eng.telemetry.inject(*run.inject)
    probe = J.Probe(eng, True)
    reqs = J.drive(eng, dataclasses.replace(run, config=config))
    return [list(r.generated) for r in reqs], probe.logits, eng.stats()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def _runs_of(key, arch):
    V = reduced(get_arch("llama3.2-1b")).vocab_size
    if key == "moe":
        return _moe_runs(V)
    return _runs(V, MESHES[CASES[(key, arch)]][0])


# ---------------------------------------------------------------------------
# (a) streams
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("run", ["chunked", "timeline"])
@pytest.mark.parametrize("key,arch", sorted(CASES), ids=str)
def test_model_ranks_serve_the_one_card_streams(served, key, arch, run):
    ranks, models, _, _ = served
    api, params = models[arch]
    r = _runs_of(key, arch)[run]
    d = MESHES[CASES[(key, arch)]][1]
    streams, logits, st = one_card(api, params, r,
                                   d * r.config.num_microbatches)
    for got in ranks[key][run]:
        assert got["streams"] == streams
        assert all(s == "done" for s in got["status"])
        for k in SCHEDULE:
            assert got["stats"].get(k) == st.get(k), k
        if not r.config.seal_boundary:
            assert len(got["logits"]) == len(logits) > 0
            for a, b in zip(got["logits"], logits):
                assert _rel(a, b) < F32_TOL
                assert torch.equal(a.argmax(-1), b.argmax(-1))
    if run == "chunked":
        assert st["swap_outs"] > 0 and st["chunked_admissions"] > 0
        assert st["packed_admissions"] > 0


@pytest.mark.parametrize("kv", ["paged", "timeline"])
def test_model_ranks_serve_the_reference_streams(served, kv):
    ranks, _, reference, _ = served
    for r in ranks["reference"][kv]:
        assert r["streams"] == reference[kv]


def test_the_crossings_are_sealed_on_model_rank_zero(served):
    """Decode boundaries and prefill crossings: model rank 0 of each pod
    seals and sends; its model peers seal no activation."""
    for r in served[0]["pods"]["chunked"]:
        kinds = {k[0] for k in r["keys"]}
        crossing = [k for k in r["keys"] if k[0] == "seal_bits" and
                    sealing.CROSSING_SEQ_BASE <= (k[2] ^ 0xA5A50000) // 2
                    < sealing.RESTAGE_SEQ_BASE]
        if r["stage"] == 0 and r["model"] == 0:
            assert "seal" in kinds and crossing
        else:
            assert "seal" not in kinds and not crossing
        # one message of crossings a tick, only from model rank 0
        assert (len(r["crossings"]) > 0) == (r["stage"] == 0
                                              and r["model"] == 0)


# ---------------------------------------------------------------------------
# (b) swaps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key,arch", [("pods", "llama3.2-1b"),
                                      ("data", "llama3.2-1b"),
                                      ("wide", "glm4-9b")], ids=str)
def test_a_swap_payload_is_the_pod_by_data_engines_bytes(served, key, arch):
    ranks = served[0][key]["chunked"]
    api = served[1][arch][0]
    kvh = api.cfg.num_kv_heads
    by = {(r["stage"], r["data"], r["model"]): r for r in ranks}
    pods = {r["stage"] for r in ranks}
    for p in pods:
        lead = by[(p, 0, 0)]["first_swap"]
        group = [by[(p, 0, m)] for m in range(MESHES[key][2])]
        # the pod's window of every KV head: the model ranks' heads side
        # by side (the whole pool where the heads stay whole)
        split = group[0]["first_rows"][0].shape[2] < kvh
        rows = [torch.cat([g["first_rows"][i] for g in group], dim=2)
                if split else group[0]["first_rows"][i] for i in range(2)]
        n = api.model.served_segment.n
        lo, hi = by[(p, 0, 0)]["first_swap"]["layout"][p]
        for part, (r, c) in enumerate(zip(rows, lead["payload"])):
            assert r.shape[0] == hi - lo and r.shape[2] == kvh
            flat = r.transpose(0, 1).reshape(r.shape[1], -1)
            per = flat.shape[1] // (hi - lo)
            want = sealing.seal_pages(flat, lead["key"], lead["counter"],
                                      part=part, col0=lo * per,
                                      row_cols=n * per)
            c = np.asarray(c)
            assert np.array_equal(np.asarray(want).view(c.dtype), c)
        for rr in by.values():
            if rr["stage"] == p and (rr["data"], rr["model"]) != (0, 0):
                assert rr["first_swap"]["payload"][0].shape[1] == 0
                assert rr["first_swap"]["counter"] == lead["counter"]
    whole = tuple(np.concatenate([by[(p, 0, 0)]["first_swap"]["payload"][i]
                                  for p in sorted(pods)], axis=1)
                  for i in range(2))
    digests = {by[(p, 0, 0)]["first_swap"]["digest"] for p in pods}
    if len(pods) == 1:
        assert sealing.payload_digest(whole) in digests
    # every swap-in restored each rank's pages bit for bit
    assert len({r["restored"] for r in ranks}) == 1
    assert ranks[0]["restored"] > 0


# ---------------------------------------------------------------------------
# (c) keys, (d) re-plans, (e) decisions
# ---------------------------------------------------------------------------
def _space(kind, ctr) -> str:
    seq = (ctr ^ 0xA5A50000) // 2
    if kind == "seal":
        return "boundary"
    if seq >= sealing.RESTAGE_SEQ_BASE:
        return "restage"
    if seq >= sealing.CROSSING_SEQ_BASE:
        return "crossing"
    if seq >= sealing.EXCHANGE_SEQ_BASE:
        return "exchange"
    return "swap"


def test_no_keystream_reuse_over_the_model_ranks(served):
    spaces = set()
    for key in ("pods", "moe", "data", "wide", "reference"):
        for name, ranks in served[0][key].items():
            assert not J.keystream_reuse([r["keys"] for r in ranks]), \
                (key, name)
            spaces |= {_space(k[0], k[2]) for r in ranks for k in r["keys"]}
    assert spaces == {"boundary", "restage", "crossing", "exchange",
                      "swap"}, spaces
    # the re-plan's moves: each model rank moves its own blocks
    moved = [r for r in served[0]["pods"]["straggler"]
             if any(_space(k[0], k[2]) == "restage" for k in r["keys"])]
    assert {r["model"] for r in moved} == {0, 1}
    # the exchanges: each model rank of each data rank seals its own
    ex = {(r["data"], r["model"]) for r in served[0]["data"]["chunked"]
          if any(_space(k[0], k[2]) == "exchange" for k in r["keys"])}
    assert ex == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_a_live_replan_keeps_the_streams(served):
    ranks = served[0]["pods"]
    for r in ranks["straggler"]:
        assert r["streams"] == ranks["tight"][0]["streams"]
        assert r["stats"]["swaps"] >= 1
        assert any(k == "swap" and d["migrated"] for _, k, d in r["events"])
        assert r["moved"] + r["restored"] > 0


def test_a_device_death_keeps_the_streams(served):
    ranks = served[0]["pods"]
    for r in ranks["death"]:
        assert r["streams"] == ranks["calm"][0]["streams"]
        st = r["stats"]
        assert st["faults"]["device_death"] == 1, st["faults"]
        assert st["recovery"]["device_loss_replans"] == 1
        assert st["failure_replans"] == 1


def test_a_stage_stall_keeps_the_streams(served):
    ranks = served[0]["pods"]
    for r in ranks["stall"]:
        assert r["streams"] == ranks["calm"][0]["streams"]
        assert r["stats"]["faults"]["stage_stall"] >= 1, r["stats"]["faults"]


def test_every_rank_takes_the_same_decisions(served):
    for key, runs in served[0].items():
        for name, ranks in runs.items():
            for r in ranks[1:]:
                assert r["events"] == ranks[0]["events"], (key, name)
                assert r["stats"] == ranks[0]["stats"], (key, name)
                assert r["admission_ms"] == ranks[0]["admission_ms"]


# ---------------------------------------------------------------------------
# (f) what a rank holds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key,arch", sorted(CASES), ids=str)
def test_each_rank_holds_its_blocks(served, key, arch):
    from repro_torch.launch.mesh import LogicalMesh
    api = served[1][arch][0]
    cfg = api.cfg
    mesh = LogicalMesh(MESHES[CASES[(key, arch)]], ("pod", "data", "model"))
    M = mesh.shape[2]
    seg = api.model.served_segment.name
    specs = api.param_specs()
    for r in served[0][key]["chunked"]:
        lo, hi = r["range"]
        coords = {"pod": r["stage"], "data": r["data"], "model": r["model"]}
        want = []
        for k, v in specs.items():
            if k not in ("embed", "ln_f", "head", seg):
                continue
            for sp in leaves(v):
                blk = S.leaf_block(sp, mesh, coords, PIPE_PARAM_RULES)
                shape = list(sp.shape)
                if blk is not None:
                    shape = [len(range(n)[b]) for b, n in zip(blk, shape)]
                if k == seg:
                    shape[0] = hi - lo
                want.append((k, tuple(shape)))
        kept = [w for k, w in want if k == seg or (
            k == "embed" and (r["stage"] == 0 or (
                cfg.tie_embeddings and r["stage"] == MESHES[CASES[(
                    key, arch)]][0] - 1)))
            or (k in ("ln_f", "head") and r["stage"] == MESHES[CASES[(
                key, arch)]][0] - 1)]
        assert sorted(r["param_shapes"]) == sorted(kept)
        heads = cfg.num_kv_heads // M if cfg.num_kv_heads % M == 0 \
            else cfg.num_kv_heads
        for shp in r["kv_shapes"]:
            assert shp[2] == heads
    for r in served[0][key]["timeline"]:
        S_ = 128 // M if cfg.num_kv_heads % M else 128
        assert all(shp[3] == S_ for shp in r["kv_shapes"]), r["kv_shapes"]
    if arch == "glm4-9b":
        # the whole pool on every rank; the timeline's positions a quarter
        assert served[0][key]["chunked"][0]["kv_shapes"][0][2] == 2
        assert served[0][key]["timeline"][0]["kv_shapes"][0][3] == 128 // 4
        # the flash-decode's two messages a layer in every decode step
        for r in served[0][key]["timeline"]:
            assert all(q > 0 and c > 0 for _, q, c in r["model_bytes"])
    else:
        for r in served[0][key]["timeline"]:
            assert all(q == c == 0 and b > 0 for b, q, c in r["model_bytes"])


# ---------------------------------------------------------------------------
# (g) the paged kernel's first KV head
# ---------------------------------------------------------------------------
def _paged_case(H, KVH, rep_rank, D, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(11)
    B, N, Pg, MP = 3, 9, 4, 4
    q = torch.randn(B, H, D, generator=g).to(device, dtype)
    kp = torch.randn(N, KVH, Pg, D, generator=g).to(device, dtype)
    vp = torch.randn(N, KVH, Pg, D, generator=g).to(device, dtype)
    bt = torch.randint(1, N, (B, MP), generator=g,
                       dtype=torch.int32).to(device)
    sl = torch.tensor([5, 0, 13], dtype=torch.int32, device=device)
    return q, kp, vp, bt, sl


@pytest.mark.parametrize("H,KVH,rep,kv0", [(8, 2, 8, 1), (1, 2, 1, 1),
                                           (4, 4, 2, 2), (4, 2, 2, 0)])
def test_plain_paged_attention_reads_from_its_first_kv_head(H, KVH, rep,
                                                            kv0):
    q, kp, vp, bt, sl = _paged_case(H, KVH, rep, 16, "cpu")
    G = H // rep
    got = ops.paged_attention(q, kp, vp, bt, sl, kv_head0=kv0, rep=rep)
    want = ref.paged_attention_ref(q, kp[:, kv0:kv0 + G].contiguous(),
                                   vp[:, kv0:kv0 + G].contiguous(), bt, sl)
    assert torch.equal(got, want)
    # the defaults are the one-card call
    if kv0 == 0 and rep == H // KVH:
        assert torch.equal(ops.paged_attention(q, kp, vp, bt, sl), want)
    with pytest.raises(ValueError):
        ops.paged_attention(q, kp, vp, bt, sl, kv_head0=KVH, rep=rep)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_reads_from_its_first_kv_head(dtype):
    for H, KVH, rep, kv0, D in ((8, 2, 8, 1, 128), (16, 8, 4, 4, 64)):
        q, kp, vp, bt, sl = _paged_case(H, KVH, rep, D, "cuda", dtype)
        got = ops.paged_attention(q, kp, vp, bt, sl, kv_head0=kv0, rep=rep)
        want = ref.paged_attention_ref(q, kp, vp, bt, sl, kv0, rep)
        assert (got.float() - want.float()).abs().max() < 2e-2


# ---------------------------------------------------------------------------
# (h) refusals
# ---------------------------------------------------------------------------
def test_what_the_model_axis_does_not_serve_is_refused_by_name(served):
    for errs in served[3]:
        assert errs["warmup"].startswith("NotImplementedError") \
            and "warmup=True" in errs["warmup"] \
            and "step 5c" in errs["warmup"], errs["warmup"]
        assert errs["disagg"].startswith("NotImplementedError") \
            and "disagg_role" in errs["disagg"] \
            and "step 5c" in errs["disagg"], errs["disagg"]
        for arch in ("hymba-1.5b", "xlstm-125m"):
            assert errs[arch].startswith("NotImplementedError") \
                and "step 5c" in errs[arch], (arch, errs[arch])
        assert "int8" in errs["int8"] and "step 5c" in errs["int8"], \
            errs["int8"]
