"""The prefill and decode serve steps over a ``model`` axis of ranks
(tensor parallelism: ``runtime.steps.make_prefill_step`` /
``make_decode_step`` on a ``DeviceMesh`` of gloo CPU ranks, each rank
holding its shard of the params), reduced configs in f32, one thread a
rank:

- glm4-9b on (2, 4) ("data", "model"), 8 ranks: its two KV heads do not
  divide over 4, so they stay whole (the reference's prefill cache then
  splits its 12 positions over model, 3 a rank, and so do the ranks; the
  decode cache's 15 do not divide and stay whole);
- llama3.2-1b (tied head), qwen2-moe-a2.7b (experts over model, its
  attention biases drawn nonzero) and moonshot-v1-16b-a3b (a dense stem
  ahead of the MoE blocks) on (2, 1, 2) ("pod", "data", "model"), 4
  ranks, in one spawn.

(a) Against the reference's ``make_prefill_step`` / ``make_decode_step``
    on the same mesh of fake XLA devices (run once in a subprocess while
    the ranks run): the [B, V] logits of the prefill and of 3 greedy
    decode steps within 1e-4 of the largest |logit| (the port's f32
    tolerance), greedy tokens equal.
(b) Each rank's prefill and final decode cache equal the reference's
    shard on that rank's device under ``cache_shardings``, shard to shard
    within 1e-4 of each leaf's largest |value|, also where the reference
    splits the positions over model (KV heads that do not divide).
(b') The distributed flash-decode (glm4-9b on (1, 4) in the (2, 1, 2)
    spawn): a 10-token prefill keeps every position (10 does not divide),
    the cache grown to a horizon of 16 holds 4 positions a rank, and 3
    greedy decode steps write positions 10, 11 and 12, the last past the
    end of rank 2's block into rank 3's, which was empty until then. Its
    logits stay within 1e-4 of the largest |logit| of the reference's
    decode step on the same mesh (where ``cache_shardings`` puts those
    positions on model) and of the one-card decode, with equal tokens;
    each rank's cache is the reference's shard on its device and its
    block of the one-card cache; each step sends one query gather and one
    partial combine a layer.
(c) The whole logits are the same bits on every rank.
(d) Each rank's param shapes are the shard shapes of ``param_shardings``
    on the whole mesh (the reference's: every ``embed`` dim over data too,
    on glm4-9b's (2, 4)); the sharded draw equals ``shard_params`` of the
    whole draw bit for bit.
(e) What the model axis does not run yet is refused by name with its
    roadmap step; the train step and the prefill step under
    ``SP_ACT_RULES`` build (step 5b).

The helpers of ``sharding.tensor_parallel`` on 2 gloo ranks:
``reduce_model`` gives both ranks the f32 sum rounded once, the
vocab-split lookup the whole table's rows bit for bit; with no mesh (or
a mesh of one) every helper is the identity.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import rank_jobs as J
from repro_torch.launch.mesh import LogicalMesh, make_mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.runtime import steps as S
from repro_torch.sharding import rules as R
from repro_torch.sharding import tensor_parallel as TP
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

B, SQ, STEPS = 8, 12, 3
F32_TOL = 1e-4
WIDE = ((2, 4), ("data", "model"))
PODS = ((2, 1, 2), ("pod", "data", "model"))
CASES = {"glm4-9b": WIDE, "llama3.2-1b": PODS, "qwen2-moe-a2.7b": PODS,
         "moonshot-v1-16b-a3b": PODS}

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.configs.base import ShapeConfig
from repro.models.api import build_model
from repro.runtime import steps as S
from repro.sharding import rules as R

data = pickle.load(open(PATH, "rb"))
B, SQ, STEPS = data["shape"]


def shards(tree, mesh):
    # each device's block of each leaf, keyed by its mesh coordinates
    out = {}
    for idx in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[idx]
        out[idx] = [np.asarray(next(s.data for s in x.addressable_shards
                                    if s.device == dev))
                    for x in jax.tree.leaves(tree)]
    return out


def serve(arch, shape, axes, tokens, horizon):
    # the prefill of tokens [B, sq], the cache grown to horizon under the
    # decode step's cache_shardings, and STEPS greedy decode steps
    cfg = reduced(get_arch(arch))
    api = build_model(cfg, max_seq=horizon)
    params = jax.tree.map(jnp.asarray, data["params"][arch])
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(axes))
    sq = tokens.shape[1]
    pre = S.make_prefill_step(api, mesh, ShapeConfig("p", sq, B, "prefill"))
    dshape = ShapeConfig("d", horizon, B, "decode")
    dec = S.make_decode_step(api, mesh, dshape)
    logits, cache = pre(params, {"tokens": jnp.asarray(tokens)})
    out = {"logits": [np.asarray(logits)], "prefill": shards(cache, mesh)}
    grown = {k: v if k == "len" else tuple(
        jnp.pad(t, ((0, 0),) * 3 + ((0, horizon - sq), (0, 0))) for t in v)
        for k, v in cache.items()}
    cache = jax.device_put(grown, S.cache_shardings(
        api, B, mesh, R.ACT_RULES, max_seq=horizon))
    tok_sharding = S.batch_shardings(api, dshape, mesh,
                                     R.ACT_RULES)["tokens"]
    for _ in range(STEPS):
        tok = jax.device_put(
            jnp.argmax(logits, -1)[:, None].astype(jnp.int32), tok_sharding)
        logits, cache = dec(params, cache, {"tokens": tok})
        out["logits"].append(np.asarray(logits))
    out["decode"] = shards(cache, mesh)
    return out


res = {arch: serve(arch, shape, axes, data["tokens"][arch], SQ + STEPS)
       for arch, (shape, axes) in data["cases"].items()}
# the distributed flash-decode: the decode horizon's positions over model
flash = data["flash"]
res["flash"] = serve(flash["arch"], *flash["mesh"], flash["tokens"],
                     flash["horizon"])
pickle.dump(res, open(PATH, "wb"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_params(arch):
    """The reference's f32 init of the reduced config as numpy, with
    every attention bias drawn nonzero (the initializer's zeros would
    hide a bias cut on the wrong heads)."""
    import jax
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    try:
        japi = jbuild(jreduced(jget(arch)), max_seq=SQ + STEPS)
        tree = jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32))
            if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x),
            japi.init(jax.random.PRNGKey(0)))
    finally:
        JL.DEFAULT_DTYPE = old
    rng = np.random.RandomState(7)

    def biases(t):
        if isinstance(t, dict):
            return {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
                    if k in ("bq", "bk", "bv") else biases(v)
                    for k, v in t.items()}
        return t

    return biases(tree)


def draw_body(ctx, job):
    """Whether this rank's sharded draw (``draw_params``) equals the shard
    of the whole draw (``shard_params``), bit for bit."""
    api = build_model(job.cfg, device="cpu", dtype=job.dtype,
                      max_seq=job.max_seq)
    mesh = make_mesh(*job.mesh, device="cpu")
    a = S.draw_params(api, mesh, torch.Generator().manual_seed(job.seed))
    b = S.shard_params(api, mesh,
                       api.init(torch.Generator().manual_seed(job.seed)))
    return all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(leaves(a), leaves(b)))


# the distributed flash-decode: glm4-9b on (1, 4), a 10-token prompt (its
# positions stay whole), a decode horizon of 16 (4 positions a rank)
FLASH = ((1, 4), ("data", "model"))
FLASH_SQ, FLASH_HORIZON = 10, 16


def refusal_body(ctx, cfg):
    """The refusals of a (2, 1, 2) model axis, as messages by case."""
    from repro_torch.runtime.pipeline import PipelinedDecoder
    from repro_torch.optim.adamw import AdamWConfig
    mesh = make_mesh(*PODS, device="cpu")
    shape = ShapeConfig("p", SQ, B, "prefill")
    dense = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=32)
    out = {}
    cases = {
        "train": lambda: S.make_train_step(
            dense, AdamWConfig(), ShapeConfig("t", SQ, B, "train"),
            device="cpu", mesh=mesh),
        "sp": lambda: S.make_prefill_step(dense, mesh, shape,
                                          act_rules=R.SP_ACT_RULES),
        "int8": lambda: S.make_decode_step(
            build_model(cfg, device="cpu", dtype=torch.float32, max_seq=32,
                        cache_quant=True), mesh, shape),
        "decoder": lambda: PipelinedDecoder(dense, num_stages=2,
                                            num_microbatches=1, mesh=mesh),
        "decoder_vlm": lambda: PipelinedDecoder(
            build_model(reduced(get_arch("qwen2-vl-7b")), device="cpu",
                        dtype=torch.float32, max_seq=32), num_stages=2,
            num_microbatches=1, mesh=mesh),
        "whole_params": lambda: S.make_prefill_step(dense, mesh, shape)(
            dense.init(torch.Generator().manual_seed(0)),
            {"tokens": torch.zeros((B, SQ), dtype=torch.int32)}),
    }
    for arch in ("hymba-1.5b", "xlstm-125m", "whisper-small",
                 "qwen2-vl-7b"):
        api = build_model(reduced(get_arch(arch)), device="cpu",
                          dtype=torch.float32, max_seq=32)
        cases[arch] = lambda api=api: S.make_prefill_step(api, mesh, shape)
    for name, make in cases.items():
        try:
            make()
            out[name] = "built"
        except (NotImplementedError, ValueError, AssertionError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{arch: (the reference's results, the port's api and whole params,
    the ranks' results)} and the (2, 1, 2) ranks' refusals."""
    pytest.importorskip("jax")
    jparams = {arch: _jax_params(arch) for arch in CASES}
    toks = {arch: np.random.RandomState(31).randint(
        0, reduced(get_arch(arch)).vocab_size, (B, SQ), dtype=np.int32)
        for arch in CASES}
    path = str(tmp_path_factory.mktemp("model_ranks") / "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump({"shape": (B, SQ, STEPS), "cases": CASES,
                     "params": jparams, "tokens": toks,
                     "flash": {"arch": "glm4-9b", "mesh": FLASH,
                               "tokens": toks["glm4-9b"][:, :FLASH_SQ],
                               "horizon": FLASH_HORIZON}}, f)
    env = dict(os.environ)
    # XLA's CPU kernels on one thread: twelve ranks run beside it, and
    # the reference's wall-clock-timed tests beside them
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.replace("PATH", repr(path))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port, jobs = {}, {}
        for arch, mesh in CASES.items():
            cfg = reduced(get_arch(arch))
            api = build_model(cfg, device="cpu", dtype=torch.float32,
                              max_seq=SQ + STEPS)
            params = params_from_jax(jparams[arch], "cpu")
            port[arch] = (api, params)
            jobs[arch] = J.StepsJob(cfg, mesh, torch.from_numpy(toks[arch]),
                                    steps=STEPS, params=params)
        wide = spawn(J.chain, 8, backend="gloo", device="cpu", args=(
            [(J.serve_steps, jobs["glm4-9b"]),
             (draw_body, jobs["glm4-9b"])],))
        pods = [a for a in CASES if CASES[a] is PODS]
        flash = J.StepsJob(reduced(get_arch("glm4-9b")), FLASH,
                           torch.from_numpy(toks["glm4-9b"][:, :FLASH_SQ]),
                           steps=STEPS, horizon=FLASH_HORIZON,
                           params=port["glm4-9b"][1])
        chained = spawn(J.chain, 4, backend="gloo", device="cpu", args=(
            [(J.serve_steps, jobs[a]) for a in pods]
            + [(draw_body, jobs[a]) for a in pods]
            + [(refusal_body, reduced(get_arch("llama3.2-1b"))),
               (J.serve_steps, flash)],))
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REFERENCE OK" in out, err[-4000:]
        with open(path, "rb") as f:
            ref = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ranks = {"glm4-9b": [dict(c[0], draw_equal=c[1]) for c in wide]}
    for i, arch in enumerate(pods):
        ranks[arch] = [dict(c[i], draw_equal=c[len(pods) + i])
                       for c in chained]
    res = {arch: (ref[arch], *port[arch], ranks[arch]) for arch in CASES}
    yield res, [c[-2] for c in chained], [c[-1] for c in chained], \
        ref["flash"]


@pytest.mark.parametrize("arch", sorted(CASES))
def test_model_ranks_hold_the_reference(steps, arch):
    ref, _, _, ranks = steps[0][arch]
    for r in ranks:
        assert len(r["logits"]) == len(ref["logits"]) == STEPS + 1
        for got, want in zip(r["logits"], ref["logits"]):
            assert tuple(got.shape) == want.shape == (B, got.shape[1])
            assert _rel(got.numpy(), want) < F32_TOL
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          want.argmax(-1))
    # (c) the same bits on every rank
    for r in ranks[1:]:
        for a, b in zip(r["logits"], ranks[0]["logits"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_each_rank_holds_the_reference_cache_shard(steps, arch):
    ref, api, _, ranks = steps[0][arch]
    shape, _ = CASES[arch]
    for rank, r in enumerate(ranks):
        coords = tuple(int(c) for c in np.unravel_index(rank, shape))
        for key, got in (("prefill", r["prefill_cache"]),
                         ("decode", r["cache"])):
            want = ref[key][coords]
            got = leaves(got)
            assert len(got) == len(want)
            for i, (g, w) in enumerate(zip(got, want)):
                # shard to shard: the rank holds the reference's block
                assert tuple(g.shape) == w.shape, (key, coords, g.shape,
                                                   w.shape)
                if g.dim() == 0:
                    assert int(g) == int(w)
                else:
                    assert _rel(g.numpy(), w) < F32_TOL, (key, coords)
    if arch == "glm4-9b":
        # the KV heads stay whole; the prefill's 12 positions split over
        # model, 3 a rank, and the decode horizon's 15 stay whole
        for r in ranks:
            k = r["prefill_cache"]["blocks"][0]
            assert k.shape[2] == 2 and k.shape[3] == SQ // 4
            assert r["cache"]["blocks"][0].shape[3] == SQ + STEPS
        assert ref["prefill"][(0, 0)][0].shape[3] == SQ // 4


@pytest.mark.parametrize("arch", sorted(CASES))
def test_each_rank_holds_its_param_shards(steps, arch):
    _, api, params, ranks = steps[0][arch]
    want = [sh.shard_shape(sp.shape) for sh, sp in zip(
        leaves(S.param_shardings(api, LogicalMesh(*CASES[arch]))),
        leaves(api.param_specs()))]
    whole = sum(t.numel() * t.element_size() for t in leaves(params))
    for r in ranks:
        assert r["param_shapes"] == want
        assert r["draw_equal"]
        assert r["param_bytes"] < whole
    if arch == "qwen2-moe-a2.7b":
        assert ranks[0]["param_shapes"][leaves(api.param_specs()).index(
            api.param_specs()["blocks"]["moe"]["wi"])][1] == 4


def test_what_the_model_axis_does_not_run_is_refused_by_name(steps):
    for errs in steps[1]:
        # the train step runs over a model axis since step 5b
        assert errs["train"] == "built", errs["train"]
        # and under SP_ACT_RULES (Megatron-SP) since step 5b's rest
        assert errs["sp"] == "built", errs["sp"]
        assert "int8" in errs["int8"] and "step 5c" in errs["int8"]
        # the pipelined decoder runs over a model axis since step 5c
        assert errs["decoder"] == "built", errs["decoder"]
        assert errs["decoder_vlm"].startswith("NotImplementedError") \
            and "step 5c" in errs["decoder_vlm"], errs["decoder_vlm"]
        assert errs["whole_params"].startswith("ValueError") \
            and "shard_params" in errs["whole_params"]
        for arch in ("hymba-1.5b", "xlstm-125m", "whisper-small",
                     "qwen2-vl-7b"):
            assert errs[arch].startswith("NotImplementedError") \
                and "step 5c" in errs[arch], (arch, errs[arch])


# ---------------------------------------------------------------------------
# (b') the distributed flash-decode
# ---------------------------------------------------------------------------
def _one_card_flash(api, params, tokens):
    """The one-card prefill of ``tokens``, the cache grown to the flash
    horizon and 3 greedy decode steps: (logits each call, final cache)."""
    logits, cache = api.prefill_fn(params, {"tokens": tokens})
    cache = J.grow_cache(api, cache, FLASH_HORIZON - FLASH_SQ)
    out = [logits]
    for _ in range(STEPS):
        tok = out[-1].argmax(-1)[:, None].to(torch.int32)
        logits, cache = api.decode_fn(params, cache, {"tokens": tok})
        out.append(logits)
    return out, cache


@pytest.fixture(scope="module")
def flash(steps):
    _, api, params, _ = steps[0]["glm4-9b"]
    toks = torch.from_numpy(np.random.RandomState(31).randint(
        0, api.cfg.vocab_size, (B, SQ), dtype=np.int32)[:, :FLASH_SQ])
    return _one_card_flash(api, params, toks), steps[2], steps[3]


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_flash_decode_holds_the_one_card_decode(flash, step):
    """Step 0 is the prefill; steps 1 and 2 attend positions that leave
    rank 3's block empty, step 3 writes position 12 into it."""
    (want, _), ranks, _ = flash
    w = want[step].numpy()
    for r in ranks:
        got = r["logits"][step].numpy()
        assert _rel(got, w) < F32_TOL, step
        np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))
        assert torch.equal(r["logits"][step], ranks[0]["logits"][step])


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_flash_decode_holds_the_reference_decode(flash, step):
    """The reference's decode step on the same (1, 4) mesh of fake
    devices, where ``cache_shardings`` puts the horizon's positions on
    model: each rank's logits within 1e-4 of its largest |logit|, the
    same greedy tokens."""
    _, ranks, ref = flash
    w = ref["logits"][step]
    for r in ranks:
        got = r["logits"][step].numpy()
        assert got.shape == w.shape
        assert _rel(got, w) < F32_TOL, step
        np.testing.assert_array_equal(got.argmax(-1), w.argmax(-1))


def test_flash_decode_ranks_hold_the_reference_shards(flash):
    """Each rank's prefill cache (10 positions, whole) and final decode
    cache (its 4 of 16 positions) equal the reference's shard on that
    rank's device, shard to shard within 1e-4 of each leaf's largest
    |value|."""
    _, ranks, ref = flash
    for m, r in enumerate(ranks):
        for key, got in (("prefill", r["prefill_cache"]),
                         ("decode", r["cache"])):
            want = ref[key][(0, m)]
            got = leaves(got)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert tuple(g.shape) == w.shape, (key, m, g.shape, w.shape)
                if g.dim() == 0:
                    assert int(g) == int(w)
                else:
                    assert _rel(g.numpy(), w) < F32_TOL, (key, m)
        assert ref["decode"][(0, m)][0].shape[3] == FLASH_HORIZON // 4


def test_flash_decode_ranks_hold_their_positions(flash):
    (_, whole), ranks, _ = flash
    n = FLASH_HORIZON // 4
    for m, r in enumerate(ranks):
        # the prefill's 10 positions stay whole (10 does not divide)
        assert r["prefill_cache"]["blocks"][0].shape[3] == FLASH_SQ
        for g, w in zip(r["cache"]["blocks"], whole["blocks"]):
            assert g.shape[3] == n and g.shape[2] == 2
            assert _rel(g.numpy(), w[:, :, :, m * n:(m + 1) * n].numpy()) \
                < F32_TOL
        assert int(r["cache"]["len"]) == FLASH_SQ + STEPS
        # rank 3's block holds position 12 only, written at the last step
        blk = r["cache"]["blocks"][0]
        if m == 3:
            assert blk[..., 0, :].abs().amax() > 0
            assert torch.count_nonzero(blk[..., 1:, :]) == 0
    L, D = ranks[0]["cache"]["blocks"][0].shape[0], 16
    H, b = 4, B
    for r in ranks:
        for qg, comb in r["decode_flash_bytes"]:
            # one [B, 1, H / M, D] query gather and one f32 [B, H, D + 2]
            # partial combine a layer, each rank's share of the gather
            assert qg == L * b * (H // 4) * D * 4
            assert comb == L * b * H * (D + 2) * 4


# ---------------------------------------------------------------------------
# The helpers
# ---------------------------------------------------------------------------
V, DIM = 24, 5


def helper_body(ctx):
    mesh = make_mesh((2,), ("model",), device="cpu")
    g = torch.Generator().manual_seed(ctx.rank)
    out = {"part": torch.randn(3, 7, generator=g)}
    out["part16"] = out["part"].to(torch.bfloat16)
    table = torch.randn(V, DIM, generator=torch.Generator().manual_seed(9))
    ids = torch.randint(0, V, (4, 6),
                        generator=torch.Generator().manual_seed(3))
    with R.axis_rules(mesh):
        out["sum"] = TP.reduce_model(out["part"].clone())
        out["sum16"] = TP.reduce_model(out["part16"].clone())
        out["gather"] = TP.gather_model(out["part"], 1)
        half = V // 2
        out["rows"] = TP.embed_lookup(
            table[ctx.rank * half:(ctx.rank + 1) * half], ids, V)
        out["whole_rows"] = TP.embed_lookup(table, ids, V)
        # a block of 4 positions is this rank's of 8; a whole cache of 8
        # under a horizon of 8 is refused by name
        with TP.kv_positions(8):
            out["horizon"] = TP.whole_positions(4)
            try:
                TP.whole_positions(8)
            except ValueError as e:
                out["refused"] = str(e)
    out["want_rows"] = table[ids.long()]
    return out


def test_helpers_on_two_ranks():
    a, b = spawn(helper_body, 2, backend="gloo", device="cpu")
    for r in (a, b):
        assert torch.equal(r["sum"], a["part"] + b["part"])
        assert torch.equal(r["sum16"], (a["part16"].float()
                                        + b["part16"].float()).to(
            torch.bfloat16))
        assert r["sum16"].dtype == torch.bfloat16
        assert torch.equal(r["gather"], torch.cat([a["part"], b["part"]], 1))
        assert torch.equal(r["rows"], r["want_rows"])
        assert torch.equal(r["whole_rows"], r["want_rows"])
        assert r["horizon"] == 8
        assert "not this rank's block of the 8 positions" in r["refused"]
    for k in ("sum", "sum16", "gather", "rows"):
        assert torch.equal(a[k], b[k])


def test_helpers_are_the_identity_off_a_model_axis():
    x = torch.randn(3, 4)
    table = torch.randn(V, DIM)
    ids = torch.randint(0, V, (2, 3))
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        with R.axis_rules(mesh):
            assert TP.current() is None
            assert TP.reduce_model(x) is x
            assert TP.gather_model(x, 0) is x
            assert torch.equal(TP.embed_lookup(table, ids, V),
                               table[ids])
            assert TP.kv_for_heads(8, 2, 8, 2) is None
            assert not TP.split(2, 4)
            with TP.kv_positions(16):
                assert TP.positions_split() is None
                assert TP.whole_positions(16) == 16
