"""The residual stream's sequence split over the ``model`` axis of ranks
(``SP_ACT_RULES``, Megatron-SP: ``act_seq_sp`` over ``model``) in the
train step and both serve steps, on gloo CPU ranks; reduced configs in
f32 from the reference's weights (``params_from_jax``; attention biases
drawn nonzero), batch 8, one thread a rank:

- llama3.2-1b (tied, vocab-split head) on (2, 1, 2) pod x data x model;
- qwen2-moe-a2.7b (experts over model; it drops at capacity in train
  mode) on (2, 2) data x model, its norms split over data as well;
- glm4-9b on (1, 4) data x model: its two KV heads stay whole over four
  (``copy_to_model`` on k and v beside the whole gather of the normed
  block). The sequence's reduce-scatter is ``reduce_model``'s all-reduce
  cut to the rank's block, so over four ranks as over two the SP loss is
  the non-SP loss's bits.

(a) Train steps at 8 x 32, each from the reference's state before it
    (tests/test_torch_train_model_ranks.py's ``_reference_steps``), under
    ``SP_ACT_RULES`` and under ``ACT_RULES`` on the same mesh: the SP
    loss within rtol 1e-5 and grad norm within rtol 5e-5 of the
    reference's one-device step (2e-5 of the port's one-device step), as
    that file's (a); the loss the same bits as the non-SP step's and
    every gradient (what AdamW receives) within atol 1e-6 + rtol 1e-5 of
    the non-SP step's; the norms' gradients and
    every block of the new params the same bits on every rank that holds
    the block; the sequence's gathers and reduce-scatters and the norms'
    sum counted, apart from the model axis's other collectives.
(b) The SP prefill step (8 x 16) against the reference's
    ``make_prefill_step(..., act_rules=SP_ACT_RULES)`` on the same mesh of
    fake XLA devices (run once in a subprocess while the ranks run):
    logits within 1e-4 of the largest |logit|, greedy tokens equal; each
    SP decode step's logits the same bits as the non-SP decode step's on
    the same cache and tokens (its one position does not split: it runs
    as without the rules); on the two-rank model axes the SP prefill's
    logits and cache and the decode steps after it the same bits as the
    non-SP steps'.
(c) A sequence that does not divide over the model axis (31 positions
    over 2) gives the non-SP train step bit for bit, with no sequence
    message.
(d) ``gather_seq`` (as a share and whole), ``reduce_scatter_seq``,
    ``keep_seq`` and the vocab-split ``embed_lookup(seq=True)`` on two
    ranks: values the one-rank function's block, backwards against
    autograd of the one-rank function: atol 1e-6 + rtol 1e-5;
    ``seq_split`` holds exactly where ``act_seq_sp`` resolves to
    ``model``; off a model axis every helper is the identity.
(e) The remat recompute's sequence gathers run on a thread that never
    entered the rule context (a card's autograd device thread) and give
    the same gradient bits.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import test_torch_train_model_ranks as TM
from conftest import SRC
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.launch import rank_jobs as J
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.runtime import steps as S
from repro_torch.sharding import rules as R
from repro_torch.sharding import tensor_parallel as TP
from repro_torch.tree import leaves, map_tree, named_leaves
from repro_torch.weights import params_from_jax

B, SEQ, STEPS = TM.B, TM.SEQ, 2
PODS = ((2, 1, 2), ("pod", "data", "model"))
DM = ((2, 2), ("data", "model"))
WIDE = ((1, 4), ("data", "model"))
PAIR = ((1, 2), ("data", "model"))
CASES = {"llama3.2-1b": PODS, "qwen2-moe-a2.7b": DM, "glm4-9b": WIDE}
SQ, SERVE_STEPS, F32_TOL = 16, 3, 1e-4
SERVE = {"llama3.2-1b": PODS, "qwen2-moe-a2.7b": PODS, "glm4-9b": WIDE}
ODD = 31                           # (c): positions that do not split over 2

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
B, SQ = data["shape"]
res = {}
for arch, (shape, axes) in data["cases"].items():
    api = build_model(reduced(get_arch(arch)), max_seq=SQ)
    params = jax.tree.map(jnp.asarray, data["params"][arch])
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(axes))
    pre = S.make_prefill_step(api, mesh, ShapeConfig("p", SQ, B, "prefill"),
                              act_rules=R.SP_ACT_RULES)
    logits, _ = pre(params, {"tokens": jnp.asarray(data["tokens"][arch])})
    res[arch] = np.asarray(logits)
pickle.dump(res, open(PATH, "wb"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _api(arch, seq=SEQ):
    return build_model(reduced(get_arch(arch)), device="cpu",
                       dtype=torch.float32, max_seq=seq)


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FromState:
    """Train steps on ``mesh`` under ``ACT_RULES`` and ``SP_ACT_RULES``,
    each from a whole state on the CPU cut to the rank's blocks."""
    arch: str
    mesh: tuple
    params: list
    opt: list
    batches: list


def _recording(grads: list):
    """``adamw.update`` that first keeps a copy of the gradients it gets
    (the step's reduced ones)."""
    update = adamw.update

    def spy(cfg, g, *args, **kw):
        grads.append(map_tree(lambda t: t.clone(), g))
        return update(cfg, g, *args, **kw)

    return update, spy


def from_state(ctx, job: FromState) -> dict:
    mesh = make_mesh(*job.mesh, device="cpu")
    api = _api(job.arch)
    out = {"split": S.split_axes(api, mesh)}
    for name, rules in (("plain", None), ("sp", R.SP_ACT_RULES)):
        step = S.make_train_step(api, AdamWConfig(**TM.OPT),
                                 ShapeConfig("t", SEQ, B, "train"),
                                 device="cpu", mesh=mesh, act_rules=rules)
        cut = lambda tree: map_tree(lambda t: t.clone(),
                                    S.shard_params(api, mesh, tree))
        stagings = [step.model_staging, step.seq_gather_staging,
                    step.seq_scatter_staging, step.norms_staging]
        before = [st.collective if st else 0 for st in stagings]
        grads, runs = [], []
        update, spy = _recording(grads)
        adamw.update = spy
        try:
            for i, (p, o, b) in enumerate(zip(job.params, job.opt,
                                              job.batches)):
                loss, p, _, gnorm = step(cut(p), AdamWState(*map(cut, o)),
                                         b, np.int32(i))
                runs.append({"loss": loss, "gnorm": gnorm,
                             "digest": J.param_digest(p)})
        finally:
            adamw.update = update
        out[name] = {"steps": runs, "grads": grads, "bytes": [
            (st.collective if st else 0) - b0
            for st, b0 in zip(stagings, before)]}
    return out


def serve_pair(ctx, job: J.StepsJob) -> dict:
    """``rank_jobs.serve_steps`` under ``SP_ACT_RULES`` and without."""
    return {"plain": J.serve_steps(ctx, job),
            "sp": J.serve_steps(ctx, dataclasses.replace(
                job, act_rules=R.SP_ACT_RULES, plain_decode=True))}


def odd_pair(ctx, _) -> list:
    """Reduced llama3.2-1b's train step on PAIR over ODD positions, under
    ``ACT_RULES`` and ``SP_ACT_RULES``, from one seeded draw."""
    return [J.train(ctx, J.TrainJob(
        reduced(get_arch("llama3.2-1b")), PAIR, 2, B, ODD,
        opt=AdamWConfig(**TM.OPT), seed=3, keep=("params",),
        act_rules=rules)) for rules in (None, R.SP_ACT_RULES)]


# (d): a two-rank SP MLP, a whole elementwise product and the embedding
T_B, T_S, T_D, T_F, V = 3, 8, 6, 4, 16


def _helper_inputs():
    g = torch.Generator().manual_seed(5)
    return {"h": torch.randn(T_B, T_S, T_D, generator=g),
            "wi": torch.randn(T_D, T_F, generator=g),
            "wo": torch.randn(T_F, T_D, generator=g),
            "c": torch.randn(T_B, T_S, T_D, generator=g),
            "w": torch.randn(T_D, generator=g),
            "table": torch.randn(V, T_D, generator=g),
            "ids": torch.randint(0, V, (T_B, T_S), generator=g)}


def _block(t, r, n=2):
    s = t.shape[1] // n
    return t[:, r * s:(r + 1) * s]


def helpers(ctx, _):
    """Each SP helper's value and gradients on rank ``ctx.rank`` of a
    model axis of 2, and ``seq_split``'s answers."""
    mesh = make_mesh((2,), ("model",), device="cpu")
    r, t, out = ctx.rank, _helper_inputs(), {}
    half = T_F // 2
    with R.axis_rules(mesh, R.SP_ACT_RULES):
        out["seq_split"] = [TP.seq_split(n) for n in (8, 7, 1)]
        h = _block(t["h"], r).clone().requires_grad_()
        wi = t["wi"][:, r * half:(r + 1) * half].clone().requires_grad_()
        wo = t["wo"][r * half:(r + 1) * half].clone().requires_grad_()
        y = TP.reduce_scatter_seq(torch.nn.functional.gelu(
            TP.gather_seq(h) @ wi) @ wo)
        (y * _block(t["c"], r)).sum().backward()
        out["mlp"] = (y.detach(), h.grad, wi.grad, wo.grad)
        x = _block(t["h"], r).clone().requires_grad_()
        w = t["w"].clone().requires_grad_()
        z = TP.keep_seq(torch.sin(TP.gather_seq(x, share=False)) * w)
        (z * _block(t["c"], r)).sum().backward()
        out["whole"] = (z.detach(), x.grad, w.grad)
        table = t["table"][r * V // 2:(r + 1) * V // 2].clone() \
            .requires_grad_()
        e = TP.embed_lookup(table, t["ids"], V, seq=True)
        (e * _block(t["c"], r)).sum().backward()
        out["embed"] = (e.detach(), table.grad)
    with R.axis_rules(mesh):
        out["seq_split_plain"] = TP.seq_split(8)
    return out


def backward_thread(ctx, _):
    """The gradient of reduced glm4-9b's loss under ``SP_ACT_RULES`` on
    PAIR (remat and the chunked loss recomputed in the backward), taken
    on this thread and on one that never entered the rule context, with
    the sequence gathers each backward ran."""
    mesh = make_mesh(*PAIR, device="cpu")
    cfg = reduced(get_arch("glm4-9b"))
    api = _api("glm4-9b")
    params = S.shard_params(api, mesh, api.init(
        torch.Generator().manual_seed(3)))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokenStream(
        cfg.vocab_size, 2, SEQ).batch_at(0).items()}
    grads, gathers = [], []
    tp = TP.axis_of(mesh)
    for other in (False, True):
        tracked = map_tree(lambda t: t.detach().requires_grad_(), params)
        with R.axis_rules(mesh, R.SP_ACT_RULES):
            loss = api.loss_fn(tracked, batch)
        b0 = tp.seq_gather.collective

        def run():
            grads.append(torch.autograd.grad(loss, leaves(tracked)))

        if other:
            worker = threading.Thread(target=run)
            worker.start()
            worker.join()
        else:
            with R.axis_rules(mesh, R.SP_ACT_RULES):
                run()
        gathers.append(tp.seq_gather.collective - b0)
    return grads, gathers


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------
def _jax_params(arch):
    """The reference's f32 init of the reduced config as numpy, every
    attention bias drawn nonzero."""
    import test_torch_steps_model_ranks as SM
    return SM._jax_params(arch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    jparams = {arch: _jax_params(arch) for arch in SERVE}
    toks = {arch: np.random.RandomState(37).randint(
        0, reduced(get_arch(arch)).vocab_size, (B, SQ), dtype=np.int32)
        for arch in SERVE}
    path = str(tmp_path_factory.mktemp("sp_ranks") / "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump({"shape": (B, SQ), "cases": SERVE, "params": jparams,
                     "tokens": toks}, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.replace("PATH", repr(path))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ref = {arch: TM._reference_steps(arch) for arch in CASES}
        trains = [(from_state, FromState(
            arch, mesh, ref[arch]["params"][:STEPS],
            ref[arch]["opt"][:STEPS], ref[arch]["batches"][:STEPS]))
            for arch, mesh in CASES.items()]
        serves = [(serve_pair, J.StepsJob(
            reduced(get_arch(arch)), mesh, torch.from_numpy(toks[arch]),
            steps=SERVE_STEPS, params=params_from_jax(jparams[arch], "cpu"),
            max_seq=SQ + SERVE_STEPS)) for arch, mesh in SERVE.items()]
        four = spawn(J.chain, 4, backend="gloo", device="cpu",
                     args=(trains + serves,))
        two = spawn(J.chain, 2, backend="gloo", device="cpu", args=(
            [(helpers, None), (backward_thread, None), (odd_pair, None)],))
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REFERENCE OK" in out, err[-4000:]
        with open(path, "rb") as f:
            jref = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    n = len(CASES)
    return {"ref": ref, "jref": jref,
            "train": {a: [r[i] for r in four] for i, a in enumerate(CASES)},
            "serve": {a: [r[n + i] for r in four]
                      for i, a in enumerate(SERVE)},
            "helpers": [r[0] for r in two], "threads": [r[1] for r in two],
            "odd": [r[2] for r in two]}


def _model_size(mesh):
    return dict(zip(mesh[1], mesh[0]))["model"]


# ---------------------------------------------------------------------------
# (a) the train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(CASES))
def test_sp_train_step_holds_the_reference_and_the_plain_step(runs, arch):
    ref, ranks = runs["ref"][arch], runs["train"][arch]
    for i in range(STEPS):
        for r in ranks:
            sp, plain = r["sp"]["steps"][i], r["plain"]["steps"][i]
            np.testing.assert_allclose(float(sp["loss"]), ref["loss"][i],
                                       rtol=TM.RTOL)
            np.testing.assert_allclose(float(sp["gnorm"]), ref["gnorm"][i],
                                       rtol=TM.GNORM_RTOL)
            np.testing.assert_allclose(float(sp["gnorm"]),
                                       ref["one_gnorm"][i],
                                       rtol=TM.ONE_GNORM_RTOL)
            assert torch.equal(sp["loss"], plain["loss"]), (arch, i)
            assert torch.equal(sp["loss"], ranks[0]["sp"]["steps"][i]["loss"])
            assert torch.equal(sp["gnorm"],
                               ranks[0]["sp"]["steps"][i]["gnorm"])
            for k, (g, w) in enumerate(zip(leaves(r["sp"]["grads"][i]),
                                           leaves(r["plain"]["grads"][i]))):
                torch.testing.assert_close(g, w, atol=TM.GRAD_ATOL,
                                           rtol=TM.GRAD_RTOL,
                                           msg=f"{arch} step {i} leaf {k}")


@pytest.mark.parametrize("arch", sorted(CASES))
def test_sp_blocks_and_norms_agree_across_ranks(runs, arch):
    ranks, mesh = runs["train"][arch], CASES[arch]
    api = build_model(reduced(get_arch(arch)), device="meta")
    names = list(named_leaves(api.param_specs()))
    norms = [names.index(n) for n in api.model.seq_norms()]
    split = ranks[0]["split"]
    assert all("model" not in split[k] for k in norms)
    for i in range(STEPS):
        for rank, r in enumerate(ranks):
            for k, axes in enumerate(split):
                peer = ranks[TM._holder(rank, mesh, axes)]
                assert r["sp"]["steps"][i]["digest"][k] == \
                    peer["sp"]["steps"][i]["digest"][k], (arch, i, rank, k)
                if k in norms:
                    # the norms' gradients: summed over the model group
                    assert torch.equal(leaves(r["sp"]["grads"][i])[k],
                                       leaves(peer["sp"]["grads"][i])[k])
    for r in ranks:
        model, gathers, scatters, norm_sum = r["sp"]["bytes"]
        assert gathers > 0 and scatters > 0 and norm_sum > 0
        # the sequence messages left the model axis's other collectives
        assert model < r["plain"]["bytes"][0]
        assert r["plain"]["bytes"][1:] == [0, 0, 0]


# ---------------------------------------------------------------------------
# (b) the serve steps
# ---------------------------------------------------------------------------
def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("arch", sorted(SERVE))
def test_sp_prefill_holds_the_reference_sp_prefill(runs, arch):
    want = runs["jref"][arch]
    for r in runs["serve"][arch]:
        got = r["sp"]["logits"][0].numpy()
        assert got.shape == want.shape == (B, got.shape[1])
        assert _rel(got, want) < F32_TOL
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        gathers, scatters = r["sp"]["prefill_seq_bytes"]
        assert gathers > 0 and scatters > 0
        assert r["plain"]["prefill_seq_bytes"] == (0, 0)
        # a decode step's one position does not split
        assert all(b == (0, 0) for b in r["sp"]["decode_seq_bytes"])
        assert len(r["sp"]["plain_decode_logits"]) == SERVE_STEPS
        for a, b in zip(r["sp"]["logits"][1:],
                        r["sp"]["plain_decode_logits"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(a for a, m in SERVE.items()
                                        if _model_size(m) == 2))
def test_sp_serve_steps_are_the_plain_steps_bit_for_bit(runs, arch):
    for r in runs["serve"][arch]:
        sp, plain = r["sp"], r["plain"]
        assert len(sp["logits"]) == SERVE_STEPS + 1
        for a, b in zip(sp["logits"], plain["logits"]):
            assert torch.equal(a, b)
        for key in ("prefill_cache", "cache"):
            assert all(torch.equal(a, b) for a, b in
                       zip(leaves(sp[key]), leaves(plain[key])))


# ---------------------------------------------------------------------------
# (c) a sequence that does not divide
# ---------------------------------------------------------------------------
def test_an_indivisible_sequence_runs_the_plain_step(runs):
    for plain, sp in runs["odd"]:
        assert sp["losses"] == plain["losses"]
        assert sp["gnorms"] == plain["gnorms"]
        assert sp["digests"] == plain["digests"]
        assert sp["seq_gather_bytes_per_step"] == 0
        assert sp["seq_scatter_bytes_per_step"] == 0
        assert sp["norms_bytes_per_step"] == 0
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(sp["params"]), leaves(plain["params"])))


# ---------------------------------------------------------------------------
# (d) the helpers
# ---------------------------------------------------------------------------
def _close(got, want, what):
    torch.testing.assert_close(got, want, atol=TM.GRAD_ATOL,
                               rtol=TM.GRAD_RTOL, msg=what)


def test_sp_helper_backwards_equal_autograd_of_the_one_rank_function(runs):
    t = _helper_inputs()
    h, wi, wo, w, table = (t[k].clone().requires_grad_()
                           for k in ("h", "wi", "wo", "w", "table"))
    y = torch.nn.functional.gelu(h @ wi) @ wo
    (y * t["c"]).sum().backward()
    x = t["h"].clone().requires_grad_()
    z = torch.sin(x) * w
    (z * t["c"]).sum().backward()
    e = table[t["ids"].long()]
    (e * t["c"]).sum().backward()
    half = T_F // 2
    for r, out in enumerate(runs["helpers"]):
        assert out["seq_split"] == [True, False, False]
        assert out["seq_split_plain"] is False
        gy, gh, gi, go = out["mlp"]
        _close(gy, _block(y.detach(), r), "reduce_scatter_seq value")
        _close(gh, _block(h.grad, r), "gather_seq (share) backward")
        _close(gi, wi.grad[:, r * half:(r + 1) * half], "column shard")
        _close(go, wo.grad[r * half:(r + 1) * half],
               "reduce_scatter_seq backward")
        gz, gx, gw = out["whole"]
        assert torch.equal(gz, _block(z.detach(), r))
        _close(gx, _block(x.grad, r), "gather_seq (whole) backward")
        _close(gw, w.grad, "keep_seq backward")
        ge, gt = out["embed"]
        assert torch.equal(ge, _block(e.detach(), r))
        _close(gt, table.grad[r * V // 2:(r + 1) * V // 2],
               "embed_lookup(seq=True) backward")


def test_sp_helpers_are_the_identity_off_a_model_axis():
    x = torch.randn(2, 4, 3)
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        with R.axis_rules(mesh, R.SP_ACT_RULES):
            assert not TP.seq_split(4)
            assert TP.gather_seq(x) is x
            assert TP.reduce_scatter_seq(x) is x
            assert TP.keep_seq(x) is x
            assert TP.enter(x, False, False) is x
            assert TP.leave(x, False, False) is x


# ---------------------------------------------------------------------------
# (e) the recompute on another thread
# ---------------------------------------------------------------------------
def test_sp_recompute_gathers_on_another_thread(runs):
    for (here, there), (g_here, g_there) in runs["threads"]:
        assert all(torch.equal(a, b) for a, b in zip(here, there))
        # the backward gathered the blocks again (the remat recompute and
        # the reduce-scatters' backward) on either thread
        assert g_here == g_there > 0
