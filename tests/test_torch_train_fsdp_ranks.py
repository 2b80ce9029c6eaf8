"""Params and AdamW state split over the data axis of ranks (the
reference's FSDP: ``PARAM_RULES["embed"] = [("data",), ()]``), in the
train step, the serve steps and the launcher's checkpoint, on gloo CPU
ranks; reduced llama3.2-1b in f32, one thread a rank.

(a) Each rank's param shapes, and the shapes of AdamW's master, ``m``
    and ``v``, are the reference's blocks: ``repro.sharding.rules``'
    ``resolve_spec`` with ``PARAM_RULES`` on a stand-in of the whole mesh
    (its ``axis_names`` and ``devices.shape``; no XLA devices), on (2, 2)
    data x model, (2, 2) pod x data and (2, 1, 2) pod x data x model; so
    are ``abstract_inputs``' stand-ins of a rank.
(b) The plain step on those meshes, each step from the reference's
    state before it cut to the rank's blocks, against the reference's
    one-device step, at ``tests/test_torch_train_model_ranks.py``'s
    tolerances: each loss within rtol 1e-5, each grad norm within rtol
    5e-5 of the reference's and 2e-5 of the port's one-device step, the
    ranks' blocks put side by side within 1e-5 of each leaf's largest
    |value| at all but 0.5% of the elements and nowhere further apart
    than twice the reference's largest move; the same loss and grad norm
    bits on every rank; gathers and reduce-scatters counted.
(c) The compressed step on (2, 2) pod x data from one seeded draw,
    three free-running steps, against the same step with ``{"embed":
    [()]}`` merged into the rules (every leaf whole over data, the layout
    ``tests/test_torch_compression.py`` held against the reference's
    before the data axis split), at that file's (g) tolerances: losses
    rtol 1e-5, the grad norms of steps 0 and 1 (equal params: lr is 0 at
    step 0) rtol 5e-5, the final params within 1e-4 at all but 0.5% and
    nowhere past twice the pods' largest move, step 0's error feedback
    within 2.5e-2 of its largest at all but 0.1%.
(d) ``gather_data``'s backward on (2, 2) pod x data, each rank with its
    own input and label weight and the pods' sum: the whole leaf the same
    bits as the one-rank one, and each block's gradient within atol 1e-6
    + rtol 1e-5 of its block of autograd through the one-rank weighted
    sum (f32 sums in another order), along either dim.
(e) A backward run on a thread that never entered the rule context (a
    card runs it on autograd's device thread) gathers again in the remat
    recompute and gives the same gradient bits.
(f) The serve steps on (2, 2) pod x data over data blocks: logits and
    caches bit-equal to the steps over whole-over-data params (a gather
    does no arithmetic), with gather bytes counted; with
    ``sharded_logits`` each rank's logits are its block of the whole
    logits bit for bit, on (2, 2) pod x data and on (1, 2) data x model.
(g) ``param_rules`` with ``{"embed": [()]}`` merged in gives each rank
    the model-axis shards alone (the layout before the data axis split)
    and losses and grad norms within (b)'s tolerances of the default's; a
    table that puts ``embed`` on ``model`` or ``heads`` on ``pod`` is
    refused by name by every step.
(i) An MoE layer in training over rows split across ranks (reduced
    qwen2-moe-a2.7b's layer 0 at capacity factor 0.5, so tokens drop) on
    (2, 2) pod x data: each rank's rows of the output within atol 1e-6 +
    rtol 1e-5 of one process routing the whole batch (capacity and slots
    over the whole batch), where routing its rows alone would drop others.
(j) Whisper (no ``StackedLM``: the step gathers its whole tree at entry)
    on (2, 1) data x model ranks: its blocks are the reference's, and the
    train step's loss and the prefill step's logits over them are the
    same bits as over whole-over-data params, the grad norm within rtol
    1e-6 (the norm adds the blocks' sums).
(h) A checkpoint written by ``TrainLoop`` over (2, 1) data x model ranks
    holding data blocks equals, leaf for leaf, the one the whole-over-data
    layout writes after the same two steps at lr 0, and a restore gives
    each rank its blocks back.
"""
import dataclasses
import os
import threading
from typing import Optional

import numpy as np
import pytest
import torch

import test_torch_train_model_ranks as TM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.launch import rank_jobs as J
from repro_torch.launch import ranks as RK
from repro_torch.launch.mesh import LogicalMesh, make_mesh, rank_axes
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.runtime import steps as S
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig
from repro_torch.sharding import fsdp as FS
from repro_torch.sharding import rules as R
from repro_torch.tree import leaves, map_tree, named_leaves

ARCH = "llama3.2-1b"
B, SEQ, STEPS = TM.B, TM.SEQ, TM.STEPS
DM = ((2, 2), ("data", "model"))
PD = ((2, 2), ("pod", "data"))
PDM = ((2, 1, 2), ("pod", "data", "model"))
PAIR = ((1, 2), ("data", "model"))
MESHES = {"data x model": DM, "pod x data": PD, "pod x data x model": PDM}
WHOLE = R.merge_rules(R.PARAM_RULES, {"embed": [()]})
SQ, SERVE_STEPS = 12, 3
GRAD_ATOL, GRAD_RTOL = TM.GRAD_ATOL, TM.GRAD_RTOL


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return reduced(get_arch(ARCH))


def _api(device="cpu"):
    return build_model(_cfg(), device=device, dtype=torch.float32,
                       max_seq=SEQ)


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FromState:
    """Train steps on ``mesh`` under ``rules``, each from a whole state on
    the CPU (params, ``AdamWState``) cut to the rank's blocks."""
    mesh: tuple
    params: list
    opt: list
    batches: list
    rules: Optional[dict] = None


def from_state(ctx, job: FromState) -> dict:
    mesh = make_mesh(*job.mesh, device="cpu")
    api = _api()
    step = S.make_train_step(api, AdamWConfig(**TM.OPT),
                             ShapeConfig("t", SEQ, B, "train"),
                             device="cpu", mesh=mesh, param_rules=job.rules)

    def cut(tree):
        return map_tree(lambda t: t.clone(),
                        S.shard_params(api, mesh, tree, job.rules))

    out = {"steps": [], "split": S.split_axes(api, mesh, job.rules)}
    for i, (p, o, b) in enumerate(zip(job.params, job.opt, job.batches)):
        loss, p, o, gnorm = step(cut(p), AdamWState(*map(cut, o)), b,
                                 np.int32(i))
        out["steps"].append({"loss": loss, "gnorm": gnorm, "params": p})
    out["shapes"] = [tuple(t.shape) for t in leaves(p)]
    out["opt_shapes"] = [[tuple(t.shape) for t in leaves(tree)]
                         for tree in o]
    out["gathered"] = step.gather_staging and step.gather_staging.collective
    out["scattered"] = step.scatter_staging \
        and step.scatter_staging.collective
    return out


def _gather_inputs():
    g = torch.Generator().manual_seed(5)
    return {"w": torch.randn(6, 8, generator=g),
            "x": torch.randn(4, 3, 6, generator=g),
            "c": torch.randn(4, 3, 8, generator=g),
            "weights": torch.tensor([0.1, 0.2, 0.3, 0.4])}


def _gather_loss(w, x, c):
    return (torch.sin(x @ w) * c).sum()


def gather_body(ctx, _):
    """``gather_data`` of this rank's block of ``w`` along each dim on
    (2, 2) pod x data, its loss on the rank's own input, weighted by the
    rank's label weight, summed over the pods: the whole leaf and the
    block's gradient."""
    mesh = make_mesh(*PD, device="cpu")
    dax, ax, t = FS.axis_of(mesh), rank_axes(mesh), _gather_inputs()
    out = {}
    for dim in (0, 1):
        n = t["w"].shape[dim] // dax.size
        block = t["w"].narrow(dim, dax.index * n, n).clone() \
            .requires_grad_()
        blocks = FS.DataBlocks(dax, None, t["weights"][ctx.rank],
                               (ax.group("pod"), RK.Staging()))
        whole = FS.gather_data(block, dim, blocks)
        _gather_loss(whole, t["x"][ctx.rank], t["c"][ctx.rank]).backward()
        out[dim] = (whole.detach(), block.grad)
    return out


def thread_body(ctx, _):
    """The gradient of the loss on this rank's blocks over (2, 2) data x
    model, taken on this thread and on one that never entered the rule
    context, and the bytes the data axis gathered in each backward."""
    mesh = make_mesh(*DM, device="cpu")
    api = _api()
    params = S.shard_params(api, mesh, api.init(
        torch.Generator().manual_seed(3)))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokenStream(
        _cfg().vocab_size, 4, SEQ).batch_at(0).items()}
    dax, dims = FS.axis_of(mesh), S.data_dims(api, mesh)
    data = FS.DataBlocks(dax, dims)
    grads, gathered = [], []
    for other in (False, True):
        tracked = map_tree(lambda t: t.detach().requires_grad_(), params)
        with R.axis_rules(mesh, None, data):
            loss = api.loss_fn(tracked, batch)
        before = dax.staging.collective
        run = lambda: grads.append(torch.autograd.grad(loss,
                                                       leaves(tracked)))
        if other:
            worker = threading.Thread(target=run)
            worker.start()
            worker.join()
        else:
            with R.axis_rules(mesh, None, data):
                run()
        gathered.append(dax.staging.collective - before)
    return {"grads": grads, "gathered": gathered}


def refusal_body(ctx, _):
    """Each step's refusal of a table that puts embed on model (on (2, 2)
    data x model) and heads on pod (on (2, 2) pod x data)."""
    api, out = _api(), {}
    for name, mesh, over in (("embed on model", DM,
                              {"embed": [("model",), ()]}),
                             ("heads on pod", PD, {"heads": [("pod",), ()]})):
        mesh = make_mesh(*mesh, device="cpu")
        rules = R.merge_rules(R.PARAM_RULES, over)
        for kind, make in (
                ("train", lambda: S.make_train_step(
                    api, AdamWConfig(), ShapeConfig("t", SEQ, B, "train"),
                    device="cpu", mesh=mesh, param_rules=rules)),
                ("prefill", lambda: S.make_prefill_step(
                    api, mesh, ShapeConfig("p", SQ, B, "prefill"),
                    param_rules=rules)),
                ("decode", lambda: S.make_decode_step(
                    api, mesh, ShapeConfig("d", SQ, B, "decode"),
                    param_rules=rules))):
            try:
                make()
                out[name, kind] = "built"
            except NotImplementedError as e:
                out[name, kind] = str(e)
    return out


MOE_ARCH, MOE_CAPACITY, MOE_S = "qwen2-moe-a2.7b", 0.5, 16


def _moe_inputs():
    from repro_torch.models.transformer import _at
    api = build_model(reduced(get_arch(MOE_ARCH)), device="cpu",
                      dtype=torch.float32)
    p = _at(api.init(torch.Generator().manual_seed(4))["blocks"], 0)["moe"]
    x = torch.randn(B, MOE_S, api.cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    return api.cfg, p, x


def moe_rows_body(ctx, _):
    """This rank's rows of an MoE layer's training output on (2, 2) pod x
    data, routed over the whole batch's rows (``RowBlocks``) and alone."""
    from repro_torch.models.moe import moe_mlp_apply
    mesh = make_mesh(*PD, device="cpu")
    cfg, p, x = _moe_inputs()
    n = B // 4
    mine = x[ctx.rank * n:(ctx.rank + 1) * n]
    run = lambda: moe_mlp_apply(cfg, p, mine, drop_tokens=True, aux=False,
                                capacity_factor=MOE_CAPACITY)[0]
    rows = FS.RowBlocks(ctx.rank, 4, None, RK.Staging())
    with R.axis_rules(mesh, None, None, rows):
        over = run()
    return {"over": over, "alone": run()}


WHISPER = ((2, 1), ("data", "model"))


def whisper_body(ctx, rules):
    """reduced whisper-small in f32 on (2, 1) data x model under
    ``rules``: one train step and one prefill step from a seeded draw."""
    mesh = make_mesh(*WHISPER, device="cpu")
    api = build_model(reduced(get_arch("whisper-small")), device="cpu",
                      dtype=torch.float32, max_seq=SEQ)
    params = S.draw_params(api, mesh, torch.Generator().manual_seed(2),
                           rules)
    tshape = ShapeConfig("t", SEQ // 2, 4, "train")
    pshape = ShapeConfig("p", SEQ // 2, 4, "prefill")
    step = S.make_train_step(api, AdamWConfig(**TM.OPT), tshape,
                             device="cpu", mesh=mesh, param_rules=rules)
    pre = S.make_prefill_step(api, mesh, pshape, param_rules=rules)
    g = torch.Generator().manual_seed(8)
    logits, _ = pre(params, api.make_inputs(pshape, g))
    loss, _, _, gnorm = step(params, adamw.init(params),
                             api.make_inputs(tshape, g), np.int32(1))
    return {"loss": loss, "gnorm": gnorm, "logits": logits,
            "shapes": [tuple(t.shape) for t in leaves(params)]}


@dataclasses.dataclass
class CkptJob:
    directory: str
    rules: Optional[dict] = None


def ckpt_body(ctx, job: CkptJob) -> dict:
    """Two ``TrainLoop`` steps at lr 0 over (2, 1) data x model ranks
    under ``rules``, checkpointed (rank 0 writes), then a restore into a
    fresh loop: whether it holds the loop's blocks bit for bit."""
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    api = _api()
    opt = AdamWConfig(lr=0.0, warmup_steps=1, total_steps=10)

    def loop(params):
        step = S.make_train_step(api, opt, ShapeConfig("t", SEQ, B, "train"),
                                 device="cpu", mesh=mesh,
                                 param_rules=job.rules)
        return TrainLoop(
            train_step=step, params=params, opt_state=adamw.init(params),
            data=SyntheticTokenStream(_cfg().vocab_size, B, SEQ),
            ckpt=CheckpointManager(job.directory, async_save=False),
            cfg=TrainLoopConfig(total_steps=2, ckpt_every=2),
            layout=S.DataLayout(api, mesh, job.rules))

    params = S.draw_params(api, mesh, torch.Generator().manual_seed(0),
                           job.rules)
    first = loop(params)
    first.run(2)
    # rank 0 writes; the others read only once it has committed
    torch.distributed.barrier()
    again = loop(map_tree(torch.zeros_like, first.params))
    assert again.try_restore() and again.step == 2
    same = all(torch.equal(a, b) for a, b in zip(
        leaves([first.params, first.opt_state]),
        leaves([again.params, again.opt_state])))
    return {"restored": same,
            "shapes": [tuple(t.shape) for t in leaves(first.params)]}


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------
def _steps_job(mesh, params, tokens, feed, **kw):
    return J.StepsJob(_cfg(), mesh, tokens, steps=SERVE_STEPS,
                      params=params, max_seq=SQ + SERVE_STEPS, feed=feed,
                      **kw)


@pytest.fixture(scope="module")
def runs():
    pytest.importorskip("jax")
    ref = TM._reference_steps(ARCH)
    api = _api()
    whole = api.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(31)
    cfg = _cfg()
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, SQ),
                                          dtype=np.int32))
    feed = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                        (SERVE_STEPS, B, 1), dtype=np.int32))
    state = lambda mesh, rules=None: FromState(
        mesh, ref["params"], ref["opt"], ref["batches"], rules)
    compressed = lambda rules: J.TrainJob(
        cfg, PD, STEPS, B, SEQ, opt=AdamWConfig(**TM.OPT), compressed=True,
        seed=3, keep=("params", "ef"), param_rules=rules)
    serve = lambda **kw: _steps_job(PD, whole, tokens, feed, **kw)
    calls = [(from_state, state(m)) for m in MESHES.values()] + [
        (from_state, state(DM, WHOLE)),
        (J.train, compressed(None)), (J.train, compressed(WHOLE)),
        (gather_body, None), (thread_body, None), (refusal_body, None),
        (moe_rows_body, None),
        (J.serve_steps, serve()), (J.serve_steps, serve(param_rules=WHOLE)),
        (J.serve_steps, serve(sharded_logits=True))]
    four = spawn(J.chain, 4, backend="gloo", device="cpu", args=(calls,))
    col = lambda i: [r[i] for r in four]
    out = {"ref": ref, "whole": whole, "tokens": tokens, "feed": feed,
           "fsdp": {name: col(i) for i, name in enumerate(MESHES)},
           "whole_dm": col(3), "compressed": (col(4), col(5)),
           "gather": col(6), "thread": col(7), "refusals": col(8),
           "moe": col(9), "serve": (col(10), col(11), col(12))}
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """On two ranks: the sharded logits on (1, 2) data x model beside the
    whole ones, and the checkpoints of the data blocks and of the
    whole-over-data layout."""
    api = _api()
    whole = api.init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(32)
    tokens = torch.from_numpy(rng.randint(0, _cfg().vocab_size, (B, SQ),
                                          dtype=np.int32))
    feed = torch.from_numpy(rng.randint(0, _cfg().vocab_size,
                                        (SERVE_STEPS, B, 1), dtype=np.int32))
    dirs = [str(tmp_path_factory.mktemp(k)) for k in ("fsdp", "whole")]
    two = spawn(J.chain, 2, backend="gloo", device="cpu", args=([
        (J.serve_steps, _steps_job(PAIR, whole, tokens, feed)),
        (J.serve_steps, _steps_job(PAIR, whole, tokens, feed,
                                   sharded_logits=True)),
        (ckpt_body, CkptJob(dirs[0])), (ckpt_body, CkptJob(dirs[1], WHOLE)),
        (whisper_body, None), (whisper_body, WHOLE)],))
    return {"serve": ([r[0] for r in two], [r[1] for r in two]),
            "ckpt": ([r[2] for r in two], [r[3] for r in two]),
            "dirs": dirs, "whisper": ([r[4] for r in two],
                                      [r[5] for r in two])}


# ---------------------------------------------------------------------------
# (a) the reference's blocks
# ---------------------------------------------------------------------------
class _StandIn:
    """What ``repro.sharding.rules.resolve_spec`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _reference_blocks(api, mesh):
    from repro.sharding import rules as JR
    sizes = dict(zip(mesh[1], mesh[0]))
    out = []
    for sp in leaves(api.param_specs()):
        spec = JR.resolve_spec(sp.shape, sp.axes, _StandIn(*mesh),
                               JR.PARAM_RULES)
        shape = list(sp.shape)
        for d, entry in enumerate(spec):
            for a in (entry,) if isinstance(entry, str) else entry or ():
                shape[d] //= sizes[a]
        out.append(tuple(shape))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_blocks_are_the_reference_resolve_spec(runs, mesh):
    want = _reference_blocks(_api("meta"), MESHES[mesh])
    whole = [tuple(sp.shape) for sp in leaves(_api("meta").param_specs())]
    assert want != whole
    for r in runs["fsdp"][mesh]:
        assert r["shapes"] == want
        # AdamW's master, m and v: the same blocks
        assert r["opt_shapes"] == [want] * 3
    # the dry-run's stand-ins of a rank, from the same decision
    shape, names = MESHES[mesh]
    ab = S.abstract_inputs(_api("meta"), ShapeConfig("t", SEQ, B, "train"),
                           LogicalMesh(shape, names),
                           coords={a: 0 for a in names})
    assert [tuple(t.shape) for t in leaves(ab["params"])] == want
    assert [[tuple(t.shape) for t in leaves(o)] for o in ab["opt"]] == \
        [want] * 3


# ---------------------------------------------------------------------------
# (b) the plain step against the reference
# ---------------------------------------------------------------------------
def _hold_params(got, w, w0, what):
    """``tests/test_torch_train_model_ranks.py``'s params check."""
    d = (got - w).abs()
    off = int((d > TM.PARAM_TOL * w.abs().max()).sum())
    allowed = TM.PARAM_SHARE * d.numel()
    allowed = TM.PARAM_FEW if allowed < 1 else allowed
    assert off <= allowed, (what, off)
    assert d.max() <= 2 * (w - w0).abs().max(), what


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fsdp_steps_hold_the_reference(runs, mesh):
    ref, ranks = runs["ref"], runs["fsdp"][mesh]
    api = _api("meta")
    for i in range(STEPS):
        for r in ranks:
            got = r["steps"][i]
            np.testing.assert_allclose(float(got["loss"]), ref["loss"][i],
                                       rtol=TM.RTOL)
            np.testing.assert_allclose(float(got["gnorm"]),
                                       ref["one_gnorm"][i],
                                       rtol=TM.ONE_GNORM_RTOL)
            np.testing.assert_allclose(float(got["gnorm"]), ref["gnorm"][i],
                                       rtol=TM.GNORM_RTOL)
            assert torch.equal(got["loss"], ranks[0]["steps"][i]["loss"])
            assert torch.equal(got["gnorm"], ranks[0]["steps"][i]["gnorm"])
        joined = S.join_blocks(api, LogicalMesh(*MESHES[mesh]),
                               [r["steps"][i]["params"] for r in ranks])
        for (name, g), w0, w in zip(named_leaves(joined).items(),
                                    leaves(ref["params"][i]),
                                    leaves(ref["new"][i])):
            _hold_params(g, w, w0, (mesh, i, name))
    data = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["data"]
    for r in ranks:
        if data > 1:
            assert r["gathered"] > 0 and r["scattered"] > 0
        else:               # (2, 1, 2): nothing splits over a data axis of 1
            assert r["gathered"] is None and r["scattered"] is None


# ---------------------------------------------------------------------------
# (c) the compressed step over data blocks
# ---------------------------------------------------------------------------
def test_compressed_step_over_data_blocks_holds_the_whole_layout(runs):
    fsdp, whole = runs["compressed"]
    api = _api()
    first = leaves(api.init(torch.Generator().manual_seed(3)))
    mesh = LogicalMesh(*PD)
    assert all("data" in a for a in fsdp[0]["split"])
    assert not any(whole[0]["split"])
    np.testing.assert_allclose(fsdp[0]["losses"], whole[0]["losses"],
                               rtol=TM.RTOL)
    np.testing.assert_allclose(fsdp[0]["gnorms"][:2], whole[0]["gnorms"][:2],
                               rtol=TM.GNORM_RTOL)
    for r in fsdp:
        assert r["losses"] == fsdp[0]["losses"]
        assert r["gnorms"] == fsdp[0]["gnorms"]
    params = leaves(S.join_blocks(api, mesh, [r["params"] for r in fsdp]))
    # pod 0's error feedback: its data ranks' blocks side by side
    ef = leaves(S.join_blocks(api, mesh, [r["ef_steps"][0]
                                          for r in fsdp[:2] * 2]))
    names = list(named_leaves(api.param_specs()))
    for name, p0, w, g, e_w, e_g in zip(
            names, first, leaves(whole[0]["params"]), params,
            leaves(whole[0]["ef_steps"][0]), ef):
        TM._held(g, w, TM.COMP_PARAM_TOL, TM.PARAM_SHARE, name)
        assert float((g - w).abs().max()) <= \
            2 * float((w - p0).abs().max()), name
        TM._held(e_g, e_w, TM.EF_TOL, TM.TIE_SHARE, name)


# ---------------------------------------------------------------------------
# (d), (e) the gather's backward
# ---------------------------------------------------------------------------
def test_gather_data_backward_equals_autograd_of_the_one_rank_function(runs):
    t = _gather_inputs()
    w = t["w"].clone().requires_grad_()
    total = sum(t["weights"][r] * _gather_loss(w, t["x"][r], t["c"][r])
                for r in range(4))
    total.backward()
    for rank, out in enumerate(runs["gather"]):
        d = rank % 2                      # the mesh is (pod, data)
        for dim in (0, 1):
            whole, grad = out[dim]
            assert torch.equal(whole, t["w"])
            n = t["w"].shape[dim] // 2
            torch.testing.assert_close(
                grad, w.grad.narrow(dim, d * n, n), atol=GRAD_ATOL,
                rtol=GRAD_RTOL, msg=f"rank {rank} dim {dim}")


def test_backward_on_another_thread_still_gathers(runs):
    for r in runs["thread"]:
        here, there = r["grads"]
        assert all(torch.equal(a, b) for a, b in zip(here, there))
        # the remat recompute gathered its layers again, on either thread
        assert r["gathered"][0] == r["gathered"][1] > 0


# ---------------------------------------------------------------------------
# (f) the serve steps
# ---------------------------------------------------------------------------
def test_serve_steps_over_data_blocks_equal_the_whole_param_steps(runs):
    fsdp, whole, _ = runs["serve"]
    want = _reference_blocks(_api("meta"), PD)
    for a, b in zip(fsdp, whole):
        assert a["param_shapes"] == want
        assert len(a["logits"]) == SERVE_STEPS + 1
        for x, y in zip(a["logits"], b["logits"]):
            assert torch.equal(x, y)
        for key in ("prefill_cache", "cache"):
            for x, y in zip(leaves(a[key]), leaves(b[key])):
                assert torch.equal(x, y), key
        assert a["prefill_gather_bytes"] > 0 and all(
            n == a["decode_gather_bytes"][0] > 0
            for n in a["decode_gather_bytes"])
        assert b["prefill_gather_bytes"] == 0
        assert a["param_bytes"] * 2 == b["param_bytes"]


def _hold_sharded(whole, sharded, mesh):
    shape, names = mesh
    V = _cfg().vocab_size
    for rank, (a, b) in enumerate(zip(whole, sharded)):
        coords = {n: int(c) for n, c in zip(names,
                                            np.unravel_index(rank, shape))}
        blk = R.logical_sharding((B, V), ("act_batch", "act_vocab"),
                                 LogicalMesh(*mesh), R.ACT_RULES).block(
            (B, V), coords)
        assert len(b["logits"]) == SERVE_STEPS + 1
        for x, y in zip(a["logits"], b["logits"]):
            assert tuple(y.shape) != (B, V)
            assert torch.equal(y, x[blk]), (rank, blk)


def test_sharded_logits_are_the_rank_blocks_of_the_whole_logits(runs, pair):
    fsdp, _, sharded = runs["serve"]
    _hold_sharded(fsdp, sharded, PD)
    whole, sharded = pair["serve"]
    _hold_sharded(whole, sharded, PAIR)
    # data x model: the rank's rows and its vocab block
    assert tuple(sharded[0]["logits"][0].shape) == (B,
                                                    _cfg().vocab_size // 2)


# ---------------------------------------------------------------------------
# (g) param_rules
# ---------------------------------------------------------------------------
def test_whole_over_data_rules_give_the_model_axis_shards(runs):
    api = _api("meta")
    want = [sh.shard_shape(sp.shape) for sh, sp in zip(
        leaves(S.param_shardings(api, LogicalMesh((2,), ("model",)))),
        leaves(api.param_specs()))]
    default = runs["fsdp"]["data x model"]
    for r, d in zip(runs["whole_dm"], default):
        assert r["shapes"] == want and r["shapes"] != d["shapes"]
        assert r["gathered"] is None
        for i in range(STEPS):
            np.testing.assert_allclose(float(r["steps"][i]["loss"]),
                                       float(d["steps"][i]["loss"]),
                                       rtol=TM.RTOL)
            np.testing.assert_allclose(float(r["steps"][i]["gnorm"]),
                                       float(d["steps"][i]["gnorm"]),
                                       rtol=TM.ONE_GNORM_RTOL)


def test_rules_the_port_cannot_run_are_refused_by_name(runs):
    for errs in runs["refusals"]:
        for kind in ("train", "prefill", "decode"):
            e = errs["embed on model", kind]
            assert "model on 'embed'" in e and "step 5c" in e, e
            e = errs["heads on pod", kind]
            assert "pod on 'heads'" in e and "step 5c" in e, e


# ---------------------------------------------------------------------------
# (i) MoE routing over rows split across ranks
# ---------------------------------------------------------------------------
def test_moe_routes_over_the_whole_batch_across_row_ranks(runs):
    from repro_torch.models.moe import moe_mlp_apply
    cfg, p, x = _moe_inputs()
    whole = moe_mlp_apply(cfg, p, x, drop_tokens=True, aux=False,
                          capacity_factor=MOE_CAPACITY)[0]
    n = B // 4
    alone_differs = False
    for rank, r in enumerate(runs["moe"]):
        want = whole[rank * n:(rank + 1) * n]
        torch.testing.assert_close(r["over"], want, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, msg=f"rank {rank}")
        alone_differs |= not torch.allclose(r["alone"], want,
                                            atol=GRAD_ATOL, rtol=GRAD_RTOL)
    # the rows alone drop other tokens: the case needs the whole batch's
    assert alone_differs


# ---------------------------------------------------------------------------
# (j) Whisper
# ---------------------------------------------------------------------------
def test_whisper_is_gathered_whole_at_the_step_entry(pair):
    api = build_model(reduced(get_arch("whisper-small")), device="meta",
                      dtype=torch.float32, max_seq=SEQ)
    want = _reference_blocks(api, WHISPER)
    fsdp, whole = pair["whisper"]
    for a, b in zip(fsdp, whole):
        assert a["shapes"] == want and a["shapes"] != b["shapes"]
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["logits"], b["logits"])
        np.testing.assert_allclose(float(a["gnorm"]), float(b["gnorm"]),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# (h) the checkpoint
# ---------------------------------------------------------------------------
def test_checkpoint_of_data_blocks_equals_the_whole_layouts(pair):
    fsdp, whole = pair["ckpt"]
    assert fsdp[0]["shapes"] != whole[0]["shapes"]
    assert all(r["restored"] for r in fsdp + whole)
    files = [np.load(os.path.join(d, "step_2", "arrays.npz"))
             for d in pair["dirs"]]
    assert sorted(files[0].files) == sorted(files[1].files)
    api = _api("meta")
    shapes = {f"params/{k}": tuple(sp.shape)
              for k, sp in named_leaves(api.param_specs()).items()}
    for name in files[0].files:
        a, b = files[0][name], files[1][name]
        if name in shapes:
            assert a.shape == shapes[name], name
        np.testing.assert_array_equal(a, b, err_msg=name)
