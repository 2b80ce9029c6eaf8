"""The train step over a ``model`` axis of ranks (tensor parallelism:
``runtime.steps.make_train_step`` on a ``DeviceMesh`` of gloo CPU ranks,
each holding its shards of the params, the gradients and the AdamW
state), against the reference's step on one device: ``jax.value_and_grad``
of its ``loss_fn`` and its ``adamw.update``, as tests/test_train_loop.py
sets the step up. Reduced configs in f32 from the reference's weights
(``params_from_jax``; the attention biases drawn nonzero), batch 8 x 32,
one thread a rank.

(a) glm4-9b on (2, 4) data x model (its two KV heads stay whole over 4:
    ``copy_to_model`` on k and v) and llama3.2-1b on (2, 2, 2) pod x data
    x model (tied, vocab-split head), three steps; (b) qwen2-moe-a2.7b on
    (1, 2) data x model in train mode, which drops at capacity (4 of 8
    experts a rank). Each step starts from the reference's state before
    it (its params and AdamW state, cut to the rank's blocks): AdamW moves
    an element whose gradient sits at rounding level by up to lr in
    either direction, so free-running copies part after the first moving
    step (measured: the port's one-device run and its ranks 3e-5 to
    6.5e-5 apart in the grad norm at step 2; capacity drops part MoE runs
    further). Each loss within rtol 1e-5 of the reference's; each grad
    norm within rtol 5e-5 of the reference's and 2e-5 of the port's
    one-device step from the same state: every gradient is an f32 sum in
    another order (``test_torch_train.py`` holds each within 5e-4 of its
    leaf's largest), and the norm follows its largest elements (measured
    on these states: the one-device port up to 1.4e-5 from the
    reference, the ranks up to 1.0e-5 from the one-device port, on
    qwen2-moe's router-led norm of 123); each rank's updated params
    within the reference's leaves cut to its block at the tolerance of
    ``test_torch_train_ranks.py`` (a): 1e-5 of each leaf's largest |value|
    at all but 0.5% of the elements (2 elements on a leaf under 200, where
    0.5% allows none: measured, 2 of the 96 in a rank's shard of
    qwen2-moe's ``bk``, where the one-device port has 1 of 192 past it),
    and nowhere further apart than twice the reference's largest move in
    that step. Every rank's loss and grad
    norm are the same bits, the whole leaves (the norms, the router) the
    same bits on every rank, a split leaf's shard the same bits on the
    ranks of one model index; the model axis's collectives were counted.
(c) ``compressed_psum_pod`` on (2, 1, 2) pod x data x model ranks: each
    rank's int8 payload and scales (what it sends its peer pod) are the
    reference's ``_quantize`` of the whole leaf, cut to the shard, bit for
    bit, and so are the reduced gradient and the new error feedback.
(d) Each helper's backward (``reduce_model``, ``copy_to_model``,
    ``gather_model``, ``embed_lookup``) on two ranks against autograd
    through the one-rank function: atol 1e-6 + rtol 1e-5 (f32 sums over
    a split dim in another order).
(e) The vocab-parallel cross entropy (``chunked_softmax_xent`` over a
    vocab-split head, four chunks, a label mask) on two ranks against
    ``chunked_softmax_xent`` on the whole head: value rtol 1e-6, gradients
    atol 1e-6 + rtol 1e-5.
(f) The gradient of the loss on a model axis is the same bits when the
    backward (with its remat and loss recomputes) runs on a thread that
    never entered the rule context, as a card's autograd device thread.
(g) The compressed step (``compress_pod_grads``) of reduced llama3.2-1b
    on (2, 1, 2) pod x data x model ranks, three free-running steps from
    one seeded draw, against the same step on (2, 1) pod x data ranks
    (no model axis; tests/test_torch_compression.py holds that one
    against the reference's): each loss within rtol 1e-5 (measured
    1.5e-7); the grad norms of steps 0 and 1, which run on equal params
    (lr is 0 at step 0), within rtol 5e-5 (measured 1.1e-5; step 2's,
    after a moving step, 1.4e-4, not held); the final params cut to the
    rank's block within 1e-4 of each leaf's largest |value| at all but
    0.5% of the elements (measured at most 0.05%) and nowhere further
    apart than twice the pods' largest move; step 0's error feedback
    within 2.5e-2 of its largest |value| at all but 0.1% of the elements
    (a value on a rounding tie moves by a scale; measured at most 0.04%),
    as tests/test_torch_compression.py (d) holds the port's against the
    reference's; the whole leaves the same bits on every rank and each
    shard the same bits on both pods.
"""
import concurrent.futures
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.launch import rank_jobs
from repro_torch.launch.mesh import LogicalMesh, make_mesh, rank_axes
from repro_torch.launch.ranks import spawn
from repro_torch.models import layers as L
from repro_torch.models.api import build_model
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.runtime import steps as S
from repro_torch.sharding import rules as R
from repro_torch.sharding import tensor_parallel as TP
from repro_torch.tree import leaves, map_tree, named_leaves
from repro_torch.weights import opt_state_from_jax, params_from_jax

B, SEQ, STEPS = 8, 32, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
RTOL = 1e-5
GNORM_RTOL, ONE_GNORM_RTOL = 5e-5, 2e-5
PARAM_TOL, PARAM_SHARE, PARAM_FEW = 1e-5, 5e-3, 2
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
WIDE = ((2, 4), ("data", "model"))
PODS = ((2, 2, 2), ("pod", "data", "model"))
PAIR = ((1, 2), ("data", "model"))
CASES = {"glm4-9b": WIDE, "llama3.2-1b": PODS, "qwen2-moe-a2.7b": PAIR}
COMPRESSED = ((2, 1, 2), ("pod", "data", "model"))
POD_PAIR = ((2, 1), ("pod", "data"))
# (g): the compressed steps' params and error feedback, as
# tests/test_torch_compression.py (d) holds the port's against the
# reference's: every gradient an f32 sum in another order, turned into a
# whole quantization step where a value sits on a rounding tie
COMP_PARAM_TOL = 1e-4
EF_TOL, TIE_SHARE = 2.5e-2, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _reference_steps(arch):
    """The reference's f32 init of the reduced config (attention biases
    drawn nonzero: the initializer's zeros would hide a bias's gradient
    cut on the wrong heads) and three steps of its one-device train step
    on ``SyntheticTokenStream(seed=1)``: the state before each step (port
    trees), each batch, and each step's loss, grad norm and new params."""
    import jax
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    from repro.optim import adamw as jadamw
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    try:
        japi = jbuild(jreduced(jget(arch)), max_seq=SEQ)
        jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                          japi.init(jax.random.PRNGKey(0)))
        rng = np.random.RandomState(7)

        def biases(t):
            if isinstance(t, dict):
                return {k: jnp.asarray(rng.normal(0, 0.5, v.shape),
                                       jnp.float32)
                        if k in ("bq", "bk", "bv") else biases(v)
                        for k, v in t.items()}
            return t

        jp = biases(jp)
        cfg = jadamw.AdamWConfig(**OPT)

        @jax.jit
        def step(params, opt_state, batch, i):
            loss, grads = jax.value_and_grad(japi.loss_fn)(params, batch)
            new, new_opt, gnorm = jadamw.update(cfg, grads, opt_state, i)
            return loss, new, new_opt, gnorm

        js = jadamw.init(jp)
        data = SyntheticTokenStream(reduced(get_arch(arch)).vocab_size, B,
                                    SEQ, seed=1)
        out = {"params": [], "opt": [], "batches": [], "loss": [],
               "gnorm": [], "new": []}
        for i in range(STEPS):
            b = data.batch_at(i)
            out["params"].append(params_from_jax(_np(jp), "cpu"))
            out["opt"].append(opt_state_from_jax(_np(js), "cpu"))
            out["batches"].append(b)
            jl, jp, js, jn = step(jp, js, {k: jnp.asarray(v)
                                           for k, v in b.items()}, i)
            out["loss"].append(float(jl))
            out["gnorm"].append(float(jn))
            out["new"].append(params_from_jax(_np(jp), "cpu"))
    finally:
        JL.DEFAULT_DTYPE = old
    # the port's one-device step from the same states
    api = build_model(reduced(get_arch(arch)), device="cpu",
                      dtype=torch.float32, max_seq=SEQ)
    step = S.make_train_step(api, AdamWConfig(**OPT),
                             ShapeConfig("t", SEQ, B, "train"), device="cpu")
    clone = lambda tree: map_tree(lambda t: t.clone(), tree)
    out["one_gnorm"], out["one"] = [], []
    for i, (p, o, b) in enumerate(zip(out["params"], out["opt"],
                                      out["batches"])):
        _, p, _, gnorm = step(clone(p), AdamWState(*map(clone, o)), b,
                              np.int32(i))
        out["one_gnorm"].append(float(gnorm))
        out["one"].append(p)
    return out


@dataclasses.dataclass
class FromState:
    """Train steps of ``make_train_step`` on ``mesh``, each from a whole
    state on the CPU (params, ``AdamWState``) cut to the rank's shards."""
    cfg: object
    mesh: tuple
    params: list
    opt: list
    batches: list


def from_state(ctx, job: FromState) -> dict:
    mesh = make_mesh(*job.mesh, device="cpu")
    api = build_model(job.cfg, device="cpu", dtype=torch.float32,
                      max_seq=SEQ)
    step = S.make_train_step(api, AdamWConfig(**OPT),
                             ShapeConfig("t", SEQ, B, "train"),
                             device="cpu", mesh=mesh)

    def cut(tree):
        return map_tree(lambda t: t.clone(), S.shard_params(api, mesh, tree))

    out = {"steps": [], "split": S.split_axes(api, mesh)}
    for i, (p, o, b) in enumerate(zip(job.params, job.opt, job.batches)):
        loss, p, o, gnorm = step(cut(p), AdamWState(*map(cut, o)), b,
                                 np.int32(i))
        out["steps"].append({"loss": loss, "gnorm": gnorm, "params": p,
                             "digest": rank_jobs.param_digest(p)})
    out["model_bytes"] = step.model_staging.collective
    return out


# ---------------------------------------------------------------------------
# (d), (e): the helpers on two ranks
# ---------------------------------------------------------------------------
V, D, DF = 24, 8, 6


def _helper_inputs():
    g = torch.Generator().manual_seed(5)
    return {"h": torch.randn(3, 5, D, generator=g),
            "wi": torch.randn(D, DF, generator=g),
            "wo": torch.randn(DF, D, generator=g),
            "c": torch.randn(3, 5, D, generator=g),
            "x": torch.randn(4, 6, generator=g),
            "cg": torch.randn(4, 6, generator=g),
            "table": torch.randn(V, D, generator=g),
            "ids": torch.randint(0, V, (4, 7), generator=g),
            "rows_c": torch.randn(4, 7, D, generator=g)}


def _mlp_loss(t, h, wi, wo):
    hh = TP.copy_to_model(h)
    y = TP.reduce_model(torch.nn.functional.gelu(hh @ wi) @ wo)
    return (y * t["c"]).sum()


def _gather_loss(t, x):
    return (torch.sin(TP.gather_model(x, 1)) * t["cg"]).sum()


def _embed_loss(t, table):
    return (TP.embed_lookup(table, t["ids"], V) * t["rows_c"]).sum()


XENT_B, XENT_S, XENT_D, XENT_V = 2, 32, 16, 40


def _xent_inputs():
    g = torch.Generator().manual_seed(11)
    mask = torch.ones(XENT_B, XENT_S)
    mask[0, :5] = 0
    return {"h": torch.randn(XENT_B, XENT_S, XENT_D, generator=g),
            "w": torch.randn(XENT_D, XENT_V, generator=g) * 0.5,
            "labels": torch.randint(0, XENT_V, (XENT_B, XENT_S),
                                    generator=g),
            "mask": mask}


def helpers(ctx, _):
    """Each helper's value and gradients on this rank of a model axis of
    2, and the vocab-parallel loss over this rank's head columns."""
    mesh = make_mesh((2,), ("model",), device="cpu")
    r, t, out = ctx.rank, _helper_inputs(), {}
    with R.axis_rules(mesh):
        h = t["h"].clone().requires_grad_()
        wi = t["wi"][:, r * 3:(r + 1) * 3].clone().requires_grad_()
        wo = t["wo"][r * 3:(r + 1) * 3].clone().requires_grad_()
        loss = _mlp_loss(t, h, wi, wo)
        out["mlp"] = loss.detach()
        loss.backward()
        out["mlp_grads"] = (h.grad, wi.grad, wo.grad)
        x = t["x"][:, r * 3:(r + 1) * 3].clone().requires_grad_()
        _gather_loss(t, x).backward()
        out["gather_grad"] = x.grad
        table = t["table"][r * 12:(r + 1) * 12].clone().requires_grad_()
        _embed_loss(t, table).backward()
        out["embed_grad"] = table.grad
        out["max"] = TP.max_model(t["x"] * (r + 1) - 2 * r)
        xs = _xent_inputs()
        hx = xs["h"].clone().requires_grad_()
        half = XENT_V // 2
        w = xs["w"][:, r * half:(r + 1) * half].clone().requires_grad_()
        loss = L.chunked_softmax_xent(hx, w, xs["labels"], chunk=8,
                                      label_mask=xs["mask"], vocab=XENT_V)
        loss.backward()
        out["xent"] = (loss.detach(), hx.grad, w.grad)
    return out


def backward_thread(ctx, _):
    """The gradient of reduced glm4-9b's loss (remat and the chunked loss
    recomputed in the backward) on this rank's shards of a model axis of
    2, taken on this thread and on another one that never entered the
    rule context, as a card's autograd runs the backward on its device
    thread."""
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    cfg = reduced(get_arch("glm4-9b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=SEQ)
    params = S.shard_params(api, mesh, api.init(
        torch.Generator().manual_seed(3)))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticTokenStream(
        cfg.vocab_size, 2, SEQ).batch_at(0).items()}
    grads = []
    for other in (False, True):
        tracked = map_tree(lambda t: t.detach().requires_grad_(), params)
        with R.axis_rules(mesh):
            loss = api.loss_fn(tracked, batch)
        run = lambda: grads.append(torch.autograd.grad(loss,
                                                       leaves(tracked)))
        if other:
            worker = threading.Thread(target=run)
            worker.start()
            worker.join()
        else:
            with R.axis_rules(mesh):
                run()
    return grads


@dataclasses.dataclass
class PodCase:
    """Per-pod whole gradient and error-feedback trees of a reduced
    model's param shapes (numpy)."""
    cfg: object
    trees: list


def pod_payload(ctx, case: PodCase) -> dict:
    """``compressed_psum_pod`` over this rank's pod group on its shards,
    the whole leaves' absmax taken over its model group; records what it
    sent its peer pod."""
    mesh = make_mesh(*COMPRESSED, device="cpu")
    api = build_model(case.cfg, device="meta", dtype=torch.float32)
    ax = rank_axes(mesh)
    g, e = case.trees[ax.index("pod")]
    whole = lambda tree: params_from_jax(tree, "cpu")
    g, e = (map_tree(lambda t: t.clone(), S.shard_params(api, mesh,
                                                         whole(x)))
            for x in (g, e))
    sent = []
    exchange = C.RK.exchange

    def spy(staging, tensors, peer, group=None, tag="exchange"):
        sent.append([t.clone() for t in tensors])
        return exchange(staging, tensors, peer, group, tag)

    C.RK.exchange = spy
    try:
        reduced_g, ef = C.compressed_psum_pod(
            g, e, ax.group("pod"), 2,
            leaf_absmax=S.ModelShards(api, mesh).leaf_absmax)
    finally:
        C.RK.exchange = exchange
    return {"q": sent[0][0], "scales": sent[0][1], "reduced": reduced_g,
            "ef": ef}


def _compressed_job(mesh) -> rank_jobs.TrainJob:
    """The compressed step of reduced llama3.2-1b in f32 on ``mesh``,
    STEPS steps from the seeded draw (each rank its shards of it)."""
    return rank_jobs.TrainJob(reduced(get_arch("llama3.2-1b")), mesh, STEPS,
                              B, SEQ, opt=AdamWConfig(**OPT),
                              compressed=True, seed=3,
                              keep=("params", "ef"))


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------
def _pod_trees(cfg):
    """Two pods' (g, e) trees of ``cfg``'s param shapes, as nested dicts
    of numpy arrays (``params_from_jax``'s input)."""
    api = build_model(cfg, device="meta", dtype=torch.float32)
    rng = np.random.RandomState(13)

    def draw(spec, scale):
        return (rng.randn(*spec.shape) * scale).astype(np.float32)

    def tree(specs, scale):
        if isinstance(specs, dict):
            return {k: tree(v, scale) for k, v in specs.items()}
        return draw(specs, scale)

    return [(tree(api.param_specs(), 1.0), tree(api.param_specs(), 1e-2))
            for _ in range(2)]


@pytest.fixture(scope="module")
def runs():
    pytest.importorskip("jax")
    cfg = reduced(get_arch("llama3.2-1b"))
    trees = _pod_trees(cfg)
    # the compressed exchange needs no reference run: its ranks run while
    # the reference's steps compile and run here
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pending = pool.submit(spawn, rank_jobs.chain, 4, backend="gloo",
                              device="cpu", args=(
                                  [(pod_payload, PodCase(cfg, trees)),
                                   (rank_jobs.train,
                                    _compressed_job(COMPRESSED))],))
        ref = {arch: _reference_steps(arch) for arch in CASES}
        pods, compressed = zip(*pending.result())
    jobs = {arch: FromState(reduced(get_arch(arch)), mesh,
                            ref[arch]["params"], ref[arch]["opt"],
                            ref[arch]["batches"])
            for arch, mesh in CASES.items()}
    eight = spawn(rank_jobs.chain, 8, backend="gloo", device="cpu", args=(
        [(from_state, jobs["glm4-9b"]), (from_state, jobs["llama3.2-1b"])],))
    two = spawn(rank_jobs.chain, 2, backend="gloo", device="cpu", args=(
        [(from_state, jobs["qwen2-moe-a2.7b"]), (helpers, None),
         (backward_thread, None),
         (rank_jobs.train, _compressed_job(POD_PAIR))],))
    ranks = {"glm4-9b": [r[0] for r in eight],
             "llama3.2-1b": [r[1] for r in eight],
             "qwen2-moe-a2.7b": [r[0] for r in two]}
    return {"ref": ref, "ranks": ranks, "pods": (cfg, trees, pods),
            "helpers": [r[1] for r in two], "threads": [r[2] for r in two],
            "compressed": (list(compressed), [r[3] for r in two])}


def _coords(rank, shape, axes):
    return {a: int(c) for a, c in zip(axes, np.unravel_index(rank, shape))}


def _blocks(api, mesh, rank):
    """The reference's blocks (``resolve_spec`` with ``PARAM_RULES`` on the
    whole mesh) that ``rank`` of ``mesh`` (sizes, names) holds."""
    return S.param_blocks(api, LogicalMesh(*mesh), _coords(rank, *mesh))


def _holder(rank, mesh, axes):
    """The lowest rank of ``mesh`` holding ``rank``'s block of a leaf
    split over ``axes``: its coordinates on those, 0 on the rest."""
    shape, names = mesh
    c = _coords(rank, shape, names)
    return int(np.ravel_multi_index(
        [c[a] if a in axes else 0 for a in names], shape))


@pytest.mark.parametrize("arch", sorted(CASES))
def test_steps_hold_the_reference(runs, arch):
    ref, ranks = runs["ref"][arch], runs["ranks"][arch]
    api = build_model(reduced(get_arch(arch)), device="meta",
                      dtype=torch.float32)
    names = list(named_leaves(api.param_specs()))
    for i in range(STEPS):
        for r in ranks:
            got = r["steps"][i]
            np.testing.assert_allclose(float(got["loss"]), ref["loss"][i],
                                       rtol=RTOL)
            np.testing.assert_allclose(float(got["gnorm"]),
                                       ref["one_gnorm"][i],
                                       rtol=ONE_GNORM_RTOL)
            np.testing.assert_allclose(float(got["gnorm"]), ref["gnorm"][i],
                                       rtol=GNORM_RTOL)
            # the same bits on every rank
            assert torch.equal(got["loss"], ranks[0]["steps"][i]["loss"])
            assert torch.equal(got["gnorm"], ranks[0]["steps"][i]["gnorm"])
        before, after = leaves(ref["params"][i]), leaves(ref["new"][i])
        for rank, r in enumerate(ranks):
            blocks = _blocks(api, CASES[arch], rank)
            for name, blk, w0, w, g in zip(names, blocks, before, after,
                                           leaves(r["steps"][i]["params"])):
                if blk is not None:
                    w0, w = w0[blk], w[blk]
                assert g.shape == w.shape, (name, g.shape, w.shape)
                d = (g - w).abs()
                off = int((d > PARAM_TOL * w.abs().max()).sum())
                allowed = PARAM_SHARE * d.numel()
                # a leaf too small for the share to allow one element
                allowed = PARAM_FEW if allowed < 1 else allowed
                assert off <= allowed, (arch, i, name, off)
                assert d.max() <= 2 * (w - w0).abs().max(), (arch, i, name)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_ranks_agree_on_whole_leaves_and_model_shards(runs, arch):
    ranks = runs["ranks"][arch]
    mesh = CASES[arch]
    split = ranks[0]["split"]
    # the reference's layout: every leaf with an embed dim over data, the
    # head, heads and mlp dims over model
    assert any("model" in a for a in split)
    data = dict(zip(mesh[1], mesh[0]))["data"] > 1
    assert any("data" in a for a in split) == data
    for i in range(STEPS):
        for rank, r in enumerate(ranks):
            for k, axes in enumerate(split):
                # a block: the same bits on every rank that holds it
                peer = ranks[_holder(rank, mesh, axes)]
                assert r["steps"][i]["digest"][k] == \
                    peer["steps"][i]["digest"][k], (arch, i, rank, k)
        assert all(r["model_bytes"] > 0 for r in ranks)
    if arch == "glm4-9b":
        # the KV heads stayed whole over model: wk and wv are not split
        # there, only over data
        names = list(named_leaves(build_model(
            reduced(get_arch(arch)), device="meta").param_specs()))
        assert split[names.index("blocks/attn/wk")] == ("data",)
        assert split[names.index("blocks/attn/wq")] == ("data", "model")


def test_compressed_payload_is_the_whole_leaf_cut_to_the_shard(runs):
    import jax
    import jax.numpy as jnp
    from repro.optim.compression import _quantize
    cfg, trees, pods = runs["pods"]
    api = build_model(cfg, device="meta", dtype=torch.float32)
    quantize = jax.jit(_quantize)
    want = []
    for g, e in trees:
        gf = [np.asarray(a, np.float32) + b
              for a, b in zip(leaves(g), leaves(e))]
        qs = [quantize(jnp.asarray(x)) for x in gf]
        want.append((gf, [np.asarray(q) for q, _ in qs],
                     [np.float32(s) for _, s in qs]))
    for rank, out in enumerate(pods):
        pod, _, j = np.unravel_index(rank, COMPRESSED[0])
        gf, q_want, s_want = want[pod]
        _, q_peer, s_peer = want[1 - pod]
        cuts = [(lambda a: a) if b is None else (lambda a, b=b: a[b])
                for b in _blocks(api, COMPRESSED, rank)]
        parts = out["q"].split([cut(q).size for q, cut in zip(q_want, cuts)])
        assert out["scales"].numpy().tobytes() == \
            np.asarray(s_want, np.float32).tobytes()
        for k, (part, q, cut) in enumerate(zip(parts, q_want, cuts)):
            np.testing.assert_array_equal(part.numpy(), cut(q).reshape(-1),
                                          err_msg=str(k))
        for k, (r, e, cut) in enumerate(zip(leaves(out["reduced"]),
                                            leaves(out["ef"]), cuts)):
            mine = q_want[k].astype(np.float32) * s_want[k]
            theirs = q_peer[k].astype(np.float32) * s_peer[k]
            assert r.numpy().tobytes() == cut(
                (mine + theirs) * np.float32(0.5)).tobytes(), k
            assert e.numpy().tobytes() == cut(gf[k] - mine).tobytes(), k


def _held(got, want, tol, share, what):
    """Within ``tol`` of ``want``'s largest |value| at all but ``share``
    of the elements."""
    d = (got.double() - want.double()).abs() / (want.abs().max() + 1e-30)
    assert float((d > tol).double().mean()) <= share, \
        (what, int((d > tol).sum()), d.numel())


def test_compressed_step_on_a_model_axis_holds_the_pods_alone(runs):
    ranks, alone = runs["compressed"]
    cfg = reduced(get_arch("llama3.2-1b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=SEQ)
    names = list(named_leaves(api.param_specs()))
    first = leaves(api.init(torch.Generator().manual_seed(3)))
    split = ranks[0]["split"]
    assert any(split) and not all(split) and not any(alone[0]["split"])
    assert all(a in ((), ("model",)) for a in split)
    for rank, r in enumerate(ranks):
        pod, _, j = np.unravel_index(rank, COMPRESSED[0])
        mine = alone[pod]
        np.testing.assert_allclose(r["losses"], mine["losses"], rtol=RTOL)
        # steps 0 and 1 run on equal params (lr is 0 at step 0)
        np.testing.assert_allclose(r["gnorms"][:2], mine["gnorms"][:2],
                                   rtol=GNORM_RTOL)
        assert r["losses"] == ranks[0]["losses"]
        assert r["gnorms"] == ranks[0]["gnorms"]
        # whole leaves: the same bits everywhere; shards: on both pods
        for k, axes in enumerate(split):
            peer = ranks[_holder(rank, COMPRESSED, axes)]
            assert r["digests"][-1][k] == peer["digests"][-1][k], (rank, k)
        blocks = _blocks(api, COMPRESSED, rank)
        for name, blk, p0, w, g, e_w, e_g in zip(
                names, blocks, first, leaves(mine["params"]),
                leaves(r["params"]), leaves(mine["ef_steps"][0]),
                leaves(r["ef_steps"][0])):
            if blk is not None:
                p0, w, e_w = p0[blk], w[blk], e_w[blk]
            assert g.shape == w.shape and e_g.shape == e_w.shape, name
            _held(g, w, COMP_PARAM_TOL, PARAM_SHARE, name)
            # no element moved further than twice the pods' widest move
            assert float((g - w).abs().max()) <= \
                2 * float((w - p0).abs().max()), name
            # the first step's error feedback, from the same draw
            _held(e_g, e_w, EF_TOL, TIE_SHARE, name)


def _close(got, want, what):
    torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                               msg=what)


def test_helper_backwards_equal_autograd_of_the_one_rank_function(runs):
    t = _helper_inputs()
    h, wi, wo, x, table = (t[k].clone().requires_grad_()
                           for k in ("h", "wi", "wo", "x", "table"))
    loss = _mlp_loss(t, h, wi, wo)
    loss.backward()
    _gather_loss(t, x).backward()
    _embed_loss(t, table).backward()
    a, b = runs["helpers"]
    for r, out in enumerate((a, b)):
        _close(out["mlp"], loss.detach(), "reduce_model value")
        gh, gi, go = out["mlp_grads"]
        _close(gh, h.grad, "copy_to_model backward")
        _close(gi, wi.grad[:, r * 3:(r + 1) * 3], "column shard")
        _close(go, wo.grad[r * 3:(r + 1) * 3], "reduce_model backward")
        _close(out["gather_grad"], x.grad[:, r * 3:(r + 1) * 3],
               "gather_model backward")
        _close(out["embed_grad"], table.grad[r * 12:(r + 1) * 12],
               "embed_lookup backward")
        assert torch.equal(out["max"], torch.maximum(t["x"], t["x"] * 2 - 2))
    # the whole input's gradient is the same bits on both ranks
    assert torch.equal(a["mlp_grads"][0], b["mlp_grads"][0])


def test_vocab_parallel_loss_equals_the_whole_head(runs):
    xs = _xent_inputs()
    h = xs["h"].clone().requires_grad_()
    w = xs["w"].clone().requires_grad_()
    loss = L.chunked_softmax_xent(h, w, xs["labels"], chunk=8,
                                  label_mask=xs["mask"])
    loss.backward()
    half = XENT_V // 2
    outs = runs["helpers"]
    for r, out in enumerate(outs):
        got, gh, gw = out["xent"]
        torch.testing.assert_close(got, loss.detach(), atol=0, rtol=1e-6)
        _close(gh, h.grad, "h")
        _close(gw, w.grad[:, r * half:(r + 1) * half], "the head's block")
    assert torch.equal(outs[0]["xent"][0], outs[1]["xent"][0])
    assert torch.equal(outs[0]["xent"][1], outs[1]["xent"][1])


def test_recompute_runs_the_model_axis_on_another_thread(runs):
    # the remat and loss recomputes re-enter the forward's rule context,
    # so their collectives run wherever autograd runs the backward
    for here, there in runs["threads"]:
        assert all(torch.equal(a, b) for a, b in zip(here, there))

