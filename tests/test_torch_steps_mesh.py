"""The mesh, the serve steps, the train step's mesh argument, the FLOP
and byte counts and the calibration of the PyTorch port, on the CPU.

(a) ``make_mesh``: a real one-rank ``DeviceMesh`` for a mesh of one
    device, a ``LogicalMesh`` otherwise; the production meshes are
    logical; ``mesh_context`` is a no-op.
(b) The serve steps on a (1, 1) mesh against the reference's
    ``make_prefill_step`` / ``make_decode_step`` on a one-device mesh:
    reduced llama3.2-1b in f32, the reference's parameters carried
    across; logits within 1e-4 of the largest |logit| (the port's f32
    tolerance, ``tests/test_torch_timeline.py``), greedy tokens equal.
    The steps equal ``prefill_fn`` / ``decode_fn`` bit for bit, the train
    step on a (1, 1) mesh the train step without one. A mesh of several
    devices on a real device, the compressed cross-pod step and a
    re-sharding restore are refused by name.
(c) Counts on meta tensors (``utils.cost_analysis.cost_summary``):
    reduced dense prefill and decode equal a closed form from the config
    (projections, MLP, scores, values, head) and the same count on CPU
    tensors; reduced xLSTM's sLSTM loop, counted one step by its trip
    count on meta, equals the step-by-step loop on CPU tensors.
(d) ``hlo_calibration`` equals the reference's for the same ``{"flops",
    "bytes"}``, fed to the reference through a stub with
    ``cost_analysis()``, over a grid that reaches both clamps and the
    ``None`` cases; ``profiles_from_arch(calibrate_from_hlo=True,
    compiled=...)`` equals the reference's.
(e) The reference's four pipelined CI serve lines (ci.yml:37-44, :50-57,
    :75-81, :88-94) through the port with ``--device cpu`` added and
    ``--mesh`` kept: their OK markers; the demand-paging line drains every
    request. ``--mesh`` values one card cannot be are refused by name.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.core.planner.profiling import (hlo_calibration,
                                                profiles_from_arch)
from repro_torch.launch import serve
from repro_torch.launch.mesh import (LogicalMesh, make_mesh,
                                     make_production_mesh, mesh_context)
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as S
from repro_torch.tree import leaves, map_tree
from repro_torch.utils.cost_analysis import cost_summary
from repro_torch.weights import params_from_jax

F32_TOL = 1e-4           # of the largest |logit|
B, SQ, STEPS = 2, 16, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread runs them faster and keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    return jax, jnp


@pytest.fixture(scope="module")
def llama():
    """(japi, jparams, tapi, tparams): reduced llama3.2-1b in f32 in both
    packages, the reference's parameters carried across."""
    jax, jnp = _jax()
    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    try:
        japi = jbuild(jreduced(jget("llama3.2-1b")), max_seq=SQ + STEPS)
        jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                               japi.init(jax.random.PRNGKey(0)))
        tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                           dtype=torch.float32, max_seq=SQ + STEPS)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        yield japi, jparams, tapi, tparams
    finally:
        JL.DEFAULT_DTYPE = old


def _one_mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=shape,
                                               dtype=np.int32)


def _grow(cache, extra):
    """A timeline cache with ``extra`` zero positions on the seq axis."""
    return dict(cache, blocks=tuple(
        torch.nn.functional.pad(t, (0, 0, 0, extra))
        for t in cache["blocks"]))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# (a) meshes
# ---------------------------------------------------------------------------
def test_make_mesh_real_for_one_device_logical_otherwise():
    from torch.distributed.device_mesh import DeviceMesh
    m = _one_mesh()
    assert isinstance(m, DeviceMesh) and m.mesh_dim_names == ("data",
                                                               "model")
    assert m.device_type == "cpu"
    lm = make_mesh((2, 4), ("data", "model"))
    assert lm == LogicalMesh((2, 4), ("data", "model"))
    assert make_production_mesh() == LogicalMesh((16, 16), ("data",
                                                            "model"))
    assert make_production_mesh(multi_pod=True) == LogicalMesh(
        (2, 16, 16), ("pod", "data", "model"))
    with mesh_context(lm):
        pass
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((2, 2), ("data",))


# ---------------------------------------------------------------------------
# (b) steps
# ---------------------------------------------------------------------------
def test_serve_steps_equal_reference_and_direct_calls(llama):
    jax, jnp = _jax()
    from repro.configs.base import ShapeConfig as JShape
    from repro.launch.mesh import make_mesh as jmake
    from repro.runtime import steps as JS
    japi, jparams, tapi, tparams = llama
    jmesh = jmake((1, 1), ("data", "model"))
    toks = _tokens(tapi.cfg.vocab_size, (B, SQ))
    jpre = JS.make_prefill_step(japi, jmesh, JShape("p", SQ, B, "prefill"))
    jdec = JS.make_decode_step(japi, jmesh,
                               JShape("d", SQ + STEPS, B, "decode"))
    mesh = _one_mesh()
    pre = S.make_prefill_step(tapi, mesh, ShapeConfig("p", SQ, B, "prefill"))
    dec = S.make_decode_step(tapi, mesh,
                             ShapeConfig("d", SQ + STEPS, B, "decode"))
    jl, jc = jpre(jparams, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks)}
    tl, tc = pre(tparams, batch)
    dl, dc = tapi.prefill_fn(tparams, batch)
    assert torch.equal(tl, dl)
    assert all(torch.equal(a, b) for a, b in zip(tc["blocks"],
                                                 dc["blocks"]))
    assert _rel(tl, jl) < F32_TOL
    jc = dict(jc, blocks=tuple(jnp.pad(t, ((0, 0),) * 3 + ((0, STEPS),
                                                            (0, 0)))
                               for t in jc["blocks"]))
    tc, dc = _grow(tc, STEPS), _grow(dc, STEPS)
    jt = np.asarray(jl).argmax(-1)
    assert (jt == tl.argmax(-1).numpy()).all()
    for _ in range(STEPS):
        jl, jc = jdec(jparams, jc, {"tokens": jnp.asarray(jt[:, None],
                                                          jnp.int32)})
        tok = torch.from_numpy(jt[:, None].astype(np.int32))
        tl, out = dec(tparams, tc, {"tokens": tok})
        assert out is tc                      # updated in place
        dl, dc = tapi.decode_fn(tparams, dc, {"tokens": tok})
        assert torch.equal(tl, dl)
        assert _rel(tl, jl) < F32_TOL
        jt = np.asarray(jl).argmax(-1)
        assert (jt == tl.argmax(-1).numpy()).all()
    assert int(tc["len"]) == int(jc["len"]) == SQ + STEPS
    assert all(torch.equal(a, b) for a, b in zip(tc["blocks"],
                                                 dc["blocks"]))
    with pytest.raises(ValueError, match="tokens"):
        pre(tparams, {"tokens": batch["tokens"][:, :-1]})


def test_train_step_on_one_device_mesh_equals_no_mesh(llama):
    _, _, tapi, tparams = llama
    shape = ShapeConfig("t", SQ, B, "train")
    batch = {"tokens": _tokens(tapi.cfg.vocab_size, (B, SQ), 1),
             "labels": _tokens(tapi.cfg.vocab_size, (B, SQ), 2)}
    outs = []
    for mesh in (None, _one_mesh()):
        params = map_tree(lambda t: t.clone(), tparams)
        opt = adamw.init(params)
        step = S.make_train_step(tapi, AdamWConfig(), shape, device="cpu",
                                 mesh=mesh)
        for i in range(2):
            loss, params, opt, _ = step(params, opt, batch, i)
        outs.append((loss, params))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(outs[0][1]), leaves(outs[1][1])))


def test_hymba_loss_gradient_equals_reference():
    """Hymba's training gradient (the dry-run's train cell runs it): its
    chunked SSM scan wrote each chunk with ``out=``, which autograd
    refuses, so ``loss_fn``'s backward raised. Reduced hymba-1.5b in f32:
    the loss within rtol 1e-5 and
    every gradient within 5e-4 of its leaf's largest |value| of the
    reference's ``jax.value_and_grad`` (``tests/test_torch_train.py``'s
    tolerances), 2 x 16 tokens; then 2 x 320 tokens (two scan chunks of
    160) under autograd equal the same forward without it bit for bit."""
    jax, jnp = _jax()
    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    try:
        japi = jbuild(jreduced(jget("hymba-1.5b")), max_seq=16)
        jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                          japi.init(jax.random.PRNGKey(0)))
    finally:
        JL.DEFAULT_DTYPE = old
    tapi = build_model(reduced(get_arch("hymba-1.5b")), device="cpu",
                       dtype=torch.float32, max_seq=16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(tapi.cfg.vocab_size, (2, 16), 5)
    labels = _tokens(tapi.cfg.vocab_size, (2, 16), 6)
    jl, jg = jax.jit(jax.value_and_grad(japi.loss_fn))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tracked = map_tree(lambda t: t.requires_grad_(), tp)
    tl = tapi.loss_fn(tracked, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    tleaves = leaves(map_tree(lambda t: t.grad, tracked))
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 5e-4 * max(np.abs(j).max(),
                                                         1e-30)
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, 320, tapi.cfg.d_model).astype(np.float32))
    p = map_tree(lambda t: t.detach()[0], tp["blocks"]["ssm"])
    from repro_torch.models.hymba import mamba_apply
    with torch.no_grad():
        want = mamba_apply(tapi.cfg, p, x, mode="train")
    got = mamba_apply(tapi.cfg, map_tree(lambda t: t.requires_grad_(), p), x,
                      mode="train")
    assert got[0].requires_grad
    assert torch.equal(got[0].detach(), want[0])
    assert torch.equal(got[1][1].detach(), want[1][1])


def test_meshes_of_several_devices_are_refused_by_name(llama, tmp_path):
    _, _, tapi, tparams = llama
    shape = ShapeConfig("p", SQ, B, "prefill")
    pods = LogicalMesh((2, 2, 1), ("pod", "data", "model"))
    for make in (lambda m: S.make_prefill_step(tapi, m, shape),
                 lambda m: S.make_decode_step(tapi, m, shape),
                 lambda m: S.make_train_step(tapi, AdamWConfig(), ShapeConfig(
                     "t", SQ, B, "train"), device="cpu", mesh=m)):
        with pytest.raises(NotImplementedError, match="item 10"):
            make(pods)
    with pytest.raises(NotImplementedError, match="compression"):
        S.make_train_step(tapi, AdamWConfig(), ShapeConfig("t", SQ, B,
                                                           "train"),
                          device="cpu", mesh=pods, compress_pod_grads=True)
    # a checkpoint restores with one-device shardings, and refuses others
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tparams, block=True)
    got = mgr.restore(1, tparams,
                      shardings=S.param_shardings(tapi, _one_mesh()))
    assert all(torch.equal(a, b) for a, b in zip(leaves(got),
                                                 leaves(tparams)))
    with pytest.raises(NotImplementedError, match="item 10"):
        mgr.restore(1, tparams, shardings=S.param_shardings(tapi, pods))


def test_abstract_inputs_are_meta_and_match_the_reference_shapes():
    jax, _ = _jax()
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.configs.base import ShapeConfig as JShape
    from repro.models.api import build_model as jbuild
    from repro.runtime import steps as JS
    for arch in ("llama3.2-1b", "hymba-1.5b", "whisper-small"):
        for kind in ("train", "prefill", "decode"):
            japi = jbuild(jreduced(jget(arch)), max_seq=32)
            tapi = build_model(reduced(get_arch(arch)), device="meta",
                               max_seq=32)
            want = JS.abstract_inputs(japi, JShape("x", 32, 2, kind))
            got = S.abstract_inputs(tapi, ShapeConfig("x", 32, 2, kind))
            assert sorted(got) == sorted(want)
            for k in want:
                jl = jax.tree.leaves(want[k])
                tl = leaves(got[k])
                assert [tuple(x.shape) for x in jl] == \
                    [tuple(x.shape) for x in tl], (arch, kind, k)
                assert all(t.is_meta for t in tl)
            if kind == "train":
                assert all(t.dtype == torch.float32
                           for t in leaves(got["opt"]))


# ---------------------------------------------------------------------------
# (c) counts
# ---------------------------------------------------------------------------
def _dense_flops(cfg, Bq, Sq, Skv):
    """Projections, MLP, scores and values of every layer over Sq queries
    and Skv keys (the plain attention's full square), and the head at one
    position a row."""
    d, H, KVH, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    tok = Bq * Sq
    proj = 2 * tok * d * hd * (2 * H + 2 * KVH)
    mlp = 2 * tok * d * ff * 3
    attn = 2 * 2 * Bq * H * Sq * Skv * hd
    return cfg.num_layers * (proj + mlp + attn) + 2 * Bq * d * cfg.vocab_size


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dense_counts_equal_closed_form_and_cpu(kind, llama):
    _, _, tapi, tparams = llama
    cfg = tapi.cfg
    if kind == "prefill":
        shape = ShapeConfig("p", SQ, B, "prefill")
        want = _dense_flops(cfg, B, SQ, SQ)
        mk = lambda api: S.make_prefill_step(api, None, shape)
    else:
        shape = ShapeConfig("d", SQ + STEPS, B, "decode")
        want = _dense_flops(cfg, B, 1, SQ + STEPS)
        mk = lambda api: S.make_decode_step(api, None, shape)
    meta = build_model(cfg, device="meta", max_seq=SQ + STEPS,
                       dtype=torch.float32)
    ab = S.abstract_inputs(meta, shape)
    args = (ab["params"], ab["batch"]) if kind == "prefill" else \
        (ab["params"], ab["cache"], ab["batch"])
    counted = cost_summary(mk(meta), *args)
    assert counted["flops"] == want
    toks = torch.from_numpy(_tokens(cfg.vocab_size,
                                    ab["batch"]["tokens"].shape))
    if kind == "prefill":
        cpu_args = (tparams, {"tokens": toks})
    else:
        cpu_args = (tparams, tapi.init_cache(B, SQ + STEPS, fill_len=SQ),
                    {"tokens": toks})
    assert cost_summary(mk(tapi), *cpu_args) == counted


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_xlstm_loop_counted_by_trip_count_equals_the_loop(kind):
    cfg = reduced(get_arch("xlstm-125m"))
    Sx = 12
    shape = ShapeConfig("x", Sx, 2, kind)
    counts = []
    for dev in ("meta", "cpu"):
        api = build_model(cfg, device=dev, dtype=torch.float32, max_seq=Sx)
        ab = S.abstract_inputs(api, shape)
        if dev == "meta":
            params, batch = ab["params"], ab["batch"]
            opt = ab.get("opt")
        else:
            params = api.init(torch.Generator().manual_seed(0))
            batch = {k: torch.from_numpy(_tokens(cfg.vocab_size, v.shape, i))
                     for i, (k, v) in enumerate(ab["batch"].items())}
            opt = adamw.init(params) if kind == "train" else None
        if kind == "train":
            step = S.make_train_step(api, AdamWConfig(), shape, device=dev)
            args = (params, opt, batch, torch.zeros((), device=dev))
        else:
            step = S.make_prefill_step(api, None, shape)
            args = (params, batch)
        counts.append(cost_summary(step, *args))
    assert counts[0]["flops"] == counts[1]["flops"] > 0
    if kind == "prefill":
        # forward only: the counted step makes the loop's ops exactly
        assert counts[0]["bytes"] == counts[1]["bytes"]


# ---------------------------------------------------------------------------
# (d) calibration
# ---------------------------------------------------------------------------
def _stub(flops, byts):
    return types.SimpleNamespace(
        cost_analysis=lambda: {"flops": flops, "bytes accessed": byts})


def test_hlo_calibration_equals_reference():
    pytest.importorskip("jax")
    from repro.configs import get_arch as jget
    from repro.core.planner import profiling as JP
    for arch in ("llama3.2-1b", "qwen2-moe-a2.7b", "xlstm-125m"):
        cfg, jcfg = get_arch(arch), jget(arch)
        fl = sum(2.0 * cfg.block_active_params(i) for i in
                 range(cfg.num_layers))
        by = sum(cfg.block_params(i) * 2.0 + cfg.d_model * 2
                 for i in range(cfg.num_layers))
        seen = set()
        for f in (0.0, -1.0, fl * 0.5, fl, fl * 1.7, fl * 40.0):
            for b in (0.0, by * 0.01, by * 0.5, by * 3.0, by * 500.0):
                for batch in (1, 4):
                    want = JP.hlo_calibration(jcfg, 1, _stub(f, b), batch)
                    got = hlo_calibration(cfg, 1, {"flops": f, "bytes": b},
                                          batch)
                    assert got == want, (arch, f, b, batch)
                    carried = types.SimpleNamespace(
                        cost={"flops": f, "bytes": b})
                    assert hlo_calibration(cfg, 1, carried, batch) == want
                    if want is None:
                        seen.add("None")
                    else:
                        seen.update({f"eff={want[0]}", f"act={want[1]}"})
        # both clamps of both terms, and the degenerate counts
        assert {"None", "eff=0.05", "eff=1.0", "act=0.1", "act=100.0"} \
            <= seen, seen
        assert hlo_calibration(cfg, 1, None) is None
        assert hlo_calibration(cfg, 1, object()) is None
        count = {"flops": fl * 1.3, "bytes": by * 2.0}
        got = profiles_from_arch(cfg, 1, calibrate_from_hlo=True,
                                 compiled=count)
        want = JP.profiles_from_arch(jcfg, 1, calibrate_from_hlo=True,
                                     compiled=_stub(fl * 1.3, by * 2.0))
        assert [dataclasses.astuple(p) for p in got] == \
            [dataclasses.astuple(p) for p in want]
        assert got[0].eff < 1.0


# ---------------------------------------------------------------------------
# (e) the reference's pipelined CI serve lines, with --mesh
# ---------------------------------------------------------------------------
CI_LINES = {
    # ci.yml:37-44: live re-plan swap, token-exact, no recompiles
    "swap": ("--mesh 2x2 --stages 2 --microbatches 2 --slots 4 --requests 6 "
             "--max-new 8 --no-seal --f32 --inject-straggler 1:10 "
             "--verify-swap --warmup --assert-no-recompile",
             ("SWAP-EXACT OK", "NO-RECOMPILE OK")),
    # ci.yml:50-57: non-prefix plan
    "non-prefix": ("--mesh 3x1 --stages 3 --microbatches 2 --slots 4 "
                   "--requests 6 --max-new 8 --no-seal --f32 --topology "
                   "sandwich --delta 2.0 --require-non-prefix "
                   "--inject-straggler 2:10 --verify-swap",
                   ("NON-PREFIX OK", "SWAP-EXACT OK")),
    # ci.yml:75-81: demand paging, shared system prompt (no marker: it
    # must drain every request)
    "demand": ("--mesh 2x2 --stages 2 --microbatches 2 --slots 4 "
               "--requests 8 --prompt-len 12 --max-new 8 --page-size 8 "
               "--num-pages 9 --page-policy demand --shared-system-prompt "
               "0.75 --no-seal", ()),
    # ci.yml:88-94: chunked prefill
    "chunked": ("--mesh 2x2 --stages 2 --microbatches 2 --slots 4 "
                "--requests 8 --prompt-len 24 --max-new 8 --page-size 8 "
                "--no-seal --f32 --warmup --prefill-chunk 6 "
                "--verify-chunked --assert-no-recompile",
                ("CHUNK-EXACT OK", "NO-RECOMPILE OK")),
}


@pytest.mark.parametrize("name", sorted(CI_LINES))
def test_reference_ci_serve_lines_with_mesh(name, capsys):
    flags, markers = CI_LINES[name]
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu"] + \
        flags.split()
    st = serve.main(argv)
    out = capsys.readouterr().out
    for m in markers:
        assert m in out, (name, m)
    assert "pods x" in out
    args = serve.build_parser().parse_args(argv)
    assert st["completed"] == args.requests, st["completed"]
    assert not st["failed_requests"]


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2x1", "--stages", "3"], "2 pods but --stages 3"),
    (["--mesh", "4x1"], "4 pods but --stages 2"),
    (["--mesh", "2x2x2"], "pod x data"),
    (["--mesh", "0x1"], "pod x data"),
    (["--mesh", "two"], "pod x data")])
def test_serve_refuses_meshes_one_card_cannot_be(flags, match):
    with pytest.raises(ValueError, match=match):
        serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                    *flags])
    # the local backend ignores pods, as the reference's does
    args = serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", "--backend", "local", "--mesh", "4x1"])
    assert serve.check_mesh(args) == (4, 1)
