"""The pipelined decoder with one stage per rank (``PipelinedDecoder(mesh=)``
over ``launch.ranks``), on the CPU over gloo, against the reference.

The reference's ``tests/test_pipeline_runtime.py`` runs its ``shard_map``
pipeline on a (2, 2) pod x data mesh of fake XLA devices and holds it
against the single-device ``decode_fn``; here the same cases run on four
gloo ranks (stage s on the ranks of pod s, each data rank on half of each
microbatch's rows, sealed payloads sent between ranks):

(a) ``PIPE_CODE``: reduced llama3.2-1b (stage blocks None, [3, 1], [1, 3])
    and hymba-1.5b in f32, one decode step from the reference's prefilled
    timeline cache on its weights (``weights.cache_from_jax``): unsealed,
    logits and the cache within 1e-5 of the reference's ``decode_fn``
    (relative to the largest |value|, as the reference holds its own);
    sealed (llama, the reference's sealed case), within 0.05.
(b) Sealed and unsealed, every rank's logits and the cache gathered from
    the ranks equal the port's one-card ``PipelinedDecoder`` bit for bit.
    The one-card run takes ``num_microbatches x data`` microbatches, so
    every stage call has the rows a rank's call has (a CPU GEMM's bits
    depend on its row count); one thread, as each rank runs.
(c) ``NON_PREFIX_CODE``: the planner's 3-segment non-prefix plan on three
    ranks through ``from_spec(mesh=)``, token-exact and within 1e-5 of the
    reference's ``decode_fn``, and bit-equal to the one-card decoder.
(d) What crosses a boundary: the stage-0 ranks send the sealed int8
    payload and its scales (rows x (d_model + 4) bytes a microbatch), or
    the raw f32 activation unsealed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.launch import rank_jobs
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.runtime.pipeline import PipelinedDecoder
from repro_torch.weights import cache_from_jax, params_from_jax

B, S, PAD, NM = 8, 16, 16, 4
MESH = ((2, 2), ("pod", "data"))
LAYOUTS = {"llama3.2-1b": [None, (3, 1), (1, 3)], "hymba-1.5b": [None]}
CASES = [(arch, blocks, seal) for arch, layouts in LAYOUTS.items()
         for blocks in layouts for seal in (False, True)]
KEY = 7                                 # the reference's uint32(7)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    return jax, jnp


@pytest.fixture(scope="module")
def f32():
    _, jnp = _jax()
    import repro.models.layers as JL
    old = JL.DEFAULT_DTYPE
    JL.DEFAULT_DTYPE = jnp.float32
    yield
    JL.DEFAULT_DTYPE = old


def _reference(arch, batch, seed_new=2):
    """PIPE_CODE's inputs and oracle: the reference's f32 weights, its
    prefill of ``batch`` x S tokens padded by PAD positions, new tokens,
    and ``decode_fn``'s logits and cache; the port's params and cache on
    the same bits."""
    jax, jnp = _jax()
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    japi = jbuild(jreduced(jget(arch)), max_seq=32)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32)
                           if jnp.issubdtype(x.dtype, jnp.floating) else x,
                           japi.init(jax.random.PRNGKey(0)))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (batch, S), 0,
                                japi.cfg.vocab_size, jnp.int32)
    _, cache = jax.jit(japi.prefill_fn)(jparams, {"tokens": tokens})
    seg = japi.model.segments[0].name
    cache[seg] = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0)] * 3 + [(0, PAD)] + [(0, 0)])
        if a.ndim == 5 else a, cache[seg])
    new = jax.random.randint(jax.random.PRNGKey(seed_new), (batch, 1), 0,
                             japi.cfg.vocab_size, jnp.int32)
    np_cache = jax.tree.map(np.asarray, cache)
    ref_logits, ref_cache = jax.jit(japi.decode_fn)(jparams, cache,
                                                    {"tokens": new})
    tapi = build_model(reduced(get_arch(arch)), device="cpu",
                       dtype=torch.float32, max_seq=32)
    return dict(tapi=tapi,
                params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                       "cpu"),
                cache=cache_from_jax(np_cache, "cpu"),
                tokens=torch.from_numpy(np.array(new)),
                ref_logits=np.asarray(ref_logits),
                ref_cache=jax.tree.map(np.asarray, ref_cache), seg=seg)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(t) for t in tree)
    return tree.clone()


def _one_card(ref, blocks, seal, nm, spec=None):
    """The port's one-card decoder on a copy of the inputs: (logits, the
    decoded cache body)."""
    if spec is not None:
        dec = PipelinedDecoder.from_spec(ref["tapi"], spec, nm,
                                         seal_boundary=seal)
    else:
        dec = PipelinedDecoder(ref["tapi"], 2, nm, seal_boundary=seal,
                               stage_blocks=blocks)
    staged = dec.stage_cache(_clone(ref["cache"]))
    lg, (body, n) = dec.build(paged=False, per_slot_start=False)(
        ref["params"], staged, {"tokens": ref["tokens"]}, KEY)
    return lg, body, int(n)


def _gathered(ranks, run, seg_body, rows_of):
    """The whole cache body from every rank's stage layers and data rows:
    rank (s, d) contributes layers ``range`` and rows ``rows_of(d)``."""
    out = _clone(seg_body)
    for res in ranks:
        r = res[run]
        lo, hi = r["range"]
        rows = rows_of(r["data"])

        def put(dst, src):
            if isinstance(dst, tuple):
                for a, b in zip(dst, src):
                    put(a, b)
                return
            dst[lo:hi, rows] = src[:, rows]

        put(out, r["cache"][0])
    return out


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rows_of(data, D=2):
    """Data rank d's rows: the d-th half of each microbatch of B / NM."""
    mb, b = B // NM, B // NM // D
    return torch.tensor([m * mb + data * b + j for m in range(NM)
                         for j in range(b)])


@pytest.fixture(scope="module")
def pipe(f32):
    """Per arch: the reference's oracle and the four ranks' results of
    every (layout, seal) run of that arch, in CASES order."""
    out = {}
    for arch, layouts in LAYOUTS.items():
        ref = _reference(arch, B)
        job = rank_jobs.DecodeJob(
            ref["tapi"].cfg, MESH, ref["cache"], ref["tokens"],
            layouts=layouts, seals=(False, True), num_microbatches=NM,
            key=KEY, params=ref["params"], max_seq=32)
        ranks = spawn(rank_jobs.decode, 4, backend="gloo", device="cpu",
                      args=(job,))
        runs = {(blocks, seal): i for i, (blocks, seal) in enumerate(
            (b_, s_) for b_ in layouts for s_ in (False, True))}
        out[arch] = (ref, ranks, runs)
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


@pytest.mark.parametrize("arch,blocks,seal", CASES)
def test_ranked_pipeline_holds_the_reference(pipe, arch, blocks, seal):
    ref, ranks, runs = pipe[arch]
    run = runs[(blocks, seal)]
    tol = 0.05 if seal else 1e-5
    for res in ranks:
        assert _rel(res[run]["logits"][0], ref["ref_logits"]) < tol
        assert int(res[run]["cache"][1]) == int(ref["ref_cache"]["len"])
    body = _gathered(ranks, run, ref["cache"][ref["seg"]], _rows_of)
    for got, want in zip(_leaves(body),
                         _leaves(ref["ref_cache"][ref["seg"]])):
        assert _rel(got.numpy(), want) < tol


@pytest.mark.parametrize("arch,blocks,seal", CASES)
def test_ranked_pipeline_equals_one_card_bit_for_bit(pipe, arch, blocks,
                                                     seal):
    ref, ranks, runs = pipe[arch]
    run = runs[(blocks, seal)]
    lg, body, n = _one_card(ref, blocks, seal, NM * 2)
    for res in ranks:
        assert torch.equal(res[run]["logits"][0], lg)
        assert int(res[run]["cache"][1]) == n
    got = _gathered(ranks, run, ref["cache"][ref["seg"]], _rows_of)
    for a, b in zip(_leaves(got), _leaves(body)):
        assert torch.equal(a, b)
    # each rank kept its stage's layers only
    counts = blocks or (2, 2)
    for res in ranks:
        lo, hi = res[run]["range"]
        assert hi - lo == counts[res[run]["stage"]]
        assert _leaves(res[run]["cache"][0])[0].shape[0] == hi - lo


@pytest.mark.parametrize("seal", [False, True])
def test_boundary_payload_bytes(pipe, seal):
    ref, ranks, runs = pipe["llama3.2-1b"]
    run = runs[(None, seal)]
    d, b = ref["tapi"].cfg.d_model, B // NM // 2
    per_mb = b * (d + 4) if seal else b * d * 4
    for res in ranks:
        want = NM * per_mb if res[run]["stage"] == 0 else 0
        assert res[run]["sent_per_step"] == want


def _non_prefix_spec():
    """NON_PREFIX_CODE's plan through the port's planner: a similarity
    bump at layer 3 sandwiches a fast untrusted device between two slow
    enclaves; the segment solver beats every prefix plan."""
    from repro_torch.core import cost_model as CM
    from repro_torch.core.planner import (LayerProfile, PlacementSpec,
                                          ResourceGraph, solve)
    sims = [0.3, 0.3, 0.9, 0.1]
    profs = [LayerProfile(f"b{i}", 2e8, 2e5, sims[i], params_bytes=1e6)
             for i in range(4)]
    g = ResourceGraph({"tee0": CM.TEE,
                       "tee1": dataclasses.replace(CM.TEE, name="tee1"),
                       "gpu0": CM.GPU}, {}, CM.WAN_30MBPS)
    px = solve(profs, g, n=10_800, delta=0.5, solver="exhaustive")
    sg = solve(profs, g, n=10_800, delta=0.5, solver="segment-dp")
    assert sg.best.t_chunk < px.best.t_chunk * (1 - 1e-6)
    spec = PlacementSpec.from_placement(sg.best.placement, g)
    assert not spec.is_prefix(g) and spec.num_segments == 3
    return spec


def test_non_prefix_plan_on_three_ranks_is_token_exact(f32):
    spec = _non_prefix_spec()
    ref = _reference("llama3.2-1b", 6)
    job = rank_jobs.DecodeJob(ref["tapi"].cfg, ((3,), ("pod",)),
                              ref["cache"], ref["tokens"], spec=spec,
                              seals=(False,), num_microbatches=3, key=KEY,
                              params=ref["params"], max_seq=32)
    ranks = spawn(rank_jobs.decode, 3, backend="gloo", device="cpu",
                  args=(job,))
    want_tok = ref["ref_logits"].argmax(-1)
    lg, body, _ = _one_card(ref, None, False, 3, spec=spec)
    for res in ranks:
        r = res[0]
        assert r["stage_counts"] == spec.stage_sizes()
        assert r["stage_devices"] == spec.devices()
        assert _rel(r["logits"][0], ref["ref_logits"]) < 1e-5
        np.testing.assert_array_equal(r["tokens"][0].numpy(), want_tok)
        assert torch.equal(r["logits"][0], lg)
    assert [res[0]["range"] for res in ranks] == [
        PipelinedDecoder.from_spec(ref["tapi"], spec, 3).ranges[s]
        for s in range(3)]
