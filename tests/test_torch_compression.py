"""The cross-pod gradient compression of the port (``optim/compression.py``)
and the compressed train step over ranks, against the reference on the
CPU.

(a) ``_quantize`` equals the reference's bit for bit: q and scale, on
    random leaves (200 absmaxes, where XLA's folded 1/127 shows),
    leaves of exact rounding ties ((k + 0.5) * scale, scale a power of
    two) and an all-zero leaf.
(b) ``compressed_psum_pod`` on two gloo ranks equals the reference's
    inside ``jax.shard_map`` on two fake XLA devices bit for bit, reduced
    gradient and new error feedback both, from f32 and bf16 gradients;
    both pods' results are equal to each other. The reference is compiled
    at ``--xla_backend_optimization_level=0``: its HLO is the same (XLA
    folds ``/ 127`` into ``* f32(1/127)`` there, and the port does
    likewise), but the default level lets LLVM contract ``mine + theirs``
    and ``gf - mine`` into FMAs, which rounds once where the source rounds
    twice and leaves the reference's two pods apart by an ulp at some
    elements; the port keeps the source's roundings, so its pods agree.
(c) On three ranks it is the f32 sum over pods / 3, within rtol 1e-6 of
    the reference's, with the error feedback handed back unchanged.
(d) Three compressed train steps of reduced llama3.2-1b in f32 on (2, 2)
    pod x data ranks, from the reference's weights (``params_from_jax``)
    and the same ``SyntheticTokenStream``, against the reference's
    ``make_train_step(..., compress_pod_grads=True)`` on a (2, 2) mesh of
    fake devices. The two packages' gradients differ by rounding (sums in
    other orders), about 1e-5 of a leaf's largest gradient, and the int8
    exchange turns that into whole quantization steps where a value sits
    on a rounding tie; AdamW then moves such an element by up to lr.
    So: each loss within rtol 1e-4; the final params within 1e-4 of each
    leaf's largest |value| at all but 5% of the elements (measured: at
    most 3.5%, a 256-element norm) and nowhere further apart than twice
    the reference's largest move; the error feedback after step 1 (equal
    params: the schedule's lr is 0 at step 0) within 2.5e-2 of its largest
    |value| at all but 0.1% of the elements (a tie moves one by a scale,
    twice that largest value; measured: at most 2% of a 256-element norm
    past 1e-2, 0.03% past 0.25); every rank ends with the same params,
    and a pod's data ranks with the same error feedback.

The reference runs once, in a subprocess with 4 fake XLA devices, and
hands its results over in a pickle.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import rank_jobs
from repro_torch.launch import ranks as RK
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, named_leaves
from repro_torch.weights import params_from_jax

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=40)
STEPS, BATCH, SEQ = 3, 4, 32
# the whole step against the reference (see (d) above), each of the
# largest |value| of its leaf
PARAM_TOL, PARAM_SHARE = 1e-4, 0.05
EF_TOL, TIE_SHARE = 2.5e-2, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_np(seed, pods, dtype=np.float32):
    """Per-pod gradient and error-feedback trees: dicts of a few leaves,
    one all zero, one of exact ties."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(pods):
        g = {"a": rng.randn(6, 5).astype(np.float32) * 3,
             "b": np.zeros((7,), np.float32),
             "c": ((rng.randint(-120, 120, (4, 8)) + 0.5)
                   * 2.0 ** -7).astype(np.float32),
             "d": rng.randn(33).astype(np.float32) * 1e-3}
        g["c"][0, 0] = 127 * 2.0 ** -7              # absmax: scale 2^-7
        e = {k: rng.randn(*v.shape).astype(np.float32) * 1e-2
             for k, v in g.items()}
        e["c"][:] = 0.0                               # keep the ties exact
        out.append(({k: v.astype(dtype) for k, v in g.items()}, e))
    return out


REFERENCE = """
import os, pickle
# the reference's program as XLA's HLO passes leave it (/ 127 folded into
# * f32(1/127)), compiled without LLVM's FMA contraction: at the default
# level XLA:CPU fuses mine + theirs into an FMA on the peer's product,
# and its two pods then part by an ulp at some elements
os.environ["XLA_FLAGS"] += " --xla_backend_optimization_level=0"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced, ShapeConfig
from repro.data.tokens import SyntheticTokenStream
from repro.models.api import build_model
from repro.optim import adamw
from repro.optim.adamw import AdamWConfig
from repro.optim.compression import (_quantize, compressed_psum_pod,
                                     init_error_feedback)
from repro.runtime import steps as S

data = pickle.load(open(PATH, "rb"))
out = {"quantize": {}, "psum": {}}
for name, leaf in data["quantize"].items():
    q, s = jax.jit(_quantize)(jnp.asarray(leaf))
    out["quantize"][name] = (np.asarray(q), np.asarray(s))

def psum(pods, trees):
    mesh = jax.make_mesh((pods,), ("pod",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:pods])
    g = jax.tree.map(lambda *xs: jnp.stack(xs), *[t[0] for t in trees])
    e = jax.tree.map(lambda *xs: jnp.stack(xs), *[t[1] for t in trees])
    spec = jax.tree.map(lambda _: P("pod"), g)
    def body(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        r, ne = compressed_psum_pod(g, e, "pod", pods)
        return (jax.tree.map(lambda x: x[None], r),
                jax.tree.map(lambda x: x[None], ne))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec), check_vma=False))
    r, ne = fn(g, e)
    return jax.tree.map(np.asarray, r), jax.tree.map(np.asarray, ne)

for key, trees in data["psum"].items():
    out["psum"][key] = psum(len(trees), trees)

cfg = reduced(get_arch("llama3.2-1b"))
api = build_model(cfg, max_seq=data["seq"])
params = jax.tree.map(lambda x: x.astype(jnp.float32),
                      api.init(jax.random.PRNGKey(0)))
out["params0"] = jax.tree.map(np.asarray, params)
shape = ShapeConfig("t", data["seq"], data["batch"], "train")
mesh = jax.make_mesh((2, 2), ("pod", "data"), axis_types=(AxisType.Auto,) * 2)
opt = adamw.init(params)
ef = init_error_feedback(params)
stream = SyntheticTokenStream(cfg.vocab_size, data["batch"], data["seq"],
                              seed=0, structure=1.0)
losses, efs = [], []
with jax.set_mesh(mesh):
    step = S.make_train_step(api, mesh, AdamWConfig(**data["opt"]), shape,
                             compress_pod_grads=True)
    for i in range(data["steps"]):
        loss, params, opt, ef, gn = step(params, opt, ef, next(stream),
                                         np.int32(i))
        losses.append(float(loss))
        efs.append(jax.tree.map(np.asarray, ef))
out["train"] = (losses, jax.tree.map(np.asarray, params), efs)
pickle.dump(out, open(PATH, "wb"))
print("REFERENCE OK")
"""


def _quantize_inputs():
    rng = np.random.RandomState(3)
    ties = ((rng.randint(-126, 126, (64,)) + 0.5) * 2.0 ** -5)
    ties[0] = 127 * 2.0 ** -5
    # one leaf a scale: XLA folds / 127 into * f32(1/127), which moves the
    # scale by an ulp for about 4% of absmaxes
    many = {f"scale{i}": (rng.randn(5) * 10.0 ** rng.uniform(-3, 3)
                          ).astype(np.float32) for i in range(200)}
    return {**many, "random": rng.randn(50, 7).astype(np.float32),
            "ties": ties.astype(np.float32),
            "zero": np.zeros((3, 4), np.float32),
            "tiny": (rng.randn(9) * 1e-14).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    data = {"quantize": _quantize_inputs(),
            "psum": {("f32", 2): _leaves_np(0, 2),
                     ("bf16", 2): _leaves_np(1, 2, np.float32),
                     ("f32", 3): _leaves_np(2, 3)},
            "opt": OPT, "steps": STEPS, "batch": BATCH, "seq": SEQ}
    # the bf16 case: gradients rounded to bf16 on both sides
    data["psum"][("bf16", 2)] = [
        ({k: torch.from_numpy(v).bfloat16().float().numpy()
          for k, v in g.items()}, e) for g, e in data["psum"][("bf16", 2)]]
    path = str(tmp_path_factory.mktemp("compression") / "ref.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    out = run_subprocess(REFERENCE.replace("PATH", repr(path)), devices=4,
                         timeout=600)
    assert "REFERENCE OK" in out
    with open(path, "rb") as f:
        ref = pickle.load(f)
    os.remove(path)
    return data, ref


def test_quantize_is_bit_equal(reference):
    data, ref = reference
    for name, leaf in data["quantize"].items():
        q, s = C._quantize(torch.from_numpy(leaf))
        want_q, want_s = ref["quantize"][name]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), want_q)
        assert s.numpy().tobytes() == np.float32(want_s).tobytes(), name


def _torch_tree(tree, dtype=torch.float32):
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in tree.items()}


@pytest.fixture(scope="module")
def exchanged(reference):
    """The port's exchange on gloo ranks: both two-pod cases on two ranks,
    the three-pod case on three."""
    data, _ = reference
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def cases(keys):
        return [[(_torch_tree(g, dtypes[k[0]]), _torch_tree(e))
                 for g, e in data["psum"][k]] for k in keys]

    two = [("f32", 2), ("bf16", 2)]
    outs = RK.spawn(rank_jobs.pod_exchange, 2, backend="gloo", device="cpu",
                    args=(cases(two),))
    got = {k: [o[i] for o in outs] for i, k in enumerate(two)}
    outs = RK.spawn(rank_jobs.pod_exchange, 3, backend="gloo", device="cpu",
                    args=(cases([("f32", 3)]),))
    got[("f32", 3)] = [o[0] for o in outs]
    return got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_two_pods_are_bit_equal_to_the_reference(reference, exchanged,
                                                 dtype):
    _, ref = reference
    outs = exchanged[(dtype, 2)]
    want_r, want_e = ref["psum"][(dtype, 2)]
    for pod, (r, e, sent) in enumerate(outs):
        # one int8 a element and one f32 scale a leaf
        assert sent == C.exchanged_bytes(r) == sum(
            v[pod].size + 4 for v in want_r.values())
        for k in want_r:
            assert r[k].dtype == torch.float32
            assert r[k].numpy().tobytes() == want_r[k][pod].tobytes(), k
            assert e[k].numpy().tobytes() == want_e[k][pod].tobytes(), k
    for k in want_r:
        assert torch.equal(outs[0][0][k], outs[1][0][k])


def test_three_pods_reduce_in_f32(reference, exchanged):
    data, ref = reference
    trees = data["psum"][("f32", 3)]
    want_r, _ = ref["psum"][("f32", 3)]
    for pod, (r, e, _) in enumerate(exchanged[("f32", 3)]):
        for k in want_r:
            np.testing.assert_allclose(r[k].numpy(), want_r[k][pod],
                                       rtol=1e-6, atol=1e-6 * np.abs(
                                           want_r[k][pod]).max())
            np.testing.assert_array_equal(e[k].numpy(), trees[pod][1][k])


def _held(got, want, tol, share, what):
    """Within ``tol`` of the largest |value| at all but ``share`` of the
    elements; returns the largest difference in that unit."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want) / (np.abs(want).max() + 1e-30)
    assert (d > tol).mean() <= share, (what, int((d > tol).sum()), d.size)
    return float(d.max())


def test_compressed_steps_on_ranks_match_the_reference(reference):
    data, ref = reference
    losses, want_params, want_efs = ref["train"]
    cfg = reduced(get_arch("llama3.2-1b"))
    job = rank_jobs.TrainJob(cfg, ((2, 2), ("pod", "data")), STEPS, BATCH,
                             SEQ, opt=AdamWConfig(**OPT), compressed=True,
                             params=params_from_jax(ref["params0"], "cpu"),
                             structure=1.0)
    outs = RK.spawn(rank_jobs.train, 4, backend="gloo", device="cpu",
                    args=(job,))
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-4)
    for o in outs[1:]:
        assert o["losses"] == outs[0]["losses"]
        assert o["digests"] == outs[0]["digests"]
    p0 = named_leaves(params_from_jax(ref["params0"], "cpu"))
    got_p = named_leaves(outs[0]["params"])
    want_p = named_leaves(params_from_jax(want_params, "cpu"))
    assert sorted(got_p) == sorted(want_p)
    for name, w in want_p.items():
        g = got_p[name]
        assert g.dtype == torch.float32
        _held(g.numpy(), w.numpy(), PARAM_TOL, PARAM_SHARE, name)
        # no element moved further than twice the reference's widest move
        moved = float((w - p0[name]).abs().max())
        assert float((g - w).abs().max()) <= 2 * moved, name
    # step 1 runs on equal params (lr is 0 at step 0): the ef differs by
    # the gradients' rounding, and by a scale at tie elements
    got_e = named_leaves(outs[0]["ef_steps"][0])
    want_e = named_leaves(params_from_jax(want_efs[0], "cpu"))
    for name, w in want_e.items():
        _held(got_e[name].numpy(), w.numpy(), EF_TOL, TIE_SHARE, name)
    # the pods keep their own error feedback; a pod's data ranks share it
    for a, b in ((1, 0), (3, 2)):
        for x, y in zip(leaves(outs[a]["ef_steps"][-1]),
                        leaves(outs[b]["ef_steps"][-1])):
            assert torch.equal(x, y)
