"""The prefill and decode serve steps over a pod x data mesh of ranks
(``runtime.steps.make_prefill_step`` / ``make_decode_step`` with a
``DeviceMesh`` of four gloo CPU ranks, ``make_mesh((2, 2), ("pod",
"data"))``), reduced llama3.2-1b in f32, one thread a rank.

(a) Against the reference's ``make_prefill_step`` / ``make_decode_step``
    on its (2, 2) mesh of fake XLA devices (run once in a subprocess while
    the ranks run): the [B, V] logits of the prefill and of every greedy
    decode step within 1e-4 of the largest |logit| (the port's f32
    tolerance, ``tests/test_torch_steps_mesh.py``), greedy tokens equal.
(b) Rank (p, d) takes the ``(p * 2 + d)``-th block of B / 4 rows: its
    prefill cache, its decode cache and its rows of every step's logits
    are the one-device ``prefill_fn`` / ``decode_fn`` on those rows, bit
    for bit; the whole [B, V] logits are the same on every rank.
(c) A global batch that does not split over the four ranks is refused by
    name.
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
from repro_torch.launch import rank_jobs as J
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.tree import leaves
from repro_torch.weights import params_from_jax

B, SQ, STEPS = 8, 12, 3
MESH = ((2, 2), ("pod", "data"))
F32_TOL = 1e-4

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.configs.base import ShapeConfig
from repro.launch.mesh import make_mesh
from repro.models.api import build_model
from repro.runtime import steps as S
from repro.sharding import rules as R

data = pickle.load(open(PATH, "rb"))
B, SQ, STEPS = data["shape"]
cfg = reduced(get_arch("llama3.2-1b"))
api = build_model(cfg, max_seq=SQ + STEPS)
params = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      api.init(jax.random.PRNGKey(0)))
mesh = make_mesh((2, 2), ("pod", "data"))
pre = S.make_prefill_step(api, mesh, ShapeConfig("p", SQ, B, "prefill"))
dshape = ShapeConfig("d", SQ + STEPS, B, "decode")
dec = S.make_decode_step(api, mesh, dshape)
logits, cache = pre(params, {"tokens": jnp.asarray(data["tokens"])})
out = [np.asarray(logits)]
cache = dict(cache, blocks=tuple(
    jnp.pad(t, ((0, 0),) * 3 + ((0, STEPS), (0, 0)))
    for t in cache["blocks"]))
# the decode step's in_shardings: the batch's rows over (pod, data)
cache = jax.device_put(cache, S.cache_shardings(
    api, B, mesh, R.ACT_RULES, max_seq=SQ + STEPS))
tok_sharding = S.batch_shardings(api, dshape, mesh, R.ACT_RULES)["tokens"]
for _ in range(STEPS):
    tok = jax.device_put(jnp.argmax(logits, -1)[:, None].astype(jnp.int32),
                         tok_sharding)
    logits, cache = dec(params, cache, {"tokens": tok})
    out.append(np.asarray(logits))
pickle.dump({"logits": out}, open(PATH, "wb"))
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


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(the reference's logits, the port's model, params and tokens, the
    four ranks' results)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    cfg = reduced(get_arch("llama3.2-1b"))
    toks = np.random.RandomState(31).randint(0, cfg.vocab_size, (B, SQ),
                                             dtype=np.int32)
    path = str(tmp_path_factory.mktemp("steps_ranks") / "reference.pkl")
    with open(path, "wb") as f:
        pickle.dump({"shape": (B, SQ, STEPS), "tokens": toks}, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.replace("PATH", repr(path))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        old = JL.DEFAULT_DTYPE
        JL.DEFAULT_DTYPE = jnp.float32
        try:
            japi = jbuild(jreduced(jget("llama3.2-1b")), max_seq=SQ + STEPS)
            jparams = jax.tree.map(
                lambda x: np.asarray(x.astype(jnp.float32))
                if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x),
                japi.init(jax.random.PRNGKey(0)))
        finally:
            JL.DEFAULT_DTYPE = old
        api = build_model(cfg, device="cpu", dtype=torch.float32,
                          max_seq=SQ + STEPS)
        params = params_from_jax(jparams, "cpu")
        tokens = torch.from_numpy(toks)
        ranks = spawn(J.serve_steps, 4, backend="gloo", device="cpu",
                      args=(J.StepsJob(cfg, MESH, tokens, steps=STEPS,
                                       params=params, indivisible=6),))
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0 and "REFERENCE OK" in out, err[-4000:]
        with open(path, "rb") as f:
            ref = pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    yield ref["logits"], api, params, tokens, ranks


def test_serve_steps_over_ranks_hold_the_reference(steps):
    ref, _, _, _, ranks = steps
    for r in ranks:
        assert len(r["logits"]) == len(ref) == STEPS + 1
        for got, want in zip(r["logits"], ref):
            assert tuple(got.shape) == want.shape == (B, got.shape[1])
            assert _rel(got.numpy(), want) < F32_TOL
            np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                          want.argmax(-1))


def test_each_rank_is_the_one_device_step_on_its_rows(steps):
    _, api, params, tokens, ranks = steps
    for rank, r in enumerate(ranks):
        rows = r["rows"]
        assert rows == slice(rank * B // 4, (rank + 1) * B // 4)
        logits, cache = api.prefill_fn(params, {"tokens": tokens[rows]})
        assert torch.equal(r["logits"][0][rows], logits)
        for a, b in zip(leaves(r["prefill_cache"]), leaves(cache)):
            assert torch.equal(a, b)
        cache = J.grow_cache(api, cache, STEPS)
        for i in range(STEPS):
            tok = r["logits"][i].argmax(-1)[:, None].to(torch.int32)
            logits, cache = api.decode_fn(params, cache,
                                          {"tokens": tok[rows]})
            assert torch.equal(r["logits"][i + 1][rows], logits)
        # the cache holds this rank's rows only
        assert all(t.shape[1] == B // 4 for t in r["cache"]["blocks"])
        for a, b in zip(leaves(r["cache"]), leaves(cache)):
            assert torch.equal(a, b)
        assert int(r["cache"]["len"]) == SQ + STEPS
    for r in ranks[1:]:
        for a, b in zip(r["logits"], ranks[0]["logits"]):
            assert torch.equal(a, b)


def test_a_batch_that_does_not_split_is_refused_by_name(steps):
    for r in steps[4]:
        assert "does not split over 4 ranks" in r["refusal"]
        assert "prefill_step" in r["refusal"]
