"""The disaggregated pair over ranks: ``build_disagg(api, params,
config=, backend="pipelined", mesh=make_mesh((2, 2), ("pod", "data")))``
on four gloo CPU ranks (a prefill-role and a decode-role rank engine on
every rank, stage s on the two data ranks of pod s, the orchestrator on
every rank), reduced llama3.2-1b in f32, one thread a rank, one spawn.

(a) ``REFERENCE``: the reference's ``build_disagg(mesh=)`` on its own
    (2, 2) mesh of fake XLA devices, sealed and unsealed eager in one
    subprocess and unsealed warmed in another, both running while the
    ranks serve. The ranks serve its streams, eager and warmed.
(b) Against the port's one-card pipelined pair on the same params: the
    streams of each run, sealed and unsealed, eager and warmed; under a
    seeded fault plane the same injections and recovery rungs.
(c) The first handoff: the pods' parts (data rank 0 of each seals its
    pod's layers; the other data ranks keep an empty part) side by side
    are the one-card pair's payload, byte for byte, with its
    ``payload_digest``; every transferred (layer, page row) is restored
    bit for bit (``rank_jobs.rows_restored``); the data ranks of a pod
    hold one decode cache after every tick.
(d) Keys: no (key, counter) pair ciphered twice over the four ranks and
    both roles, across warmup (both roles' tours) and serve
    (``rank_jobs.KeyLedger``); the prefill role's crossings, restages,
    exchanges and swaps lie in its own spaces (``sealing``,
    ``prefill=True``).
(e) Decisions: every rank's events (both roles), orchestrator decisions
    after every tick (back-pressure, the in-flight ladder: fates and
    deadlines) and stats are equal, but for ``PER_RANK``.
(f) A handoff after the decode role re-planned (the injected straggler)
    moves its cipher columns to their new owners first and restores bit
    for bit; a corrupted and a truncated transfer fall back to re-prefill
    on every rank at once.
(g) The serve launcher: the reference's ``--disagg --verify-disagg
    --warmup --assert-no-recompile`` line and its chaos-over-disagg line
    on four gloo ranks; ``make_disagg`` under ``--ranks`` builds rank
    engines on the rank mesh (the repair: before it, each rank served a
    one-device pair).
(h) On the card (marker ``cuda``): a warmed pair's exports and
    transfer-ins, replayed, are bit-equal to an eager pair's.
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
from repro_torch.launch import rank_jobs as J
from repro_torch.launch import serve
from repro_torch.launch.ranks import spawn
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, FaultConfig, build_disagg
from repro_torch.weights import params_from_jax
from test_torch_engine_ranks import _workloads
from test_torch_serve_ranks import NO_REPLAN

D = 2                                    # data ranks a pod
# the pair's engine: the reference disagg test's base (page 4, capacity
# 24: few prefill buckets for the reference's warmup), pipelined
BASE = dict(num_slots=4, num_stages=2, num_microbatches=2, max_seq=128,
            prompt_capacity=16, page_size=4, request_capacity=24,
            telemetry_interval=NO_REPLAN)
STRAGGLER = (1, 25.0)
# a plane that corrupts, truncates, drops and delays handoffs: seed 7
# fires each site over the fault plane's stream, all up front, so the
# prefill role also meets back-pressure
CHAOS = dict(seed=7, corrupt_transfer=0.3, truncate_transfer=0.3,
             drop_handoff=0.2, delay_handoff=0.2)
# stats each rank keeps of its own
PER_RANK = ("graphs", "warmup_s")

REFERENCE = """
import pickle
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L
L.DEFAULT_DTYPE = jnp.float32
from repro.configs import get_arch, reduced
from repro.launch.mesh import make_mesh
from repro.models.api import build_model
from repro.serving import EngineConfig, build_disagg

data = pickle.load(open(PATH, "rb"))
cfg = reduced(get_arch("llama3.2-1b"))
api = build_model(cfg, max_seq=128)
params = jax.tree.map(lambda x: x.astype(jnp.float32)
                      if jnp.issubdtype(x.dtype, jnp.floating) else x,
                      api.init(jax.random.PRNGKey(0)))
mesh = make_mesh((2, 2), ("pod", "data"))
out = {}
for name, kw in data["cases"].items():
    orch = build_disagg(api, params=params, mesh=mesh, backend="pipelined",
                        config=EngineConfig(**data["base"], **kw))
    wl, reqs, k = data["wl"], [], 0
    while k < len(wl) or orch.has_work():
        if k < len(wl):
            reqs.append(orch.submit(*wl[k]))
            k += 1
        orch.step()
        if k < len(wl) and not orch.has_work():
            reqs.append(orch.submit(*wl[k]))
            k += 1
    assert all(r.status == "done" for r in reqs)
    st = orch.stats()
    assert st["handoffs"] == len(wl), st["handoffs"]
    if kw.get("warmup"):
        assert st["post_warmup_compiles"] in (None, 0)
        assert st["prefill_stats"]["post_warmup_compiles"] in (None, 0)
    out[name] = [list(r.generated) for r in reqs]
pickle.dump(out, open(PATH, "wb"))
print("REFERENCE OK")
"""
# the reference's cases, by subprocess: eager, then warmed (its warmup
# compiles every bucket of both roles; no tour, as telemetry never
# re-plans here)
REF_CASES = ({"calm": dict(seal_boundary=False),
              "sealed": dict(seal_boundary=True)},
             {"calm_warm": dict(seal_boundary=False, warmup=True,
                                allow_swap=False)})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Reference:
    """``REFERENCE`` over ``cases`` in a subprocess with 4 fake XLA
    devices, running while the ranks serve (``result()`` waits for it)."""

    def __init__(self, path: str, cases, wl):
        with open(path, "wb") as f:
            pickle.dump({"base": BASE, "wl": wl, "cases": cases}, f)
        env = dict(os.environ)
        # XLA's CPU kernels on one thread: the four ranks serve meanwhile,
        # and other test files share the cores
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                            "--xla_cpu_multi_thread_eigen=false")
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


def _streams(vocab):
    """The reference's pipelined workload (five prompts of 3-8 tokens, 10
    new each), and a longer one for the fault plane (eight of 2-12)."""
    pipe, _ = _workloads(vocab)
    rng = np.random.RandomState(11)
    chaos = [(rng.randint(0, vocab, size=int(rng.randint(2, 13))).tolist(),
              int(rng.randint(4, 10))) for _ in range(8)]
    return pipe, chaos


def _runs(vocab):
    """name -> DisaggRun, each served on the 2 x 2 ranks in one spawn."""
    pipe, chaos = _streams(vocab)

    def cfg(**kw):
        return EngineConfig(**dict(BASE, **kw))

    return {
        "calm": J.DisaggRun(cfg(seal_boundary=False), pipe, every=1),
        "sealed": J.DisaggRun(cfg(), pipe, every=1),
        "calm_warm": J.DisaggRun(cfg(seal_boundary=False, warmup=True,
                                     allow_swap=False), pipe, every=1),
        # both roles tour every layout at warmup: restages in both roles
        "sealed_warm": J.DisaggRun(cfg(warmup=True), pipe, every=1),
        # the decode role re-plans at its first telemetry tick; the
        # handoffs after it relayout
        "straggler": J.DisaggRun(cfg(seal_boundary=False,
                                     telemetry_interval=2), pipe, every=1,
                                 inject=STRAGGLER),
        "chaos": J.DisaggRun(cfg(seal_boundary=False,
                                 faults=FaultConfig(**CHAOS)), chaos),
        "chaos_calm": J.DisaggRun(cfg(seal_boundary=False), chaos),
    }


def make_disagg_body(ctx, argv):
    """``serve.make_disagg`` on a rank, as ``serve --ranks`` calls it: the
    two roles' meshes (whether each is the rank mesh), backends, backend
    classes and whether they share one params tree."""
    from repro_torch.launch.mesh import make_mesh
    args = serve.build_parser().parse_args(argv)
    args.rank_mesh = make_mesh(serve.check_mesh(args), ("pod", "data"),
                               device=ctx.device)
    api, params = serve.build_params(args)
    orch = serve.make_disagg(api, params, args)
    return [(eng.mesh is args.rank_mesh, eng.backend_kind,
             type(eng.backend).__name__, eng.params is orch.decode.params)
            for eng in (orch.decode, orch.eng_prefill)]


ARGV = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--ranks",
        "gloo", "--mesh", "2x2", "--stages", "2", "--microbatches", "2",
        "--slots", "4", "--page-size", "4", "--prompt-len", "8",
        "--no-seal", "--f32", "--disagg"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the reference's subprocesses, the port's model and params, every
    run's four ranks' results by name, ``make_disagg_body``'s four)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.models.layers as JL
    from repro.configs import get_arch as jget, reduced as jreduced
    from repro.models.api import build_model as jbuild
    cfg = reduced(get_arch("llama3.2-1b"))
    pipe, _ = _streams(cfg.vocab_size)
    tmp = tmp_path_factory.mktemp("disagg_ranks")
    refs = [_Reference(str(tmp / f"ref{i}.pkl"), cases, pipe)
            for i, cases in enumerate(REF_CASES)]
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
    params = params_from_jax(jparams, "cpu")
    runs = _runs(cfg.vocab_size)
    out = spawn(J.chain, 4, backend="gloo", device="cpu", args=([
        (J.disagg, J.DisaggJob(cfg, list(runs.values()), params=params,
                               max_seq=128, data=D)),
        (make_disagg_body, ARGV)],))
    yield refs, api, params, {name: [r[0][i] for r in out]
                              for i, name in enumerate(runs)}, \
        [r[1] for r in out]
    for ref in refs:
        if ref.proc.poll() is None:
            ref.proc.kill()
            ref.proc.wait()


@pytest.fixture(scope="module")
def one_card(served):
    """name -> the run on the port's one-card pipelined pair: (streams,
    ``PairProbe``, the orchestrator's stats)."""
    _, api, params, _, _ = served
    out = {}
    for name, run in _runs(api.cfg.vocab_size).items():
        orch = build_disagg(api, params, config=run.config,
                            backend="pipelined", device="cpu",
                            rm=serve.TOPOLOGIES["two-enclave"](2))
        if run.inject:
            orch.decode.telemetry.inject(*run.inject)
        probe = J.PairProbe(orch)
        reqs = J.drive_pair(orch, run)
        out[name] = ([list(r.generated) for r in reqs], probe, orch.stats())
    return out


def test_both_roles_lie_on_the_pod_by_data_mesh(served):
    for r in served[3]["calm"]:
        for role in ("decode", "prefill"):
            assert (r[role]["stage"], r[role]["data"]) == (
                r["decode"]["stage"], r["decode"]["data"])
            assert r[role]["range"] == ((0, 1), (1, 4))[r[role]["stage"]]
    assert [(r["decode"]["stage"], r["decode"]["data"])
            for r in served[3]["calm"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", ["calm", "sealed", "calm_warm",
                                  "sealed_warm", "straggler", "chaos",
                                  "chaos_calm"])
def test_pair_over_ranks_equals_one_card_pair(served, one_card, name):
    ranked = served[3][name]
    streams, probe, st = one_card[name]
    n = len(_runs(served[1].cfg.vocab_size)[name].requests)
    for r in ranked:
        assert r["streams"] == streams, name
        assert r["status"] == ["done"] * n
        assert r["orch"]["handoffs"] == st["handoffs"]
        assert r["orch"]["transfers_in"] == st["transfers_in"]
        for k in ("faults", "recovery", "backpressure_events",
                  "prefill_completed", "completed", "tokens_out"):
            assert r["orch"].get(k) == st.get(k), (name, k)
        assert len(r["exports"]) == len(probe.exports) > 0
        assert len(r["transfers_in"]) == len(probe.transfers_in)
    if name == "chaos":
        assert streams == one_card["chaos_calm"][0]


def test_handoffs_are_every_prompt_not_finished_at_prefill(served):
    for name, ranks in served[3].items():
        st = ranks[0]["orch"]
        n = len(ranks[0]["streams"])
        assert st["prefill_stats"]["transfers_out"] \
            == n - st["prefill_completed"], name
        delivered = st["handoffs"]
        if name != "chaos":
            assert delivered == st["transfers_in"] \
                == st["prefill_stats"]["transfers_out"], name


def test_every_transferred_row_restored_bit_for_bit(served):
    for name, ranks in served[3].items():
        counts = J.rows_restored(ranks)
        assert all(c > 0 for c in counts), (name, counts)
        # both data ranks of a pod restore the pod's layers
        assert counts[0] == counts[1] and counts[2] == counts[3], name
        by = {(r["decode"]["stage"], r["decode"]["data"]): r for r in ranks}
        for pod in range(2):
            a, b = by[(pod, 0)], by[(pod, 1)]
            assert len(a["digests"]) > 0 and a["digests"] == b["digests"]
            assert a["cache_digest"] == b["cache_digest"]


@pytest.mark.parametrize("name", ["calm", "sealed"])
def test_the_pods_transfer_parts_are_the_one_card_payload(served, one_card,
                                                          name):
    want = one_card[name][1].first_handoff
    parts = {(r["decode"]["stage"], r["decode"]["data"]): r["first_handoff"]
             for r in served[3][name]}
    assert want["counter"] == sealing.transfer_seq(0)
    assert all(p["counter"] == want["counter"] for p in parts.values())
    assert all(p["layout"] == ((0, 1), (1, 4)) for p in parts.values())
    whole = tuple(np.concatenate([parts[(pod, 0)]["payload"][i]
                                  for pod in range(2)], axis=1)
                  for i in range(2))
    for a, b in zip(whole, want["payload"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sealing.payload_digest(whole) == want["digest"]
    assert all(p["payload"][0].shape[1] == 0
               for (_, d), p in parts.items() if d > 0)


def _space(seq: int) -> str:
    """The sequence space a page-cipher sequence number lies in."""
    if seq >= sealing.TRANSFER_SEQ_BASE:
        return "transfer"
    role = "prefill " if seq >= sealing.PREFILL_SEQ_SHIFT else ""
    seq %= sealing.PREFILL_SEQ_SHIFT
    for name, base in (("restage", sealing.RESTAGE_SEQ_BASE),
                       ("crossing", sealing.CROSSING_SEQ_BASE),
                       ("exchange", sealing.EXCHANGE_SEQ_BASE)):
        if seq >= base:
            return role + name
    return role + "swap"


def test_no_keystream_reuse_over_four_ranks_and_both_roles(served):
    spaces = set()
    for name, ranks in served[3].items():
        assert not J.keystream_reuse([r["keys"] for r in ranks]), name
        for r in ranks:
            for kind, _, ctr, *_ in r["keys"]:
                if kind == "seal_bits":
                    spaces.add(_space((ctr ^ 0xA5A50000) // 2))
    # both roles' warmups swap, cross, exchange and restage (their tours);
    # the prefill role hands every prompt over
    assert spaces == {"swap", "crossing", "exchange", "restage",
                      "prefill swap", "prefill crossing", "prefill exchange",
                      "prefill restage", "transfer"}, spaces


def test_role_spaces_are_disjoint_and_below_the_transfer_space():
    top = sealing.TRANSFER_SEQ_BASE // 8 - 1
    ends = sorted((f(0, prefill), f(top, prefill))
                  for f in (sealing.crossing_seq, sealing.restage_seq,
                            sealing.exchange_seq)
                  for prefill in (False, True))
    ends += [(0, sealing.EXCHANGE_SEQ_BASE - 1),
             (sealing.PREFILL_SEQ_SHIFT,
              sealing.PREFILL_SEQ_SHIFT + sealing.EXCHANGE_SEQ_BASE - 1)]
    ends.sort()
    assert all(a[1] < b[0] for a, b in zip(ends, ends[1:]))
    assert ends[-1][1] < sealing.TRANSFER_SEQ_BASE
    assert sealing.crossing_seq(5, prefill=True) == \
        sealing.crossing_seq(5) + sealing.PREFILL_SEQ_SHIFT
    with pytest.raises(ValueError, match="exchange"):
        sealing.exchange_seq(top + 1, prefill=True)


def test_every_rank_takes_the_same_decisions(served):
    def mine(st):
        return {k: v for k, v in st.items() if k not in PER_RANK}

    for name, ranks in served[3].items():
        r0 = ranks[0]
        assert r0["decisions"], name
        for r in ranks[1:]:
            assert r["decisions"] == r0["decisions"], name
            assert r["admission_ms"] == r0["admission_ms"], name
            for role in ("decode", "prefill"):
                assert r[role]["events"] == r0[role]["events"], (name, role)
                assert mine(r[role]["stats"]) == mine(r0[role]["stats"]), \
                    (name, role)
            assert mine(r["orch"]) == mine(r0["orch"]), name


def test_a_handoff_after_a_decode_replan_relayouts(served, one_card):
    ranks = served[3]["straggler"]
    st = ranks[0]["decode"]["stats"]
    assert st["swaps"] >= 1 and st["stage_blocks"] != (1, 3)
    assert ranks[0]["prefill"]["stats"]["stage_blocks"] == (1, 3)
    assert all(r["relayouts"] >= 1 for r in ranks)
    assert len({r["relayouts"] for r in ranks}) == 1
    assert J.rows_restored(ranks)
    assert ranks[0]["streams"] == one_card["calm"][0]


def test_tampered_transfers_fall_back_on_every_rank_at_once(served):
    ranks = served[3]["chaos"]
    st = ranks[0]["orch"]
    inj, rec = st["faults"], st["recovery"]
    assert inj["corrupt_transfer"] >= 1 and inj["truncate_transfer"] >= 1
    assert inj["drop_handoff"] >= 1 and inj["delay_handoff"] >= 1
    assert rec["unseal_fallback_transfer"] == inj["corrupt_transfer"] \
        + inj["truncate_transfer"]
    assert st["backpressure_events"] > 0
    falls = [e for e in ranks[0]["decode"]["events"]
             if e[1] == "unseal_fallback"]
    assert len(falls) == rec["unseal_fallback_transfer"]
    # a corruption flips one byte on the one rank whose part holds it;
    # the verdict is every rank's
    flagged = [d["error"] for _, _, d in falls if "digest" in d["error"]]
    assert any("rank(s) [0]" in e or "rank(s) [2]" in e for e in flagged)
    for r in ranks:
        oks = [t[3] for t in r["transfers_in"]]
        assert oks == [t[3] for t in ranks[0]["transfers_in"]]
        assert oks.count(False) == rec["unseal_fallback_transfer"]


def test_make_disagg_under_ranks_builds_rank_engines(served):
    for roles in served[4]:
        assert roles == [(True, "pipelined", "RankPagedBackend", True)] * 2


# ---------------------------------------------------------------------------
# (g) the launcher over 2 x 2 ranks
# ---------------------------------------------------------------------------
def test_serve_disagg_line_on_four_ranks(capfd):
    st = serve.main(ARGV + ["--requests", "6", "--max-new", "8", "--warmup",
                            "--verify-disagg", "--assert-no-recompile"])
    out = capfd.readouterr().out
    assert "prefill backend=pipelined decode backend=pipelined" in out
    assert "DISAGG-EXACT OK" in out and "(6 sealed handoffs)" in out
    assert "NO-RECOMPILE OK" in out and "both roles on every one of 4 " \
        "ranks" in out
    assert st["handoffs"] == 6 and st["backend"] == "pipelined"


def test_serve_chaos_over_the_pair_on_four_ranks(capfd):
    st = serve.main(ARGV + ["--requests", "8", "--max-new", "10", "--seed",
                            "7", "--chaos", "--verify-recovery"])
    out = capfd.readouterr().out
    assert "RECOVERY-EXACT OK" in out and "2 pods x 2 data" in out
    assert "the same on every one of 4 ranks" in out
    assert st["recovery"]["unseal_fallback_transfer"] >= 1


# ---------------------------------------------------------------------------
# (a) against the reference, last: its subprocesses ran meanwhile
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,ref", [("calm", "calm"), ("sealed", "sealed"),
                                      ("calm_warm", "calm_warm"),
                                      ("sealed_warm", "sealed")])
def test_pair_over_ranks_serves_the_reference_streams(served, name, ref):
    want = {**served[0][0].result(), **served[0][1].result()}
    assert want["calm"] == want["calm_warm"]
    for r in served[3][name]:
        assert r["streams"] == want[ref], (name, r["decode"]["stage"],
                                           r["decode"]["data"])


# ---------------------------------------------------------------------------
# (h) on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_warmed_pair_over_ranks_replays_bit_equal_eager():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = reduced(get_arch("llama3.2-1b"))
    pipe, _ = _streams(cfg.vocab_size)
    runs = [J.DisaggRun(EngineConfig(**dict(BASE, warmup=warm)), pipe,
                        every=1) for warm in (False, True)]
    out = spawn(J.disagg, 4, backend="gloo", device="cuda", args=(
        J.DisaggJob(cfg, runs, max_seq=128, data=D),))
    for cold, warm in out:
        for role in ("decode", "prefill"):
            assert warm[role]["post_warmup_compiles"] == 0
            assert warm[role]["stalls"] == [] and warm[role]["graphs"] > 0
        assert warm["streams"] == cold["streams"]
        a, b = cold["first_handoff"], warm["first_handoff"]
        assert a["digest"] == b["digest"]
        assert all(np.array_equal(x, y)
                   for x, y in zip(a["payload"], b["payload"]))
        assert warm["gathered"] == cold["gathered"]
        assert warm["restored"] == cold["restored"]
        assert warm["digests"] == cold["digests"]
        assert warm["launches"] == cold["launches"]
    for res in (0, 1):
        J.rows_restored([o[res] for o in out])
