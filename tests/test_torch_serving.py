"""Serving-engine properties inside the PyTorch port (CPU, no JAX).

Parameters come from a seeded ``torch.Generator``. Swap resume, recompute
resume and an undisturbed run give the same greedy streams over several
workloads and pool sizes, with the page pool's refcount invariants and
the all-zero null page audited after every step. Each swap-in restores
the gathered pages bit for bit, a tampered swap payload falls back to
recompute without changing the stream, and options of later slices are
refused by name. ``tests/test_torch_engine.py`` holds the same engine
against the JAX package's.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.models.api import build_model
from repro_torch.serving import (EngineConfig, FaultConfig, PagePool,
                                 ServingEngine)
from repro_torch.serving.scheduler import DONE, SWAPPED

BASE = dict(num_slots=4, prompt_capacity=16, page_size=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread runs them faster and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port():
    tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu",
                       dtype=torch.float32)
    return tapi, tapi.init(torch.Generator().manual_seed(0))


def _torch_engine(tapi, tparams, **kw):
    return ServingEngine(tapi, EngineConfig(**{**BASE, **kw}), tparams,
                         device="cpu")


def _workload(seed, n, shared_ratio=0.0, max_new=(3, 10)):
    rng = np.random.RandomState(seed)
    sys_prompt = rng.randint(0, 512, size=8).tolist()
    wl = []
    for _ in range(n):
        if rng.rand() < shared_ratio:
            tail = rng.randint(0, 512, size=rng.randint(0, 9)).tolist()
            prompt = sys_prompt + tail
        else:
            prompt = rng.randint(0, 512, size=rng.randint(2, 17)).tolist()
        wl.append((prompt, int(rng.randint(*max_new)), int(rng.randint(0, 3))))
    return wl


def _drive(eng, wl, audit=None, max_steps=600):
    """Submit with per-request arrival gaps and drain; ``audit`` runs after
    every step."""
    reqs, k, gap = [], 0, 0
    while k < len(wl) or eng.scheduler.has_work():
        if k < len(wl) and gap <= 0:
            prompt, max_new, gap = wl[k]
            reqs.append(eng.submit(prompt, max_new))
            k += 1
        else:
            gap -= 1
        eng.step()
        if audit is not None:
            audit(eng)
        assert eng.steps < max_steps, "schedule failed to drain"
    assert all(r.status == DONE for r in reqs)
    return [list(r.generated) for r in reqs]


def _audit(eng):
    eng.scheduler.check_invariants()
    eng.check_page_invariants()
    kp, vp = eng.backend.cache["blocks"]
    assert not kp[:, 0].any() and not vp[:, 0].any(), "null page written"


@pytest.mark.parametrize("seed,num_pages", [(3, 12), (9, 9), (7, 10),
                                             (8, 9)])
def test_swap_equals_recompute_equals_undisturbed(port, seed, num_pages):
    tapi, tparams = port
    wl = _workload(seed, 10, shared_ratio=0.5)
    swap = _torch_engine(tapi, tparams, num_pages=num_pages)
    rec = _torch_engine(tapi, tparams, num_pages=num_pages,
                        preempt_policy="recompute")
    calm = _torch_engine(tapi, tparams)
    a = _drive(swap, wl, audit=_audit)
    b = _drive(rec, wl, audit=_audit)
    # undisturbed: everything submitted up front and drained by run()
    reqs = [calm.submit(prompt, max_new) for prompt, max_new, _ in wl]
    calm.run()
    c = [list(r.generated) for r in reqs]
    assert a == b == c
    assert swap.stats()["swap_ins"] > 0
    assert rec.stats()["preemptions"] > 0 and rec.stats()["swap_outs"] == 0
    assert calm.stats()["preemptions"] == 0


def test_swap_restores_gathered_pages_bit_for_bit(port):
    """Record each swap-out's plaintext rows; after the matching swap-in
    the freshly allocated pages hold exactly those bits."""
    tapi, tparams = port
    eng = _torch_engine(tapi, tparams, num_pages=12)
    be = eng.backend
    gathered, checked = {}, []
    orig_gather, orig_scatter = be.gather_pages, be.scatter_pages

    def gather(pages, key, ctr):
        pg = torch.from_numpy(pages.astype(np.int64))
        gathered[ctr] = [pool[:, pg].clone() for pool in be.cache["blocks"]]
        return orig_gather(pages, key, ctr)

    def scatter(ck, cv, pages, key, ctr):
        orig_scatter(ck, cv, pages, key, ctr)
        for i, pg in enumerate(pages):
            if pg < be.num_pages:
                for pool, rows in zip(be.cache["blocks"], gathered[ctr]):
                    assert torch.equal(pool[:, pg], rows[:, i])
                checked.append(pg)

    be.gather_pages, be.scatter_pages = gather, scatter
    _drive(eng, _workload(4, 10), audit=_audit)
    assert checked, "no swap-in happened"


def test_tampered_swap_payload_falls_back_to_recompute(port):
    """A flipped bit in a host payload fails the digest at swap-in; the
    request re-prefills instead and its stream is unchanged."""
    tapi, tparams = port
    wl = _workload(0, 10)
    calm = _drive(_torch_engine(tapi, tparams), wl)
    eng = _torch_engine(tapi, tparams, num_pages=12)
    orig = eng._swap_in

    def tamper_then_swap_in(slot, req, t0):
        man = eng.pool.swap_manifest[req.rid]
        ck = man.payload[0].copy()
        ck.reshape(-1)[0] ^= 1
        man.payload = (ck, man.payload[1])
        return orig(slot, req, t0)

    eng._swap_in = tamper_then_swap_in
    assert _drive(eng, wl, audit=_audit) == calm
    assert any(e.kind == "unseal_fallback" for e in eng.events)


def test_later_slice_options_raise_by_name(port):
    tapi, tparams = port
    for kw in (dict(kv_layout="timeline"), dict(batched_prefill=False)):
        with pytest.raises(NotImplementedError):
            _torch_engine(tapi, tparams, **kw)
    # sampling is ported: temperature, top_k and sample_seed reach the
    # sampler, which the engine runs under graph management
    eng = _torch_engine(tapi, tparams, temperature=0.7, top_k=5,
                        sample_seed=9)
    s = eng.sampler
    assert not s.greedy and (s.temperature, s.top_k, s.seed) == (0.7, 5, 9)
    assert "sample" in eng.aot.fns
    # the fault plane is ported: anything but None or a FaultConfig is
    # refused by name, and a FaultConfig arms the plane
    with pytest.raises(TypeError, match="faults"):
        _torch_engine(tapi, tparams, faults=object())
    eng = _torch_engine(tapi, tparams, faults=FaultConfig())
    assert eng.faults is not None and eng.stats()["faults_pending"] == {
        "death": False, "stall": False, "storm": False}
    # disaggregated prefill/decode is ported: both roles construct
    for role in ("prefill", "decode"):
        assert _torch_engine(tapi, tparams, disagg_role=role).stats()[
            "disagg_role"] == role
    # warmup is ported for both backends (the seals read their key from
    # device memory), so the pipelined backend warms up by name too
    eng = ServingEngine(tapi, EngineConfig(**BASE, warmup=True), tparams,
                        device="cpu", backend="pipelined")
    assert eng.stats()["warmed"] and eng.stats()["backend"] == "pipelined"


def test_submit_rejects_requests_the_pool_cannot_serve(port):
    tapi, tparams = port
    eng = _torch_engine(tapi, tparams, num_pages=6)
    with pytest.raises(ValueError):
        eng.submit(list(range(16)), 10)          # 7 pages + headroom > 5
    with pytest.raises(ValueError):
        eng.submit(list(range(17)), 1)           # over prompt_capacity


def test_page_pool_refcounts_cow_and_swap_ledger():
    p = PagePool(num_pages=9, page_size=4)
    a = p.alloc_one()
    p.register_prefix((1, 2, 3, 4), a)
    assert p.refcount[a] == 2 and p.lookup_prefix((1, 2, 3, 4)) == a
    p.release([a, a])                   # table refs gone: index-only page
    assert p.evictable_pages == 1
    pages = [p.alloc_one() for _ in range(8)]     # the 8th evicts `a`
    assert sorted(pages) == list(range(1, 9)) and p.evictions == 1
    assert p.alloc_one() is None
    p.check_invariants({0: pages})
    man = p.swap_out(7, [("sealed", 0)], (np.zeros((1, 4), np.uint32),),
                     n_tokens=3, counter=0)
    assert p.has_swap(7) and man.sealed_pages == 1 and p.swapped_pages == 1
    assert p.swap_in(7) is man and not p.has_swap(7)
    assert p.stats()["swap_outs"] == 1 and p.stats()["swap_ins"] == 1
    assert SWAPPED == "swapped"
