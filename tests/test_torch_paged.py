"""The reference's demand = reserve paging property
(``tests/test_paged.py::test_demand_paging_property_matches_reserve_oracle``)
on the port's ``PagedLocalBackend`` (CPU, f32, no JAX).

Over hypothesis-drawn admission, EOS, shared-prefix and tight-pool
schedules, the demand-paged engine with copy-on-write prefix sharing and
swap preemption must give token streams bit-identical to the worst-case
reservation engine's, with the scheduler's and the page pool's refcount
and partition invariants audited after every step, every page but the
index-retained prefix pages free after the drain, and the null page never
written. Few examples, as the reference runs (``max_examples=6``).
"""
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro_torch.configs import get_arch, reduced
from repro_torch.models.api import build_model
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.engine import PagedLocalBackend
from repro_torch.serving.scheduler import DONE


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_arch("llama3.2-1b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32, max_seq=128)
    return cfg, api, api.init(torch.Generator().manual_seed(0))


def _engine(api, params, **overrides):
    """The reference test's engine settings."""
    kw = dict(num_slots=4, num_microbatches=2, max_seq=128,
              prompt_capacity=16, telemetry_interval=4, seal_boundary=False,
              page_size=4)
    kw.update(overrides)
    eng = ServingEngine(api, EngineConfig(**kw), params, device="cpu",
                        backend="local")
    assert isinstance(eng.backend, PagedLocalBackend)
    return eng


def _shared_prefix_workload(rng, vocab, n_req, share_ratio):
    """The reference's workload: ``share_ratio`` of the prompts extend one
    of two system prompts (COW prefix sharing), the rest are random."""
    sys_prompts = [rng.randint(0, vocab,
                               size=int(rng.randint(4, 11))).tolist()
                   for _ in range(2)]
    wl = []
    for _ in range(n_req):
        if rng.rand() < share_ratio:
            base = sys_prompts[int(rng.randint(2))]
            prompt = (base + rng.randint(
                0, vocab, size=int(rng.randint(1, 6))).tolist())[:16]
        else:
            prompt = rng.randint(0, vocab,
                                 size=int(rng.randint(2, 13))).tolist()
        eos = int(rng.randint(0, vocab)) if rng.rand() < 0.4 else None
        wl.append((prompt, int(rng.randint(1, 9)), eos,
                   int(rng.randint(0, 3))))
    return wl


def _assert_drained(eng):
    """No slot holds pages; every non-free page is an index-retained
    prefix page."""
    assert not eng.slot_pages
    eng.check_page_invariants()
    st = eng.stats()
    retained = len(eng.pool.prefix_index)
    assert st["free_pages"] + retained == st["num_pages"] - 1, \
        (st["free_pages"], retained, st["num_pages"])


def _drive_checked(eng, wl, max_steps=800):
    """Submit with per-request arrival gaps; audit the scheduler and the
    page pool after every step; drain and assert completion."""
    reqs, k, gap = [], 0, 0
    while k < len(wl) or eng.scheduler.has_work():
        if k < len(wl) and gap <= 0:
            prompt, max_new, eos, gap = wl[k]
            reqs.append(eng.submit(prompt, max_new, eos_id=eos))
            k += 1
        gap -= 1
        eng.step()
        eng.scheduler.check_invariants()
        eng.check_page_invariants()
        assert eng.steps < max_steps, "schedule failed to drain"
    assert all(r.status == DONE for r in reqs)
    _assert_drained(eng)
    return [list(r.generated) for r in reqs]


def _assert_null_page_zero(eng):
    k_pool, v_pool = eng.backend.cache["blocks"]
    assert not k_pool[:, 0].any() and not v_pool[:, 0].any()


def test_demand_paging_property_matches_reserve_oracle(setup):
    cfg, api, params = setup

    @settings(deadline=None, max_examples=6, print_blob=True,
              suppress_health_check=list(HealthCheck))
    @given(seed=st.integers(0, 2**16 - 1),
           num_pages=st.sampled_from([8, 9, 11, 14]),
           share_ratio=st.sampled_from([0.0, 0.5, 0.9]))
    def prop(seed, num_pages, share_ratio):
        rng = np.random.RandomState(seed)
        wl = _shared_prefix_workload(rng, cfg.vocab_size,
                                     int(rng.randint(4, 10)), share_ratio)
        oracle_eng = _engine(api, params, request_capacity=24,
                             page_policy="reserve")
        oracle = _drive_checked(oracle_eng, wl)
        assert oracle_eng.stats()["cow_hits"] == 0
        eng = _engine(api, params, request_capacity=24,
                      num_pages=num_pages, page_policy="demand")
        got = _drive_checked(eng, wl)
        assert got == oracle
        _assert_null_page_zero(eng)

    prop()


@pytest.mark.parametrize("seed,num_pages,share_ratio", [(1, 8, 0.9),
                                                         (3, 9, 0.5)])
def test_demand_equals_reserve_under_preemption_and_cow(setup, seed,
                                                        num_pages,
                                                        share_ratio):
    """Two fixed schedules of the property in which the tight pool
    preempts and shared prefixes hit, so both paths are exercised."""
    cfg, api, params = setup
    rng = np.random.RandomState(seed)
    wl = _shared_prefix_workload(rng, cfg.vocab_size, 9, share_ratio)
    oracle = _drive_checked(_engine(api, params, request_capacity=24,
                                    page_policy="reserve"), wl)
    eng = _engine(api, params, request_capacity=24, num_pages=num_pages,
                  page_policy="demand")
    assert _drive_checked(eng, wl) == oracle
    _assert_null_page_zero(eng)
    st = eng.stats()
    assert st["preemptions"] > 0 and st["cow_hits"] > 0, st
    assert st["swap_outs"] == st["preemptions"], st
