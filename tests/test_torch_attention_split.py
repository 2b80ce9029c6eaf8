"""The split-and-merge rule of the paged decode kernel, on the CPU.

On the card the paged decode kernel cuts a row's block table into
``ops._page_splits`` splits (``ops._page_part``), one block each. Each
split writes (m, l, acc) in f32, and the last split to finish merges them
in split order: M = the largest m over splits that saw keys,
L = sum l e^(m - M), out = sum acc e^(m - M) / max(L, 1e-30). A split
whose pages start at or past the row's length writes m = -inf, l = 0 and
is skipped; a row with seq_len 0 has only such splits and writes zeros.

The kernel itself runs only on the card; this file computes each split's
(m, l, acc) with torch as the kernel defines it — positions past the row's
length at -1e30 with zero weight, the running max starting at -1e30 — for
the plan the wrapper yields at the serving path's shapes and at the test
shapes (and for one split and for two-page splits), merges them by the
kernel's rule, and holds the result against the port's plain version and
the JAX package's reference, f32 within atol = rtol = 3e-5.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = dict(atol=3e-5, rtol=3e-5)
SMS = 132                                   # an H100 SXM's SMs
NEG = -1e30
# paged: B, KVH, rep, D, Pg, MP, N, seq_lens (None: random, >= 1)
PAGED = [(8, 8, 4, 64, 16, 10, 30, (160, 0, 1, 17, 100, 128, 159, 64)),
         (8, 8, 4, 64, 16, 34, 116, (544, 0, 1, 16, 17, 300, 543, 129)),
         (3, 2, 4, 16, 4, 5, 16, None), (2, 4, 1, 32, 8, 3, 7, None),
         (4, 2, 2, 128, 8, 4, 17, (0, 32, 1, 9))]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: small tensors, and parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package as the oracle (absent on hosts without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jref)


def merge(parts):
    """The kernel's merge, in split order; ``None`` is a split with no keys
    (m = -inf, l = 0), which it skips. Returns (out, M, L)."""
    seen = [p for p in parts if p is not None]
    if not seen:
        return None
    mm = torch.stack([m for m, _, _ in seen]).amax(0)
    ll = sum(l * torch.exp(m - mm) for m, l, _ in seen)
    acc = sum(a * torch.exp(m - mm)[..., None] for m, _, a in seen)
    return acc / ll.clamp_min(1e-30)[..., None], mm, ll


def _paged_inputs(B, KVH, rep, D, Pg, MP, N, seq_lens, seed=5):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, KVH * rep, D).astype(np.float32)
    kp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    vp = rng.randn(N, KVH, Pg, D).astype(np.float32)
    bt = rng.randint(1, N, size=(B, MP)).astype(np.int32)
    sl = (rng.randint(1, MP * Pg + 1, size=B) if seq_lens is None
          else np.array(seq_lens)).astype(np.int32)
    for b in range(B):
        bt[b, -(-int(sl[b]) // Pg):] = 0          # null tail past the length
    return q, kp, vp, bt, sl


def paged_parts(q, kp, vp, bt, sl, splits, b):
    """Every split's (m [KVH, rep], l, acc [KVH, rep, D]) of row b, or None
    for a split whose pages start at or past the row's length."""
    _, H, D = q.shape
    N, KVH, Pg, _ = kp.shape
    MP = bt.shape[1]
    qg = q[b].reshape(KVH, H // KVH, D) / math.sqrt(D)
    parts = []
    for split in range(splits):
        p0, p1 = ops._page_part(split, splits, MP, int(sl[b]), Pg)
        if p0 >= p1:
            parts.append(None)
            continue
        pid = bt[b, p0:p1].long()
        pid = torch.where((pid < 0) | (pid >= N), torch.zeros_like(pid), pid)
        keys = kp[pid].permute(1, 0, 2, 3).reshape(KVH, -1, D)
        vals = vp[pid].permute(1, 0, 2, 3).reshape(KVH, -1, D)
        tok = torch.arange(p0 * Pg, p1 * Pg)
        valid = (tok < int(sl[b]))[None, None, :]
        s = qg @ keys.transpose(1, 2)
        # past the row's length: -1e30 and zero weight, as the kernel
        s = torch.where(valid, s, torch.full_like(s, NEG))
        m = s.amax(-1).clamp_min(NEG)
        p = torch.where(valid, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        parts.append((m, p.sum(-1), p @ vals))
    return parts


def paged_split(q, kp, vp, bt, sl, splits):
    out = torch.zeros_like(q)
    for b in range(q.shape[0]):
        merged = merge(paged_parts(q, kp, vp, bt, sl, splits, b))
        if merged is not None:                    # idle rows stay zero
            out[b] = merged[0].reshape(q.shape[1], q.shape[2])
    return out


# how many splits: the wrapper's plan on an H100, one, two pages each
SPLITS = {"plan": lambda B, KVH, MP: ops._page_splits(B, KVH, MP, SMS),
          "one": lambda B, KVH, MP: 1,
          "two_pages": lambda B, KVH, MP: max(1, MP // 2)}


@pytest.mark.parametrize("how", sorted(SPLITS))
@pytest.mark.parametrize("case", PAGED, ids=[str(c[:6]) for c in PAGED])
def test_paged_split_merge_matches_both_references(jx, case, how):
    B, KVH, rep, D, Pg, MP, N, seq_lens = case
    arrays = _paged_inputs(B, KVH, rep, D, Pg, MP, N, seq_lens)
    q, kp, vp, bt, sl = (torch.from_numpy(a) for a in arrays)
    want = ref.paged_attention_ref(q, kp, vp, bt, sl)
    jwant = np.asarray(jx.ref.paged_attention_ref(
        *(jx.jnp.asarray(a) for a in arrays)))
    live = sl > 0
    got = paged_split(q, kp, vp, bt, sl, SPLITS[how](B, KVH, MP))
    assert not got[~live].any(), "idle rows are zero"
    torch.testing.assert_close(got[live], want[live], **TOL)
    np.testing.assert_allclose(got[live].numpy(), jwant[live.numpy()], **TOL)


def test_paged_plans_and_empty_splits():
    """At 8 rows x 8 KV heads the plan splits each row's table into parts
    of two pages (5 of the 10-page table, 17 of the 34-page one); a row of
    17 tokens (2 pages) leaves splits 1..16 of the 34-page table empty, and
    an idle row (seq_len 0) leaves every split empty."""
    assert ops._page_splits(8, 8, 10, SMS) == 5
    assert ops._page_splits(8, 8, 34, SMS) == 17
    assert ops._page_splits(64, 8, 34, SMS) == 3          # 512 pairs
    assert ops._page_splits(1, 1, 3, SMS) == 1            # under 2 pages
    assert ops._page_splits(1, 1, 512, SMS) == 32         # one lane each
    assert [ops._page_part(s, 17, 34, 17, 16) for s in range(3)] == \
        [(0, 2), (2, 2), (4, 4)]
    assert ops._page_part(16, 17, 34, 544, 16) == (32, 34)
    assert all(ops._page_part(s, 17, 34, 0, 16)[0] >=
               ops._page_part(s, 17, 34, 0, 16)[1] for s in range(17))
    B, KVH, rep, D, Pg, MP, N, seq_lens = PAGED[1]
    q, kp, vp, bt, sl = (torch.from_numpy(a) for a in _paged_inputs(
        B, KVH, rep, D, Pg, MP, N, seq_lens))
    assert all(p is None for p in paged_parts(q, kp, vp, bt, sl, 17, 1))
    parts = paged_parts(q, kp, vp, bt, sl, 17, 3)         # 16 tokens
    assert parts[0] is not None and parts[1:] == [None] * 16
