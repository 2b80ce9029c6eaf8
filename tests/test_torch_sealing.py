"""Page sealing of the PyTorch port against the JAX package.

The same pages, key and swap sequence must give the same cipher bytes and
the same ``payload_digest`` in both packages; a payload sealed by either
unseals under the other to the same bits; the engine backends lay pages
out as the same ``[MP, L*KVH*Pg*D]`` rows, so a swap payload gathered by
one restores under the other. On a card (marker ``cuda``) the CUDA cipher
gives the CPU plain version's bytes. The attestation stub's measurement
is the reference's, byte for byte, and ``verify`` fails on any change.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops

SEQS = [(0, 0), (0, 1), (41, 0), (0x3FFFFFFF, 1), (0x40000000 + 5, 0)]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.enclave import sealing as jsealing
    return types.SimpleNamespace(jax=jax, jnp=jnp, sealing=jsealing)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pages(dtype, shape=(5, 4 * 2 * 4 * 16), seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x, torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("seq,part", SEQS)
def test_swap_counter_matches_reference(jx, seq, part):
    want = int(jx.sealing._swap_counter(seq, part))
    assert sealing._swap_counter(seq, part) == want
    assert sealing.TRANSFER_SEQ_BASE == jx.sealing.TRANSFER_SEQ_BASE
    assert sealing.transfer_seq(7) == jx.sealing.transfer_seq(7)
    with pytest.raises(ValueError):
        sealing.transfer_seq(sealing.TRANSFER_SEQ_BASE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [0, 3, sealing.TRANSFER_SEQ_BASE + 9])
def test_seal_pages_same_bytes_and_digest_both_ways(jx, dtype, seq):
    jdt = getattr(jx.jnp, dtype)
    xk, tk = _pages(dtype, seed=1)
    xv, tv = _pages(dtype, seed=2)
    key = 0xC0FFEE
    jpay = tuple(np.asarray(jx.sealing.seal_pages(
        jx.jnp.asarray(x).astype(jdt), jx.jnp.uint32(key), seq, part=p))
        for p, x in ((0, xk), (1, xv)))
    tpay = tuple(sealing.cipher_to_host(sealing.seal_pages(t, key, seq,
                                                           part=p))
                 for p, t in ((0, tk), (1, tv)))
    for a, b in zip(jpay, tpay):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sealing.payload_digest(tpay) == jx.sealing.payload_digest(jpay)
    sealing.verify_payload(tpay, jx.sealing.payload_digest(jpay))
    jx.sealing.verify_payload(jpay, sealing.payload_digest(tpay))
    # a JAX-sealed payload unseals under the port ...
    back = sealing.unseal_pages(sealing.cipher_to_device(jpay[0], "cpu"),
                                key, seq, getattr(torch, dtype), part=0)
    idt = torch.int32 if dtype == "float32" else torch.int16
    assert torch.equal(back.view(idt), tk.view(idt))
    # ... and a port-sealed one under JAX
    jback = np.asarray(jx.sealing.unseal_pages(
        jx.jnp.asarray(tpay[1]), jx.jnp.uint32(key), seq, jdt, part=1))
    assert np.array_equal(jback.view(tpay[1].dtype),
                          np.asarray(jx.jnp.asarray(xv).astype(jdt)
                                     ).view(tpay[1].dtype))


def test_integrity_tags_reject_tampering_like_the_reference(jx):
    _, t = _pages("bfloat16")
    payload = (sealing.cipher_to_host(sealing.seal_pages(t, 1, 2, part=0)),
               sealing.cipher_to_host(sealing.seal_pages(t, 1, 2, part=1)))
    digest = sealing.payload_digest(payload)
    sealing.verify_payload(payload, digest)
    sealing.verify_payload(payload, None)            # untagged: trivially ok
    flipped = (payload[0].copy(), payload[1])
    flipped[0].reshape(-1)[3] ^= 1
    truncated = (payload[0][:-1], payload[1])
    for bad, exc in ((flipped, "digest"), (truncated, "structure")):
        with pytest.raises(sealing.SealIntegrityError, match=exc):
            sealing.verify_payload(bad, digest)
        with pytest.raises(jx.sealing.SealIntegrityError, match=exc):
            jx.sealing.verify_payload(bad, digest)
    with pytest.raises(sealing.SealIntegrityError):
        sealing.verify_structure(truncated, digest)


def test_backend_page_rows_cross_packages(jx):
    """The engines' gather layout is the reference's: on the same pools the
    port's ``gather_pages`` gives the JAX backend's cipher bytes, and a
    JAX-gathered payload scattered by the port restores the same pages."""
    import jax.numpy as jnp

    from repro.configs import get_arch as jget
    from repro.configs import reduced as jreduced
    from repro.models.api import build_model as jbuild
    from repro.serving.engine import EngineConfig as JCfg
    from repro.serving.engine import PagedLocalBackend as JBackend
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.api import build_model
    from repro_torch.serving import EngineConfig, PagedLocalBackend
    N, MP = 10, 4
    japi = jbuild(jreduced(jget("llama3.2-1b")))
    tapi = build_model(reduced(get_arch("llama3.2-1b")), device="cpu")
    jbe = JBackend(japi, None, JCfg(num_slots=2, page_size=4), (4,), N, MP)
    tbe = PagedLocalBackend(tapi, None, EngineConfig(num_slots=2,
                                                     page_size=4), N, MP)
    rng = np.random.RandomState(3)
    shape = tuple(tbe.cache["blocks"][0].shape)          # [L, N, KVH, Pg, D]
    pools = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    for p in pools:
        p[:, 0] = 0
    jbe.cache["blocks"] = tuple(jnp.asarray(p).astype(jnp.bfloat16)
                                for p in pools)
    tbe.cache["blocks"] = tuple(torch.from_numpy(p).to(torch.bfloat16)
                                for p in pools)
    pages = np.array([3, 0, 7, 1], np.int32)
    jck, jcv = jbe.gather_pages(jnp.asarray(pages), jnp.uint32(0xC0FFEE),
                                jnp.uint32(5))
    tck, tcv = tbe.gather_pages(pages, 0xC0FFEE, 5)
    jpay = (np.asarray(jck), np.asarray(jcv))
    tpay = (sealing.cipher_to_host(tck), sealing.cipher_to_host(tcv))
    assert all(np.array_equal(a, b) for a, b in zip(jpay, tpay))
    assert sealing.payload_digest(tpay) == jx.sealing.payload_digest(jpay)
    # JAX payload -> port scatter into fresh pages 2, 4, 5 (row 1 skipped)
    before = [p.clone() for p in tbe.cache["blocks"]]
    dst = np.array([2, N, 4, 5], np.int32)
    tbe.scatter_pages(*(sealing.cipher_to_device(a, "cpu") for a in jpay),
                      dst, 0xC0FFEE, 5)
    for pool, old in zip(tbe.cache["blocks"], before):
        for src_pg, dst_pg in ((3, 2), (7, 4), (1, 5)):
            assert torch.equal(pool[:, dst_pg].view(torch.int16),
                               old[:, src_pg].view(torch.int16))
        for untouched in (0, 1, 3, 6, 7, 8, 9):
            assert torch.equal(pool[:, untouched], old[:, untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seal_pages_on_card_gives_cpu_bytes(cuda, dtype):
    _, t = _pages(dtype, shape=(10, 131072))
    launches = ops.LAUNCHES["seal_bits"]
    on_card = sealing.cipher_to_host(sealing.seal_pages(t.to(cuda), 9, 4,
                                                        part=1))
    assert ops.LAUNCHES["seal_bits"] == launches + 1
    on_cpu = sealing.cipher_to_host(sealing.seal_pages(t, 9, 4, part=1))
    assert np.array_equal(on_card, on_cpu)
    back = sealing.unseal_pages(sealing.cipher_to_device(on_card, cuda), 9,
                                4, t.dtype, part=1)
    assert torch.equal(back.cpu().view(torch.int16 if dtype == "bfloat16"
                                       else torch.int32),
                       t.view(torch.int16 if dtype == "bfloat16"
                              else torch.int32))


@pytest.mark.parametrize("code,params", [
    (b"code", b"params"), (b"", b""), (b"\x00" * 7, bytes(range(256))),
    (b"serdab-enclave-v1", bytes(32))])
def test_attestation_measure_equals_reference(jx, code, params):
    m = sealing.measure(code, params)
    assert m == jx.sealing.measure(code, params) and len(m) == 32
    assert sealing.verify(m, jx.sealing.measure(code, params))
    assert sealing.verify(m, m) == jx.sealing.verify(m, m)


def test_attestation_stub_rejects_changed_code_or_params(jx):
    """The reference's ``test_attestation_stub`` on the port, and a
    measurement over a sealed payload's digest that one flipped byte
    breaks."""
    m = sealing.measure(b"code", b"params")
    assert sealing.verify(m, sealing.measure(b"code", b"params"))
    assert not sealing.verify(m, sealing.measure(b"code2", b"params"))
    assert not sealing.verify(m, sealing.measure(b"code", b"params2"))
    x, _ = _pages("float32")
    payload = (x.view(np.uint32), np.arange(5, dtype=np.int32))
    _, d = sealing.payload_digest(payload)
    assert d == jx.sealing.payload_digest(payload)[1]
    good = sealing.measure(b"code", d)
    bad = x.copy()
    bad.view(np.uint8).reshape(-1)[17] ^= 1
    _, d2 = sealing.payload_digest((bad.view(np.uint32), payload[1]))
    assert not sealing.verify(sealing.measure(b"code", d2), good)
