"""The cipher kernels' key and counter as device operands, against the JAX
package.

The Pallas kernels read their key and counter from device memory
(``key_ref[0]``, ``ctr_ref[0]`` in ``repro/kernels/seal.py``); the port's
kernels now do too, and its wrappers and plain versions take each as a
Python int or a one-element integer tensor. On the CPU, for each of
``seal``, ``unseal``, ``seal_bits`` and ``unseal_bits``: the plain version
under a tensor key and counter (int64, and the int32 bit pattern of the
same word) gives the bytes it gives under the ints, and the bytes of the
reference's Pallas kernel (``interpret=True``, as tests/test_kernels.py
runs it) and of its ``ref.py``, for keys {0, 1, 0xC0FFEE + 7, 0xFFFFFFFF}
and counters that include swap counters with bit 31 set. The seal's input
is integers in [-127, 127] with each row's absmax 127, so its scale is 1
and no quantization tie can make the packages differ: the cipher bytes
must be equal. The swap and leaf counters built from tensors equal the
reference's, and a key on another device than the data raises.

On a card (marker ``cuda``): the kernels give the same bytes under a
device key as under the int, and a CUDA graph that captured them ciphers
under whatever key its buffers hold at each replay.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops

KEYS = [0, 1, 0xC0FFEE + 7, 0xFFFFFFFF]
CTRS = [0, 65537 * 3, sealing._swap_counter(7, 1),
        sealing._swap_counter(0x3FFFFFFF, 0)]
OPS = ["seal", "unseal", "seal_bits", "unseal_bits"]
SHAPE = (8, 96)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.enclave import sealing as jsealing
    from repro.kernels import ref as jref
    from repro.kernels.seal import (seal_bits_pallas, seal_pallas,
                                    unseal_bits_pallas, unseal_pallas)
    pallas = types.SimpleNamespace(
        seal_pallas=seal_pallas, unseal_pallas=unseal_pallas,
        seal_bits_pallas=seal_bits_pallas,
        unseal_bits_pallas=unseal_bits_pallas)
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jref, seal=pallas,
                                 sealing=jsealing)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _as_int32(v: int) -> torch.Tensor:
    """The uint32 word ``v`` as the bit pattern of a one-element int32."""
    return torch.tensor([v - (1 << 32) if v >> 31 else v], dtype=torch.int32)


def _inputs(seed=0):
    """Rows of integers in [-127, 127], each with absmax 127 (scale 1, so
    the quantization is exact in both packages), in f32; and float pages
    for the lossless cipher."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, size=SHAPE).astype(np.float32)
    q[:, 0] = np.where(rng.rand(SHAPE[0]) < 0.5, 127.0, -127.0)
    pages = rng.randn(*SHAPE).astype(np.float32)
    return q, pages


def _port(op, x, key, ctr):
    """The port's op on the CPU (its plain version) -> numpy bytes."""
    if op == "seal":
        c, s = ops.seal(torch.from_numpy(x), key, ctr)
        return c.numpy(), s.numpy()
    if op == "unseal":
        c, s = x
        return ops.unseal(torch.from_numpy(c), torch.from_numpy(s), key, ctr,
                          torch.float32).numpy()
    if op == "seal_bits":
        return ops.seal_bits(torch.from_numpy(x), key, ctr).numpy().view(
            np.uint32)
    return ops.unseal_bits(torch.from_numpy(x.view(np.int32)), key, ctr,
                           torch.float32).numpy()


def _reference(jx, op, x, key, ctr):
    """(Pallas kernel in interpret mode, JAX oracle) outputs as numpy."""
    jnp, jk, jc = jx.jnp, jx.jnp.uint32(key), jx.jnp.uint32(ctr)
    if op == "seal":
        xs = jnp.asarray(x)
        return (jx.seal.seal_pallas(xs, jk, jc, interpret=True),
                jx.ref.seal_ref(xs, jk, jc))
    if op == "unseal":
        c, s = (jnp.asarray(a) for a in x)
        return (jx.seal.unseal_pallas(c, s, jk, jc, out_dtype=jnp.float32,
                                      interpret=True),
                jx.ref.unseal_ref(c, s, jk, jc, jnp.float32))
    if op == "seal_bits":
        xs = jnp.asarray(x)
        return (jx.seal.seal_bits_pallas(xs, jk, jc, interpret=True),
                jx.ref.seal_bits_ref(xs, jk, jc))
    c = jnp.asarray(x.view(np.uint32))
    return (jx.seal.unseal_bits_pallas(c, jk, jc, out_dtype=jnp.float32,
                                       interpret=True),
            jx.ref.unseal_bits_ref(c, jk, jc, jnp.float32))


def _bytes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o).tobytes() for o in outs]


@pytest.mark.parametrize("ctr", CTRS)
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("op", OPS)
def test_tensor_key_gives_int_key_and_reference_bytes(jx, op, key, ctr):
    q, pages = _inputs(seed=key % 97 + ctr % 89)
    if op == "seal":
        x = q
    elif op == "unseal":
        # a cipher text and scales from the reference's oracle
        c, s = jx.ref.seal_ref(jx.jnp.asarray(q), jx.jnp.uint32(key),
                               jx.jnp.uint32(ctr))
        x = (np.array(c), np.array(s))
    elif op == "seal_bits":
        x = pages
    else:
        x = np.array(jx.ref.seal_bits_ref(
            jx.jnp.asarray(pages), jx.jnp.uint32(key), jx.jnp.uint32(ctr)))
        x = x.view(np.float32)
    want = _bytes(_port(op, x, key, ctr))
    for k, c in ((torch.tensor([key]), torch.tensor([ctr])),
                 (torch.tensor(key), torch.tensor(ctr)),
                 (_as_int32(key), _as_int32(ctr))):
        assert _bytes(_port(op, x, k, c)) == want, (k.dtype, k.shape)
    for name, out in zip(("pallas", "oracle"),
                         _reference(jx, op, x, key, ctr)):
        assert _bytes(out) == want, name


@pytest.mark.parametrize("seq,part", [(0, 0), (7, 1), (0x3FFFFFFF, 1),
                                      (sealing.TRANSFER_SEQ_BASE + 5, 0)])
def test_tensor_counters_equal_the_reference(jx, seq, part):
    want = int(jx.sealing._swap_counter(seq, part))
    got = sealing._swap_counter(torch.tensor([seq]), part)
    assert isinstance(got, torch.Tensor) and int(got) == want
    assert sealing._swap_counter(seq, part) == want
    for step in (seq, seq + 1):
        assert int(sealing._leaf_counter(torch.tensor(step), part)) == \
            int(jx.sealing._leaf_counter(step, part))
    assert sealing.leaf_counters(6, "cpu").tolist() == [
        int(jx.sealing._leaf_counter(t, 0)) for t in range(6)]


def test_key_on_another_device_or_not_one_integer_raises():
    x = torch.zeros(2, 8)
    with pytest.raises(TypeError, match="one integer"):
        ops.seal(x, torch.tensor([1, 2]), 0)
    with pytest.raises(TypeError, match="one integer"):
        ops.seal_bits(x, 1, torch.tensor([1.0]))
    meta = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.seal_bits(x, meta, 0)
    with pytest.raises(ValueError, match="meta"):
        ops.unseal(torch.zeros(2, 8, dtype=torch.uint8), torch.ones(2, 1),
                   0, meta, torch.float32)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
def test_kernels_under_device_keys_give_int_key_bytes(cuda, key):
    q, pages = _inputs(seed=3)
    x, p = torch.from_numpy(q).to(cuda), torch.from_numpy(pages).to(cuda)
    for ctr in CTRS:
        kt = torch.tensor([key], device=cuda)
        ct = _as_int32(ctr).to(cuda)
        c, s = ops.seal(x, kt, ct)
        c0, s0 = ops.seal(x, key, ctr)
        assert torch.equal(c, c0) and torch.equal(s, s0)
        assert torch.equal(ops.unseal(c, s, kt, ct, torch.float32),
                           ops.unseal(c, s, key, ctr, torch.float32))
        b = ops.seal_bits(p, kt, ct)
        assert torch.equal(b, ops.seal_bits(p, key, ctr))
        assert torch.equal(ops.unseal_bits(b, kt, ct, torch.float32), p)
        torch.cuda.synchronize()
    with pytest.raises(ValueError, match="cpu"):
        ops.seal_bits(p, torch.tensor([key]), 0)


@pytest.mark.cuda
def test_captured_ciphers_read_the_key_at_replay(cuda):
    """Captured once, replayed under two keys written into the same
    buffers: each replay equals the plain version under its key, and the
    two replays' cipher texts differ."""
    q, pages = _inputs(seed=4)
    x = torch.from_numpy(q).to(cuda).to(torch.bfloat16)
    p = torch.from_numpy(pages).to(cuda).to(torch.bfloat16)
    kt = torch.zeros(1, dtype=torch.int64, device=cuda)
    ct = torch.full((1,), CTRS[2], dtype=torch.int64, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):         # libraries loaded, kernels run
        ops.unseal(*ops.seal(x, kt, ct), kt, ct, torch.bfloat16)
        ops.seal_bits(p, kt, ct)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        c, s = ops.seal(x, kt, ct)
        opened = ops.unseal(c, s, kt, ct, torch.bfloat16)
        b = ops.seal_bits(p, kt, ct)
    seen = []
    for key in (0xC0FFEE, 0xFFFFFFFF):
        kt.fill_(key)
        graph.replay()
        torch.cuda.synchronize()
        wc, ws = ops.seal(x, key, CTRS[2])
        assert torch.equal(c, wc) and torch.equal(s, ws)
        assert torch.equal(opened, ops.unseal(wc, ws, key, CTRS[2],
                                              torch.bfloat16))
        assert torch.equal(b, ops.seal_bits(p, key, CTRS[2]))
        seen.append((c.clone(), b.clone()))
    assert not torch.equal(seen[0][0], seen[1][0])
    assert not torch.equal(seen[0][1], seen[1][1])
