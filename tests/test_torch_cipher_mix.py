"""The cipher kernels' rewritten arithmetic and launch plans, on the CPU.

The CUDA kernels ``csrc/seal_bits.cu`` (page cipher) and ``csrc/seal_q8.cu``
(quantizing seal) evaluate the keystream in the form of
``csrc/keystream.cuh``: ``a = idx0 * M1 + j * M1`` per lane j, the key
folded as ``a ^ (a >> 16) ^ K'`` with ``K' = K ^ (K >> 16)``, the last
xorshift folded into the data XOR (or dropped where only the top byte is
used), and lanes packed into words by ``__byte_perm``. No CPU runs that
code, so this file transcribes the same instruction sequence in numpy
uint32 arithmetic, here and not in the port, and holds it bit for bit
against the JAX package's ``repro.kernels.seal.keystream_u32`` and the
port's ``repro_torch.kernels.seal.keystream_u32``: for every lane of a
bf16 and an f32 vector, the scalar path, and the seal's keystream and
quantized bytes, over 4 x 65,536 indices (one run crossing 2**32, one far
past it) at key and counter in {0, 0xFFFFFFFF, 0xC0FFEE}.

The quantizing unseal's per-thread arithmetic is transcribed the same
way (a 4-byte word of cipher bytes, one XOR with the packed keystream top
bytes, sign extension, one f32 multiply, the round to bf16 done on the
bits) and held bit for bit against the port's ``ref.unseal_ref`` and the
JAX package's ``unseal_pallas`` in interpret mode.

It also transcribes the kernels' index rule (which thread touches which
element) and checks that the wrappers' launch plans (``ops._cipher_plan``,
``ops._seal_threads``, ``ops._unseal_plan``) cover every element exactly
once.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.seal import keystream_u32 as torch_keystream

MASK = 0xFFFFFFFF
M1, M2, M3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
WORDS = (0, 0xFFFFFFFF, 0xC0FFEE)
KEY_CTR = [(k, c) for k in WORDS for c in WORDS]
SMS = 132                                   # an H100 SXM's SMs
PATH_N = 10 * 131072                        # the swap path's [10, 131072]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's keystream as the oracle (absent without JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.seal import keystream_u32, unseal_pallas
    return types.SimpleNamespace(jnp=jnp, keystream=keystream_u32,
                                 unseal_pallas=unseal_pallas)


def u32(v) -> np.ndarray:
    """int64 values modulo 2**32, as a C cast to uint32_t takes them."""
    return (np.asarray(v, dtype=np.int64) & MASK).astype(np.uint32)


def c32(v: int) -> np.uint32:
    """A compile-time constant, reduced modulo 2**32 as nvcc folds it."""
    return np.uint32(v & MASK)


# --- transcription of csrc/keystream.cuh -----------------------------------
def consts(key: int, ctr: int):
    k = (key + ctr * M2) & MASK
    return c32(k ^ (k >> 16)), c32(key | 1), c32(ctr)


def pre(c, a: np.ndarray) -> np.ndarray:
    k1, kmul, ctr = c
    x = (a ^ (a >> np.uint32(16)) ^ k1) * c32(M2)
    x = (x ^ (x >> np.uint32(13))) * c32(M3)
    x ^= x >> np.uint32(16)
    x = x * kmul + ctr
    return (x ^ (x >> np.uint32(15))) * c32(M1)


def byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s) for selector nibbles 0..7: byte i of
    the result is byte (s >> 4i) & 7 of the 8-byte value {y, x}."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + \
          [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


# --- transcription of the kernels' per-item work ----------------------------
def bits_vector_bf16(c, it: np.ndarray) -> np.ndarray:
    """seal_bits.cu xor_vector<uint16_t>: the 4 words XORed into one
    16-byte vector of 8 bf16 at item ``it`` -> [len(it), 4] uint32."""
    a0 = u32(it) * np.uint32(8) * c32(M1)
    words = []
    for j in range(4):
        p0 = pre(c, a0 + c32(2 * j * M1))
        p1 = pre(c, a0 + c32((2 * j + 1) * M1))
        words.append(byte_perm(p0, p1, 0x5410)
                     ^ byte_perm(p0 >> np.uint32(17), p1 >> np.uint32(17),
                                 0x5410))
    return np.stack(words, axis=1)


def bits_vector_f32(c, it: np.ndarray) -> np.ndarray:
    """xor_vector<uint32_t>: 4 words for one vector of 4 f32."""
    a0 = u32(it) * np.uint32(4) * c32(M1)
    words = []
    for j in range(4):
        p = pre(c, a0 + c32(j * M1))
        words.append(p ^ (p >> np.uint32(17)))
    return np.stack(words, axis=1)


def bits_scalar(c, idx: np.ndarray) -> np.ndarray:
    """keystream_elem: the unaligned path and the tail."""
    p = pre(c, u32(idx) * c32(M1))
    return p ^ (p >> np.uint32(17))


def seal_top_bytes(c, idx0: np.ndarray) -> np.ndarray:
    """seal_q8.cu keystream_top_bytes: the top bytes of 4 lanes' words,
    lane e in byte e."""
    a0 = u32(idx0) * c32(M1)
    p = [pre(c, a0 + c32(e * M1)) for e in range(4)]
    return byte_perm(byte_perm(p[0], p[1], 0x0073),
                     byte_perm(p[2], p[3], 0x0073), 0x5410)


def item_runs(per: int) -> np.ndarray:
    """Item numbers whose elements (``per`` a vector) give 4 x 65,536
    indices: from 0, a run crossing 2**32, a run near 2**33, and random
    items whose indices reach 2**40."""
    n = 65536 // per
    cross = (1 << 32) // per - n // 2
    rand = np.random.RandomState(0).randint(0, (1 << 40) // per, size=n,
                                                dtype=np.int64)
    return np.concatenate([np.arange(n), cross + np.arange(n),
                           (1 << 33) // per - 7 + np.arange(n), rand]
                          ).astype(np.int64)


def references(jx, key: int, ctr: int, idx: np.ndarray) -> np.ndarray:
    """Both packages' keystream at int64 indices (taken modulo 2**32);
    asserts they agree and returns the words as uint32."""
    want = np.asarray(jx.keystream(jx.jnp.uint32(key), jx.jnp.uint32(ctr),
                                   jx.jnp.asarray(u32(idx))))
    port = torch_keystream(key, ctr, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(port.astype(np.uint32), want)
    return want.astype(np.uint32)


def lo16(w):
    return w & np.uint32(0xFFFF)


@pytest.mark.parametrize("key,ctr", KEY_CTR)
def test_bf16_vector_lanes_match_both_keystreams(jx, key, ctr):
    it = item_runs(8)
    got = bits_vector_bf16(consts(key, ctr), it)
    for j in range(4):
        for half, lane in ((0, 2 * j), (16, 2 * j + 1)):
            want = references(jx, key, ctr, it * 8 + lane)
            np.testing.assert_array_equal(
                lo16(got[:, j] >> np.uint32(half)), lo16(want),
                err_msg=f"lane {lane}")


@pytest.mark.parametrize("key,ctr", KEY_CTR)
def test_f32_vector_lanes_match_both_keystreams(jx, key, ctr):
    it = item_runs(4)
    got = bits_vector_f32(consts(key, ctr), it)
    for j in range(4):
        np.testing.assert_array_equal(
            got[:, j], references(jx, key, ctr, it * 4 + j),
            err_msg=f"lane {j}")


@pytest.mark.parametrize("key,ctr", KEY_CTR)
def test_scalar_path_matches_both_keystreams(jx, key, ctr):
    idx = item_runs(1)
    np.testing.assert_array_equal(bits_scalar(consts(key, ctr), idx),
                                  references(jx, key, ctr, idx))


@pytest.mark.parametrize("key,ctr", KEY_CTR)
def test_seal_keystream_bytes_match_both_keystreams(jx, key, ctr):
    idx0 = item_runs(4) * 4
    got = seal_top_bytes(consts(key, ctr), idx0)
    for e in range(4):
        want = references(jx, key, ctr, idx0 + e) >> np.uint32(24)
        np.testing.assert_array_equal(
            (got >> np.uint32(8 * e)) & np.uint32(0xFF), want,
            err_msg=f"lane {e}")


def test_seal_packs_each_quantized_byte_in_its_lane():
    """quantize_store: the low bytes of four int32 q in [-127, 127] packed
    by __byte_perm, lane e in byte e."""
    q = np.random.RandomState(1).randint(-127, 128, size=(4096, 4))
    qu = u32(q)
    word = byte_perm(byte_perm(qu[:, 0], qu[:, 1], 0x0040),
                     byte_perm(qu[:, 2], qu[:, 3], 0x0040), 0x5410)
    for e in range(4):
        np.testing.assert_array_equal(
            (word >> np.uint32(8 * e)) & np.uint32(0xFF), q[:, e] & 0xFF)


def unseal_transcribed(cipher: np.ndarray, scales: np.ndarray, key: int,
                       ctr: int, out: str) -> np.ndarray:
    """seal_q8.cu unseal_q8_kernel, every thread at once: the thread of
    columns c .. c + 3 of a row packs their cipher bytes into a word (byte
    e for column c + e, zero past the row: one 4-byte load on the vector
    path, byte loads on the scalar one), XORs it with keystream_top_bytes
    at row * cols + c (mod 2**32), takes byte e as int8, multiplies by the
    row's f32 scale once (IEEE, round to nearest even) and, for bf16, rounds
    the f32 bits to nearest even. Returns the output bits: uint16 (bf16) or
    uint32 (f32), [rows, cols]."""
    rows, cols = cipher.shape
    starts = np.arange(0, cols, 4)
    padded = np.zeros((rows, len(starts) * 4), np.uint32)
    padded[:, :cols] = cipher
    lanes = padded.reshape(rows, len(starts), 4)
    word = (lanes[..., 0] | lanes[..., 1] << np.uint32(8)
            | lanes[..., 2] << np.uint32(16) | lanes[..., 3] << np.uint32(24))
    idx0 = np.arange(rows, dtype=np.int64)[:, None] * cols + starts[None, :]
    w = word ^ seal_top_bytes(consts(key, ctr), idx0)
    v = np.stack([((w >> np.uint32(8 * e)) & np.uint32(0xFF))
                  .astype(np.uint8).view(np.int8) for e in range(4)], axis=-1)
    v = v.astype(np.float32) * scales.astype(np.float32)[:, :, None]
    bits = v.reshape(rows, -1)[:, :cols].view(np.uint32)
    if out == "float32":
        return bits
    # f32 -> bf16, round to nearest even (values here are finite)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                           & np.uint32(1))) >> np.uint32(16)
    return rounded.astype(np.uint16)


def unseal_inputs(shape, seed=5):
    """Cipher bytes holding every one of the 256 values, shuffled, and f32
    row scales of the sizes the seal makes (absmax / 127), from numpy."""
    rng = np.random.RandomState(seed)
    n = shape[0] * shape[1]
    c = np.resize(np.arange(256, dtype=np.uint8), n)
    rng.shuffle(c)
    scales = (rng.rand(shape[0], 1) * 8 / 127 + 1e-6).astype(np.float32)
    return c.reshape(shape), scales


def bits_of(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("key,ctr", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                     (0xC0FFEE, 65537 * 3)])
@pytest.mark.parametrize("shape", [(4, 2048), (3, 2047), (5, 7)])
def test_unseal_transcription_matches_both_packages(jx, shape, key, ctr, out):
    """The vector path's arithmetic (cols a multiple of 4) and the scalar
    path's (the last thread of a row holds fewer than 4 columns)."""
    cipher, scales = unseal_inputs(shape)
    assert len(np.unique(cipher)) == min(256, cipher.size)
    got = unseal_transcribed(cipher, scales, key, ctr, out)
    port = ref.unseal_ref(torch.from_numpy(cipher), torch.from_numpy(scales),
                          key, ctr, getattr(torch, out))
    np.testing.assert_array_equal(got, bits_of(port))
    jnp = jx.jnp
    want = jx.unseal_pallas(jnp.asarray(cipher), jnp.asarray(scales),
                            jnp.uint32(key), jnp.uint32(ctr),
                            out_dtype=getattr(jnp, out), interpret=True)
    np.testing.assert_array_equal(
        got, np.asarray(want).view(np.uint16 if out == "bfloat16"
                                   else np.uint32))


def test_unseal_sign_extends_every_byte():
    """Byte b opens to the int8 value of b times the scale, for all 256 b,
    in every lane of the word."""
    cipher = np.arange(256, dtype=np.uint8).reshape(64, 4)
    ks = seal_top_bytes(consts(3, 4), np.arange(64, dtype=np.int64) * 4)
    lanes = np.stack([(ks >> np.uint32(8 * e)) & np.uint32(0xFF)
                      for e in range(4)], axis=1).astype(np.uint8)
    # the cipher bytes that open to 0..255 in order under key 3, ctr 4
    opened = unseal_transcribed(cipher ^ lanes, np.ones((64, 1), np.float32),
                                3, 4, "float32").view(np.float32)
    # one row of 256 columns: the flat index of (r, c) is 4 * r + c
    np.testing.assert_array_equal(
        opened.reshape(-1), np.arange(256, dtype=np.uint8).view(np.int8)
        .astype(np.float32))


# --- launch plans ------------------------------------------------------------
def cipher_hits(n: int, elem_bytes: int, vec_ok: bool, plan) -> np.ndarray:
    """How often the page cipher kernel touches each of n elements under
    ``plan``: thread g takes item g while below the item count, and threads
    g < tail the tail element items * per + g (seal_bits.cu
    bits_xor_kernel); the C entry refuses a plan that does not reach every
    item and the tail."""
    threads, blocks = plan
    per = 16 // elem_bytes if vec_ok else 1
    items, grid = n // per, threads * blocks
    tail = n - items * per
    assert grid >= items and grid >= tail and grid < 2 ** 31, plan
    g = np.arange(grid, dtype=np.int64)
    it = g[g < items]
    touched = [g[g < tail] + items * per] + [it * per + j for j in range(per)]
    return np.bincount(np.concatenate(touched), minlength=n)


def full_grid_n(elem_bytes: int, vec_ok: bool) -> int:
    """Elements of a grid whose every thread has a whole item under the
    plan of the swap path's size."""
    threads, blocks = ops._cipher_plan(PATH_N, elem_bytes, vec_ok)
    return threads * blocks * (16 // elem_bytes if vec_ok else 1)


@pytest.mark.parametrize("vec_ok", [True, False])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n", ["1", "7", "8", "full-1vec", "full-1vec+3",
                               "path"])
def test_cipher_plan_covers_every_element_once(n, elem_bytes, vec_ok):
    per = 16 // elem_bytes if vec_ok else 1
    full = full_grid_n(elem_bytes, vec_ok)
    n = {"1": 1, "7": 7, "8": 8, "full-1vec": full - per,
         "full-1vec+3": full - per + 3, "path": PATH_N}[n]
    plan = ops._cipher_plan(n, elem_bytes, vec_ok)
    hits = cipher_hits(n, elem_bytes, vec_ok, plan)
    assert hits.shape == (n,) and (hits == 1).all(), (n, plan)


def test_cipher_plan_balances_the_path_shape():
    """At [10, 131072] bf16 the busiest SM carries within 5% of an even
    share of the 16-byte vectors."""
    items = PATH_N // 8
    threads, blocks = ops._cipher_plan(PATH_N, 2, True)
    busiest = -(-blocks // SMS) * threads
    assert busiest <= 1.05 * items / SMS, (threads, blocks)


@pytest.mark.parametrize("cols", [1, 7, 8, 2047, 2048, 4096, 131075])
def test_seal_plan_covers_every_column_once(cols):
    """Thread t of the row's block holds columns t0 + t * 4 + e (e < 4,
    below cols) of each tile t0 = 0, tile, 2 * tile, ... with tile =
    threads * 4 (seal_q8.cu seal_q8_kernel)."""
    threads = ops._seal_threads(cols)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    tile = threads * 4
    if cols <= 4096:
        assert tile >= cols, "a row that fits one tile is read once"
    cols_hit = [t0 + t * 4 + e for t0 in range(0, cols, tile)
                for t in range(threads) for e in range(4)
                if t0 + t * 4 + e < cols]
    assert np.array_equal(np.bincount(cols_hit, minlength=cols),
                          np.ones(cols, np.int64))


@pytest.mark.parametrize("most", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("cols", list(range(1, 10)) + [2047, 2048, 5000,
                                                      8192])
def test_unseal_plan_covers_every_column_once(cols, most, monkeypatch):
    """Thread t of column tile x holds columns x * threads * 4 + t * 4 + e
    (e < 4, below cols) of its row (seal_q8.cu unseal_q8_kernel), under the
    plan's default bound on threads and each candidate of
    ``repro_torch.launch.sweep_seal``; no tile is empty (the C entry
    refuses such a plan)."""
    if most != 1024:
        monkeypatch.setattr(ops, "_UNSEAL_THREADS", most)
    threads, tiles = ops._unseal_plan(cols)
    assert threads % 32 == 0 and 32 <= threads <= min(most, 1024)
    tile = threads * 4
    assert (tiles - 1) * tile < cols <= tiles * tile, (threads, tiles)
    x, t, e = np.meshgrid(np.arange(tiles), np.arange(threads), np.arange(4),
                          indexing="ij")
    col = (x * tile + t * 4 + e).ravel()
    assert np.array_equal(np.bincount(col[col < cols], minlength=cols),
                          np.ones(cols, np.int64))
