"""The quantizing seal of the PyTorch port against the JAX package.

On the CPU: the port's plain ``seal_ref`` / ``unseal_ref`` (what
``ops.seal`` / ``ops.unseal`` run for a CPU tensor) against the JAX
oracle ``ref.seal_ref`` and the Pallas kernel ``seal_pallas`` in interpret
mode, over the shape and dtype sweep of ``tests/test_kernels.py``: cipher
bytes may differ only at rounding ties (below 1e-3 of the elements, the
reference's own allowance), the f32 row scales agree within rtol 1e-6, and
one cipher unseals to the same bits in both packages. Payloads cross
packages both ways, and the activation-sealing helpers (``_leaf_counter``,
``seal_array``, ``seal_tree``) match the reference's.

On a card (marker ``cuda``, skipped without one): the CUDA kernel against
the plain version on the same inputs — the same tolerances, scales equal,
unseal bit-equal, the latter also from cipher views 1 to 3 bytes past a
4-byte boundary, into bf16 and f32, and past 65,535 rows. Run there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_seal_q8.py``
(the JAX half skips where JAX is not installed).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.enclave import sealing
from repro_torch.kernels import ops, ref

# the reference's sweep (tests/test_kernels.py) plus the pipeline
# boundary's shape ([B_mb = 4, d_model = 2048])
SEAL_CASES = [((64, 128), "float32"), ((256, 512), "bfloat16"),
              ((100, 48), "float32"), ((8, 2048), "bfloat16"),
              ((1, 16), "float32"), ((4, 2048), "bfloat16"),
              ((4, 2048), "float32")]
KEYS = [(0xDEADBEEF, 7), (0xFFFFFFFF, 0xFFFFFFFF), (0xC0FFEE, 65537 * 9)]
TIE_TOL = 1e-3          # cipher mismatch allowed from rounding ties


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.enclave import sealing as jsealing
    from repro.kernels import ref as jref
    from repro.kernels.seal import seal_pallas, unseal_pallas
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jref,
                                 sealing=jsealing, seal_pallas=seal_pallas,
                                 unseal_pallas=unseal_pallas)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(shape, dtype, seed=1):
    """numpy f32 draws and the same values as a torch tensor of ``dtype``
    (bf16 rounding happens once, in torch, and JAX gets those bits)."""
    x = (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return t, t.float().numpy()


def _jax_x(jx, xf, dtype):
    return jx.jnp.asarray(xf).astype(getattr(jx.jnp, dtype))


@pytest.mark.parametrize("shape,dtype", SEAL_CASES)
@pytest.mark.parametrize("key,ctr", KEYS)
def test_plain_seal_matches_jax_oracle_and_pallas(jx, shape, dtype, key, ctr):
    jnp = jx.jnp
    t, xf = _x(shape, dtype)
    jx_in = _jax_x(jx, xf, dtype)
    c, s = ops.seal(t, key, ctr)
    assert c.dtype == torch.uint8 and tuple(c.shape) == shape
    assert s.dtype == torch.float32 and tuple(s.shape) == (shape[0], 1)
    jk, jc = jnp.uint32(key), jnp.uint32(ctr)
    for name, (wc, ws) in (
            ("oracle", jx.ref.seal_ref(jx_in, jk, jc)),
            ("pallas", jx.seal_pallas(jx_in, jk, jc, interpret=True))):
        mismatch = (np.asarray(wc) != c.numpy()).mean()
        assert mismatch < TIE_TOL, (name, mismatch)
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
    # one cipher text, two packages: the unsealed bits are equal
    wc, ws = jx.ref.seal_ref(jx_in, jk, jc)
    want = jx.ref.unseal_ref(wc, ws, jk, jc, getattr(jnp, dtype))
    got = ops.unseal(torch.from_numpy(np.array(wc)),
                     torch.from_numpy(np.array(ws)), key, ctr,
                     getattr(torch, dtype))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_crosses_packages_both_ways(jx, dtype):
    """seal_array / unseal_array: a boundary payload sealed by either
    package opens under the other to the same values as under its own."""
    jnp = jx.jnp
    t, xf = _x((3, 5, 64), dtype, seed=2)
    shape = (3, 5, 64)
    key, step = 0xC0FFEE + 11, 11
    tc, ts = sealing.seal_array(t, key, step)
    jc, js = jx.sealing.seal_array(_jax_x(jx, xf, dtype), jnp.uint32(key),
                                   step)
    assert (np.asarray(jc) != tc.numpy()).mean() < TIE_TOL
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # torch-sealed, JAX-opened == torch-opened
    j_open = jx.sealing.unseal_array(jnp.asarray(tc.numpy()),
                                     jnp.asarray(ts.numpy()), shape,
                                     jnp.uint32(key), step, jdt)
    t_open = sealing.unseal_array(tc, ts, shape, key, step, tdt)
    np.testing.assert_array_equal(np.asarray(j_open.astype(jnp.float32)),
                                  t_open.float().numpy())
    # JAX-sealed, torch-opened == JAX-opened
    t_open = sealing.unseal_array(torch.from_numpy(np.array(jc)),
                                  torch.from_numpy(np.array(js)), shape,
                                  key, step, tdt)
    j_open = jx.sealing.unseal_array(jc, js, shape, jnp.uint32(key), step,
                                     jdt)
    np.testing.assert_array_equal(t_open.float().numpy(),
                                  np.asarray(j_open.astype(jnp.float32)))
    np.testing.assert_allclose(t_open.float().numpy(), xf, atol=0.1)


@pytest.mark.parametrize("step", [0, 3, 65536, 2**32 - 1])
def test_leaf_counter_matches_reference(jx, step):
    for leaf in (0, 1, 7):
        assert sealing._leaf_counter(step, leaf) == \
            int(jx.sealing._leaf_counter(step, leaf))


def test_seal_tree_matches_reference(jx):
    """Same leaf order (dict keys sorted), same per-leaf counters, raw
    integer leaves, and the round trip within the quantization."""
    jnp = jx.jnp
    rng = np.random.RandomState(3)
    a = rng.randn(4, 32).astype(np.float32)
    b = rng.randn(2, 3, 16).astype(np.float32)
    n = np.arange(5, dtype=np.int32)
    v = rng.randn(16).astype(np.float32)
    ttree = {"b": (torch.from_numpy(b), torch.from_numpy(n)),
             "a": torch.from_numpy(a), "v": [torch.from_numpy(v)]}
    jtree = {"b": (jnp.asarray(b), jnp.asarray(n)), "a": jnp.asarray(a),
             "v": [jnp.asarray(v)]}
    tsealed, tdef = sealing.seal_tree(ttree, 0xABCD, 3)
    jsealed, _ = jx.sealing.seal_tree(jtree, jnp.uint32(0xABCD), 3)
    assert [tag for tag, _ in tsealed] == [tag for tag, _ in jsealed]
    for (tag, tp), (_, jp) in zip(tsealed, jsealed):
        if tag == "raw":
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
            continue
        assert tp[2] == tuple(jp[2])
        assert (tp[0].numpy() != np.asarray(jp[0])).mean() < TIE_TOL
        np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp[1]),
                                   rtol=1e-6)
    out = sealing.unseal_tree(tsealed, tdef, 0xABCD, 3)
    assert sorted(out) == ["a", "b", "v"] and isinstance(out["b"], tuple) \
        and isinstance(out["v"], list)
    np.testing.assert_allclose(out["a"].numpy(), a, atol=0.05)
    np.testing.assert_allclose(out["b"][0].numpy(), b, atol=0.05)
    np.testing.assert_allclose(out["v"][0].numpy(), v, atol=0.05)
    assert torch.equal(out["b"][1], torch.from_numpy(n))


def test_same_plaintext_different_leaves_and_steps_differ():
    x = torch.ones(2, 16)
    sealed, _ = sealing.seal_tree({"a": x, "b": x}, 1, 0)
    assert (sealed[0][1][0] == sealed[1][1][0]).float().mean() < 0.1
    c0, _ = sealing.seal_array(x, 1, 0)
    c1, _ = sealing.seal_array(x, 1, 1)
    assert (c0 == c1).float().mean() < 0.1


def test_ciphertext_statistics_uniform():
    x = torch.from_numpy(np.random.RandomState(2).randn(256, 512)
                         .astype(np.float32))
    c, _ = ref.seal_ref(x, 3, 1)
    h = np.bincount(c.numpy().ravel(), minlength=256)
    chi2 = ((h - h.mean()) ** 2 / h.mean()).sum()
    assert chi2 < 400          # ~255 dof; catastrophic non-uniformity fails


def test_seal_rejects_wrong_types():
    with pytest.raises(TypeError):
        ops.seal(torch.zeros(2, 4, dtype=torch.float16), 1, 2)
    with pytest.raises(TypeError):
        ops.seal(torch.zeros(8), 1, 2)
    with pytest.raises(TypeError):
        ops.unseal(torch.zeros(2, 4, dtype=torch.int8),
                   torch.zeros(2, 1), 1, 2)
    with pytest.raises(TypeError):
        ops.unseal(torch.zeros(2, 4, dtype=torch.uint8),
                   torch.zeros(4, 1), 1, 2)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------
# on the card also widths that are not a multiple of 4 (the kernel's
# scalar path) and widths that are a multiple of 4 but not of 8
CARD_SEAL_CASES = SEAL_CASES + [((3, 2047), "bfloat16"), ((5, 7), "float32"),
                                ((3, 2052), "bfloat16"), ((2, 4), "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape,dtype", CARD_SEAL_CASES)
@pytest.mark.parametrize("key,ctr", KEYS)
def test_seal_kernel_matches_plain(cuda, shape, dtype, key, ctr, offset):
    """offset 1: a contiguous tensor whose storage starts one element (2
    bytes in bf16, 4 in f32) past a 16-byte boundary."""
    t, _ = _x(shape, dtype)
    base = torch.zeros(t.numel() + offset, dtype=t.dtype, device=cuda)
    base[offset:] = t.flatten().to(cuda)
    x = base[offset:].view(shape)
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    before = dict(ops.LAUNCHES)
    c, s = ops.seal(x, key, ctr)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["seal"] == before["seal"] + 1
    wc, ws = ref.seal_ref(x, key, ctr)
    assert (c != wc).float().mean().item() < TIE_TOL
    assert torch.equal(s, ws), "row scales differ"
    # and the plain version on the CPU, which equals the JAX oracle
    cc, cs = ref.seal_ref(x.cpu(), key, ctr)
    assert (c.cpu() != cc).float().mean().item() < TIE_TOL
    assert torch.equal(s.cpu(), cs), "row scales differ from the CPU's"
    got = ops.unseal(wc, ws, key, ctr, getattr(torch, dtype))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["unseal"] == before["unseal"] + 1
    want = ref.unseal_ref(wc, ws, key, ctr, getattr(torch, dtype))
    assert torch.equal(got.float(), want.float()), "unseal not bit-equal"


@pytest.mark.cuda
def test_seal_kernel_rows_wider_than_the_block(cuda):
    """cols far above one tile (1024 threads x 4 columns), and an odd
    width."""
    for cols in (131072 + 3, 7):
        x = torch.randn(3, cols, device=cuda)
        c, s = ops.seal(x, 5, 6)
        wc, ws = ref.seal_ref(x, 5, 6)
        assert torch.equal(s, ws)
        assert (c != wc).float().mean().item() < TIE_TOL


# unseal on the card: the stage boundary's shape and its double, widths not
# a multiple of 4, one element, one wide row, and a wide block of rows
UNSEAL_CARD_SHAPES = [(4, 2048), (8, 2048), (3, 2047), (5, 7), (1, 1),
                      (1, 5000), (64, 8192)]


def _unseal_operands(device, shape, offset, seed=7):
    """Random cipher bytes as a contiguous view ``offset`` bytes past a
    4-byte boundary, and f32 row scales of the seal's sizes."""
    rng = np.random.RandomState(seed)
    n = shape[0] * shape[1]
    base = torch.from_numpy(rng.randint(0, 256, size=n + offset)
                            .astype(np.uint8)).to(device)
    c = base[offset:].view(shape)
    assert c.is_contiguous() and (c.data_ptr() % 4 == 0) == (offset == 0)
    scales = torch.from_numpy((rng.rand(shape[0], 1) * 8 / 127 + 1e-6)
                              .astype(np.float32)).to(device)
    return c, scales


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["bfloat16", "float32"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", UNSEAL_CARD_SHAPES)
def test_unseal_kernel_matches_plain(cuda, shape, offset, out):
    """Bit-equal to the plain version on the card and on the CPU; offsets
    1 to 3 and widths not a multiple of 4 take the scalar path."""
    c, scales = _unseal_operands(cuda, shape, offset)
    dtype = getattr(torch, out)
    for key, ctr in KEYS:
        before = ops.LAUNCHES["unseal"]
        got = ops.unseal(c, scales, key, ctr, dtype)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["unseal"] == before + 1
        want = ref.unseal_ref(c, scales, key, ctr, dtype)
        assert torch.equal(_bits(got), _bits(want)), "not bit-equal"
        cpu = ref.unseal_ref(c.cpu(), scales.cpu(), key, ctr, dtype)
        assert torch.equal(_bits(got.cpu()), _bits(cpu)), \
            "not bit-equal to the CPU's"


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [4, 3])
def test_unseal_kernel_past_65535_rows(cuda, cols):
    """Rows past gridDim.y's limit go to the grid's z slices."""
    c, scales = _unseal_operands(cuda, (70000, cols), 0)
    got = ops.unseal(c, scales, 5, 6, torch.float32)
    want = ref.unseal_ref(c, scales, 5, 6, torch.float32)
    assert torch.equal(_bits(got), _bits(want))
