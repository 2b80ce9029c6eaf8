"""The port's CNN tables and ``TinyCNN`` against the JAX package (CPU).

The five layer tables, their totals and the profiles the planner builds
from them must equal the reference's exactly. ``TinyCNN`` built from the
reference's kernels (``weights.cnn_from_jax``: HWIO -> OIHW) must give
the reference's feature maps within atol 1e-5 (f32 convolutions and
resizes summed in another order) on a 224 x 224 ``VideoChunkStream``
frame over every table, and each map must have its entry's resolution
(``max(2, resolution)``). The seeded draw is the reference's scheme:
standard normals over ``sqrt(9 * in_ch)`` per OIHW kernel.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import placement as JP
from repro.data.stream import VideoChunkStream as JStream
from repro.models import cnn as JC
from repro_torch.core.placement import profiles_from_cnn
from repro_torch.data.stream import VideoChunkStream
from repro_torch.models import cnn as C
from repro_torch.weights import cnn_from_jax

TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_equals_reference():
    assert list(C.CNN_MODELS) == list(JC.CNN_MODELS)
    assert C._MBN == JC._MBN
    assert [f.name for f in dataclasses.fields(C.CnnLayer)] == \
        [f.name for f in dataclasses.fields(JC.CnnLayer)]


@pytest.mark.parametrize("model", sorted(JC.CNN_MODELS))
def test_table_and_totals_equal_reference(model):
    got = [dataclasses.astuple(l) for l in C.CNN_MODELS[model]]
    want = [dataclasses.astuple(l) for l in JC.CNN_MODELS[model]]
    assert got == want
    assert C.model_params_bytes(model) == JC.model_params_bytes(model)
    assert C.model_flops(model) == JC.model_flops(model)
    assert [dataclasses.asdict(p) for p in
            profiles_from_cnn(C.CNN_MODELS[model])] == \
        [dataclasses.asdict(p) for p in
         JP.profiles_from_cnn(JC.CNN_MODELS[model])]


def test_named_tables_are_the_registry_entries():
    assert (C.ALEXNET, C.RESNET50, C.GOOGLENET, C.MOBILENET,
            C.SQUEEZENET) == tuple(C.CNN_MODELS[m] for m in (
                "alexnet", "resnet", "googlenet", "mobilenet", "squeezenet"))
    assert C._layer("x", 7, 2, 3, 4, 0.5) == C.CnnLayer(
        "x", 7, 2e6, 7 * 7 * 3 * 4, 4e3, 0.5)


def test_cnn_from_jax_is_hwio_to_oihw():
    w = np.arange(3 * 3 * 2 * 5, dtype=np.float32).reshape(3, 3, 2, 5)
    (t,) = cnn_from_jax([w], "cpu")
    assert t.shape == (5, 2, 3, 3) and t.is_contiguous()
    for o, i, h, x in [(0, 0, 0, 0), (4, 1, 2, 1), (2, 0, 1, 2)]:
        assert float(t[o, i, h, x]) == float(w[h, x, i, o])


@pytest.mark.parametrize("model", sorted(JC.CNN_MODELS))
def test_tinycnn_maps_match_reference(model):
    table = JC.CNN_MODELS[model]
    ref = JC.TinyCNN(table, channels=8, key=jax.random.PRNGKey(7))
    img = JStream(resolution=224).frame(0, 0)
    want = ref.intermediates(jnp.asarray(img))
    cnn = C.TinyCNN(C.CNN_MODELS[model], 8, device="cpu",
                    kernels=cnn_from_jax([np.asarray(k) for k in ref.kernels],
                                         "cpu"))
    got = cnn.intermediates(torch.from_numpy(
        VideoChunkStream(resolution=224).frame(0, 0)))
    assert len(got) == len(want) == len(table)
    for g, w, l in zip(got, want, table):
        res = max(2, l.resolution)
        assert tuple(g.shape) == tuple(w.shape) == (res, res, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_tinycnn_resolution_schedule():
    """The reference's ``test_tinycnn_resolution_schedule`` on the port,
    with a seeded draw."""
    table = C.CNN_MODELS["alexnet"]
    cnn = C.TinyCNN(table, channels=4, generator=torch.Generator()
                    .manual_seed(0), device="cpu")
    outs = cnn.intermediates(torch.from_numpy(
        VideoChunkStream(resolution=224).frame(0, 0)))
    assert len(outs) == len(table)
    for o, l in zip(outs, table):
        assert tuple(o.shape) == (max(2, l.resolution),) * 2 + (4,)
        assert bool((o >= 0).all())         # relu, then a convex resize


def test_tinycnn_draw_is_seeded_oihw_scaled():
    table = C.CNN_MODELS["squeezenet"]

    def draw(seed):
        return C.TinyCNN(table, channels=8, device="cpu",
                         generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(3), draw(3), draw(4)
    assert len(a.kernels) == len(table)
    assert tuple(a.kernels[0].shape) == (8, 3, 3, 3)
    assert all(tuple(w.shape) == (8, 8, 3, 3) for w in a.kernels[1:])
    assert all(torch.equal(x, y) for x, y in zip(a.kernels, b.kernels))
    assert not torch.equal(a.kernels[0], c.kernels[0])
    g = torch.Generator().manual_seed(3)
    first = torch.randn((8, 3, 3, 3), generator=g) / np.sqrt(27)
    assert torch.equal(a.kernels[0], first)
    assert not any(w.requires_grad for w in a.kernels)
    with pytest.raises(ValueError):
        C.TinyCNN(table, device="cpu")
    with pytest.raises(ValueError):
        C.TinyCNN(table, device="cpu", kernels=list(a.kernels[:2]))


def test_tinycnn_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.TinyCNN(C.ALEXNET, generator=torch.Generator())
    with pytest.raises(RuntimeError):
        cnn_from_jax([np.zeros((3, 3, 3, 8), np.float32)])
