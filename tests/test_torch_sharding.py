"""Logical axes and sharding rules of the PyTorch port against the JAX
package, on the CPU (no arrays at full width: specs only).

(a) Every registered config's ``param_specs`` (shape, initializer, scale
    and logical axes) equal the reference's leaf for leaf at full width;
    the timeline cache's specs and axes (``init_cache_axes``) and
    ``input_specs`` / ``input_axes`` equal the reference's for every
    config and every ``SHAPES`` cell.
(b) ``resolve_spec`` equals the reference's under hypothesis: random
    shapes, every logical axis name of the four rule tables (and one no
    table has), on meshes (1,), (2, 4), (2, 2, 2), (16, 16) and
    (2, 16, 16). The reference's reads only ``mesh.axis_names`` and
    ``mesh.devices.shape``, so a stand-in with a numpy ``devices`` array
    serves it without XLA devices. The reference's
    ``tests/test_property.py::test_resolve_spec_always_divides`` runs on
    the port's one-device ``DeviceMesh``.
(c) ``param_shardings``, ``cache_shardings`` and ``batch_shardings`` on
    the logical production meshes equal the reference's ``resolve_spec``
    of the reference's own specs, for every config at full width.
(d) DTensor's layout of a dim over two mesh axes is JAX's major-to-minor
    one: four gloo ranks on a real (2, 2) ``DeviceMesh``.
"""
import math
import os
import socket
import subprocess
import sys
import textwrap
import types

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch
from hypothesis import given

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch.mesh import (LogicalMesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models.api import build_model
from repro_torch.models.layers import ParamSpec
from repro_torch.runtime import steps as S
from repro_torch.sharding import rules as R

MAX_SEQ = 4096
MESHES = {(1,): ("data",), (2, 4): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
TABLES = ("PARAM_RULES", "ACT_RULES", "SP_ACT_RULES", "PIPE_RULES")
NAMES = sorted({k for t in TABLES for k in getattr(R, t) if k is not None}
               | {"not_in_any_table"})


def _jax_pkg():
    pytest.importorskip("jax")
    import repro.configs as JC
    import repro.models.api as JA
    import repro.models.layers as JL
    import repro.sharding.rules as JR
    return JC, JA, JL, JR


def _stand_in(mesh):
    """What the reference's ``resolve_spec`` reads of a mesh."""
    sizes = R.mesh_axis_sizes(mesh)
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _named(tree, is_leaf, prefix=""):
    """{path: leaf} of a nested dict / tuple tree."""
    if is_leaf(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_named(v, is_leaf, f"{prefix}/{k}"))
    return out


def _jax_specs(JL, specs):
    return _named(specs, lambda x: isinstance(x, JL.ParamSpec))


def _port_specs(specs):
    return _named(specs, lambda x: isinstance(x, ParamSpec))


def _is_struct(x):
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _is_port_spec(x):
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[1], torch.dtype)


def _apis(arch):
    JC, JA, _, _ = _jax_pkg()
    japi = JA.build_model(JC.get_arch(arch), max_seq=MAX_SEQ)
    tapi = build_model(get_arch(arch), device="meta", max_seq=MAX_SEQ)
    return japi, tapi


# ---------------------------------------------------------------------------
# (a) axes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_and_axes_equal_reference(arch):
    _, _, JL, _ = _jax_pkg()
    japi, tapi = _apis(arch)
    want = _jax_specs(JL, japi.param_specs())
    got = _port_specs(tapi.param_specs())
    assert sorted(got) == sorted(want)
    for path, j in want.items():
        t = got[path]
        assert (tuple(t.shape), tuple(t.axes), t.init, t.scale) == \
            (tuple(j.shape), tuple(j.axes), j.init, j.scale), path
    # abstract_params: meta tensors of the specs' shapes
    ab = _named(tapi.abstract_params(), lambda x: isinstance(x,
                                                             torch.Tensor))
    assert {p: tuple(t.shape) for p, t in ab.items()} == \
        {p: tuple(s.shape) for p, s in got.items()}
    assert all(t.is_meta for t in ab.values())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_and_input_axes_equal_reference(arch):
    japi, tapi = _apis(arch)
    for shape in SHAPES.values():
        B, Sq = shape.global_batch, shape.seq_len
        jspecs, jaxes = japi.init_cache_specs(B, Sq)
        tspecs = tapi.init_cache_specs(B, Sq)
        assert tapi.init_cache_axes(B, Sq) == jaxes, (arch, shape.name)
        js = _named(jspecs, _is_struct)
        ts = _named(tspecs, _is_port_spec)
        assert {p: tuple(s.shape) for p, s in js.items()} == \
            {p: tuple(s[0]) for p, s in ts.items()}, (arch, shape.name)
        assert tapi.input_axes(shape) == japi.input_axes(shape)
        assert {k: tuple(v[0]) for k, v in tapi.input_specs(shape).items()} \
            == {k: tuple(v.shape)
                for k, v in japi.input_specs(shape).items()}


def test_param_spec_refuses_axes_of_another_rank():
    with pytest.raises(ValueError, match="axes"):
        ParamSpec((4, 8), axes=("embed",))


# ---------------------------------------------------------------------------
# (b) resolve_spec under hypothesis
# ---------------------------------------------------------------------------
_DIMS = st.one_of(st.integers(1, 64), st.sampled_from(
    [96, 128, 256, 512, 1024, 2048, 4096, 32768, 128256, 151936]))


@hypothesis.settings(deadline=None, max_examples=300,
                     suppress_health_check=[hypothesis.HealthCheck.too_slow])
@given(dims=st.lists(_DIMS, min_size=1, max_size=5),
       data=st.data(),
       mesh_shape=st.sampled_from(sorted(MESHES)),
       table=st.sampled_from(TABLES))
def test_resolve_spec_equals_reference(dims, data, mesh_shape, table):
    _, _, _, JR = _jax_pkg()
    axes = data.draw(st.lists(st.sampled_from(NAMES + [None]),
                              min_size=len(dims), max_size=len(dims)))
    mesh = LogicalMesh(mesh_shape, MESHES[mesh_shape])
    got = R.resolve_spec(dims, axes, mesh, getattr(R, table))
    want = tuple(JR.resolve_spec(dims, axes, _stand_in(mesh),
                                 getattr(JR, table)))
    assert got == want
    sh = R.NamedSharding(mesh, got)
    local = sh.shard_shape(dims)
    assert all(d % n == 0 and d // n == s for d, n, s in zip(
        dims, [math.prod(R.mesh_axis_sizes(mesh)[a] for a in R._names(e))
               for e in got] + [1] * len(dims), local))


def test_rule_tables_equal_reference():
    _, _, _, JR = _jax_pkg()
    for t in TABLES:
        assert getattr(R, t) == getattr(JR, t), t
    assert R.merge_rules(R.ACT_RULES, {"act_seq": [("model",)]}) == \
        JR.merge_rules(JR.ACT_RULES, {"act_seq": [("model",)]})
    with pytest.raises(ValueError, match="rank mismatch"):
        R.resolve_spec((4, 4), ("act_batch",), make_production_mesh(),
                       R.ACT_RULES)


@hypothesis.settings(deadline=None, max_examples=25)
@given(st.integers(1, 64), st.integers(1, 64))
def test_resolve_spec_always_divides(rows, cols):
    """The reference's ``tests/test_property.py`` check, on the port's
    one-device ``DeviceMesh`` (gloo, one rank)."""
    mesh = make_mesh((1,), ("data",), device="cpu")
    spec = R.resolve_spec((rows, cols), ("act_batch", "act_mlp"), mesh,
                          R.ACT_RULES)
    # on a 1-device mesh everything resolves (possibly fully replicated)
    assert spec is not None
    assert R.NamedSharding(mesh, spec).is_replicated


def test_constrain_is_identity_outside_a_rule_context_and_on_one_device():
    x = torch.randn(4, 8)
    assert R.constrain(x, ("act_batch", None)) is x
    with R.axis_rules(make_mesh((1, 1), ("data", "model"), device="cpu")):
        assert R.current_mesh() is not None
        assert R.constrain(x, ("act_batch", None)) is x
    with R.axis_rules(make_production_mesh(multi_pod=True)):
        # a plain tensor on a logical mesh carries no placement
        assert R.constrain(x, ("act_batch", None)) is x
    assert R.current_mesh() is None


# ---------------------------------------------------------------------------
# (c) the sharding trees on the production meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_sharding_trees_equal_reference(arch, multi_pod):
    _, _, JL, JR = _jax_pkg()
    japi, tapi = _apis(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    jm = _stand_in(mesh)
    want = {p: tuple(JR.resolve_spec(s.shape, s.axes, jm, JR.PARAM_RULES))
            for p, s in _jax_specs(JL, japi.param_specs()).items()}
    got = _named(S.param_shardings(tapi, mesh),
                 lambda x: isinstance(x, R.NamedSharding))
    assert {p: sh.spec for p, sh in got.items()} == want
    opt = S.opt_shardings(tapi, mesh)
    assert {p: sh.spec for p, sh in _named(
        opt.v, lambda x: isinstance(x, R.NamedSharding)).items()} == want
    for shape in SHAPES.values():
        B, Sq = shape.global_batch, shape.seq_len
        jspecs, jaxes = japi.init_cache_specs(B, Sq)
        js = _named(jspecs, _is_struct)
        ja = _named(jaxes, lambda a: isinstance(a, tuple) and all(
            x is None or isinstance(x, str) for x in a))
        want = {p: tuple(JR.resolve_spec(js[p].shape, ja[p], jm,
                                         JR.ACT_RULES)) for p in js}
        got = _named(S.cache_shardings(tapi, B, mesh, max_seq=Sq),
                     lambda x: isinstance(x, R.NamedSharding))
        assert {p: sh.spec for p, sh in got.items()} == want, shape.name
        jin, jax_ = japi.input_specs(shape), japi.input_axes(shape)
        want = {k: tuple(JR.resolve_spec(jin[k].shape, jax_[k], jm,
                                         JR.ACT_RULES)) for k in jin}
        got = S.batch_shardings(tapi, shape, mesh)
        assert {k: sh.spec for k, sh in got.items()} == want, shape.name


# ---------------------------------------------------------------------------
# (d) DTensor's layout against JAX's
# ---------------------------------------------------------------------------
_RANK = """
import sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import rules as R

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
assert type(mesh).__name__ == "DeviceMesh", mesh
x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
sh = R.logical_sharding(x.shape, ("act_batch", None), mesh, R.ACT_RULES)
assert sh.spec == (("pod", "data"),), sh.spec
local = distribute_tensor(x, mesh, sh.placements()).to_local()
pod, data = mesh.get_coordinate()
block = 2 * pod + data           # JAX: the first mesh axis is the major
assert torch.equal(local, x[2 * block:2 * block + 2]), (rank, local)
dist.destroy_process_group()
print("RANK-OK", rank)
"""


def test_dtensor_layout_is_pod_major():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_RANK),
                               str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK-OK {r}" in out, err[-2000:]
    # a spec that lists mesh axes against the mesh's order is refused
    with pytest.raises(NotImplementedError, match="order"):
        R.NamedSharding(LogicalMesh((2, 2), ("pod", "data")),
                        (("data", "pod"),)).placements()
