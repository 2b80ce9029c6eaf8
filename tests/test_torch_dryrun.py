"""The dry-run of the PyTorch port (``launch/dryrun.py``,
``utils/cost_analysis.py``) on the CPU.

(a) The reference's ``tests/test_hlo_analysis.py::test_roofline_terms``
    on the port's ``Roofline``, with the reference's v5e constants passed
    explicitly (the port's defaults are the H100's datasheet figures).
(b) ``run_cell`` over every reduced config x every ``SHAPES`` cell on the
    logical production mesh: the skipped cells and their reasons equal
    the reference's ``shape_applicable``, no cell fails, and each writes
    its JSON record.
(c) The reference's ``tests/test_dryrun_small.py`` cells: reduced
    llama3.2-1b train on a logical (2, 2, 2) mesh and reduced glm4-9b
    decode on (2, 4). The port's per-device argument bytes, from its
    sharding trees, equal XLA's ``memory_analysis().argument_size_in_bytes``
    of the reference's compiled step (one subprocess, 8 host devices).
(d) ``main``: one cell through the CLI, and a failing cell makes it exit 1.
"""
import json
import math
import os

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_arch, reduced
from repro_torch.configs import shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.utils.cost_analysis import (HBM_BW, ICI_BW, PEAK_FLOPS,
                                             Roofline)


def test_roofline_terms():
    """The reference's check, at its v5e constants (197 TFLOP/s bf16,
    819 GB/s HBM, 50 GB/s ICI), passed explicitly."""
    r = Roofline(flops=197e12 * 256, hbm_bytes=819e9 * 256,
                 coll_bytes=50e9 * 256, chips=256, peak_flops=197e12,
                 hbm_bw=819e9, ici_bw=50e9)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 1.0) < 1e-9
    assert r.dominant in ("compute", "memory", "collective")
    # the port's defaults: the H100 SXM datasheet's figures
    assert (PEAK_FLOPS, HBM_BW, ICI_BW) == (989e12, 3.35e12, 450e9)
    r = Roofline(flops=989e12, hbm_bytes=3.35e12 / 2, coll_bytes=0.0,
                 chips=1)
    assert r.dominant == "compute" and r.bound_s == r.compute_s == 1.0
    assert r.as_dict()["memory_s"] == 0.5


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_reduced_cell_runs_or_skips_as_the_reference(arch, tmp_path):
    pytest.importorskip("jax")
    import repro.configs as JC
    cfg = reduced(get_arch(arch))
    jcfg = JC.reduced(JC.get_arch(arch))
    for name, shape in SHAPES.items():
        rec = dryrun.run_cell(arch, name, multi_pod=False, cfg=cfg,
                              out_dir=str(tmp_path))
        ok, why = JC.shape_applicable(jcfg, JC.SHAPES[name])
        assert "error" not in rec, rec.get("trace")
        if not ok:
            assert rec["skipped"] == why
            continue
        assert shape_applicable(cfg, shape) == (True, "")
        assert rec["raw_cost_analysis"]["flops"] > 0
        assert rec["raw_cost_analysis"]["bytes"] > 0
        assert rec["memory"]["temp_gb"] is None
        assert rec["collectives"] is None and "item 10" in \
            rec["collectives_note"]
        assert rec["roofline"]["chips"] == 256
        assert rec["tokens"] == shape.tokens
        fn = f"{arch.replace('.', '_')}__{name}__pod16x16.json"
        with open(os.path.join(str(tmp_path), fn)) as f:
            assert json.load(f)["shape"] == name


_REFERENCE_CELLS = """
import jax, jax.numpy as jnp
from repro.configs import get_arch, reduced, ShapeConfig
from repro.launch.mesh import make_mesh, mesh_context
from repro.models.api import build_model
from repro.optim.adamw import AdamWConfig
from repro.runtime import steps as S

mesh = make_mesh((2, 2, 2), ('pod', 'data', 'model'))
api = build_model(reduced(get_arch('llama3.2-1b')), max_seq=64)
shape = ShapeConfig('t', 64, 4, 'train')
ab = S.abstract_inputs(api, shape)
with mesh_context(mesh):
    step = S.make_train_step(api, mesh, AdamWConfig(), shape)
    c = step.lower(ab['params'], ab['opt'], ab['batch'],
                   jax.ShapeDtypeStruct((), jnp.int32)).compile()
print('TRAIN', c.memory_analysis().argument_size_in_bytes)
mesh = make_mesh((2, 4), ('data', 'model'))
api = build_model(reduced(get_arch('glm4-9b')), max_seq=64)
shape = ShapeConfig('d', 64, 4, 'decode')
ab = S.abstract_inputs(api, shape)
with mesh_context(mesh):
    step = S.make_decode_step(api, mesh, shape)
    c = step.lower(ab['params'], ab['cache'], ab['batch']).compile()
print('DECODE', c.memory_analysis().argument_size_in_bytes)
"""


def test_small_mesh_cells_argument_bytes_equal_xla(subproc):
    pytest.importorskip("jax")
    out = subproc(_REFERENCE_CELLS, devices=8, timeout=600)
    want = {line.split()[0]: int(line.split()[1])
            for line in out.splitlines() if line.split()[:1] in
            (["TRAIN"], ["DECODE"])}
    cells = {"TRAIN": ("llama3.2-1b", ShapeConfig("t", 64, 4, "train"),
                       LogicalMesh((2, 2, 2), ("pod", "data", "model"))),
             "DECODE": ("glm4-9b", ShapeConfig("d", 64, 4, "decode"),
                        LogicalMesh((2, 4), ("data", "model")))}
    for key, (arch, shape, mesh) in cells.items():
        rec = dryrun.run_cell(arch, shape.name, multi_pod=False, save=False,
                              cfg=reduced(get_arch(arch)), shape=shape,
                              mesh=mesh)
        assert "error" not in rec, rec.get("trace")
        assert rec["memory"]["argument_bytes"] == want[key], (key, want)
        assert rec["roofline"]["chips"] == math.prod(mesh.shape)
        assert rec["raw_cost_analysis"]["flops"] > 0


def test_main_writes_records_and_fails_on_a_failed_cell(tmp_path, capsys):
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--out-dir", str(tmp_path)])
    assert "ok   llama3.2-1b" in capsys.readouterr().out
    with open(tmp_path / "llama3_2-1b__decode_32k__pod16x16.json") as f:
        rec = json.load(f)
    assert rec["memory"]["per_device_gb"] > 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--out-dir", str(tmp_path)])
    assert e.value.code == 1
    assert "1 FAILURES" in capsys.readouterr().out
