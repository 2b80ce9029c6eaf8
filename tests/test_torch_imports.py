"""Guards of the PyTorch port: it imports no JAX and nothing of the JAX
package, and its entry points never fall back to the CPU silently."""
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _run(code: str, cwd: str = REPO, timeout: int = 300):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=cwd)


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    proc = _run("""
        import importlib, importlib.util, pkgutil, sys
        import repro_torch
        names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        # the modules of the pod axis over ranks among them
        assert {"repro_torch.launch.ranks", "repro_torch.launch.rank_jobs",
                "repro_torch.optim.compression",
                "repro_torch.serving.ranked"} <= set(names), names
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", "chip_smoke.py")
        importlib.util.module_from_spec(spec)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(len(names))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20      # every module imported


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(tmp_path):
    _no_card()
    from repro_torch.checkpoint import CheckpointManager, TensorSpec
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.launch import serve, train
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.weights import params_from_jax
    cfg = reduced(get_arch("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError):
        build_model(cfg, device="cuda")
    api = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        ServingEngine(api, EngineConfig())
    with pytest.raises(RuntimeError):
        ServingEngine(api, EngineConfig(kv_layout="timeline"))
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "llama3.2-1b", "--reduced"])
    for flags in (["--kv-layout", "timeline"], ["--per-token-prefill"]):
        with pytest.raises(RuntimeError):
            serve.main(["--arch", "llama3.2-1b", "--reduced", *flags])
    assert ServingEngine(api, EngineConfig(kv_layout="timeline"),
                         device="cpu").kv_layout == "timeline"
    with pytest.raises(RuntimeError):
        params_from_jax({"w": [1.0]})
    eng = ServingEngine(api, EngineConfig(), device="cpu")
    assert eng.device.type == "cpu"
    # training: the launcher, the step and a restore onto the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1"])
    shape = ShapeConfig("t", 8, 2, "train")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(api, AdamWConfig(), shape)
    assert callable(make_train_step(api, AdamWConfig(), shape, device="cpu"))
    ck = CheckpointManager(str(tmp_path), async_save=False)
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore(1, {"w": TensorSpec((2,), torch.float32, "cuda")})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore(1, {"w": TensorSpec((2,), torch.float32)})
    assert torch.equal(ck.restore(1, {"w": torch.zeros(2)})["w"],
                       torch.ones(2))


def test_serve_cli_runs_on_cpu_when_asked():
    from repro_torch.launch import serve
    st = serve.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
                     "--slots", "4", "--requests", "6", "--prompt-len", "12",
                     "--max-new", "6", "--page-size", "4", "--num-pages", "9",
                     "--shared-system-prompt", "0.75", "--f32"])
    assert st["completed"] == 6 and st["tokens_out"] == 36
    assert st["device"] == "cpu" and st["preemptions"] > 0


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    _no_card()
    proc = _run("import runpy; runpy.run_path('chip_smoke.py', "
                "run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300,
                           env=env)
    assert alone.returncode != 0 and '"ok"' not in alone.stdout
