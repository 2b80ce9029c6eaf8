import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_subprocess(code: str, devices: int = 4, timeout: int = 900) -> str:
    """Run python code in a fresh process with N fake XLA devices.

    Used by multi-device tests: the main pytest process must keep seeing a
    single device (smoke tests depend on it), so anything needing a mesh
    larger than 1 runs out-of-process.
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout[-4000:]}\n"
            f"--- stderr ---\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.fixture(scope="session")
def subproc():
    return run_subprocess


def random_placement_instance(rng, m, r, u):
    """Random placement problem (m layers, r TEEs, u untrusted devices) —
    shared by the solver-equivalence tests in test_planner.py and
    test_property.py so both suites fuzz the same instance space."""
    import dataclasses

    from repro.core import cost_model as CM
    from repro.core.planner import LayerProfile, ResourceGraph

    devs = {}
    for i in range(r):
        devs[f"t{i}"] = dataclasses.replace(
            CM.TEE, name=f"t{i}", flops_per_s=float(rng.uniform(5e8, 5e9)),
            mem_bw=float(rng.uniform(1e9, 8e9)))
    for i in range(u):
        devs[f"u{i}"] = dataclasses.replace(
            CM.CPU, name=f"u{i}", flops_per_s=float(rng.uniform(5e9, 9e10)))
    profs = [LayerProfile(f"l{i}", float(rng.uniform(1e6, 5e8)),
                          float(rng.uniform(1e4, 1e6)),
                          similarity=float(rng.uniform(0, 1)),
                          params_bytes=float(rng.uniform(0, 8e7)),
                          eff=float(rng.uniform(0.5, 1.0)))
             for i in range(m)]
    return profs, ResourceGraph(devs, {}, CM.WAN_30MBPS)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips when "
                   "torch.cuda.is_available() is False")
