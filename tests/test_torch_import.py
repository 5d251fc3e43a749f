"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never fall back to the CPU quietly."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import round as port_round
from repro_torch.core import solvers
from repro_torch.policy.pipeline import reactive_pipeline
from repro_torch.runtime import platform

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def test_main_path_imports_without_jax_or_reference():
    """With jax blocked: import the main paths of both slices, then run one
    learned-forecaster forward and one Holt-Winters fit on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import repro_torch.sim.engine\n"
        "import repro_torch.policy.pipeline\n"
        "import repro_torch.core.round\n"
        "import repro_torch.convert\n"
        "import repro_torch.forecast as fc\n"
        "import repro_torch.kernels.rglru_scan.ops\n"
        "from repro_torch.policy.pipeline import forecast_pipeline\n"
        "from repro_torch.forecast import learned\n"
        "p = learned.init_params(0, 16, 24)\n"
        "q = learned._quantiles_from_windows(p, torch.zeros(8, 48), 24, 24,"
        " 'kernel')\n"
        "assert q.shape == (8, 24, 3)\n"
        "y = np.abs(np.sin(np.arange(72))[:, None]) + np.ones((72, 2))\n"
        "hw = fc.make_forecaster('holtwinters', device='cpu').fit(y)\n"
        "assert np.isfinite(hw.predict(6).mean).all()\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import jax|from jax|import repro\.|from repro\.|from repro import"
    r"|import repro\s*$)", re.MULTILINE)


def test_port_sources_never_import_jax_or_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    names = {str(p.relative_to(SRC / "repro_torch")) for p in files}
    assert {"forecast/learned.py", "forecast/holtwinters.py",
            "models/rglru.py", "optim/adamw.py", "checkpoint/store.py",
            "kernels/rglru_scan/ops.py"} <= names
    hits = [(str(p), m.group(0).strip()) for p in files
            for m in _FORBIDDEN.finditer(p.read_text())]
    assert hits == []


def test_device_without_cuda_raises(monkeypatch):
    """No silent CPU fallback: with no card, the default device raises and
    so does every device entry point; the CPU is reached only on request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        platform.device()
    assert platform.device("cpu") == torch.device("cpu")
    assert not platform.on_hopper()
    cost, allowed, cap = np.ones((3, 2)), np.ones((3, 2), bool), np.array(
        [2, 2])
    for backend in ("fused", "torch"):
        with pytest.raises(RuntimeError):
            solvers.solve(cost, allowed, cap, backend=backend)
        assert solvers.solve(cost, allowed, cap, backend=backend,
                             device="cpu").feasible
    with pytest.raises(RuntimeError):
        port_round.fused_solve(cost, allowed, cap)


def test_pipeline_passes_device_to_device_backends(monkeypatch):
    from repro_torch.core import problem, telemetry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tele = telemetry.generate(days=2, seed=0)
    jobs = [problem.Job(job_id=i, home_region=i % 5, submit_time_s=0.0,
                        exec_time_s=600.0, energy_kwh=0.05, tolerance=1.0)
            for i in range(4)]
    cap = np.full(5, 2)
    with pytest.raises(RuntimeError):
        reactive_pipeline(tele, backend="fused").schedule(jobs, 0.0, cap)
    dec = reactive_pipeline(tele, backend="fused", device="cpu").schedule(
        jobs, 0.0, cap)
    assert dec.solver.backend == "fused" and len(dec.scheduled) == 4
    # The host backend takes no device at all.
    dec = reactive_pipeline(tele, backend="flow").schedule(jobs, 0.0, cap)
    assert len(dec.scheduled) == 4


def test_registry_lists_port_backends():
    assert {"flow", "torch", "fused"} <= set(solvers.available_backends())
    with pytest.raises(KeyError):
        solvers.get_solver("jax")
