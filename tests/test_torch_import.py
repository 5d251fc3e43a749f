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
    """With jax blocked: import the main paths of the slices, then run one
    learned-forecaster forward, one Holt-Winters fit, a two-cell plan
    built from spec strings (serial, then two seeds through the ``device``
    executor), one reduced-config LM prefill per architecture family
    (MLA, MoE, leading dense layers, vision and encdec too) and a small
    workflow cell streamed through the warm-started service on the CPU."""
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
        "import repro_torch.policy, repro_torch.sim.scenarios\n"
        "import repro_torch.experiments, repro_torch.obs.report\n"
        "from repro_torch import experiments, policy\n"
        "from repro_torch.core import baselines, controller, solvers\n"
        "assert 'scipy' in solvers.available_backends()\n"
        "rows = experiments.ExperimentPlan.build(\n"
        "    ['nominal[days=0.01,jobs_per_day=5000]'],\n"
        "    ['baseline', 'waterwise[backend=fused]']).run(device='cpu')\n"
        "assert [r['error'] for r in rows] == ['', ''], rows\n"
        "import repro_torch.experiments.shard\n"
        "rows = experiments.ExperimentPlan.build(\n"
        "    ['nominal[days=0.01,jobs_per_day=5000]'],\n"
        "    ['waterwise[backend=fused]'], seeds=[0, 1]).run(\n"
        "    'device', device='cpu')\n"
        "assert [r['error'] for r in rows] == ['', ''], rows\n"
        "import repro_torch.runtime.serve_loop\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.ssd_scan.ops\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.model import Model\n"
        "for arch in ('qwen2_1_5b', 'mamba2_2_7b', 'minicpm3_4b', "
        "'dbrx_132b', 'deepseek_v2_236b', 'llama_3_2_vision_11b', "
        "'seamless_m4t_large_v2'):\n"
        "    m = Model(get_config(arch, reduced=True))\n"
        "    p = m.init(torch.Generator().manual_seed(0))\n"
        "    t = torch.zeros((2, 12), dtype=torch.long)\n"
        "    b = dict(tokens=t)\n"
        "    if m.cfg.family == 'encdec':\n"
        "        b['frames'] = torch.ones((2, 7, m.cfg.d_model))\n"
        "    if m.cfg.family == 'vision':\n"
        "        b['patches'] = torch.ones((2, m.cfg.n_img_tokens, "
        "m.cfg.d_model))\n"
        "    logits, cache = m.prefill(p, b)\n"
        "    assert logits.shape == (2, m.cfg.padded_vocab)\n"
        "    assert torch.isfinite(logits.float()).all()\n"
        "import repro_torch.serve, repro_torch.workflows\n"
        "import repro_torch.runtime.elastic\n"
        "import repro_torch.data, repro_torch.optim.compression\n"
        "from repro_torch.serve import DecisionLoop, ReplayArrivals\n"
        "from repro_torch.sim.engine import EventSimulator\n"
        "from repro_torch.sim.scenarios import get_scenario\n"
        "from repro_torch.workflows import precedence_violations\n"
        "inst = get_scenario('workflow-diurnal').build(0.005, 0, 5000.0, "
        "0.15)\n"
        "pipe = forecast_pipeline(inst.tele, forecaster='oracle', "
        "backend='fused', warm=True, device='cpu')\n"
        "loop = DecisionLoop(EventSimulator(inst.tele, inst.capacity), pipe,"
        " ReplayArrivals(inst.jobs))\n"
        "rep = loop.run(0.005 * 86400.0)\n"
        "assert rep.placed == len(inst.jobs) > 0, rep\n"
        "assert pipe.sinkhorn_cold_iters, rep\n"
        "assert precedence_violations(loop.stepper.result()['records']) "
        "== 0\n"
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
            "kernels/rglru_scan/ops.py", "configs/base.py",
            "configs/qwen2_1_5b.py", "configs/mamba2_2_7b.py",
            "models/attention.py", "models/transformer.py",
            "models/model.py", "models/mla.py", "models/moe.py",
            "configs/minicpm3_4b.py", "configs/deepseek_v2_236b.py",
            "configs/dbrx_132b.py", "configs/llama_3_2_vision_11b.py",
            "configs/seamless_m4t_large_v2.py", "runtime/serve_loop.py",
            "runtime/train_loop.py", "kernels/flash_attention/ops.py",
            "kernels/flash_attention/flash_attention.py",
            "kernels/ssd_scan/ops.py", "kernels/ssd_scan/ssd_scan.py",
            "spec.py", "policy/spec.py", "policy/registry.py",
            "policy/builtin.py", "core/baselines.py", "core/controller.py",
            "core/solvers/scipy_solver.py", "core/solvers/pulp_solver.py",
            "sim/scenarios.py", "experiments/scenario.py",
            "experiments/plan.py", "experiments/runner.py",
            "experiments/executor.py", "obs/report.py",
            "serve/__init__.py", "serve/arrivals.py", "serve/loop.py",
            "workflows/__init__.py", "workflows/spec.py",
            "workflows/cpath.py", "workflows/generators.py",
            "workflows/ingest.py", "runtime/elastic.py",
            "data/pipeline.py", "optim/compression.py"} <= names
    cu = {p.name for p in (SRC / "repro_torch" / "csrc").glob("*.cu")}
    assert {"flash_attention.cu", "ssd_scan.cu"} <= cu
    hits = [(str(p), m.group(0).strip()) for p in files
            for m in _FORBIDDEN.finditer(p.read_text())]
    assert hits == []


def test_card_scripts_never_import_jax_or_reference():
    """The scripts run on the card (``chip_smoke.py``, ``kernel_probe.py``,
    ``train_probe.py``) import neither JAX nor the reference package."""
    root = SRC.parent
    hits = [(name, m.group(0).strip())
            for name in ("chip_smoke.py", "kernel_probe.py", "train_probe.py")
            for m in _FORBIDDEN.finditer((root / name).read_text())]
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


def test_server_without_cuda_raises(monkeypatch):
    """The LM server runs on the card unless asked for the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.serve_loop import Server
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = Model(get_config("qwen2_1_5b", reduced=True))
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        Server(m, params)
    out = Server(m, params, device="cpu").generate(
        dict(tokens=np.zeros((1, 5), np.int32)), max_new=2)
    assert out.shape == (1, 2)


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """On a CPU tensor each wrapper takes its plain version and launches
    nothing; there is no path for another device."""
    from repro_torch.kernels.flash_attention import flash_attention as fb
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ssd_scan as sb
    before = (fb.LAUNCHES, sb.LAUNCHES)
    q = torch.randn(1, 9, 1, 2, 16)
    k = torch.randn(1, 9, 1, 16)
    assert fops.flash_attention(q, k, k).shape == q.shape
    x = torch.randn(1, 9, 2, 16)
    y, st = sops.ssd_scan(x, torch.rand(1, 9, 2), -torch.rand(2),
                          torch.randn(1, 9, 1, 4), torch.randn(1, 9, 1, 4),
                          chunk=4)
    assert y.shape == x.shape and st.shape == (1, 2, 16, 4)
    assert (fb.LAUNCHES, sb.LAUNCHES) == before
    with pytest.raises(ValueError, match="no SSD scan kernel"):
        sops.ssd_scan(x.to("meta"), *(torch.zeros(1, device="meta"),) * 4)


def test_registry_lists_port_backends():
    assert {"flow", "torch", "fused", "scipy"} <= set(
        solvers.available_backends())
    with pytest.raises(KeyError, match="counterpart is 'torch'"):
        solvers.get_solver("jax")
