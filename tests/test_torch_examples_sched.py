"""The port's five scheduler examples (``examples_torch/``) against the
JAX package's scripts (``examples/``) on the CPU, at reduced sizes: each
reference script runs its own code (its ``main`` under the same
arguments, or its source at a smaller ``DAYS``) and prints what it
prints; the port's prints the same rows, within the parity contract
(ROADMAP.md: the same engine records on the same instances), wall times
aside. Sweeps run serially in the test process on both sides.
"""
import functools
import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.forecast import learned as ref_learned
from repro.sim import scenarios as ref_scenarios
from repro_torch import convert
from repro_torch.experiments import executor
from repro_torch.forecast import learned

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(name, argv, capsys, monkeypatch):
    """The reference script's ``main`` under ``argv``: (its return value,
    its printed lines)."""
    mod = load(ROOT / "examples" / f"{name}.py", f"ref_{name}")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    capsys.readouterr()
    code = mod.main()
    return code, capsys.readouterr().out.splitlines()


def run_port(name, argv, capsys):
    """The port's ``main`` under ``argv`` and ``--device cpu``."""
    mod = load(ROOT / "examples_torch" / f"{name}.py", f"port_{name}")
    capsys.readouterr()
    code = mod.main(argv + ["--device", "cpu"])
    return code, capsys.readouterr().out.splitlines()


def without_last_column(lines):
    """Table lines with their last column (the cell's wall seconds) cut;
    the dashed rule under the header dropped (its widths follow the
    walls')."""
    return [line.split()[:-1] for line in lines
            if line.strip() and set(line.strip()) - {"-", " "}]


@pytest.fixture
def serial_sweeps(monkeypatch):
    """The reference's ``sweep`` serial, the port's auto-sized pools one
    process: the rows are the same either way (the executor tests), and
    the test stays in one process. PyTorch on one thread meanwhile: the
    learned forecaster's training is hundreds of mid-sized ops, whose
    OpenMP threads, spinning in two test processes at once (another file
    trains it too), slow both ~20 times on a shared CPU."""
    monkeypatch.setattr(ref_scenarios, "sweep", functools.partial(
        ref_scenarios.sweep, executor="serial"))
    monkeypatch.setattr(executor, "auto_workers",
                        lambda n_cells, device=None: 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_quickstart_prints_the_reference_rows(capsys):
    """The reference script's own source at DAYS 0.02, against the
    port's ``compare`` at the same size: every printed line equal."""
    src = (ROOT / "examples" / "quickstart.py").read_text()
    assert "DAYS = 0.1\n" in src
    capsys.readouterr()
    exec(compile(src.replace("DAYS = 0.1\n", "DAYS = 0.02\n"),
                 "quickstart.py", "exec"), {"__name__": "ref_quickstart"})
    want = capsys.readouterr().out.splitlines()
    mod = load(ROOT / "examples_torch" / "quickstart.py", "port_quickstart")
    got = []
    mod.compare(0.02, "cpu", log=lambda s: got.extend(s.split("\n")))
    assert got == want
    assert len(got) > 8 and got[3].startswith("baseline")


def test_scenario_sweep_prints_the_reference_rows(capsys, monkeypatch):
    argv = ["--days", "0.02", "--executor", "serial"]
    _, want = run_reference("scenario_sweep", argv, capsys, monkeypatch)
    _, got = run_port("scenario_sweep", argv, capsys)
    table = [line for line in want if "saved vs baseline" not in line]
    assert without_last_column(got[:len(table)]) == \
        without_last_column(table)
    assert got[len(table):] == want[len(table):]
    assert len(want) - len(table) == 6


def test_forecast_shift_prints_the_reference_rows(capsys, monkeypatch,
                                                  serial_sweeps):
    """At 0.01 days with the learned forecaster's JAX init carried
    across (it trains, 300 steps, in each scenario's first round): the
    tidy table (wall seconds aside) and every joint-cost line equal."""
    def init(seed, d_model, horizon, device=None):
        tree = ref_learned.init_params(jax.random.PRNGKey(seed), d_model,
                                       horizon)
        return convert.learned_params_from_reference(
            jax.tree.map(np.asarray, tree), device or "cpu")
    monkeypatch.setattr(learned, "init_params", init)
    argv = ["--days", "0.01"]
    _, want = run_reference("forecast_shift", argv, capsys, monkeypatch)
    _, got = run_port("forecast_shift", argv, capsys)
    split = want.index("")
    assert got.index("") == split
    assert without_last_column(got[:split]) == without_last_column(
        want[:split])
    assert got[split:] == want[split:]
    assert len(want) - split == 7


def test_serve_stream_prints_the_reference_report(capsys, monkeypatch):
    """The CI smoke (30 s, 5 s rounds, --assert-clean): exit 0 on both
    sides and the same report, the round latencies and budget overruns
    (wall times) aside."""
    argv = ["--duration", "30", "--round-s", "5", "--assert-clean"]
    code_ref, want = run_reference("serve_stream", argv, capsys,
                                   monkeypatch)
    code, got = run_port("serve_stream", argv, capsys)
    assert code == code_ref == 0
    walls = ("p50_round_ms", "p99_round_ms", "budget_overruns")

    def results(lines):
        return [line for line in lines
                if not any(f" {k} =" in line for k in walls)]
    assert results(got) == results(want)
    assert got[-1].startswith("OK: ") and len(results(got)) > 15


def test_workflow_run_prints_the_reference_rows(capsys, monkeypatch):
    argv = ["--days", "0.05", "--assert-clean"]
    _, want = run_reference("workflow_run", argv, capsys, monkeypatch)
    _, got = run_port("workflow_run", argv, capsys)
    assert got == want
    assert "precedence_violations 0" in got[-1]
