"""``ExperimentPlan``: the (scenarios × policies × seeds) grid as data
(the port of ``repro/experiments/plan.py``).

A plan is the declarative form of a whole experiment: every axis is a spec
(scenario specs, policy specs, seed overrides), the cross product is the
cell list, and the whole object serializes to/from JSON — so a fleet-scale
study is one reviewable artifact instead of a kwargs pile, and a shard
worker or a remote host can be driven by the plan text alone.

    plan = ExperimentPlan.build(
        scenarios=["diurnal[days=10,jobs_per_day=1e5]", "drought-summer"],
        policies=["baseline", "waterwise[lam_h2o=0.7]"],
        seeds=[0, 1, 2])
    rows = plan.run(executor="process", device="cpu")

Each cell yields one tidy row (``TABLE_COLS`` / ``CSV_COLS`` schema); rows
carry re-parseable ``spec`` (policy) and ``scenario_spec`` columns plus the
``seed``, so any CSV line reproduces its cell exactly. Failed cells don't
abort the others: their rows carry an ``error`` column (see
``ExperimentPlan.run(strict=...)``). The torch ``device`` the policies run
on travels beside the cells (``run(..., device=...)``), never inside a spec
or the plan's JSON.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import policy
from repro_torch.experiments.scenario import ScenarioSpec, parse_scenario
from repro_torch.sim.metrics import savings_vs

PlanLike = Union[str, "ExperimentPlan"]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One experiment cell: a scenario spec × a policy spec × a seed
    override (``None`` = use the scenario spec's own ``seed`` param)."""
    scenario: ScenarioSpec
    policy: policy.PolicySpec
    seed: Optional[int] = None

    def resolved_scenario(self) -> ScenarioSpec:
        """The scenario spec with the seed override applied."""
        if self.seed is None:
            return self.scenario
        return self.scenario.with_params(seed=self.seed)

    @property
    def seed_value(self) -> int:
        if self.seed is not None:
            return self.seed
        return int(self.scenario.params.get("seed", 0))

    def label(self) -> str:
        return (f"{self.resolved_scenario()} × {self.policy}")


@dataclasses.dataclass(frozen=True)
class ExperimentPlan:
    """The full experiment grid; axes are tuples of validated specs."""
    scenarios: Tuple[ScenarioSpec, ...]
    policies: Tuple[policy.PolicySpec, ...]
    seeds: Tuple[Optional[int], ...] = (None,)

    @classmethod
    def build(cls, scenarios: Sequence, policies: Sequence,
              seeds: Optional[Sequence[Optional[int]]] = None
              ) -> "ExperimentPlan":
        """Validated plan from spec strings/objects (fails fast on typos —
        a misspelled scenario, policy, or param raises before any cell
        runs, with a did-you-mean message)."""
        return cls(
            scenarios=tuple(parse_scenario(s) for s in scenarios),
            policies=tuple(policy.as_spec(p) for p in policies),
            seeds=tuple(seeds) if seeds else (None,))

    def cells(self) -> List[Cell]:
        """The cross product, scenario-major (scenario → seed → policy),
        matching the old ``sweep`` row order for the default seed axis."""
        return [Cell(sc, pol, seed)
                for sc in self.scenarios
                for seed in self.seeds
                for pol in self.policies]

    # -- JSON round-trip -----------------------------------------------------

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(
            dict(scenarios=[str(s) for s in self.scenarios],
                 policies=[str(p) for p in self.policies],
                 seeds=list(self.seeds)), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentPlan":
        d = json.loads(text)
        unknown = set(d) - {"scenarios", "policies", "seeds"}
        if unknown:
            raise ValueError(f"unknown ExperimentPlan keys {sorted(unknown)} "
                             f"(accepts: scenarios, policies, seeds)")
        return cls.build(d["scenarios"], d["policies"], d.get("seeds"))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "ExperimentPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- execution -----------------------------------------------------------

    def run(self, executor: str = "serial", *, strict: bool = False,
            baseline: str = "baseline", device=None,
            **options) -> List[Dict]:
        """Run every cell through ``executor`` and return the tidy rows.

        ``executor`` is an executor spec — ``"serial"``, ``"process"``,
        ``"process[max_workers=4]"`` — resolved by
        ``repro_torch.experiments.executor``; ``options`` are validated
        overrides merged into it. Every backend produces identical rows for
        identical plans. ``device`` is where the policies run (None: the
        CUDA card).

        A crashed cell never aborts the others: its row records the
        failure in the ``error`` column (metrics empty). With
        ``strict=True`` a ``CellError`` naming the failing (scenario,
        policy) cell is raised *after* all cells finish; the completed
        rows ride on the exception as ``err.rows``.

        Within each (scenario, seed) group, savings percentages are
        attached relative to the ``baseline`` policy when present.
        """
        from repro_torch.experiments.executor import get_executor
        from repro_torch.experiments.runner import CellError

        rows = get_executor(executor, **options).run(self.cells(),
                                                     device=device)
        attach_savings(rows, baseline=baseline)
        if strict:
            failed = [r for r in rows if r.get("error")]
            if failed:
                first = failed[0]
                err = CellError(first["scenario_spec"], first["spec"],
                                first["error"])
                err.rows = rows
                raise err
        return rows


def attach_savings(rows: Sequence[Dict], baseline: str = "baseline") -> None:
    """Attach % savings vs the in-group baseline row, including the
    stress-weighted water view. Groups key on the full resolved
    ``scenario_spec`` (plus seed), not the bare scenario name — two
    param-variants of one scenario in a plan each get their own baseline.
    Error rows neither serve as baselines nor receive savings."""
    def key(row):
        return (row.get("scenario_spec", row["scenario"]),
                row.get("seed", 0))

    by_group: Dict[Tuple, Dict] = {}
    for row in rows:
        if row["scheduler"] == baseline and not row.get("error"):
            by_group[key(row)] = row
    for row in rows:
        if row.get("error"):
            continue
        base = by_group.get(key(row))
        if base is None:
            continue
        row.update(savings_vs(base, row))
        bw = base["stress_water_kl"]
        row["stress_water_savings_pct"] = (
            100.0 * (bw - row["stress_water_kl"]) / bw if bw else 0.0)


# ---------------------------------------------------------------------------
# Multi-seed confidence intervals
# ---------------------------------------------------------------------------

# Two-sided 95% Student-t critical values t_{0.975, df} for df = 1..30
# (normal beyond) — hardcoded so the CI math has no scipy dependency and is
# bit-deterministic across hosts.
_T95 = {
    1: 12.706204736432095, 2: 4.302652729911275, 3: 3.182446305284263,
    4: 2.7764451051977987, 5: 2.570581835636197, 6: 2.4469118487916806,
    7: 2.3646242510102993, 8: 2.306004135033371, 9: 2.2621571627409915,
    10: 2.2281388519649385, 11: 2.200985160082949, 12: 2.1788128296634177,
    13: 2.160368656461013, 14: 2.1447866879169273, 15: 2.131449545559323,
    16: 2.1199052992210112, 17: 2.1098155778331806, 18: 2.100922040241039,
    19: 2.093024054408263, 20: 2.0859634472658364, 21: 2.0796138447276626,
    22: 2.0738730679040147, 23: 2.0686576104190406, 24: 2.0638985616280205,
    25: 2.059538552753294, 26: 2.055529438642871, 27: 2.0518305164802833,
    28: 2.048407141795244, 29: 2.0452296421327034, 30: 2.0422724563012373,
}


def t95(df: int) -> float:
    """t_{0.975, df} (95% two-sided); normal approximation past df=30."""
    return _T95.get(df, 1.959963984540054)


def _strip_bracket_param(spec_str: str, key: str) -> str:
    """Drop ``key=value`` from a bracketed spec string textually (no
    registry lookup, so it works on rows from scenarios that are no longer
    registered in this process)."""
    m = re.match(r"^(.*)\[(.*)\]$", spec_str.strip())
    if not m:
        return spec_str
    name, body = m.groups()
    parts = [p.strip() for p in body.split(",")
             if p.strip() and not p.strip().startswith(key + "=")]
    return f"{name}[{','.join(parts)}]" if parts else name


def seed_group_key(row: Dict) -> Tuple[str, str]:
    """Identity of a row modulo its seed: the scenario spec with ``seed``
    stripped × the policy spec with ``forecast_seed`` stripped (the one
    param ``resolve_policy_spec`` varies per seed)."""
    scen = str(row.get("scenario_spec") or row.get("scenario", ""))
    spec = str(row.get("spec") or row.get("scheduler", ""))
    return (_strip_bracket_param(scen, "seed"),
            _strip_bracket_param(spec, "forecast_seed"))


def aggregate_seeds(rows: Sequence[Dict]) -> List[Dict]:
    """Collapse multi-seed replicate rows into one row per cell carrying
    mean ± 95% CI (ROADMAP's rolling multi-seed studies item).

    Rows that differ only in their seed (see :func:`seed_group_key`) are
    grouped; every numeric metric becomes its across-seed mean under the
    original key plus a ``<key>_ci95`` half-width (Student-t, two-sided
    95%, sample std with ddof=1). Aggregated rows carry ``n_seeds`` and a
    comma-joined ``seed`` column. Single rows pass through untouched; error
    rows are never aggregated and ride along at the end.
    """
    groups: Dict[Tuple, List[Dict]] = {}
    order: List[Tuple] = []
    err_rows: List[Dict] = []
    for r in rows:
        if r.get("error"):
            err_rows.append(r)
            continue
        k = seed_group_key(r)
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(r)
    out: List[Dict] = []
    for k in order:
        g = groups[k]
        if len(g) == 1:
            out.append(g[0])
            continue
        agg = dict(g[0])
        # The aggregated row describes the whole seed group: its spec
        # columns are the seed-stripped forms (the group key), not the
        # first replicate's seed-bearing specs.
        scen_stripped, spec_stripped = k
        if "scenario_spec" in agg:
            agg["scenario_spec"] = scen_stripped
        if "spec" in agg:
            agg["spec"] = spec_stripped
        agg["seed"] = ",".join(str(r.get("seed", "")) for r in g)
        agg["n_seeds"] = len(g)
        n = len(g)
        crit = t95(n - 1)
        for key in g[0]:
            if key == "seed":          # identity, not a metric
                continue
            vals = [r.get(key) for r in g]
            if not all(isinstance(v, (int, float))
                       and not isinstance(v, bool) for v in vals):
                continue
            m = sum(vals) / n
            var = sum((v - m) ** 2 for v in vals) / (n - 1)
            agg[key] = float(m)
            agg[f"{key}_ci95"] = float(crit * math.sqrt(var / n))
        out.append(agg)
    return out + err_rows


def _has_seed_replicates(rows: Sequence[Dict]) -> bool:
    seen: Dict[Tuple, set] = {}
    for r in rows:
        if r.get("error"):
            continue
        seeds = seen.setdefault(seed_group_key(r), set())
        seeds.add(r.get("seed"))
        if len(seeds) > 1:
            return True
    return False


# ---------------------------------------------------------------------------
# Tidy-row schema
# ---------------------------------------------------------------------------

# "unfinished" stays in the default view: a scheduler that strands jobs
# accrues less footprint than one that ran everything — savings read from a
# row with unfinished > 0 are not comparable to the baseline's.
TABLE_COLS = ("scenario", "scheduler", "jobs", "unfinished", "carbon_kg",
              "water_kl", "stress_water_kl", "carbon_savings_pct",
              "water_savings_pct", "violation_pct", "mean_service_ratio",
              "wall_s")
CSV_COLS = TABLE_COLS + ("stress_water_savings_pct", "p99_service_ratio",
                         "utilization", "mean_solve_ms", "moved_pct",
                         "forecast_mape", "mean_defer_s", "deferred_pct",
                         "seed", "scenario_spec", "error", "spec")


def to_table(rows: Sequence[Dict], cols: Sequence[str] = TABLE_COLS, *,
             ci: Union[bool, str] = "auto") -> str:
    """Fixed-width tidy table (one line per experiment cell).

    When the rows contain multi-seed replicates (a plan with ≥ 2 seeds)
    they are collapsed through :func:`aggregate_seeds` and every numeric
    cell renders as ``mean±ci95``. ``ci=False`` disables the aggregation,
    ``ci=True`` forces it, the default ``"auto"`` detects replicates.
    """
    rows = list(rows)
    if ci is True or (ci == "auto" and _has_seed_replicates(rows)):
        rows = aggregate_seeds(rows)

    def fmt(r, c):
        v = r.get(c, "")
        hw = r.get(f"{c}_ci95")
        if hw is not None and isinstance(v, float):
            return f"{v:.2f}±{hw:.2f}"
        if isinstance(v, float):
            return f"{v:.2f}"
        return str(v)
    table = [[fmt(r, c) for c in cols] for r in rows]
    widths = [max(len(c), *(len(t[i]) for t in table)) if table else len(c)
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines.append("  ".join("-" * w for w in widths))
    for t in table:
        lines.append("  ".join(v.rjust(w) for v, w in zip(t, widths)))
    return "\n".join(lines)


def to_csv(rows: Sequence[Dict], path: str,
           cols: Sequence[str] = CSV_COLS) -> None:
    """Write tidy rows as CSV. Uses the stdlib writer so the ``spec`` /
    ``scenario_spec`` columns — whose bracketed params contain commas — are
    quoted and every row stays re-parseable (``policy.parse(row["spec"])``
    and ``experiments.parse_scenario(row["scenario_spec"])`` rebuild the
    cell exactly)."""
    import csv
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for r in rows:
            w.writerow([r.get(c, "") for c in cols])
