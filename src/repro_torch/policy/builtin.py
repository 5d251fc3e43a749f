"""Built-in policy registrations: the paper's scheduler family as specs
(the port of ``repro/policy/builtin.py``: the same names, parameters and
defaults).

Param schemas for the pipeline-backed policies are *derived* from the
factory signatures (``reactive_pipeline`` / ``forecast_pipeline``), so a new
tunable added to a factory is automatically spec-addressable and the
documented defaults can never drift from the code. Rule-based baselines
declare their (few) params by hand.

The rule schedulers themselves are imported lazily inside the factories —
``repro_torch.core.baselines`` imports the pipeline module, so importing it
here at module scope would cycle.

The solver backends are the port's: the reference's ``backend=jax`` is
``backend=torch`` here, so the forecast-driven policies default to
``torch``. ``jax`` is not an alias: a spec naming it fails when it is built,
and the error names ``torch``. The pipeline-backed policies take the torch
``device`` beside their spec (``registry.build(..., device=...)``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.policy.pipeline import forecast_pipeline, reactive_pipeline
from repro_torch.policy.registry import Param, register_policy
from repro_torch.spec import params_from_signature

_HELP: Dict[str, str] = {
    "lam_co2": "carbon weight λ_CO2 (λ_CO2 + λ_H2O must sum to 1; "
               "specifying only one sets the other to its complement)",
    "lam_h2o": "water weight λ_H2O (complement rule as for lam_co2)",
    "lam_ref": "history-term weight λ_ref (Eq 8)",
    "lam_emb": "embodied-carbon weight λ_emb (three-way Eq-8 extension; "
               "λ_CO2 + λ_H2O + λ_emb must sum to 1)",
    "window": "history-learner trailing window (rounds)",
    "sigma": "soft-violation penalty σ (Eqs 12-13)",
    "backend": "solver backend (flow / torch / fused / scipy / pulp)",
    "defer_margin": "defer-arc price margin over the trailing-mean cost",
    "defer_slack_s": "min remaining TOL budget (s) to offer the defer arc",
    "record_windows": "record every solved window for offline batched replay",
    "forecaster": "forecast model (holtwinters / seasonal-naive / "
                  "persistence / learned / oracle)",
    "horizon_slots": "number of future slots offered per round",
    "slot_s": "slot width (seconds)",
    "risk": "shade future slots toward the upper quantile band by this "
            "fraction",
    "defer_eps": "per-slot tie-break cost — deferral must earn its delay",
    "guard_s": "tolerance budget reserve forcing early release of held jobs",
    "warmup_hours": "telemetry archive hours used to warm-start the "
                    "forecaster (0 = cold start)",
    "forecast_bias": "multiplicative forecast error injection (1.0 = off)",
    "forecast_noise": "relative forecast noise injection (0.0 = off)",
    "forecast_seed": "seed for the injected forecast noise",
    "warm": "carry Sinkhorn potentials between rounds as warm starts "
            "(fused backend only)",
    "replan": "receding-horizon re-planning: held jobs re-enter pricing "
              "every round instead of committing at admission",
    "replan_guard_s": "commit window (s): held jobs this close to release "
                      "are not re-planned",
    "replan_margin": "hysteresis: a re-planned early run must beat the "
                     "committed slot by this cost margin",
}

# Constructor arguments that are not spec-addressable (non-serializable or
# simulator-internal; the device travels beside the spec).
_NON_SPEC = {"tele", "server", "device"}


def _sig_params(fn, exclude: Sequence[str] = ()) -> List[Param]:
    """Derive a Param list from a factory's keyword-only signature (shared
    ``repro_torch.spec`` introspection; non-spec-expressible defaults like
    the ``server`` object are skipped automatically)."""
    return params_from_signature(fn, skip=_NON_SPEC | set(exclude),
                                 help_text=_HELP)


# -- rule-based comparison schedulers (paper §5) ----------------------------

@register_policy("baseline",
                 "home region, carbon/water-unaware (paper's reference)",
                 stateless=True)
def _baseline(tele):
    from repro_torch.core.baselines import Baseline
    return Baseline(tele)


@register_policy("round-robin",
                 "cyclic region placement, sustainability-unaware")
def _round_robin(tele):
    from repro_torch.core.baselines import RoundRobin
    return RoundRobin(tele)


@register_policy("least-load",
                 "most-free-capacity region, sustainability-unaware",
                 stateless=True)
def _least_load(tele):
    from repro_torch.core.baselines import LeastLoad
    return LeastLoad(tele)


@register_policy("carbon-greedy-opt",
                 "infeasible oracle: knows future carbon intensity, "
                 "delays/moves each job to its per-job best slot",
                 stateless=True)
def _carbon_greedy(tele):
    from repro_torch.core.baselines import GreedyOpt
    return GreedyOpt(tele, "carbon")


@register_policy("water-greedy-opt",
                 "infeasible oracle: knows future water intensity, "
                 "delays/moves each job to its per-job best slot",
                 stateless=True)
def _water_greedy(tele):
    from repro_torch.core.baselines import GreedyOpt
    return GreedyOpt(tele, "water")


@register_policy("ecovisor",
                 "home-region carbon scaler (customized [50]): resource-"
                 "scales jobs against a trailing carbon-intensity target",
                 params=[Param("window", int, 24,
                               "trailing carbon-target window (hours)")],
                 stateless=True)
def _ecovisor(tele, **p):
    from repro_torch.core.baselines import Ecovisor
    return Ecovisor(tele, **p)


# -- pipeline-backed policies -----------------------------------------------

def _complete_lams(p: Dict) -> Dict:
    """Specifying one of the Eq-8 weights implies the other (they must sum
    to 1), so ``waterwise[lam_h2o=0.7]`` is a complete spec."""
    if "lam_h2o" in p and "lam_co2" not in p:
        p = dict(p, lam_co2=1.0 - p["lam_h2o"])
    elif "lam_co2" in p and "lam_h2o" not in p:
        p = dict(p, lam_h2o=1.0 - p["lam_co2"])
    return p


@register_policy("waterwise",
                 "the paper's myopic carbon+water co-optimizing controller "
                 "(Algorithm 1): snapshot pricing + defer arc + MILP",
                 params=_sig_params(reactive_pipeline))
def _waterwise(tele, device=None, **p):
    return reactive_pipeline(tele, device=device, **_complete_lams(p))


@register_policy("waterwise-embodied",
                 "three-way footprint controller: adds per-region amortized "
                 "embodied carbon to the Eq-8 objective "
                 "(λ_emb + equal-split operational weights sum to 1)",
                 params=[Param("lam_embodied", float, 0.2,
                               "embodied-carbon weight λ_emb; the remaining "
                               "(1-λ_emb) splits evenly between carbon and "
                               "water")]
                 + _sig_params(reactive_pipeline,
                               exclude=("lam_co2", "lam_h2o", "lam_emb")))
def _waterwise_embodied(tele, lam_embodied: float = 0.2, device=None, **p):
    op = (1.0 - lam_embodied) / 2.0
    return reactive_pipeline(tele, lam_co2=op, lam_h2o=op,
                             lam_emb=lam_embodied, device=device, **p)


@register_policy("waterwise-forecast",
                 "forecast-driven temporal shifting: jobs x (regions x "
                 "horizon-slots) priced by a Holt-Winters forecast",
                 params=_sig_params(forecast_pipeline),
                 forecast_driven=True)
def _waterwise_forecast(tele, device=None, **p):
    return forecast_pipeline(tele, device=device, **_complete_lams(p))


@register_policy("waterwise-oracle",
                 "upper-bound variant: temporal shifting priced by the "
                 "true future telemetry",
                 params=_sig_params(forecast_pipeline,
                                    exclude=("forecaster",)),
                 forecast_driven=True)
def _waterwise_oracle(tele, device=None, **p):
    return forecast_pipeline(tele, forecaster="oracle", device=device,
                             **_complete_lams(p))


@register_policy("carbon-forecast",
                 "carbon-only forecast shifting (λ_CO2=1): the "
                 "GreenCourier-style comparison point",
                 params=_sig_params(forecast_pipeline,
                                    exclude=("lam_co2", "lam_h2o")),
                 forecast_driven=True)
def _carbon_forecast(tele, device=None, **p):
    return forecast_pipeline(tele, lam_co2=1.0, lam_h2o=0.0, device=device,
                             **p)
