"""Declarative scheduling-policy API: specs, registry, one pipeline.

A scheduler is *data* here: a ``PolicySpec`` — registered name + typed,
validated params — that round-trips through its string form
(``"waterwise[lam_h2o=0.7,backend=torch]"``), sweep CSV rows, and CLI flags.
The registry (``@register_policy``) maps specs to builders; the paper's
controller family is a set of specs over ONE composable ``PolicyPipeline``
(Pricer × DeferralPolicy × solver backend), not a class hierarchy.

Typical use::

    from repro_torch import policy

    sched = policy.build("waterwise[lam_h2o=0.7,backend=torch]", tele)
    spec  = policy.parse("waterwise-forecast[horizon_slots=8]")
    spec2 = spec.with_params(risk=0.5)        # validated; raises on typos
    print(policy.describe())                  # the full registry, documented

The port's policy names, parameters and defaults are the reference's
(``repro.policy``), with its solver backends: ``backend=torch`` where the
reference says ``jax``. ``build(spec, tele, device=...)`` takes the torch
device beside the spec (None: the CUDA card).

Everything a spec cannot express (an unknown policy, a typo'd or ill-typed
param) fails fast with a did-you-mean message — nothing is silently
dropped.
"""
from repro_torch.policy.pipeline import (
    DEFER, HOLD, RUN, Decision, DeferralPolicy, ForecastPricer,
    HistoryLearner, NextRoundDeferral, PolicyPipeline, PricedPlan, Pricer,
    QueueDeferral, ReplanQueueDeferral, Scheduler, SnapshotPricer,
    forecast_pipeline, reactive_pipeline)
from repro_torch.policy.registry import (Param, PolicyEntry, as_spec, build,
                                         describe, get_policy, list_policies,
                                         parse, register_policy)
from repro_torch.policy.spec import (ParamValueError, PolicySpec, PolicySpecError,
                                     SpecSyntaxError, UnknownParamError,
                                     UnknownPolicyError, split_specs)

__all__ = [
    # spec grammar
    "PolicySpec", "PolicySpecError", "SpecSyntaxError", "UnknownPolicyError",
    "UnknownParamError", "ParamValueError", "split_specs",
    # registry
    "Param", "PolicyEntry", "register_policy", "get_policy", "list_policies",
    "parse", "as_spec", "build", "describe",
    # pipeline
    "Decision", "Scheduler", "HistoryLearner", "PolicyPipeline", "Pricer",
    "PricedPlan", "SnapshotPricer", "ForecastPricer", "DeferralPolicy",
    "NextRoundDeferral", "QueueDeferral", "ReplanQueueDeferral",
    "reactive_pipeline", "forecast_pipeline", "RUN", "HOLD", "DEFER",
]
