"""Policy registry: ``@register_policy`` + typed param schemas (the port
of ``repro/policy/registry.py``).

Every scheduler is registered once with a description and a parameter
schema, unknown names and params fail fast with a did-you-mean message
(nothing is silently dropped), and any registered policy can be built from
a ``PolicySpec`` — or its string form — anywhere a scheduler is accepted.

``build(spec, tele, device=...)`` takes the torch device beside the spec,
never inside it: ``device`` is not a spec parameter, so a row's ``spec``
column names the same policy on the card and on the CPU. It reaches the
pipeline-backed policies, whose factories take it; the rule schedulers
are host code and never see it. ``device=None`` means the CUDA card.

The grammar/validation plumbing is the shared ``repro_torch.spec`` module (also
used by scenario and executor specs); this registry contributes the policy
schemas and factories.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Union

from repro_torch.policy.spec import PolicySpec, parse_raw
from repro_torch.spec import (Param, unknown_name_error, unknown_param_error,
                              validate_params)

SpecLike = Union[str, PolicySpec]


@dataclasses.dataclass(frozen=True)
class PolicyEntry:
    """A registered scheduling policy."""
    name: str
    description: str
    params: Dict[str, Param]
    factory: Callable                 # (tele, **explicit_params) -> scheduler
    # Forecast-driven policies accept the scenario sweep's forecast-error
    # injection (forecast_bias / forecast_noise / forecast_seed defaults).
    forecast_driven: bool = False
    # Stateless policies carry no scheduler-internal state across fully
    # drained engine instants (no history window, no deferral queue, no
    # round-robin cursor), so a sharded executor may rebuild them fresh per
    # trace slice and still reproduce the unsharded run bit-for-bit when
    # slice boundaries are quiescent. Stateful policies shard via the
    # engine-state handoff chain instead (the reference's
    # repro.experiments.shard; not ported yet).
    stateless: bool = False
    def make_spec(self, **params) -> PolicySpec:
        """Validated, coerced ``PolicySpec`` for this policy."""
        return PolicySpec(self.name, validate_params(
            "policy", self.name, self.params, params))

    def build(self, tele, spec: PolicySpec, device=None):
        # Pipeline-backed factories take ``device=``; rule schedulers are
        # host code and take none.
        takes = "device" in inspect.signature(self.factory).parameters
        kw = dict(device=device) if takes else {}
        return self.factory(tele, **dict(spec.params), **kw)


_REGISTRY: Dict[str, PolicyEntry] = {}


def register_policy(name: str, description: str,
                    params: List[Param] = (),
                    forecast_driven: bool = False,
                    stateless: bool = False):
    """Decorator: register ``fn(tele, **params) -> scheduler`` under
    ``name`` (a pipeline-backed ``fn`` also takes ``device=``)."""
    def deco(fn):
        _REGISTRY[name] = PolicyEntry(
            name=name, description=description,
            params={p.name: p for p in params}, factory=fn,
            forecast_driven=forecast_driven, stateless=stateless)
        return fn
    return deco


def _ensure_builtins() -> None:
    # Import side-effect registration (lazy to keep the package import-cycle
    # free: builtin pulls in the rule schedulers which import the pipeline).
    if "waterwise" not in _REGISTRY:
        from repro_torch.policy import builtin  # noqa: F401


def get_policy(name: str) -> PolicyEntry:
    _ensure_builtins()
    entry = _REGISTRY.get(name)
    if entry is None:
        raise unknown_name_error("policy", name, list(_REGISTRY))
    return entry


def list_policies() -> List[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def parse(text: SpecLike) -> PolicySpec:
    """Parse + validate a spec string against the registry.

    Accepts an existing ``PolicySpec`` too (re-validated), so every consumer
    can take either form.
    """
    if isinstance(text, PolicySpec):
        return get_policy(text.name).make_spec(**text.params)
    name, raw = parse_raw(text)
    return get_policy(name).make_spec(**raw)


as_spec = parse     # readability alias: as_spec("waterwise[...]") / (spec)


def build(spec: SpecLike, tele, *, device=None, **overrides):
    """Instantiate the scheduler a spec describes, against ``tele``.

    ``overrides`` are merged on top of the spec's params (validated), which
    is what the deprecated ``make_scheduler(name, tele, **kw)`` shim
    forwards to. ``device`` is where a pipeline-backed policy runs (None:
    the CUDA card); it never becomes a spec field.
    """
    s = parse(spec)
    if overrides:
        s = s.with_params(**overrides)
    return get_policy(s.name).build(tele, s, device=device)


def describe(markdown: bool = False) -> str:
    """Human-readable registry dump (the ``--list-schedulers`` surface and
    the source of the README scheduler table)."""
    _ensure_builtins()
    entries = [_REGISTRY[n] for n in sorted(_REGISTRY)]
    if markdown:
        lines = ["| policy | parameters | description |", "|---|---|---|"]
        for e in entries:
            ps = ", ".join(f"`{p.describe()}`" for p in e.params.values()) \
                or "—"
            lines.append(f"| `{e.name}` | {ps} | {e.description} |")
        return "\n".join(lines)
    lines = []
    for e in entries:
        lines.append(f"{e.name:20s} {e.description}")
        for p in e.params.values():
            doc = f"  — {p.help}" if p.help else ""
            lines.append(f"    {p.describe():28s}{doc}")
    return "\n".join(lines)


# Exported for backward compatibility: ``Param`` originally lived here.
__all__ = ["Param", "PolicyEntry", "SpecLike", "register_policy",
           "get_policy", "list_policies", "parse", "as_spec", "build",
           "describe", "unknown_param_error"]
